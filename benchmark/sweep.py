#!/usr/bin/env python3
"""The camera mix of a cell at a list of rates, a few seconds each, to find
the knee: the highest rate at which every frame is published and the
due-to-publish times do not grow over the run.

    python3 benchmark/sweep.py --workload <camera cell> --rates 30 60 90 120 \
        --seconds 8 --seeds 5 6 [--set queue=4]

One JSON line a rate and seed, on the card: frames published a second, p95
latency, drops, the consumer's median ms a frame (wall and CPU), whether the
latency grew (the mean of the last quarter of frames over that of the
first), and the host's load over the window. ``--set`` overrides a
parameter of the mix (a JSON value).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.run import run_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seeds", type=int, nargs="+", default=[5])
    ap.add_argument("--set", action="append", default=[], metavar="KEY=JSON")
    args = ap.parse_args(argv)
    changes = {k: json.loads(v) for k, v in (kv.split("=", 1) for kv in args.set)}
    for rate in args.rates:
        for seed in args.seeds:
            t = time.monotonic()
            r = run_cell(Path.cwd(), args.workload, seed, args.seconds, False,
                         start=t, traffic_changes=dict(changes, rate_fps=rate))
            m = {k: v["value"] for k, v in r["metrics"].items()}
            print(json.dumps({"workload": args.workload, "rate_fps": rate, "seed": seed,
                              "changes": changes, "correct": r["correct"],
                              "metrics": m,
                              "notes": r["notes"], "run_s": time.monotonic() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
