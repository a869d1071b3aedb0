#!/usr/bin/env python3
"""The numbers ``correct`` compares, over several seeds in one process.

    python3 benchmark/readings.py --workload <name> --seconds <s> --seeds 11 12 13 \
        [--control <arm>]

Without ``--control`` it reads the program, as a run of ``run.py`` does; the
largest reading over a dozen seeds or more is a limit's lower end. With
``--control`` it reads one arm of the configuration's ``controls``: the
program with a lower-precision path of its own switched on (``flags``), or
the reference computed in a lower precision in the program's place
(``reference_dtype``); the smallest reading is a limit's upper end. The
benchmark's own runs never run a control. One JSON line a seed, on the card.
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
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        t = time.monotonic()
        r = run_cell(Path.cwd(), args.workload, seed, args.seconds, False,
                     device=args.device, control=args.control, start=t)
        print(json.dumps({"workload": args.workload, "control": args.control, "seed": seed,
                          "correct": r["correct"], "failed": r["failed"],
                          "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                          "notes": r["notes"], "run_s": time.monotonic() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
