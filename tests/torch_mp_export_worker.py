"""One rank of the port's two-process export (not collected by pytest).

tests/test_torch_multiprocess_export.py starts one of these a rank. Each
rank joins a gloo group over a local TCP address, holds 4 of the 8 CPU
shards of a ("time",) mesh, and calls export_video_distributed with the same
arguments as the other. It imports the port only.

    python tests/torch_mp_export_worker.py RANK PORT CLIP OUT [END|-] [CHECKPOINT|-] [keep]

The last line of stdout is one JSON object:
  {"rank": N, "final": path, "frames": N, "backend": str, "error": str|null}
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    from live_video_magnification_tpu_torch.models.params import (
        MagnificationMode,
        MagnificationParams,
        PreprocessParams,
        ProcessorConfig,
    )
    from live_video_magnification_tpu_torch.parallel import distributed
    from live_video_magnification_tpu_torch.parallel.batch_export import export_video_distributed
    from live_video_magnification_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(2)
    rank, port, clip, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    end = int(sys.argv[5]) if len(sys.argv) > 5 and sys.argv[5] != "-" else None
    checkpoint = sys.argv[6] if len(sys.argv) > 6 and sys.argv[6] != "-" else None
    keep_parts = len(sys.argv) > 7 and sys.argv[7] == "keep"

    assert distributed.initialize(f"127.0.0.1:{port}", 2, rank, device="cpu"), \
        "expected a multi-process group"
    mesh = make_mesh((8,), ("time",), ["cpu"] * 8, ranks=[0] * 4 + [1] * 4)
    cfg = ProcessorConfig(
        preprocess=PreprocessParams(), grayscale=False,
        magnification=MagnificationParams(
            mode=MagnificationMode.PHASE, amplification=30.0, co_wavelength=40.0,
            co_low=0.5, co_high=3.0, levels=2, framerate=30.0))

    stats: dict = {}
    err = final = None
    try:
        final = export_video_distributed(
            clip, out, cfg, mesh=mesh, chunk=8, end=end, keep_parts=keep_parts,
            checkpoint_path=checkpoint, checkpoint_every=8 if checkpoint else 0, stats=stats)
    except Exception as e:  # reported to the test through the JSON line
        err = f"{type(e).__name__}: {e}"
    print(json.dumps({"rank": rank, "final": final, "frames": stats.get("frames"),
                      "backend": distributed.layout().backend, "error": err}), flush=True)
    torch.distributed.destroy_process_group()
    return 0 if err is None else 1


if __name__ == "__main__":
    sys.exit(main())
