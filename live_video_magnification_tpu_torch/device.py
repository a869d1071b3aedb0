"""Device resolution for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``. Without a card
that raises: the port never falls back to the CPU on its own. Tests and
reference runs ask for the CPU explicitly with ``device="cpu"``.

f32 means IEEE f32 everywhere: cuDNN convolutions and cuBLAS matmuls default
to (or may be switched to) TF32 on Hopper, which keeps ~3 decimal digits.
:func:`resolve_device` pins both to IEEE before any work is queued.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def pin_ieee_f32() -> None:
    """Disable TF32 for cuDNN convolutions and cuBLAS matmuls (process-wide)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a torch.device; raises for CUDA when no card is present."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!s}: use 'cuda' or 'cpu'")
    pin_ieee_f32()
    return dev
