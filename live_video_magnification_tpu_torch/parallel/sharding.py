"""Frame-tile + batch sharding of the magnification step.

The counterpart of the reference package's ``parallel/sharding.py``. Frames
[B, C, H, W] lay B over the 'batch' mesh axis and split the frame over the
'tile' axis. Phase mode takes the explicit lane-sharded step
(parallel/riesz_sharded.py: W over 'tile', the port's kernels on
halo-exchanged strips) wherever the frame's width lane-shards; motion,
colour and phase at the other widths take the row-sharded steps
(parallel/row_sharded.py: H over 'tile'), the port's explicit form of the
reference's GSPMD path. The reference's ``kernels=`` is a TPU lever
(ROADMAP.md, "TPU levers not ported"): every exchange here is K10 or a row
copy, and the port's stencils launch on every CUDA tensor.
"""

from __future__ import annotations

from typing import Callable, Tuple

from live_video_magnification_tpu_torch.models.color import ColorState
from live_video_magnification_tpu_torch.models.motion import MotionState
from live_video_magnification_tpu_torch.models.params import MagnificationMode
from live_video_magnification_tpu_torch.models.riesz import RieszState
from live_video_magnification_tpu_torch.parallel.mesh import Mesh
from live_video_magnification_tpu_torch.parallel.riesz_sharded import (
    _tree_map,
    build_sharded_riesz_step,
    make_plan,
    place_row,
    tile_rows,
)
from live_video_magnification_tpu_torch.parallel.row_sharded import (
    build_row_sharded_step,
    mode_row_plan,
    state_layout,
)

_MODE_OF = {RieszState: MagnificationMode.PHASE, MotionState: MagnificationMode.LAPLACE,
            ColorState: MagnificationMode.COLOR}


def sharded_plan(mesh: Mesh, mode: MagnificationMode, h: int, w: int, levels: int):
    """The plan ``build_sharded_step`` lays frames and state out by: the lane
    plan for phase where level 0 lane-shards, else the mode's row plan."""
    n = mesh.shape["tile"]
    if mode is MagnificationMode.PHASE:
        plan = make_plan(h, w, levels, n)
        if plan.sharded[0]:
            return plan
    return mode_row_plan(mode, h, w, levels, n)


def build_sharded_step(
    mesh: Mesh,
    mode: MagnificationMode,
    batch: int,
    h: int,
    w: int,
    levels: int,
    framerate: float = 30.0,
    channels: int = 3,
) -> Tuple[Callable, object]:
    """(step, initial state) of a batched, sharded mode step:
    step(state, frames_u8 [B,C,H,W], dyn) -> (state, outs [B,C,H,W]), the
    outputs gathered on the mesh's first device.

    Phase with a width that lane-shards at level 0 takes
    build_sharded_riesz_step; every other mode and shape the row-sharded
    step of ``build_row_sharded_step`` (``framerate`` for colour,
    ``channels`` for motion and colour)."""
    plan = sharded_plan(mesh, mode, h, w, levels)
    if mode is MagnificationMode.PHASE and plan.axis == -1:
        return build_sharded_riesz_step(mesh, batch, h, w, levels)
    return build_row_sharded_step(mesh, mode, batch, h, w, levels, framerate, channels)


def shard_batched_state(state, mesh: Mesh, plan):
    """A global batched state onto the mesh by ``plan`` (``sharded_plan``
    of the step it feeds): ``state`` is a RieszState, MotionState or
    ColorState whose count is [B] and whose planes are global [B, ...]
    tensors or numpy arrays (a checkpoint, or the reference's sharded state
    through ``convert.py``). Returns the step's state: per batch element, the
    tuple of its tile row's per-shard states."""
    if type(state) not in _MODE_OF:
        raise TypeError(f"not a mode state: {type(state).__name__}")
    layout = state_layout(_MODE_OF[type(state)], plan)
    batch = len(state[0])
    return tuple(place_row(layout, _tree_map(lambda x, b=b: x[b], state), devices, plan)
                 for b, devices in enumerate(tile_rows(mesh, batch)))
