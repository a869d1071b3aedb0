"""Carried state and dynamic parameters between the JAX package and the port.

The system has no weights: what must cross from a JAX run to a port run is the
carried temporal state. Both packages lay it out as the same nested
NamedTuples, so a state is a flat list of leaves in ``jax.tree.flatten`` order.
Phase: ``count``, then per level ``old`` (lowpass, cos, sin), per active level
``acc`` (cos, sin), ``lo`` (reg0.cos, reg0.sin, reg1.cos, reg1.sin) and ``hi``
(the same). Motion: ``count``, the levels+1 ``lowpass_hi`` planes, then the
levels+1 ``lowpass_lo`` planes. Colour: ``count`` and the ``window``.
Checkpoints (``export/batch.py``) use the same order; ``count`` is a host int
in the port.

The sharded steps (``parallel/riesz_sharded.py``, lane-sharded phase;
``parallel/row_sharded.py``, row-sharded motion, colour and phase) carry,
per batch element, one mode state per tile shard; the reference's sharded
step carries one batched state of global [B, ...] leaves. The functions at
the end map one to the other for a given mesh and plan, in each mode.

This module imports no JAX: callers hand over numpy arrays.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from live_video_magnification_tpu_torch.device import resolve_device
from live_video_magnification_tpu_torch.models import color as color_mode
from live_video_magnification_tpu_torch.models import motion as motion_mode
from live_video_magnification_tpu_torch.models.riesz import RieszDynParams, init_state
from live_video_magnification_tpu_torch.models.params import MagnificationMode
from live_video_magnification_tpu_torch.parallel.row_sharded import state_layout
from live_video_magnification_tpu_torch.parallel.sharding import shard_batched_state


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves of nested tuples / NamedTuples, depth first, in field order."""
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_unflatten(like: Any, leaves: Sequence[Any]) -> Any:
    """A tree shaped as ``like`` holding ``leaves`` in tree_leaves order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, tuple):
            children = [build(c) for c in node]
            return type(node)(*children) if hasattr(node, "_fields") else tuple(children)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def state_to_numpy(state: Any) -> List[np.ndarray]:
    """The state's leaves as host numpy arrays (count as an int32 scalar).
    bfloat16 leaves come out as float32, which holds them exactly: numpy has
    no bfloat16."""
    return [
        (leaf.detach().float() if leaf.dtype == torch.bfloat16 else leaf.detach()).cpu().numpy()
        if isinstance(leaf, torch.Tensor) else np.asarray(leaf, np.int32)
        for leaf in tree_leaves(state)
    ]


def state_from_numpy(like: Any, leaves: Sequence[np.ndarray], device) -> Any:
    """Leaves from ``state_to_numpy`` (or a JAX run) in the layout of ``like``,
    cast to its leaf dtypes. An int leaf of ``like`` (the frame count) stays a
    host int. Floating leaves go through float32, so a bfloat16 array of any
    library that numpy can cast (JAX's) is taken as well."""
    ref = tree_leaves(like)
    if len(ref) != len(leaves):
        raise ValueError(f"expected {len(ref)} state leaves, got {len(leaves)}")
    out = []
    for r, leaf in zip(ref, leaves):
        floating = isinstance(r, torch.Tensor) and r.is_floating_point()
        a = np.asarray(leaf, np.float32) if floating else np.asarray(leaf)
        if isinstance(r, torch.Tensor):
            if tuple(a.shape) != tuple(r.shape):
                raise ValueError(f"state leaf shape {a.shape} != expected {tuple(r.shape)}")
            out.append(torch.tensor(a, dtype=r.dtype, device=device))
        else:
            out.append(int(a))
    return tree_unflatten(like, out)


def _f32(v) -> float:
    return float(np.asarray(v, np.float32))


def riesz_state_from_jax(leaves: Sequence[np.ndarray], device=None,
                         pyr_io: Optional[str] = None):
    """The port's RieszState from the JAX RieszState's leaves (numpy, in
    ``jax.tree.flatten`` order), on ``device`` (CUDA by default). ``pyr_io``
    is the dtype of the carried band levels; by default the first leaf of the
    prior pyramid tells it (a JAX state under LVMT_PYR_IO=bf16 carries
    bfloat16 band levels)."""
    n = len(leaves)
    if (n + 9) % 13:
        raise ValueError(f"{n} leaves is not a RieszState (13*levels - 9 leaves)")
    levels = (n + 9) // 13
    h, w = np.shape(leaves[1])
    if pyr_io is None:
        pyr_io = "bf16" if str(np.asarray(leaves[1]).dtype) == "bfloat16" else "f32"
    dev = resolve_device(device)
    like = init_state(h, w, levels, device="cpu", pyr_io=pyr_io)
    return state_from_numpy(like, leaves, dev)


def riesz_dyn_from_jax(dyn: Any) -> RieszDynParams:
    """The port's RieszDynParams from a JAX RieszDynParams (or any 8-tuple of
    array-likes in its field order)."""
    c3 = lambda v: tuple(float(x) for x in np.asarray(v, np.float32).reshape(3))
    amp, thr, b_lo, a_lo, b_hi, a_hi, reset, force = dyn
    return RieszDynParams(_f32(amp), _f32(thr), c3(b_lo), c3(a_lo), c3(b_hi), c3(a_hi),
                          bool(np.asarray(reset)), bool(np.asarray(force)))


def motion_state_from_jax(leaves: Sequence[np.ndarray], device=None) -> motion_mode.MotionState:
    """The port's MotionState from the JAX MotionState's leaves (numpy, in
    ``jax.tree.flatten`` order: count, levels+1 hi planes, levels+1 lo
    planes), on ``device`` (CUDA by default)."""
    n = len(leaves)
    if n < 5 or (n - 1) % 2:
        raise ValueError(f"{n} leaves is not a MotionState (2*(levels+1) + 1 leaves)")
    levels = (n - 1) // 2 - 1
    channels, h, w = np.shape(leaves[1])
    like = motion_mode.init_state(h, w, channels, levels, device="cpu")
    return state_from_numpy(like, leaves, resolve_device(device))


def color_state_from_jax(leaves: Sequence[np.ndarray], device=None) -> color_mode.ColorState:
    """The port's ColorState from the JAX ColorState's leaves (count, window)."""
    if len(leaves) != 2 or np.ndim(leaves[1]) != 4:
        raise ValueError("a ColorState is two leaves: count and a [W, C, hs, ws] window")
    return color_mode.ColorState(int(np.asarray(leaves[0])),
                                 torch.tensor(np.asarray(leaves[1], np.float32),
                                              device=resolve_device(device)))


def motion_dyn_from_jax(dyn: Any) -> motion_mode.MotionDynParams:
    """The port's MotionDynParams from a JAX MotionDynParams (or any 5-tuple
    of array-likes in its field order)."""
    return motion_mode.MotionDynParams(*(_f32(v) for v in dyn))


def color_dyn_from_jax(dyn: Any) -> color_mode.ColorDynParams:
    """The port's ColorDynParams from a JAX ColorDynParams (or any 3-tuple)."""
    return color_mode.ColorDynParams(*(_f32(v) for v in dyn))


def _sharded_from_jax(mode: MagnificationMode, leaves: Sequence[np.ndarray], mesh, plan):
    """``shard_batched_state`` of the batched state whose leaves (global
    [B, ...], in ``jax.tree.flatten`` order) are ``leaves``."""
    layout = state_layout(mode, plan)
    if len(leaves) != len(tree_leaves(layout)):
        raise ValueError(f"expected {len(tree_leaves(layout))} state leaves, got {len(leaves)}")
    return shard_batched_state(tree_unflatten(layout, [np.asarray(x) for x in leaves]), mesh,
                               plan)


def _sharded_to_jax(mode: MagnificationMode, state, plan) -> List[np.ndarray]:
    """Global [B, ...] numpy leaves (the count as int32 [B]) of a sharded
    step's state: sharded levels concatenated over the tile row along
    ``plan.axis``, the others from its first shard."""
    rows = [[tree_leaves(s) for s in row] for row in state]
    out = []
    for j, l in enumerate(tree_leaves(state_layout(mode, plan))):
        if l < 0:
            out.append(np.asarray([row[0][j] for row in rows], np.int32))
            continue
        per_b = [np.concatenate([s[j].detach().cpu().numpy() for s in row], axis=plan.axis)
                 if plan.sharded[l] else row[0][j].detach().cpu().numpy() for row in rows]
        out.append(np.stack(per_b))
    return out


def sharded_riesz_state_from_jax(leaves: Sequence[np.ndarray], mesh, plan):
    """A sharded phase step's state from the reference sharded step's
    (batched RieszState leaves as global [B, ...] numpy arrays, in
    ``jax.tree.flatten`` order): per batch element, the tuple of its tile
    row's per-shard RieszStates; sharded levels as the shard's strip (of W
    on a lane plan, of H on a row plan), the others whole. f32 leaves."""
    return _sharded_from_jax(MagnificationMode.PHASE, leaves, mesh, plan)


def sharded_riesz_state_to_jax(state, plan) -> List[np.ndarray]:
    """The inverse of ``sharded_riesz_state_from_jax``."""
    return _sharded_to_jax(MagnificationMode.PHASE, state, plan)


def sharded_motion_state_from_jax(leaves: Sequence[np.ndarray], mesh, plan):
    """The row-sharded motion step's state from the reference sharded
    step's batched MotionState leaves (count, then the levels+1 hi and lo
    planes, global [B, C, h, w])."""
    return _sharded_from_jax(MagnificationMode.LAPLACE, leaves, mesh, plan)


def sharded_motion_state_to_jax(state, plan) -> List[np.ndarray]:
    """The inverse of ``sharded_motion_state_from_jax``."""
    return _sharded_to_jax(MagnificationMode.LAPLACE, state, plan)


def sharded_color_state_from_jax(leaves: Sequence[np.ndarray], mesh, plan):
    """The row-sharded colour step's state from the reference sharded
    step's batched ColorState leaves (count [B], window [B, W, C, hs, ws])."""
    return _sharded_from_jax(MagnificationMode.COLOR, leaves, mesh, plan)


def sharded_color_state_to_jax(state, plan) -> List[np.ndarray]:
    """The inverse of ``sharded_color_state_from_jax``."""
    return _sharded_to_jax(MagnificationMode.COLOR, state, plan)
