"""Sharding over a mesh of devices: the mesh, the halo exchanges, the
lane-sharded (W-axis) Riesz step and the row-sharded (H-axis) steps of
every mode behind ``build_sharded_step``; the time mesh of the batch export (its
boundary step in ``time_shard.py``) and the multi-process bring-up.

The names below load on first use: ``time_shard`` sits under ``models/``,
which ``batch_export`` imports in turn."""

_EXPORTS = {
    "make_mesh": "mesh",
    "Mesh": "mesh",
    "build_sharded_step": "sharding",
    "shard_batched_state": "sharding",
    "sharded_plan": "sharding",
    "TimeShards": "time_shard",
    "DistributedClipExporter": "batch_export",
    "export_video_distributed": "batch_export",
    "distributed": None,
}


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    module = importlib.import_module(f"{__name__}.{_EXPORTS[name] or name}")
    return module if _EXPORTS[name] is None else getattr(module, name)


__all__ = list(_EXPORTS)
