"""Sharding policy (counterpart of ``repro/sharding/ctx.py``).

The policy is process-global and set by the serving engine (or a
launcher) for the duration of its calls, as the reference's is.  Unlike
the reference's selection code, the port's does not read it: a sharded
attention layer's ``comm.HeadShard`` (set by ``AttnBlock.place``) names
the ``model`` axis and decides QUOKA's sharded routes and the fused
route (``core/plan.py``), so one fact has one channel.

The reference's ``shard_batch``, ``shard_activation``, ``shard_heads``
and ``shard_spec`` are ``with_sharding_constraint`` hints to GSPMD.  The
port places every tensor explicitly (each rank holds and computes its own
shards, ``sharding/comm.py`` carries the collectives), so they have no
counterpart here.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.sharding.specs import mesh_shape

_BATCH_AXES: Optional[Tuple[str, ...]] = None
_MODEL_AXIS: Optional[str] = None
_MESH = None


def set_policy(mesh, batch_axes, model_axis="model"):
    global _BATCH_AXES, _MODEL_AXIS, _MESH
    _MESH = mesh
    _BATCH_AXES = tuple(batch_axes) if batch_axes else None
    _MODEL_AXIS = model_axis if (mesh is not None
                                 and model_axis in mesh_shape(mesh)) else None


def clear_policy():
    set_policy(None, None)


def get_policy():
    """Snapshot of (mesh, batch_axes, model_axis): pass it back to
    ``restore_policy`` so a nested scope does not clobber an outer one."""
    return _MESH, _BATCH_AXES, _MODEL_AXIS


def restore_policy(snap) -> None:
    global _BATCH_AXES, _MODEL_AXIS, _MESH
    _MESH, _BATCH_AXES, _MODEL_AXIS = snap


def tp_shard_info():
    """(mesh, model_axis, batch_axes) when a policy with a >1-way model
    axis is active, else None: the switch of the T-local scoring route."""
    if _MESH is None or _MODEL_AXIS is None:
        return None
    if mesh_shape(_MESH)[_MODEL_AXIS] <= 1:
        return None
    return _MESH, _MODEL_AXIS, _BATCH_AXES


class policy:
    """``with policy(mesh, batch_axes):`` sets the policy and restores
    the previous one on exit."""

    def __init__(self, mesh, batch_axes, model_axis="model"):
        self.args = (mesh, batch_axes, model_axis)

    def __enter__(self):
        self.snap = get_policy()
        set_policy(*self.args)
        return self

    def __exit__(self, *exc):
        restore_policy(self.snap)
        return False
