"""The tensor-parallel collectives, written out (the port's own module: the
reference has no counterpart, since GSPMD inserts its collectives).

Placement is explicit SPMD: one process per rank, each holding its own
shards (``training/checkpoint.py::shard``) and computing on them; the
collectives below, over the ``model`` axis of a ``DeviceMesh``, are the
only places where ranks meet:

  * ``all_reduce``      the row-parallel partial sums (``wo``, MLP
                        ``down``) and the vocab-parallel embedding lookup;
  * ``all_gather``      the vocab-parallel logits, the sub-selected queries
                        and QUOKA's (score, index) candidates;
  * ``all_reduce_max``  the head-shared block plan's max over KV heads
                        when the KV heads are sharded;
  * ``broadcast``       rank 0's clock, which the serving scheduler runs
                        on, so every rank takes the same decisions.

Backends: NCCL when every rank has a card of its own; gloo when ranks
share one card (``launch/mesh.py``).  gloo runs every collective used
here on CUDA tensors, moving them through host memory itself: checked on
the H100 with torch 2.11 (``chip_smoke.py`` phase 33's probe: all-reduce
sum and max, broadcast and all-gather give the right values), although
``torch.distributed``'s backend table lists only all-reduce and
broadcast.  So this module moves no tensor to the host; a collective a
backend refuses raises.  Compute stays where the tensors are.

``BYTES`` counts by (scope, kind), as the reference's
``analysis/hlo.py::collective_bytes`` counts an HLO module: an all-gather
its result bytes, an all-reduce twice its bytes.  ``scope("score")``
labels the collectives of a stretch of code (the scoring pass labels
its own), the rest count under ``""``.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.sharding.specs import mesh_shape

BYTES: Dict[Tuple[str, str], int] = defaultdict(int)
_SCOPE = [""]


def reset_counts() -> None:
    BYTES.clear()


def bytes_by_kind(scope=None) -> Dict[str, int]:
    """{kind: bytes} in ``scope`` (all scopes when None)."""
    out: Dict[str, int] = defaultdict(int)
    for (s, kind), n in BYTES.items():
        if scope is None or s == scope:
            out[kind] += n
    return dict(out)


@contextlib.contextmanager
def scope(name: str):
    _SCOPE.append(name)
    try:
        yield
    finally:
        _SCOPE.pop()


def _note(kind: str, nbytes: int) -> None:
    BYTES[(_SCOPE[-1], kind)] += int(nbytes)


class Axis:
    """One mesh axis as this rank sees it: its process group, size, this
    rank's coordinate on it and the group's backend."""

    def __init__(self, mesh, name: str = "model"):
        self.mesh = mesh
        self.name = name
        self.size = mesh_shape(mesh)[name]
        self.group = mesh.get_group(name)
        self.rank = mesh.get_local_rank(name)
        self.backend = str(dist.get_backend(self.group))


_AXES: Dict[Tuple[int, str], Axis] = {}


def axis(mesh, name: str = "model") -> Axis:
    key = (id(mesh), name)
    ax = _AXES.get(key)
    if ax is None or ax.mesh is not mesh:
        ax = _AXES[key] = Axis(mesh, name)
    return ax


def _reduce(x: torch.Tensor, ax: Axis, op, kind: str) -> torch.Tensor:
    y = x.clone()
    dist.all_reduce(y, op=op, group=ax.group)
    _note(kind, 2 * y.numel() * y.element_size())
    return y


def all_reduce(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The sum of every rank's ``x`` (a new tensor, ``x``'s dtype)."""
    return _reduce(x, ax, dist.ReduceOp.SUM, "all_reduce")


def all_reduce_max(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The elementwise max over the ranks (exact in any order)."""
    return _reduce(x, ax, dist.ReduceOp.MAX, "all_reduce_max")


def all_gather(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x, group=ax.group)
    out = torch.cat(parts, dim=dim)
    _note("all_gather", out.numel() * out.element_size())
    return out


def broadcast_float(v: float, ax: Axis, device) -> float:
    """Rank 0's host value ``v`` on every rank: a float64 on the card for
    NCCL, in host memory for gloo."""
    t = torch.tensor([v], dtype=torch.float64,
                     device=device if ax.backend == "nccl" else "cpu")
    dist.broadcast(t, src=dist.get_global_rank(ax.group, 0), group=ax.group)
    _note("broadcast", t.numel() * t.element_size())
    return float(t.item())


class HeadShard:
    """This rank's share of an attention layer's heads under tensor
    parallelism: query heads ``h0 .. h0 + h_loc`` of ``n_heads``, and the
    KV heads its cache holds (``n_kv`` of them are the model's): its own
    aligned ``n_kv / M`` when ``kv_sharded``, else all of them
    (replicated, as ``specs.param_specs`` leaves an indivisible KV-head
    axis).

    The attention kernels assume ``kv = h // group`` locally.  ``take``
    hands them the KV heads this rank's query heads read: a view of the
    aligned range when the rank's heads are whole groups (or one head),
    else one KV head per query head by an index (group 1 locally; a rank
    whose groups straddle ranks, e.g. llama3-2-3b's 8 heads of group 3 on
    ``model=3``)."""

    def __init__(self, ax: Axis, n_heads: int, n_kv: int, h_loc: int,
                 kv_held: int, device):
        self.ax = ax
        self.n_heads, self.n_kv, self.h_loc = n_heads, n_kv, h_loc
        self.heads_sharded = h_loc < n_heads
        self.kv_sharded = kv_held < n_kv
        self.h0 = ax.rank * h_loc if self.heads_sharded else 0
        group = n_heads // n_kv
        self.kv_range = self.kv_idx = None   # None, None: the held heads
        if self.heads_sharded and not self.kv_sharded:
            if self.h0 % group == 0 and h_loc % group == 0:
                self.kv_range = (self.h0 // group, h_loc // group)
            elif h_loc == 1:
                self.kv_range = (self.h0 // group, 1)
            else:
                self.kv_idx = torch.tensor(
                    [(self.h0 + j) // group for j in range(h_loc)],
                    dtype=torch.long, device=device)

    def take(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x``'s KV-head axis ``dim`` cut to the heads this rank reads."""
        if self.kv_range is not None:
            return x.narrow(dim, *self.kv_range)
        return x if self.kv_idx is None else x.index_select(dim, self.kv_idx)
