"""The mesh collectives, written out (the port's own module: the reference
has no counterpart, since GSPMD inserts its collectives).

Placement is explicit SPMD: one process per rank, each holding its own
shards (``training/checkpoint.py::shard``) and computing on them; the
collectives below, over one axis of a ``DeviceMesh`` (``model``,
``data``, the FSDP group ``(pod, data)`` or the whole mesh), are the only
places where ranks meet:

  * ``all_reduce``      the row-parallel partial sums (``wo``, MLP
                        ``down``, the expert-parallel MoE's routed and
                        shared partials), the vocab-parallel embedding
                        lookup and the FSDP read-out's partial logits;
  * ``all_gather``      the vocab-parallel logits, the sub-selected queries,
                        QUOKA's (score, index) candidates, FSDP weight
                        shards, a sequence-sharded cache's whole slices
                        (for dense attention) and the MoE's per-expert
                        counts;
  * ``all_reduce_max``  the head-shared block plan's max over KV heads
                        when the KV heads are sharded;
  * ``broadcast``       a sequence-sharded cache's selected rows, from
                        the rank that holds them; and rank 0's clock,
                        over the whole mesh, which the serving scheduler
                        runs on, so every rank takes the same decisions.

``axis(mesh, name)`` takes an axis name, or a tuple of names for their
flattened product (the FSDP group ``("pod", "data")``, built with
``dist.new_group`` by every rank in the same order; ``DeviceMesh``'s own
flattening is private API); an axis the mesh lacks has size 1, and a
collective over a size-1 axis returns its input without meeting anyone.

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
its result bytes, an all-reduce twice its bytes, a broadcast its
bytes once.  ``scope(name)`` labels
the collectives of a stretch of code: ``score`` the scoring pass,
``fsdp`` the weight gathers (and the embedding rows and read-out sums
that stand in for gathering the embedding), ``seq`` a sequence-sharded
cache's row and slice moves, ``ep`` the expert-parallel MoE's sum over
``model`` and its capacity ranking's (E,) int32 counts gathered over the
FSDP group (``models/moe.py``), ``loss`` a training loss's sums over the
FSDP group (``models/model.py``); the rest count under ``""``.

Gradients (training).  ``all_reduce``, ``all_gather`` /
``all_gather_parts`` (and so ``layers.gather_weights``, the FSDP
gather) are ``torch.autograd.Function``s; under ``torch.no_grad``
(serving) autograd records nothing and they move what they moved
before.  The convention: a tensor that the ranks of an axis hold alike
(replicated: the residual stream over ``model``, a weight gathered over
the FSDP group, the loss on every rank) has on each rank the PARTIAL
gradient of that rank's own uses of it, and its whole gradient is the
sum over the ranks; a tensor a rank holds alone (a shard, a partial
product, its own rows) has its whole gradient.  Every op keeps to it:

  * ``all_reduce``'s backward is an all-reduce of the output's partials;
  * an all-gather's backward reduce-scatters them: each rank receives
    the sum of every rank's gradient of its part (an FSDP gather's
    reduces the whole weight's gradient into the rank's shard);
  * the entry of a tensor-parallel region (a replicated input that each
    rank multiplies by its own heads', experts' or channels' weights, or
    reads a subset of, as ``HeadShard.take``) is the identity forward
    and backward: each rank's gradient of it is the partial of its own
    heads, and the sum it needs is made where the partials meet, in the
    backward of the region's exit (the row-parallel all-reduce, the
    gathers) and, for a leaf replicated over an axis, in the sum of its
    gradient over that axis (``training/loop.py``);
  * the loss, replicated on every rank, seeds the backward once: 1 on
    the mesh's first rank, 0 on the others (``seed``).

Backward bytes count under the scope ``grad`` (by kind: ``all_reduce``,
``reduce_scatter``), whatever scope the forward ran in; a layer's
forward re-run in the backward under ``remat`` (``models/stack.py``)
counts under ``remat``.  A reduce-scatter counts its result bytes, as an
all-gather does; a backend that refuses one raises.
"""
from __future__ import annotations

import contextlib
import math
from collections import defaultdict
from typing import Dict, List, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.sharding.specs import mesh_shape

BYTES: Dict[Tuple[str, str], int] = defaultdict(int)
_SCOPE = [""]
_LABEL: List[str] = []     # a label that overrides every scope (``label``)


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


@contextlib.contextmanager
def label(name: str):
    """Count every collective of a stretch of code under ``name``,
    whatever ``scope`` its own code names (the backward's ``grad``, the
    recompute's ``remat``)."""
    _LABEL.append(name)
    try:
        yield
    finally:
        _LABEL.pop()


def _note(kind: str, nbytes: int) -> None:
    BYTES[(_LABEL[-1] if _LABEL else _SCOPE[-1], kind)] += int(nbytes)


class Axis:
    """One mesh axis (or the flattened product of a tuple of axes) as this
    rank sees it: its process group, size, this rank's coordinate on it,
    the global rank of each coordinate (``ranks``; ``root`` the first)
    and the group's backend.  An axis the mesh lacks has size 1 and no
    group."""

    def __init__(self, mesh, name: Union[str, Tuple[str, ...]] = "model"):
        self.mesh = mesh
        self.name = name
        shape = mesh_shape(mesh)
        names = tuple(n for n in ((name,) if isinstance(name, str) else name)
                      if n in shape)
        self.size = int(math.prod(shape[n] for n in names))
        self.group, self.rank, self.ranks = None, 0, [dist.get_rank()]
        if len(names) == 1:
            self.group = mesh.get_group(names[0])
            self.rank = mesh.get_local_rank(names[0])
            self.ranks = [dist.get_global_rank(self.group, c)
                          for c in range(self.size)]
        elif names:
            self.group, self.rank, self.ranks = _flat_group(mesh, names)
        self.root = self.ranks[0]
        self.backend = str(dist.get_backend(self.group))


def _flat_group(mesh, names):
    """(group, coordinate, ranks) of the flattened product of ``names``
    (in the mesh's axis order, the first major): every rank creates the
    group of every coordinate of the other axes, in one order, and keeps
    its own; or the default group when ``names`` span the whole world."""
    dims = list(mesh.mesh_dim_names)
    grid = mesh.mesh
    keep = [dims.index(n) for n in dims if n in names]
    rest = [i for i in range(len(dims)) if i not in keep]
    rows = grid.permute(*rest, *keep).reshape(-1, math.prod(
        grid.shape[i] for i in keep)).tolist()
    me = dist.get_rank()
    if len(rows) == 1 and len(rows[0]) == dist.get_world_size():
        return None, rows[0].index(me), rows[0]
    mine = None
    for ranks in rows:
        g = dist.new_group(ranks)
        if me in ranks:
            mine = (g, ranks.index(me), ranks)
    return mine


_AXES: Dict[Tuple[int, object], Axis] = {}


def axis(mesh, name: Union[str, Tuple[str, ...]] = "model") -> Axis:
    key = (id(mesh), name)
    ax = _AXES.get(key)
    if ax is None or ax.mesh is not mesh:
        ax = _AXES[key] = Axis(mesh, name)
    return ax


def world(mesh) -> Axis:
    """Every rank of ``mesh`` as one axis (the serve clock's)."""
    return axis(mesh, tuple(mesh_shape(mesh)))


def _reduce(x: torch.Tensor, ax: Axis, op, kind: str) -> torch.Tensor:
    if ax.size == 1:
        return x.clone()
    y = x.clone()
    dist.all_reduce(y, op=op, group=ax.group)
    _note(kind, 2 * y.numel() * y.element_size())
    return y


class _AllReduce(torch.autograd.Function):
    """The sum over ``ax``; its backward sums the output's partial
    gradients over ``ax`` (module docstring)."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _reduce(x, ax, dist.ReduceOp.SUM, "all_reduce")

    @staticmethod
    def backward(ctx, g):
        with label("grad"):
            return _reduce(g, ctx.ax, dist.ReduceOp.SUM, "all_reduce"), None


def all_reduce(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The sum of every rank's ``x`` (a new tensor, ``x``'s dtype)."""
    return _AllReduce.apply(x, ax)


def all_reduce_max(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The elementwise max over the ranks (exact in any order); no
    backward (serving only)."""
    return _reduce(x, ax, dist.ReduceOp.MAX, "all_reduce_max")


def _gather(x: torch.Tensor, ax: Axis) -> List[torch.Tensor]:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x, group=ax.group)
    _note("all_gather", ax.size * x.numel() * x.element_size())
    return parts


def reduce_scatter(parts: List[torch.Tensor], ax: Axis) -> torch.Tensor:
    """The sum over the ranks of ``parts[c]`` (one tensor per coordinate
    of ``ax``, one shape), on coordinate ``c``."""
    if ax.size == 1:
        return parts[0]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, [p.contiguous() for p in parts],
                        group=ax.group)
    _note("reduce_scatter", out.numel() * out.element_size())
    return out


class _AllGather(torch.autograd.Function):
    """Every rank's ``x`` in rank order; its backward reduce-scatters the
    parts' partial gradients, so each rank receives the whole gradient
    of its own part (module docstring)."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return tuple(_gather(x, ax))

    @staticmethod
    def backward(ctx, *gs):
        with label("grad"):
            return reduce_scatter(list(gs), ctx.ax), None


def all_gather_parts(x: torch.Tensor, ax: Axis) -> List[torch.Tensor]:
    """Every rank's ``x`` (one shape on every rank), in rank order."""
    if ax.size == 1:
        return [x]
    return list(_AllGather.apply(x, ax))


def all_gather(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    parts = all_gather_parts(x, ax)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def broadcast(x: torch.Tensor, ax: Axis, src: int) -> torch.Tensor:
    """Coordinate ``src``'s ``x`` on every rank of ``ax``: every rank
    passes a contiguous tensor of one shape and dtype, which the others'
    receive into (no backward: serving only)."""
    if ax.size == 1:
        return x
    dist.broadcast(x, src=ax.ranks[src], group=ax.group)
    _note("broadcast", x.numel() * x.element_size())
    return x


def broadcast_float(v: float, ax: Axis, device) -> float:
    """Rank 0's host value ``v`` on every rank: a float64 on the card for
    NCCL, in host memory for gloo."""
    if ax.size == 1:
        return v
    t = torch.tensor([v], dtype=torch.float64,
                     device=device if ax.backend == "nccl" else "cpu")
    dist.broadcast(t, src=ax.root, group=ax.group)
    _note("broadcast", t.numel() * t.element_size())
    return float(t.item())


def seed(mesh) -> float:
    """The gradient a rank seeds the replicated loss's backward with: 1
    on the mesh's first rank, 0 on the others, so the ranks' partials sum
    to the loss's one seed (module docstring); 1 meshless."""
    return 1.0 if mesh is None or dist.get_rank() == world(mesh).root \
        else 0.0


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
    ``model=3``).  MLA's latent is one KV head (``n_kv`` 1) that every
    query head reads."""

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
            elif h_loc == 1 or n_kv == 1:
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
