"""QUOKA scoring primitives, paper Algorithm 1 stages 1-3 (counterpart of
``repro/core/quoka.py``).

  1. query subselection: keep the ``N_Q`` queries least cosine-similar to
     the chunk's mean query, group-coherently under GQA;
  2. cosine scoring of the kept normalised queries against normalised keys;
  3. max over queries, with queries pre-aggregated (mean) inside each KV
     group before the product.

Layouts: q (b, t, n_q_heads, d); caches (b, T, n_kv, d); key positions
(b, T) int32 with -1 marking empty slots.

Tensor parallelism (``sharding/``): ``subselect_queries_tp`` gives every
rank every head's sub-selected queries when the query heads are sharded
and the KV heads are not, moving only the per-token dissimilarities and
the kept queries; ``_tp_route`` / ``tp_plan_candidates`` are the
reference's T-local route: each rank scores a contiguous ``T / M`` slice
of the keys it holds and the ranks merge (score, index) candidates, never
the K cache.  A cache whose sequence is split over ``data`` takes the
same merge (``plan_candidates``) over ``data``: each rank scores the
slots it holds (and, where the T-local route applies, its ``model``
rank's part of them, merged over ``model`` first).  ``ROUTES`` counts the
scoring calls of each route under a mesh.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import QuokaConfig
from repro_torch.core.attention import NEG_INF
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import l2_normalize
from repro_torch.sharding import comm

#: scoring calls by route under a mesh: ``t_local`` (candidates merged),
#: ``replicated`` (every KV head on the replicated cache: the route's
#: conditions failed, the reference's rule), ``kv_heads`` (this rank's own
#: KV heads, when they shard); on a sequence-sharded cache ``seq`` (this
#: rank's slots, candidates merged over ``data``) and ``seq_t_local``
#: (its ``model`` rank's part of them, merged over ``model``, then
#: ``data``)
ROUTES = {"t_local": 0, "replicated": 0, "kv_heads": 0, "seq": 0,
          "seq_t_local": 0}


class Selected(NamedTuple):
    """A gathered KV budget; -1 in ``pos`` / ``idx`` marks padding."""
    k: torch.Tensor       # (b, B, n_kv, d)
    v: torch.Tensor       # (b, B, n_kv, d)
    pos: torch.Tensor     # (b, n_kv, B) int32
    idx: torch.Tensor     # (b, n_kv, B) cache slots


def topk_stable(x, k: int, dim: int = -1):
    """Top-k in ``jax.lax.top_k``'s order: descending, ties at the lower
    index first (``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


def sanitize_queries(q, q_valid: Optional[torch.Tensor]):
    """Replace invalid query rows with a copy of the row's first valid
    query, so padding can never change a max-aggregated score."""
    if q_valid is None:
        return q
    first = torch.argmax(q_valid.to(torch.int32), dim=1)          # (b,)
    repl = q[torch.arange(q.shape[0], device=q.device), first][:, None]
    return torch.where(q_valid[:, :, None, None], q, repl)


def subselect_queries(q, n_queries: int, n_kv: Optional[int] = None,
                      q_valid: Optional[torch.Tensor] = None):
    """Keep the ``n_queries`` queries with lowest CosSim to the mean query.

    q: (b, t, h, d) -> (b, n_queries, h, d); unchanged when t <= n_queries.
    With ``n_kv`` the dissimilarity is averaged over each GQA group and all
    heads of a group keep the same tokens.  ``q_valid`` (b, t) keeps padding
    out of the mean and ranks it last."""
    if q.shape[1] <= n_queries:
        return q
    top_i = _kept_tokens(_dissimilarity(q, q_valid), n_queries, n_kv)
    return _gather_tokens(q, top_i)


def _dissimilarity(q, q_valid):
    """(b, t, h) fp32: minus each query's CosSim to its head's mean query
    (padding out of the mean and ranked last).  Per head: a shard of the
    heads gives the same numbers for its heads."""
    qf = q.float()
    if q_valid is not None:
        w = q_valid[:, :, None, None].float()
        cnt = w.sum(1, keepdim=True).clamp(min=1.0)
        mq = (qf * w).sum(1, keepdim=True) / cnt
    else:
        mq = qf.mean(1, keepdim=True)
    num = (qf * mq).sum(-1)
    den = qf.norm(dim=-1) * mq.norm(dim=-1) + 1e-8
    s_q = -(num / den)                                            # (b, t, h)
    if q_valid is not None:
        s_q = torch.where(q_valid[:, :, None], s_q,
                          torch.full_like(s_q, float("-inf")))
    return s_q


def _kept_tokens(s_q, n_queries: int, n_kv: Optional[int]):
    """(b, h, N_Q) token indices each head keeps: group-coherent under
    GQA (the group's mean dissimilarity)."""
    b, t, h = s_q.shape
    if n_kv is not None and n_kv != h:
        group = h // n_kv
        s_g = s_q.reshape(b, t, n_kv, group).mean(3)              # (b, t, n_kv)
        _, top_g = topk_stable(s_g.transpose(1, 2), n_queries)
        return top_g.repeat_interleave(group, dim=1)              # (b, h, N_Q)
    _, top_i = topk_stable(s_q.transpose(1, 2), n_queries)
    return top_i


def _gather_tokens(q, top_i):
    """q (b, t, h, d) at per-head token indices (b, h, N_Q) ->
    (b, N_Q, h, d)."""
    gathered = torch.gather(q.transpose(1, 2), 2,
                            top_i[..., None].expand(-1, -1, -1, q.shape[-1]))
    return gathered.transpose(1, 2)


def subselect_queries_tp(q, n_queries: int, heads: comm.HeadShard,
                         q_valid: Optional[torch.Tensor] = None):
    """``subselect_queries`` over every head when this rank holds only
    query heads ``heads.h0 ..`` of q (b, t, h_loc, d): the ranks gather
    the (b, t, h) dissimilarities (a GQA group may straddle ranks), each
    keeps its own heads' queries at the group's tokens, and the ranks
    gather those: (b, N_Q, n_heads, d), the same on every rank and equal
    to the meshless sub-selection.  The chunk's queries themselves never
    move (a decode step's single query does: it is the sub-selection)."""
    ax = heads.ax
    if q.shape[1] <= n_queries:
        return comm.all_gather(q, ax, dim=2)
    s_q = comm.all_gather(_dissimilarity(q, q_valid), ax, dim=2)
    top_i = _kept_tokens(s_q, n_queries, heads.n_kv)
    mine = top_i[:, heads.h0:heads.h0 + heads.h_loc]
    return comm.all_gather(_gather_tokens(q, mine), ax, dim=2)


def quoka_scores(q, k, valid, cfg: QuokaConfig):
    """Algorithm 1 lines 6-10.  q: (b, N_Q, h, d) sub-selected; k:
    (b, T, n_kv, d); valid (b, T).  Returns fp32 (b, n_kv, T), NEG_INF on
    invalid slots.  Cosine + max goes through the scoring kernel
    (``ops.score``, low-rank under ``score_proj_dim``); the "dot" and
    "mean" ablation arms stay plain torch and ignore the projection, as in
    the reference."""
    b, nq, h, d = q.shape
    n_kv = k.shape[2]
    group = h // n_kv
    if cfg.scoring == "cosine":
        qn = l2_normalize(q.float())
    elif cfg.scoring == "dot":
        qn = q.float()
    else:
        raise ValueError(cfg.scoring)
    qbar = qn.reshape(b, nq, n_kv, group, d).mean(3)              # (b,N_Q,n_kv,d)
    if cfg.scoring == "cosine" and cfg.query_agg == "max":
        return kops.score(qbar, k, valid,
                          proj=score_proj(cfg, d, device=k.device))
    kf = k.float()
    s = torch.einsum("bnkd,btkd->bknt", qbar.to(k.dtype).float(), kf)
    if cfg.scoring == "cosine":
        inv = torch.rsqrt((kf * kf).sum(-1) + 1e-16)              # (b, T, n_kv)
        s = s * inv.transpose(1, 2)[:, :, None, :]
    if cfg.query_agg == "max":
        s_hat = s.amax(2)
    elif cfg.query_agg == "mean":
        s_hat = s.mean(2)
    else:
        raise ValueError(cfg.query_agg)
    return torch.where(valid[:, None, :], s_hat,
                       torch.full_like(s_hat, NEG_INF))


def score_proj(cfg: QuokaConfig, d: int, device="cpu"):
    """The cached low-rank scoring projection for ``cfg.score_proj_dim`` on
    ``device``, or None when the mode is off or would not reduce d."""
    r = cfg.score_proj_dim
    if not r or r >= d:
        return None
    return kops.score_projection(d, r, device)


def prior_context_valid(key_pos, chunk_start):
    """Selectable slots: 0 <= pos < chunk_start.  ``chunk_start`` is an int,
    a () tensor or a per-row (b,) tensor."""
    if isinstance(chunk_start, torch.Tensor) and chunk_start.ndim == 1:
        chunk_start = chunk_start[:, None]
    return (key_pos >= 0) & (key_pos < chunk_start)


# ----------------------------------------------------------------------------
# tensor-parallel T-local selection (over the ``model`` axis)
# ----------------------------------------------------------------------------

def _tp_route(k, cfg: QuokaConfig, heads: comm.HeadShard) -> bool:
    """Does the T-local route apply to a sharded layer (``heads``)?  The
    reference's conditions: cosine scoring with max aggregation, a >1-way
    model axis ``heads.ax``, a KV-head count (the layer's: the model's,
    or 1 for MLA's latent, as the reference reads ``k.shape[2]``) that
    does not divide it (in that regime the cache's heads are replicated, so each
    rank can score a contiguous T-slice of keys it already holds),
    ``T % M == 0`` and a selection grid that does not straddle the
    slices."""
    if cfg.scoring != "cosine" or cfg.query_agg != "max":
        return False
    msize, t = heads.ax.size, k.shape[1]
    return (msize > 1 and heads.n_kv % msize != 0 and t % msize == 0
            and (t // msize) % max(1, cfg.granularity) == 0)


def tp_plan_candidates(qs, k, key_pos, valid, cfg: QuokaConfig,
                       budget: int, ax: comm.Axis,
                       on_scores=None) -> torch.Tensor:
    """T-local scoring and candidate merge: each rank scores its
    contiguous ``T / M`` slice of the keys and the ranks merge their
    candidates (``plan_candidates``).  qs: (b, N_Q, h, d) every head's
    sub-selected queries; k: (b, T, n_kv, d) the replicated cache.
    Returns the plan's ``idx``: (b, n_kv, budget) token slots at
    granularity 1, (b, budget // g) block ids at g > 1; -1 marks padding.
    ``ax``: the model axis; ``on_scores`` as ``plan_candidates``'."""
    t = k.shape[1]
    tl = t // ax.size
    lo = ax.rank * tl
    return plan_candidates(qs, k[:, lo:lo + tl], key_pos[:, lo:lo + tl],
                           valid[:, lo:lo + tl], cfg, min(budget, t), lo,
                           (ax,), on_scores=on_scores)


def plan_candidates(qs, k, key_pos, valid, cfg: QuokaConfig, budget: int,
                    lo: int, axes, head_ax: Optional[comm.Axis] = None,
                    on_scores=None) -> torch.Tensor:
    """Score the contiguous slice of keys ``k`` (b, tl, n_kv, d), which
    starts at slot ``lo`` of the whole cache, through the same
    ``ops.score`` as the meshless path, stamp the sinks, keep the slice's
    top candidates on the selection grid, and merge the ranks'
    candidates over each axis of ``axes`` in turn (inner first: their
    slices must tile the keys in rank order) with small all-gathers of
    (score, index) pairs.  The merged top-k is
    ``plan.plan_from_scores``'s exactly: descending score, lower index
    first on ties (each rank's slice is contiguous and ascending, its
    local top-k orders ties by index, and the merge keeps candidate order
    on ties; the top-k of a union is the top-k of its parts' top-ks under
    that total order).  ``budget`` is the whole cache's, on the grid.
    ``head_ax``: when ``k`` holds this rank's own KV heads of a block
    plan, the axis over which the max over KV heads is taken.
    ``on_scores``, if given, is called with the slice's raw scores (b,
    n_kv, tl) before the sinks are stamped (the telemetry's sketch).
    Returns the plan's ``idx`` as ``tp_plan_candidates``."""
    b, nq, h, d = qs.shape
    tl, n_kv = k.shape[1], k.shape[2]
    g = max(1, cfg.granularity)
    want = budget if g == 1 else budget // g          # plan slots
    qn = l2_normalize(qs.float())
    qbar = qn.reshape(b, nq, n_kv, h // n_kv, d).mean(3)
    s = kops.score(qbar, k, valid,
                   proj=score_proj(cfg, d, device=k.device))  # (b, n_kv, tl)
    if on_scores is not None:
        on_scores(s)
    if cfg.keep_first:
        sink = (key_pos >= 0) & (key_pos < cfg.keep_first)
        s = torch.where(sink[:, None, :] & (s > NEG_INF / 2),
                        torch.full_like(s, float("inf")), s)
    if g == 1:
        cs, ci = topk_stable(s, min(want, tl))            # (b, n_kv, n)
        ci = ci + lo
        dim = 2
    else:
        # max is associative: the local block max then the merge equals
        # the meshless reshape-max over the whole key axis
        sb = s.reshape(b, n_kv, tl // g, g).amax(3).amax(1)
        if head_ax is not None:
            sb = comm.all_reduce_max(sb, head_ax)
        cs, ci = topk_stable(sb, min(want, tl // g))      # (b, n)
        ci = ci + lo // g
        dim = 1
    for ax in axes:
        cs = comm.all_gather(cs, ax, dim=dim)
        ci = comm.all_gather(ci.to(torch.int32), ax, dim=dim).long()
        cs, cpos = topk_stable(cs, min(want, cs.shape[dim]), dim=dim)
        ci = torch.gather(ci, dim, cpos)
    return torch.where(cs > NEG_INF / 2, ci, torch.full_like(ci, -1))


def seq_route(k, cfg: QuokaConfig) -> bool:
    """Does sequence-local selection apply to this rank's slice ``k`` of
    a sequence-sharded cache?  Cosine scoring with max aggregation (the
    scoring kernel's contract) and a selection grid that does not
    straddle the ranks' slices; else the slices are gathered first."""
    return (cfg.scoring == "cosine" and cfg.query_agg == "max"
            and k.shape[1] % max(1, cfg.granularity) == 0)
