"""QUOKA scoring primitives, paper Algorithm 1 stages 1-3 (counterpart of
``repro/core/quoka.py``).

  1. query subselection: keep the ``N_Q`` queries least cosine-similar to
     the chunk's mean query, group-coherently under GQA;
  2. cosine scoring of the kept normalised queries against normalised keys;
  3. max over queries, with queries pre-aggregated (mean) inside each KV
     group before the product.

Layouts: q (b, t, n_q_heads, d); caches (b, T, n_kv, d); key positions
(b, T) int32 with -1 marking empty slots.  The tensor-parallel T-local
route (``_tp_route`` / ``tp_plan_candidates``) is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import QuokaConfig
from repro_torch.core.attention import NEG_INF
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import l2_normalize


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
    b, t, h, d = q.shape
    if t <= n_queries:
        return q
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
    if n_kv is not None and n_kv != h:
        group = h // n_kv
        s_g = s_q.reshape(b, t, n_kv, group).mean(3)              # (b, t, n_kv)
        _, top_g = topk_stable(s_g.transpose(1, 2), n_queries)
        top_i = top_g.repeat_interleave(group, dim=1)             # (b, h, N_Q)
    else:
        _, top_i = topk_stable(s_q.transpose(1, 2), n_queries)
    gathered = torch.gather(q.transpose(1, 2), 2,
                            top_i[..., None].expand(-1, -1, -1, d))
    return gathered.transpose(1, 2)


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
