"""The baseline selectors the paper compares against (§4), the scorer
dispatch and budget resolution (counterpart of ``repro/core/selection.py``).

Every method produces fp32 relevance scores (b, n_kv, T) over the cached
keys, NEG_INF on invalid slots; the shared select and materialize stages
are ``core/plan.py``'s, so only the scoring policy differs.

  sample_attention  Zhu et al. 2024      uniformly sampled queries, softmax
                                         probabilities, mean aggregation
  sparq             Ribar et al. 2024    top-|q| channels, dot scores, mean
  loki              Singhania et al.2024 low-rank projected dot scores (the
                                         cached random projection stands in
                                         for the offline PCA)
  less_is_more      Yang et al. 2025b    last-window mean dot scores (the
                                         depth reuse is ``reuse_interval``)
  snapkv            Li et al. 2024       last-window softmax mass, max-pooled
  keydiff           Park et al. 2025     query-free: dissimilarity from the
                                         mean key
  quoka             this paper (``core/quoka.py``, the scoring kernel)
  full              dense attention: the caller bypasses selection

The baselines are plain torch, as they are plain XLA in the reference; each
casts K to fp32 and, like the reference, ignores query validity.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import QuokaConfig
from repro_torch.core.attention import NEG_INF
from repro_torch.core.quoka import topk_stable
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import l2_normalize

METHODS = ("quoka", "sample_attention", "sparq", "loki", "less_is_more",
           "snapkv", "keydiff", "full")


def _group_mean_q(q, n_kv: int):
    """(b, t, h, d) -> (b, t, n_kv, d): mean over each GQA group."""
    b, t, h, d = q.shape
    return q.reshape(b, t, n_kv, h // n_kv, d).mean(3)


def _mask(scores, valid):
    return torch.where(valid[:, None, :], scores,
                       torch.full_like(scores, NEG_INF))


def sample_positions(t: int, n: int, device="cpu") -> torch.Tensor:
    """The reference's ``jnp.linspace(0, t - 1, n).astype(int32)`` as XLA
    evaluates it: in float32, ``i * c`` with the constant folded to
    c = float32(t - 1) * float32(1 / (n - 1)), the last point exactly
    t - 1, truncated.  A float64 linspace, or (t - 1) * (i / (n - 1)),
    truncates one lower at some boundaries.  Built on ``device`` (a
    float32 product is exact IEEE arithmetic there too), so no host
    copy waits on the stream."""
    if n == 1:
        return torch.zeros(1, dtype=torch.long, device=device)
    c = np.float32(t - 1) * (np.float32(1) / np.float32(n - 1))
    idx = (torch.arange(n, dtype=torch.float32, device=device)
           * float(c)).long()
    idx[-1] = t - 1
    return idx


def sample_attention_scores(q, k, valid, cfg: QuokaConfig):
    """Uniformly sampled queries, per attention head softmax, mean over the
    queries and then over the GQA group."""
    b, t, h, d = q.shape
    n_kv = k.shape[2]
    n = min(cfg.n_queries, t)
    idx = sample_positions(t, n, q.device)
    qs = q[:, idx].float()                                        # (b,n,h,d)
    kr = k.float().repeat_interleave(h // n_kv, dim=2)            # (b,T,h,d)
    logits = torch.einsum("bnhd,bthd->bhnt", qs, kr) / math.sqrt(d)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    s = torch.softmax(logits, dim=-1).mean(2)                     # (b, h, T)
    s = s.reshape(b, n_kv, h // n_kv, -1).mean(2)
    return _mask(s, valid)


def sparq_scores(q, k, valid, cfg: QuokaConfig):
    """The r channels of largest mean |q̄| (ties to the lower channel, as
    ``lax.top_k``), dot scores on them, mean over the queries."""
    t = q.shape[1]
    T, n_kv = k.shape[1], k.shape[2]
    r = min(cfg.rank, q.shape[-1])
    qg = _group_mean_q(q.float(), n_kv)                           # (b,t,kv,d)
    imp = qg.abs().mean(1)                                        # (b,kv,d)
    _, ch = topk_stable(imp, r)                                   # (b,kv,r)
    qc = torch.gather(qg.transpose(1, 2), 3,
                      ch[:, :, None, :].expand(-1, -1, t, -1))    # (b,kv,t,r)
    kc = torch.gather(k.float().transpose(1, 2), 3,
                      ch[:, :, None, :].expand(-1, -1, T, -1))    # (b,kv,T,r)
    s = torch.einsum("bktr,bksr->bkts", qc, kc).mean(2)
    return _mask(s, valid)


def loki_scores(q, k, valid, cfg: QuokaConfig):
    """Dot scores in a (d, rank) projected space, mean over the queries;
    the projection is the cached one ``score_proj_dim`` uses."""
    n_kv = k.shape[2]
    d = q.shape[-1]
    proj = kops.score_projection(d, min(cfg.rank, d), q.device)
    qg = _group_mean_q(q.float(), n_kv) @ proj                    # (b,t,kv,r)
    kl = k.float().transpose(1, 2) @ proj                         # (b,kv,T,r)
    s = torch.einsum("btkr,bksr->bkts", qg, kl).mean(2)
    return _mask(s, valid)


def less_is_more_scores(q, k, valid, cfg: QuokaConfig):
    """Dot scores of the last ``n_queries`` group-mean queries, mean over
    them (the method's depth reuse is ``reuse_interval``)."""
    n_kv = k.shape[2]
    w = min(cfg.n_queries, q.shape[1])
    qg = _group_mean_q(q[:, -w:].float(), n_kv)
    s = torch.einsum("btkd,bskd->bkts", qg, k.float()).mean(2)
    return _mask(s, valid)


def snapkv_scores(q, k, valid, cfg: QuokaConfig, pool: int = 7):
    """Softmax mass from the last 16 queries, summed over them, mean over
    the GQA group, then max-pooled over the key axis.  The key axis is
    padded with the reference's 0.0 before the pool (``max_pool1d``'s own
    padding is -inf; the masses are >= 0, so the two agree, but the
    reference's form is the one kept)."""
    b, t, h, d = q.shape
    n_kv = k.shape[2]
    w = min(16, t)
    kr = k.float().repeat_interleave(h // n_kv, dim=2)
    logits = torch.einsum("bnhd,bthd->bhnt", q[:, -w:].float(),
                          kr) / math.sqrt(d)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    s = torch.softmax(logits, dim=-1).sum(2)                      # (b, h, T)
    s = s.reshape(b, n_kv, h // n_kv, -1).mean(2)
    s = F.max_pool1d(F.pad(s, (pool // 2, pool // 2), value=0.0), pool,
                     stride=1)
    return _mask(s, valid)


def keydiff_scores(q, k, valid, cfg: QuokaConfig):
    """Query-free: the negative cosine of each key with the mean of the
    valid normalised keys."""
    kn = l2_normalize(k.float())                                  # (b,T,kv,d)
    denom = valid.sum(1, keepdim=True).clamp(min=1)               # (b, 1)
    mean_k = torch.where(valid[:, :, None, None], kn,
                         torch.zeros_like(kn)).sum(1, keepdim=True) \
        / denom[:, :, None, None]
    s = -(kn * l2_normalize(mean_k)).sum(-1)                      # (b,T,kv)
    return _mask(s.transpose(1, 2), valid)


_SCORERS = {"sample_attention": sample_attention_scores,
            "sparq": sparq_scores, "loki": loki_scores,
            "less_is_more": less_is_more_scores, "snapkv": snapkv_scores,
            "keydiff": keydiff_scores}


def compute_scores(method: str, q, k, valid, cfg: QuokaConfig):
    """A baseline's scores; QUOKA is scored by ``core/plan.py::plan_scores``
    alone (it also masks pad query rows)."""
    if method not in _SCORERS:
        raise ValueError(f"unknown selection method {method!r}")
    return _SCORERS[method](q, k, valid, cfg)


def floor_to_grid(budget: int, g: int) -> int:
    """Floor a token budget onto the g-token selection grid (min one
    block); granularity 1 is the identity."""
    if g <= 1:
        return budget
    return max(g, budget - budget % g)


def resolve_budget(cfg: QuokaConfig, context_len: int) -> int:
    """Effective B_SA: fixed, or a fraction of the static context length,
    floored onto the selection grid."""
    if cfg.budget_ratio is not None:
        budget = max(cfg.keep_first + 1, int(cfg.budget_ratio * context_len))
    else:
        budget = cfg.budget
    return floor_to_grid(budget, max(1, cfg.granularity))
