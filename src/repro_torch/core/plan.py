"""SelectionPlan — the single KV-selection code path (counterpart of
``repro/core/plan.py``).

    scores = plan_scores(method, q, k, key_pos, chunk_start, cfg)   # stage 1
    plan   = plan_from_scores(scores, key_pos, cfg, budget)         # stage 2
    sel    = materialize(plan, k, v, key_pos, chunk_start, cfg)     # stage 3

A plan is indices only: at granularity 1, (b, n_kv, B) per-head token
slots; at granularity g > 1, (b, B//g) block ids on the g-token grid shared
across KV heads.  The fused route (``fused_attend_with_ctx``) attends
straight through a block plan with the selected-attention kernel instead
of materializing it.

Not ported yet: cross-layer plan reuse (``reuse_interval > 1``:
``PlanCarry`` / ``refresh``), the in-jit ``LayerObs`` telemetry and the
prefetch-oracle block counts; the tensor-parallel T-local route.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import QuokaConfig
from repro_torch.core import quoka as qk
from repro_torch.core import selection as sel_scores
from repro_torch.core.attention import NEG_INF
from repro_torch.core.quoka import Selected, prior_context_valid
from repro_torch.kernels import ops as kops


class SelectionPlan(NamedTuple):
    """idx: int64, -1 marks padding.  granularity 1 -> (b, n_kv, B) token
    slots; granularity g > 1 -> (b, B//g) block ids shared across heads."""
    idx: torch.Tensor


def grid(cfg: QuokaConfig) -> int:
    return max(1, int(cfg.granularity))


floor_to_grid = sel_scores.floor_to_grid


def resolve_budget(cfg: QuokaConfig, context_len: int) -> int:
    """Effective grid-aligned B_SA, clamped to the view."""
    return floor_to_grid(min(sel_scores.resolve_budget(cfg, context_len),
                             context_len), grid(cfg))


def _check_ported(cfg: QuokaConfig) -> None:
    if max(1, cfg.reuse_interval) > 1 or cfg.correction_layers:
        raise NotImplementedError("cross-layer plan reuse (reuse_interval > "
                                  "1) is not yet ported")


def plan_scores(method: str, q, k, key_pos, chunk_start, cfg: QuokaConfig,
                q_valid=None):
    """Stage 1: fp32 (b, n_kv, T) relevance scores, NEG_INF on invalid
    slots.  ``q_valid`` (b, t) masks pad query rows out of QUOKA's chunk
    statistics."""
    valid = prior_context_valid(key_pos, chunk_start)
    if method == "quoka":
        q = qk.sanitize_queries(q, q_valid)
        qs = qk.subselect_queries(q, cfg.n_queries, n_kv=k.shape[2],
                                  q_valid=q_valid)
        return qk.quoka_scores(qs, k, valid, cfg)
    return sel_scores.compute_scores(method, q, k, valid, cfg)


def plan_from_scores(scores, key_pos, cfg: QuokaConfig,
                     budget: Optional[int] = None) -> SelectionPlan:
    """Stage 2: top-k on the selection grid.  The ``keep_first`` earliest
    real tokens are stamped +inf first (sink protection); ties keep the
    reference's order (descending score, lower index first)."""
    b, n_kv, t = scores.shape
    g = grid(cfg)
    budget = floor_to_grid(min(budget or sel_scores.resolve_budget(cfg, t),
                               t), g)
    if cfg.keep_first:
        sink = (key_pos >= 0) & (key_pos < cfg.keep_first)        # (b, T)
        scores = torch.where(sink[:, None, :] & (scores > NEG_INF / 2),
                             torch.full_like(scores, float("inf")), scores)
    if g == 1:
        top_s, top_i = qk.topk_stable(scores, budget)             # (b,n_kv,B)
        return SelectionPlan(idx=torch.where(top_s > NEG_INF / 2, top_i,
                                             torch.full_like(top_i, -1)))
    if t % g:
        raise ValueError(
            f"selection granularity {g} must divide the cache view length "
            f"{t} (align granularity with the pool block size / B_CP)")
    # block score = max over the g tokens and over KV heads
    sb = scores.reshape(b, n_kv, t // g, g).amax(3).amax(1)
    top_s, top_i = qk.topk_stable(sb, budget // g)                # (b, NB)
    return SelectionPlan(idx=torch.where(top_s > NEG_INF / 2, top_i,
                                         torch.full_like(top_i, -1)))


def materialize(plan: SelectionPlan, k, v, key_pos, chunk_start,
                cfg: QuokaConfig) -> Selected:
    """Stage 3: gather a plan's KV budget from the cache (b, T, n_kv, d)
    into a dense ``Selected``.  Validity is re-derived here: tokens that
    are not prior context get pos == -1."""
    b, t, n_kv, d = k.shape
    g = grid(cfg)
    valid = prior_context_valid(key_pos, chunk_start)             # (b, T)
    if g == 1:
        top_i = plan.idx                                          # (b,n_kv,B)
        safe = top_i.clamp(min=0)
        gi = safe.transpose(1, 2)[..., None].expand(-1, -1, -1, d)
        k_sel = torch.gather(k, 1, gi)                            # (b,B,n_kv,d)
        v_sel = torch.gather(v, 1, gi)
        pos = torch.gather(key_pos[:, None, :].expand(b, n_kv, t), 2, safe)
        ok = torch.gather(valid[:, None, :].expand(b, n_kv, t), 2, safe)
        good = (top_i >= 0) & ok
        return Selected(k=k_sel, v=v_sel,
                        pos=torch.where(good, pos, torch.full_like(pos, -1)),
                        idx=torch.where(good, top_i,
                                        torch.full_like(top_i, -1)))
    nb = plan.idx.shape[1]
    blocks = plan.idx.clamp(min=0)                                # (b, NB)
    gi = blocks[:, :, None, None, None].expand(-1, -1, g, n_kv, d)
    k_sel = torch.gather(k.reshape(b, t // g, g, n_kv, d), 1,
                         gi).reshape(b, nb * g, n_kv, d)
    v_sel = torch.gather(v.reshape(b, t // g, g, n_kv, d), 1,
                         gi).reshape(b, nb * g, n_kv, d)
    bi = blocks[:, :, None].expand(-1, -1, g)
    pos_sel = torch.gather(key_pos.reshape(b, t // g, g), 1, bi)  # (b, NB, g)
    ok_sel = torch.gather(valid.reshape(b, t // g, g), 1, bi)
    good = ok_sel & (plan.idx >= 0)[:, :, None]
    pos_flat = torch.where(good, pos_sel,
                           torch.full_like(pos_sel, -1)).reshape(b, nb * g)
    slot = blocks[:, :, None] * g + torch.arange(g, device=k.device)
    idx_flat = torch.where(good, slot,
                           torch.full_like(slot, -1)).reshape(b, nb * g)
    return Selected(k=k_sel, v=v_sel,
                    pos=pos_flat[:, None, :].expand(b, n_kv, nb * g),
                    idx=idx_flat[:, None, :].expand(b, n_kv, nb * g))


def build(method: str, q, k, key_pos, chunk_start, cfg: QuokaConfig,
          budget: Optional[int] = None, q_valid=None) -> SelectionPlan:
    """Stages 1+2."""
    scores = plan_scores(method, q, k, key_pos, chunk_start, cfg,
                         q_valid=q_valid)
    return plan_from_scores(scores, key_pos, cfg, budget=budget)


def select(method: str, q, k, v, key_pos, chunk_start, cfg: QuokaConfig,
           budget: Optional[int] = None, q_valid=None) -> Selected:
    """All three stages (``full`` means "do not select" and is the
    caller's)."""
    pln = build(method, q, k, key_pos, chunk_start, cfg, budget=budget,
                q_valid=q_valid)
    return materialize(pln, k, v, key_pos, chunk_start, cfg)


def select_with_ctx(method: str, q, k, v, key_pos, chunk_start,
                    cfg: QuokaConfig, budget: Optional[int] = None,
                    q_valid=None) -> Selected:
    """The block-facing staged selection: build + materialize (the
    reference's branch without telemetry or plan reuse, which are not
    ported; plan reuse raises)."""
    _check_ported(cfg)
    return select(method, q, k, v, key_pos, chunk_start, cfg, budget=budget,
                  q_valid=q_valid)


def fused_route(cfg: QuokaConfig, method: str, k,
                window: Optional[int] = None) -> bool:
    """May the fused selected-attention kernel replace materialize +
    attention here?  Opted in, block-granular plans whose grid divides the
    cache view, no sliding window (no mesh exists in the port yet)."""
    if not cfg.fused_select_attn or window is not None:
        return False
    g = grid(cfg)
    return g > 1 and k.shape[1] % g == 0


def fused_attend_with_ctx(method: str, q, k, v, key_pos, chunk_start,
                          cfg: QuokaConfig, budget: Optional[int] = None,
                          q_valid=None):
    """Build the plan, then attend straight through its block ids with
    ``ops.selected_attention``: no materialize, no [budget | chunk] concat,
    one kernel launch.  Callers gate on ``fused_route``."""
    _check_ported(cfg)
    pln = build(method, q, k, key_pos, chunk_start, cfg, budget=budget,
                q_valid=q_valid)
    return kops.selected_attention(q, k, v, key_pos, pln.idx, chunk_start,
                                   granularity=grid(cfg))
