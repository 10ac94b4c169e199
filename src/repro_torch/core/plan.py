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

Cross-layer reuse (``reuse_interval`` / ``correction_layers``) threads a
``PlanCarry`` through the layer loop (``models/stack.py``): a layer builds
when the carry is still empty, at ``layer % reuse_interval == 0`` and at a
correction layer, and reuses the carried indices in between; ``refresh``
is that decision, taken on the host (layer indices are Python ints), so it
costs no device sync.

Telemetry: with ``ctx["obs"]`` set, a selecting layer leaves its
``LayerObs`` (seven fp32 0-d tensors on the model's device) in
``ctx["_obs"]`` for ``models/stack.py`` to collect; with it unset the path
runs exactly the ops it runs without telemetry.  Stages 1 and 3 run under
``record_function`` ranges named as the reference's ``jax.named_scope``
labels (``plan_scores``, ``plan_materialize``), so a ``torch.profiler``
trace attributes their ops (``analysis/trace_ops.py``).

Not ported yet: the tensor-parallel T-local route.
"""
from __future__ import annotations

import math
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


class PlanCarry(NamedTuple):
    """The plan state carried across layers: the last built plan's indices
    and whether one was built yet."""
    idx: torch.Tensor
    valid: bool


class LayerObs(NamedTuple):
    """Per-layer selection telemetry: seven fp32 0-d tensors on the
    model's device (stacked by the model into (n_layers,) leaves).

    NaN means "not applicable": non-attention layers are all-NaN; dense
    layers have no budget and no sketch; a layer that REUSED a carried plan
    has a NaN sketch (its scores were never computed).

    sel_tokens    selected valid KV tokens, mean over batch & KV heads
    ctx_tokens    selectable prior-context tokens, mean over batch
                  (sel_tokens / ctx_tokens is the live selected-KV
                  fraction — the paper's "88% fewer key-value pairs" axis)
    budget_tokens the resolved grid-aligned B_SA
    refreshed     1.0 if this layer BUILT a plan, 0.0 if it reused one
    score_lo/score_mean/score_hi
                  sketch of the raw stage-1 scores over valid slots, taken
                  BEFORE sink +inf stamping
    """
    sel_tokens: torch.Tensor
    ctx_tokens: torch.Tensor
    budget_tokens: torch.Tensor
    refreshed: torch.Tensor
    score_lo: torch.Tensor
    score_mean: torch.Tensor
    score_hi: torch.Tensor


def grid(cfg: QuokaConfig) -> int:
    return max(1, int(cfg.granularity))


floor_to_grid = sel_scores.floor_to_grid


def resolve_budget(cfg: QuokaConfig, context_len: int) -> int:
    """Effective grid-aligned B_SA, clamped to the view."""
    return floor_to_grid(min(sel_scores.resolve_budget(cfg, context_len),
                             context_len), grid(cfg))


def plan_idx_shape(cfg: QuokaConfig, b: int, n_kv: int, t: int,
                   budget: Optional[int] = None):
    """Shape of ``SelectionPlan.idx`` for a (b, T, n_kv, d) cache view."""
    g = grid(cfg)
    bud = floor_to_grid(min(budget or sel_scores.resolve_budget(cfg, t), t),
                        g)
    return (b, n_kv, bud) if g == 1 else (b, bud // g)


def plan_scores(method: str, q, k, key_pos, chunk_start, cfg: QuokaConfig,
                q_valid=None):
    """Stage 1: fp32 (b, n_kv, T) relevance scores, NEG_INF on invalid
    slots.  ``q_valid`` (b, t) masks pad query rows out of QUOKA's chunk
    statistics."""
    with torch.profiler.record_function("plan_scores"):
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
    with torch.profiler.record_function("plan_materialize"):
        return _materialize(plan, k, v, key_pos, chunk_start, cfg)


def _materialize(plan: SelectionPlan, k, v, key_pos, chunk_start,
                 cfg: QuokaConfig) -> Selected:
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


def empty_carry(shape, device) -> PlanCarry:
    """An invalid carry of ``plan_idx_shape``: the first selecting layer
    builds."""
    return PlanCarry(idx=torch.full(shape, -1, dtype=torch.long,
                                    device=device), valid=False)


def _refresh_decision(carry: PlanCarry, layer_idx: int,
                      cfg: QuokaConfig) -> bool:
    """Does layer ``layer_idx`` rebuild?  (empty carry, the interval grid,
    or a correction layer.)"""
    s = max(1, cfg.reuse_interval)
    return (not carry.valid or layer_idx % s == 0
            or layer_idx in cfg.correction_layers)


def refresh(carry: Optional[PlanCarry], layer_idx: int, cfg: QuokaConfig,
            build_fn):
    """(plan for this layer, updated carry).  With no carry (reuse off, or
    a geometry the carry cannot span) every layer builds; otherwise the
    layer builds or reuses per ``_refresh_decision``.  ``layer_idx`` is the
    global layer index, so reuse runs span stacks."""
    if carry is None:
        return build_fn(), None
    if _refresh_decision(carry, layer_idx, cfg):
        pln = build_fn()
    else:
        pln = SelectionPlan(idx=carry.idx)
    return pln, PlanCarry(idx=pln.idx, valid=True)


def _layer_plan(ctx, plan: Optional[PlanCarry], method: str, q, k, key_pos,
                chunk_start, cfg: QuokaConfig, budget, q_valid):
    """Refresh-or-build this layer's plan: (plan, updated carry, stage-1
    scores).  The scores are None where the layer reused the carried plan
    (no scores were computed); they feed only the ``LayerObs`` sketch."""
    built = []

    def build_fn():
        built.append(plan_scores(method, q, k, key_pos, chunk_start, cfg,
                                 q_valid=q_valid))
        return plan_from_scores(built[0], key_pos, cfg, budget=budget)

    pln, plan = refresh(plan, ctx.get("layer_idx", 0), cfg, build_fn)
    return pln, plan, (built[0] if built else None)


def select_with_ctx(ctx, plan: Optional[PlanCarry], method: str, q, k, v,
                    key_pos, chunk_start, cfg: QuokaConfig,
                    budget: Optional[int] = None, q_valid=None):
    """The block-facing staged selection: refresh-or-build, then
    materialize.  Returns (Selected, updated carry).  With ``ctx["obs"]``
    set the layer's ``LayerObs`` is left in ``ctx["_obs"]`` (a per-layer
    ctx copy, see models/stack.py)."""
    pln, plan, scores = _layer_plan(ctx, plan, method, q, k, key_pos,
                                    chunk_start, cfg, budget, q_valid)
    _note_block_counts(ctx, pln, cfg)
    sel = materialize(pln, k, v, key_pos, chunk_start, cfg)
    if ctx.get("obs"):
        ctx["_obs"] = selected_obs(sel.pos, key_pos, chunk_start,
                                   _obs_budget(cfg, k.shape[1], budget),
                                   scores)
    return sel, plan


def _note_block_counts(ctx, pln: SelectionPlan, cfg: QuokaConfig) -> None:
    """Leave this layer's ``pool_block_counts`` in ``ctx["_selblk"]`` when
    the caller asked for the prefetch oracle's side channel
    (``ctx["selblk"] = (block_size, n_blocks)``); models/stack.py pops and
    sums it over the layers."""
    sb = ctx.get("selblk")
    if sb is not None:
        ctx["_selblk"] = pool_block_counts(pln, cfg, sb[0], sb[1])


def pool_block_counts(plan: SelectionPlan, cfg: QuokaConfig,
                      block_size: int, n_blocks: int) -> torch.Tensor:
    """(b, n_blocks) int32: how many of this plan's selected entries land
    in each LOGICAL pool block of the request's cache view, read off the
    plan's indices before materialize — QUOKA's stage-2 output doubling as
    the host tier's prefetch oracle (serving/engine.py::_prefetch).  Token
    plans (g == 1) map a slot to its block by ``// block_size``; block
    plans map grid ids through ``g / block_size``.  Padding (-1) and ids
    past ``n_blocks`` drop out."""
    g = grid(cfg)
    flat = plan.idx.reshape(plan.idx.shape[0], -1).long()
    ids = flat // block_size if g == 1 else (flat * g) // block_size
    ids = torch.where((flat >= 0) & (ids < n_blocks), ids,
                      torch.full_like(ids, n_blocks))
    out = torch.zeros((flat.shape[0], n_blocks + 1), dtype=torch.int32,
                      device=flat.device)
    out.scatter_add_(1, ids, torch.ones_like(ids, dtype=torch.int32))
    return out[:, :n_blocks]


def fused_route(cfg: QuokaConfig, method: str, k,
                window: Optional[int] = None) -> bool:
    """May the fused selected-attention kernel replace materialize +
    attention here?  Opted in, block-granular plans whose grid divides the
    cache view, no sliding window (no mesh exists in the port yet)."""
    if not cfg.fused_select_attn or window is not None:
        return False
    g = grid(cfg)
    return g > 1 and k.shape[1] % g == 0


def plan_selected_pos(plan: SelectionPlan, key_pos, chunk_start,
                      cfg: QuokaConfig) -> torch.Tensor:
    """Positions-only twin of ``materialize`` for telemetry: the selected
    positions (-1 = padding, validity re-derived as materialize derives
    it) without touching K/V — (b, n_kv, B) at g == 1, (b, 1, B) at g > 1.
    The fused kernel applies the same masks in-kernel; this keeps
    ``LayerObs.sel_tokens`` exact while gathering only (b, T) int32
    positions, not the KV budget the fused route exists to avoid."""
    b, t = key_pos.shape
    g = grid(cfg)
    valid = prior_context_valid(key_pos, chunk_start)
    if g == 1:
        top_i = plan.idx                                      # (b, n_kv, B)
        safe = top_i.clamp(min=0)
        n_kv = top_i.shape[1]
        pos = torch.gather(key_pos[:, None, :].expand(b, n_kv, t), 2, safe)
        ok = torch.gather(valid[:, None, :].expand(b, n_kv, t), 2, safe)
        return torch.where((top_i >= 0) & ok, pos, torch.full_like(pos, -1))
    blocks = plan.idx.clamp(min=0)                            # (b, NB)
    bi = blocks[:, :, None].expand(-1, -1, g)
    pos_sel = torch.gather(key_pos.reshape(b, t // g, g), 1, bi)
    ok_sel = torch.gather(valid.reshape(b, t // g, g), 1, bi)
    good = ok_sel & (plan.idx >= 0)[:, :, None]
    return torch.where(good, pos_sel,
                       torch.full_like(pos_sel, -1)).reshape(b, 1, -1)


def fused_attend_with_ctx(ctx, plan: Optional[PlanCarry], method: str, q,
                          k, v, key_pos, chunk_start, cfg: QuokaConfig,
                          budget: Optional[int] = None, q_valid=None):
    """Refresh-or-build the plan, then attend straight through its block
    ids with ``ops.selected_attention``: no materialize, no [budget | chunk]
    concat, one kernel launch.  Callers gate on ``fused_route``.  Returns
    (attention output (b, t, h, d), updated carry); the obs side channel
    is ``select_with_ctx``'s, its ``sel_tokens`` from the positions-only
    ``plan_selected_pos``."""
    pln, plan, scores = _layer_plan(ctx, plan, method, q, k, key_pos,
                                    chunk_start, cfg, budget, q_valid)
    att = kops.selected_attention(q, k, v, key_pos, pln.idx, chunk_start,
                                  granularity=grid(cfg))
    _note_block_counts(ctx, pln, cfg)
    if ctx.get("obs"):
        ctx["_obs"] = selected_obs(
            plan_selected_pos(pln, key_pos, chunk_start, cfg), key_pos,
            chunk_start, _obs_budget(cfg, k.shape[1], budget), scores)
    return att, plan


# ----------------------------------------------------------------------------
# telemetry (the per-layer LayerObs side channel)
# ----------------------------------------------------------------------------

_CONST: dict = {}


def _const(v: float, device) -> torch.Tensor:
    """A cached read-only fp32 0-d constant on ``device`` (telemetry's
    budgets, flags and NaN, made once, not per layer call).  NaN is keyed
    by name: a NaN key never compares equal to itself, so it would miss
    the cache on every call."""
    key = ("nan" if math.isnan(v) else v, str(device))
    t = _CONST.get(key)
    if t is None:
        t = _CONST[key] = torch.full((), v, dtype=torch.float32,
                                     device=device)
    return t


def nan_obs(device) -> LayerObs:
    """The all-NaN ``LayerObs`` of a layer that never selects (recurrent
    and encoder blocks), so every layer has one."""
    n = _const(math.nan, device)
    return LayerObs(n, n, n, n, n, n, n)


def score_sketch(scores) -> torch.Tensor:
    """(3,) fp32 [min, mean, max] of stage-1 scores over VALID slots.

    Taken on the raw ``plan_scores`` output: ``plan_from_scores`` stamps
    +inf onto sink slots (through ``torch.where``, not in place, so the
    tensor here is untouched).  A view with no valid slot (the first
    chunk) sketches NaN.  Invalid slots hold NEG_INF, below every valid
    score, so the plain max is the valid slots' max whenever one exists."""
    ok = scores > NEG_INF / 2
    n = ok.sum()
    lo = torch.where(ok, scores, math.inf).amin()
    mean = (scores * ok).sum() / n
    sk = torch.stack([lo, mean, scores.amax()])
    return torch.where(n > 0, sk, math.nan)


def _count_mean(mask) -> torch.Tensor:
    """fp32 mean over the leading axes of the last axis's True count."""
    return mask.sum(-1, dtype=torch.float32).mean()


def dense_obs(key_pos, chunk_start) -> LayerObs:
    """``LayerObs`` of a dense (no-selection) attention layer: every
    selectable prior token is attended; no budget, no score pass."""
    ctxc = _count_mean(prior_context_valid(key_pos, chunk_start))
    dev = key_pos.device
    n = _const(math.nan, dev)
    return LayerObs(sel_tokens=ctxc, ctx_tokens=ctxc, budget_tokens=n,
                    refreshed=_const(0.0, dev), score_lo=n, score_mean=n,
                    score_hi=n)


def selected_obs(sel_pos, key_pos, chunk_start, budget: int,
                 scores) -> LayerObs:
    """``LayerObs`` of a selecting layer, from the budget's positions
    (``sel_pos == -1`` marks padding, exactly what attention masks, so
    ``sel_tokens`` counts the KV pairs attended) and the layer's stage-1
    ``scores``: None where it reused a carried plan, which leaves
    ``refreshed`` 0 and a NaN sketch, as the reference's ``lax.cond``
    branch gives."""
    dev = key_pos.device
    if scores is None:
        lo = mean = hi = _const(math.nan, dev)
    else:
        lo, mean, hi = score_sketch(scores).unbind()
    return LayerObs(
        sel_tokens=_count_mean(sel_pos >= 0),
        ctx_tokens=_count_mean(prior_context_valid(key_pos, chunk_start)),
        budget_tokens=_const(float(budget), dev),
        refreshed=_const(0.0 if scores is None else 1.0, dev),
        score_lo=lo, score_mean=mean, score_hi=hi)


def _obs_budget(cfg: QuokaConfig, t: int, budget: Optional[int]) -> int:
    return floor_to_grid(min(budget or sel_scores.resolve_budget(cfg, t), t),
                         grid(cfg))
