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
runs exactly the ops it runs without telemetry.  On a mesh
(``ctx["obs"]`` a ``MeshObs``) each layer leaves its raw partials
instead, and the model reduces the step's stacked partials over the
mesh once (``MeshObs.reduce``), so every rank returns the meshless
``LayerObs``.  Stages 1 and 3 run under
``record_function`` ranges named as the reference's ``jax.named_scope``
labels (``plan_scores``, ``plan_materialize``), so a ``torch.profiler``
trace attributes their ops (``analysis/trace_ops.py``).

Tensor parallelism (``sharding/``): a selecting layer of a sharded model
hands ``build`` its ``HeadShard`` (``heads``), which alone decides the
sharded routes.  QUOKA then scores on this rank's own KV heads when they
shard (a block plan's max over KV heads becomes a cross-rank max, so
every rank holds the same plan), or, when they are replicated, over
every head's sub-selected queries: on the T-local route
(``quoka.tp_plan_candidates``, over ``heads.ax``) when the reference's
conditions allow, else on the whole replicated cache.  The scoring
pass's collectives count under ``comm.scope("score")``.  The fused route
stays off for a sharded layer, as in the reference.

A batch-1 cache whose sequence is split over ``data`` (``seq``, a
``serving/cache.py::SeqShard``) is selected where it lies: each rank
scores the slots it holds and the ranks merge their candidates
(``quoka.plan_candidates``; the T-local route inside a slice where it
applies), so every rank builds the meshless plan; ``materialize`` then
brings the budget's K/V rows to every rank, each rank contributing the
rows it holds (``comm.scope("seq")``).
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
from repro_torch.sharding import comm


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
                     budget: Optional[int] = None,
                     heads: Optional[comm.HeadShard] = None) -> SelectionPlan:
    """Stage 2: top-k on the selection grid.  The ``keep_first`` earliest
    real tokens are stamped +inf first (sink protection); ties keep the
    reference's order (descending score, lower index first).  With
    ``heads`` whose KV heads shard, ``scores`` are this rank's KV heads'
    and a block plan's max over KV heads is taken across the ranks."""
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
    if heads is not None and heads.kv_sharded:
        sb = comm.all_reduce_max(sb, heads.ax)
    top_s, top_i = qk.topk_stable(sb, budget // g)                # (b, NB)
    return SelectionPlan(idx=torch.where(top_s > NEG_INF / 2, top_i,
                                         torch.full_like(top_i, -1)))


def materialize(plan: SelectionPlan, k, v, key_pos, chunk_start,
                cfg: QuokaConfig, seq=None) -> Selected:
    """Stage 3: gather a plan's KV budget from the cache (b, T, n_kv, d)
    into a dense ``Selected``.  Validity is re-derived here: tokens that
    are not prior context get pos == -1.  ``seq``: the cache is this
    rank's slice of a sequence-sharded one (``_materialize_seq``)."""
    with torch.profiler.record_function("plan_materialize"):
        if seq is not None:
            return _materialize_seq(plan, k, v, key_pos, chunk_start, cfg,
                                    seq)
        return _materialize(plan, k, v, key_pos, chunk_start, cfg)


def _materialize_seq(plan: SelectionPlan, k, v, key_pos, chunk_start,
                     cfg: QuokaConfig, seq) -> Selected:
    """``_materialize`` on a sequence-sharded cache: every rank knows from
    the plan which rank holds each selected slot (slot // held), so each
    rank packs the rows it holds (K, V and position, as bytes) and
    broadcasts them over ``seq.ax``; the others place them where the plan
    puts them.  The budget's rows cross once, never the cache.  The values
    are the meshless ones (an unselected row holds zeros where the
    meshless one holds a masked row).  When ``v`` is ``k`` (MLA's latent,
    whose values are its keys' first columns) one buffer moves."""
    b, held, n_kv, d = k.shape
    one = v is k
    g = grid(cfg)
    if g == 1:
        slots = plan.idx                                      # (b, n_kv, B)
    else:
        ar = torch.arange(g, device=k.device)
        slots = torch.where(plan.idx[:, :, None] >= 0,
                            plan.idx[:, :, None] * g + ar,
                            torch.full_like(plan.idx[:, :, None], -1))
        slots = slots.reshape(b, 1, -1).expand(b, n_kv, -1)
    owner = torch.where(slots >= 0, slots // held,
                        torch.full_like(slots, -1)).transpose(1, 2)
    counts = torch.bincount(owner[owner >= 0].reshape(-1),
                            minlength=seq.ax.size).tolist()
    # this rank's rows in (b, S, n_kv) order
    mine = owner == seq.ax.rank
    loc = (slots - seq.lo).clamp(0, held - 1)
    gi = loc.transpose(1, 2)[..., None].expand(-1, -1, -1, d)
    kv = torch.gather(k, 1, gi) if one else \
        torch.cat([torch.gather(k, 1, gi), torch.gather(v, 1, gi)], -1)
    w = kv.shape[-1]
    valid = prior_context_valid(key_pos, chunk_start)
    pos = torch.gather(key_pos[:, None, :].expand(b, n_kv, held), 2, loc)
    ok = torch.gather(valid[:, None, :].expand(b, n_kv, held), 2, loc)
    pos = torch.where(ok, pos, torch.full_like(pos, -1)).transpose(1, 2)
    out_kv = torch.zeros_like(kv)                         # (b, S, n_kv, w)
    out_pos = torch.full_like(pos, -1)                    # (b, S, n_kv)
    row = w * kv.element_size()
    with comm.scope("seq"):
        for r, n in enumerate(counts):
            if n == 0:
                continue
            if r == seq.ax.rank:
                buf = torch.cat([kv[mine].reshape(-1).view(torch.uint8),
                                 pos[mine].reshape(-1).view(torch.uint8)])
            else:
                buf = torch.empty(n * (row + pos.element_size()),
                                  dtype=torch.uint8, device=k.device)
            buf = comm.broadcast(buf, seq.ax, r)
            at = owner == r
            out_kv[at] = buf[:n * row].view(kv.dtype).view(n, w)
            out_pos[at] = buf[n * row:].view(pos.dtype)
    pos = out_pos.transpose(1, 2)
    k_sel = out_kv[..., :d]
    return Selected(k=k_sel, v=k_sel if one else out_kv[..., d:], pos=pos,
                    idx=torch.where(pos >= 0, slots,
                                    torch.full_like(slots, -1)))


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
          budget: Optional[int] = None, q_valid=None,
          heads: Optional[comm.HeadShard] = None, seq=None,
          sketch: Optional[list] = None) -> SelectionPlan:
    """Stages 1+2.  Under tensor parallelism (``heads``) QUOKA scores as
    the module docstring says, on the T-local route where it applies;
    every rank returns the same plan (its own KV heads' rows of it at
    granularity 1 when the KV heads shard).  ``seq``: ``k`` / ``key_pos``
    are this rank's slice of a sequence-sharded cache, which must pass
    ``quoka.seq_route``.  ``sketch`` (a list, on a mesh) receives this
    rank's ``score_partial`` of the scores it computed and the mesh axes
    over which the route partitions them (``MeshObs``)."""
    if heads is not None:
        if method != "quoka":
            raise NotImplementedError(
                f"selection method {method!r} on a mesh is not yet ported")
        t = k.shape[1] if seq is None else seq.cap
        with torch.profiler.record_function("plan_scores"), \
                comm.scope("score"):
            return _build_tp(q, k, key_pos, chunk_start, cfg,
                             _plan_budget(cfg, t, budget), q_valid, heads,
                             seq, sketch)
    scores = plan_scores(method, q, k, key_pos, chunk_start, cfg,
                         q_valid=q_valid)
    return plan_from_scores(scores, key_pos, cfg, budget=budget)


def _keep(sketch: Optional[list], scores, parts) -> None:
    """With telemetry on a mesh (``sketch`` a list), note this rank's
    ``score_partial`` of ``scores`` and the mesh axes ``parts`` over
    which the route partitions them."""
    if sketch is not None:
        sketch.append((score_partial(scores), parts))


def _keeper(sketch: Optional[list], parts):
    """``_keep`` as a scoring hook (``on_scores``); None without
    telemetry."""
    return None if sketch is None else (lambda s: _keep(sketch, s, parts))


def _build_tp(q, k, key_pos, chunk_start, cfg: QuokaConfig, budget: int,
              q_valid, heads: comm.HeadShard, seq=None,
              sketch: Optional[list] = None) -> SelectionPlan:
    """QUOKA's stages 1+2 on a mesh (``build``)."""
    q = qk.sanitize_queries(q, q_valid)
    valid = prior_context_valid(key_pos, chunk_start)
    if heads.kv_sharded:
        # whole GQA groups on this rank: its own heads score its own keys
        qs = qk.subselect_queries(q, cfg.n_queries, n_kv=k.shape[2],
                                  q_valid=q_valid)
        if seq is None:
            qk.ROUTES["kv_heads"] += 1
            scores = qk.quoka_scores(qs, k, valid, cfg)
            _keep(sketch, scores, ("model",))
            return plan_from_scores(scores, key_pos, cfg, budget=budget,
                                    heads=heads)
    elif heads.heads_sharded:
        qs = qk.subselect_queries_tp(q, cfg.n_queries, heads,
                                     q_valid=q_valid)
    else:
        qs = qk.subselect_queries(q, cfg.n_queries, n_kv=k.shape[2],
                                  q_valid=q_valid)
    if seq is not None:
        return SelectionPlan(idx=_seq_candidates(qs, k, key_pos, valid, cfg,
                                                 budget, heads, seq, sketch))
    if qk._tp_route(k, cfg, heads):
        qk.ROUTES["t_local"] += 1
        return SelectionPlan(idx=qk.tp_plan_candidates(
            qs, k, key_pos, valid, cfg, budget, heads.ax,
            on_scores=_keeper(sketch, ("model",))))
    qk.ROUTES["replicated"] += 1
    scores = qk.quoka_scores(qs, k, valid, cfg)
    _keep(sketch, scores, ())
    return plan_from_scores(scores, key_pos, cfg, budget=budget)


def _seq_candidates(qs, k, key_pos, valid, cfg: QuokaConfig, budget: int,
                    heads: comm.HeadShard, seq,
                    sketch: Optional[list] = None) -> torch.Tensor:
    """The plan of a sequence-sharded cache: this rank's slots scored,
    the candidates merged over ``seq.ax``; where the KV heads are
    replicated and the T-local conditions hold on the slice, each
    ``model`` rank scores its part of the slice and the candidates merge
    over ``model`` first."""
    ax = heads.ax
    if not heads.kv_sharded and qk._tp_route(k, cfg, heads):
        qk.ROUTES["seq_t_local"] += 1
        tl = k.shape[1] // ax.size
        a = ax.rank * tl
        return qk.plan_candidates(
            qs, k[:, a:a + tl], key_pos[:, a:a + tl], valid[:, a:a + tl],
            cfg, budget, seq.lo + a, (ax, seq.ax),
            on_scores=_keeper(sketch, ("data", "model")))
    qk.ROUTES["seq"] += 1
    return qk.plan_candidates(
        qs, k, key_pos, valid, cfg, budget, seq.lo, (seq.ax,),
        head_ax=ax if heads.kv_sharded else None,
        on_scores=_keeper(sketch, ("data",) + (("model",)
                                               if heads.kv_sharded else ())))


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
                chunk_start, cfg: QuokaConfig, budget, q_valid, heads=None,
                seq=None):
    """Refresh-or-build this layer's plan: (plan, updated carry, stage-1
    scores).  The scores are None where the layer reused the carried plan
    (no scores were computed); they feed only the ``LayerObs`` sketch.
    A sharded layer (``heads``) builds through ``build``, and with
    telemetry on returns its ``(score_partial, axes)`` instead of the
    scores."""
    built = []

    def build_fn():
        if heads is not None:
            return build(method, q, k, key_pos, chunk_start, cfg,
                         budget=budget, q_valid=q_valid, heads=heads,
                         seq=seq, sketch=built if ctx.get("obs") else None)
        built.append(plan_scores(method, q, k, key_pos, chunk_start, cfg,
                                 q_valid=q_valid))
        return plan_from_scores(built[0], key_pos, cfg, budget=budget)

    pln, plan = refresh(plan, ctx.get("layer_idx", 0), cfg, build_fn)
    return pln, plan, (built[0] if built else None)


def select_with_ctx(ctx, plan: Optional[PlanCarry], method: str, q, k, v,
                    key_pos, chunk_start, cfg: QuokaConfig,
                    budget: Optional[int] = None, q_valid=None, heads=None,
                    seq=None):
    """The block-facing staged selection: refresh-or-build, then
    materialize.  Returns (Selected, updated carry).  With ``ctx["obs"]``
    set the layer's ``LayerObs`` is left in ``ctx["_obs"]`` (a per-layer
    ctx copy, see models/stack.py).  ``heads``: a sharded layer's
    ``HeadShard`` (``build``); the ``Selected`` holds the cache's KV
    heads.  ``seq``: the cache is this rank's slice of a
    sequence-sharded one (``build``, ``materialize``)."""
    pln, plan, scores = _layer_plan(ctx, plan, method, q, k, key_pos,
                                    chunk_start, cfg, budget, q_valid, heads,
                                    seq)
    _note_block_counts(ctx, pln, cfg)
    sel = materialize(pln, k, v, key_pos, chunk_start, cfg, seq=seq)
    ob = ctx.get("obs")
    if isinstance(ob, MeshObs):
        ctx["_obs"] = ob.selected(
            sel.pos, key_pos, chunk_start,
            _plan_budget(cfg, seq.cap if seq is not None else k.shape[1],
                         budget), scores, heads, seq)
    elif ob:
        ctx["_obs"] = selected_obs(sel.pos, key_pos, chunk_start,
                                   _plan_budget(cfg, k.shape[1], budget),
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
                window: Optional[int] = None,
                heads: Optional[comm.HeadShard] = None) -> bool:
    """May the fused selected-attention kernel replace materialize +
    attention here?  Opted in, block-granular plans whose grid divides the
    cache view, no sliding window, not a sharded layer (``heads``: the
    sharded routes stay staged, as in the reference)."""
    if not cfg.fused_select_attn or window is not None or heads is not None:
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
            chunk_start, _plan_budget(cfg, k.shape[1], budget), scores)
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


def note_dense_obs(ctx, key_pos, chunk_start) -> None:
    """With telemetry on, leave a dense (no-selection) layer's
    ``LayerObs`` in ``ctx["_obs"]``, or on a mesh its partials
    (``MeshObs.dense``; ``key_pos`` the whole cache's)."""
    ob = ctx.get("obs")
    if isinstance(ob, MeshObs):
        ctx["_obs"] = ob.dense(key_pos, chunk_start)
    elif ob:
        ctx["_obs"] = dense_obs(key_pos, chunk_start)


def missing_obs(ctx, device):
    """What a layer that left no ``LayerObs`` contributes: ``nan_obs``,
    or on a mesh ``MeshObs.nan``."""
    ob = ctx.get("obs")
    return ob.nan(device) if isinstance(ob, MeshObs) else nan_obs(device)


def score_partial(scores) -> torch.Tensor:
    """(4,) fp32 partial of ``score_sketch`` over this rank's stage-1
    scores: [sum, count] of the valid slots' scores (summed over the
    mesh), then their max and minus their min (maxed over it); a rank
    with no valid slot gives -inf for both."""
    ok = scores > NEG_INF / 2
    hi = torch.where(ok, scores, -math.inf).amax()
    lo = torch.where(ok, scores, math.inf).amin()
    return torch.stack([(scores * ok).sum(), ok.sum(dtype=torch.float32),
                        hi, -lo])


class MeshObs:
    """``ctx["obs"]`` on a mesh: each layer leaves, instead of a
    ``LayerObs``, its raw partials (12,) fp32 on the model's device

        [sel sum, sel rows, ctx sum, ctx rows, budget, budget count,
         refreshed, refreshed count, score sum, score count,
         score max, -score min]

    and ``reduce`` turns a step's stacked (n_layers, 12) partials into
    the meshless ``LayerObs`` with two collectives over the whole mesh:
    one sum of the first ten columns, one max of the last two.  Each
    quantity is counted once: the mesh partitions it over some axes (the
    step's rows over the FSDP axes when they are split, KV heads or key
    slices over ``model`` by QUOKA's route, a batch-1 cache's slots over
    ``data``) and replicates it over the others, and only the rank at
    coordinate 0 of every axis that replicates it contributes its share
    (``_owns``); a max or a min is the same either way.  Counts of
    selected and prior-context tokens are integers, so their sums and
    hence the means are the meshless ones exactly; the score mean differs
    from the meshless one only by the order of its fp32 sum."""

    def __init__(self, mesh, rows: bool):
        from repro_torch.sharding.specs import mesh_shape
        shape = mesh_shape(mesh)
        self.world = comm.world(mesh)
        self.coord = {n: comm.axis(mesh, n).rank for n in shape}
        self.rows = {"pod", "data"} & set(shape) if rows else set()

    def _owns(self, parts=()) -> bool:
        keep = self.rows | set(parts)
        return all(c == 0 for n, c in self.coord.items() if n not in keep)

    def _vec(self, device, sel=None, ctx=None, budget=None, refreshed=None,
             sketch=None) -> torch.Tensor:
        """A layer's partials: ``sel`` / ``ctx`` (mask (..., T), the axes
        that partition it) count the mask's True entries per row; the
        once-counted ``budget`` and ``refreshed``; ``sketch`` a
        (``score_partial``, axes) pair."""
        zero, ninf = _const(0.0, device), _const(-math.inf, device)
        out = [zero] * 10 + [ninf] * 2
        for i, part in ((0, sel), (2, ctx)):
            if part is not None and self._owns(part[1]):
                c = part[0].sum(-1, dtype=torch.float32)
                out[i] = c.sum()
                out[i + 1] = _const(float(c.numel()), device)
        once = self._owns()
        for i, v in ((4, budget), (6, refreshed)):
            if v is not None and once:
                out[i], out[i + 1] = _const(float(v), device), \
                    _const(1.0, device)
        if sketch is not None and self._owns(sketch[1]):
            out[8:12] = sketch[0].unbind()
        return torch.stack(out)

    def selected(self, sel_pos, key_pos, chunk_start, budget: int, built,
                 heads: comm.HeadShard, seq) -> torch.Tensor:
        """A selecting layer's partials (``selected_obs``'s quantities):
        its selected positions (this rank's KV heads when they shard;
        every ``data`` rank holds the whole budget of a sequence-sharded
        cache), its keys' positions (this rank's slots when ``seq``), and
        ``built``, the scoring route's (``score_partial``, axes), None
        where the layer reused a plan."""
        return self._vec(
            key_pos.device,
            sel=(sel_pos >= 0, ("model",) if heads.kv_sharded else ()),
            ctx=(prior_context_valid(key_pos, chunk_start),
                 ("data",) if seq is not None else ()),
            budget=budget, refreshed=0.0 if built is None else 1.0,
            sketch=built)

    def dense(self, key_pos, chunk_start) -> torch.Tensor:
        """A dense layer's partials (``dense_obs``'s quantities) over its
        whole cache's positions."""
        valid = prior_context_valid(key_pos, chunk_start)
        return self._vec(key_pos.device, sel=(valid, ()), ctx=(valid, ()),
                         refreshed=0.0)

    def nan(self, device) -> torch.Tensor:
        """The partials of a layer that never selects: all NaN once
        reduced."""
        return self._vec(device)

    def reduce(self, parts) -> LayerObs:
        """The step's per-layer partials (a list of (12,) tensors, in
        layer order) reduced over the mesh into the ``LayerObs`` with
        (n_layers,) leaves every rank returns."""
        p = torch.stack(parts)
        with comm.scope("obs"):
            s = comm.all_reduce(p[:, :10].contiguous(), self.world)
            m = comm.all_reduce_max(p[:, 10:].contiguous(), self.world)
        nan = _const(math.nan, p.device)

        def mean(i):
            return torch.where(s[:, i + 1] > 0, s[:, i] / s[:, i + 1], nan)

        seen = s[:, 9] > 0
        return LayerObs(sel_tokens=mean(0), ctx_tokens=mean(2),
                        budget_tokens=mean(4), refreshed=mean(6),
                        score_lo=torch.where(seen, -m[:, 1], nan),
                        score_mean=mean(8),
                        score_hi=torch.where(seen, m[:, 0], nan))


def _plan_budget(cfg: QuokaConfig, t: int, budget: Optional[int]) -> int:
    return floor_to_grid(min(budget or sel_scores.resolve_budget(cfg, t), t),
                         grid(cfg))
