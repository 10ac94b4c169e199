"""Attention blocks (counterpart of ``repro/models/blocks.py``):
``AttnBlock`` for kinds ``"attn"`` (GQA + SwiGLU MLP), ``"attn_local"``
(the same over a sliding window, in a ring cache of ``min(cap, window)``
slots) and ``"attn_moe"`` (GQA + MoE FFN, ``models/moe.py``), ``MLABlock``
for ``"mla"`` and ``"mla_moe"`` (DeepSeek multi-head latent attention over
a compressed ``LatentCache``), ``MambaBlock`` for ``"mamba"`` and
``"mamba_shared_attn"`` (a Mamba2 mixer, ``models/mamba2.py``; the second
then calls zamba2's shared attention block) and ``RWKVBlock`` for
``"rwkv"`` (``models/rwkv6.py``), and ``DecCrossBlock`` for whisper's
decoder layers, ``"dec_cross"``.  ``AttnBlock`` kind ``"enc_attn"`` is
whisper's encoder layer: bidirectional, no cache, never selects.  Every
block norm of the ``"audio"`` family is LayerNorm with a bias (``ln1_b``,
...), as the reference's ``_norm_fns``; every other family's is RMSNorm.

Every block has ``full_forward(x, pos, ctx)``, the reference's ``train``:
one full-sequence pass with no cache on the plain attention path (no
kernel; the reference's ``train`` reaches no Pallas kernel either),
returning ``(x, aux)`` with the MoE load-balance loss as a value (0.0 for
the other kinds).  A recurrent block starts from a fresh zero state and
writes no cache.  ``ctx`` holds ``shared`` (zamba2's shared block),
``enc_out`` (whisper's encoder output, for ``dec_cross``) and ``rows``
(the FSDP axis when the step's rows are split over it: a MoE's capacity
ranking and load-balance loss then count every rank's rows).  The name keeps
clear of ``nn.Module.train(mode)``.

``AttnBlock.apply`` runs a prefill chunk or a decode step (t == 1) against
the layer's KV cache along one of three routes, as in the reference:

  * dense bypass  ``method == "full"`` or capacity <= budget + t: plain
                  masked attention over the whole cache (no kernel);
  * fused         block-granular plan with ``fused_select_attn``: scoring
                  kernel, top-k, then the selected-attention kernel reading
                  the cache in place;
  * staged        scoring kernel, top-k, materialize, then the flash kernel
                  over [selected budget | chunk].

A windowed layer (``attn_local``) writes its ring modulo the capacity and
never takes the fused route; QUOKA still scores its ring with the scoring
kernel, but the attention over [selected | chunk] is the plain masked path,
since the window bounds each selected key per query (the kernels' contract
has a static boundary and per-key validity only), as in the reference.

``MLABlock.apply`` takes the dense bypass or the staged route only (the
reference's ``fused_route`` never takes MLA): QUOKA scores the latent as
one shared "KV head" and the flash kernel attends the absorbed queries
over ``[latent | rope]`` keys, 576 wide at deepseek-v3's geometry.

``DecCrossBlock.apply`` runs its self-attention along the same three
routes (``AttnBlock._attend``, without the MLP), then cross-attention
over the layer's ``CrossKV`` (the encoder's keys and values), then the
self-attention block's MLP.  Cross-attention and the encoder's attention
stay plain dense attention, as the reference's: no kernel is on either.

The shared block is ONE ``AttnBlock`` owned by the model and handed to
every ``mamba_shared_attn`` layer in ``ctx["shared"]`` (as the reference
closes over its shared parameters): each use attends over the layer's own
KV cache, so its weights are stored once and its caches 13 times at
zamba2-7b's depth.  The recurrent blocks update their states in place.

``ctx`` (dict): ``method``, ``qcfg`` (QuokaConfig), ``slot`` (the
chunk's cache write slot: an int, or a per-row (b,) tensor under
continuous batching; distinct from positions, since pad slots carry
pos == -1) and, under cross-layer plan reuse, ``layer_idx`` (the global
layer index ``core/plan.py::refresh`` decides on).  With ``obs`` set, an
attention layer leaves its ``LayerObs`` in ``_obs``: ``dense_obs`` at a
dense bypass, the selecting routes through ``core/plan.py``.

Tensor parallelism (``training/checkpoint.py::shard``; every kind):
``AttnBlock.place`` (``enc_attn`` too), ``MLABlock.place``,
``MambaBlock.place``, ``RWKVBlock.place`` and ``DecCrossBlock.place``
read the block's shards off its weights' shapes (the recurrent mixers:
``models/mamba2.py``, ``models/rwkv6.py``).
``n_heads`` / ``n_kv`` are then this rank's query heads and the KV heads
its cache holds (MLA: one, the latent), ``heads`` its ``HeadShard``
(selection and the KV heads each query head reads), and ``wo`` and, when
the FFN width divides, the MLP's ``down`` are row-parallel
(``layers.row_linear``); a MoE FFN runs this rank's experts
(``moe.MoE.place``).  Under FSDP (a ``pod`` / ``data`` axis) the weights'
embed axis is cut over the FSDP group as well (``fsdp``, ``_EMBED_DIM``:
the router's rows, the experts' ``d`` axis): each layer call gathers its
weights whole over that group in one all-gather (``_layer_weights``) and
drops them when it returns, so no full copy stays resident.  A batch-1
cache whose sequence is split over ``data`` (``cache.seq``) is selected
where it lies (``core/plan.py``); dense attention gathers it whole
(``cache.seq_full``).  ``ctx["rows"]`` names the FSDP axis when a step's
rows are split over it, for the MoE's global capacity ranking.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import plan as plan_mod
from repro_torch.core import quoka as qk
from repro_torch.core import selection as sel_mod
from repro_torch.core.attention import (BLOCKED_THRESHOLD, NEG_INF,
                                        attention_with_positions,
                                        blocked_attention, dense_attention,
                                        position_mask)
from repro_torch.kernels import ops as kops
from repro_torch.models import mamba2, moe, rwkv6
from repro_torch.models.layers import (gather_weights, layernorm, linear,
                                       mlp, rmsnorm, rope, row_linear)
from repro_torch.sharding import comm
from repro_torch.serving.cache import (CrossCache, CrossKV, KVCache,
                                       LatentCache, RWKVCache,
                                       SharedAttnCache, cross_init, kv_init,
                                       kv_write, kv_write_ring, latent_init,
                                       latent_write, mamba_cache_init,
                                       rwkv_cache_init, seq_full,
                                       state_write)


def _weight(dt, device):
    def w(*shape):
        return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                            requires_grad=False)
    return w


def _norm(d, device):
    return nn.Parameter(torch.ones(d, dtype=torch.float32, device=device),
                        requires_grad=False)


def _norm_params(blk, names, cfg: ModelConfig, device) -> None:
    """Each block norm of ``names``: its gain and, in the ``"audio"``
    family (whisper's LayerNorm), a bias ``<name>_b``."""
    for name in names:
        setattr(blk, name, _norm(cfg.d_model, device))
        if cfg.family == "audio":
            setattr(blk, name + "_b", nn.Parameter(
                torch.zeros(cfg.d_model, dtype=torch.float32, device=device),
                requires_grad=False))


def _block_norm(blk, name, x):
    """A block norm: LayerNorm (eps 1e-5) with a bias in the ``"audio"``
    family, else RMSNorm at the config's eps."""
    cfg = blk.cfg
    if cfg.family == "audio":
        return layernorm(getattr(blk, name), getattr(blk, name + "_b"), x)
    return rmsnorm(getattr(blk, name), x, cfg.norm_eps)


def _ffn_params(blk, cfg: ModelConfig, device, gated: bool) -> None:
    """The block's FFN: ``moe`` (models/moe.py) for a MoE kind, else the
    MLP ``mlp`` ("up", "down" and, gated, "gate")."""
    w = _weight(cfg.compute_dtype, device)
    if blk.kind.endswith("_moe"):
        blk.moe = moe.MoE(cfg, device)
    else:
        d = cfg.d_model
        blk.mlp = nn.ParameterDict({"up": w(d, cfg.d_ff),
                                    "down": w(cfg.d_ff, d)})
        if gated:
            blk.mlp["gate"] = w(d, cfg.d_ff)


def _ffn(blk, x, w, rows=None):
    """x + FFN(norm2(x)) with the layer call's weights ``w`` (``_weights``):
    the MLP, or the MoE with no aux loss (inference; ``moe.moe_apply``
    takes a ctx to accumulate it); ``rows``: the FSDP axis when the
    step's rows are split over it (MoE capacity is global)."""
    cfg = blk.cfg
    h = _block_norm(blk, "ln2", x)
    if blk.kind.endswith("_moe"):
        return x + moe.moe_apply(blk.moe, h, cfg, w=w["moe"], rows=rows)
    return x + mlp(w["mlp"], h, cfg.act, blk.tp_ffn)


def _ffn_aux(blk, x, w, rows=None):
    """``(_ffn(blk, x, w), aux)``: a MoE FFN's ``router_aux_coef``
    times its load-balance loss, accumulated into a dict of this call's
    own (so a recomputed forward cannot count it twice), else 0.0;
    ``rows`` as ``_ffn``'s (the loss then counts every rank's rows)."""
    if not blk.kind.endswith("_moe"):
        return _ffn(blk, x, w), 0.0
    c = {}
    y = moe.moe_apply(blk.moe, _block_norm(blk, "ln2", x), blk.cfg, c,
                      w=w["moe"], rows=rows)
    return x + y, c["aux_loss"]


#: the axis the FSDP group cuts (the embed axis, or the channel mix
#: ``cm/wv``'s ``d_ff`` rows) of each weight of a layer, by its name in
#: ``_held``
_EMBED_DIM = {"wq": 0, "wk": 0, "wv": 0, "wo": 1, "wq_a": 0, "wkv_a": 0,
              "xq": 0, "xk": 0, "xv": 0, "xo": 1,
              "mlp/gate": 0, "mlp/up": 0, "mlp/down": 1,
              "moe/router": 0, "moe/gate": 1, "moe/up": 1, "moe/down": 2,
              "moe/shared/gate": 0, "moe/shared/up": 0,
              "moe/shared/down": 1,
              **{f"mamba/{k}": 0 for k in ("z_proj", "x_proj", "bc_proj",
                                           "dt_proj")},
              "mamba/out_proj": 1,
              **{f"tm/{k}": 0 for k in ("wk", "wv", "wg", "wa")},
              "tm/wo": 1, "cm/wk": 0, "cm/wr": 0, "cm/wv": 0}

#: the prefixes under which ``_layer_weights`` also hands a mixer its
#: weights without the prefix
_MIXERS = ("mlp", "moe", "mamba", "tm", "cm")


def _ffn_held(blk):
    """The FFN's weights as this rank holds them: ``mlp/<name>`` or
    ``moe/<name>`` (``MoE.held``)."""
    if hasattr(blk, "moe"):
        return {f"moe/{k}": p for k, p in blk.moe.held().items()}
    return {f"mlp/{k}": p for k, p in blk.mlp.items()}


def _place_ffn(blk, ax: comm.Axis, fax: comm.Axis) -> None:
    """The FFN's layout on the ``model`` axis ``ax`` (a row-parallel
    ``down`` when it is sliced; the MoE's experts, ``MoE.place``) and
    which of the layer's weights the FSDP axis ``fax`` cut along their
    embed axis (``blk.fsdp``)."""
    if hasattr(blk, "moe"):
        blk.moe.place(ax)
    else:
        blk.tp_ffn = ax if blk.mlp["down"].shape[0] < blk.cfg.d_ff else None
    _place_fsdp(blk, fax)


def _place_fsdp(blk, fax: comm.Axis) -> None:
    """Which of the layer's weights the FSDP axis ``fax`` cut along their
    ``_EMBED_DIM`` axis (``blk.fsdp``: gathered whole per layer call)."""
    whole = {"cm/wv": blk.cfg.d_ff}
    dims = {k: _EMBED_DIM[k] for k, t in blk._held().items()
            if k in _EMBED_DIM and t.shape[_EMBED_DIM[k]]
            < whole.get(k, blk.cfg.d_model)}
    blk.fsdp = (fax, dims) if dims else None


def _layer_weights(blk):
    """The weights of one layer call: the held ones, or under FSDP the
    whole ones, gathered from the FSDP group in one all-gather for this
    call only (the caller drops them when it returns); the FFN's also
    under ``mlp`` / ``moe`` without their prefix."""
    w = blk._held()
    if blk.fsdp is not None:
        fax, dims = blk.fsdp
        w.update(gather_weights({k: (w[k], d) for k, d in dims.items()},
                                fax))
    for f in _MIXERS:
        w[f] = {k[len(f) + 1:]: p for k, p in w.items()
                if k.startswith(f + "/")}
    return w


def _divides(seq, cap: int):
    """The mesh axis ``seq`` when it divides a cache's ``cap`` slots, else
    None: as ``specs.cache_specs`` places each cache (a ring of
    ``min(cap, window)`` slots may split where the others do not)."""
    return seq if seq is not None and cap % seq.size == 0 else None


def _kv_plan_shape(cache: KVCache, t: int, method: str, qcfg):
    """Shape of the plan an attention block would build over ``cache`` for
    a t-token chunk, or None when it never selects there (``full``, the
    dense bypass, a cache off the selection grid), which disables the
    cross-layer carry."""
    b, n_kv = cache.k.shape[0], cache.k.shape[2]
    cap = cache.capacity
    budget = sel_mod.resolve_budget(qcfg, cap)
    if method == "full" or cap <= budget + t:
        return None
    if plan_mod.grid(qcfg) > 1 and cap % plan_mod.grid(qcfg):
        return None
    return plan_mod.plan_idx_shape(qcfg, b, n_kv, cap, budget)


class AttnBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device, kind: str = "attn"):
        super().__init__()
        if kind not in ("attn", "attn_local", "attn_moe", "enc_attn"):
            raise ValueError(f"block kind {kind!r} is not an attention "
                             f"block")
        self.cfg = cfg
        self.kind = kind
        self.window = cfg.sliding_window if kind == "attn_local" else None
        # this rank's query heads and held KV heads (all of them meshless)
        self.n_heads, self.n_kv = cfg.n_heads, cfg.n_kv_heads
        self.heads = None          # HeadShard under tensor parallelism
        self.tp_ffn = None         # the model axis when ``down`` is sharded
        self.fsdp = None           # (FSDP axis, {weight: its cut dim})
        d, hd = cfg.d_model, cfg.resolved_head_dim
        w = _weight(cfg.compute_dtype, device)
        _norm_params(self, ("ln1", "ln2"), cfg, device)
        self.wq = w(d, self.n_heads * hd)
        self.wk = w(d, self.n_kv * hd)
        self.wv = w(d, self.n_kv * hd)
        self.wo = w(self.n_heads * hd, d)
        _ffn_params(self, cfg, device, gated=cfg.act != "gelu")

    def place(self, ax: comm.Axis, fax: comm.Axis = None) -> None:
        """Adopt the layout of the (already sliced) weights on the
        ``model`` axis ``ax``: local head counts, the ``HeadShard``, the
        FFN's (``_place_ffn``: a row-parallel ``down``, the MoE's
        experts); and which weights the FSDP axis ``fax`` cut along their
        embed axis (``fsdp``)."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        self.n_heads = self.wq.shape[1] // hd
        self.n_kv = self.wk.shape[1] // hd
        if self.wo.shape[0] != self.n_heads * hd:
            raise ValueError("wq and wo are sliced differently")
        self.heads = comm.HeadShard(ax, cfg.n_heads, cfg.n_kv_heads,
                                    self.n_heads, self.n_kv, self.wq.device)
        _place_ffn(self, ax, fax)

    def _held(self):
        """The layer's linear weights as this rank holds them, by name."""
        return {"wq": self.wq, "wk": self.wk, "wv": self.wv, "wo": self.wo,
                **_ffn_held(self)}

    _weights = _layer_weights

    def init_cache(self, batch: int, cap: int, seq=None) -> KVCache:
        """The layer's cache of its held KV heads: ``cap`` slots, or a ring
        of at most ``window`` slots for a windowed layer; ``seq`` (a mesh
        axis) holds this rank's slice of the capacity axis where it
        divides it (``_divides``)."""
        cfg = self.cfg
        if self.window is not None:
            cap = min(cap, self.window)
        return kv_init(batch, cap, self.n_kv, cfg.resolved_head_dim,
                       cfg.compute_dtype, self.wq.device,
                       seq_ax=_divides(seq, cap))

    def _qkv(self, x, pos, w):
        cfg = self.cfg
        b, t, _ = x.shape
        hd = cfg.resolved_head_dim
        q = linear(w["wq"], x).reshape(b, t, self.n_heads, hd)
        k = linear(w["wk"], x).reshape(b, t, self.n_kv, hd)
        v = linear(w["wv"], x).reshape(b, t, self.n_kv, hd)
        if cfg.use_rope:
            q = rope(q, pos, cfg.rope_theta)
            k = rope(k, pos, cfg.rope_theta)
        return q, k, v

    def plan_carry_shape(self, cache: KVCache, t: int, method: str, qcfg):
        return _kv_plan_shape(cache, t, method, qcfg)

    def _self_attend(self, x, pos, w):
        """x plus attention over the sequence itself at positions ``pos``
        (the plain path: dense, or blocked above ``BLOCKED_THRESHOLD``
        keys): causal and windowed as the kind says, bidirectional for
        ``enc_attn``; ``w`` the layer call's weights."""
        b, t, _ = x.shape
        q, k, v = self._qkv(_block_norm(self, "ln1", x), pos, w)
        att = attention_with_positions(q, self._kv(k), self._kv(v), pos,
                                       pos, causal=self.kind != "enc_attn",
                                       window=self.window)
        return x + self._out(att.reshape(b, t, -1), w["wo"])

    def _kv(self, x):
        """The KV heads (axis 2) this rank's query heads read."""
        return x if self.heads is None else self.heads.take(x, 2)

    def _out(self, att, wo):
        """The output projection ``wo`` (or whisper's ``xo``): row-parallel
        when the heads shard."""
        h = self.heads
        return row_linear(wo, att,
                          h.ax if h is not None and h.heads_sharded else None)

    def full_forward(self, x, pos, ctx=None):
        """The full-sequence pass: attention over the sequence, then the
        MLP or the MoE.  Returns (x, aux)."""
        w = self._weights()
        return _ffn_aux(self, self._self_attend(x, pos, w), w,
                        (ctx or {}).get("rows"))

    def apply(self, x, pos, kv: KVCache, ctx, plan=None):
        """x (b, t, d), pos (b, t) (-1 = pad); writes the chunk's K/V into
        ``kv`` in place.  ``plan`` is the cross-layer ``PlanCarry`` (None:
        no reuse).  Returns (block output, updated carry); the dense bypass
        leaves the carry as it came."""
        w = self._weights()
        x, plan = self._attend(x, pos, kv, ctx, plan, w)
        return _ffn(self, x, w, ctx.get("rows")), plan

    def _attend(self, x, pos, kv: KVCache, ctx, plan, w):
        """x plus the attention sub-block's output, along the route the
        method and the cache give (no MLP; ``w`` the layer call's
        weights).  Returns (x, plan carry)."""
        b, t, _ = x.shape
        q, k, v = self._qkv(_block_norm(self, "ln1", x), pos, w)
        # the chunk's first slot, unmodded: selection compares positions
        # with it; only a ring's write takes it modulo the capacity
        start = ctx["slot"]
        write = kv_write if self.window is None else kv_write_ring
        write(kv, k, v, start, pos_new=pos)
        method = ctx.get("method", "full")
        qcfg = ctx["qcfg"]
        budget = sel_mod.resolve_budget(qcfg, kv.capacity) \
            if method != "full" else 0
        if kv.seq is not None and (method == "full" or kv.capacity <=
                                   budget + t or not qk.seq_route(kv.k,
                                                                  qcfg)):
            kv = seq_full(kv)       # every key, or a grid across slices
        if method == "full" or kv.capacity <= budget + t:
            att = attention_with_positions(q, self._kv(kv.k), self._kv(kv.v),
                                           pos, kv.pos, causal=True,
                                           window=self.window)
            plan_mod.note_dense_obs(ctx, kv.pos, start)
        elif plan_mod.fused_route(qcfg, method, kv.k, window=self.window,
                                  heads=self.heads):
            # the chunk's KV was just written into the cache, so the kernel
            # reads it from there rather than from a [budget | chunk] concat
            att, plan = plan_mod.fused_attend_with_ctx(
                ctx, plan, method, q, kv.k, kv.v, kv.pos, start, qcfg,
                budget=budget, q_valid=pos >= 0)
        else:
            sel, plan = plan_mod.select_with_ctx(
                ctx, plan, method, q, kv.k, kv.v, kv.pos, start, qcfg,
                budget=budget, q_valid=pos >= 0, heads=self.heads,
                seq=kv.seq)
            if self.heads is not None:
                tk = self.heads.take
                sel = sel._replace(k=tk(sel.k, 2), v=tk(sel.v, 2),
                                   pos=tk(sel.pos, 1), idx=tk(sel.idx, 1))
            att = self._selected_attention(q, self._kv(k), self._kv(v), pos,
                                           sel)
        return x + self._out(att.reshape(b, t, -1), w["wo"]), plan

    def _selected_attention(self, q, k_chunk, v_chunk, pos, sel):
        """Attention over [selected budget | current chunk]: the budget is
        an unconditioned prefix (``boundary``), its padding is masked by a
        per-KV-head ``k_valid`` (sel.pos == -1), chunk pad slots too.

        A windowed layer takes the plain masked path instead: a selected
        key is attendable only inside each query's window, a per-query
        bound the kernel's contract cannot express (as in the reference)."""
        b, t = q.shape[:2]
        n_kv = k_chunk.shape[2]
        k_cat = torch.cat([sel.k, k_chunk], dim=1)
        v_cat = torch.cat([sel.v, v_chunk], dim=1)
        chunk_valid = (pos >= 0)[:, None, :].expand(b, n_kv, t)
        if self.window is None:
            k_valid = torch.cat([sel.pos >= 0, chunk_valid], dim=-1)
            return kops.attention(q, k_cat, v_cat, k_valid, causal=True,
                                  boundary=sel.pos.shape[-1])
        qp = pos[:, None, :, None]                          # (b, 1, t, 1)
        sp = sel.pos[:, :, None, :]                         # (b, n_kv, 1, B)
        m_sel = ((sp >= 0) & (sp > qp - self.window)).expand(
            b, n_kv, t, sel.pos.shape[-1])
        tri = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        m_chunk = tri[None, None] & chunk_valid[:, :, None, :]
        return dense_attention(q, k_cat, v_cat,
                               torch.cat([m_sel, m_chunk], dim=-1))


class MLABlock(nn.Module):
    """DeepSeek MLA (kinds ``"mla"``, ``"mla_moe"``): queries absorbed into
    the latent space (``q_abs[h] = q_nope[h] @ W_uk[h]``), one compressed
    latent per token plus a shared rope key in the cache, attention in
    latent space and the values decompressed by ``W_uv`` after it.

    Tensor parallelism (``place``): ``wq_b``'s columns, ``wk_b`` /
    ``wv_b``'s head axis and ``wo``'s rows are head-major, so a contiguous
    cut gives this rank whole heads (``n_heads`` local); ``wo`` is then
    row-parallel.  The latent is one shared "KV head", replicated over
    ``model``: every rank writes all of it, and its ``HeadShard`` has one
    KV head, so QUOKA takes the T-local route (each rank scores its ``T /
    M`` slice of the latent) with the group-coherent sub-selection over
    every head.  Under FSDP ``wq_a``, ``wkv_a``, ``wo`` and the FFN are
    gathered per call as ``AttnBlock``'s weights; a batch-1 latent whose
    sequence is split over ``data`` (``SeqLatentCache``) is selected
    where it lies."""

    def __init__(self, cfg: ModelConfig, device, kind: str = "mla"):
        super().__init__()
        if kind not in ("mla", "mla_moe"):
            raise ValueError(f"block kind {kind!r} is not an MLA block")
        self.cfg = cfg
        self.kind = kind
        m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
        self.n_heads = h           # this rank's query heads
        self.heads = None          # HeadShard under tensor parallelism
        self.tp_ffn = None         # the model axis when ``down`` is sharded
        self.fsdp = None           # (FSDP axis, {weight: its cut dim})
        self.scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
        w = _weight(cfg.compute_dtype, device)
        self.ln1 = _norm(d, device)
        self.wq_a = w(d, m.q_lora_rank)
        self.q_ln = _norm(m.q_lora_rank, device)
        self.wq_b = w(m.q_lora_rank, h * (m.qk_nope_dim + m.qk_rope_dim))
        self.wkv_a = w(d, m.kv_lora_rank + m.qk_rope_dim)
        self.kv_ln = _norm(m.kv_lora_rank, device)
        # decompression weights, head-major for absorption
        self.wk_b = w(m.kv_lora_rank, h, m.qk_nope_dim)
        self.wv_b = w(m.kv_lora_rank, h, m.v_head_dim)
        self.wo = w(h * m.v_head_dim, d)
        self.ln2 = _norm(d, device)
        _ffn_params(self, cfg, device, gated=True)

    def place(self, ax: comm.Axis, fax: comm.Axis = None) -> None:
        """Adopt the layout of the (already sliced) weights on the
        ``model`` axis ``ax``: the local query heads (``wq_b``'s columns),
        the ``HeadShard`` of one KV head, the FFN's (``_place_ffn``); and
        which weights the FSDP axis ``fax`` cut (``fsdp``)."""
        cfg, m = self.cfg, self.cfg.mla
        self.n_heads = self.wq_b.shape[1] // (m.qk_nope_dim + m.qk_rope_dim)
        if not (self.wk_b.shape[1] == self.wv_b.shape[1] == self.n_heads
                and self.wo.shape[0] == self.n_heads * m.v_head_dim):
            raise ValueError("wq_b, wk_b, wv_b and wo are sliced "
                             "differently")
        self.heads = comm.HeadShard(ax, cfg.n_heads, 1, self.n_heads, 1,
                                    self.wq_b.device)
        _place_ffn(self, ax, fax)

    def _held(self):
        """The layer's linear weights as this rank holds them, by name."""
        return {"wq_a": self.wq_a, "wq_b": self.wq_b, "wkv_a": self.wkv_a,
                "wk_b": self.wk_b, "wv_b": self.wv_b, "wo": self.wo,
                **_ffn_held(self)}

    _weights = _layer_weights

    def init_cache(self, batch: int, cap: int, seq=None) -> LatentCache:
        """The layer's latent cache of ``cap`` slots, the whole latent on
        every ``model`` rank; ``seq`` (a mesh axis) holds this rank's
        slice of the capacity axis."""
        m = self.cfg.mla
        return latent_init(batch, cap, m.kv_lora_rank, m.qk_rope_dim,
                           self.cfg.compute_dtype, self.wq_a.device,
                           seq_ax=seq)

    # ---- projections ----
    def _queries(self, h, pos, w=None):
        """(q_abs (b, t, H, r), q_rope (b, t, H, rope)) of this rank's H
        query heads; ``w`` the layer call's weights (default the held
        ones)."""
        cfg, m = self.cfg, self.cfg.mla
        w = self._held() if w is None else w
        b, t, _ = h.shape
        cq = rmsnorm(self.q_ln, linear(w["wq_a"], h), cfg.norm_eps)
        q = linear(w["wq_b"], cq).reshape(b, t, self.n_heads,
                                          m.qk_nope_dim + m.qk_rope_dim)
        q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
        q_rope = rope(q_rope, pos, cfg.rope_theta)
        q_abs = torch.einsum("bthn,rhn->bthr", q_nope,
                             w["wk_b"].to(q_nope.dtype))
        return q_abs, q_rope

    def _latent_kv(self, h, pos, w=None):
        """(ckv (b, t, r) normalised latent, kr (b, t, rope) rope'd key)."""
        cfg, m = self.cfg, self.cfg.mla
        w = self._held() if w is None else w
        kv = linear(w["wkv_a"], h)
        ckv = rmsnorm(self.kv_ln, kv[..., :m.kv_lora_rank], cfg.norm_eps)
        kr = rope(kv[:, :, None, m.kv_lora_rank:], pos,
                  cfg.rope_theta)[:, :, 0, :]
        return ckv, kr

    def _decompress(self, o_lat, dtype):
        """Latent attention output (b, t, H, r) -> (b, t, H * v) via W_uv
        (this rank's heads), in fp32 as the reference."""
        b, t = o_lat.shape[:2]
        out = torch.einsum("bthr,rhv->bthv", o_lat.float(),
                           self.wv_b.float())
        return out.reshape(b, t, -1).to(dtype)

    def _out(self, att, w):
        """The output projection: row-parallel when the heads shard."""
        h = self.heads
        return row_linear(w["wo"], att,
                          h.ax if h is not None and h.heads_sharded else None)

    def _absorbed_full(self, q_abs, q_rope, ckv, krope, q_pos, k_pos):
        """Position-masked absorbed attention over keys ``[ckv | krope]``
        at ``k_pos`` (the whole cache, or the sequence itself in the
        full-sequence pass); key blocks stream through
        ``blocked_attention`` above its threshold, as in the reference."""
        if ckv.shape[1] > BLOCKED_THRESHOLD:
            qc = torch.cat([q_abs, q_rope], dim=-1)
            kc = torch.cat([ckv, krope], dim=-1)
            o_lat = blocked_attention(qc, kc[:, :, None], ckv[:, :, None],
                                      q_pos, k_pos, causal=True,
                                      scale=self.scale)
            return self._decompress(o_lat, q_abs.dtype)
        mask = position_mask(q_pos, k_pos, causal=True)
        return self._absorbed_attention(q_abs, q_rope, ckv, krope, mask)

    def full_forward(self, x, pos, ctx=None):
        """The full-sequence pass: absorbed attention of the sequence over
        its own latents, then the MLP or the MoE.  Returns (x, aux)."""
        w = self._weights()
        h = rmsnorm(self.ln1, x, self.cfg.norm_eps)
        q_abs, q_rope = self._queries(h, pos, w)
        ckv, kr = self._latent_kv(h, pos, w)
        att = self._absorbed_full(q_abs, q_rope, ckv, kr, pos, pos)
        return _ffn_aux(self, x + self._out(att, w), w,
                        (ctx or {}).get("rows"))

    def _absorbed_attention(self, q_abs, q_rope, ckv, krope, mask):
        """Attention entirely in latent space (the MLA deployment trick);
        a fully-masked row keeps the reference's uniform softmax."""
        logits = (torch.einsum("bthr,bsr->bhts", q_abs.float(), ckv.float())
                  + torch.einsum("bthr,bsr->bhts", q_rope.float(),
                                 krope.float())) * self.scale
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
        probs = torch.softmax(logits, dim=-1)
        o_lat = torch.einsum("bhts,bsr->bthr", probs, ckv.float())
        return self._decompress(o_lat, q_abs.dtype)

    def plan_carry_shape(self, cache: LatentCache, t: int, method: str,
                         qcfg):
        """Latent selection geometry: one shared "KV head" (n_kv == 1)."""
        b, cap = cache.latent.shape[0], cache.capacity
        budget = sel_mod.resolve_budget(qcfg, cap)
        if method == "full" or cap <= budget + t:
            return None
        if plan_mod.grid(qcfg) > 1 and cap % plan_mod.grid(qcfg):
            return None
        return plan_mod.plan_idx_shape(qcfg, b, 1, cap, budget)

    def apply(self, x, pos, lat: LatentCache, ctx, plan=None):
        """As ``AttnBlock.apply``, over the layer's latent cache (written
        in place)."""
        cfg = self.cfg
        w = self._weights()
        h = rmsnorm(self.ln1, x, cfg.norm_eps)
        q_abs, q_rope = self._queries(h, pos, w)
        ckv, kr = self._latent_kv(h, pos, w)
        start = ctx["slot"]
        latent_write(lat, ckv, kr, start, pos_new=pos)
        method = ctx.get("method", "full")
        qcfg = ctx["qcfg"]
        budget = sel_mod.resolve_budget(qcfg, lat.capacity) \
            if method != "full" else 0
        dense = method == "full" or lat.capacity <= budget + x.shape[1]
        if lat.seq is not None and (dense or not qk.seq_route(lat.latent[
                :, :, None], qcfg)):
            lat = seq_full(lat)     # every key, or a grid across slices
        if dense:
            att = self._absorbed_full(q_abs, q_rope, lat.ckv, lat.krope,
                                      pos, lat.pos)
            plan_mod.note_dense_obs(ctx, lat.pos, start)
        else:
            att, plan = self._selected_attention(q_abs, q_rope, ckv, kr, pos,
                                                 lat, start, ctx, plan)
        x = x + self._out(att, w)
        return _ffn(self, x, w, ctx.get("rows")), plan

    def _selected_attention(self, q_abs, q_rope, ckv_chunk, kr_chunk, pos,
                            lat: LatentCache, start, ctx, plan=None):
        """QUOKA (or a baseline) on the compressed latent: one shared "KV
        head" per token, scored by the absorbed per-head queries, so
        pre-aggregation runs over all heads (n_kv == 1; on a mesh over
        every rank's heads, ``plan``'s T-local route).  Then flash over
        ``[selected | chunk]`` on this rank's heads: queries and keys are
        ``[absorbed | rope]`` vectors, the values the latent itself (its
        first ``r`` key columns, no copy), where the reference pads it with
        zeros to the key width and slices the output: the same numbers."""
        qc = ctx["qcfg"]
        method = ctx.get("method", "quoka")
        r = lat.rank
        keys = lat.latent[:, :, None, :]                        # (b,T,1,r+rd)
        q_score = torch.cat([q_abs, q_rope], dim=-1)            # (b,t,H,r+rd)
        sel, plan = plan_mod.select_with_ctx(
            ctx, plan, method, q_score, keys, keys, lat.pos, start, qc,
            q_valid=pos >= 0, heads=self.heads, seq=lat.seq)
        chunk = torch.cat([ckv_chunk, kr_chunk], dim=-1)        # (b,t,r+rd)
        k_cat = torch.cat([sel.k[:, :, 0], chunk], dim=1)[:, :, None, :]
        k_valid = torch.cat([sel.pos >= 0, (pos >= 0)[:, None, :]], dim=-1)
        o_lat = kops.attention(q_score, k_cat, k_cat[..., :r], k_valid,
                               causal=True, boundary=sel.pos.shape[-1],
                               scale=self.scale)
        return self._decompress(o_lat, q_abs.dtype), plan


class MambaBlock(nn.Module):
    """``x + Mamba2(norm(x))`` (kind ``"mamba"``); kind
    ``"mamba_shared_attn"`` then applies the model's shared attention
    block (``ctx["shared"]``) over this layer's own KV cache.

    On a mesh (``place``) the mixer runs this rank's SSD heads
    (``mamba2.Mamba2.place``) and its state holds them; the shared block's
    KV cache holds the KV heads the shared block holds (``n_kv``), and a
    batch-1 cache may split its sequence (``init_cache(seq=)``)."""

    def __init__(self, cfg: ModelConfig, device, kind: str = "mamba"):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        self.with_shared = kind == "mamba_shared_attn"
        self.n_kv = cfg.n_kv_heads  # the shared block's held KV heads
        self.fsdp = None            # (FSDP axis, {weight: its cut dim})
        self.ln = _norm(cfg.d_model, device)
        self.mamba = mamba2.Mamba2(cfg, device)

    def place(self, ax: comm.Axis, fax: comm.Axis = None,
              shared: "AttnBlock" = None) -> None:
        """Adopt the layout of the (already sliced) weights: the mixer's
        heads on the ``model`` axis ``ax``, the weights the FSDP axis
        ``fax`` cut, and the KV heads of the (placed) ``shared`` block."""
        self.mamba.place(ax)
        _place_fsdp(self, fax)
        if shared is not None:
            self.n_kv = shared.n_kv

    def _held(self):
        return {f"mamba/{k}": p for k, p in self.mamba.held().items()}

    _weights = _layer_weights

    def init_cache(self, batch: int, cap: int, seq=None):
        """A ``MambaCache`` of this rank's heads (its x channels and the
        whole B / C ones in the convolution tail) or, with the shared
        block, a ``SharedAttnCache`` that adds a KV cache of ``cap``
        slots (``seq`` as ``AttnBlock.init_cache``'s)."""
        cfg, s, m = self.cfg, self.cfg.ssm, self.mamba
        dev = self.ln.device
        mc = mamba_cache_init(batch, s.d_conv,
                              m.norm.shape[0] + 2 * s.d_state,
                              m.a_log.shape[0], s.head_dim, s.d_state,
                              cfg.compute_dtype, dev)
        if not self.with_shared:
            return mc
        return SharedAttnCache(mamba=mc, kv=kv_init(
            batch, cap, self.n_kv, cfg.resolved_head_dim, cfg.compute_dtype,
            dev, seq_ax=_divides(seq, cap)))

    def plan_carry_shape(self, cache, t: int, method: str, qcfg):
        """A plain Mamba2 layer builds no plan, which turns the carry off
        for any stack that holds one, as in the reference."""
        if not self.with_shared:
            return None
        return _kv_plan_shape(cache.kv, t, method, qcfg)

    def full_forward(self, x, pos, ctx):
        """The full-sequence pass from a zero state of this rank's heads
        (written nowhere) with the layer call's weights, then the shared
        block's full-sequence pass.  Returns (x, aux)."""
        cfg, s, m = self.cfg, self.cfg.ssm, self.mamba
        zero = mamba_cache_init(x.shape[0], s.d_conv,
                                m.norm.shape[0] + 2 * s.d_state,
                                m.a_log.shape[0], s.head_dim, s.d_state,
                                x.dtype, x.device)
        y, _ = mamba2.mamba_apply(m, rmsnorm(self.ln, x, cfg.norm_eps),
                                  zero, cfg, w=self._weights()["mamba"])
        x = x + y
        if self.with_shared:
            return ctx["shared"].full_forward(x, pos, ctx)
        return x, 0.0

    def apply(self, x, pos, cache, ctx, plan=None):
        mc = cache.mamba if self.with_shared else cache
        y, new = mamba2.mamba_apply(
            self.mamba, rmsnorm(self.ln, x, self.cfg.norm_eps), mc, self.cfg,
            w=self._weights()["mamba"])
        state_write(mc, new)
        x = x + y
        if self.with_shared:
            x, plan = ctx["shared"].apply(x, pos, cache.kv, ctx, plan=plan)
        return x, plan


class RWKVBlock(nn.Module):
    """``x + time_mix(norm1(x))``, then ``x + channel_mix(norm2(x))``.  On
    a mesh (``place``) the time mix runs this rank's wkv heads and its
    state holds them (``rwkv6.py``)."""

    def __init__(self, cfg: ModelConfig, device, kind: str = "rwkv"):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        self.fsdp = None            # (FSDP axis, {weight: its cut dim})
        self.ln1 = _norm(cfg.d_model, device)
        self.ln2 = _norm(cfg.d_model, device)
        self.tm = rwkv6.TimeMix(cfg, device)
        self.cm = rwkv6.ChannelMix(cfg, device)

    def place(self, ax: comm.Axis, fax: comm.Axis = None) -> None:
        """Adopt the layout of the (already sliced) weights on the
        ``model`` axis ``ax`` and which ones the FSDP axis ``fax`` cut."""
        self.tm.place(ax)
        self.cm.place(ax)
        _place_fsdp(self, fax)

    def _held(self):
        return {**{f"tm/{k}": p for k, p in self.tm.held().items()},
                **{f"cm/{k}": p for k, p in self.cm.held().items()}}

    _weights = _layer_weights

    def init_cache(self, batch: int, cap: int, seq=None) -> RWKVCache:
        """The token-shift carries (whole: the residual stream is) and the
        wkv state of this rank's heads; ``seq`` is ignored (the state has
        no sequence axis: at batch 1 every ``data`` rank runs the whole
        scan)."""
        cfg = self.cfg
        hd = cfg.rwkv.head_dim
        return rwkv_cache_init(batch, cfg.d_model, self.tm.wk.shape[1] // hd,
                               hd, cfg.compute_dtype, self.ln1.device)

    def plan_carry_shape(self, cache, t: int, method: str, qcfg):
        return None

    def _run(self, x, cache: RWKVCache, w=None):
        """Both mixes over the segment from ``cache``'s state (read, not
        written), with the layer call's weights ``w`` (default: the
        held ones).  Returns (x, the new ``RWKVCache``)."""
        cfg = self.cfg
        w = w or {"tm": None, "cm": None}
        y, sh_tm, wkv = rwkv6.time_mix(self.tm, rmsnorm(self.ln1, x,
                                                        cfg.norm_eps),
                                       cache.shift_tm, cache.wkv, cfg,
                                       w=w["tm"])
        x = x + y
        y, sh_cm = rwkv6.channel_mix(self.cm, rmsnorm(self.ln2, x,
                                                      cfg.norm_eps),
                                     cache.shift_cm, w=w["cm"])
        return x + y, RWKVCache(shift_tm=sh_tm, shift_cm=sh_cm, wkv=wkv)

    def full_forward(self, x, pos, ctx=None):
        """The full-sequence pass from a zero state of this rank's heads
        (written nowhere) with the layer call's weights.  Returns (x,
        0.0)."""
        hd = self.cfg.rwkv.head_dim
        zero = rwkv_cache_init(x.shape[0], self.cfg.d_model,
                               self.tm.wk.shape[1] // hd, hd, x.dtype,
                               x.device)
        return self._run(x, zero, self._weights())[0], 0.0

    def apply(self, x, pos, cache: RWKVCache, ctx, plan=None):
        x, new = self._run(x, cache, self._weights())
        state_write(cache, new)
        return x, plan


class DecCrossBlock(nn.Module):
    """Whisper's decoder layer (kind ``"dec_cross"``), in the reference's
    order: causal self-attention with its residual (``self_attn``, an
    ``AttnBlock`` whose MLP runs last), cross-attention with its residual
    (queries from ``ln_x``; ``xq``, ``xk``, ``xv``, ``xo`` carry no bias;
    plain dense attention over the encoder's keys with no mask, as the
    reference's ``_cross``), then ``self_attn``'s MLP on ``self_attn``'s
    ``ln2`` of the post-cross stream.

    On a mesh (``place``) the self-attention is placed as any attention
    block (QUOKA takes its routes); the cross-attention runs the same
    local query heads (``xq``'s columns) over the KV heads its
    ``CrossKV`` holds (``xk`` / ``xv``'s columns, read through the
    self-attention's ``HeadShard``), and ``xo`` is row-parallel.  Under
    FSDP one all-gather a layer call brings the self-attention's and the
    cross weights whole.  A batch-1 ``CrossKV`` whose encoder frames are
    split over ``data`` (``SeqCrossKV``) is attended where it lies: each
    rank's unnormalised output over its frames, with its row max and
    sum, travel in one fp32 all-gather and merge exactly
    (``_cross_merge``)."""

    def __init__(self, cfg: ModelConfig, device, kind: str = "dec_cross"):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        self.fsdp = None           # (FSDP axis, {weight: its cut dim})
        d, hd = cfg.d_model, cfg.resolved_head_dim
        w = _weight(cfg.compute_dtype, device)
        self.self_attn = AttnBlock(cfg, device, "attn")
        _norm_params(self, ("ln_x",), cfg, device)
        self.xq = w(d, cfg.n_heads * hd)
        self.xk = w(d, cfg.n_kv_heads * hd)
        self.xv = w(d, cfg.n_kv_heads * hd)
        self.xo = w(cfg.n_heads * hd, d)

    def place(self, ax: comm.Axis, fax: comm.Axis = None) -> None:
        """Place the self-attention (``AttnBlock.place``), check that the
        cross weights hold its heads, and record which of the layer's
        weights the FSDP axis ``fax`` cut (``fsdp``: gathered together
        per layer call)."""
        sa, hd = self.self_attn, self.cfg.resolved_head_dim
        sa.place(ax, fax)
        if (self.xq.shape[1] != sa.n_heads * hd
                or self.xo.shape[0] != sa.n_heads * hd
                or self.xk.shape[1] != sa.n_kv * hd):
            raise ValueError("the cross weights are sliced differently "
                             "from the self-attention's")
        _place_fsdp(self, fax)

    def _held(self):
        """The self-attention's and the cross-attention's linear weights
        as this rank holds them, by name."""
        return {**self.self_attn._held(), "xq": self.xq, "xk": self.xk,
                "xv": self.xv, "xo": self.xo}

    _weights = _layer_weights

    def init_cache(self, batch: int, cap: int, seq=None) -> CrossCache:
        """The self-attention's ``cap``-slot KV cache and an empty
        ``CrossKV`` of ``encoder.n_ctx`` frames of the held KV heads
        (``Model._build_cross`` fills it); ``seq`` (a mesh axis) holds this
        rank's slice of each one's sequence where it divides it."""
        cfg, sa = self.cfg, self.self_attn
        n_ctx = cfg.encoder.n_ctx
        return CrossCache(
            kv=sa.init_cache(batch, cap, seq),
            cross=cross_init(batch, n_ctx, sa.n_kv, cfg.resolved_head_dim,
                             cfg.compute_dtype, self.xq.device,
                             seq_ax=_divides(seq, n_ctx)))

    def build_cross(self, enc_out, w=None) -> CrossKV:
        """The cross-attention keys and values of the encoder's output
        (b, s, d): the held KV heads; ``w`` the layer call's weights."""
        w = self._held() if w is None else w
        b, s, _ = enc_out.shape
        hd = self.cfg.resolved_head_dim
        return CrossKV(k=linear(w["xk"], enc_out).reshape(b, s, -1, hd),
                       v=linear(w["xv"], enc_out).reshape(b, s, -1, hd))

    def write_cross(self, cross, enc_out) -> None:
        """Fill ``cross`` in place with the keys and values of the
        encoder's output (b, n_ctx, d): its KV heads and, split over
        ``data``, its frames."""
        if cross.seq is not None:
            n = cross.k.shape[1]
            enc_out = enc_out[:, cross.seq.lo:cross.seq.lo + n]
        new = self.build_cross(enc_out, self._weights())
        cross.k.copy_(new.k)
        cross.v.copy_(new.v)

    def _cross(self, x, cross, w):
        """x plus cross-attention over ``cross`` (non-causal, no mask),
        on this rank's query heads; ``w`` the layer call's weights."""
        sa = self.self_attn
        b, t, _ = x.shape
        h = _block_norm(self, "ln_x", x)
        q = linear(w["xq"], h).reshape(b, t, sa.n_heads,
                                       self.cfg.resolved_head_dim)
        k, v = sa._kv(cross.k), sa._kv(cross.v)
        if cross.seq is None:
            att = dense_attention(q, k, v)
        else:
            att = _cross_merge(q, k, v, cross.seq.ax)
        return x + sa._out(att.reshape(b, t, -1), w["xo"])

    def plan_carry_shape(self, cache: CrossCache, t: int, method: str,
                         qcfg):
        return self.self_attn.plan_carry_shape(cache.kv, t, method, qcfg)

    def full_forward(self, x, pos, ctx):
        """The full-sequence pass: causal self-attention over the sequence,
        cross-attention over the keys and values of ``ctx["enc_out"]``,
        then the MLP.  Returns (x, 0.0)."""
        w = self._weights()
        x = self.self_attn._self_attend(x, pos, w)
        x = self._cross(x, self.build_cross(ctx["enc_out"], w), w)
        return _ffn(self.self_attn, x, w), 0.0

    def apply(self, x, pos, cache: CrossCache, ctx, plan=None):
        w = self._weights()
        x, plan = self.self_attn._attend(x, pos, cache.kv, ctx, plan, w)
        x = self._cross(x, cache.cross, w)
        return _ffn(self.self_attn, x, w, ctx.get("rows")), plan


def _cross_merge(q, k, v, ax: comm.Axis):
    """``dense_attention(q, k, v)`` (no mask) over keys and values whose
    sequence is split over ``ax``: each rank's fp32 unnormalised output
    over its keys, its row max ``m`` and its row sum ``l`` (b, t, h, d +
    2) cross in one all-gather; every rank then rescales each part by
    ``exp(m_r - max_r m_r)`` and divides the summed outputs by the summed
    sums, in fp32, and casts once to q's dtype."""
    b, t, n_q, d = q.shape
    group = n_q // k.shape[2]
    kr = k.repeat_interleave(group, dim=2) if group > 1 else k
    vr = v.repeat_interleave(group, dim=2) if group > 1 else v
    logits = torch.einsum("bthd,bshd->bths", q.float(),
                          kr.float()) * d ** -0.5
    m = logits.amax(-1, keepdim=True)                        # (b, t, h, 1)
    p = torch.exp(logits - m)
    o = torch.einsum("bths,bshd->bthd", p, vr.float())
    with comm.scope("cross"):
        parts = comm.all_gather_parts(
            torch.cat([o, m, p.sum(-1, keepdim=True)], dim=-1), ax)
    top = torch.stack([pt[..., d] for pt in parts]).amax(0)[..., None]
    o = l = 0
    for pt in parts:
        a = torch.exp(pt[..., d:d + 1] - top)
        o = o + pt[..., :d] * a
        l = l + pt[..., d + 1:] * a
    return (o / l).to(q.dtype)


def make_block(cfg: ModelConfig, kind: str, device):
    if kind in ("mla", "mla_moe"):
        return MLABlock(cfg, device, kind)
    if kind in ("mamba", "mamba_shared_attn"):
        return MambaBlock(cfg, device, kind)
    if kind == "rwkv":
        return RWKVBlock(cfg, device, kind)
    if kind == "dec_cross":
        return DecCrossBlock(cfg, device, kind)
    return AttnBlock(cfg, device, kind)
