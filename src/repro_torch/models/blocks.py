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
writes no cache.  ``ctx`` holds ``shared`` (zamba2's shared block) and
``enc_out`` (whisper's encoder output, for ``dec_cross``).  The name keeps
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
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import plan as plan_mod
from repro_torch.core import selection as sel_mod
from repro_torch.core.attention import (BLOCKED_THRESHOLD, NEG_INF,
                                        attention_with_positions,
                                        blocked_attention, dense_attention,
                                        position_mask)
from repro_torch.kernels import ops as kops
from repro_torch.models import mamba2, moe, rwkv6
from repro_torch.models.layers import (layernorm, linear, mlp, rmsnorm,
                                       rope)
from repro_torch.serving.cache import (CrossCache, CrossKV, KVCache,
                                       LatentCache, RWKVCache,
                                       SharedAttnCache, cross_init, kv_init,
                                       kv_write, kv_write_ring, latent_init,
                                       latent_write, mamba_cache_init,
                                       rwkv_cache_init, state_write)


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


def _ffn(blk, x):
    """x + FFN(norm2(x)): the MLP, or the MoE with no aux loss (inference;
    ``moe.moe_apply`` takes a ctx to accumulate it)."""
    cfg = blk.cfg
    h = _block_norm(blk, "ln2", x)
    if blk.kind.endswith("_moe"):
        return x + moe.moe_apply(blk.moe, h, cfg)
    return x + mlp(blk.mlp, h, cfg.act)


def _ffn_aux(blk, x):
    """``(_ffn(blk, x), aux)``: a MoE FFN's ``router_aux_coef`` times its
    load-balance loss, accumulated into a dict of this call's own (so a
    recomputed forward cannot count it twice), else 0.0."""
    if not blk.kind.endswith("_moe"):
        return _ffn(blk, x), 0.0
    c = {}
    y = moe.moe_apply(blk.moe, _block_norm(blk, "ln2", x), blk.cfg, c)
    return x + y, c["aux_loss"]


def _kv_plan_shape(cache: KVCache, t: int, method: str, qcfg):
    """Shape of the plan an attention block would build over ``cache`` for
    a t-token chunk, or None when it never selects there (``full``, the
    dense bypass, a cache off the selection grid), which disables the
    cross-layer carry."""
    b, cap, n_kv = cache.k.shape[:3]
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
            raise NotImplementedError(f"block kind {kind!r} is not yet ported")
        self.cfg = cfg
        self.kind = kind
        self.window = cfg.sliding_window if kind == "attn_local" else None
        d, hd = cfg.d_model, cfg.resolved_head_dim
        w = _weight(cfg.compute_dtype, device)
        _norm_params(self, ("ln1", "ln2"), cfg, device)
        self.wq = w(d, cfg.n_heads * hd)
        self.wk = w(d, cfg.n_kv_heads * hd)
        self.wv = w(d, cfg.n_kv_heads * hd)
        self.wo = w(cfg.n_heads * hd, d)
        _ffn_params(self, cfg, device, gated=cfg.act != "gelu")

    def init_cache(self, batch: int, cap: int) -> KVCache:
        """The layer's cache: ``cap`` slots, or a ring of at most ``window``
        slots for a windowed layer."""
        cfg = self.cfg
        if self.window is not None:
            cap = min(cap, self.window)
        return kv_init(batch, cap, cfg.n_kv_heads, cfg.resolved_head_dim,
                       cfg.compute_dtype, self.wq.device)

    def _qkv(self, x, pos):
        cfg = self.cfg
        b, t, _ = x.shape
        hd = cfg.resolved_head_dim
        q = linear(self.wq, x).reshape(b, t, cfg.n_heads, hd)
        k = linear(self.wk, x).reshape(b, t, cfg.n_kv_heads, hd)
        v = linear(self.wv, x).reshape(b, t, cfg.n_kv_heads, hd)
        if cfg.use_rope:
            q = rope(q, pos, cfg.rope_theta)
            k = rope(k, pos, cfg.rope_theta)
        return q, k, v

    def plan_carry_shape(self, cache: KVCache, t: int, method: str, qcfg):
        return _kv_plan_shape(cache, t, method, qcfg)

    def _self_attend(self, x, pos):
        """x plus attention over the sequence itself at positions ``pos``
        (the plain path: dense, or blocked above ``BLOCKED_THRESHOLD``
        keys): causal and windowed as the kind says, bidirectional for
        ``enc_attn``."""
        b, t, _ = x.shape
        q, k, v = self._qkv(_block_norm(self, "ln1", x), pos)
        att = attention_with_positions(q, k, v, pos, pos,
                                       causal=self.kind != "enc_attn",
                                       window=self.window)
        return x + linear(self.wo, att.reshape(b, t, -1))

    def full_forward(self, x, pos, ctx=None):
        """The full-sequence pass: attention over the sequence, then the
        MLP or the MoE.  Returns (x, aux)."""
        return _ffn_aux(self, self._self_attend(x, pos))

    def apply(self, x, pos, kv: KVCache, ctx, plan=None):
        """x (b, t, d), pos (b, t) (-1 = pad); writes the chunk's K/V into
        ``kv`` in place.  ``plan`` is the cross-layer ``PlanCarry`` (None:
        no reuse).  Returns (block output, updated carry); the dense bypass
        leaves the carry as it came."""
        x, plan = self._attend(x, pos, kv, ctx, plan)
        return _ffn(self, x), plan

    def _attend(self, x, pos, kv: KVCache, ctx, plan=None):
        """x plus the attention sub-block's output, along the route the
        method and the cache give (no MLP).  Returns (x, plan carry)."""
        b, t, _ = x.shape
        q, k, v = self._qkv(_block_norm(self, "ln1", x), pos)
        # the chunk's first slot, unmodded: selection compares positions
        # with it; only a ring's write takes it modulo the capacity
        start = ctx["slot"]
        write = kv_write if self.window is None else kv_write_ring
        write(kv, k, v, start, pos_new=pos)
        method = ctx.get("method", "full")
        qcfg = ctx["qcfg"]
        budget = sel_mod.resolve_budget(qcfg, kv.capacity) \
            if method != "full" else 0
        if method == "full" or kv.capacity <= budget + t:
            att = attention_with_positions(q, kv.k, kv.v, pos, kv.pos,
                                           causal=True, window=self.window)
            if ctx.get("obs"):
                ctx["_obs"] = plan_mod.dense_obs(kv.pos, start)
        elif plan_mod.fused_route(qcfg, method, kv.k, window=self.window):
            # the chunk's KV was just written into the cache, so the kernel
            # reads it from there rather than from a [budget | chunk] concat
            att, plan = plan_mod.fused_attend_with_ctx(
                ctx, plan, method, q, kv.k, kv.v, kv.pos, start, qcfg,
                budget=budget, q_valid=pos >= 0)
        else:
            sel, plan = plan_mod.select_with_ctx(
                ctx, plan, method, q, kv.k, kv.v, kv.pos, start, qcfg,
                budget=budget, q_valid=pos >= 0)
            att = self._selected_attention(q, k, v, pos, sel)
        return x + linear(self.wo, att.reshape(b, t, -1)), plan

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
    latent space and the values decompressed by ``W_uv`` after it."""

    def __init__(self, cfg: ModelConfig, device, kind: str = "mla"):
        super().__init__()
        if kind not in ("mla", "mla_moe"):
            raise NotImplementedError(f"block kind {kind!r} is not yet ported")
        self.cfg = cfg
        self.kind = kind
        m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
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

    def init_cache(self, batch: int, cap: int) -> LatentCache:
        m = self.cfg.mla
        return latent_init(batch, cap, m.kv_lora_rank, m.qk_rope_dim,
                           self.cfg.compute_dtype, self.wq_a.device)

    # ---- projections ----
    def _queries(self, h, pos):
        """(q_abs (b, t, H, r), q_rope (b, t, H, rope))."""
        cfg, m = self.cfg, self.cfg.mla
        b, t, _ = h.shape
        cq = rmsnorm(self.q_ln, linear(self.wq_a, h), cfg.norm_eps)
        q = linear(self.wq_b, cq).reshape(b, t, cfg.n_heads,
                                          m.qk_nope_dim + m.qk_rope_dim)
        q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
        q_rope = rope(q_rope, pos, cfg.rope_theta)
        q_abs = torch.einsum("bthn,rhn->bthr", q_nope,
                             self.wk_b.to(q_nope.dtype))
        return q_abs, q_rope

    def _latent_kv(self, h, pos):
        """(ckv (b, t, r) normalised latent, kr (b, t, rope) rope'd key)."""
        cfg, m = self.cfg, self.cfg.mla
        kv = linear(self.wkv_a, h)
        ckv = rmsnorm(self.kv_ln, kv[..., :m.kv_lora_rank], cfg.norm_eps)
        kr = rope(kv[:, :, None, m.kv_lora_rank:], pos,
                  cfg.rope_theta)[:, :, 0, :]
        return ckv, kr

    def _decompress(self, o_lat, dtype):
        """Latent attention output (b, t, H, r) -> (b, t, H * v) via W_uv,
        in fp32 as the reference."""
        b, t = o_lat.shape[:2]
        out = torch.einsum("bthr,rhv->bthv", o_lat.float(),
                           self.wv_b.float())
        return out.reshape(b, t, -1).to(dtype)

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
        h = rmsnorm(self.ln1, x, self.cfg.norm_eps)
        q_abs, q_rope = self._queries(h, pos)
        ckv, kr = self._latent_kv(h, pos)
        att = self._absorbed_full(q_abs, q_rope, ckv, kr, pos, pos)
        return _ffn_aux(self, x + linear(self.wo, att))

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
        b, cap = cache.latent.shape[:2]
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
        h = rmsnorm(self.ln1, x, cfg.norm_eps)
        q_abs, q_rope = self._queries(h, pos)
        ckv, kr = self._latent_kv(h, pos)
        start = ctx["slot"]
        latent_write(lat, ckv, kr, start, pos_new=pos)
        method = ctx.get("method", "full")
        budget = sel_mod.resolve_budget(ctx["qcfg"], lat.capacity) \
            if method != "full" else 0
        if method == "full" or lat.capacity <= budget + x.shape[1]:
            att = self._absorbed_full(q_abs, q_rope, lat.ckv, lat.krope,
                                      pos, lat.pos)
            if ctx.get("obs"):
                ctx["_obs"] = plan_mod.dense_obs(lat.pos, start)
        else:
            att, plan = self._selected_attention(q_abs, q_rope, ckv, kr, pos,
                                                 lat, start, ctx, plan)
        x = x + linear(self.wo, att)
        return _ffn(self, x), plan

    def _selected_attention(self, q_abs, q_rope, ckv_chunk, kr_chunk, pos,
                            lat: LatentCache, start, ctx, plan=None):
        """QUOKA (or a baseline) on the compressed latent: one shared "KV
        head" per token, scored by the absorbed per-head queries, so
        pre-aggregation runs over all heads (n_kv == 1).  Then flash over
        ``[selected | chunk]``: queries and keys are ``[absorbed | rope]``
        vectors, the values the latent itself (its first ``r`` key
        columns, no copy), where the reference pads it with zeros to the
        key width and slices the output: the same numbers."""
        qc = ctx["qcfg"]
        method = ctx.get("method", "quoka")
        r = lat.rank
        keys = lat.latent[:, :, None, :]                        # (b,T,1,r+rd)
        q_score = torch.cat([q_abs, q_rope], dim=-1)            # (b,t,H,r+rd)
        sel, plan = plan_mod.select_with_ctx(
            ctx, plan, method, q_score, keys, keys, lat.pos, start, qc,
            q_valid=pos >= 0)
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
    block (``ctx["shared"]``) over this layer's own KV cache."""

    def __init__(self, cfg: ModelConfig, device, kind: str = "mamba"):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        self.with_shared = kind == "mamba_shared_attn"
        self.ln = _norm(cfg.d_model, device)
        self.mamba = mamba2.Mamba2(cfg, device)

    def init_cache(self, batch: int, cap: int):
        """A ``MambaCache`` or, with the shared block, a
        ``SharedAttnCache`` that adds a KV cache of ``cap`` slots."""
        cfg, s = self.cfg, self.cfg.ssm
        _, nh, ch = mamba2._dims(cfg)
        dev = self.ln.device
        mc = mamba_cache_init(batch, s.d_conv, ch, nh, s.head_dim, s.d_state,
                              cfg.compute_dtype, dev)
        if not self.with_shared:
            return mc
        return SharedAttnCache(mamba=mc, kv=kv_init(
            batch, cap, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.compute_dtype, dev))

    def plan_carry_shape(self, cache, t: int, method: str, qcfg):
        """A plain Mamba2 layer builds no plan, which turns the carry off
        for any stack that holds one, as in the reference."""
        if not self.with_shared:
            return None
        return _kv_plan_shape(cache.kv, t, method, qcfg)

    def full_forward(self, x, pos, ctx):
        """The full-sequence pass from a zero state (written nowhere), then
        the shared block's full-sequence pass.  Returns (x, aux)."""
        cfg, s = self.cfg, self.cfg.ssm
        _, nh, ch = mamba2._dims(cfg)
        zero = mamba_cache_init(x.shape[0], s.d_conv, ch, nh, s.head_dim,
                                s.d_state, x.dtype, x.device)
        y, _ = mamba2.mamba_apply(self.mamba, rmsnorm(self.ln, x,
                                                      cfg.norm_eps),
                                  zero, cfg)
        x = x + y
        if self.with_shared:
            return ctx["shared"].full_forward(x, pos, ctx)
        return x, 0.0

    def apply(self, x, pos, cache, ctx, plan=None):
        mc = cache.mamba if self.with_shared else cache
        y, new = mamba2.mamba_apply(
            self.mamba, rmsnorm(self.ln, x, self.cfg.norm_eps), mc, self.cfg)
        state_write(mc, new)
        x = x + y
        if self.with_shared:
            x, plan = ctx["shared"].apply(x, pos, cache.kv, ctx, plan=plan)
        return x, plan


class RWKVBlock(nn.Module):
    """``x + time_mix(norm1(x))``, then ``x + channel_mix(norm2(x))``."""

    def __init__(self, cfg: ModelConfig, device, kind: str = "rwkv"):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        self.ln1 = _norm(cfg.d_model, device)
        self.ln2 = _norm(cfg.d_model, device)
        self.tm = rwkv6.TimeMix(cfg, device)
        self.cm = rwkv6.ChannelMix(cfg, device)

    def init_cache(self, batch: int, cap: int) -> RWKVCache:
        cfg = self.cfg
        hd = cfg.rwkv.head_dim
        return rwkv_cache_init(batch, cfg.d_model, cfg.d_model // hd, hd,
                               cfg.compute_dtype, self.ln1.device)

    def plan_carry_shape(self, cache, t: int, method: str, qcfg):
        return None

    def _run(self, x, cache: RWKVCache):
        """Both mixes over the segment from ``cache``'s state (read, not
        written).  Returns (x, the new ``RWKVCache``)."""
        cfg = self.cfg
        y, sh_tm, wkv = rwkv6.time_mix(self.tm, rmsnorm(self.ln1, x,
                                                        cfg.norm_eps),
                                       cache.shift_tm, cache.wkv, cfg)
        x = x + y
        y, sh_cm = rwkv6.channel_mix(self.cm, rmsnorm(self.ln2, x,
                                                      cfg.norm_eps),
                                     cache.shift_cm)
        return x + y, RWKVCache(shift_tm=sh_tm, shift_cm=sh_cm, wkv=wkv)

    def full_forward(self, x, pos, ctx=None):
        """The full-sequence pass from a zero state (written nowhere).
        Returns (x, 0.0)."""
        cfg = self.cfg
        hd = cfg.rwkv.head_dim
        zero = rwkv_cache_init(x.shape[0], cfg.d_model, cfg.d_model // hd,
                               hd, x.dtype, x.device)
        return self._run(x, zero)[0], 0.0

    def apply(self, x, pos, cache: RWKVCache, ctx, plan=None):
        x, new = self._run(x, cache)
        state_write(cache, new)
        return x, plan


class DecCrossBlock(nn.Module):
    """Whisper's decoder layer (kind ``"dec_cross"``), in the reference's
    order: causal self-attention with its residual (``self_attn``, an
    ``AttnBlock`` whose MLP runs last), cross-attention with its residual
    (queries from ``ln_x``; ``xq``, ``xk``, ``xv``, ``xo`` carry no bias;
    plain dense attention over the encoder's keys with no mask, as the
    reference's ``_cross``), then ``self_attn``'s MLP on ``self_attn``'s
    ``ln2`` of the post-cross stream."""

    def __init__(self, cfg: ModelConfig, device, kind: str = "dec_cross"):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        d, hd = cfg.d_model, cfg.resolved_head_dim
        w = _weight(cfg.compute_dtype, device)
        self.self_attn = AttnBlock(cfg, device, "attn")
        _norm_params(self, ("ln_x",), cfg, device)
        self.xq = w(d, cfg.n_heads * hd)
        self.xk = w(d, cfg.n_kv_heads * hd)
        self.xv = w(d, cfg.n_kv_heads * hd)
        self.xo = w(cfg.n_heads * hd, d)

    def init_cache(self, batch: int, cap: int) -> CrossCache:
        """The self-attention's ``cap``-slot KV cache and an empty
        ``CrossKV`` of ``encoder.n_ctx`` rows (``Model._build_cross``
        fills it)."""
        cfg = self.cfg
        return CrossCache(
            kv=self.self_attn.init_cache(batch, cap),
            cross=cross_init(batch, cfg.encoder.n_ctx, cfg.n_kv_heads,
                             cfg.resolved_head_dim, cfg.compute_dtype,
                             self.xq.device))

    def build_cross(self, enc_out) -> CrossKV:
        """The cross-attention keys and values of the encoder's output
        (b, n_ctx, d)."""
        cfg = self.cfg
        b, s, _ = enc_out.shape
        hd = cfg.resolved_head_dim
        return CrossKV(
            k=linear(self.xk, enc_out).reshape(b, s, cfg.n_kv_heads, hd),
            v=linear(self.xv, enc_out).reshape(b, s, cfg.n_kv_heads, hd))

    def _cross(self, x, cross: CrossKV):
        cfg = self.cfg
        b, t, _ = x.shape
        h = _block_norm(self, "ln_x", x)
        q = linear(self.xq, h).reshape(b, t, cfg.n_heads,
                                       cfg.resolved_head_dim)
        att = dense_attention(q, cross.k, cross.v)          # non-causal
        return x + linear(self.xo, att.reshape(b, t, -1))

    def plan_carry_shape(self, cache: CrossCache, t: int, method: str,
                         qcfg):
        return self.self_attn.plan_carry_shape(cache.kv, t, method, qcfg)

    def full_forward(self, x, pos, ctx):
        """The full-sequence pass: causal self-attention over the sequence,
        cross-attention over the keys and values of ``ctx["enc_out"]``,
        then the MLP.  Returns (x, 0.0)."""
        x = self.self_attn._self_attend(x, pos)
        x = self._cross(x, self.build_cross(ctx["enc_out"]))
        return _ffn(self.self_attn, x), 0.0

    def apply(self, x, pos, cache: CrossCache, ctx, plan=None):
        x, plan = self.self_attn._attend(x, pos, cache.kv, ctx, plan)
        x = self._cross(x, cache.cross)
        return _ffn(self.self_attn, x), plan


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
