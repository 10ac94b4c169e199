"""GQA attention block, kind ``"attn"`` (counterpart of
``repro/models/blocks.py::AttnBlock``; other block kinds are not ported).

``apply`` runs a prefill chunk or a decode step (t == 1) against the
layer's KV cache along one of three routes, as in the reference:

  * dense bypass  ``method == "full"`` or capacity <= budget + t: plain
                  masked attention over the whole cache (no kernel);
  * fused         block-granular plan with ``fused_select_attn``: scoring
                  kernel, top-k, then the selected-attention kernel reading
                  the cache in place;
  * staged        scoring kernel, top-k, materialize, then the flash kernel
                  over [selected budget | chunk].

``ctx`` (dict): ``method``, ``qcfg`` (QuokaConfig), ``slot`` (the
chunk's cache write slot: an int, or a per-row (b,) tensor under
continuous batching; distinct from positions, since pad slots carry
pos == -1) and, under cross-layer plan reuse, ``layer_idx`` (the global
layer index ``core/plan.py::refresh`` decides on).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import plan as plan_mod
from repro_torch.core import selection as sel_mod
from repro_torch.core.attention import attention_with_positions
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import linear, mlp, rmsnorm, rope
from repro_torch.serving.cache import KVCache, kv_init, kv_write


class AttnBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device, kind: str = "attn"):
        super().__init__()
        if kind != "attn":
            raise NotImplementedError(f"block kind {kind!r} is not yet ported")
        self.cfg = cfg
        self.kind = kind
        d, hd, dt = cfg.d_model, cfg.resolved_head_dim, cfg.compute_dtype

        def w(d_in, d_out):
            return nn.Parameter(torch.empty((d_in, d_out), dtype=dt,
                                            device=device),
                                requires_grad=False)

        def norm():
            return nn.Parameter(torch.ones(d, dtype=torch.float32,
                                           device=device),
                                requires_grad=False)

        self.ln1 = norm()
        self.wq = w(d, cfg.n_heads * hd)
        self.wk = w(d, cfg.n_kv_heads * hd)
        self.wv = w(d, cfg.n_kv_heads * hd)
        self.wo = w(cfg.n_heads * hd, d)
        self.ln2 = norm()
        self.mlp = nn.ParameterDict({"up": w(d, cfg.d_ff),
                                     "down": w(cfg.d_ff, d)})
        if cfg.act != "gelu":
            self.mlp["gate"] = w(d, cfg.d_ff)

    def init_cache(self, batch: int, cap: int) -> KVCache:
        cfg = self.cfg
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
        """Shape of the plan this block would build for a t-token chunk, or
        None when it never selects here (``full``, the dense bypass, a
        cache off the selection grid), which disables the carry."""
        b, cap, n_kv = cache.k.shape[:3]
        budget = sel_mod.resolve_budget(qcfg, cap)
        if method == "full" or cap <= budget + t:
            return None
        if plan_mod.grid(qcfg) > 1 and cap % plan_mod.grid(qcfg):
            return None
        return plan_mod.plan_idx_shape(qcfg, b, n_kv, cap, budget)

    def apply(self, x, pos, kv: KVCache, ctx, plan=None):
        """x (b, t, d), pos (b, t) (-1 = pad); writes the chunk's K/V into
        ``kv`` in place.  ``plan`` is the cross-layer ``PlanCarry`` (None:
        no reuse).  Returns (block output, updated carry); the dense bypass
        leaves the carry as it came."""
        cfg = self.cfg
        b, t, _ = x.shape
        q, k, v = self._qkv(rmsnorm(self.ln1, x, cfg.norm_eps), pos)
        start = ctx["slot"]
        kv_write(kv, k, v, start, pos_new=pos)
        method = ctx.get("method", "full")
        qcfg = ctx["qcfg"]
        budget = sel_mod.resolve_budget(qcfg, kv.capacity) \
            if method != "full" else 0
        if method == "full" or kv.capacity <= budget + t:
            att = attention_with_positions(q, kv.k, kv.v, pos, kv.pos,
                                           causal=True)
        elif plan_mod.fused_route(qcfg, method, kv.k):
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
        x = x + linear(self.wo, att.reshape(b, t, -1))
        h = rmsnorm(self.ln2, x, cfg.norm_eps)
        return x + mlp(self.mlp, h, cfg.act), plan

    def _selected_attention(self, q, k_chunk, v_chunk, pos, sel):
        """Attention over [selected budget | current chunk]: the budget is
        an unconditioned prefix (``boundary``), its padding is masked by a
        per-KV-head ``k_valid`` (sel.pos == -1), chunk pad slots too."""
        b, t = q.shape[:2]
        n_kv = k_chunk.shape[2]
        k_cat = torch.cat([sel.k, k_chunk], dim=1)
        v_cat = torch.cat([sel.v, v_chunk], dim=1)
        chunk_valid = (pos >= 0)[:, None, :].expand(b, n_kv, t)
        k_valid = torch.cat([sel.pos >= 0, chunk_valid], dim=-1)
        return kops.attention(q, k_cat, v_cat, k_valid, causal=True,
                              boundary=sel.pos.shape[-1])


def make_block(cfg: ModelConfig, kind: str, device) -> AttnBlock:
    return AttnBlock(cfg, device, kind)
