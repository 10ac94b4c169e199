"""Plain PyTorch versions of the four hand-written kernels.

They are the reference package's production oracles written again in
torch: ``flash_attention_ref`` (``repro/kernels/ref.py``), ``score_ref``
(``repro/kernels/ops.py::_score_xla``), ``selected_ref``
(``repro/kernels/ops.py::_selected_xla``) and ``selected_paged_ref``
(``_linearize_pool`` + ``_selected_xla``).  The kernel wrappers call them
for CPU tensors, the CPU tests hold them to the JAX package, and
``chip_smoke.py`` holds each CUDA kernel to them on the card.

Layouts follow the reference: the attention and score oracles are BHTD
(kernel-native), ``selected_ref`` and ``selected_paged_ref`` are BTHD like
``_selected_xla``.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, boundary: int = 0,
                        k_valid: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None):
    """q: (b, h, tq, d); k: (b, h_kv, tk, d); v: (b, h_kv, tk, dv), dv <= d
    (the output is dv wide: the softmax of q·kᵀ over d columns, times V);
    k_valid: bool (b, tk) or (b, h_kv, tk).  attend(i, j) iff k_valid[j]
    and (not causal or j < boundary or j - boundary <= i).  Fully-masked
    rows give zeros."""
    b, h, tq, d = q.shape
    h_kv, tk = k.shape[1], k.shape[2]
    g = h // h_kv
    scale = (d ** -0.5) if scale is None else scale
    kr = k.repeat_interleave(g, dim=1)
    vr = v.repeat_interleave(g, dim=1)
    logits = torch.einsum("bhtd,bhsd->bhts", q.float(), kr.float()) * scale
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        i = torch.arange(tq, device=q.device)[:, None]
        j = torch.arange(tk, device=q.device)[None, :]
        mask = (j < boundary) | ((j - boundary) <= i)
    mask = mask[None, None]
    if k_valid is not None:
        if k_valid.ndim == 2:
            kv_mask = k_valid[:, None, None, :]
        else:
            kv_mask = k_valid.repeat_interleave(g, dim=1)[:, :, None, :]
        mask = mask & kv_mask
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    p = torch.where(mask.any(-1, keepdim=True), p, torch.zeros_like(p))
    return torch.einsum("bhts,bhsd->bhtd", p, vr.float()).to(q.dtype)


def score_ref(qbar, k, valid):
    """Fused QUOKA scoring, BHTD: qbar (b, n_kv, n_q, d) normalised
    pre-aggregated queries, k (b, n_kv, T, d) raw keys, valid (b, T) bool.
    Returns fp32 (b, n_kv, T): max over n_q of q̄·k / sqrt(Σk² + 1e-16),
    NEG_INF where invalid.  As in the reference, q̄ is first rounded to
    k's dtype and the products accumulate in fp32."""
    kf = k.float()
    s = torch.einsum("bknd,bktd->bknt", qbar.to(k.dtype).float(), kf)
    inv = torch.rsqrt((kf * kf).sum(-1) + 1e-16)                  # (b,n_kv,T)
    s = (s * inv[:, :, None, :]).amax(dim=2)
    return torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))


def selected_ref(q, k, v, key_pos, plan_idx, chunk_start, g: int,
                 scale: Optional[float] = None):
    """Attention of chunk queries over [plan-selected KV | causal chunk]
    read from a linear cache, BTHD: q (b, t, h, d); k, v (b, T, n_kv, d);
    key_pos (b, T); plan_idx (b, B//g) block ids at g > 1 or (b, n_kv, B)
    token slots at g == 1 (-1 = padding); chunk_start () or (b,).  The
    plan is materialized with a gather (this is the oracle; the kernel
    reads the cache in place)."""
    b, T, n_kv, d = k.shape
    t = q.shape[1]
    dev = k.device
    start = torch.as_tensor(chunk_start, dtype=torch.int32, device=dev)
    if start.ndim == 0:
        start = start.expand(b)
    valid = (key_pos >= 0) & (key_pos < start[:, None])           # (b, T)
    idx = plan_idx.to(torch.int64)
    if g == 1:
        if idx.ndim == 2:
            idx = idx[:, None, :].expand(b, n_kv, idx.shape[1])
        safe = idx.clamp(min=0)                                    # (b,n_kv,B)
        gi = safe.transpose(1, 2)[..., None].expand(-1, -1, -1, d)
        k_sel = torch.gather(k, 1, gi)
        v_sel = torch.gather(v, 1, gi)
        pos = torch.gather(key_pos[:, None, :].expand(b, n_kv, T), 2, safe)
        ok = torch.gather(valid[:, None, :].expand(b, n_kv, T), 2, safe)
        sel_valid = (idx >= 0) & ok & (pos >= 0)
    else:
        if idx.ndim == 3:
            idx = idx[:, 0]
        nb = idx.shape[1]
        blocks = idx.clamp(min=0)
        gi = blocks[:, :, None, None, None].expand(-1, -1, g, n_kv, d)
        k_sel = torch.gather(k.reshape(b, T // g, g, n_kv, d), 1,
                             gi).reshape(b, nb * g, n_kv, d)
        v_sel = torch.gather(v.reshape(b, T // g, g, n_kv, d), 1,
                             gi).reshape(b, nb * g, n_kv, d)
        ok_sel = torch.gather(valid.reshape(b, T // g, g), 1,
                              blocks[:, :, None].expand(-1, -1, g))
        good = (ok_sel & (idx >= 0)[:, :, None]).reshape(b, nb * g)
        sel_valid = good[:, None, :].expand(b, n_kv, nb * g)
    boundary = k_sel.shape[1]
    # chunk rows are contiguous in the cache at [start, start + t), clamped
    # like a dynamic slice so start <= T - t
    s0 = start.clamp(max=T - t).to(torch.int64)
    rows = s0[:, None] + torch.arange(t, device=dev)              # (b, t)
    ri = rows[:, :, None, None].expand(-1, -1, n_kv, d)
    k_chunk = torch.gather(k, 1, ri)
    v_chunk = torch.gather(v, 1, ri)
    cpos = torch.gather(key_pos, 1, rows)
    chunk_valid = (cpos >= 0)[:, None, :].expand(b, n_kv, t)
    k_valid = torch.cat([sel_valid, chunk_valid], dim=-1)
    out = flash_attention_ref(
        q.transpose(1, 2),
        torch.cat([k_sel, k_chunk], dim=1).transpose(1, 2),
        torch.cat([v_sel, v_chunk], dim=1).transpose(1, 2),
        causal=True, boundary=boundary, k_valid=k_valid, scale=scale)
    return out.transpose(1, 2)


def linearize_pool(k_pool, v_pool, pos_pool, table):
    """Paged pool leaves -> per-request linear view (the reference's
    ``ops.py::_linearize_pool``).  k_pool, v_pool (N, bs, n_kv, d);
    pos_pool (N, bs); table (b, nb) physical block ids, -1 = unmapped.
    Unmapped entries read as an empty block: pos -1 and zero K/V (the
    reference reads block 0's K/V there; the position mask hides it either
    way, as it does in ``serving/pool.py::gather``)."""
    b, nb = table.shape
    bs, n_kv, d = k_pool.shape[1:]
    table = table.to(device=k_pool.device, dtype=torch.int64)
    mapped = table >= 0
    safe = table.clamp(min=0)
    hole = ~mapped[:, :, None, None, None]
    k_lin = k_pool[safe].masked_fill(hole, 0)
    v_lin = v_pool[safe].masked_fill(hole, 0)
    pos_lin = pos_pool[safe].to(torch.int32).masked_fill(~mapped[:, :, None],
                                                         -1)
    return (k_lin.reshape(b, nb * bs, n_kv, d),
            v_lin.reshape(b, nb * bs, n_kv, d), pos_lin.reshape(b, nb * bs))


def selected_paged_ref(q, k_pool, v_pool, pos_pool, plan_idx, chunk_start,
                       table, g: int, scale: Optional[float] = None):
    """``selected_ref`` read through a paged pool's block table, BTHD:
    q (b, t, h, d); pool leaves as in ``linearize_pool``; plan ids and the
    chunk start on the LOGICAL grid (the request's blocks in table
    order).  The pool is linearized with a gather first (this is the
    oracle; the kernel reads the pool blocks in place)."""
    k, v, key_pos = linearize_pool(k_pool, v_pool, pos_pool, table)
    return selected_ref(q, k, v, key_pos, plan_idx, chunk_start, g, scale)
