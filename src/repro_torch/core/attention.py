"""Dense (masked) GQA attention in plain PyTorch (counterpart of
``repro/core/attention.py``).

Used by the dense bypass (cache capacity <= budget + chunk) and by
``method="full"``; the reference has no Pallas kernel here either.  Layout
is BTHD; masks derive from absolute positions (-1 = empty slot).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
BLOCKED_THRESHOLD = 2048   # online-softmax streaming above this many keys
BLOCK_K = 1024


def position_mask(q_pos, k_pos, *, causal: bool = True,
                  window: Optional[int] = None):
    """q_pos (b, tq), k_pos (b, tk) -> bool (b, 1, tq, tk), True = attend."""
    q = q_pos[:, :, None]
    k = k_pos[:, None, :]
    m = k >= 0
    if causal:
        m = m & (k <= q)
    if window is not None:
        m = m & (k > q - window)
    return m[:, None, :, :]


def dense_attention(q, k, v, mask=None, *, scale: Optional[float] = None):
    """Masked softmax attention with flat-head GQA (kv repeated to n_q
    heads).  q (b, tq, n_q, d); k, v (b, tk, n_kv, d); mask bool
    (b, H, tq, tk) with H in {1, n_kv, n_q}.  Logits in fp32, probabilities
    cast to v's dtype; fully-masked rows give zeros."""
    b, tq, n_q, d = q.shape
    n_kv = k.shape[2]
    group = n_q // n_kv
    scale = (d ** -0.5) if scale is None else scale
    kr = k.repeat_interleave(group, dim=2) if group > 1 else k
    vr = v.repeat_interleave(group, dim=2) if group > 1 else v
    logits = torch.einsum("bthd,bshd->bhts", q.float(), kr.float()) * scale
    if mask is not None:
        h = mask.shape[1]
        if h == n_kv and n_kv not in (1, n_q):
            mask = mask.repeat_interleave(group, dim=1)
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    if mask is not None:
        probs = torch.where(mask.any(-1, keepdim=True), probs,
                            torch.zeros_like(probs))
    return torch.einsum("bhts,bshd->bthd", probs.to(vr.dtype), vr)


def blocked_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                      window: Optional[int] = None,
                      scale: Optional[float] = None, block_k: int = BLOCK_K):
    """Online-softmax attention over key blocks (the score matrix is never
    materialised in full).  Same semantics as ``dense_attention`` with a
    position mask; accumulates in fp32."""
    b, tq, n_q, d = q.shape
    tk, n_kv = k.shape[1], k.shape[2]
    group = n_q // n_kv
    scale = (d ** -0.5) if scale is None else scale
    block_k = min(block_k, tk)
    qf = q.float() * scale
    m = torch.full((b, n_q, tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, n_q, tq, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for s in range(0, tk, block_k):
        kb, vb, pb = k[:, s:s + block_k], v[:, s:s + block_k], \
            k_pos[:, s:s + block_k]
        if group > 1:
            kb = kb.repeat_interleave(group, dim=2)
            vb = vb.repeat_interleave(group, dim=2)
        sc = torch.einsum("bthd,bshd->bhts", qf, kb.float())
        mask = position_mask(q_pos, pb, causal=causal, window=window)
        sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.where(mask, torch.exp(sc - m_new[..., None]),
                        torch.zeros_like(sc))
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhts,bshd->bhtd", p,
                                                    vb.float())
        m = m_new
    safe = torch.where(l > 0, l, torch.ones_like(l))
    out = torch.where((l > 0)[..., None], acc / safe[..., None],
                      torch.zeros_like(acc))
    return out.transpose(1, 2).to(q.dtype)


def attention_with_positions(q, k, v, q_pos, k_pos, *, causal: bool = True,
                             window: Optional[int] = None):
    if k.shape[1] > BLOCKED_THRESHOLD:
        return blocked_attention(q, k, v, q_pos, k_pos, causal=causal,
                                 window=window)
    mask = position_mask(q_pos, k_pos, causal=causal, window=window)
    return dense_attention(q, k, v, mask)
