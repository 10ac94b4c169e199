"""Kernel facade (counterpart of ``repro/kernels/ops.py``).

Every attention and scoring call of the port goes through the three entry
points here, in the reference's BTHD signatures.  Dispatch is by the
tensor's device: on the CPU each wrapper runs its plain PyTorch version,
on a CUDA device it launches its hand-written kernel or raises.  There is
no backend switch.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.flash_attention import flash_attention_bhtd
from repro_torch.kernels.quoka_score import quoka_score_bhtd
from repro_torch.kernels.selected_attention import selected_attention_bhtd


def attention(q, k, v, k_valid=None, *, causal: bool = True,
              boundary: int = 0, scale: Optional[float] = None):
    """Post-selection attention over a [selected budget | chunk] layout.

    q: (b, tq, h, d); k, v: (b, tk, h_kv, d); k_valid: bool (b, tk) or
    (b, h_kv, tk).  The first ``boundary`` keys are an unconditioned prefix;
    the rest are causal in chunk-local indices.  Returns (b, tq, h, d)."""
    out = flash_attention_bhtd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), k_valid, causal=causal,
                               boundary=boundary, scale=scale)
    return out.transpose(1, 2)


def selected_attention(q, k, v, key_pos, plan_idx, chunk_start, *,
                       granularity: int = 1, scale: Optional[float] = None):
    """Gather-free twin of ``plan.materialize`` + ``attention`` over a linear
    cache view.  q: (b, t, h, d); k, v: (b, T, n_kv, d); key_pos (b, T);
    plan_idx: (b, B//g) block ids at g > 1, (b, n_kv, B) token slots at
    g == 1; chunk_start: () or (b,).  Returns (b, t, h, d)."""
    out = selected_attention_bhtd(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), key_pos, plan_idx,
                                  chunk_start, granularity=granularity,
                                  scale=scale)
    return out.transpose(1, 2)


def score(qbar, k, valid, *, proj_dim: int = 0):
    """Fused QUOKA scoring (Algorithm 1 lines 7-10).

    qbar: (b, n_q, n_kv, d) pre-aggregated normalised queries; k:
    (b, T, n_kv, d) raw keys; valid (b, T).  Returns fp32 (b, n_kv, T) with
    NEG_INF on invalid slots.  ``proj_dim`` > 0 (low-rank scoring) is not
    yet ported: its projection is drawn by ``jax.random`` in the reference.
    """
    if proj_dim and proj_dim < qbar.shape[-1]:
        raise NotImplementedError(
            "score_proj_dim > 0 is not yet ported (its projection comes from "
            "jax.random in the reference)")
    return quoka_score_bhtd(qbar.transpose(1, 2), k.transpose(1, 2), valid)
