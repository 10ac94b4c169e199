"""Kernel facade (counterpart of ``repro/kernels/ops.py``).

Every attention and scoring call of the port goes through the entry points
here, in the reference's BTHD signatures.  Dispatch is by the
tensor's device: on the CPU each wrapper runs its plain PyTorch version,
on a CUDA device it launches its hand-written kernel or raises.  There is
no backend switch.  Each entry point runs under a ``record_function``
range named as the reference's ``jax.named_scope`` label with the port's
backend, the tensor's device type: ``ops_attention_cuda`` on the card,
``ops_attention_cpu`` for the plain version (likewise
``ops_selected_attention_*`` and ``ops_score_*``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention_bhtd
from repro_torch.kernels.quoka_score import quoka_score_bhtd
from repro_torch.kernels.selected_attention import (selected_attention_bhtd,
                                                    selected_attention_paged)


def attention(q, k, v, k_valid=None, *, causal: bool = True,
              boundary: int = 0, scale: Optional[float] = None):
    """Post-selection attention over a [selected budget | chunk] layout.

    q: (b, tq, h, d); k: (b, tk, h_kv, d); v: (b, tk, h_kv, dv) with
    dv <= d (MLA's latent values beside its [latent | rope] keys; equal
    widths otherwise); k_valid: bool (b, tk) or (b, h_kv, tk).  The first
    ``boundary`` keys are an unconditioned prefix; the rest are causal in
    chunk-local indices.  Returns (b, tq, h, dv)."""
    with torch.profiler.record_function(f"ops_attention_{q.device.type}"):
        out = flash_attention_bhtd(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), k_valid,
                                   causal=causal, boundary=boundary,
                                   scale=scale)
        return out.transpose(1, 2)


def selected_attention(q, k, v, key_pos, plan_idx, chunk_start, *,
                       granularity: int = 1, scale: Optional[float] = None,
                       table=None, block_size: int = 0):
    """Gather-free twin of ``plan.materialize`` + ``attention``.

    q: (b, t, h, d) chunk queries.
    Linear cache view (default): k, v (b, T, n_kv, d); key_pos (b, T).
    Paged pool view (``table`` given): k, v (N, block_size, n_kv, d) pool
      leaves, key_pos (N, block_size), table (b, nb_logical) with -1 =
      unmapped: the kernel attends THROUGH the block table.
    plan_idx: (b, B//g) block ids at g > 1, (b, n_kv, B) token slots at
    g == 1 (on the logical grid for the paged view); chunk_start: () or
    (b,).  Returns (b, t, h, d)."""
    with torch.profiler.record_function(
            f"ops_selected_attention_{q.device.type}"):
        if table is not None:
            out = selected_attention_paged(
                q.transpose(1, 2), k, v, key_pos, plan_idx, chunk_start,
                table, granularity=granularity, block_size=block_size,
                scale=scale)
        else:
            out = selected_attention_bhtd(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                key_pos, plan_idx, chunk_start, granularity=granularity,
                scale=scale)
        return out.transpose(1, 2)


_PROJ_SEED = 7
_PROJ: Dict[Tuple[int, int], torch.Tensor] = {}      # (d, r) -> fp32 CPU
_PROJ_ON: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}


def score_projection(d: int, r: int, device="cpu") -> torch.Tensor:
    """Cached low-rank scoring projection (d, r), fp32, on ``device``.

    A fixed JL-style random projection stands in for Loki's offline PCA
    and serves the ``score_proj_dim`` mode.  It is drawn once per (d, r) on
    the CPU from a ``torch.Generator`` seeded 7, scaled by 1/sqrt(r), so
    every device sees the same numbers; the reference draws its own from
    ``jax.random``, which torch cannot reproduce (``training/checkpoint.py::
    load_score_projection`` installs the reference's array instead)."""
    dev = torch.device(device)
    key = (d, r, dev)
    proj = _PROJ_ON.get(key)
    if proj is None:
        base = _PROJ.get((d, r))
        if base is None:
            gen = torch.Generator().manual_seed(_PROJ_SEED)
            base = torch.randn((d, r), generator=gen) / math.sqrt(r)
            _PROJ[(d, r)] = base
        proj = _PROJ_ON[key] = base.to(dev)
    return proj


def set_score_projection(d: int, r: int, proj: torch.Tensor) -> None:
    """Replace the cached (d, r) projection on every device."""
    if tuple(proj.shape) != (d, r):
        raise ValueError(f"score projection shape {tuple(proj.shape)} != "
                         f"{(d, r)}")
    _PROJ[(d, r)] = proj.detach().to("cpu", torch.float32).clone()
    for key in [key for key in _PROJ_ON if key[:2] == (d, r)]:
        del _PROJ_ON[key]


def score(qbar, k, valid, *, proj: Optional[torch.Tensor] = None):
    """Fused QUOKA scoring (Algorithm 1 lines 7-10).

    qbar: (b, n_q, n_kv, d) pre-aggregated normalised queries; k:
    (b, T, n_kv, d) raw keys; valid (b, T).  Returns fp32 (b, n_kv, T) with
    NEG_INF on invalid slots.  ``proj`` (d, r) projects both operands first
    (``score_proj_dim``): q̄ in fp32, K in its storage dtype (a plain
    product, no fp32 copy of the cache); the unchanged kernel then runs at
    head dim r, so scores are cosines in the projected space.  On the card
    r must be a multiple of 8 up to 576 (``tiling.score_width``).
    """
    with torch.profiler.record_function(f"ops_score_{k.device.type}"):
        if proj is not None:
            qbar = qbar.float() @ proj
            k = k @ proj.to(k.dtype)
        return quoka_score_bhtd(qbar.transpose(1, 2), k.transpose(1, 2),
                                valid)
