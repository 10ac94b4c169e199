"""Fused QUOKA scoring kernel wrapper (counterpart of
``repro/kernels/quoka_score.py``; CUDA source ``csrc/quoka_score.cu``).

For a CPU tensor the wrapper runs the plain version (``ref.score_ref``);
for a CUDA tensor it launches the kernel or raises.  ``LAUNCHES`` counts
kernel launches.  The kernel rounds q̄ to k's dtype itself, so a call
launches nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref, tiling

LAUNCHES = 0


def quoka_score_bhtd(qbar, k, valid):
    """qbar: (b, n_kv, n_q, d) pre-aggregated normalised queries, fp32
    (any strides); k: (b, n_kv, T, d) raw keys (any strides with a
    contiguous head dim and 16-byte aligned rows; d a multiple of 8 up to
    576, staged at the next multiple of 16 with the columns past d
    zero-filled: ``tiling.score_width``); valid: (b, T) bool.  Returns
    fp32 scores (b, n_kv, T)."""
    global LAUNCHES
    if k.device.type == "cpu":
        return ref.score_ref(qbar, k, valid)
    if k.device.type != "cuda":
        raise RuntimeError(f"quoka_score: no kernel for device {k.device}")
    b, n_kv, n_q, d = qbar.shape
    T = k.shape[2]
    if k.shape != (b, n_kv, T, d) or valid.shape != (b, T):
        raise ValueError(f"quoka_score: shapes qbar {tuple(qbar.shape)} "
                         f"k {tuple(k.shape)} valid {tuple(valid.shape)}")
    if valid.dtype != torch.bool:
        raise TypeError("quoka_score: valid must be bool")
    if qbar.dtype != torch.float32:
        raise TypeError(f"quoka_score: qbar must be float32, got "
                        f"{qbar.dtype}")
    if not (qbar.device == k.device == valid.device):
        raise ValueError("quoka_score: tensors on different devices")
    geom = tiling.score_geometry(b, n_kv, n_q, T, d, k.element_size(),
                                 tiling.sm_count(k.device.index))
    if k.stride(-1) != 1:
        raise ValueError("quoka_score: k needs a contiguous head dim")
    if k.data_ptr() % 16 or any(s * k.element_size() % 16
                                for s in k.stride()[:-1]):
        raise ValueError(f"quoka_score: k rows must be 16-byte aligned "
                         f"(strides {tuple(k.stride())})")
    out = torch.empty((b, n_kv, T), dtype=torch.float32, device=k.device)
    lib = build.library()
    rc = lib.quoka_score_launch(
        build.dtype_code(k.dtype), d, qbar.data_ptr(), k.data_ptr(),
        valid.data_ptr(), out.data_ptr(), b, n_kv, n_q, T, *qbar.stride(),
        *k.stride()[:3], *valid.stride(),
        geom.warps, geom.stages, geom.n_chunks, geom.nq_pad,
        build.stream_ptr(k.device))
    LAUNCHES += 1
    build.check(rc, "quoka_score")
    return out
