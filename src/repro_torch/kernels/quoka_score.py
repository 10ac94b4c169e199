"""Fused QUOKA scoring kernel wrapper (counterpart of
``repro/kernels/quoka_score.py``; CUDA source ``csrc/quoka_score.cu``).

For a CPU tensor the wrapper runs the plain version (``ref.score_ref``);
for a CUDA tensor it launches the kernel or raises.  ``LAUNCHES`` counts
kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

LAUNCHES = 0
HEAD_DIMS = (64, 128)


def quoka_score_bhtd(qbar, k, valid):
    """qbar: (b, n_kv, n_q, d) pre-aggregated normalised queries; k:
    (b, n_kv, T, d) raw keys (any strides with a contiguous head dim);
    valid: (b, T) bool.  Returns fp32 scores (b, n_kv, T)."""
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
    if d not in HEAD_DIMS:
        raise ValueError(f"quoka_score: head dim {d} not in {HEAD_DIMS}")
    if n_q * d * 4 > 48 * 1024:
        raise ValueError(f"quoka_score: n_q={n_q} queries do not fit in "
                         "shared memory")
    if valid.dtype != torch.bool:
        raise TypeError("quoka_score: valid must be bool")
    if not (qbar.device == k.device == valid.device):
        raise ValueError("quoka_score: tensors on different devices")
    qbar = qbar.to(k.dtype)       # the reference rounds q̄ to k's dtype
    if qbar.stride(-1) != 1:
        qbar = qbar.contiguous()
    if k.stride(-1) != 1:
        raise ValueError("quoka_score: k needs a contiguous head dim")
    if valid.stride(-1) != 1:
        valid = valid.contiguous()
    out = torch.empty((b, n_kv, T), dtype=torch.float32, device=k.device)
    lib = build.library()
    rc = lib.quoka_score_launch(
        build.dtype_code(k.dtype), d, qbar.data_ptr(), k.data_ptr(),
        valid.data_ptr(), out.data_ptr(), b, n_kv, n_q, T,
        *qbar.stride()[:3], *k.stride()[:3], valid.stride(0),
        build.stream_ptr(k.device))
    LAUNCHES += 1
    build.check(rc, "quoka_score")
    return out
