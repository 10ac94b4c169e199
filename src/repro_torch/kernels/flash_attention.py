"""Flash attention kernel wrapper (counterpart of
``repro/kernels/flash_attention.py``; CUDA source ``csrc/flash_attention.cu``).

Mask: attend(i, j) iff k_valid[j] and (not causal or j < boundary or
j - boundary <= i); fully-masked rows give zeros.  For a CPU tensor the
wrapper runs the plain version (``ref.flash_attention_ref``); for a CUDA
tensor it launches the kernel or raises.  ``LAUNCHES`` counts launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref

LAUNCHES = 0
HEAD_DIMS = (64, 128)


def flash_attention_bhtd(q, k, v, k_valid=None, *, causal: bool = True,
                         boundary: int = 0, scale: Optional[float] = None):
    """q: (b, h, tq, d); k, v: (b, h_kv, tk, d) (any strides with a
    contiguous head dim); k_valid: bool (b, tk) or (b, h_kv, tk).
    Returns (b, h, tq, d) in q's dtype."""
    global LAUNCHES
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       boundary=boundary, k_valid=k_valid,
                                       scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    b, h, tq, d = q.shape
    h_kv, tk = k.shape[1], k.shape[2]
    if k.shape != (b, h_kv, tk, d) or v.shape != k.shape or h % h_kv:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k, v must share a dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: tensors on different devices")
    if k_valid is None:
        k_valid = torch.ones((b, 1, tk), dtype=torch.bool, device=q.device)
    if k_valid.dtype != torch.bool or k_valid.device != q.device:
        raise TypeError("flash_attention: k_valid must be bool on q's device")
    if k_valid.ndim == 2:
        k_valid = k_valid[:, None, :]
    if k_valid.shape not in ((b, 1, tk), (b, h_kv, tk)):
        raise ValueError(f"flash_attention: k_valid {tuple(k_valid.shape)}")
    if k_valid.stride(-1) != 1:
        k_valid = k_valid.contiguous()
    sva_h = 0 if k_valid.shape[1] == 1 else k_valid.stride(1)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} needs a contiguous "
                             "head dim")
    scale = (d ** -0.5) if scale is None else scale
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    o = out.transpose(1, 2)                     # BHTD view of BTHD storage
    lib = build.library()
    rc = lib.flash_attention_launch(
        build.dtype_code(q.dtype), d, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), k_valid.data_ptr(), o.data_ptr(), b, h, h_kv, tq, tk,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        k_valid.stride(0), sva_h, *o.stride()[:3], int(causal),
        int(boundary), float(scale), build.stream_ptr(q.device))
    LAUNCHES += 1
    build.check(rc, "flash_attention")
    return o
