"""Gather-free fused selected-attention kernel wrapper (counterpart of
``repro/kernels/selected_attention.py``, linear cache view only; CUDA
source ``csrc/selected_attention.cu``).

The chunk's queries attend over [plan-selected KV | causal chunk] read in
place from the unmaterialized cache; validity is re-derived in the kernel
exactly as ``core/plan.py::materialize`` derives it.  For a CPU tensor the
wrapper runs the plain version (``ref.selected_ref``, which gathers); for a
CUDA tensor it launches the kernel or raises.  ``LAUNCHES`` counts launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref

LAUNCHES = 0
HEAD_DIMS = (64, 128)


def selected_attention_bhtd(q, k, v, key_pos, block_idx, chunk_start, *,
                            granularity: int = 1,
                            scale: Optional[float] = None):
    """q: (b, h, t, d) chunk queries; k, v: (b, n_kv, T, d) cache views
    (any strides with a contiguous head dim); key_pos: (b, T) int32
    (-1 = unwritten slot); block_idx: (b, B//g) block ids at g > 1, or
    (b, n_kv, B) / (b, B) token slots at g == 1 (-1 = padding);
    chunk_start: int, () or (b,).  Returns (b, h, t, d)."""
    global LAUNCHES
    g = int(granularity)
    if q.device.type == "cpu":
        out = ref.selected_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), key_pos, block_idx,
                               chunk_start, g, scale)
        return out.transpose(1, 2)
    if q.device.type != "cuda":
        raise RuntimeError(f"selected_attention: no kernel for device "
                           f"{q.device}")
    b, h, t, d = q.shape
    n_kv, T = k.shape[1], k.shape[2]
    if k.shape != (b, n_kv, T, d) or v.shape != k.shape or h % n_kv \
            or key_pos.shape != (b, T):
        raise ValueError(f"selected_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} key_pos {tuple(key_pos.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"selected_attention: head dim {d} not in "
                         f"{HEAD_DIMS}")
    if T % g:
        raise ValueError(f"cache length {T} must be a multiple of the "
                         f"granularity {g}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("selected_attention: q, k, v must share a dtype")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"selected_attention: {name} needs a contiguous "
                             "head dim")
    dev = q.device
    idx = block_idx.to(device=dev, dtype=torch.int32)
    if g > 1 and idx.ndim == 3:
        idx = idx[:, 0]                     # block plans are head-shared
    idx = idx.contiguous()
    nb = idx.shape[-1]
    si_h = 0 if idx.ndim == 2 else idx.stride(1)
    if idx.shape[0] != b or (idx.ndim == 3 and idx.shape[1] != n_kv):
        raise ValueError(f"selected_attention: plan ids {tuple(idx.shape)}")
    if isinstance(chunk_start, int):    # a fill, no host-to-device copy
        start = torch.full((b,), chunk_start, dtype=torch.int32, device=dev)
    else:
        start = chunk_start.to(device=dev, dtype=torch.int32)
        start = start.expand(b).contiguous() if start.ndim == 0 else \
            start.contiguous()
    key_pos = key_pos.to(torch.int32).contiguous()
    scale = (d ** -0.5) if scale is None else scale
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=dev)
    o = out.transpose(1, 2)
    lib = build.library()
    rc = lib.selected_attention_launch(
        build.dtype_code(q.dtype), d, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), key_pos.data_ptr(), idx.data_ptr(), start.data_ptr(),
        o.data_ptr(), b, h, n_kv, t, T, nb, g,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        idx.stride(0), si_h, *o.stride()[:3], float(scale),
        build.stream_ptr(dev))
    LAUNCHES += 1
    build.check(rc, "selected_attention")
    return o
