"""Gather-free fused selected-attention kernel wrappers (counterpart of
``repro/kernels/selected_attention.py``).

``selected_attention_bhtd`` reads a linear cache view (CUDA source
``csrc/selected_attention.cu``); ``selected_attention_paged`` reads the
paged pool's blocks through a block table (``csrc/selected_attention_
paged.cu``).  The chunk's queries attend over [plan-selected KV | causal
chunk] read in place; validity is re-derived in the kernel exactly as
``core/plan.py::materialize`` derives it.  For a CPU tensor each wrapper
runs its plain version (``ref.selected_ref`` / ``ref.selected_paged_ref``,
which gather); for a CUDA tensor it launches its kernel (bf16:
``csrc/attn_mma.cuh``, with its merge kernel when ``tiling.attn_geometry``
splits the key walk, identically for both views) or raises.  Both take
every head dim that is a multiple of 8 up to 128 (``tiling.attn_width``).
``LAUNCHES`` and ``PAGED_LAUNCHES`` count wrapper calls that launched.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref, tiling

LAUNCHES = 0
PAGED_LAUNCHES = 0


def _plan_inputs(q, block_idx, chunk_start, g: int, n_kv: int, name: str):
    """Plan ids as contiguous int32 (b, nb) or (b, n_kv, nb) with the head
    stride the kernel reads (0 when head-shared), and the chunk start as a
    (b,) int32 device tensor."""
    b, dev = q.shape[0], q.device
    idx = block_idx.to(device=dev, dtype=torch.int32)
    if g > 1 and idx.ndim == 3:
        idx = idx[:, 0]                     # block plans are head-shared
    idx = idx.contiguous()
    si_h = 0 if idx.ndim == 2 else idx.stride(1)
    if idx.shape[0] != b or (idx.ndim == 3 and idx.shape[1] != n_kv):
        raise ValueError(f"{name}: plan ids {tuple(idx.shape)}")
    if isinstance(chunk_start, int):    # a fill, no host-to-device copy
        start = torch.full((b,), chunk_start, dtype=torch.int32, device=dev)
    else:
        start = chunk_start.to(device=dev, dtype=torch.int32)
        start = start.expand(b).contiguous() if start.ndim == 0 else \
            start.contiguous()
    return idx, si_h, start


def _split_args(q, idx, g: int, n_kv: int):
    """Launch geometry of either view: both walk the ``nb * g`` selected
    keys, then the ``t`` chunk keys, so one shape splits identically."""
    t = q.shape[2]
    return tiling.split_args(q, n_kv, t, idx.shape[-1] * g + t)


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
    tiling.attn_width("selected_attention", d)
    if T % g:
        raise ValueError(f"cache length {T} must be a multiple of the "
                         f"granularity {g}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("selected_attention: q, k, v must share a dtype")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"selected_attention: {name} needs a contiguous "
                             "head dim")
    idx, si_h, start = _plan_inputs(q, block_idx, chunk_start, g, n_kv,
                                    "selected_attention")
    dev = q.device
    nb = idx.shape[-1]
    key_pos = key_pos.to(torch.int32).contiguous()
    tiling.check_aligned("selected_attention", q=q, k=k, v=v)
    scale = (d ** -0.5) if scale is None else scale
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=dev)
    o = out.transpose(1, 2)
    geom, _scratch = _split_args(q, idx, g, n_kv)
    lib = build.library()
    rc = lib.selected_attention_launch(
        build.dtype_code(q.dtype), d, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), key_pos.data_ptr(), idx.data_ptr(), start.data_ptr(),
        o.data_ptr(), b, h, n_kv, t, T, nb, g,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        idx.stride(0), si_h, *o.stride()[:3], float(scale), *geom,
        build.stream_ptr(dev))
    LAUNCHES += 1
    build.check(rc, "selected_attention")
    return o


def selected_attention_paged(q, k_pool, v_pool, pos_pool, block_idx,
                             chunk_start, table, *, granularity: int,
                             block_size: int,
                             scale: Optional[float] = None):
    """Selected attention THROUGH a paged pool's block table.  q (b, h, t,
    d) chunk queries; k_pool, v_pool (N, block_size, n_kv, d) pool leaves
    (any block/slot/head strides with a contiguous head dim); pos_pool
    (N, block_size) int32; table (b, nb_logical) physical block ids, -1 =
    unmapped; block_idx and chunk_start as in ``selected_attention_bhtd``
    but on the LOGICAL grid (the request's blocks in table order, length
    nb_logical * block_size).  Returns (b, h, t, d).

    A table entry >= N raises when the table is on the host; a table
    already on the card is not read back (that would cost a sync), and the
    kernel masks such an entry as unmapped instead of reading past the
    pool."""
    global PAGED_LAUNCHES
    g, bs = int(granularity), int(block_size)
    if bs % g:
        raise ValueError(f"pool block size {bs} must be a multiple of the "
                         f"selection granularity {g}")
    table = torch.as_tensor(table)
    if table.device.type == "cpu" and table.numel() \
            and int(table.max()) >= k_pool.shape[0]:
        raise ValueError(f"selected_attention_paged: table entry "
                         f"{int(table.max())} outside a pool of "
                         f"{k_pool.shape[0]} blocks")
    if q.device.type == "cpu":
        out = ref.selected_paged_ref(q.transpose(1, 2), k_pool, v_pool,
                                     pos_pool, block_idx, chunk_start, table,
                                     g, scale)
        return out.transpose(1, 2)
    if q.device.type != "cuda":
        raise RuntimeError(f"selected_attention_paged: no kernel for device "
                           f"{q.device}")
    b, h, t, d = q.shape
    n_blocks, n_kv = k_pool.shape[0], k_pool.shape[2]
    if k_pool.shape != (n_blocks, bs, n_kv, d) \
            or v_pool.shape != k_pool.shape or h % n_kv \
            or pos_pool.shape != (n_blocks, bs) or table.ndim != 2 \
            or table.shape[0] != b:
        raise ValueError(f"selected_attention_paged: shapes q "
                         f"{tuple(q.shape)} k_pool {tuple(k_pool.shape)} "
                         f"pos_pool {tuple(pos_pool.shape)} table "
                         f"{tuple(table.shape)} (block_size {bs})")
    tiling.attn_width("selected_attention_paged", d)
    if not (q.dtype == k_pool.dtype == v_pool.dtype):
        raise TypeError("selected_attention_paged: q and the pools must "
                        "share a dtype")
    for name, x in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if x.stride(-1) != 1:
            raise ValueError(f"selected_attention_paged: {name} needs a "
                             "contiguous head dim")
    idx, si_h, start = _plan_inputs(q, block_idx, chunk_start, g, n_kv,
                                    "selected_attention_paged")
    dev = q.device
    nb = idx.shape[-1]
    table = table.to(device=dev, dtype=torch.int32).contiguous()
    pos_pool = pos_pool.to(torch.int32).contiguous()
    tiling.check_aligned("selected_attention_paged", q=q, k_pool=k_pool,
                         v_pool=v_pool)
    scale = (d ** -0.5) if scale is None else scale
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=dev)
    o = out.transpose(1, 2)
    geom, _scratch = _split_args(q, idx, g, n_kv)
    lib = build.library()
    rc = lib.selected_attention_paged_launch(
        build.dtype_code(q.dtype), d, q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), pos_pool.data_ptr(), table.data_ptr(),
        idx.data_ptr(), start.data_ptr(), o.data_ptr(), b, h, n_kv, t,
        table.shape[1], n_blocks, bs, nb, g, *q.stride()[:3],
        *k_pool.stride()[:3], *v_pool.stride()[:3], idx.stride(0), si_h,
        *o.stride()[:3], float(scale), *geom, build.stream_ptr(dev))
    PAGED_LAUNCHES += 1
    build.check(rc, "selected_attention_paged")
    return o
