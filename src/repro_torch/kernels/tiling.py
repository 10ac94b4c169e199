"""Launch geometry of the bf16 attention tile (``csrc/attn_mma.cuh``).

One block owns one (batch, KV head) and ``BM`` of the GQA group's
``group * tq`` (query head, query row) pairs, enumerated head-major, and
walks the keys in tiles of ``BN``.  When those blocks do not fill the card,
the key walk is cut into ``n_split`` slices: slice ``s`` walks key tiles
``[s * n / n_split, (s + 1) * n / n_split)`` of the ``n`` tiles, so every
slice has at least one tile, and a merge kernel combines the slices.  The
choice depends only on the shapes (and the card's SM count), so the linear
and the paged selected-attention kernels split one call identically.
"""
from __future__ import annotations

import functools

import torch

# The tile's shape, defined here only: ``build.py`` compiles
# ``attn_mma.cuh`` with these values (``NVCC_DEFINES``).
BM = 64     # (head, row) pairs per block
BN = 64     # keys per tile
BLOCKS_PER_SM = 2   # resident blocks of the tile (its __launch_bounds__)
NVCC_DEFINES = (f"-DQUOKA_MMA_BM={BM}", f"-DQUOKA_MMA_BN={BN}",
                f"-DQUOKA_MMA_BLOCKS_PER_SM={BLOCKS_PER_SM}")


def attn_geometry(b: int, n_kv: int, group: int, tq: int, n_keys: int,
                  n_sm: int) -> tuple[int, int]:
    """(m_tiles, n_split) of one bf16 attention call.  Fewer blocks than
    SMs are split into as many slices as fill the resident slots of one
    wave, at most one slice per key tile."""
    m_tiles = -(-group * tq // BM)
    n_tiles = max(1, -(-n_keys // BN))
    blocks = b * n_kv * m_tiles
    n_split = 1
    if blocks < n_sm:
        n_split = min(n_tiles, BLOCKS_PER_SM * n_sm // blocks)
    return m_tiles, n_split


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_args(q, n_kv: int, tq: int, n_keys: int):
    """The split arguments of one launch, ``(n_split, part_o, part_ml)``
    with the scratch pointers as ints (0 when unused), and the scratch
    tensors that back them (kept alive by the caller until the launch is
    enqueued).  The launcher derives the M tiles from ``BM`` itself.  fp32
    runs on the simple tile: ``(1, 0, 0)``."""
    if q.dtype != torch.bfloat16:
        return (1, 0, 0), ()
    b, h, d = q.shape[0], q.shape[1], q.shape[3]
    m_tiles, n_split = attn_geometry(b, n_kv, h // n_kv, tq, n_keys,
                                     sm_count(q.device.index))
    if n_split == 1:
        return (1, 0, 0), ()
    rows = b * n_kv * m_tiles * BM
    part_o = torch.empty((n_split, rows, d), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((n_split, rows, 2), dtype=torch.float32,
                          device=q.device)
    return ((n_split, part_o.data_ptr(), part_ml.data_ptr()),
            (part_o, part_ml))


def check_aligned(kernel: str, **tensors) -> None:
    """The bf16 tile copies 16-byte chunks (cp.async): each row must start
    on a 16-byte boundary."""
    for name, x in tensors.items():
        if x.dtype == torch.bfloat16 and (
                x.data_ptr() % 16 or any(s % 8 for s in x.stride()[:-1])):
            raise ValueError(f"{kernel}: bf16 {name} rows must be 16-byte "
                             f"aligned (strides {tuple(x.stride())})")
