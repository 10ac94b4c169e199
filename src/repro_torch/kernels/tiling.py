"""Launch geometry of the bf16 attention tile (``csrc/attn_mma.cuh``) and
of the scoring kernel (``csrc/quoka_score.cu``).

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
from typing import NamedTuple

import torch

# The tile's shape, defined here only: ``build.py`` compiles
# ``attn_mma.cuh`` with these values (``NVCC_DEFINES``).
BM = 64     # (head, row) pairs per block
BN = 64     # keys per tile
BLOCKS_PER_SM = 2   # resident blocks of the tile (its __launch_bounds__)
# The scoring kernel's block: at most SCORE_WARPS warps (its launch bound),
# each owning SCORE_KEYS consecutive keys of a tile (the mma's M).
SCORE_WARPS = 4
SCORE_KEYS = 16
SCORE_BLOCKS_PER_SM = 2    # resident scoring blocks aimed for
SCORE_MAX_D = 576          # MLA's 512 + 64 latent
# Hopper (H100, H200): shared memory one block may opt into, and per SM
SMEM_PER_BLOCK = 227 * 1024
SMEM_PER_SM = 228 * 1024
NVCC_DEFINES = (f"-DQUOKA_MMA_BM={BM}", f"-DQUOKA_MMA_BN={BN}",
                f"-DQUOKA_MMA_BLOCKS_PER_SM={BLOCKS_PER_SM}",
                f"-DQUOKA_SCORE_WARPS={SCORE_WARPS}",
                f"-DQUOKA_SMEM_PER_SM={SMEM_PER_SM}",
                f"-DQUOKA_SMEM_PER_BLOCK={SMEM_PER_BLOCK}")
# The attention tiles (flash, selected, paged) take every head dim that is a
# multiple of 8 up to ATTN_MAX_D, each built at the multiple of 16 at or
# above it (the mma's k), with the columns past d zero-filled.
ATTN_MAX_D = 128


def attn_width(kernel: str, d: int) -> int:
    """The instantiated width D of head dim ``d`` in the attention tiles
    (``with_head_dim`` in ``csrc/attn_tile.cuh``); raises ``ValueError``
    before any launch for a head dim they do not take."""
    if d % 8 or not 8 <= d <= ATTN_MAX_D:
        raise ValueError(f"{kernel}: head dim {d} is not a multiple of 8 "
                         f"in [8, {ATTN_MAX_D}]")
    return -(-d // 16) * 16


def attn_smem(width: int, stages: int) -> int:
    """Bytes of one bf16 attention block at width D: Q, a K/V ring of
    ``stages`` tiles, and the resolver's per-key offsets, min_i and biases
    and per-tile maxima for stages + 1 tiles.  Mirrors ``attn_smem`` in
    ``csrc/attn_mma.cuh``."""
    return (BM * width * 2 + stages * 2 * BN * width * 2
            + (stages + 1) * (BN * 24 + 4))


def attn_stages(width: int) -> int:
    """Depth of the bf16 tile's K/V ring at width D: 3 where
    ``BLOCKS_PER_SM`` blocks of 3 stages fit one SM (each block reserves
    1 KiB more), else 2 (``Cfg<D>::STAGES``)."""
    return 3 if BLOCKS_PER_SM * (attn_smem(width, 3) + 1024) \
        <= SMEM_PER_SM else 2


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


class ScoreGeometry(NamedTuple):
    warps: int      # warps per block; a tile is warps * SCORE_KEYS keys
    stages: int     # depth of each warp's cp.async ring
    n_chunks: int   # blocks per (batch, KV head); block c walks tiles
                    # c, c + n_chunks, ... of the key axis
    nq_pad: int     # queries padded (last row repeated) to a multiple of 16
    smem: int       # dynamic shared memory of one block, bytes


def score_smem(d: int, elem: int, nq_pad: int, warps: int,
               stages: int) -> int:
    """Bytes of one scoring block: each warp's ring of ``stages`` slices
    of 16 key rows (padded by 16 bytes), the resident q̄ (bf16 rows padded
    by 16 bytes, fp32 rows not) and each slot's valid bits.  Mirrors
    ``smem_bytes`` in ``quoka_score.cu``."""
    ring_row = d * elem + 16
    q_row = 2 * d + 16 if elem == 2 else 4 * d
    return (warps * stages * SCORE_KEYS * ring_row + nq_pad * q_row
            + 4 * warps * stages)


@functools.lru_cache(maxsize=1024)
def score_geometry(b: int, n_kv: int, n_q: int, T: int, d: int, elem: int,
                   n_sm: int) -> ScoreGeometry:
    """Launch geometry of one scoring call (``elem``: bytes per K element,
    2 for bf16, 4 for fp32).  The largest block whose ring fits one
    block's shared memory (4 warps and 3 stages first), then enough blocks
    per (batch, KV head) that ``SCORE_BLOCKS_PER_SM`` of them (or as many
    as fit) are resident on every SM, at most one per tile.  Raises
    ``ValueError`` for a head dim or query count the kernel does not
    take."""
    if d % 16 or not 16 <= d <= SCORE_MAX_D:
        raise ValueError(f"quoka_score: head dim {d} is not a multiple of "
                         f"16 in [16, {SCORE_MAX_D}]")
    if n_q < 1:
        raise ValueError(f"quoka_score: n_q = {n_q}")
    nq_pad = -(-n_q // 16) * 16
    for warps, stages in ((SCORE_WARPS, 3), (SCORE_WARPS, 2), (2, 3),
                          (2, 2), (1, 3), (1, 2)):
        smem = score_smem(d, elem, nq_pad, warps, stages)
        if smem <= SMEM_PER_BLOCK:
            break
    else:
        raise ValueError(f"quoka_score: n_q={n_q} queries at d={d} do not "
                         "fit in shared memory")
    n_tiles = max(1, -(-T // (warps * SCORE_KEYS)))
    resident = max(1, min(SCORE_BLOCKS_PER_SM,
                          SMEM_PER_SM // (smem + 1024)))
    n_chunks = min(n_tiles, -(-resident * n_sm // max(1, b * n_kv)))
    return ScoreGeometry(warps, stages, n_chunks, nq_pad, smem)


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
