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

Flash attention also takes MLA's 576-wide [latent | rope] keys on a wide
tile (``WIDE_*``): Q and K stay whole, the
value width is cut into ``WIDE_DV``-column slices, one per block, and the
keys come in tiles of ``WIDE_BN`` (``csrc/attn_mma.cuh``, ``Wide``).
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
# The attention tiles (flash, selected, paged) take every head dim that is a
# multiple of 8 up to ATTN_MAX_D, each built at the multiple of 16 at or
# above it (the mma's k), with the columns past d zero-filled.
ATTN_MAX_D = 128
# Flash's wide tile: key width WIDE_D only (the widths between ATTN_MAX_D
# and WIDE_D are refused); a block owns WIDE_DV columns of V and walks
# WIDE_BN-key tiles, one block per SM (its shared memory: Q 72 KiB and a
# 3-stage ring).
WIDE_D = 576       # MLA's 512 + 64 [latent | rope] key width
WIDE_DV = 128
WIDE_BN = 32
WIDE_BLOCKS_PER_SM = 1
NVCC_DEFINES = (f"-DQUOKA_MMA_BM={BM}", f"-DQUOKA_MMA_BN={BN}",
                f"-DQUOKA_MMA_BLOCKS_PER_SM={BLOCKS_PER_SM}",
                f"-DQUOKA_SCORE_WARPS={SCORE_WARPS}",
                f"-DQUOKA_SMEM_PER_SM={SMEM_PER_SM}",
                f"-DQUOKA_SMEM_PER_BLOCK={SMEM_PER_BLOCK}",
                f"-DQUOKA_WIDE_D={WIDE_D}", f"-DQUOKA_WIDE_DV={WIDE_DV}",
                f"-DQUOKA_WIDE_BN={WIDE_BN}")


def attn_width(kernel: str, d: int) -> int:
    """The instantiated width D of head dim ``d`` in the attention tiles
    (``with_head_dim`` in ``csrc/attn_tile.cuh``); raises ``ValueError``
    before any launch for a head dim they do not take."""
    if d % 8 or not 8 <= d <= ATTN_MAX_D:
        raise ValueError(f"{kernel}: head dim {d} is not a multiple of 8 "
                         f"in [8, {ATTN_MAX_D}]")
    return -(-d // 16) * 16


def flash_width(d: int, dv: int) -> int:
    """The instantiated width of flash attention at key width ``d`` and
    value width ``dv`` (``with_flash_head_dim`` in
    ``csrc/flash_attention.cu``): ``attn_width`` up to 128, or ``WIDE_D``
    itself; ``dv`` a multiple of 8 in [8, d].  Raises ``ValueError``
    before any launch otherwise."""
    if d != WIDE_D and (d % 8 or not 8 <= d <= ATTN_MAX_D):
        raise ValueError(f"flash_attention: head dim {d} is neither a "
                         f"multiple of 8 in [8, {ATTN_MAX_D}] nor {WIDE_D}")
    if dv % 8 or not 8 <= dv <= d:
        raise ValueError(f"flash_attention: value width {dv} is not a "
                         f"multiple of 8 in [8, {d}]")
    return attn_width("flash_attention", d) if d <= ATTN_MAX_D else WIDE_D


def attn_smem(width: int, stages: int, dv: int = 0, bn: int = BN) -> int:
    """Bytes of one bf16 attention block at width D (V ``dv`` columns,
    default D; ``bn`` keys per tile): Q, a K/V ring of ``stages`` tiles,
    and the resolver's per-key offsets, min_i and biases and per-tile
    maxima for stages + 1 tiles.  Mirrors ``attn_smem`` in
    ``csrc/attn_mma.cuh``."""
    dv = dv or width
    return (BM * width * 2 + stages * bn * (width + dv) * 2
            + (stages + 1) * (bn * 24 + 4))


def attn_stages(width: int, dv: int = 0, bn: int = BN,
                per_sm: int = BLOCKS_PER_SM) -> int:
    """Depth of the bf16 tile's K/V ring: 3 where ``per_sm`` blocks of 3
    stages fit one SM (each block reserves 1 KiB more), else 2
    (``Tile::STAGES``)."""
    return 3 if per_sm * (attn_smem(width, 3, dv, bn) + 1024) \
        <= SMEM_PER_SM else 2


def attn_geometry(b: int, n_kv: int, group: int, tq: int, n_keys: int,
                  n_sm: int, *, bn: int = BN, n_cs: int = 1,
                  per_sm: int = BLOCKS_PER_SM) -> tuple[int, int]:
    """(m_tiles, n_split) of one bf16 attention call whose blocks each own
    one of ``n_cs`` column slices of V and walk ``bn``-key tiles.  Fewer
    blocks than SMs are split into as many slices as fill the resident
    slots of one wave, at most one slice per key tile."""
    m_tiles = -(-group * tq // BM)
    n_tiles = max(1, -(-n_keys // bn))
    blocks = b * n_kv * m_tiles * n_cs
    n_split = 1
    if blocks < n_sm:
        n_split = min(n_tiles, per_sm * n_sm // blocks)
    return m_tiles, n_split


def wide_geometry(b: int, n_kv: int, group: int, tq: int, n_keys: int,
                  dv: int, n_sm: int) -> tuple[int, int, int]:
    """(m_tiles, n_cs, n_split) of one flash call on the wide tile."""
    n_cs = -(-dv // WIDE_DV)
    m_tiles, n_split = attn_geometry(b, n_kv, group, tq, n_keys, n_sm,
                                     bn=WIDE_BN, n_cs=n_cs,
                                     per_sm=WIDE_BLOCKS_PER_SM)
    return m_tiles, n_cs, n_split


class ScoreGeometry(NamedTuple):
    warps: int      # warps per block; a tile is warps * SCORE_KEYS keys
    stages: int     # depth of each warp's cp.async ring
    n_chunks: int   # blocks per (batch, KV head); block c walks tiles
                    # c, c + n_chunks, ... of the key axis
    nq_pad: int     # queries padded (last row repeated) to a multiple of 16
    smem: int       # dynamic shared memory of one block, bytes


def score_width(d: int) -> int:
    """The width the scoring kernel stages head dim ``d`` at: the multiple
    of 16 at or above it (the mma's k; the columns past ``d`` are
    zero-filled).  Raises ``ValueError`` before any launch for a head dim
    it does not take: not a multiple of 8 in [8, SCORE_MAX_D]."""
    if d % 8 or not 8 <= d <= SCORE_MAX_D:
        raise ValueError(f"quoka_score: head dim {d} is not a multiple of "
                         f"8 in [8, {SCORE_MAX_D}]")
    return -(-d // 16) * 16


def score_smem(d: int, elem: int, nq_pad: int, warps: int,
               stages: int) -> int:
    """Bytes of one scoring block at head dim ``d`` (staged at
    ``score_width(d)``): each warp's ring of ``stages`` slices of 16 key
    rows (padded by 16 bytes), the resident q̄ (bf16 rows padded by 16
    bytes, fp32 rows not) and each slot's valid bits.  Mirrors
    ``smem_bytes`` in ``quoka_score.cu``."""
    d = score_width(d)
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
    take (``score_width``).  A head dim off the 16-grid gets the geometry
    of the width it is staged at."""
    score_width(d)
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


def split_args(q, n_kv: int, tq: int, n_keys: int, dv: int = 0):
    """The split arguments of one launch, ``(n_split, part_o, part_ml)``
    with the scratch pointers as ints (0 when unused), and the scratch
    tensors that back them (kept alive by the caller until the launch is
    enqueued).  ``dv``: V's width (default q's d); a d above
    ``ATTN_MAX_D`` takes the wide tile's geometry.  The launcher derives
    the M tiles and column slices itself.  fp32 runs on the simple tile:
    ``(1, 0, 0)``."""
    if q.dtype != torch.bfloat16:
        return (1, 0, 0), ()
    b, h, d = q.shape[0], q.shape[1], q.shape[3]
    dv = dv or d
    n_sm = sm_count(q.device.index)
    if d > ATTN_MAX_D:
        m_tiles, _, n_split = wide_geometry(b, n_kv, h // n_kv, tq, n_keys,
                                            dv, n_sm)
    else:
        m_tiles, n_split = attn_geometry(b, n_kv, h // n_kv, tq, n_keys,
                                         n_sm)
    if n_split == 1:
        return (1, 0, 0), ()
    rows = b * n_kv * m_tiles * BM
    part_o = torch.empty((n_split, rows, dv), dtype=torch.float32,
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
