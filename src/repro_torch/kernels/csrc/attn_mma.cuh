// bf16 tensor-core attention tile for the flash, selected and paged
// attention kernels (flash_attention.cu, selected_attention.cu,
// selected_attention_paged.cu).  The fp32 launches stay on attn_tile.cuh:
// tensor cores would take fp32 operands as TF32.
//
// Contract (the same as attn_tile.cuh): the caller's key map turns a
// logical key index into the element offsets of its K and V rows and into
// `min_i`; query row i attends the key iff i >= min_i (NEVER = no row).
// Masked logits are the finite NEG_INF, p is re-masked explicitly, and a
// row with l == 0 writes exact zeros.
//
// Design:
//   * A GQA group per block.  A block owns one (batch, KV head) and a BM =
//     64-row tile of the group's `group x tq` (query head, query row) pairs,
//     enumerated head-major, so a tile may straddle heads; each row keeps
//     its own head (output address) and its own i (mask).  Each K/V tile is
//     staged once for every query head of the group.
//   * Tensor cores: four warps each own 16 rows; S = Q K^T and O += P V are
//     mma.sync.m16n8k16 bf16 products with fp32 accumulation, operands
//     read with ldmatrix from 128-byte-swizzled shared memory (16-byte chunk
//     c of row r sits at chunk c ^ (r & 7) within its group of 8: conflict-
//     free).  A row of D / 8 chunks that is not a multiple of 8 (D = 16, 48,
//     80, 112) keeps its last D / 8 % 8 chunks unswizzled, so no chunk
//     leaves its row.
//   * Head dims: D is the multiple of 16 at or above the true d (the mma's
//     k is 16); Q, K and V columns past d are zero-filled by cp.async and
//     output columns past d are not written (attn_tile.cuh,
//     with_head_dim).  mma.sync, not
//     wgmma: its fragment layouts are fixed per thread, so the tile could be
//     written and checked without a compiler at hand; wgmma is queued.  Q is
//     staged once, unscaled, and read back per k-step (registers go to S
//     and O); `scale` multiplies S in fp32.  P is rounded to bf16 for the PV
//     product and the row sum l adds the rounded values, so the output is
//     an exact weighted mean of V under the rounded weights.
//   * Masking: where every attendable key of a tile is visible to every
//     live row of a warp (all budget tiles; the chunk's diagonal tiles are
//     not), the mask is a per-key additive bias (0 or NEG_INF) fused into
//     the scaling FMA; otherwise each element compares its row with the
//     key's min_i.  p = 2^(s - m) through ex2.approx, re-masked by value.
//   * An asynchronous K/V ring: a fifth warp resolves the offsets of tile
//     j + STAGES through the map into a shared ring while the four mma warps
//     compute tile j; the mma warps fill the STAGES-deep K/V ring with
//     cp.async (16 bytes per thread, whole rows), so the loads of tiles
//     j+1 .. j+STAGES-1 are in flight while tile j computes.  A key masked
//     for every row (min_i == NEVER) is zero-filled, not read.
//   * MLA's width (flash only): Q and K 576 columns wide, V up to 576.  At
//     BM = 64 over 4 warps an O row slice of 576 fp32 columns would be 288
//     registers a thread (the limit is 255), and Q plus two stages of
//     64-key K and V tiles 360 KiB of shared memory (227 KiB a block).  So
//     the value width is split, not the key width: a block owns DV = 128
//     of V's columns (grid.y = m_tiles x column slices) and computes S over
//     all 576 key columns itself, and key tiles are BN = 32 keys (Wide
//     below).  Slices past V's width are not launched, so MLA's 512-wide
//     latent V skips the zero tail the reference pads to 576.
//   * A split key walk: grid (n_split, m_tiles * column slices, b * n_kv).  When the blocks
//     do not fill the card the wrapper picks n_split > 1 (a pure function of
//     the shapes, ``tiling.attn_geometry``); slice s walks key tiles
//     [s * n / S, (s + 1) * n / S) and writes its (m, l, acc) in fp32 to
//     scratch, and attn_merge_kernel combines the slices by log-sum-exp
//     (exact zeros where every l is 0).
#pragma once

#include "attn_tile.cuh"
#include "ptx.cuh"

namespace quoka {
namespace mma {

// The tile's shape is one decision, made in kernels/tiling.py (which sizes
// the split and its scratch from it) and handed to nvcc by kernels/build.py.
#if !defined(QUOKA_MMA_BM) || !defined(QUOKA_MMA_BN) || \
    !defined(QUOKA_MMA_BLOCKS_PER_SM) || !defined(QUOKA_SMEM_PER_SM) || \
    !defined(QUOKA_SMEM_PER_BLOCK) || !defined(QUOKA_WIDE_D) || \
    !defined(QUOKA_WIDE_DV) || !defined(QUOKA_WIDE_BN)
#error "build through kernels/build.py: it defines the tile's BM, BN, blocks"
#endif
constexpr int BM = QUOKA_MMA_BM;  // (head, row) pairs per block
constexpr int BN = QUOKA_MMA_BN;  // keys per tile
constexpr int BLOCKS_PER_SM = QUOKA_MMA_BLOCKS_PER_SM;  // resident blocks
constexpr int SMEM_PER_SM = QUOKA_SMEM_PER_SM;          // bytes, the card's
constexpr int SMEM_PER_BLOCK = QUOKA_SMEM_PER_BLOCK;
constexpr int WIDE_D = QUOKA_WIDE_D;    // MLA's [latent | rope] key width
constexpr int WIDE_DV = QUOKA_WIDE_DV;  // V columns one wide block owns
constexpr int WIDE_BN = QUOKA_WIDE_BN;  // keys per wide tile
static_assert(BM == 64, "the fragment and staging loops take 64 rows");
constexpr int MMA_WARPS = BM / 16;  // 16 rows each
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int NTHREADS = MMA_THREADS + 32;   // + the offset resolver warp
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of one block with a K/V ring of `stages` tiles of TBN keys,
// K DK and V DV columns wide: Q, the ring, and the resolver's offsets,
// min_i, biases and tile maxima for stages + 1 tiles.  Mirrored by
// tiling.attn_smem.
template <int DK, int DV, int TBN>
constexpr int attn_smem(int stages) {
  return BM * DK * 2 + stages * TBN * (DK + DV) * 2 +
         (stages + 1) * (TBN * 24 + 4);
}

// One instantiation of the tile: Q and K DK columns wide, DV columns of V
// (and of the output) per block, TBN keys per tile, NB resident blocks an
// SM aimed for (the kernel's launch bound).
template <int DK, int DV, int TBN, int NB>
struct Tile {
  static_assert(DK % 16 == 0 && DK >= 16 && DV % 16 == 0 && DV <= DK,
                "DK, DV: multiples of 16, DV <= DK");
  static_assert(TBN == 32 || TBN == 64, "TBN: 32 or 64 keys");
  static constexpr int D = DK;
  static constexpr int V = DV;
  static constexpr int N = TBN;
  static constexpr int BLOCKS = NB;
  // K/V ring depth: 3 where NB blocks of 3 stages fit an SM (with the 1 KiB
  // each block reserves), else 2 (tiling.attn_stages)
  static constexpr int STAGES =
      NB * (attn_smem<DK, DV, TBN>(3) + 1024) <= SMEM_PER_SM ? 3 : 2;
  static constexpr int RING = STAGES + 1;         // offset slots
  static constexpr int CH = DK / 8;               // 16-byte chunks per row
  static constexpr int CHV = DV / 8;              // ... per V row
  static constexpr int K_BYTES = TBN * DK * 2;    // K of one tile
  static constexpr int STAGE_BYTES = K_BYTES + TBN * DV * 2;
  static constexpr int Q_BYTES = BM * DK * 2;
  static constexpr int KV_OFF = Q_BYTES;
  static constexpr int KO_OFF = KV_OFF + STAGES * STAGE_BYTES;
  static constexpr int VO_OFF = KO_OFF + RING * TBN * 8;
  static constexpr int MI_OFF = VO_OFF + RING * TBN * 8;
  static constexpr int KB_OFF = MI_OFF + RING * TBN * 4;
  static constexpr int TM_OFF = KB_OFF + RING * TBN * 4;
  static constexpr int SMEM = TM_OFF + RING * 4;
  static_assert(SMEM == attn_smem<DK, DV, TBN>(STAGES), "layout != attn_smem");
  static_assert(SMEM <= SMEM_PER_BLOCK, "the tile exceeds a block's smem");
  static_assert((TBN * CH) % MMA_THREADS == 0 &&
                (TBN * CHV) % MMA_THREADS == 0 &&
                (BM * CH) % MMA_THREADS == 0,
                "whole staging rounds");
};

// The tile at head dims up to 128 (every kernel), and MLA's wide tile
// (flash only)
template <int D>
using Cfg = Tile<D, D, BN, BLOCKS_PER_SM>;
using Wide = Tile<WIDE_D, WIDE_DV, WIDE_BN, 1>;

struct Split {
  int n_kv;
  int n_split;
  int n_cs;         // column slices of V: blockIdx.y = m tile * n_cs + slice
  int m_pad;        // m_tiles * BM: rows of one (batch, KV head) in scratch
  float* part_o;    // (n_split, b * n_kv, m_pad, dv) unnormalised acc
  float* part_ml;   // (n_split, b * n_kv, m_pad, 2) running max (log2), l
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi, float& sum) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  const float2 f = __bfloat1622float2(h);
  sum += f.x + f.y;
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 2^x (ex2.approx, 2 ulp); flushes to +0 far below -126
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// swizzled byte offset of 16-byte chunk `ch` of row `r` in rows of CH
// chunks (the chunks past the last whole group of 8 stay in place)
template <int CH>
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  const int c = ch < (CH & ~7) ? ch ^ (r & 7) : ch;
  return r * CH * 16 + (c << 4);
}

template <class C, class Map>
__global__ void __launch_bounds__(NTHREADS, C::BLOCKS)
    attn_mma_kernel(AttnIO<__nv_bfloat16> io, Map map, Split sp) {
  constexpr int D = C::D, DV = C::V, BN = C::N;
  extern __shared__ __align__(128) unsigned char smem[];
  long long* koff = reinterpret_cast<long long*>(smem + C::KO_OFF);
  long long* voff = reinterpret_cast<long long*>(smem + C::VO_OFF);
  int* kmin = reinterpret_cast<int*>(smem + C::MI_OFF);
  float* kbias = reinterpret_cast<float*>(smem + C::KB_OFF);
  int* tmax = reinterpret_cast<int*>(smem + C::TM_OFF);
  const uint32_t q_s = smem_u32(smem);
  const uint32_t kv_s = q_s + C::KV_OFF;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, bh = blockIdx.z;
  // a tile whose block owns all of V's columns has one slice: c0 folds to 0
  constexpr bool SLICED = DV < D;
  const int mt = SLICED ? blockIdx.y / sp.n_cs : blockIdx.y;
  const int cs = SLICED ? blockIdx.y % sp.n_cs : 0;
  const int bi = bh / sp.n_kv, hk = bh % sp.n_kv;
  const int rows = io.group * io.tq;
  const int dch = io.d / 8;   // chunks of a Q / K row that hold data
  const int vch = io.dv / 8;  // ... of a V row
  const int c0 = cs * DV;     // this block's first V / output column
  const int n_tiles = max(1, (io.n_keys + BN - 1) / BN);
  const int t0 = static_cast<int>((long long)split * n_tiles / sp.n_split);
  const int nt =
      static_cast<int>((long long)(split + 1) * n_tiles / sp.n_split) - t0;

  // resolver warp: offsets of local tile j into ring slot j % RING, each
  // key's min_i and additive bias (0, or NEG_INF when no row attends it),
  // and the tile's largest min_i among attendable keys (-1: none)
  auto resolve = [&](int j) {
    const int slot = j % C::RING, base = slot * BN;
    int top = -1;
#pragma unroll
    for (int u = 0; u < BN / 32; ++u) {
      const int c = lane + 32 * u;
      const int key = (t0 + j) * BN + c;
      long long ko = 0, vo = 0;
      int mi = NEVER;
      if (key < io.n_keys) map.key(bi, hk, key, ko, vo, mi);
      koff[base + c] = ko;
      voff[base + c] = vo;
      kmin[base + c] = mi;
      kbias[base + c] = mi == NEVER ? NEG_INF : 0.f;
      if (mi != NEVER) top = max(top, mi);
    }
    top = __reduce_max_sync(0xffffffffu, top);
    if (lane == 0) tmax[slot] = top;
  };
  // mma warps: K rows and this block's V columns of local tile j into
  // ring stage j % STAGES
  auto load = [&](int j) {
    const int base = (j % C::RING) * BN;
    const uint32_t ks = kv_s + (j % C::STAGES) * C::STAGE_BYTES;
#pragma unroll
    for (int u = 0; u < BN * C::CH / MMA_THREADS; ++u) {
      const int y = tid + u * MMA_THREADS;
      const int c = y / C::CH, ch = y % C::CH;
      const bool live = kmin[base + c] != NEVER && ch < dch;
      cp_async16(ks + swz<C::CH>(c, ch),
                 io.k + koff[base + c] + (ch < dch ? ch : 0) * 8, live);
    }
#pragma unroll
    for (int u = 0; u < BN * C::CHV / MMA_THREADS; ++u) {
      const int y = tid + u * MMA_THREADS;
      const int c = y / C::CHV, ch = y % C::CHV, gc = c0 / 8 + ch;
      const bool live = kmin[base + c] != NEVER && gc < vch;
      cp_async16(ks + C::K_BYTES + swz<C::CHV>(c, ch),
                 io.v + voff[base + c] + (gc < vch ? gc : 0) * 8, live);
    }
  };

  // prologue: offsets of the first STAGES tiles, Q, the first STAGES-1 tiles
  if (warp == MMA_WARPS) {
    for (int j = 0; j < min(C::STAGES, nt); ++j) resolve(j);
  } else {
#pragma unroll
    for (int u = 0; u < BM * C::CH / MMA_THREADS; ++u) {
      const int x = tid + u * MMA_THREADS;
      const int r = x / C::CH, ch = x % C::CH;
      const int p = mt * BM + r;
      const bool ok = p < rows && ch < dch;
      const int hg = p < rows ? p / io.tq : 0, i = p < rows ? p % io.tq : 0;
      const __nv_bfloat16* src = io.q + bi * io.sq_b +
                                 (hk * io.group + hg) * io.sq_h +
                                 i * io.sq_t + (ch < dch ? ch : 0) * 8;
      cp_async16(q_s + swz<C::CH>(r, ch), src, ok);
    }
    cp_commit();
  }
  __syncthreads();  // offsets of the first tiles are visible
  if (warp < MMA_WARPS) {
#pragma unroll
    for (int j = 0; j < C::STAGES - 1; ++j) {
      if (j < nt) load(j);
      cp_commit();
    }
    cp_wait<C::STAGES - 1>();  // the Q group has landed
  }
  __syncthreads();  // Q is visible

  // this thread's two rows: g and g + 8 of its warp's 16
  const int g = lane >> 2, tq4 = lane & 3;
  const int r0 = warp * 16 + g;
  int qi[2], head[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int p = mt * BM + r0 + 8 * e;
    qi[e] = p < rows ? p % io.tq : -1;  // -1 attends nothing
    head[e] = p < rows ? hk * io.group + p / io.tq : 0;
  }
  const bool warp_live = warp < MMA_WARPS && mt * BM + warp * 16 < rows;
  // the smallest query row of this warp's live rows: a tile whose every
  // attendable key has min_i <= it needs only the per-key bias
  const int warp_qmin = __reduce_min_sync(
      0xffffffffu, min(qi[0] < 0 ? NEVER : qi[0], qi[1] < 0 ? NEVER : qi[1]));

  const float sl2 = io.scale * LOG2E;  // logits in log2 units
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[DV / 8][4];
#pragma unroll
  for (int dt = 0; dt < DV / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;

  for (int j = 0; j < nt; ++j) {
    if (warp < MMA_WARPS) cp_wait<C::STAGES - 2>();  // tile j has landed
    // all copies of tile j are visible, the stage of tile j - 1 is free,
    // and the offsets of tile j + STAGES - 1 are resolved
    __syncthreads();
    if (warp == MMA_WARPS) {
      if (j + C::STAGES < nt) resolve(j + C::STAGES);
      continue;
    }
    if (j + C::STAGES - 1 < nt) load(j + C::STAGES - 1);
    cp_commit();
    if (!warp_live) continue;

    const uint32_t ks = kv_s + (j % C::STAGES) * C::STAGE_BYTES;
    const uint32_t vs = ks + C::K_BYTES;
    const int slot = j % C::RING;

    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    {
      const int mi = lane >> 3;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[4];  // Q stays in shared memory: registers go to S, O
        ldsm_x4(qa, q_s + swz<C::CH>(warp * 16 + (mi & 1) * 8 + (lane & 7),
                                     2 * kk + (mi >> 1)));
#pragma unroll
        for (int np = 0; np < BN / 16; ++np) {
          uint32_t b[4];
          ldsm_x4(b, ks + swz<C::CH>(np * 16 + (mi >> 1) * 8 + (lane & 7),
                                     2 * kk + (mi & 1)));
          mma16816(s[2 * np], qa, b[0], b[1]);
          mma16816(s[2 * np + 1], qa, b[2], b[3]);
        }
      }
    }

    // scale and mask: a per-key bias where every attendable key of the
    // tile is visible to every live row of the warp, else per element
    if (warp_qmin >= tmax[slot]) {
      const float* kb = kbias + slot * BN + 2 * tq4;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        const float2 b2 = *reinterpret_cast<const float2*>(kb + n * 8);
        s[n][0] = fmaf(s[n][0], sl2, b2.x);
        s[n][1] = fmaf(s[n][1], sl2, b2.y);
        s[n][2] = fmaf(s[n][2], sl2, b2.x);
        s[n][3] = fmaf(s[n][3], sl2, b2.y);
      }
    } else {
      const int* km = kmin + slot * BN + 2 * tq4;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = qi[e >> 1] >= km[n * 8 + (e & 1)] ? s[n][e] * sl2
                                                      : NEG_INF;
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    float alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
      const float m_new = fmaxf(m[e], mx[e]);
      alpha[e] = ex2(m[e] - m_new);
      m[e] = m_new;
    }

    // p = exp2(s - m), re-masked (a masked logit is NEG_INF, or NEG_INF
    // plus a logit on the bias path); rounded to bf16 as the PV operand
    uint32_t pa[BN / 16][4];
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = s[n][e] > 0.5f * NEG_INF ? ex2(s[n][e] - m[e >> 1]) : 0.f;
      pa[n >> 1][(n & 1) * 2 + 0] = pack_bf16(p[0], p[1], ls[0]);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3], ls[1]);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) l[e] = alpha[e] * l[e] + ls[e];
#pragma unroll
    for (int dt = 0; dt < DV / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
    {
      const int mi = lane >> 3;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int dp = 0; dp < DV / 16; ++dp) {
          uint32_t b[4];
          ldsm_x4_t(b, vs + swz<C::CHV>(kk * 16 + (mi & 1) * 8 + (lane & 7),
                                        2 * dp + (mi >> 1)));
          mma16816(o[2 * dp], pa[kk], b[0], b[1]);
          mma16816(o[2 * dp + 1], pa[kk], b[2], b[3]);
        }
      }
    }
  }
  if (!warp_live) return;

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (qi[e] < 0) continue;
    const int r = r0 + 8 * e;
    if (sp.n_split == 1) {
      const float inv = l[e] > 0.f ? 1.f / l[e] : 0.f;
      __nv_bfloat16* op =
          io.o + bi * io.so_b + head[e] * io.so_h + qi[e] * io.so_t + c0;
#pragma unroll
      for (int dt = 0; dt < DV / 8; ++dt) {
        if (c0 / 8 + dt >= vch) break;
        const float a = l[e] > 0.f ? o[dt][2 * e] * inv : 0.f;
        const float c = l[e] > 0.f ? o[dt][2 * e + 1] * inv : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(op + dt * 8 + 2 * tq4) =
            __floats2bfloat162_rn(a, c);
      }
    } else {
      const size_t row =
          ((size_t)split * gridDim.z + bh) * sp.m_pad + mt * BM + r;
      float* po = sp.part_o + row * io.dv + c0;
#pragma unroll
      for (int dt = 0; dt < DV / 8; ++dt) {
        if (c0 / 8 + dt >= vch) break;
        *reinterpret_cast<float2*>(po + dt * 8 + 2 * tq4) =
            make_float2(o[dt][2 * e], o[dt][2 * e + 1]);
      }
      if (tq4 == 0 && cs == 0)  // every column slice has the same m, l
        *reinterpret_cast<float2*>(sp.part_ml + row * 2) =
            make_float2(m[e], l[e]);
    }
  }
}

// One warp per (head, row) pair: combine the n_split partial (m, l, acc)
// by log-sum-exp and write the bf16 output (exact zeros where every l is 0).
// The slices' loads are independent, so they are issued together.  Lane L
// owns the column pairs 2L + 64e of the dv output columns.
template <int D>
__global__ void __launch_bounds__(128)
    attn_merge_kernel(AttnIO<__nv_bfloat16> io, Split sp) {
  constexpr int E = (D + 63) / 64;  // column pairs per lane, at most
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = blockIdx.x * 4 + warp;
  const int bh = blockIdx.y;
  if (p >= io.group * io.tq) return;
  const int bi = bh / sp.n_kv, hk = bh % sp.n_kv;
  const size_t per_split = (size_t)gridDim.y * sp.m_pad;
  const size_t row0 = (size_t)bh * sp.m_pad + p;
  float mmax = NEG_INF;
  for (int s = lane; s < sp.n_split; s += 32)
    mmax = fmaxf(mmax, sp.part_ml[(s * per_split + row0) * 2]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mmax = fmaxf(mmax, __shfl_xor_sync(0xffffffffu, mmax, o));
  float l = 0.f, acc[E][2];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e][0] = acc[e][1] = 0.f;
#pragma unroll 4
  for (int s = 0; s < sp.n_split; ++s) {
    const size_t row = s * per_split + row0;
    const float2 ml = *reinterpret_cast<const float2*>(sp.part_ml + row * 2);
    const float w = exp2f(ml.x - mmax);
    l += w * ml.y;
    const float* po = sp.part_o + row * io.dv;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int c = 2 * lane + 64 * e;
      if (c < io.dv) {
        const float2 x = *reinterpret_cast<const float2*>(po + c);
        acc[e][0] += w * x.x;
        acc[e][1] += w * x.y;
      }
    }
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
  __nv_bfloat16* op = io.o + bi * io.so_b +
                      (hk * io.group + p / io.tq) * io.so_h +
                      (p % io.tq) * io.so_t;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int c = 2 * lane + 64 * e;
    if (c < io.dv)
      *reinterpret_cast<__nv_bfloat162*>(op + c) = __floats2bfloat162_rn(
          l > 0.f ? acc[e][0] * inv : 0.f, l > 0.f ? acc[e][1] * inv : 0.f);
  }
}

}  // namespace mma

// bf16 launch of tile C: n_split comes from the wrapper
// (tiling.attn_geometry); part_o / part_ml are its fp32 scratch, used only
// when n_split > 1.  The column slices cover V's dv columns.
// static: the `configured` bits stay private to each library that
// includes this header (an inline function's static is shared process-wide)
template <class C, class Map>
static cudaError_t launch_attn_tile(const AttnIO<__nv_bfloat16>& io,
                                    const Map& map, int b, int n_kv,
                                    int n_split, float* part_o,
                                    float* part_ml, cudaStream_t stream) {
  // the shared-memory limit is a per-device attribute: set it once each
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !((configured >> dev) & 1ull)) {
    e = cudaFuncSetAttribute(mma::attn_mma_kernel<C, Map>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
    if (e != cudaSuccess) return e;
    if (dev < 64) configured |= 1ull << dev;
  }
  const int m_tiles = (io.group * io.tq + mma::BM - 1) / mma::BM;
  const int n_cs = (io.dv + C::V - 1) / C::V;
  if (m_tiles < 1 || n_split < 1 || (n_split > 1 && !(part_o && part_ml)) ||
      io.d > C::D || io.dv > io.d || io.dv < 8 || io.dv % 8)
    return cudaErrorInvalidValue;
  const mma::Split sp{n_kv, n_split, n_cs, m_tiles * mma::BM, part_o,
                      part_ml};
  dim3 grid(n_split, m_tiles * n_cs, b * n_kv);
  mma::attn_mma_kernel<C, Map><<<grid, mma::NTHREADS, C::SMEM, stream>>>(
      io, map, sp);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return e;
  dim3 mgrid((io.group * io.tq + 3) / 4, b * n_kv);
  mma::attn_merge_kernel<C::D><<<mgrid, 128, 0, stream>>>(io, sp);
  return cudaGetLastError();
}

// The tile at head dims up to 128 (width D)
template <int D, class Map>
static cudaError_t launch_attn_mma(const AttnIO<__nv_bfloat16>& io,
                                   const Map& map, int b, int n_kv,
                                   int n_split, float* part_o, float* part_ml,
                                   cudaStream_t stream) {
  return launch_attn_tile<mma::Cfg<D>>(io, map, b, n_kv, n_split, part_o,
                                       part_ml, stream);
}

}  // namespace quoka
