// Fused QUOKA key scoring (paper Algorithm 1 lines 7-10).
//
// Replaces: src/repro/kernels/quoka_score.py, quoka_score_bhtd (the Pallas
// TPU kernel, body _kernel).  For every cached key:
//
//   score[b, h, t] = max_n (q̄[b, h, n] . k[b, h, t]) * rsqrt(sum k^2 + 1e-16)
//
// and NEG_INF = -1e30 where valid[b, t] is false.  q̄ is first rounded to
// k's dtype and the products accumulate in fp32; the max is taken before
// the positive scale, which is exact since rounding is monotone.  The
// output is fp32 (b, n_kv, T); the (n_q x T) score matrix never reaches
// memory.
//
// Bound on the H100 at the main path's shapes (qwen3-4b: b = 1, n_kv = 8,
// T = 8224 cache slots, d = 128, bf16 K, fp32 q̄): bytes.  The kernel must
// read the valid K rows (8 x 256 B each), q̄, `valid` and write the scores:
// 8.7 MB at a mid-prefill chunk (n_q = 16, 4096 valid slots; 2.6 us at
// 3.35 TB/s) and 17.0 MB at the last chunk or a decode step (8192 valid;
// 5.1 us), against 0.3 GFLOP of products (0.3 us on the tensor cores).
//
// Design:
//   * Keys are M.  A warp owns 16 consecutive keys (a slice) of a tile; its
//     product is K (16 x d, bf16, the A operand) times q̄^T (d x 16, B) as
//     mma.sync.m16n8k16 with fp32 accumulation, both read with ldmatrix
//     from shared memory whose rows are padded by 16 bytes (row stride
//     2d + 16: 8 consecutive rows hit 8 distinct bank groups for every d
//     that is a multiple of 16; a 128-byte swizzle needs d % 64 == 0).
//     n_q is padded to a multiple of 16 by repeating its last row (a zero
//     row would bias the max toward 0: the TPU wrapper's edge-pad rule) and
//     walked in blocks of 16.  The max over queries is a per-thread max over
//     the accumulator's columns and two quad shuffles per 16-key row group.
//     Four k-steps' ldmatrix loads are issued before their products.
//   * Head dims: every multiple of 8 up to 576.  The shared-memory rows
//     and the k-steps run at dp, the multiple of 16 at or above d (the
//     mma's k); the columns d .. dp - 1 of the staged keys are zero-filled
//     (cp.async with source size 0: h2o-danube's d = 120 is a 240-byte row,
//     fifteen 16-byte chunks read and the sixteenth zero-filled) and those
//     of q̄ are stored as zeros, so neither a product nor a norm changes:
//     the scores are the same function of the d real columns.
//   * Key norms on the tensor cores too: the slice's Gram matrix K K^T has
//     the squared norms on its diagonal, and ldmatrix gives A's 8x8 blocks
//     the thread layout of B's, so K^T's B fragments are A's registers
//     reordered.  Two more mma per k-step (first query block only) replace
//     16 unpack-and-FMA instructions, and K is read from memory once.
//   * q̄ stays resident in shared memory, rounded in the kernel
//     (__float2bfloat16_rn, as torch's .to(torch.bfloat16)) from the fp32
//     q̄ the caller passes: the wrapper launches no cast.  Its loads are
//     issued before the key copies, so they do not queue behind them.
//   * Bytes in flight: every warp streams its slices through its own R-slot
//     cp.async ring (16 bytes per lane, whole rows, one commit group per
//     slice): R slices are in flight from the start, and slice j + R is
//     issued into slice j's slot once j's products are done, so the wait
//     for slice j is always cp.async.wait_group R - 1 and no block barrier
//     follows the staging of q̄.  A block walks the tiles chunk,
//     chunk + n_chunks, ... of one (batch, KV head): strided, so the valid
//     prefix of the cache spreads evenly over the blocks.
//     kernels/tiling.py::score_geometry picks warps, R and n_chunks from
//     the shapes and the SM count (qwen3-4b: 4 warps, R = 3, a grid of
//     33 x 8 blocks, each walking 3-4 tiles of 64 keys).
//   * Invalid keys are never read.  Each lane fetches the valid bytes of
//     its key in 8 slices per round trip; a row whose slot is invalid is
//     zero-filled (cp.async with source size 0) and masked on store; a
//     slice with no valid slot issues no copy, skips its products and
//     writes NEG_INF.
//   * fp32 K (smoke configs, tests) stays in full fp32 on the CUDA cores:
//     TF32 products would miss the 2e-5 tolerance.  Two lanes per key, each
//     half of the row from the same staged slice, q̄ rows broadcast from
//     shared memory, 16 dot products in registers, one shuffle to combine.
//
// Times (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 6; PERF.md):
// per call in a profiler trace 0.0068-0.0069 ms at n_q = 16 with 4096
// valid slots (2.6x the bound), 0.0091-0.0092 ms with 8192 valid and
// 0.0090 ms at decode; 0.0085 / 0.0109 / 0.0108-0.0111 ms each for 20
// calls back to back in one graph.  Against a minimal cp.async ring that
// only reads the same rows, the excess is latency in series: the valid
// bytes' round trip before the first copy, q̄'s staging, and the products
// of the last slices after they land.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"

#if !defined(QUOKA_SCORE_WARPS)
#error "build through kernels/build.py: it defines the score tile's warps"
#endif

namespace quoka_score {

using quoka::cp_async16;
using quoka::cp_commit;
using quoka::cp_wait;
using quoka::ldsm_x4;
using quoka::mma16816;
using quoka::smem_u32;

constexpr float NEG_INF = -1e30f;
constexpr int MAX_WARPS = QUOKA_SCORE_WARPS;  // warps per block, at most
constexpr int KEYS = 16;   // keys per warp slice: the mma's M
constexpr int NB = 16;     // queries per block of the n_q walk
constexpr int MAX_D = 576;

struct Args {
  const float* qbar;
  const void* k;
  const uint8_t* valid;
  float* out;
  int n_kv, n_q, nq_pad, T;
  int d;   // the staged width: the multiple of 16 at or above dk
  int dk;  // the head dim of q̄ and k, a multiple of 8
  int n_chunks;
  long long sq_b, sq_h, sq_n, sq_d;
  long long sk_b, sk_h, sk_t;
  long long sv_b, sv_t;
};

// bytes of one staged key row (padded) and of one resident q̄ row
template <typename T>
__host__ __device__ inline int ring_row(int d) {
  return d * static_cast<int>(sizeof(T)) + 16;
}
template <typename T>
__host__ __device__ inline int q_row(int d) {
  return sizeof(T) == 2 ? 2 * d + 16 : 4 * d;
}
// the ring, q̄, then each slot's valid bits
template <typename T>
__host__ inline size_t smem_bytes(int d, int nq_pad, int warps, int ring) {
  return (size_t)warps * ring * KEYS * ring_row<T>(d) +
         (size_t)nq_pad * q_row<T>(d) + 4 * warps * ring;
}

__device__ __forceinline__ void store_q(unsigned char* p, float x,
                                        __nv_bfloat16) {
  *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store_q(unsigned char* p, float x, float) {
  *reinterpret_cast<float*>(p) = x;
}

// 16 rows n0 .. n0 + 15 of q̄ column e (rows past n_q repeat row
// n_q - 1: the edge pad), all loads in flight at once; zeros for a column
// past the head dim (e >= dk: the staged width's padding)
__device__ __forceinline__ void load_q(float (&v)[NB], const float* col,
                                       int e, int n0, const Args& a) {
#pragma unroll
  for (int i = 0; i < NB; ++i)
    v[i] = e < a.dk ? col[min(n0 + i, a.n_q - 1) * a.sq_n] : 0.f;
}
// ... and into shared memory, rounded to T
template <typename T>
__device__ __forceinline__ void store_q_rows(unsigned char* dst,
                                             const float (&v)[NB], int qrs) {
#pragma unroll
  for (int i = 0; i < NB; ++i) store_q(dst + i * qrs, v[i], T());
}

// G k-steps of one 16-query block from k-step kk0: all ldmatrix loads
// first, then the products into c[k-step parity][n8 tile].  With NORM, also
// the slice's Gram matrix K K^T into gm[parity][n8 tile] (its diagonal is
// the squared key norms): ldmatrix gives A's 8x8 blocks the same thread
// layout as B's, so K^T's B fragments are the A registers reordered.
template <int G, bool NORM>
__device__ __forceinline__ void ksteps(float (&c)[2][2][4],
                                       float (&gm)[2][2][4], uint32_t a_addr,
                                       uint32_t b_addr, int kk0) {
  uint32_t ra[G][4], rb[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    ldsm_x4(ra[g], a_addr + (kk0 + g) * 32);
    ldsm_x4(rb[g], b_addr + (kk0 + g) * 32);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    mma16816(c[g & 1][0], ra[g], rb[g][0], rb[g][1]);
    mma16816(c[g & 1][1], ra[g], rb[g][2], rb[g][3]);
    if (NORM) {
      mma16816(gm[g & 1][0], ra[g], ra[g][0], ra[g][2]);  // keys 0-7
      mma16816(gm[g & 1][1], ra[g], ra[g][1], ra[g][3]);  // keys 8-15
    }
  }
}

// one 16-query block over all nk k-steps; the max of its columns per row
template <bool NORM>
__device__ __forceinline__ void qblock(float (&best)[2], float (&gm)[2][2][4],
                                       uint32_t a_addr, uint32_t b_addr,
                                       int nk) {
  float c[2][2][4] = {};
  int kk = 0;
  for (; kk + 4 <= nk; kk += 4) ksteps<4, NORM>(c, gm, a_addr, b_addr, kk);
  for (; kk < nk; ++kk) ksteps<1, NORM>(c, gm, a_addr, b_addr, kk);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    best[0] = fmaxf(best[0], fmaxf(c[0][t][0] + c[1][t][0],
                                   c[0][t][1] + c[1][t][1]));
    best[1] = fmaxf(best[1], fmaxf(c[0][t][2] + c[1][t][2],
                                   c[0][t][3] + c[1][t][3]));
  }
}

// bf16: the max over queries and the squared norm of this thread's two
// rows, g = lane / 4 and g + 8 of the warp's 16, for the whole quad
__device__ __forceinline__ void slice_bf16(uint32_t ks, uint32_t qs, int rs,
                                           int qrs, int d, int nq_pad,
                                           float (&best)[2], float (&sq)[2]) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, g = lane >> 2;
  // A x4: (rows 0-7, k lo) (rows 8-15, k lo) (rows 0-7, k hi) (8-15, hi)
  const uint32_t a_addr =
      ks + ((mi & 1) * 8 + (lane & 7)) * rs + (mi >> 1) * 16;
  // B x4: (queries 0-7, k lo) (0-7, k hi) (8-15, k lo) (8-15, k hi)
  const uint32_t b_addr =
      qs + ((mi >> 1) * 8 + (lane & 7)) * qrs + (mi & 1) * 16;
  float gm[2][2][4] = {};
  best[0] = best[1] = -INFINITY;
  qblock<true>(best, gm, a_addr, b_addr, d / 16);
  for (int nb = NB; nb < nq_pad; nb += NB)
    qblock<false>(best, gm, a_addr, b_addr + nb * qrs, d / 16);
  // Gram diagonal (g, g) sits in lane 4g + g/2, element g % 2 of tile 0;
  // (g + 8, g + 8) in the same lane, element 2 + g % 2 of tile 1
  const int e0 = g & 1;
  const float d0 = e0 ? gm[0][0][1] + gm[1][0][1] : gm[0][0][0] + gm[1][0][0];
  const float d1 = e0 ? gm[0][1][3] + gm[1][1][3] : gm[0][1][2] + gm[1][1][2];
  const int src = (lane & ~3) | (g >> 1);
  sq[0] = __shfl_sync(0xffffffffu, d0, src);
  sq[1] = __shfl_sync(0xffffffffu, d1, src);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1)
      best[e] = fmaxf(best[e], __shfl_xor_sync(0xffffffffu, best[e], o));
  }
}

// fp32: lanes l and l + 16 share key l % 16, each half of its row
__device__ __forceinline__ void slice_f32(const unsigned char* ks,
                                          const unsigned char* qs, int rs,
                                          int qrs, int d, int nq_pad,
                                          float& best, float& sq) {
  const int lane = threadIdx.x & 31;
  const int half = d / 8;  // 16-byte chunks per half row
  const unsigned char* kr = ks + (lane & 15) * rs + (lane >> 4) * half * 16;
  const unsigned char* qr = qs + (lane >> 4) * half * 16;
  best = -INFINITY;
  sq = 0.f;
  for (int nb = 0; nb < nq_pad; nb += NB) {
    float dot[NB];
#pragma unroll
    for (int n = 0; n < NB; ++n) dot[n] = 0.f;
    for (int c = 0; c < half; ++c) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + c * 16);
      if (nb == 0) {
        sq = fmaf(kv.x, kv.x, sq);
        sq = fmaf(kv.y, kv.y, sq);
        sq = fmaf(kv.z, kv.z, sq);
        sq = fmaf(kv.w, kv.w, sq);
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const float4 q =
            *reinterpret_cast<const float4*>(qr + (nb + n) * qrs + c * 16);
        dot[n] = fmaf(kv.x, q.x, dot[n]);
        dot[n] = fmaf(kv.y, q.y, dot[n]);
        dot[n] = fmaf(kv.z, q.z, dot[n]);
        dot[n] = fmaf(kv.w, q.w, dot[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < NB; ++n)
      best = fmaxf(best, dot[n] + __shfl_xor_sync(0xffffffffu, dot[n], 16));
  }
  sq += __shfl_xor_sync(0xffffffffu, sq, 16);
}

template <typename T, int R>
__global__ void __launch_bounds__(MAX_WARPS * 32) score_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int warps = blockDim.x >> 5;
  const int chunk = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int rs = ring_row<T>(a.d), qrs = q_row<T>(a.d);
  const int tile_keys = warps * KEYS;
  const int n_tiles = (a.T + tile_keys - 1) / tile_keys;
  const int nt = (n_tiles - 1 - chunk) / a.n_chunks + 1;  // chunk < n_tiles

  unsigned char* ring = smem + warp * R * KEYS * rs;
  unsigned char* qs = smem + warps * R * KEYS * rs;
  uint32_t* vmask =
      reinterpret_cast<uint32_t*>(qs + a.nq_pad * qrs) + warp * R;
  const T* kb = static_cast<const T*>(a.k) + bi * a.sk_b + hi * a.sk_h;
  const uint8_t* vb = a.valid + bi * a.sv_b;
  float* ob = a.out + ((long long)bi * a.n_kv + hi) * a.T;
  const float* qcol = a.qbar + bi * a.sq_b + hi * a.sq_h + tid * a.sq_d;

  // this lane's chunks of a slice: 16 rows x CH chunks, 32 at a time, so
  // each lane copies CH / 2 of them (CH is even); row r0, chunk c0 first,
  // then dr rows and dc chunks on per copy, one row more on a wrap.
  // Chunks c >= CK lie past the head dim: zero-filled, never read
  constexpr int EPC = 16 / sizeof(T);  // elements per chunk
  const int CH = a.d / EPC, CK = a.dk / EPC;
  const int r0 = lane / CH, c0 = lane % CH, dr = 32 / CH, dc = 32 % CH;
  const long long src_step = dr * a.sk_t + dc * EPC;
  const long long src_wrap = a.sk_t - CH * EPC;
  const int dst_step = dr * rs + dc * 16, dst_wrap = rs - CH * 16;
  auto first_key = [&](int j) {
    return (chunk + j * a.n_chunks) * tile_keys + warp * KEYS;
  };
  // valid bytes, VW slices per round trip: bit i of vbits is the byte of
  // key lane % 16 of slice w0 + i (0 past the walk or past T)
  constexpr int VW = 8;
  auto fetch_valid = [&](int j0) {
    uint32_t bits = 0;
#pragma unroll
    for (int i = 0; i < VW; ++i) {
      const int t = first_key(j0 + i) + (lane & 15);
      uint8_t v = 0;
      if (j0 + i < nt && t < a.T) v = vb[t * a.sv_t];
      bits |= static_cast<uint32_t>(v != 0) << i;
    }
    return bits;
  };
  int w0 = 0;
  uint32_t vbits = fetch_valid(0);
  // slice j of this warp into ring slot j % R (j increases by one per
  // call), one cp.async group; its valid bits into vmask (lane 0 writes,
  // the whole warp reads after a __syncwarp).  A row whose slot is invalid
  // is zero-filled, not read; a slice with no valid slot copies nothing.
  auto load = [&](int j) {
    if (j < nt) {
      if (j - w0 >= VW) {
        w0 = j;
        vbits = fetch_valid(j);
      }
      const uint32_t m =
          __ballot_sync(0xffffffffu, (vbits >> (j - w0)) & 1) & 0xffffu;
      if (lane == 0) vmask[j % R] = m;
      if (m != 0) {
        const T* src =
            kb + (long long)(first_key(j) + r0) * a.sk_t + c0 * EPC;
        uint32_t dst =
            smem_u32(ring + (j % R) * KEYS * rs) + r0 * rs + c0 * 16;
        int r = r0, c = c0;
        for (int u = 0; u < CH / 2; ++u) {
          const bool live = ((m >> r) & 1) && c < CK;
          cp_async16(dst, live ? src : kb, live);
          src += src_step;
          dst += dst_step;
          r += dr;
          c += dc;
          if (c >= CH) {
            c -= CH;
            ++r;
            src += src_wrap;
            dst += dst_wrap;
          }
        }
      }
    }
    cp_commit();
  };

  // prologue: q̄'s first 16 rows of this thread's column in flight, then
  // the copies of the first R slices, then q̄ into shared memory (its
  // other row blocks and columns, if any, after)
  float q0[NB];
  if (tid < a.d) load_q(q0, qcol, tid, 0, a);
  for (int j = 0; j < R; ++j) load(j);
  for (int e = tid; e < a.d; e += blockDim.x) {
    unsigned char* dst = qs + e * static_cast<int>(sizeof(T));
    for (int n0 = 0; n0 < a.nq_pad; n0 += NB) {
      if (e != tid || n0 != 0)
        load_q(q0, qcol + (e - tid) * a.sq_d, e, n0, a);
      store_q_rows<T>(dst + n0 * qrs, q0, qrs);
    }
  }
  __syncthreads();

  for (int j = 0; j < nt; ++j) {
    cp_wait<R - 1>();  // this lane's copies of slice j have landed
    __syncwarp();      // everyone's have
    const int slot = j % R, t0 = first_key(j);
    const uint32_t m = vmask[slot];
    float res = NEG_INF;  // lanes 0-15: key t0 + lane
    if (m != 0) {
      const unsigned char* ks = ring + slot * KEYS * rs;
      if constexpr (sizeof(T) == 2) {
        float best[2], sq[2];
        slice_bf16(smem_u32(ks), smem_u32(qs), rs, qrs, a.d, a.nq_pad, best,
                   sq);
        const float s0 = best[0] * rsqrtf(sq[0] + 1e-16f);
        const float s1 = best[1] * rsqrtf(sq[1] + 1e-16f);
        // row l of the slice sits in quad l % 8, value l / 8
        const float v0 = __shfl_sync(0xffffffffu, s0, (lane & 7) * 4);
        const float v1 = __shfl_sync(0xffffffffu, s1, (lane & 7) * 4);
        res = (lane & 8) ? v1 : v0;
      } else {
        float best, sq;
        slice_f32(ks, qs, rs, qrs, a.d, a.nq_pad, best, sq);
        res = best * rsqrtf(sq + 1e-16f);
      }
      if (!((m >> (lane & 15)) & 1)) res = NEG_INF;
    }
    if (lane < 16 && t0 + lane < a.T) ob[t0 + lane] = res;
    __syncwarp();  // slot j % R is free: every lane is done reading it
    load(j + R);
  }
}

// the kernel's shared-memory limit is a per-device attribute: raised once
// per device and instantiation to the card's opt-in maximum
template <typename T, int R>
static cudaError_t launch(const Args& a, int b, int warps,
                          cudaStream_t stream) {
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes<T>(a.d, a.nq_pad, warps, R);
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  if (dev >= 64 || !((configured >> dev) & 1ull)) {
    e = cudaFuncSetAttribute(score_kernel<T, R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
    if (e != cudaSuccess) return e;
    if (dev < 64) configured |= 1ull << dev;
  }
  dim3 grid(a.n_chunks, a.n_kv, b);
  score_kernel<T, R><<<grid, warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t run(const Args& a, int b, int warps, int stages,
                       cudaStream_t s) {
  const int tile_keys = warps * KEYS;
  const int n_tiles = (a.T + tile_keys - 1) / tile_keys;
  if (b < 1 || a.n_kv < 1 || a.T < 1 || a.dk % 8 || a.dk < 8 ||
      a.d != (a.dk + 15) / 16 * 16 || a.d > MAX_D || a.n_q < 1 ||
      a.nq_pad < a.n_q || a.nq_pad % NB ||
      warps < 1 || warps > MAX_WARPS || a.n_chunks < 1 ||
      a.n_chunks > n_tiles)
    return cudaErrorInvalidValue;
  if (stages == 2) return launch<T, 2>(a, b, warps, s);
  if (stages == 3) return launch<T, 3>(a, b, warps, s);
  return cudaErrorInvalidValue;
}

}  // namespace quoka_score

// dtype: 0 = float32, 1 = bfloat16 (k).  d: the head dim, a multiple of 8
// up to 576 (staged at the multiple of 16 at or above it).  qbar (b, n_kv,
// n_q, d) fp32 and valid (b, T) are any strided views;
// k (b, n_kv, T, d) has a contiguous head dim and 16-byte aligned rows; out
// (b, n_kv, T) fp32 contiguous.  warps, stages (the ring's slots), n_chunks
// and nq_pad come from tiling.score_geometry.  Returns cudaGetLastError().
extern "C" int quoka_score_launch(
    int dtype, int d, const void* qbar, const void* k,
    const void* valid, void* out, int b, int n_kv, int n_q, int T,
    long long sq_b, long long sq_h, long long sq_n, long long sq_d,
    long long sk_b, long long sk_h, long long sk_t, long long sv_b,
    long long sv_t, int warps, int stages, int n_chunks, int nq_pad,
    void* stream) {
  using namespace quoka_score;
  const Args a{static_cast<const float*>(qbar), k,
               static_cast<const uint8_t*>(valid),
               static_cast<float*>(out), n_kv, n_q, nq_pad, T,
               (d + 15) / 16 * 16, d, n_chunks,
               sq_b, sq_h, sq_n, sq_d, sk_b, sk_h, sk_t, sv_b, sv_t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0) e = run<float>(a, b, warps, stages, s);
  if (dtype == 1) e = run<__nv_bfloat16>(a, b, warps, stages, s);
  return static_cast<int>(e);
}
