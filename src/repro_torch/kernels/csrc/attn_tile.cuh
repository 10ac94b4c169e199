// Shared online-softmax attention tile for the fp32 launches of the flash,
// selected and paged attention kernels (flash_attention.cu,
// selected_attention.cu, selected_attention_paged.cu); their bf16 launches
// run on the tensor-core tile of attn_mma.cuh, which shares AttnIO and the
// key-map contract below.
//
// One thread block computes BQ query rows of one (batch, query head) against
// a sequence of "logical keys".  The caller's key map turns a logical key
// index into the element offsets of its K and V rows and into `min_i`, the
// smallest query row allowed to attend it (NEVER = masked for every row):
//
//     attend(i, key) iff i >= min_i(key)
//
// which expresses both kernels' masks: a valid unconditioned key has
// min_i = 0, a causal chunk key at chunk-local index j has min_i = j.
//
// Per K tile of BK keys: BK threads resolve the tile's row offsets and masks
// into shared memory, all threads stage K and V (fp32) in shared memory,
// each group of 8 lanes owns one query row (BK / 8 scores per lane, D/8
// output columns per lane), and the running max / sum / accumulator stay in
// registers in fp32.  Masked logits are the finite NEG_INF and p is
// re-masked explicitly, so a row that attends nothing keeps l == 0 and
// writes exact zeros, never NaN.
//
// Head dims: the tiles take every head dim d that is a multiple of 8 in
// [8, 128] (the reference's kernels take any d).  Each is instantiated at
// D, the multiple of 16 at or above d (with_head_dim), and reads the true
// d at run time: Q and K columns past d are zero-filled in shared memory
// (a zero column changes no dot product), V's are zero too, and output
// columns past d are never written.  V and the output may be narrower
// than Q and K (`dv` <= d, a multiple of 8: MLA's latent values beside its
// [latent | rope] keys); V's columns past dv read as zero and output
// columns past dv are not written.  The flash kernel also instantiates
// D = 576 (MLA's key width) with a key tile of BK_WIDE keys, whose
// shared memory is opted into above the default 48 KiB.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace quoka {

constexpr float NEG_INF = -1e30f;
constexpr int NEVER = 0x7fffffff;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

template <typename T>
struct AttnIO {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  long long sq_b, sq_h, sq_t;  // q strides in elements; head dim contiguous
  long long so_b, so_h, so_t;  // output strides
  int tq;                      // query rows
  int group;                   // query heads per KV head
  int n_keys;                  // logical keys the map walks
  float scale;
  int d;                       // head dim of q, k: a multiple of 8 <= D
  int dv;                      // columns of v and the output, <= d
};

// Calls f(std::integral_constant<int, D>) with D the instantiated width of
// head dim d (the multiple of 16 at or above it); d not a multiple of 8 in
// [8, 128] is refused.
template <class F>
static cudaError_t with_head_dim(int d, F&& f) {
  if (d < 8 || d > 128 || d % 8) return cudaErrorInvalidValue;
  switch ((d + 15) / 16) {
    case 1: return f(std::integral_constant<int, 16>());
    case 2: return f(std::integral_constant<int, 32>());
    case 3: return f(std::integral_constant<int, 48>());
    case 4: return f(std::integral_constant<int, 64>());
    case 5: return f(std::integral_constant<int, 80>());
    case 6: return f(std::integral_constant<int, 96>());
    case 7: return f(std::integral_constant<int, 112>());
    case 8: return f(std::integral_constant<int, 128>());
  }
  return cudaErrorInvalidValue;
}

constexpr int BQ = 16;       // query rows per block
constexpr int BK = 32;       // keys per tile up to D = 128
constexpr int BK_WIDE = 16;  // keys per tile at D = 576 (shared memory)
constexpr int NT = 128;      // threads per block: 8 lanes per query row

// Bytes of one block's dynamic shared memory: Q, K (rows padded by one
// float), V and the tile's probabilities.
template <int D, int TBK>
constexpr int tile_smem() {
  return 4 * (BQ * (D + 1) + TBK * (D + 1) + TBK * D + BQ * (TBK + 1));
}

template <typename T, int D, int TBK, class Map>
__global__ void __launch_bounds__(NT) attn_tile_kernel(AttnIO<T> io, Map map) {
  constexpr int E = D / 8;     // output columns per lane
  constexpr int KPL = TBK / 8; // keys per lane in a tile
  extern __shared__ float fsm[];
  float(*Qs)[D + 1] = reinterpret_cast<float(*)[D + 1]>(fsm);
  float(*Ks)[D + 1] = reinterpret_cast<float(*)[D + 1]>(fsm + BQ * (D + 1));
  float(*Vs)[D] =
      reinterpret_cast<float(*)[D]>(fsm + (BQ + TBK) * (D + 1));
  float(*Ps)[TBK + 1] = reinterpret_cast<float(*)[TBK + 1]>(
      fsm + (BQ + TBK) * (D + 1) + TBK * D);
  __shared__ long long koff[TBK];
  __shared__ long long voff[TBK];
  __shared__ int kmin[TBK];

  const int tid = threadIdx.x;
  const int bi = blockIdx.z;
  const int hi = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int hk = hi / io.group;
  const int r = tid >> 3;   // query row of this lane within the tile
  const int c8 = tid & 7;   // lane within the row's group of 8
  const int qi = q0 + r;

  for (int x = tid; x < BQ * D; x += NT) {
    const int rr = x / D, dd = x % D;
    const int row = q0 + rr;
    float val = 0.f;
    if (row < io.tq && dd < io.d)
      val = to_f(io.q[bi * io.sq_b + hi * io.sq_h + row * io.sq_t + dd]);
    Qs[rr][dd] = val * io.scale;
  }

  float m = NEG_INF, l = 0.f;
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  const int n_tiles = (io.n_keys + TBK - 1) / TBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // the previous tile is consumed, Q is staged
    if (tid < TBK) {
      const int key = kt * TBK + tid;
      long long ko = 0, vo = 0;
      int mi = NEVER;
      if (key < io.n_keys) map.key(bi, hk, key, ko, vo, mi);
      koff[tid] = ko;
      voff[tid] = vo;
      kmin[tid] = mi;
    }
    __syncthreads();
    for (int x = tid; x < TBK * D; x += NT) {
      const int c = x / D, dd = x % D;
      Ks[c][dd] = dd < io.d ? to_f(io.k[koff[c] + dd]) : 0.f;
      Vs[c][dd] = dd < io.dv ? to_f(io.v[voff[c] + dd]) : 0.f;
    }
    __syncthreads();

    float s[KPL];
#pragma unroll
    for (int j = 0; j < KPL; ++j) s[j] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      const float qv = Qs[r][dd];
#pragma unroll
      for (int j = 0; j < KPL; ++j) s[j] += qv * Ks[c8 + 8 * j][dd];
    }
    bool ok[KPL];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      ok[j] = qi < io.tq && qi >= kmin[c8 + 8 * j];
      s[j] = ok[j] ? s[j] : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const float p = ok[j] ? expf(s[j] - m_new) : 0.f;  // explicit re-mask
      Ps[r][c8 + 8 * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 4);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    const float alpha = expf(m - m_new);
    l = alpha * l + psum;
    m = m_new;
    __syncwarp();  // a row's P is written and read by the same warp
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= alpha;
    for (int c = 0; c < TBK; ++c) {
      const float p = Ps[r][c];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] += p * Vs[c][c8 + 8 * e];
    }
  }

  if (qi < io.tq) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* op = io.o + bi * io.so_b + hi * io.so_h + qi * io.so_t;
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (c8 + 8 * e < io.dv)
        op[c8 + 8 * e] = from_f<T>(l > 0.f ? acc[e] * inv : 0.f);
  }
}

// fp32 launch at width D with key tiles of TBK keys (BK up to D = 128).
// static: the `configured` bits stay private to each library that includes
// this header.
template <typename T, int D, class Map, int TBK = BK>
static cudaError_t launch_attn(const AttnIO<T>& io, const Map& map, int b,
                               int h, cudaStream_t stream) {
  constexpr int SMEM = tile_smem<D, TBK>();
  if (io.dv > io.d || io.dv % 8 || io.d > D) return cudaErrorInvalidValue;
  if (SMEM > 48 * 1024) {
    // above 48 KiB a kernel must opt in, once per device
    static unsigned long long configured = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= 64 || !((configured >> dev) & 1ull)) {
      e = cudaFuncSetAttribute(attn_tile_kernel<T, D, TBK, Map>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
      if (e != cudaSuccess) return e;
      if (dev < 64) configured |= 1ull << dev;
    }
  }
  dim3 grid((io.tq + BQ - 1) / BQ, h, b);
  attn_tile_kernel<T, D, TBK, Map><<<grid, NT, SMEM, stream>>>(io, map);
  return cudaGetLastError();
}

}  // namespace quoka
