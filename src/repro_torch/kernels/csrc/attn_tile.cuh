// Shared online-softmax attention tile for the flash and selected-attention
// kernels (flash_attention.cu, selected_attention.cu).
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
// Per K tile of BK keys: 32 threads resolve the tile's row offsets and masks
// into shared memory, all threads stage K and V (fp32) in shared memory,
// each group of 8 lanes owns one query row (4 scores per lane, D/8 output
// columns per lane), and the running max / sum / accumulator stay in
// registers in fp32.  Masked logits are the finite NEG_INF and p is
// re-masked explicitly, so a row that attends nothing keeps l == 0 and
// writes exact zeros, never NaN.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace quoka {

constexpr float NEG_INF = -1e30f;
constexpr int NEVER = 0x7fffffff;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
};

constexpr int BQ = 16;   // query rows per block
constexpr int BK = 32;   // keys per tile
constexpr int NT = 128;  // threads per block: 8 lanes per query row

template <typename T, int D, class Map>
__global__ void __launch_bounds__(NT) attn_tile_kernel(AttnIO<T> io, Map map) {
  constexpr int E = D / 8;  // output columns per lane
  __shared__ float Qs[BQ][D + 1];
  __shared__ float Ks[BK][D + 1];
  __shared__ float Vs[BK][D];
  __shared__ float Ps[BQ][BK + 1];
  __shared__ long long koff[BK];
  __shared__ long long voff[BK];
  __shared__ int kmin[BK];

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
    if (row < io.tq)
      val = to_f(io.q[bi * io.sq_b + hi * io.sq_h + row * io.sq_t + dd]);
    Qs[rr][dd] = val * io.scale;
  }

  float m = NEG_INF, l = 0.f;
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  const int n_tiles = (io.n_keys + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // the previous tile is consumed, Q is staged
    if (tid < BK) {
      const int key = kt * BK + tid;
      long long ko = 0, vo = 0;
      int mi = NEVER;
      if (key < io.n_keys) map.key(bi, hk, key, ko, vo, mi);
      koff[tid] = ko;
      voff[tid] = vo;
      kmin[tid] = mi;
    }
    __syncthreads();
    for (int x = tid; x < BK * D; x += NT) {
      const int c = x / D, dd = x % D;
      Ks[c][dd] = to_f(io.k[koff[c] + dd]);
      Vs[c][dd] = to_f(io.v[voff[c] + dd]);
    }
    __syncthreads();

    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      const float qv = Qs[r][dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] += qv * Ks[c8 + 8 * j][dd];
    }
    bool ok[4];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
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
    for (int j = 0; j < 4; ++j) {
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
    for (int c = 0; c < BK; ++c) {
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
      op[c8 + 8 * e] = from_f<T>(l > 0.f ? acc[e] * inv : 0.f);
  }
}

template <typename T, int D, class Map>
inline cudaError_t launch_attn(const AttnIO<T>& io, const Map& map, int b,
                               int h, cudaStream_t stream) {
  dim3 grid((io.tq + BQ - 1) / BQ, h, b);
  attn_tile_kernel<T, D, Map><<<grid, NT, 0, stream>>>(io, map);
  return cudaGetLastError();
}

}  // namespace quoka
