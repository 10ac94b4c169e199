// Fused QUOKA key scoring (paper Algorithm 1 lines 7-10).
//
// Replaces: src/repro/kernels/quoka_score.py, quoka_score_bhtd (the Pallas
// TPU kernel, body _kernel).  For every cached key: L2 norm (rsqrt of
// sum k^2 + 1e-16), dot with each pre-aggregated normalised query q̄, max
// over the n_q queries, NEG_INF = -1e30 where `valid` is false.  The output
// is fp32 (b, n_kv, T); the (n_q x T) score matrix never reaches memory.
//
// Bound on the H100 at the main-path shape (qwen3-4b prefill: b=1, n_kv=8,
// T=8224 cache slots, n_q=16, d=128, bf16): the kernel must read the valid
// key rows (at most 16.8 MB of K, the whole cap; the cap's future slots are
// invalid, so about half of it on average over a prefill) and write 0.26 MB
// of scores for at most 0.29 GFLOP, so it is bound by bytes (at most about
// 5 us at 3.35 TB/s).  Decode has n_q=1 and reads nearly the whole cap.
//
// Simple design: one block of 8 warps per (b, n_kv head, 64-key tile); q̄
// (n_q x d, a few KB) is resident in shared memory as fp32; each warp takes
// one key at a time, skips it when invalid, else every lane holds d/32
// elements of it (one coalesced read of the row), and warp shuffles reduce
// the norm and each query's dot in fp32.  No n_q padding is needed (the
// TPU's edge-copy pad only served its 8-row tiling).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace quoka_score {

constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 8;
constexpr int KEYS_PER_BLOCK = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32) score_kernel(
    const T* qbar, const T* k, const uint8_t* valid, float* out, int n_kv,
    int n_q, int T_len, long long sq_b, long long sq_h, long long sq_n,
    long long sk_b, long long sk_h, long long sk_t, long long sva_b) {
  constexpr int E = D / 32;
  extern __shared__ float qs[];  // (n_q, D)
  const int bi = blockIdx.z, hi = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int x = tid; x < n_q * D; x += WARPS * 32) {
    const int n = x / D, dd = x % D;
    qs[x] = to_f(qbar[bi * sq_b + hi * sq_h + n * sq_n + dd]);
  }
  __syncthreads();

  const int t0 = blockIdx.x * KEYS_PER_BLOCK;
  const int t1 = min(t0 + KEYS_PER_BLOCK, T_len);
  for (int t = t0 + warp; t < t1; t += WARPS) {
    // an invalid slot scores NEG_INF whatever its key holds, so its row is
    // never read: most of the cap is future slots in early chunks
    if (!valid[bi * sva_b + t]) {
      if (lane == 0) out[((long long)bi * n_kv + hi) * T_len + t] = NEG_INF;
      continue;
    }
    const T* kp = k + bi * sk_b + hi * sk_h + t * sk_t;
    float kv[E];
    float sq = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      kv[e] = to_f(kp[lane + 32 * e]);
      sq += kv[e] * kv[e];
    }
    sq = warp_sum(sq);
    float best = -INFINITY;
    for (int n = 0; n < n_q; ++n) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) dot += qs[n * D + lane + 32 * e] * kv[e];
      best = fmaxf(best, warp_sum(dot));
    }
    if (lane == 0)
      out[((long long)bi * n_kv + hi) * T_len + t] = best * rsqrtf(sq + 1e-16f);
  }
}

template <typename T>
static cudaError_t run(int d, const T* qbar, const T* k, const uint8_t* valid,
                       float* out, int b, int n_kv, int n_q, int T_len,
                       long long sq_b, long long sq_h, long long sq_n,
                       long long sk_b, long long sk_h, long long sk_t,
                       long long sva_b, cudaStream_t s) {
  dim3 grid((T_len + KEYS_PER_BLOCK - 1) / KEYS_PER_BLOCK, n_kv, b);
  const size_t smem = sizeof(float) * n_q * d;
  if (d == 64) {
    score_kernel<T, 64><<<grid, WARPS * 32, smem, s>>>(
        qbar, k, valid, out, n_kv, n_q, T_len, sq_b, sq_h, sq_n, sk_b, sk_h,
        sk_t, sva_b);
  } else if (d == 128) {
    score_kernel<T, 128><<<grid, WARPS * 32, smem, s>>>(
        qbar, k, valid, out, n_kv, n_q, T_len, sq_b, sq_h, sq_n, sk_b, sk_h,
        sk_t, sva_b);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace quoka_score

// dtype: 0 = float32, 1 = bfloat16 (qbar and k share it).  qbar
// (b, n_kv, n_q, d) and k (b, n_kv, T, d) are strided views with a
// contiguous head dim; valid (b, T) bool with row stride sva_b; out
// (b, n_kv, T) fp32 contiguous.  Returns cudaGetLastError().
extern "C" int quoka_score_launch(int dtype, int d, const void* qbar,
                                  const void* k, const void* valid, void* out,
                                  int b, int n_kv, int n_q, int T,
                                  long long sq_b, long long sq_h,
                                  long long sq_n, long long sk_b,
                                  long long sk_h, long long sk_t,
                                  long long sva_b, void* stream) {
  using namespace quoka_score;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* va = static_cast<const uint8_t*>(valid);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    return static_cast<int>(run<float>(
        d, static_cast<const float*>(qbar), static_cast<const float*>(k), va,
        o, b, n_kv, n_q, T, sq_b, sq_h, sq_n, sk_b, sk_h, sk_t, sva_b, s));
  if (dtype == 1)
    return static_cast<int>(run<__nv_bfloat16>(
        d, static_cast<const __nv_bfloat16*>(qbar),
        static_cast<const __nv_bfloat16*>(k), va, o, b, n_kv, n_q, T, sq_b,
        sq_h, sq_n, sk_b, sk_h, sk_t, sva_b, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
