// Flash attention over QUOKA's [selected budget | causal chunk] key layout.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_bhtd (the
// Pallas TPU kernel, body _kernel).  attend(i, j) iff k_valid[j] and (not
// causal or j < boundary or j - boundary <= i); rows that attend nothing
// write exact zeros.  `boundary` is a runtime int here (it was static on the
// TPU) and k_valid is per KV head, with a zero head stride when shared.
//
// Bound on the H100 at the main-path shape (qwen3-4b prefill chunk: b=1,
// h=32, h_kv=8, tq=128, tk=1152, d=128, bf16): about 2.4 GFLOP against 6.7 MB
// of inputs and output, so it is bound by operations at tensor-core rates
// (2.4 us at 989 TFLOP/s; the bytes take 2.0 us at 3.35 TB/s).  Decode
// (tq=1) is bound by the 4.7 MB of K/V instead.
//
// This first design is the simple one: one block per (b, h, 16-row q tile),
// K/V tiles of 32 keys staged in shared memory as fp32, and the products on
// the CUDA cores in fp32 (attn_tile.cuh).  It reads each KV tile once per
// query head and per q tile, and does not use the tensor cores; wgmma/TMA
// tiles with a GQA group per block are the later, faster design.
#include "attn_tile.cuh"

namespace quoka {

struct FlashMap {
  long long sk_b, sk_h, sk_t;
  long long sv_b, sv_h, sv_t;
  const uint8_t* valid;  // (b, h_kv, tk) bool; sva_h == 0 when shared
  long long sva_b, sva_h;
  int causal, boundary;

  __device__ __forceinline__ void key(int b, int hk, int j, long long& ko,
                                      long long& vo, int& min_i) const {
    ko = b * sk_b + hk * sk_h + j * sk_t;
    vo = b * sv_b + hk * sv_h + j * sv_t;
    if (!valid[b * sva_b + hk * sva_h + j]) {
      min_i = NEVER;
    } else {
      min_i = (!causal || j < boundary) ? 0 : j - boundary;
    }
  }
};

template <typename T>
static cudaError_t run(int d, const AttnIO<T>& io, const FlashMap& map, int b,
                       int h, cudaStream_t s) {
  if (d == 64) return launch_attn<T, 64>(io, map, b, h, s);
  if (d == 128) return launch_attn<T, 128>(io, map, b, h, s);
  return cudaErrorInvalidValue;
}

}  // namespace quoka

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the head dim
// of q, k, v and out is contiguous.  Returns cudaGetLastError() after the
// launch on `stream`.
extern "C" int flash_attention_launch(
    int dtype, int d, const void* q, const void* k, const void* v,
    const void* valid, void* out, int b, int h, int h_kv, int tq, int tk,
    long long sq_b, long long sq_h, long long sq_t, long long sk_b,
    long long sk_h, long long sk_t, long long sv_b, long long sv_h,
    long long sv_t, long long sva_b, long long sva_h, long long so_b,
    long long so_h, long long so_t, int causal, int boundary, float scale,
    void* stream) {
  using namespace quoka;
  FlashMap map{sk_b, sk_h, sk_t, sv_b, sv_h, sv_t,
               static_cast<const uint8_t*>(valid), sva_b, sva_h, causal,
               boundary};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    AttnIO<float> io{static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<float*>(out),
                     sq_b, sq_h, sq_t, so_b, so_h, so_t, tq, h / h_kv, tk,
                     scale};
    return static_cast<int>(run<float>(d, io, map, b, h, s));
  }
  if (dtype == 1) {
    AttnIO<__nv_bfloat16> io{static_cast<const __nv_bfloat16*>(q),
                             static_cast<const __nv_bfloat16*>(k),
                             static_cast<const __nv_bfloat16*>(v),
                             static_cast<__nv_bfloat16*>(out),
                             sq_b, sq_h, sq_t, so_b, so_h, so_t, tq, h / h_kv,
                             tk, scale};
    return static_cast<int>(run<__nv_bfloat16>(d, io, map, b, h, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
