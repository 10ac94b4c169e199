// Flash attention over QUOKA's [selected budget | causal chunk] key layout.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_bhtd (the
// Pallas TPU kernel, body _kernel).  attend(i, j) iff k_valid[j] and (not
// causal or j < boundary or j - boundary <= i); rows that attend nothing
// write exact zeros.  `boundary` is a runtime int here (it was static on the
// TPU) and k_valid is per KV head, with a zero head stride when shared.
// Head dims: every multiple of 8 in [8, 128], as the reference's any d up
// to there (with_head_dim, attn_tile.cuh), and 576 on MLA's wide tile
// (with_flash_head_dim): MLA attends its absorbed
// queries over [latent | rope] keys 576 wide.  V may be narrower than the
// keys (dv <= d): MLA passes its 512-wide latent, where the reference pads
// it with zeros to 576 and slices the output.
//
// Bound on the H100 at the main-path shape (qwen3-4b prefill chunk: b=1,
// h=32, h_kv=8, tq=128, tk=1152, d=128, bf16): about 2.4 GFLOP against 6.7 MB
// of inputs and output, so it is bound by operations at tensor-core rates
// (2.4 us at 989 TFLOP/s; the bytes take 2.0 us at 3.35 TB/s).  Decode
// (tq=1) is bound by the 4.2 MB of K/V instead.  MLA's prefill (deepseek-v3:
// 128 heads over one latent KV head, tq=128, tk=1152, d=576, dv=512) does
// ~39 GFLOP (0.039 ms at 989 TFLOP/s); its decode reads ~1.1 MB of K (V
// is a view of K's first 512 columns).
//
// bf16 runs on the tensor-core tile of attn_mma.cuh: one block per (b, KV
// head, 64 of the group's query (head, row) pairs), so each K/V tile is
// staged once for the whole GQA group; mma.sync bf16 products with fp32
// accumulation; a cp.async K/V ring fed by a warp that resolves the key
// offsets ahead; the key walk split across blocks, with a merge kernel,
// when the (b, KV head, row tile) blocks do not fill the card.  At d > 128
// the wide tile (mma::Wide) splits V's columns across blocks, each
// recomputing S over all key columns (attn_mma.cuh).  fp32 stays
// on the simple CUDA-core tile of attn_tile.cuh (tensor cores would round
// fp32 operands to TF32).
#include "attn_mma.cuh"

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

// Calls f(std::integral_constant<int, D>) with the instantiated width of
// head dim d: with_head_dim up to 128, and mma::WIDE_D itself.
template <class F>
static cudaError_t with_flash_head_dim(int d, F&& f) {
  if (d == mma::WIDE_D)
    return f(std::integral_constant<int, mma::WIDE_D>());
  return with_head_dim(d, f);
}

static cudaError_t run(int d, const AttnIO<float>& io, const FlashMap& map,
                       int b, int h, cudaStream_t s) {
  return with_flash_head_dim(d, [&](auto D) {
    constexpr int W = decltype(D)::value;
    return launch_attn<float, W, FlashMap, (W > 128 ? BK_WIDE : BK)>(
        io, map, b, h, s);
  });
}

// the bf16 tile of width W
template <int W>
struct FlashTile {
  using type = mma::Cfg<W>;
};
template <>
struct FlashTile<mma::WIDE_D> {
  using type = mma::Wide;
};

static cudaError_t run_mma(int d, const AttnIO<__nv_bfloat16>& io,
                           const FlashMap& map, int b, int h_kv, int n_split,
                           float* part_o, float* part_ml, cudaStream_t s) {
  return with_flash_head_dim(d, [&](auto D) {
    using C = typename FlashTile<decltype(D)::value>::type;
    return launch_attn_tile<C>(io, map, b, h_kv, n_split, part_o, part_ml,
                               s);
  });
}

}  // namespace quoka

// dtype: 0 = float32, 1 = bfloat16.  q, k (b, h | h_kv, t, d); v and out
// dv columns wide (dv <= d).  Strides are in elements; the last dim of q,
// k, v and out is contiguous.  bf16 only: n_split from
// tiling.attn_geometry, part_o / part_ml the fp32 scratch of a split walk
// (null when n_split == 1).  Returns cudaGetLastError() after the launches
// on `stream`.
extern "C" int flash_attention_launch(
    int dtype, int d, int dv, const void* q, const void* k, const void* v,
    const void* valid, void* out, int b, int h, int h_kv, int tq, int tk,
    long long sq_b, long long sq_h, long long sq_t, long long sk_b,
    long long sk_h, long long sk_t, long long sv_b, long long sv_h,
    long long sv_t, long long sva_b, long long sva_h, long long so_b,
    long long so_h, long long so_t, int causal, int boundary, float scale,
    int n_split, void* part_o, void* part_ml, void* stream) {
  using namespace quoka;
  FlashMap map{sk_b, sk_h, sk_t, sv_b, sv_h, sv_t,
               static_cast<const uint8_t*>(valid), sva_b, sva_h, causal,
               boundary};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    AttnIO<float> io{static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<float*>(out),
                     sq_b, sq_h, sq_t, so_b, so_h, so_t, tq, h / h_kv, tk,
                     scale, d, dv};
    return static_cast<int>(run(d, io, map, b, h, s));
  }
  if (dtype == 1) {
    AttnIO<__nv_bfloat16> io{static_cast<const __nv_bfloat16*>(q),
                             static_cast<const __nv_bfloat16*>(k),
                             static_cast<const __nv_bfloat16*>(v),
                             static_cast<__nv_bfloat16*>(out),
                             sq_b, sq_h, sq_t, so_b, so_h, so_t, tq, h / h_kv,
                             tk, scale, d, dv};
    return static_cast<int>(run_mma(d, io, map, b, h_kv, n_split,
                                    static_cast<float*>(part_o),
                                    static_cast<float*>(part_ml), s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
