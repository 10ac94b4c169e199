// Gather-free selected attention: the chunk's queries attend over
// [plan-selected KV | causal chunk] read in place from the linear KV cache.
//
// Replaces: src/repro/kernels/selected_attention.py, selected_attention_bhtd
// (the Pallas TPU kernel: _kernel, _masks, _k_tile), linear cache view only.
// The paged variant is selected_attention_paged.cu.
//
// The walk has two parts over "logical keys":
//   selected  nb * g keys: plan id s covers cache rows id*g .. id*g+g-1 (an
//             id of -1 reads row 0 and is masked); a key is attended iff
//             pos >= 0 and pos < start and id >= 0.
//   chunk     t keys: cache rows start .. start+t-1, chunk-local index
//             j_loc; attended by query row i iff j_loc <= i and pos >= 0.
// These are exactly the reference's _masks.  On the TPU the chunk walk
// streamed bk-aligned tiles from start rounded down and bounded j_loc;
// here each key row is addressed on its own, so the walk starts at `start`
// and the same bound holds by construction.  The plan ids and `start` are
// read by each block from global memory (the TPU's scalar prefetch).
//
// Bound on the H100 at the main-path shape (qwen3-4b, g=16, budget 1024,
// chunk t=128, h=32, n_kv=8, d=128, bf16): 2.4 GFLOP against 6.7 MB (q, the
// 1152 selected and chunk rows of K and V per KV head, out), so bound by
// operations at tensor-core rates; decode (t=1) is bound by the bytes.
// bf16 runs on the tensor-core tile of attn_mma.cuh (shared with the
// flash and paged kernels): one block per (b, KV head, 64 of the group's
// query (head, row) pairs), so each gathered K/V row is staged once for
// the whole GQA group; mma.sync bf16 products with fp32 accumulation; a
// cp.async K/V ring whose row offsets (plan id -> cache row, pos and start
// checks) a resolver warp computes tiles ahead; keys masked for every row
// (-1 ids, unwritten or future slots) zero-filled instead of read; the key
// walk split across blocks with a merge kernel when the blocks do not fill
// the card (decode).  fp32 stays on attn_tile.cuh.
#include "attn_mma.cuh"

namespace quoka {

struct SelectedMap {
  long long sk_b, sk_h, sk_t;
  long long sv_b, sv_h, sv_t;
  const int* key_pos;  // (b, T) contiguous
  const int* ids;      // (b, n_kv, nb) with strides; si_h == 0 when shared
  long long si_b, si_h;
  const int* start;    // (b,)
  int nb, g, T, t;

  __device__ __forceinline__ void key(int b, int hk, int lk, long long& ko,
                                      long long& vo, int& min_i) const {
    const int st = start[b];
    const int n_sel = nb * g;
    int row;
    bool ok;
    int mi;
    if (lk < n_sel) {
      const int id = ids[b * si_b + hk * si_h + lk / g];
      row = (id < 0 ? 0 : id) * g + lk % g;
      ok = id >= 0 && row < T;
      if (!ok) row = 0;
      const int p = key_pos[(long long)b * T + row];
      ok = ok && p >= 0 && p < st;
      mi = 0;
    } else {
      const int j_loc = lk - n_sel;
      row = st + j_loc;
      ok = row >= 0 && row < T && j_loc < t;
      if (!ok) row = 0;
      ok = ok && key_pos[(long long)b * T + row] >= 0;
      mi = j_loc;
    }
    ko = b * sk_b + hk * sk_h + row * sk_t;
    vo = b * sv_b + hk * sv_h + row * sv_t;
    min_i = ok ? mi : NEVER;
  }
};

static cudaError_t run(int d, const AttnIO<float>& io, const SelectedMap& map,
                       int b, int h, cudaStream_t s) {
  return with_head_dim(d, [&](auto D) {
    return launch_attn<float, decltype(D)::value>(io, map, b, h, s);
  });
}

static cudaError_t run_mma(int d, const AttnIO<__nv_bfloat16>& io,
                           const SelectedMap& map, int b, int n_kv, int n_split,
                           float* part_o, float* part_ml, cudaStream_t s) {
  return with_head_dim(d, [&](auto D) {
    return launch_attn_mma<decltype(D)::value>(io, map, b, n_kv, n_split,
                                               part_o, part_ml, s);
  });
}

}  // namespace quoka

// dtype: 0 = float32, 1 = bfloat16.  q (b, h, t, d) and k, v (b, n_kv, T, d)
// are strided views with a contiguous head dim; key_pos (b, T) int32;
// ids (b, n_kv, nb) int32 (block ids at g > 1, token slots at g == 1);
// start (b,) int32.  bf16 only: n_split from
// tiling.attn_geometry, part_o / part_ml the fp32 scratch of a split walk
// (null when n_split == 1).  Returns cudaGetLastError() after the launches.
extern "C" int selected_attention_launch(
    int dtype, int d, const void* q, const void* k, const void* v,
    const void* key_pos, const void* ids, const void* start, void* out, int b,
    int h, int n_kv, int t, int T, int nb, int g, long long sq_b,
    long long sq_h, long long sq_t, long long sk_b, long long sk_h,
    long long sk_t, long long sv_b, long long sv_h, long long sv_t,
    long long si_b, long long si_h, long long so_b, long long so_h,
    long long so_t, float scale, int n_split, void* part_o,
    void* part_ml, void* stream) {
  using namespace quoka;
  SelectedMap map{sk_b, sk_h, sk_t, sv_b, sv_h, sv_t,
                  static_cast<const int*>(key_pos),
                  static_cast<const int*>(ids), si_b, si_h,
                  static_cast<const int*>(start), nb, g, T, t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_keys = nb * g + t;
  if (dtype == 0) {
    AttnIO<float> io{static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<float*>(out),
                     sq_b, sq_h, sq_t, so_b, so_h, so_t, t, h / n_kv, n_keys,
                     scale, d, d};
    return static_cast<int>(run(d, io, map, b, h, s));
  }
  if (dtype == 1) {
    AttnIO<__nv_bfloat16> io{static_cast<const __nv_bfloat16*>(q),
                             static_cast<const __nv_bfloat16*>(k),
                             static_cast<const __nv_bfloat16*>(v),
                             static_cast<__nv_bfloat16*>(out),
                             sq_b, sq_h, sq_t, so_b, so_h, so_t, t, h / n_kv,
                             n_keys, scale, d, d};
    return static_cast<int>(run_mma(d, io, map, b, n_kv, n_split,
                                    static_cast<float*>(part_o),
                                    static_cast<float*>(part_ml), s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
