// Gather-free selected attention read THROUGH a paged KV pool's block
// table: the chunk's queries attend over [plan-selected KV | causal chunk]
// whose rows live in the pool's physical blocks, in place.
//
// Replaces: src/repro/kernels/selected_attention.py, selected_attention_paged
// (the Pallas TPU kernel _paged_kernel with its block-table index maps).
//
// The logical cache of request b is its blocks in table order: logical row
// L lives in physical block table[b, L / bs], slot L % bs.  The walk over
// logical keys is exactly SelectedMap's (selected_attention.cu):
//   selected  nb * g keys: plan id s covers logical rows s*g .. s*g+g-1;
//             attended iff id >= 0 and pos >= 0 and pos < start;
//   chunk     t keys: logical rows start .. start+t-1, chunk-local index
//             j_loc; attended by query row i iff j_loc <= i and pos >= 0.
// On top of that, a logical row past nb_table * bs and a row whose table
// entry is -1 (unmapped) or not a block of the pool (>= n_pool) are masked
// before their pos is read: a recycled block can still hold a stale
// pos >= 0, which must not count, and no entry leads out of the pool.  A masked
// key points at block 0, slot 0 (always in bounds), which the shared tile
// stages and then ignores, as SelectedMap does with row 0.
//
// Bound on the H100 at the serve path's shape (qwen3-4b, g=16, budget 1024,
// chunk t=128, h=32, n_kv=8, d=128, bf16): as for the linear kernel, about
// 2.4 GFLOP per request row against ~7 MB, so bound by operations at
// tensor-core rates; decode (t=1) is bound by the bytes.  It runs on the
// linear kernel's tiles through a new key map: bf16 on the tensor-core tile
// of attn_mma.cuh, fp32 on attn_tile.cuh.  The per-key table lookup is one
// extra dependent load in the resolver warp's offset step, which runs tiles
// ahead of the loads; the split of the key walk depends only on the shapes,
// so the two kernels agree bit for bit on the same rows.
#include "attn_mma.cuh"

namespace quoka {

struct PagedMap {
  long long sk_n, sk_s, sk_h;  // k pool strides: block, slot, head
  long long sv_n, sv_s, sv_h;  // v pool strides
  const int* pos;    // (N, bs) contiguous pool positions
  const int* table;  // (b, nb_table) contiguous, -1 = unmapped
  const int* ids;    // (b, n_kv, nb) with strides; si_h == 0 when shared
  long long si_b, si_h;
  const int* start;  // (b,)
  int nb, g, bs, nb_table, n_pool, t;

  __device__ __forceinline__ void key(int b, int hk, int lk, long long& ko,
                                      long long& vo, int& min_i) const {
    const int st = start[b];
    const int n_sel = nb * g;
    const int T = nb_table * bs;
    int L;
    bool ok;
    int mi;
    bool sel = lk < n_sel;
    if (sel) {
      const int id = ids[b * si_b + hk * si_h + lk / g];
      L = (id < 0 ? 0 : id) * g + lk % g;
      ok = id >= 0 && L < T;
      mi = 0;
    } else {
      const int j_loc = lk - n_sel;
      L = st + j_loc;
      ok = L >= 0 && L < T && j_loc < t;
      mi = j_loc;
    }
    int phys = 0, slot = 0;
    if (ok) {
      phys = table[(long long)b * nb_table + L / bs];
      slot = L % bs;
      ok = phys >= 0 && phys < n_pool;
      if (!ok) phys = slot = 0;
    }
    if (ok) {
      const int p = pos[(long long)phys * bs + slot];
      ok = p >= 0 && (!sel || p < st);
    }
    ko = phys * sk_n + slot * sk_s + hk * sk_h;
    vo = phys * sv_n + slot * sv_s + hk * sv_h;
    min_i = ok ? mi : NEVER;
  }
};

static cudaError_t run(int d, const AttnIO<float>& io, const PagedMap& map,
                       int b, int h, cudaStream_t s) {
  return with_head_dim(d, [&](auto D) {
    return launch_attn<float, decltype(D)::value>(io, map, b, h, s);
  });
}

static cudaError_t run_mma(int d, const AttnIO<__nv_bfloat16>& io,
                           const PagedMap& map, int b, int n_kv, int n_split,
                           float* part_o, float* part_ml, cudaStream_t s) {
  return with_head_dim(d, [&](auto D) {
    return launch_attn_mma<decltype(D)::value>(io, map, b, n_kv, n_split,
                                               part_o, part_ml, s);
  });
}

}  // namespace quoka

// dtype: 0 = float32, 1 = bfloat16.  q (b, h, t, d) is a strided view with
// a contiguous head dim; k, v pools (n_pool, bs, n_kv, d) strided by block,
// slot and head; pos (n_pool, bs) int32 and table (b, nb_table) int32
// contiguous;
// ids (b, n_kv, nb) int32 (block ids at g > 1, token slots at g == 1, on
// the logical grid); start (b,) int32.  bf16 only: n_split
// from tiling.attn_geometry, part_o / part_ml the fp32 scratch of a split
// walk (null when n_split == 1).  Returns cudaGetLastError() after the
// launches.
extern "C" int selected_attention_paged_launch(
    int dtype, int d, const void* q, const void* k, const void* v,
    const void* pos, const void* table, const void* ids, const void* start,
    void* out, int b, int h, int n_kv, int t, int nb_table, int n_pool,
    int bs, int nb,
    int g, long long sq_b, long long sq_h, long long sq_t, long long sk_n,
    long long sk_s, long long sk_h, long long sv_n, long long sv_s,
    long long sv_h, long long si_b, long long si_h, long long so_b,
    long long so_h, long long so_t, float scale, int n_split,
    void* part_o, void* part_ml, void* stream) {
  using namespace quoka;
  PagedMap map{sk_n, sk_s, sk_h, sv_n, sv_s, sv_h,
               static_cast<const int*>(pos), static_cast<const int*>(table),
               static_cast<const int*>(ids), si_b, si_h,
               static_cast<const int*>(start), nb, g, bs, nb_table, n_pool,
               t};
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
