// Per-shard flash partials of sequence parallelism, for sm_90a: decode and
// packed verify over ONE shard of a block-sharded paged cache, exporting
// (o, m, l) for the cross-shard softmax merge (parallel/sp.py).
//
// K11a npt_partials (rows 1, bf16/f32 cache): per-shard decode partials.
//   Replaces nano_pearl_tpu/ops/pallas/paged_attention.py _kernel_partial
//   (entry paged_attention_pallas_partials).
// K11c npt_partials (rows >= 1): per-shard packed-verify partials, R rows
//   of one sequence sharing its block table. Replaces
//   _grouped_kernel_partial (entry paged_attention_pallas_grouped_partials).
// K11b / K11d npt_partials_q8: K11a / K11c over a 1-byte shard (int8 or
//   e4m3) with a bf16 scale per (slot, KV head), dequantized in the tile
//   load and rounded to the query type as K9a-c and K10c/K10d do. Replace
//   _kernel_partial_q8 and _grouped_kernel_partial_q8 (same entries).
//
// The caller hands each row (group) a table of LOCAL block ids, clamped
// into the shard, and is_local [tables, m]: a slot that is not local is
// another shard's and is skipped, like a slot at or past the context. The
// statistics start at m = -1e29, l = 0, acc = 0 (the Pallas kernels'
// _init_scratch_floor), so a row with no local visible key gives o = 0,
// m = -1e29 and l = 0, which the merge weighs 0. Outputs: o = acc /
// max(l, 1e-30) in the query's type (the Pallas entries return q.dtype),
// m and l in f32.
//
// Layout: the page walk of the fallbacks K10a-d (paged_walk.cuh), which
// takes every head dim 16..256 and every Hkv * D and carries the argument
// that a K11c row equals the K11a row of the same query, context and table
// bit for bit (K11d's K11b's): the layer-share pair's draft decodes through
// K11a and its target verifies through K11c, and the merge is one
// elementwise function of (o, m, l), so the ceiling holds under sp as
// without. A cell that holds no local page does no work: its block writes
// the floor partials (m = -1e29, l = 0) and the combine skips them.
//
// Bound on the H100: bytes (a group reads its shard's share of its
// context's K/V once per KV head, ~4 flops per byte at decode).
#include "paged_walk.cuh"

extern "C" {

// walk_plan's field `what`, as npt_walk_plan in paged_attention_fallback.cu.
long long npt_walk_plan(int rows, int g, int hkv, int d, int bs, int is_bf16, int q8, int what) {
  return npt::walk_plan_field(rows, g, hkv, d, bs, is_bf16 != 0, q8 != 0, what);
}

// K11a (rows 1) / K11c: q, o [b * rows, hq, d] bf16 or f32 (is_bf16), the
// shard's cache of the same type [L, 2, NB1_loc, bs, hkv * d]; bt [b, m]
// local block ids; ctx [b * rows] global contexts; is_local [b, m] int32;
// m_out, l_out [b * rows, hq] f32; part_acc / part_ml as npt_fallback's.
// Returns cudaGetLastError() after the launches.
int npt_partials(const void* q, const void* cache, const int* bt, const int* ctx,
                 const int* is_local, void* out, float* m_out, float* l_out, float* part_acc,
                 float* part_ml, int b, int rows, int m, int hq, int hkv, int d, int bs,
                 long long k_off, long long v_off, float scale, int is_bf16, void* stream) {
  return (int)npt::launch_walk<true>(is_bf16 != 0, 0, b, rows, q, cache, nullptr, bt, ctx,
                                     is_local, out, m_out, l_out, part_acc, part_ml, m, hq, hkv, d,
                                     bs, k_off, v_off, scale, stream);
}

// K11b (rows 1) / K11d: npt_partials over a 1-byte shard (int8, or e4m3
// with is_fp8) and its bf16 scales [rows, hkv].
int npt_partials_q8(const void* q, const void* cache, const void* scales, const int* bt,
                    const int* ctx, const int* is_local, void* out, float* m_out, float* l_out,
                    float* part_acc, float* part_ml, int b, int rows, int m, int hq, int hkv,
                    int d, int bs, long long k_off, long long v_off, float scale, int is_bf16,
                    int is_fp8, void* stream) {
  return (int)npt::launch_walk<true>(is_bf16 != 0, is_fp8 ? 2 : 1, b, rows, q, cache, scales, bt,
                                     ctx, is_local, out, m_out, l_out, part_acc, part_ml, m, hq,
                                     hkv, d, bs, k_off, v_off, scale, stream);
}

const char* npt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
