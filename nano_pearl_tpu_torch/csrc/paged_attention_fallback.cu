// The paged-attention fallbacks, for sm_90a: decode and packed verify at the
// shapes the fast kernels (K1/K2, K9a/K9b, K5/K9c) are not routed to.
//
// K10a npt_fallback (rows 1, bf16/f32 cache): paged decode. Replaces
//   nano_pearl_tpu/ops/pallas/paged_attention.py _kernel (entry
//   paged_attention_pallas, its BlockSpec fallback).
// K10b npt_fallback (rows >= 1): the packed verify, R rows of one sequence
//   sharing its block table, each row masked at its own context. Replaces
//   _grouped_kernel (entry paged_attention_pallas_grouped, its fallback).
// K10c / K10d npt_fallback_q8: K10a / K10b over a 1-byte cache (int8 or
//   e4m3) with a bf16 scale per (slot, KV head), dequantized in the tile
//   load as K9a-c dequantize (value x scale, rounded to the query type).
//   Replace _kernel_q8 and _grouped_kernel_q8 (same entries).
//
// The JAX package runs these where its fast kernels' gates fail: a folded
// head axis Hkv * D that is not a multiple of 128, and for a 1-byte cache
// also a block size that is not a multiple of 32 (_q8_fastpath_ok). The
// port routes the same shapes here (ops/attention.attention_kernel).
// npt_fallback is also the bf16 route of the fast kernels K1 (paged decode)
// and K2 (packed verify) at every other shape: their wrappers
// (ops/cuda/paged_attention.py) launch it with bf16 queries and count their
// own launches, so this one library builds the walk for all four.
//
// Layout: the page walk of paged_walk.cuh, which also carries the argument
// that a K10b row equals the K10a row of the same query, context and table
// bit for bit (and K10d's K10c's): the decode <-> verify agreement of the
// layer-share ceiling at these shapes. bf16 queries run on the tensor
// cores in cells of keys at fixed positions, one block per (group, KV
// head, row slice, cell), with a combine where a table holds several
// cells; f32 queries walk a page at a time on CUDA cores.
//
// Bound on the H100: bytes (each row group reads its context's K/V once
// per KV head, ~4 flops per byte at decode).
#include "paged_walk.cuh"

extern "C" {

// walk_plan's field `what` (0 keys per cell, 1 query vectors a warp, 2 rows
// per block, 3 threads, 4 K/V stages, 5 shared-memory bytes) for groups of
// `rows` rows, g query heads per KV head, hkv KV heads, head dim d, pages of
// bs keys, bf16 (is_bf16) or f32 queries over a 1-byte (q8) or query-type
// cache. Exported to hold the Python mirror (ops/cuda/paged_walk.walk_plan)
// against it.
long long npt_walk_plan(int rows, int g, int hkv, int d, int bs, int is_bf16, int q8, int what) {
  return npt::walk_plan_field(rows, g, hkv, d, bs, is_bf16 != 0, q8 != 0, what);
}

// K10a (rows 1) / K10b: q, out [b * rows, hq, d] bf16 or f32 (is_bf16), the
// cache of the same type; bt [b, m]; ctx [b * rows]. bf16: part_acc [b *
// rows, hq, n_cells, d] and part_ml [.., 2] f32 scratch for n_cells =
// ceil(m * bs / cell) (walk_plan's cell) cells, null where that is 1.
// Returns cudaGetLastError() after the launches.
int npt_fallback(const void* q, const void* cache, const int* bt, const int* ctx, void* out,
                 float* part_acc, float* part_ml, int b, int rows, int m, int hq, int hkv, int d,
                 int bs, long long k_off, long long v_off, float scale, int is_bf16, void* stream) {
  return (int)npt::launch_walk<false>(is_bf16 != 0, 0, b, rows, q, cache, nullptr, bt, ctx,
                                      nullptr, out, nullptr, nullptr, part_acc, part_ml, m, hq,
                                      hkv, d, bs, k_off, v_off, scale, stream);
}

// K10c (rows 1) / K10d: npt_fallback over a 1-byte cache (int8, or e4m3
// with is_fp8) and its bf16 scales [rows, hkv].
int npt_fallback_q8(const void* q, const void* cache, const void* scales, const int* bt,
                    const int* ctx, void* out, float* part_acc, float* part_ml, int b, int rows,
                    int m, int hq, int hkv, int d, int bs, long long k_off, long long v_off,
                    float scale, int is_bf16, int is_fp8, void* stream) {
  return (int)npt::launch_walk<false>(is_bf16 != 0, is_fp8 ? 2 : 1, b, rows, q, cache, scales, bt,
                                      ctx, nullptr, out, nullptr, nullptr, part_acc, part_ml, m,
                                      hq, hkv, d, bs, k_off, v_off, scale, stream);
}

const char* npt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
