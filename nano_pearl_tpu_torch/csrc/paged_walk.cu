// The page walk's library, for sm_90a: paged decode and packed verify over a
// bf16/f32 or a 1-byte cache. The walk's other launches (the per-shard
// K11a-d, K7, and the deferred and split kernels K6a/K6b, K8a/K8b) are
// exported by paged_attention_partials.cu.
//
// npt_walk (rows 1: decode; rows >= 1: the packed verify, R rows of one
// sequence sharing its block table, each row masked at its own context),
// over a bf16/f32 cache:
// - K1 (paged decode) and K2 (packed verify), bf16 queries: the main path's
//   and the server's. Replace nano_pearl_tpu/ops/pallas/paged_attention.py
//   _kernel_db (entry paged_attention_pallas) and _grouped_kernel_db (entry
//   paged_attention_pallas_grouped).
// - K10a / K10b, bf16 or f32 queries: the fallbacks, at the shapes the fast
//   kernels are not routed to. Replace _kernel and _grouped_kernel (same
//   entries, their BlockSpec fallbacks).
// npt_walk_q8: the same over a 1-byte cache (int8 or e4m3) with a bf16
// scale per (slot, KV head), dequantized in shared memory (value x scale,
// rounded once to the query type, as the plain versions round it):
// - K9a / K9b, bf16 queries: K1 / K2 over the quantized cache. Replace
//   _kernel_db_q8v2 (entry _db_call_q8_single) and _grouped_kernel_db_q8v2
//   (entry _db_call_q8_grouped).
// - K10c / K10d, bf16 or f32 queries. Replace _kernel_q8 and
//   _grouped_kernel_q8.
// The f32 routes of K1/K2 and K9a/K9b stay on paged_attention.cu's chunk
// template. The wrappers (ops/cuda/paged_attention.py,
// ops/cuda/paged_attention_fallback.py) count each kernel's launches on its
// own name.
//
// The JAX package runs the fallbacks where its fast kernels' gates fail: a
// folded head axis Hkv * D that is not a multiple of 128, and for a 1-byte
// cache also a block size that is not a multiple of 32 (_q8_fastpath_ok).
// The port routes the same shapes there (ops/attention.attention_kernel).
//
// Layout: the page walk of paged_walk.cuh, which also carries the argument
// that a verify row equals the decode row of the same query, context and
// table bit for bit (K2 == K1, K9b == K9a, K10b == K10a, K10d == K10c): the
// decode <-> verify agreement of the layer-share ceiling. bf16 queries run
// on the tensor cores in cells of keys at fixed positions, one block per
// (group, KV head, row slice, cell), with a combine where a table holds
// several cells; f32 queries walk a page at a time on CUDA cores.
//
// Bound on the H100: bytes (each row group reads its context's K/V once
// per KV head, ~4 flops per byte at decode over bf16, ~8 over 1 byte).
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

// rows 1: decode; else the packed verify. q, out [b * rows, hq, d] bf16 or
// f32 (is_bf16), the cache of the same type; bt [b, m]; ctx [b * rows].
// bf16: part_acc [b * rows, hq, n_cells, d] and part_ml [.., 2] f32 scratch
// for n_cells = ceil(m * bs / cell) (walk_plan's cell) cells, null where
// that is 1. Returns cudaGetLastError() after the launches.
int npt_walk(const void* q, const void* cache, const int* bt, const int* ctx, void* out,
             float* part_acc, float* part_ml, int b, int rows, int m, int hq, int hkv, int d, int bs,
             long long k_off, long long v_off, float scale, int is_bf16, void* stream) {
  return (int)npt::launch_walk<false>(is_bf16 != 0, 0, b, rows, q, cache, nullptr, bt, ctx,
                                      nullptr, out, nullptr, nullptr, part_acc, part_ml, m, hq,
                                      hkv, d, bs, k_off, v_off, scale, stream);
}

// npt_walk over a 1-byte cache (int8, or e4m3 with is_fp8) and its bf16
// scales [cache rows, hkv].
int npt_walk_q8(const void* q, const void* cache, const void* scales, const int* bt,
                const int* ctx, void* out, float* part_acc, float* part_ml, int b, int rows, int m,
                int hq, int hkv, int d, int bs, long long k_off, long long v_off, float scale,
                int is_bf16, int is_fp8, void* stream) {
  return (int)npt::launch_walk<false>(is_bf16 != 0, is_fp8 ? 2 : 1, b, rows, q, cache, scales, bt,
                                      ctx, nullptr, out, nullptr, nullptr, part_acc, part_ml, m,
                                      hq, hkv, d, bs, k_off, v_off, scale, stream);
}

const char* npt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
