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
//
// Layout: the page walk of paged_walk.cuh (one block per row group, KV
// head and slice of the group's rows; one cache page at a time in tiles of
// at most 64 keys; no split-K and no combine pass), which also carries the
// argument that a K10b row equals the K10a row of the same query and
// context bit for bit (and K10d's K10c's): the decode <-> verify agreement
// of the layer-share ceiling at these shapes.
//
// Bound on the H100: bytes (each row group reads its context's K/V once
// per KV head, ~4 flops per byte at decode). The design does nothing for
// speed beyond staging a tile once for all of a group's rows: one block per
// (group, head) walks the whole context, so few blocks run at decode.
#include "paged_walk.cuh"

extern "C" {

// K10a (rows 1) / K10b: q, out [b * rows, hq, d] bf16 or f32 (is_bf16), the
// cache of the same type; bt [b, m]; ctx [b * rows]. Returns
// cudaGetLastError() after the launch.
int npt_fallback(const void* q, const void* cache, const int* bt, const int* ctx, void* out, int b,
                 int rows, int m, int hq, int hkv, int d, int bs, long long k_off, long long v_off,
                 float scale, int is_bf16, void* stream) {
  if (rows < 1 || d % 8) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)npt::launch_walk<__nv_bfloat16, __nv_bfloat16, false>(
        b, rows, q, cache, nullptr, bt, ctx, nullptr, out, nullptr, nullptr, m, hq, hkv, d, bs,
        k_off, v_off, scale, stream);
  return (int)npt::launch_walk<float, float, false>(b, rows, q, cache, nullptr, bt, ctx, nullptr,
                                                    out, nullptr, nullptr, m, hq, hkv, d, bs, k_off,
                                                    v_off, scale, stream);
}

// K10c (rows 1) / K10d: npt_fallback over a 1-byte cache (int8, or e4m3
// with is_fp8) and its bf16 scales [rows, hkv].
int npt_fallback_q8(const void* q, const void* cache, const void* scales, const int* bt,
                    const int* ctx, void* out, int b, int rows, int m, int hq, int hkv, int d,
                    int bs, long long k_off, long long v_off, float scale, int is_bf16,
                    int is_fp8, void* stream) {
  if (rows < 1 || d % 16) return (int)cudaErrorInvalidValue;  // 16 one-byte values per load
  if (is_bf16)
    return (int)npt::launch_walk_q8<__nv_bfloat16, false>(b, rows, q, cache, scales, bt, ctx,
                                                          nullptr, out, nullptr, nullptr, m, hq,
                                                          hkv, d, bs, k_off, v_off, scale, is_fp8,
                                                          stream);
  return (int)npt::launch_walk_q8<float, false>(b, rows, q, cache, scales, bt, ctx, nullptr, out,
                                                nullptr, nullptr, m, hq, hkv, d, bs, k_off, v_off,
                                                scale, is_fp8, stream);
}

const char* npt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
