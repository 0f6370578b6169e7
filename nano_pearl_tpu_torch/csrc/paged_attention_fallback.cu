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
// Layout: one block per (row group, KV head, slice of the group's rows).
// The block walks the group's block-table slots in order, one cache page
// at a time, and stages each page's keys and values of its head in shared
// memory in tiles of kT keys (64 for pages of 64 keys or more, else 16 or
// 32, the page's size), zero-filled past the page or the group's largest
// context; it folds each tile into the f32 online-softmax statistics of its
// rows' query vectors with flash_tile.cuh's update, skips pages at or past
// the largest context, and divides by max(l, 1e-30) at the end. No split-K
// and no combine pass: one launch per call. A group's rows are split over
// blocks only where its R * G query vectors would not fit in shared memory.
//
// Bit for bit: a tile's keys sit at fixed places (page start + multiples of
// kT), a tile past a row's context is an exact no-op for that row, and the
// tile update computes each query vector by a fixed sequence of operations
// (flash_tile.cuh), so a K10b row equals the K10a row of the same query and
// context, and K10d's equal K10c's: the decode <-> verify agreement of the
// layer-share ceiling at these shapes.
//
// Bound on the H100: bytes (each row group reads its context's K/V once
// per KV head, ~4 flops per byte at decode). The design does nothing for
// speed beyond staging a tile once for all of a group's rows: one block per
// (group, head) walks the whole context, so few blocks run at decode.
#include "flash_tile.cuh"

namespace npt {

// q, out [groups * rows, hq, d]; bt [groups, m]; ctx [groups * rows]. Block
// (group, kv head, slice) folds rows [slice * rpb, slice * rpb + rpb) of the
// group. S: T, or int8_t / __nv_fp8_e4m3 with `scales` [rows, hkv] bf16.
template <typename T, typename S, int kT>
__global__ void __launch_bounds__(kThreads)
fallback_kernel(const T* __restrict__ q, const S* __restrict__ cache,
                const __nv_bfloat16* __restrict__ scales, const int* __restrict__ bt,
                const int* __restrict__ ctx, T* __restrict__ out, int rows, int rpb, int m, int hq,
                int hkv, int d, int bs, long long k_off, long long v_off, float scale) {
  const int grp = blockIdx.x, kh = blockIdx.y, r0 = blockIdx.z * rpb;
  const int nr = min(rpb, rows - r0), tid = threadIdx.x, g = hq / hkv, nq = nr * g;
  Flash<T> f;
  int* ctx_s = reinterpret_cast<int*>(flash_carve<kT>(f, nq, d));
  const long long row0 = (long long)grp * rows + r0;
  for (int r = tid; r < nr; r += blockDim.x) ctx_s[r] = ctx[row0 + r];
  for (int idx = tid; idx < nq * d; idx += blockDim.x) {
    const int qi = idx / d, c = idx - qi * d;
    f.qs[idx] = to_f32(q[((row0 + qi / g) * hq + kh * g + qi % g) * d + c]);
  }
  flash_init_stats(f);
  __syncthreads();
  int ctx_max = 0;
  for (int r = 0; r < nr; ++r) ctx_max = max(ctx_max, ctx_s[r]);

  const int* bt_row = bt + (long long)grp * m;
  for (int p0 = 0; p0 < ctx_max; p0 += bs) {  // one page of the table at a time
    const int p_end = min(p0 + bs, ctx_max);
    for (int c0 = p0; c0 < p_end; c0 += kT) {
      const int c_end = min(c0 + kT, p_end);
      if constexpr (!std::is_same<S, T>::value) {
        stage_q8_tile<T, S, kT>(f, reinterpret_cast<const uint8_t*>(cache), scales, bt_row, m, bs,
                                hkv, kh, k_off, v_off, c0, c_end);
      } else {
        stage_tile<kT>(f, kh, c0, c_end, PagedRows<T>{cache, bt_row, m, bs, hkv * d, k_off, v_off});
      }
      __syncthreads();
      flash_tile_update<kT>(f, scale, CellMask{ctx_s, g, c0, c_end});
    }
  }

  for (int idx = tid; idx < nq * d; idx += blockDim.x) {
    const int qi = idx / d, c = idx - qi * d;
    out[((row0 + qi / g) * hq + kh * g + qi % g) * d + c] = flash_out(f, idx);
  }
}

// Tile width for pages of bs keys: the page when it holds 16 or 32 keys.
inline int tile_for(int bs) { return bs <= 16 ? 16 : bs <= 32 ? 32 : kTile; }

template <typename T, typename S, int kT>
cudaError_t launch_tile(int groups, int rows, const void* q, const void* cache, const void* scales,
                        const int* bt, const int* ctx, void* out, int m, int hq, int hkv, int d,
                        int bs, long long k_off, long long v_off, float scale,
                        cudaStream_t stream) {
  const int g = hq / hkv;
  int rpb = rows;  // rows per block: all of the group's, unless they do not fit
  auto smem = [&](int r) { return flash_smem_bytes<T>(r * g, d, sizeof(int) * r, kT); };
  while (rpb > 1 && smem(rpb) > (size_t)kMaxSmem) rpb = (rpb + 1) / 2;
  cudaError_t err = flash_set_smem(fallback_kernel<T, S, kT>, smem(rpb));
  if (err != cudaSuccess) return err;
  const dim3 grid(groups, hkv, (rows + rpb - 1) / rpb);
  fallback_kernel<T, S, kT><<<grid, kThreads, smem(rpb), stream>>>(
      static_cast<const T*>(q), static_cast<const S*>(cache),
      static_cast<const __nv_bfloat16*>(scales), bt, ctx, static_cast<T*>(out), rows, rpb, m, hq,
      hkv, d, bs, k_off, v_off, scale);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch(int groups, int rows, const void* q, const void* cache, const void* scales,
                   const int* bt, const int* ctx, void* out, int m, int hq, int hkv, int d, int bs,
                   long long k_off, long long v_off, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_for(bs)) {
    case 16:
      return launch_tile<T, S, 16>(groups, rows, q, cache, scales, bt, ctx, out, m, hq, hkv, d, bs,
                                   k_off, v_off, scale, s);
    case 32:
      return launch_tile<T, S, 32>(groups, rows, q, cache, scales, bt, ctx, out, m, hq, hkv, d, bs,
                                   k_off, v_off, scale, s);
    default:
      return launch_tile<T, S, kTile>(groups, rows, q, cache, scales, bt, ctx, out, m, hq, hkv, d,
                                      bs, k_off, v_off, scale, s);
  }
}

}  // namespace npt

extern "C" {

// K10a (rows 1) / K10b: q, out [b * rows, hq, d] bf16 or f32 (is_bf16), the
// cache of the same type; bt [b, m]; ctx [b * rows]. Returns
// cudaGetLastError() after the launch.
int npt_fallback(const void* q, const void* cache, const int* bt, const int* ctx, void* out, int b,
                 int rows, int m, int hq, int hkv, int d, int bs, long long k_off, long long v_off,
                 float scale, int is_bf16, void* stream) {
  if (rows < 1 || d % 8) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)npt::launch<__nv_bfloat16, __nv_bfloat16>(b, rows, q, cache, nullptr, bt, ctx, out,
                                                          m, hq, hkv, d, bs, k_off, v_off, scale,
                                                          stream);
  return (int)npt::launch<float, float>(b, rows, q, cache, nullptr, bt, ctx, out, m, hq, hkv, d,
                                        bs, k_off, v_off, scale, stream);
}

// K10c (rows 1) / K10d: npt_fallback over a 1-byte cache (int8, or e4m3
// with is_fp8) and its bf16 scales [rows, hkv].
int npt_fallback_q8(const void* q, const void* cache, const void* scales, const int* bt,
                    const int* ctx, void* out, int b, int rows, int m, int hq, int hkv, int d,
                    int bs, long long k_off, long long v_off, float scale, int is_bf16,
                    int is_fp8, void* stream) {
  if (rows < 1 || d % 16) return (int)cudaErrorInvalidValue;  // 16 one-byte values per load
  if (is_bf16) {
    if (is_fp8)
      return (int)npt::launch<__nv_bfloat16, __nv_fp8_e4m3>(b, rows, q, cache, scales, bt, ctx, out,
                                                            m, hq, hkv, d, bs, k_off, v_off, scale,
                                                            stream);
    return (int)npt::launch<__nv_bfloat16, int8_t>(b, rows, q, cache, scales, bt, ctx, out, m, hq,
                                                   hkv, d, bs, k_off, v_off, scale, stream);
  }
  if (is_fp8)
    return (int)npt::launch<float, __nv_fp8_e4m3>(b, rows, q, cache, scales, bt, ctx, out, m, hq,
                                                  hkv, d, bs, k_off, v_off, scale, stream);
  return (int)npt::launch<float, int8_t>(b, rows, q, cache, scales, bt, ctx, out, m, hq, hkv, d,
                                         bs, k_off, v_off, scale, stream);
}

const char* npt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
