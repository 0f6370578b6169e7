// The page walk shared by the paged-attention fallbacks K10a-d
// (csrc/paged_attention_fallback.cu) and the per-shard partials kernels
// K11a-d of sequence parallelism (csrc/paged_attention_partials.cu).
//
// One block per (row group, KV head, slice of the group's rows) walks the
// group's block-table slots in order, one cache page at a time, and stages
// each page's keys and values of its head in shared memory in tiles of kT
// keys (64 for pages of 64 keys or more, else 16 or 32, the page's size),
// zero-filled past the page or the slice's largest context; it folds each
// tile into the f32 online-softmax statistics of its rows' query vectors
// with flash_tile.cuh's update, skips pages at or past the largest context
// (and, with kPartial, the slots `is_local` marks as another shard's), and
// writes acc / max(l, 1e-30) rounded to T; with kPartial also the rows' m
// (floored at -1e29) and l. No split-K and no combine pass: one launch per
// call. A group's rows are split over blocks only where its R * G query
// vectors would not fit in shared memory (flash_rows_per_block).
//
// Bit for bit: a tile's keys sit at fixed places (page start + multiples of
// kT), a tile past a row's context is an exact no-op for that row, a
// skipped page is skipped for every row of the table alike, and the tile
// update computes each query vector by a fixed sequence of operations
// (flash_tile.cuh), so a packed-verify row (R rows sharing a table) equals
// the decode row (R = 1) of the same query, context and table.
#pragma once

#include "flash_tile.cuh"

namespace npt {

// q, out [groups * rows, hq, d]; bt [groups, m]; ctx [groups * rows]. Block
// (group, kv head, slice) folds rows [slice * rpb, slice * rpb + rpb) of the
// group. S: T, or int8_t / __nv_fp8_e4m3 with `scales` [rows, hkv] bf16.
// kPartial: is_local [groups, m] int32 (0: the slot is another shard's, not
// read) and m_out, l_out [groups * rows, hq] f32.
template <typename T, typename S, int kT, bool kPartial>
__global__ void __launch_bounds__(kThreads)
paged_walk_kernel(const T* __restrict__ q, const S* __restrict__ cache,
                  const __nv_bfloat16* __restrict__ scales, const int* __restrict__ bt,
                  const int* __restrict__ ctx, const int* __restrict__ is_local, T* __restrict__ out,
                  float* __restrict__ m_out, float* __restrict__ l_out, int rows, int rpb, int m,
                  int hq, int hkv, int d, int bs, long long k_off, long long v_off, float scale) {
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
    if constexpr (kPartial) {
      if (!is_local[(long long)grp * m + min(p0 / bs, m - 1)]) continue;  // uniform over the block
    }
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
    const long long slot = (row0 + qi / g) * hq + kh * g + qi % g;
    out[slot * d + c] = flash_out(f, idx);
    if (kPartial && c == 0) {
      m_out[slot] = f.m[qi];
      l_out[slot] = f.l[qi];
    }
  }
}

// Tile width for pages of bs keys: the page when it holds 16 or 32 keys.
inline int tile_for(int bs) { return bs <= 16 ? 16 : bs <= 32 ? 32 : kTile; }

template <typename T, typename S, bool kPartial, int kT>
cudaError_t launch_walk_tile(int groups, int rows, const void* q, const void* cache,
                             const void* scales, const int* bt, const int* ctx, const int* is_local,
                             void* out, float* m_out, float* l_out, int m, int hq, int hkv, int d,
                             int bs, long long k_off, long long v_off, float scale,
                             cudaStream_t stream) {
  const int g = hq / hkv;
  const int rpb = flash_rows_per_block<T>(rows, g, d, 0, kT);
  const size_t smem = flash_smem_bytes<T>(rpb * g, d, sizeof(int) * rpb, kT);
  auto kernel = paged_walk_kernel<T, S, kT, kPartial>;
  cudaError_t err = flash_set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(groups, hkv, (rows + rpb - 1) / rpb);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const S*>(cache),
      static_cast<const __nv_bfloat16*>(scales), bt, ctx, is_local, static_cast<T*>(out), m_out,
      l_out, rows, rpb, m, hq, hkv, d, bs, k_off, v_off, scale);
  return cudaGetLastError();
}

// The walk over `groups` groups of `rows` rows (1: decode) at the tile
// width of the cache's pages.
template <typename T, typename S, bool kPartial>
cudaError_t launch_walk(int groups, int rows, const void* q, const void* cache, const void* scales,
                        const int* bt, const int* ctx, const int* is_local, void* out,
                        float* m_out, float* l_out, int m, int hq, int hkv, int d, int bs,
                        long long k_off, long long v_off, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_for(bs)) {
    case 16:
      return launch_walk_tile<T, S, kPartial, 16>(groups, rows, q, cache, scales, bt, ctx, is_local,
                                                  out, m_out, l_out, m, hq, hkv, d, bs, k_off,
                                                  v_off, scale, s);
    case 32:
      return launch_walk_tile<T, S, kPartial, 32>(groups, rows, q, cache, scales, bt, ctx, is_local,
                                                  out, m_out, l_out, m, hq, hkv, d, bs, k_off,
                                                  v_off, scale, s);
    default:
      return launch_walk_tile<T, S, kPartial, kTile>(groups, rows, q, cache, scales, bt, ctx,
                                                     is_local, out, m_out, l_out, m, hq, hkv, d,
                                                     bs, k_off, v_off, scale, s);
  }
}

// The 1-byte caches' dispatch on the storage type (e4m3 with is_fp8).
template <typename T, bool kPartial>
cudaError_t launch_walk_q8(int groups, int rows, const void* q, const void* cache,
                           const void* scales, const int* bt, const int* ctx, const int* is_local,
                           void* out, float* m_out, float* l_out, int m, int hq, int hkv, int d,
                           int bs, long long k_off, long long v_off, float scale, int is_fp8,
                           void* stream) {
  if (is_fp8)
    return launch_walk<T, __nv_fp8_e4m3, kPartial>(groups, rows, q, cache, scales, bt, ctx,
                                                   is_local, out, m_out, l_out, m, hq, hkv, d, bs,
                                                   k_off, v_off, scale, stream);
  return launch_walk<T, int8_t, kPartial>(groups, rows, q, cache, scales, bt, ctx, is_local, out,
                                          m_out, l_out, m, hq, hkv, d, bs, k_off, v_off, scale,
                                          stream);
}

}  // namespace npt
