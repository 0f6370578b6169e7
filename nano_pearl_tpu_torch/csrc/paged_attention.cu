// Paged attention over the layer-folded KV cache, for sm_90a.
//
// K1 npt_paged_decode: one query row per sequence (draft gamma-scan and AR
//   decode). Replaces nano_pearl_tpu/ops/pallas/paged_attention.py
//   _kernel_db (entry paged_attention_pallas).
// K2 npt_paged_verify: R packed verify rows of one sequence share one
//   block table and one load of each K/V tile, each row with its own
//   (staircase) context length. Replaces _grouped_kernel_db (entry
//   paged_attention_pallas_grouped).
// These two entries are K1's and K2's f32 route (the exactness pairs, held
// at 1e-4 on CUDA cores, where the tensor cores would take f32 as TF32).
// K1's and K2's bf16 route, the main path's and the server's, is the
// tensor-core page walk of paged_walk.cuh, launched through paged_walk.cu's
// npt_walk (ops/cuda/paged_attention.py picks the route by the query type);
// these entries refuse bf16 queries.
//
// Cache layout: [L * 2 * (NB + 1), BS, Hkv * D] rows; layer l's keys live
// at block offset k_off = 2 * l * (NB + 1), its values at v_off = k_off +
// NB + 1, and a block table entry b names block k_off + b / v_off + b.
//
// Two launches per call, flash-decoding style:
// 1. partials, grid (sequences, KV heads, key chunks of kChunk positions):
//    each block stages its chunk's K/V slice of its head in kTile-key
//    shared-memory tiles with 16-byte loads and folds it into the R * G
//    query vectors (G = Hq / Hkv) of the sequence with flash_tile_update,
//    writing one (acc, m, l) partial per row, head and chunk. A chunk
//    that starts at or past every row's context does nothing.
//    Where a group's R * G query vectors do not fit in one block's shared
//    memory (D 256 at large R * G), its rows are spread over several
//    blocks (flash_rows_per_block), each folding the same tiles into its
//    own rows: no bit of a row changes.
// 2. combine, one block per row: folds the row's partials of chunks
//    0 .. ceil(ctx / kChunk) - 1 in order and rounds once to the output
//    type.
// K9a npt_paged_decode_q8 / K9b npt_paged_verify_q8: K1 / K2 over a
//   1-byte cache (int8 or e4m3) with a bf16 scale per (slot, KV head).
//   Replace _kernel_db_q8v2 (entry _db_call_q8_single, from
//   paged_attention_pallas) and _grouped_kernel_db_q8v2 (entry
//   _db_call_q8_grouped, from paged_attention_pallas_grouped). Only the
//   tile load differs (flash_tile.cuh stage_q8_tile: dequantized in shared
//   memory), so K9b rows equal K9a rows bit for bit as K2's equal K1's.
//   These entries are K9a's and K9b's f32 route and refuse bf16 queries:
//   their bf16 route, quant_path's, is the page walk's 1-byte path
//   (paged_walk.cu's npt_walk_q8).
//
// K8a npt_paged_decode_split: K1 with the chunk that holds a per-row
//   boundary b1 cut into two partials there, the second one's tiles
//   starting at b1 (the draft's gamma-scan on the split-boundary schedule).
//   Replaces _kernel_db_split (entry paged_attention_pallas_split).
// K6a npt_paged_verify_fresh (split 0): the deferred-write packed verify:
//   K2 over the cache with each row's context clamped to the group's
//   pre-round context ctx0, plus one more partial per (group, head) whose
//   tiles come from the in-operand fresh rows, folded last. Writes nothing
//   to the cache. Replaces _grouped_kernel_db_fresh (entry
//   paged_attention_pallas_grouped_fresh).
// K8b npt_paged_verify_fresh (split 1): K6a with the fresh window cut at the
//   chunk multiple inside it, so its rows fold the cells of K8a's rows and
//   equal them bit for bit. Replaces _grouped_kernel_db_fresh_split (entry
//   paged_attention_pallas_grouped_fresh_split). The cell partition is set
//   out above cell_partial_kernel.
// These three entries are K8a's, K6a's and K8b's f32 route too, and refuse
// bf16 queries: their bf16 route is the tensor-core page walk
// (paged_attention_partials.cu: npt_fresh_walk for K6a, npt_cut_walk for
// K8a and K8b, the cut cells of paged_walk.cuh).
//
// K1 is K2 with R = 1. The chunk partition is fixed by absolute position,
// a tile past a row's context is an exact no-op for that row, and the
// combine reads only the row's own chunks, so a K2 row and the K1 row of
// the same query and context give equal bits (flash_tile.cuh).
//
// Bound on the H100: bytes. Each row reads ctx * Hkv * D * 2 elements of
// K/V once and does 4 * ctx * Hq * D flops, about 4 flops per byte at bf16
// with G = 4 (8 over a 1-byte cache): far below the card's ~295 flops/byte
// balance point. The
// chunk split puts (sequences x heads x chunks) blocks on the 132 SMs
// instead of one serial walk per (sequence, head).
#include "flash_tile.cuh"

namespace npt {

constexpr int kChunk = 256;  // key positions per partial (4 tiles)

// Partials of one (sequence, KV head, chunk) for the rows [r0, r0 + rpb)
// of the sequence's group that block x = group * slices + slice folds
// (flash_rows_per_block). part_acc [rows_total, Hq, n_chunks, D] and
// part_ml [rows_total, Hq, n_chunks, 2] (m, l), f32. S is the cache's
// storage type: T, or int8_t / __nv_fp8_e4m3 with `scales`.
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
paged_partial_kernel(const T* __restrict__ q, const S* __restrict__ cache,
                     const __nv_bfloat16* __restrict__ scales,
                     const int* __restrict__ bt, const int* __restrict__ ctx,
                     float* __restrict__ part_acc, float* __restrict__ part_ml, int rows, int rpb,
                     int m, int hq, int hkv, int d, int bs, long long k_off, long long v_off,
                     float scale) {
  const int slices = (rows + rpb - 1) / rpb;
  const int grp = blockIdx.x / slices, r0 = (blockIdx.x - grp * slices) * rpb;
  const int kh = blockIdx.y, ch = blockIdx.z, n_chunks = gridDim.z;
  const int nr = min(rpb, rows - r0), tid = threadIdx.x, g = hq / hkv, nq = nr * g, hd = hkv * d;
  const long long row0 = (long long)grp * rows + r0;
  Flash<T> f;
  int* ctx_s = reinterpret_cast<int*>(flash_carve(f, nq, d));
  const int* bt_row = bt + (long long)grp * m;

  for (int r = tid; r < nr; r += blockDim.x) ctx_s[r] = ctx[row0 + r];
  __syncthreads();
  int ctx_max = 1;
  for (int r = 0; r < nr; ++r) ctx_max = max(ctx_max, ctx_s[r]);
  const int c_begin = ch * kChunk;
  if (c_begin >= ctx_max) return;  // uniform over the block
  const int c_end = min(ctx_max, c_begin + kChunk);

  for (int idx = tid; idx < nq * d; idx += blockDim.x) {
    const int qi = idx / d, c = idx - qi * d;
    const long long row = row0 + qi / g;
    f.qs[idx] = to_f32(q[(row * hq + kh * g + qi % g) * d + c]);
  }
  flash_init_stats(f);
  __syncthreads();

  for (int c0 = c_begin; c0 < c_end; c0 += kTile) {
    if constexpr (!std::is_same<S, T>::value) {
      stage_q8_tile<T, S>(f, reinterpret_cast<const uint8_t*>(cache), scales, bt_row, m, bs, hkv,
                          kh, k_off, v_off, c0, c_end);
    } else {
      stage_tile(f, kh, c0, c_end, PagedRows<T>{cache, bt_row, m, bs, hd, k_off, v_off});
    }
    __syncthreads();
    flash_tile_update(f, scale, CellMask{ctx_s, g, c0, c_end});
  }

  for (int idx = tid; idx < nq * d; idx += blockDim.x) {
    const int qi = idx / d, c = idx - qi * d, r = qi / g;
    if (c_begin >= ctx_s[r]) continue;  // the combine never reads this chunk
    const long long slot = (row0 + r) * hq + kh * g + qi % g;
    part_acc[(slot * n_chunks + ch) * d + c] = f.acc[idx];
    if (c == 0) {
      part_ml[(slot * n_chunks + ch) * 2] = f.m[qi];
      part_ml[(slot * n_chunks + ch) * 2 + 1] = f.l[qi];
    }
  }
}

// out[row, h, :] from the row's partials of chunks 0 .. ceil(ctx/kChunk)-1.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                     const int* __restrict__ ctx, T* __restrict__ out, int hq, int d,
                     int n_chunks) {
  const long long row = blockIdx.x;
  const int nc = (ctx[row] + kChunk - 1) / kChunk;
  for (int idx = threadIdx.x; idx < hq * d; idx += blockDim.x) {
    const int c = idx % d;
    const long long first = (row * hq + idx / d) * n_chunks;
    out[idx + row * hq * d] = fold_partials<T>(
        part_acc, part_ml, d, c, nc, [](int) { return true; },
        [first](int ch) { return first + ch; });
  }
}

template <typename T, typename S = T>
cudaError_t launch(int groups, int rows, const void* q, const void* cache, const int* bt,
                   const int* ctx, void* out, float* part_acc, float* part_ml, int m, int hq,
                   int hkv, int d, int bs, long long k_off, long long v_off, float scale,
                   cudaStream_t stream, const void* scales = nullptr) {
  const int g = hq / hkv, rpb = flash_rows_per_block<T>(rows, g, d);
  const size_t smem = flash_smem_bytes<T>(rpb * g, d, sizeof(int) * rpb);
  cudaError_t err = flash_set_smem(paged_partial_kernel<T, S>, smem);
  if (err != cudaSuccess) return err;
  const int n_chunks = (m * bs + kChunk - 1) / kChunk, slices = (rows + rpb - 1) / rpb;
  paged_partial_kernel<T, S><<<dim3(groups * slices, hkv, n_chunks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const S*>(cache),
      static_cast<const __nv_bfloat16*>(scales), bt, ctx, part_acc, part_ml, rows, rpb, m, hq, hkv,
      d, bs, k_off, v_off, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<T><<<groups * rows, kThreads, 0, stream>>>(
      part_acc, part_ml, ctx, static_cast<T*>(out), hq, d, n_chunks);
  return cudaGetLastError();
}

// ---- K8a, K6a, K8b (f32): kernels that fold cells other than the chunks ----
//
// The f32 route of the split-boundary schedule and of the db schedule's
// deferred verify (the exactness pairs, held at 1e-4 on CUDA cores). The
// bf16 route runs the same partition on the page walk's 128- or 256-key
// cells (paged_walk.cuh: WalkCells).
//
// A cell is an interval [lo, hi) of a row's key positions folded into one
// partial. Its tiles start at lo, so a key sits at the same place of its
// tile wherever the cell comes from; a row sees a key of the cell iff its
// position is below hi and below the row's context, and a cell is empty for
// a row iff lo >= min(hi, context). The cells of a row, in position order:
//
// K8a (decode, Cells<false>): the kChunk-key chunks of [0, ctx), the one
//   that holds b1 cut in two there: cell i < kb + 1 is chunk i (chunk kb
//   only up to b1), cell kb + 1 is [b1, end of chunk kb), cell i > kb + 1 is
//   chunk i - 1. Without a cut (b1 a chunk multiple, or b1 >= ctx) cell i
//   is chunk i and the last cell is empty. n_chunks + 1 cells.
// K6a / K8b (deferred verify of a group with pre-round context ctx0 and R
//   fresh rows, Cells<true>): cells i < n_chunks are the cache's chunks cut
//   at ctx0 ([i * kChunk, min((i + 1) * kChunk, ctx0)), read through the
//   block table); cell n_chunks is the fresh window [ctx0, ctx0 + R), read
//   from the in-operand fresh rows, and cell n_chunks + 1 is empty. Under
//   the split schedule (K8b) the window is cut at the chunk multiple
//   cstar = (ctx0 / kChunk + 1) * kChunk: cell n_chunks is [ctx0, cstar),
//   cell n_chunks + 1 [cstar, ctx0 + R). n_chunks + 2 cells.
//
// With b1 = ctx0 and R <= kChunk, a K8b row whose context exceeds ctx0 has
// exactly the non-empty cells of the K8a row with the same context, in the
// same order and with the same tile starts: cache chunks below ctx0, the
// chunk holding ctx0 cut there, [ctx0, cstar), [cstar, ctx). One pass per
// cell writes its partials; a second folds each row's non-empty cells in
// order with fold_partials. So given the same keys and values (the
// draft's cache holding what the verify gets in-operand) a K8b row equals
// the K8a row bit for bit: the decode <-> verify agreement of the
// layer-share ceiling without a per-layer cache write (the JAX package's
// split-boundary schedule, with the port's 256-key chunks and 64-key tiles
// in place of the TPU kernels' 1024-key chunks). f32 alone: the bf16
// instantiations went when the page walk took the bf16 route.
template <bool kFresh>
struct Cells;

template <>
struct Cells<false> {
  int ctx, b1, kb;
  bool cut;
  __device__ Cells(int, int ctx_, int b1_, int, bool)
      : ctx(ctx_), b1(min(max(b1_, 0), ctx_)), kb(b1 / kChunk),
        cut(b1 % kChunk != 0 && b1 < ctx) {}
  __device__ bool fresh(int) const { return false; }
  __device__ void bounds(int i, int& lo, int& hi) const {
    const int k = cut && i > kb ? i - 1 : i;
    lo = cut && i == kb + 1 ? b1 : k * kChunk;
    hi = cut && i == kb ? b1 : min(k * kChunk + kChunk, ctx);
  }
};

template <>
struct Cells<true> {
  int n_chunks, c0, end, cstar;
  __device__ Cells(int n_chunks_, int, int c0_, int rows, bool split)
      : n_chunks(n_chunks_), c0(c0_), end(c0_ + rows),
        cstar(split ? (c0_ / kChunk + 1) * kChunk : c0_ + rows) {}
  __device__ bool fresh(int i) const { return i >= n_chunks; }
  __device__ void bounds(int i, int& lo, int& hi) const {
    if (i < n_chunks) {
      lo = i * kChunk;
      hi = min(lo + kChunk, c0);
    } else if (i == n_chunks) {
      lo = c0;
      hi = min(cstar, end);
    } else {
      lo = cstar;
      hi = end;
    }
  }
};

// Partials of cell blockIdx.z of one (group, KV head): part_acc [rows_total,
// Hq, n_cells, D] and part_ml [rows_total, Hq, n_cells, 2] f32, written only
// for rows the cell is not empty for. bnd: b1 per row (K8a) or ctx0 per
// group (K6a, K8b); fk / fv [rows_total, Hkv * D] the fresh rows (K6a, K8b).
template <typename T, bool kFresh>
__global__ void __launch_bounds__(kThreads)
cell_partial_kernel(const T* __restrict__ q, const T* __restrict__ cache, const T* __restrict__ fk,
                    const T* __restrict__ fv, const int* __restrict__ bt,
                    const int* __restrict__ ctx, const int* __restrict__ bnd,
                    float* __restrict__ part_acc, float* __restrict__ part_ml, int rows, int rpb,
                    int m, int hq, int hkv, int d, int bs, long long k_off, long long v_off,
                    float scale, int split) {
  const int slices = (rows + rpb - 1) / rpb;
  const int grp = blockIdx.x / slices, r0 = (blockIdx.x - grp * slices) * rpb;
  const int kh = blockIdx.y, i = blockIdx.z, n_cells = gridDim.z;
  const int nr = min(rpb, rows - r0), tid = threadIdx.x, g = hq / hkv, nq = nr * g, hd = hkv * d;
  const long long row0 = (long long)grp * rows + r0;
  Flash<T> f;
  int* ctx_s = reinterpret_cast<int*>(flash_carve(f, nq, d));
  for (int r = tid; r < nr; r += blockDim.x) ctx_s[r] = ctx[row0 + r];
  __syncthreads();
  int ctx_max = 0;
  for (int r = 0; r < nr; ++r) ctx_max = max(ctx_max, ctx_s[r]);
  const Cells<kFresh> cells(n_cells - (kFresh ? 2 : 1), ctx_s[0], bnd[grp], rows, split);
  int lo, hi;
  cells.bounds(i, lo, hi);
  const int end = min(hi, ctx_max);
  if (lo >= end) return;  // uniform over the block: empty for every row

  for (int idx = tid; idx < nq * d; idx += blockDim.x) {
    const int qi = idx / d, c = idx - qi * d;
    const long long row = row0 + qi / g;
    f.qs[idx] = to_f32(q[(row * hq + kh * g + qi % g) * d + c]);
  }
  flash_init_stats(f);
  __syncthreads();

  const int* bt_row = bt + (long long)grp * m;
  for (int c0 = lo; c0 < end; c0 += kTile) {
    if (cells.fresh(i))
      stage_tile(f, kh, c0, end, FreshRows<T>{fk, fv, (long long)grp * rows, bnd[grp], hd});
    else
      stage_tile(f, kh, c0, end, PagedRows<T>{cache, bt_row, m, bs, hd, k_off, v_off});
    __syncthreads();
    flash_tile_update(f, scale, CellMask{ctx_s, g, c0, hi});
  }

  for (int idx = tid; idx < nq * d; idx += blockDim.x) {
    const int qi = idx / d, c = idx - qi * d, r = qi / g;
    if (lo >= min(hi, ctx_s[r])) continue;  // empty for this row: never read
    const long long slot = (row0 + r) * hq + kh * g + qi % g;
    part_acc[(slot * n_cells + i) * d + c] = f.acc[idx];
    if (c == 0) {
      part_ml[(slot * n_cells + i) * 2] = f.m[qi];
      part_ml[(slot * n_cells + i) * 2 + 1] = f.l[qi];
    }
  }
}

// out[row, h, :] from the row's non-empty cells, in order.
template <typename T, bool kFresh>
__global__ void __launch_bounds__(kThreads)
cell_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                    const int* __restrict__ ctx, const int* __restrict__ bnd, T* __restrict__ out,
                    int rows, int hq, int d, int n_cells, int split) {
  const long long row = blockIdx.x;
  const int lim = ctx[row];
  const Cells<kFresh> cells(n_cells - (kFresh ? 2 : 1), lim, bnd[row / rows], rows, split);
  const auto used = [&](int i) {
    int lo, hi;
    cells.bounds(i, lo, hi);
    return lo < min(hi, lim);
  };
  for (int idx = threadIdx.x; idx < hq * d; idx += blockDim.x) {
    const long long first = (row * hq + idx / d) * n_cells;
    out[row * hq * d + idx] = fold_partials<T>(part_acc, part_ml, d, idx % d, n_cells, used,
                                               [first](int i) { return first + i; });
  }
}

template <typename T, bool kFresh>
cudaError_t launch_cells(int groups, int rows, const void* q, const void* cache, const void* fk,
                         const void* fv, const int* bt, const int* ctx, const int* bnd, void* out,
                         float* part_acc, float* part_ml, int m, int hq, int hkv, int d, int bs,
                         long long k_off, long long v_off, float scale, int split,
                         cudaStream_t stream) {
  const int g = hq / hkv, rpb = flash_rows_per_block<T>(rows, g, d);
  const size_t smem = flash_smem_bytes<T>(rpb * g, d, sizeof(int) * rpb);
  cudaError_t err = flash_set_smem(cell_partial_kernel<T, kFresh>, smem);
  if (err != cudaSuccess) return err;
  const int n_cells = (m * bs + kChunk - 1) / kChunk + (kFresh ? 2 : 1);
  const int slices = (rows + rpb - 1) / rpb;
  cell_partial_kernel<T, kFresh><<<dim3(groups * slices, hkv, n_cells), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(cache), static_cast<const T*>(fk),
      static_cast<const T*>(fv), bt, ctx, bnd, part_acc, part_ml, rows, rpb, m, hq, hkv, d, bs,
      k_off, v_off, scale, split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cell_combine_kernel<T, kFresh><<<groups * rows, kThreads, 0, stream>>>(
      part_acc, part_ml, ctx, bnd, static_cast<T*>(out), rows, hq, d, n_cells, split);
  return cudaGetLastError();
}

// K8a, K6a, K8b here take f32 queries alone: bf16 ones run on the page walk
// (paged_attention_partials.cu), and a bf16 call here is refused.
template <bool kFresh>
cudaError_t dispatch_cells(int groups, int rows, const void* q, const void* cache, const void* fk,
                           const void* fv, const int* bt, const int* ctx, const int* bnd,
                           void* out, float* part_acc, float* part_ml, int m, int hq, int hkv,
                           int d, int bs, long long k_off, long long v_off, float scale, int split,
                           int is_bf16, void* stream) {
  if (is_bf16) return cudaErrorInvalidValue;
  return launch_cells<float, kFresh>(groups, rows, q, cache, fk, fv, bt, ctx, bnd, out, part_acc,
                                     part_ml, m, hq, hkv, d, bs, k_off, v_off, scale, split,
                                     static_cast<cudaStream_t>(stream));
}

// K1/K2 here take f32 queries alone: bf16 ones run on the page walk
// (paged_walk.cu's npt_walk), and a bf16 call here is refused.
cudaError_t dispatch(int groups, int rows, const void* q, const void* cache, const int* bt,
                     const int* ctx, void* out, float* part_acc, float* part_ml, int m, int hq,
                     int hkv, int d, int bs, long long k_off, long long v_off, float scale,
                     int is_bf16, void* stream) {
  if (is_bf16) return cudaErrorInvalidValue;
  return launch<float>(groups, rows, q, cache, bt, ctx, out, part_acc, part_ml, m, hq, hkv, d,
                       bs, k_off, v_off, scale, static_cast<cudaStream_t>(stream));
}

// K9a/K9b here take f32 queries alone: bf16 ones run on the page walk's
// 1-byte path (paged_walk.cu's npt_walk_q8), and a bf16 call here is refused.
cudaError_t dispatch_q8(int groups, int rows, const void* q, const void* cache,
                        const void* scales, const int* bt, const int* ctx, void* out,
                        float* part_acc, float* part_ml, int m, int hq, int hkv, int d, int bs,
                        long long k_off, long long v_off, float scale, int is_bf16, int is_fp8,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 || d % 16) return cudaErrorInvalidValue;  // 16 one-byte values per load
  if (is_fp8)
    return launch<float, __nv_fp8_e4m3>(groups, rows, q, cache, bt, ctx, out, part_acc, part_ml,
                                        m, hq, hkv, d, bs, k_off, v_off, scale, s, scales);
  return launch<float, int8_t>(groups, rows, q, cache, bt, ctx, out, part_acc, part_ml, m, hq,
                               hkv, d, bs, k_off, v_off, scale, s, scales);
}

}  // namespace npt

extern "C" {

// Key positions per partial: the wrapper sizes the scratch with it.
int npt_chunk_tokens() { return npt::kChunk; }

// Rows of a group one block folds (flash_rows_per_block) for query
// vectors of type bf16 (is_bf16) or f32, `fixed` more bytes of shared
// memory and tiles of `tile` keys: what every attention launcher of the
// port picks, exported to hold the Python mirror against it.
int npt_rows_per_block(int rows, int g, int d, int is_bf16, long long fixed, int tile) {
  return is_bf16 ? npt::flash_rows_per_block<__nv_bfloat16>(rows, g, d, (size_t)fixed, tile)
                 : npt::flash_rows_per_block<float>(rows, g, d, (size_t)fixed, tile);
}

// K1's f32 route: q, out [n, hq, d] f32 (is_bf16 must be 0); bt [n, m]; ctx
// [n]; part_acc [n, hq, n_chunks, d] and part_ml [n, hq, n_chunks, 2] f32
// scratch, n_chunks = ceil(m * bs / npt_chunk_tokens()). Returns
// cudaGetLastError().
int npt_paged_decode(const void* q, const void* cache, const int* bt, const int* ctx, void* out,
                     float* part_acc, float* part_ml, int n, int m, int hq, int hkv, int d,
                     int bs, long long k_off, long long v_off, float scale, int is_bf16,
                     void* stream) {
  return (int)npt::dispatch(n, 1, q, cache, bt, ctx, out, part_acc, part_ml, m, hq, hkv, d, bs,
                            k_off, v_off, scale, is_bf16, stream);
}

// K2's f32 route: q, out [b * rows, hq, d] f32; bt [b, m]; ctx [b * rows];
// scratch as above with b * rows rows. rows >= 2.
int npt_paged_verify(const void* q, const void* cache, const int* bt, const int* ctx, void* out,
                     float* part_acc, float* part_ml, int b, int rows, int m, int hq, int hkv,
                     int d, int bs, long long k_off, long long v_off, float scale, int is_bf16,
                     void* stream) {
  if (rows < 2) return (int)cudaErrorInvalidValue;
  return (int)npt::dispatch(b, rows, q, cache, bt, ctx, out, part_acc, part_ml, m, hq, hkv, d,
                            bs, k_off, v_off, scale, is_bf16, stream);
}

// K9a's f32 route: npt_paged_decode over a 1-byte cache (int8, or e4m3
// with is_fp8) and its bf16 scales [rows, hkv]; q, out f32 (is_bf16 must
// be 0).
int npt_paged_decode_q8(const void* q, const void* cache, const void* scales, const int* bt,
                        const int* ctx, void* out, float* part_acc, float* part_ml, int n, int m,
                        int hq, int hkv, int d, int bs, long long k_off, long long v_off,
                        float scale, int is_bf16, int is_fp8, void* stream) {
  return (int)npt::dispatch_q8(n, 1, q, cache, scales, bt, ctx, out, part_acc, part_ml, m, hq,
                               hkv, d, bs, k_off, v_off, scale, is_bf16, is_fp8, stream);
}

// K9b's f32 route: npt_paged_verify over a 1-byte cache, as K9a. rows >= 2.
int npt_paged_verify_q8(const void* q, const void* cache, const void* scales, const int* bt,
                        const int* ctx, void* out, float* part_acc, float* part_ml, int b,
                        int rows, int m, int hq, int hkv, int d, int bs, long long k_off,
                        long long v_off, float scale, int is_bf16, int is_fp8, void* stream) {
  if (rows < 2) return (int)cudaErrorInvalidValue;
  return (int)npt::dispatch_q8(b, rows, q, cache, scales, bt, ctx, out, part_acc, part_ml, m, hq,
                               hkv, d, bs, k_off, v_off, scale, is_bf16, is_fp8, stream);
}

// K8a's f32 route: npt_paged_decode on the split-boundary schedule, the
// chunk that holds b1[i] cut there for row i (is_bf16 must be 0). b1 [n]
// int32; part_acc [n, hq, n_cells, d] and
// part_ml [n, hq, n_cells, 2] f32 scratch, n_cells = ceil(m * bs /
// npt_chunk_tokens()) + 1.
int npt_paged_decode_split(const void* q, const void* cache, const int* bt, const int* ctx,
                           const int* b1, void* out, float* part_acc, float* part_ml, int n,
                           int m, int hq, int hkv, int d, int bs, long long k_off,
                           long long v_off, float scale, int is_bf16, void* stream) {
  return (int)npt::dispatch_cells<false>(n, 1, q, cache, nullptr, nullptr, bt, ctx, b1, out,
                                         part_acc, part_ml, m, hq, hkv, d, bs, k_off, v_off,
                                         scale, 0, is_bf16, stream);
}

// K6a (split 0) / K8b (split 1), f32 route (is_bf16 must be 0): the
// deferred verify of b groups of `rows` rows, 1 <= rows <=
// npt_chunk_tokens(). The cache holds positions < ctx0[g]
// of group g (read-only here); fk / fv [b * rows, hkv * d] hold its fresh
// rows, row t at position ctx0[g] + t; ctx [b * rows] each row's context
// with its visible fresh rows. Scratch as K8a with b * rows rows and
// n_cells = ceil(m * bs / npt_chunk_tokens()) + 2.
int npt_paged_verify_fresh(const void* q, const void* cache, const void* fk, const void* fv,
                           const int* bt, const int* ctx, const int* ctx0, void* out,
                           float* part_acc, float* part_ml, int b, int rows, int m, int hq,
                           int hkv, int d, int bs, long long k_off, long long v_off, float scale,
                           int split, int is_bf16, void* stream) {
  if (rows < 1 || rows > npt::kChunk) return (int)cudaErrorInvalidValue;
  return (int)npt::dispatch_cells<true>(b, rows, q, cache, fk, fv, bt, ctx, ctx0, out, part_acc,
                                        part_ml, m, hq, hkv, d, bs, k_off, v_off, scale, split,
                                        is_bf16, stream);
}

const char* npt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
