// Paged attention over the layer-folded KV cache, for sm_90a.
//
// K1 npt_paged_decode: one query row per sequence (draft gamma-scan and AR
//   decode). Replaces nano_pearl_tpu/ops/pallas/paged_attention.py
//   _kernel_db (entry paged_attention_pallas).
// K2 npt_paged_verify: R packed verify rows of one sequence share one
//   block table and one load of each K/V tile, each row with its own
//   (staircase) context length. Replaces _grouped_kernel_db (entry
//   paged_attention_pallas_grouped).
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
// 2. combine, one block per row: folds the row's partials of chunks
//    0 .. ceil(ctx / kChunk) - 1 in order and rounds once to the output
//    type.
// K9a npt_paged_decode_q8 / K9b npt_paged_verify_q8: K1 / K2 over a
//   1-byte cache (int8 or e4m3) with a bf16 scale per (slot, KV head).
//   Replace _kernel_db_q8v2 (entry _db_call_q8_single, from
//   paged_attention_pallas) and _grouped_kernel_db_q8v2 (entry
//   _db_call_q8_grouped, from paged_attention_pallas_grouped). Only the
//   tile load differs (flash_tile.cuh stage_q8_tile: dequantized and
//   rounded to the query type in shared memory), so K9b rows equal K9a
//   rows bit for bit as K2's equal K1's.
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

struct PagedMask {
  const int* ctx;  // [R] context length of each row, shared memory
  int g, c0;
  __device__ bool operator()(int qi, int t) const { return c0 + t < ctx[qi / g]; }
};

// Partials of one (sequence, KV head, chunk). part_acc [rows_total, Hq,
// n_chunks, D] and part_ml [rows_total, Hq, n_chunks, 2] (m, l), f32. S is
// the cache's storage type: T, or int8_t / __nv_fp8_e4m3 with `scales`.
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
paged_partial_kernel(const T* __restrict__ q, const S* __restrict__ cache,
                     const __nv_bfloat16* __restrict__ scales,
                     const int* __restrict__ bt, const int* __restrict__ ctx,
                     float* __restrict__ part_acc, float* __restrict__ part_ml, int rows, int m,
                     int hq, int hkv, int d, int bs, long long k_off, long long v_off,
                     float scale) {
  const int grp = blockIdx.x, kh = blockIdx.y, ch = blockIdx.z, n_chunks = gridDim.z;
  const int tid = threadIdx.x, g = hq / hkv, nq = rows * g, hd = hkv * d;
  Flash<T> f;
  int* ctx_s = reinterpret_cast<int*>(flash_carve(f, nq, d));
  const int* bt_row = bt + (long long)grp * m;

  for (int r = tid; r < rows; r += blockDim.x) ctx_s[r] = ctx[grp * rows + r];
  __syncthreads();
  int ctx_max = 1;
  for (int r = 0; r < rows; ++r) ctx_max = max(ctx_max, ctx_s[r]);
  const int c_begin = ch * kChunk;
  if (c_begin >= ctx_max) return;  // uniform over the block
  const int c_end = min(ctx_max, c_begin + kChunk);

  for (int idx = tid; idx < nq * d; idx += blockDim.x) {
    const int qi = idx / d, c = idx - qi * d;
    const long long row = (long long)grp * rows + qi / g;
    f.qs[idx] = to_f32(q[(row * hq + kh * g + qi % g) * d + c]);
  }
  flash_init_stats(f);
  __syncthreads();

  const int vecs = d / 8;
  for (int c0 = c_begin; c0 < c_end; c0 += kTile) {
    if constexpr (!std::is_same<S, T>::value) {
      stage_q8_tile<T, S>(f, reinterpret_cast<const uint8_t*>(cache), scales, bt_row, m, bs, hkv,
                          kh, k_off, v_off, c0, c_end);
    } else {
      for (int idx = tid; idx < kTile * vecs; idx += blockDim.x) {
        const int t = idx / vecs, c = (idx - t * vecs) * 8, pos = c0 + t;
        T* kd = f.ks + t * f.pitch + c;
        T* vd = f.vs + t * f.pitch + c;
        if (pos < c_end) {
          const int page = min(pos / bs, m - 1);
          const long long slot = (long long)bt_row[page] * bs + pos % bs;
          copy8(kd, cache + (k_off * bs + slot) * hd + kh * d + c);
          copy8(vd, cache + (v_off * bs + slot) * hd + kh * d + c);
        } else {
          zero8(kd);
          zero8(vd);
        }
      }
    }
    __syncthreads();
    flash_tile_update(f, scale, PagedMask{ctx_s, g, c0});
  }

  for (int idx = tid; idx < nq * d; idx += blockDim.x) {
    const int qi = idx / d, c = idx - qi * d, r = qi / g;
    if (c_begin >= ctx_s[r]) continue;  // the combine never reads this chunk
    const long long slot = ((long long)grp * rows + r) * hq + kh * g + qi % g;
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
    const int h = idx / d, c = idx - h * d;
    const long long slot = row * hq + h;
    const float* ml = part_ml + slot * n_chunks * 2;
    float mg = kMFloor;
    for (int ch = 0; ch < nc; ++ch) mg = fmaxf(mg, ml[2 * ch]);
    float l = 0.f, a = 0.f;
    for (int ch = 0; ch < nc; ++ch) {
      const float w = expf(ml[2 * ch] - mg);
      l = fmaf(ml[2 * ch + 1], w, l);
      a = fmaf(part_acc[(slot * n_chunks + ch) * d + c], w, a);
    }
    out[slot * d + c] = from_f32<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T, typename S = T>
cudaError_t launch(int groups, int rows, const void* q, const void* cache, const int* bt,
                   const int* ctx, void* out, float* part_acc, float* part_ml, int m, int hq,
                   int hkv, int d, int bs, long long k_off, long long v_off, float scale,
                   cudaStream_t stream, const void* scales = nullptr) {
  const size_t smem = flash_smem_bytes<T>(rows * (hq / hkv), d, sizeof(int) * rows);
  cudaError_t err = flash_set_smem(paged_partial_kernel<T, S>, smem);
  if (err != cudaSuccess) return err;
  const int n_chunks = (m * bs + kChunk - 1) / kChunk;
  paged_partial_kernel<T, S><<<dim3(groups, hkv, n_chunks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const S*>(cache),
      static_cast<const __nv_bfloat16*>(scales), bt, ctx, part_acc, part_ml, rows, m, hq, hkv, d,
      bs, k_off, v_off, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<T><<<groups * rows, kThreads, 0, stream>>>(
      part_acc, part_ml, ctx, static_cast<T*>(out), hq, d, n_chunks);
  return cudaGetLastError();
}

cudaError_t dispatch(int groups, int rows, const void* q, const void* cache, const int* bt,
                     const int* ctx, void* out, float* part_acc, float* part_ml, int m, int hq,
                     int hkv, int d, int bs, long long k_off, long long v_off, float scale,
                     int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(groups, rows, q, cache, bt, ctx, out, part_acc, part_ml, m, hq,
                                 hkv, d, bs, k_off, v_off, scale, s);
  return launch<float>(groups, rows, q, cache, bt, ctx, out, part_acc, part_ml, m, hq, hkv, d,
                       bs, k_off, v_off, scale, s);
}

template <typename T>
cudaError_t dispatch_q8_type(int groups, int rows, const void* q, const void* cache,
                             const void* scales, const int* bt, const int* ctx, void* out,
                             float* part_acc, float* part_ml, int m, int hq, int hkv, int d, int bs,
                             long long k_off, long long v_off, float scale, int is_fp8,
                             cudaStream_t s) {
  if (is_fp8)
    return launch<T, __nv_fp8_e4m3>(groups, rows, q, cache, bt, ctx, out, part_acc, part_ml, m,
                                    hq, hkv, d, bs, k_off, v_off, scale, s, scales);
  return launch<T, int8_t>(groups, rows, q, cache, bt, ctx, out, part_acc, part_ml, m, hq, hkv,
                           d, bs, k_off, v_off, scale, s, scales);
}

cudaError_t dispatch_q8(int groups, int rows, const void* q, const void* cache,
                        const void* scales, const int* bt, const int* ctx, void* out,
                        float* part_acc, float* part_ml, int m, int hq, int hkv, int d, int bs,
                        long long k_off, long long v_off, float scale, int is_bf16, int is_fp8,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 16) return cudaErrorInvalidValue;  // 16 one-byte values per load
  if (is_bf16)
    return dispatch_q8_type<__nv_bfloat16>(groups, rows, q, cache, scales, bt, ctx, out, part_acc,
                                           part_ml, m, hq, hkv, d, bs, k_off, v_off, scale,
                                           is_fp8, s);
  return dispatch_q8_type<float>(groups, rows, q, cache, scales, bt, ctx, out, part_acc, part_ml,
                                 m, hq, hkv, d, bs, k_off, v_off, scale, is_fp8, s);
}

}  // namespace npt

extern "C" {

// Key positions per partial: the wrapper sizes the scratch with it.
int npt_chunk_tokens() { return npt::kChunk; }

// q, out [n, hq, d]; bt [n, m]; ctx [n]; part_acc [n, hq, n_chunks, d] and
// part_ml [n, hq, n_chunks, 2] f32 scratch, n_chunks = ceil(m * bs /
// npt_chunk_tokens()). Returns cudaGetLastError().
int npt_paged_decode(const void* q, const void* cache, const int* bt, const int* ctx, void* out,
                     float* part_acc, float* part_ml, int n, int m, int hq, int hkv, int d,
                     int bs, long long k_off, long long v_off, float scale, int is_bf16,
                     void* stream) {
  return (int)npt::dispatch(n, 1, q, cache, bt, ctx, out, part_acc, part_ml, m, hq, hkv, d, bs,
                            k_off, v_off, scale, is_bf16, stream);
}

// q, out [b * rows, hq, d]; bt [b, m]; ctx [b * rows]; scratch as above
// with b * rows rows. rows >= 2.
int npt_paged_verify(const void* q, const void* cache, const int* bt, const int* ctx, void* out,
                     float* part_acc, float* part_ml, int b, int rows, int m, int hq, int hkv,
                     int d, int bs, long long k_off, long long v_off, float scale, int is_bf16,
                     void* stream) {
  if (rows < 2) return (int)cudaErrorInvalidValue;
  return (int)npt::dispatch(b, rows, q, cache, bt, ctx, out, part_acc, part_ml, m, hq, hkv, d,
                            bs, k_off, v_off, scale, is_bf16, stream);
}

// K9a: npt_paged_decode over a 1-byte cache (int8, or e4m3 with is_fp8)
// and its bf16 scales [rows, hkv]; q, out bf16 or f32 (is_bf16).
int npt_paged_decode_q8(const void* q, const void* cache, const void* scales, const int* bt,
                        const int* ctx, void* out, float* part_acc, float* part_ml, int n, int m,
                        int hq, int hkv, int d, int bs, long long k_off, long long v_off,
                        float scale, int is_bf16, int is_fp8, void* stream) {
  return (int)npt::dispatch_q8(n, 1, q, cache, scales, bt, ctx, out, part_acc, part_ml, m, hq,
                               hkv, d, bs, k_off, v_off, scale, is_bf16, is_fp8, stream);
}

// K9b: npt_paged_verify over a 1-byte cache, as K9a. rows >= 2.
int npt_paged_verify_q8(const void* q, const void* cache, const void* scales, const int* bt,
                        const int* ctx, void* out, float* part_acc, float* part_ml, int b,
                        int rows, int m, int hq, int hkv, int d, int bs, long long k_off,
                        long long v_off, float scale, int is_bf16, int is_fp8, void* stream) {
  if (rows < 2) return (int)cudaErrorInvalidValue;
  return (int)npt::dispatch_q8(b, rows, q, cache, scales, bt, ctx, out, part_acc, part_ml, m, hq,
                               hkv, d, bs, k_off, v_off, scale, is_bf16, is_fp8, stream);
}

const char* npt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
