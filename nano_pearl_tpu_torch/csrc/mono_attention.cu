// Grouped paged attention on the mono schedule, for sm_90a: the
// "throughput" profile's attention kernels with f32 queries, on CUDA cores
// (the mono template below).
//
// K5 npt_mono_attention: R query rows per group share one block table,
//   each row with its own (staircase) context; decode is R = 1. Replaces
//   nano_pearl_tpu/ops/pallas/paged_attention.py _grouped_kernel_db_mono
//   (entry _mono_call, stream _mono_stream).
// K7 npt_cache_partials: the same walk over the pre-round cache only,
//   exporting flash partials (o normalised, m, l) per row and head instead
//   of the normalised output: the cache half of the deferred-write verify.
//   A row with context 0 gives o = 0, m = -1e29 and l = 0. Replaces
//   _grouped_kernel_db_mono_partial (entry
//   paged_attention_pallas_grouped_cache_partials).
// K9c npt_mono_q8: K5 over a 1-byte cache (int8 or e4m3) with a bf16
//   scale per (slot, KV head), the "throughput" profile's decode and
//   verify over a quantized cache. Replaces _grouped_kernel_db_mono_q8v2
//   (entry _mono_call_q8). Only the tile load differs (flash_tile.cuh
//   stage_q8_tile).
// K6b npt_mono_fresh: the deferred-write packed verify on the mono
//   schedule in one launch: K7's walk over the cache below each group's
//   pre-round context ctx0, plus one more work item per (group, KV head)
//   whose tiles come from the in-operand fresh rows (the round's K/V, at
//   positions ctx0 .. ctx0 + R - 1), folded after the cache chunks by the
//   arrival-counter combine; returns o in the query's dtype. Writes nothing
//   to the cache. Replaces _grouped_kernel_db_mono_fresh (entry
//   _mono_call_fresh), and in the port K7 + fresh_window_partials +
//   merge_attn_partials, three launches and a dozen torch ops per layer.
//
// Where each route runs:
// - K5, K7, K6b and K9c, f32 queries: here (the f32 exactness pairs hold
//   them at 1e-4; the tensor cores would take f32 as TF32).
// - bf16 queries: not here; every entry below refuses them. At a packed
//   verify's 14 rows the template's serial dot products on CUDA cores are
//   bound by shared-memory reads, and no copy is in flight while a tile is
//   folded; the tensor-core page walk of csrc/paged_walk.cuh runs S = Q K^T
//   and P V on mma.sync behind a cp.async ring. K7 and K6b run on it through
//   csrc/paged_attention_partials.cu (npt_partials with every slot local;
//   npt_fresh_walk, the fresh window as the walk's last cell), K5 and K9c
//   through K1/K2's and K9a/K9b's launch of csrc/paged_walk.cu (npt_walk,
//   npt_walk_q8: the walk and its combine kernel, two launches a call; a
//   fold inside the walk's last block measured slower, PERF.md). Nothing
//   under the throughput profile relies on K7 or K6b giving K5's bits.
//
// The TPU kernels walk one flat stream of (group, 1024-key chunk) items
// in one grid step, counted from each group's own context, so no step
// goes to a group's empty chunks. Here: ONE launch per call. Every block
// computes the per-group chunk counts (ceil(max context of the group's
// rows / kChunk), at least 1) and their prefix sum in shared memory from
// the context array on the device, and then walks the flat work list of
// (group, key chunk, KV head) items, item = blockIdx.x, + gridDim.x, ...
// The grid is as many blocks as the card holds at once (or fewer), so
// every block stays resident and the list covers exactly the real chunks.
// The launcher asks the driver for that number (and opts the kernel into
// its shared memory) once per (instantiation, device, shared-memory size),
// not on every launch.
//
// An item folds its chunk into the group's R * G query vectors (G = Hq /
// Hkv) with flash_tile.cuh's tile update. A group with one chunk writes
// its result directly. Otherwise each item writes its (acc, m, l)
// partials, and the block that completes a (group, head) last, found with
// an arrival counter, folds that (group, head)'s partials in chunk order
// 0, 1, ... and writes the output; it also resets the counter to 0, so
// the counters are zero again when the launch ends. The fold reads the
// stored partials in a fixed order whichever block arrives last, so the
// result does not depend on the blocks' timing. Its chunks and fold order
// differ from the f32 K1/K2's (paged_attention.cu): nothing relies on f32
// K5 rows equalling K1's bit for bit (bf16 K5 rows do, on the walk).
//
// Bound on the H100: bytes. A group reads its context's K/V once per KV
// head (ctx * 2 * Hkv * D elements) and does 4 * ctx * Hq * D flops per
// row, 4 * R flops per byte at bf16 with G = 4: 4 at decode (R = 1), 56
// at the packed verify (R = 14), both under the card's ~295 flops per
// byte. The tile update runs on CUDA cores.
#include <mutex>
#include <vector>

#include "flash_tile.cuh"

namespace npt {

constexpr int kMonoChunk = 256;  // key positions per work item (4 tiles)

// Work items of group g: ceil(max row context / kMonoChunk) key chunks, at
// least 1 (a group whose rows all have context 0 still gets its floor
// outputs), at most max_chunks (the block table's width). With ctx0 (K6b):
// the chunks of the cache below ctx0[g], none for ctx0 0, then one item for
// the fresh window.
__device__ __forceinline__ int group_chunks(const int* ctx, const int* ctx0, int g, int rows,
                                            int max_chunks) {
  int c = 0;
  for (int r = 0; r < rows; ++r) c = max(c, ctx[g * rows + r]);
  if (ctx0) return min(max_chunks, (min(c, ctx0[g]) + kMonoChunk - 1) / kMonoChunk) + 1;
  return min(max_chunks, max(1, (c + kMonoChunk - 1) / kMonoChunk));
}

// cum[g] = chunks of groups 0 .. g-1, cum[groups] = all chunks: a block-wide
// exclusive scan, each thread over a contiguous run of groups. Ends with a
// barrier.
__device__ void chunk_prefix(const int* ctx, const int* ctx0, int groups, int rows, int max_chunks,
                             int* cum) {
  __shared__ int warp_sum[kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (groups + blockDim.x - 1) / blockDim.x;
  const int lo = min(groups, tid * per), hi = min(groups, lo + per);
  int local = 0;
  for (int g = lo; g < hi; ++g) local += group_chunks(ctx, ctx0, g, rows, max_chunks);
  int incl = local;  // inclusive scan within the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int before = incl - local;
  for (int w = 0; w < warp; ++w) before += warp_sum[w];
  for (int g = lo; g < hi; ++g) {
    cum[g] = before;
    before += group_chunks(ctx, ctx0, g, rows, max_chunks);
  }
  if (tid == blockDim.x - 1) cum[groups] = before;
  __syncthreads();
}

// q, out [groups * rows, hq, d]; bt [groups, m]; ctx [groups * rows].
// kPartial: also m_out, l_out [groups * rows, hq] f32. part_acc [pairs,
// hkv, rows * G, d] and part_ml [pairs, hkv, rows * G, 2] f32 scratch with
// pairs = groups * max_chunks (groups * (max_chunks + 1) with kFresh);
// counters [groups * hkv * slices], zero on entry and on exit. An item
// folds the rows [r0, r0 + rpb) of its group (slice r0 / rpb): all of
// them unless their query vectors do not fit in shared memory
// (flash_rows_per_block); each slice has its own arrival counter.
// S is the cache's storage type: T, or int8_t / __nv_fp8_e4m3 with `scales`.
// kFresh (K6b): ctx0 [groups] pre-round contexts and fk / fv [groups * rows,
// hkv * d] fresh rows (row t of group g at position ctx0[g] + t); the cache
// is read below ctx0 only and the fresh window is the group's last item.
template <typename T, typename S, bool kPartial, bool kFresh>
__global__ void __launch_bounds__(kThreads)
mono_kernel(const T* __restrict__ q, const S* __restrict__ cache,
            const __nv_bfloat16* __restrict__ scales, const int* __restrict__ bt,
            const int* __restrict__ ctx, T* __restrict__ out, float* __restrict__ m_out,
            float* __restrict__ l_out, float* part_acc, float* part_ml, int* counters,
            int groups, int rows, int rpb, int m, int hq, int hkv, int d, int bs, long long k_off,
            long long v_off, float scale, int max_chunks, const int* __restrict__ ctx0,
            const T* __restrict__ fk, const T* __restrict__ fv) {
  const int tid = threadIdx.x, g_heads = hq / hkv, hd = hkv * d;
  const int slices = (rows + rpb - 1) / rpb, nq_grp = rows * g_heads;
  Flash<T> f;
  int* ctx_s = reinterpret_cast<int*>(flash_carve(f, rpb * g_heads, d));  // [rpb]
  int* cum = ctx_s + rpb;                                                 // [groups + 1]
  __shared__ int s_last;

  chunk_prefix(ctx, kFresh ? ctx0 : nullptr, groups, rows, max_chunks, cum);
  const int total = cum[groups] * hkv * slices;

  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    const int p = item / (hkv * slices), hs = item - p * hkv * slices;
    const int kh = hs / slices, sl = hs - kh * slices, r0 = sl * rpb;
    const int nr = min(rpb, rows - r0), nq = nr * g_heads;
    f.nq = nq;  // the carve's layout is for rpb rows; this slice uses nr of them
    int lo = 0, hi = groups - 1;  // the last group with cum[g] <= p
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (cum[mid] <= p) lo = mid; else hi = mid - 1;
    }
    const int grp = lo, ci = p - cum[grp], nch = cum[grp + 1] - cum[grp];
    const long long row0 = (long long)grp * rows + r0;
    for (int r = tid; r < nr; r += blockDim.x) ctx_s[r] = ctx[row0 + r];
    for (int idx = tid; idx < nq * d; idx += blockDim.x) {
      const int qi = idx / d, c = idx - qi * d;
      const long long row = row0 + qi / g_heads;
      f.qs[idx] = to_f32(q[(row * hq + kh * g_heads + qi % g_heads) * d + c]);
    }
    flash_init_stats(f);
    __syncthreads();
    int ctx_max = 0;
    for (int r = 0; r < nr; ++r) ctx_max = max(ctx_max, ctx_s[r]);
    // the item's keys [c_lo, c_hi): a key chunk (K6b: of the cache below
    // ctx0), or K6b's fresh window [ctx0, ctx0 + rows), its tiles from ctx0
    const int c0g = kFresh ? ctx0[grp] : 0;
    const bool fresh = kFresh && ci == nch - 1;
    const int c_lo = fresh ? c0g : ci * kMonoChunk;
    const int c_hi = fresh ? c0g + rows : kFresh ? min(c_lo + kMonoChunk, c0g) : c_lo + kMonoChunk;
    const int c_end = min(ctx_max, c_hi);
    const int* bt_row = bt + (long long)grp * m;

    for (int c0 = c_lo; c0 < c_end; c0 += kTile) {
      if constexpr (!std::is_same<S, T>::value) {
        stage_q8_tile<T, S>(f, reinterpret_cast<const uint8_t*>(cache), scales, bt_row, m, bs,
                            hkv, kh, k_off, v_off, c0, c_end);
      } else if (fresh) {
        stage_tile(f, kh, c0, c_end, FreshRows<T>{fk, fv, (long long)grp * rows, c0g, hd});
      } else {
        stage_tile(f, kh, c0, c_end, PagedRows<T>{cache, bt_row, m, bs, hd, k_off, v_off});
      }
      __syncthreads();
      flash_tile_update(f, scale, CellMask{ctx_s, g_heads, c0, c_hi});
    }

    if (nch == 1) {  // the group's only chunk: write the result directly
      for (int idx = tid; idx < nq * d; idx += blockDim.x) {
        const int qi = idx / d, c = idx - qi * d;
        const long long slot = (row0 + qi / g_heads) * hq + kh * g_heads + qi % g_heads;
        out[slot * d + c] = flash_out(f, idx);
        if (kPartial && c == 0) {
          m_out[slot] = f.m[qi];
          l_out[slot] = f.l[qi];
        }
      }
    } else {
      const long long base = ((long long)p * hkv + kh) * nq_grp + (long long)r0 * g_heads;
      for (int idx = tid; idx < nq * d; idx += blockDim.x) {
        const int qi = idx / d, c = idx - qi * d;
        part_acc[(base + qi) * d + c] = f.acc[idx];
        if (c == 0) {
          part_ml[(base + qi) * 2] = f.m[qi];
          part_ml[(base + qi) * 2 + 1] = f.l[qi];
        }
      }
      __threadfence();  // this block's partials are visible before its arrival
      __syncthreads();
      int* counter = counters + ((long long)grp * hkv + kh) * slices + sl;
      if (tid == 0) s_last = atomicAdd(counter, 1) == nch - 1;
      __syncthreads();
      if (s_last) {
        __threadfence();
        const long long first = (long long)cum[grp];
        for (int idx = tid; idx < nq * d; idx += blockDim.x) {
          const int qi = idx / d, c = idx - qi * d;
          float mg = kMFloor;
          const long long qg = (long long)r0 * g_heads + qi;  // the group's query vector
          for (int ch = 0; ch < nch; ++ch)
            mg = fmaxf(mg, __ldcg(part_ml + (((first + ch) * hkv + kh) * nq_grp + qg) * 2));
          float l = 0.f, a = 0.f;
          for (int ch = 0; ch < nch; ++ch) {
            const long long at = ((first + ch) * hkv + kh) * nq_grp + qg;
            const float w = expf(__ldcg(part_ml + at * 2) - mg);
            l = fmaf(__ldcg(part_ml + at * 2 + 1), w, l);
            a = fmaf(__ldcg(part_acc + at * d + c), w, a);
          }
          const long long slot = (row0 + qi / g_heads) * hq + kh * g_heads + qi % g_heads;
          out[slot * d + c] = from_f32<T>(a / fmaxf(l, 1e-30f));
          if (kPartial && c == 0) {
            m_out[slot] = mg;
            l_out[slot] = l;
          }
        }
        if (tid == 0) *counter = 0;
      }
    }
    __syncthreads();  // shared memory is reused by the next item
  }
}

// Blocks of `kernel` the device's SMs hold at once with `smem` bytes of
// dynamic shared memory, after opting the kernel into them (flash_set_smem,
// whose opt-in only grows). The SM count and the occupancy are asked
// for once per (kernel, device, shared-memory size).
inline cudaError_t resident_blocks(const void* kernel, size_t smem, long long& blocks) {
  struct Seen {
    const void* kernel;
    int dev;
    size_t smem;
    long long blocks;
  };
  static std::mutex mu;
  static std::vector<Seen> seen;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (const Seen& e : seen) {
    if (e.kernel == kernel && e.dev == dev && e.smem == smem) {
      blocks = e.blocks;
      return cudaSuccess;
    }
  }
  if ((err = flash_set_smem(kernel, smem)) != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  blocks = (long long)sms * per_sm;
  seen.push_back({kernel, dev, smem, blocks});
  return cudaSuccess;
}

template <typename T, bool kPartial, typename S = T, bool kFresh = false>
cudaError_t launch(int groups, int rows, const void* q, const void* cache, const int* bt,
                   const int* ctx, void* out, float* m_out, float* l_out, float* part_acc,
                   float* part_ml, int* counters, int m, int hq, int hkv, int d, int bs,
                   long long k_off, long long v_off, float scale, int max_chunks,
                   cudaStream_t stream, const void* scales = nullptr,
                   const int* ctx0 = nullptr, const void* fk = nullptr,
                   const void* fv = nullptr) {
  auto kernel = mono_kernel<T, S, kPartial, kFresh>;
  const int g = hq / hkv, fixed = sizeof(int) * (groups + 1);
  const int rpb = flash_rows_per_block<T>(rows, g, d, fixed);
  const size_t smem = flash_smem_bytes<T>(rpb * g, d, sizeof(int) * rpb + fixed);
  long long resident = 0;
  cudaError_t err = resident_blocks(reinterpret_cast<const void*>(kernel), smem, resident);
  if (err != cudaSuccess) return err;
  const long long slices = (rows + rpb - 1) / rpb;
  const long long most = (long long)groups * (max_chunks + kFresh) * hkv * slices;  // items, at most
  const int grid = (int)(most < resident ? most : resident);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const S*>(cache),
      static_cast<const __nv_bfloat16*>(scales), bt, ctx, static_cast<T*>(out),
      m_out, l_out, part_acc, part_ml, counters, groups, rows, rpb, m, hq, hkv, d, bs, k_off,
      v_off, scale, max_chunks, ctx0, static_cast<const T*>(fk), static_cast<const T*>(fv));
  return cudaGetLastError();
}


}  // namespace npt

extern "C" {

// Key positions per work item: the wrapper sizes the scratch with it.
int npt_mono_chunk_tokens() { return npt::kMonoChunk; }

// K5, f32 queries (bf16 ones are refused: they take K1/K2's walk of
// paged_walk.cu). q, out [b * rows, hq, d]; bt [b, m]; ctx [b * rows],
// each >= 1; part_acc [b * max_chunks, hkv, rows * hq / hkv, d] and part_ml
// [..., 2] f32 scratch, max_chunks = ceil(m * bs / npt_mono_chunk_tokens());
// counters [b * hkv * rows] int32, zero. Returns cudaGetLastError().
int npt_mono_attention(const void* q, const void* cache, const int* bt, const int* ctx, void* out,
                       float* part_acc, float* part_ml, int* counters, int b, int rows, int m,
                       int hq, int hkv, int d, int bs, long long k_off, long long v_off,
                       float scale, int max_chunks, int is_bf16, void* stream) {
  if (is_bf16) return (int)cudaErrorInvalidValue;
  return (int)npt::launch<float, false>(b, rows, q, cache, bt, ctx, out, nullptr, nullptr, part_acc,
                                        part_ml, counters, m, hq, hkv, d, bs, k_off, v_off, scale,
                                        max_chunks, static_cast<cudaStream_t>(stream));
}

// K7, f32 queries (bf16 ones are refused: they take the walk). As K5, ctx
// >= 0, plus m_out and l_out [b * rows, hq] f32.
int npt_cache_partials(const void* q, const void* cache, const int* bt, const int* ctx, void* out,
                       float* m_out, float* l_out, float* part_acc, float* part_ml, int* counters,
                       int b, int rows, int m, int hq, int hkv, int d, int bs, long long k_off,
                       long long v_off, float scale, int max_chunks, int is_bf16, void* stream) {
  if (is_bf16) return (int)cudaErrorInvalidValue;
  return (int)npt::launch<float, true>(b, rows, q, cache, bt, ctx, out, m_out, l_out, part_acc,
                                       part_ml, counters, m, hq, hkv, d, bs, k_off, v_off, scale,
                                       max_chunks, static_cast<cudaStream_t>(stream));
}

// K6b, f32 queries (bf16 ones are refused: they take the walk): the
// deferred-write packed verify on the mono schedule. As K5 with
// ctx [b * rows] each row's context with its visible fresh rows, ctx0 [b]
// the pre-round context of each group (the cache is read below it only),
// fk / fv [b * rows, hkv * d] the fresh rows (row t of group g at position
// ctx0[g] + t), 1 <= rows <= npt_mono_chunk_tokens(); scratch of
// b * (max_chunks + 1) items.
int npt_mono_fresh(const void* q, const void* cache, const void* fk, const void* fv,
                   const int* bt, const int* ctx, const int* ctx0, void* out, float* part_acc,
                   float* part_ml, int* counters, int b, int rows, int m, int hq, int hkv, int d,
                   int bs, long long k_off, long long v_off, float scale, int max_chunks,
                   int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 || rows < 1 || rows > npt::kMonoChunk) return (int)cudaErrorInvalidValue;
  return (int)npt::launch<float, false, float, true>(
      b, rows, q, cache, bt, ctx, out, nullptr, nullptr, part_acc, part_ml, counters, m, hq, hkv,
      d, bs, k_off, v_off, scale, max_chunks, s, nullptr, ctx0, fk, fv);
}

// K9c, f32 queries (bf16 ones are refused: they take K9a/K9b's walk of
// paged_walk.cu, its 1-byte path). As K5 over a 1-byte cache (int8, or
// e4m3 with is_fp8) and its bf16 scales [rows, hkv].
int npt_mono_q8(const void* q, const void* cache, const void* scales, const int* bt,
                const int* ctx, void* out, float* part_acc, float* part_ml, int* counters, int b,
                int rows, int m, int hq, int hkv, int d, int bs, long long k_off, long long v_off,
                float scale, int max_chunks, int is_bf16, int is_fp8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 || d % 16) return (int)cudaErrorInvalidValue;  // 16 one-byte values per load
  if (is_fp8)
    return (int)npt::launch<float, false, __nv_fp8_e4m3>(b, rows, q, cache, bt, ctx, out, nullptr,
                                                         nullptr, part_acc, part_ml, counters, m,
                                                         hq, hkv, d, bs, k_off, v_off, scale,
                                                         max_chunks, s, scales);
  return (int)npt::launch<float, false, int8_t>(b, rows, q, cache, bt, ctx, out, nullptr, nullptr,
                                                part_acc, part_ml, counters, m, hq, hkv, d, bs,
                                                k_off, v_off, scale, max_chunks, s, scales);
}

const char* npt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
