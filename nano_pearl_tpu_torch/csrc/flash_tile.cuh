// One online-softmax (flash) update of a block's query vectors against a
// key/value tile staged in shared memory. Shared by all three attention
// kernels of the port (paged decode, packed verify, prefill):
//
//   s[qi, t]  = scale * <q[qi], k[t]>          (f32, masked to -1e30)
//   m_new     = max(m[qi], max_t s[qi, t])
//   p[qi, t]  = exp(s[qi, t] - m_new)
//   l[qi]     = l[qi] * exp(m[qi] - m_new) + sum_t p[qi, t]
//   acc[qi,:] = acc[qi,:] * exp(m[qi] - m_new) + sum_t p[qi, t] v[t,:]
//
// Every value of one query vector is computed by a fixed sequence of
// operations that does not depend on how many other query vectors the
// block holds: each score is one thread's sequential dot product over d,
// each row's max/sum is one warp's lane-strided fold plus a fixed
// butterfly, each accumulator element is one thread's sequential sum over
// t. So the packed-verify kernel (R rows of one sequence per block) gives
// every row the same bits as the decode kernel (one row per block) for the
// same query and context: the property PEARL's draft/verify agreement at
// the layer-share ceiling rests on.
//
// The head dim d is a run-time value read in 8-element vectors (16 for a
// 1-byte cache): every multiple of 16 from 16 to 256 runs. A tile holds kT
// keys, a template parameter: kTile (64) everywhere but in the f32 page
// walk of K10a-d / K11a-d (paged_walk.cuh), which stages one cache page at
// a time and takes kT 16 or 32 for pages of that size.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>
#include <vector>

namespace npt {

constexpr int kThreads = 256;   // threads per block, all kernels
constexpr int kTile = 64;       // keys per staged shared-memory tile
constexpr float kNegInf = -1e30f;
constexpr float kMFloor = -1e29f;  // running-max floor: masked rows give 0
constexpr int kMaxSmem = 232448;   // bytes a block may opt into on sm_90

extern __shared__ __align__(16) unsigned char smem_raw[];

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// 8 consecutive elements: one 16-byte load for bf16, two for f32.
__device__ __forceinline__ void copy8(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}
__device__ __forceinline__ void copy8(float* dst, const float* src) {
  reinterpret_cast<float4*>(dst)[0] = reinterpret_cast<const float4*>(src)[0];
  reinterpret_cast<float4*>(dst)[1] = reinterpret_cast<const float4*>(src)[1];
}
__device__ __forceinline__ void zero8(__nv_bfloat16* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
}
__device__ __forceinline__ void zero8(float* dst) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(0.f, 0.f, 0.f, 0.f);
  reinterpret_cast<float4*>(dst)[1] = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* out) {
  float4 a = reinterpret_cast<const float4*>(p)[0];
  float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// Shared-memory pitch of a staged K/V row, in elements: 16 bytes of
// padding keep neighbouring rows off the same banks.
__host__ __device__ __forceinline__ int kv_pitch(int d) { return d + 8; }

// Running statistics and operands of one block, all in shared memory.
template <typename T>
struct Flash {
  T* ks;         // [kT, pitch] staged keys of one KV head (kT: the tile)
  T* vs;         // [kT, pitch] staged values
  float* qs;     // [nq, D] query vectors in f32
  float* acc;    // [nq, D] unnormalised output
  float* s;      // [nq, kT] scores, then probabilities
  float* m;      // [nq] running max
  float* l;      // [nq] running sum
  float* alpha;  // [nq] rescale of the current tile
  int nq, d, pitch;
};

// Bytes of shared memory a Flash of nq query vectors over tiles of `tile`
// keys needs, plus `extra`.
template <typename T>
__host__ __device__ inline size_t flash_smem_bytes(int nq, int d, size_t extra, int tile = kTile) {
  return 2 * sizeof(T) * tile * kv_pitch(d) +
         sizeof(float) * (2 * (size_t)nq * d + (size_t)nq * tile + 3 * (size_t)nq) + extra;
}

// Rows of a group one block folds: all `rows`, halved (rounding up) while
// their query vectors (g each), one int per row and `fixed` bytes more do
// not fit in one block's shared memory. Rows are independent (the tile
// update is row-independent, flash_tile_update), so spreading a group's
// rows over several blocks changes no bit of any row. Mirrored by
// ops/cuda/paged_attention.py rows_per_block.
template <typename T>
inline int flash_rows_per_block(int rows, int g, int d, size_t fixed = 0, int tile = kTile) {
  auto smem = [&](int r) { return flash_smem_bytes<T>(r * g, d, sizeof(int) * r + fixed, tile); };
  int rpb = rows;
  while (rpb > 1 && smem(rpb) > (size_t)kMaxSmem) rpb = (rpb + 1) / 2;
  return rpb;
}

// Carve the dynamic shared memory for tiles of kT keys; returns the first
// byte after it.
template <int kT = kTile, typename T>
__device__ inline unsigned char* flash_carve(Flash<T>& f, int nq, int d) {
  f.nq = nq;
  f.d = d;
  f.pitch = kv_pitch(d);
  f.ks = reinterpret_cast<T*>(smem_raw);
  f.vs = f.ks + kT * f.pitch;
  f.qs = reinterpret_cast<float*>(f.vs + kT * f.pitch);
  f.acc = f.qs + nq * d;
  f.s = f.acc + nq * d;
  f.m = f.s + nq * kT;
  f.l = f.m + nq;
  f.alpha = f.l + nq;
  return reinterpret_cast<unsigned char*>(f.alpha + nq);
}

template <typename T>
__device__ inline void flash_init_stats(Flash<T>& f) {
  for (int i = threadIdx.x; i < f.nq * f.d; i += blockDim.x) f.acc[i] = 0.f;
  for (int i = threadIdx.x; i < f.nq; i += blockDim.x) {
    f.m[i] = kMFloor;
    f.l[i] = 0.f;
  }
}

// One flash update over the staged tile of kT keys (the carve's).
// `visible(qi, t)` says whether key t of the tile is visible to query
// vector qi. Must be called by all threads of the block; ends with a
// barrier.
template <int kT = kTile, typename T, typename Mask>
__device__ void flash_tile_update(Flash<T>& f, float scale, const Mask& visible) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nq = f.nq, d = f.d;

  for (int idx = tid; idx < nq * kT; idx += blockDim.x) {
    const int qi = idx / kT, t = idx - qi * kT;
    float sc = kNegInf;
    if (visible(qi, t)) {
      const float* qv = f.qs + qi * d;
      const T* kv = f.ks + t * f.pitch;
      float dot = 0.f;
      for (int c = 0; c < d; c += 8) {
        float kf[8];
        load8(kv + c, kf);
#pragma unroll
        for (int j = 0; j < 8; ++j) dot = fmaf(qv[c + j], kf[j], dot);
      }
      sc = dot * scale;
    }
    f.s[idx] = sc;
  }
  __syncthreads();

  for (int qi = warp; qi < nq; qi += nwarps) {
    float* srow = f.s + qi * kT;
    float mx = kNegInf;
    for (int t = lane; t < kT; t += 32) mx = fmaxf(mx, srow[t]);
#pragma unroll
    for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_prev = f.m[qi];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int t = lane; t < kT; t += 32) {
      const float p = expf(srow[t] - m_new);
      srow[t] = p;
      sum += p;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    __syncwarp();
    if (lane == 0) {
      const float a = expf(m_prev - m_new);
      f.alpha[qi] = a;
      f.l[qi] = fmaf(f.l[qi], a, sum);
      f.m[qi] = m_new;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < nq * d; idx += blockDim.x) {
    const int qi = idx / d, c = idx - qi * d;
    const float* prow = f.s + qi * kT;
    float pv = 0.f;
    for (int t = 0; t < kT; ++t) pv = fmaf(prow[t], to_f32(f.vs[t * f.pitch + c]), pv);
    f.acc[idx] = fmaf(f.acc[idx], f.alpha[qi], pv);
  }
  __syncthreads();
}

// acc / max(l, 1e-30), rounded once to the output type.
template <typename T>
__device__ __forceinline__ T flash_out(const Flash<T>& f, int idx) {
  return from_f32<T>(f.acc[idx] / fmaxf(f.l[idx / f.d], 1e-30f));
}

// ---- staging a tile and masking a cell -------------------------------

// The folded [Hkv * D] K and V rows of key position pos in the paged cache
// (cache [rows, hkv * d]; layer block offsets k_off / v_off; block table row
// bt_row of m pages).
template <typename T>
struct PagedRows {
  const T* cache;
  const int* bt_row;
  int m, bs, hd;
  long long k_off, v_off;
  __device__ void operator()(int pos, const T*& k, const T*& v) const {
    const int page = min(pos / bs, m - 1);
    const long long slot = (long long)bt_row[page] * bs + pos % bs;
    k = cache + (k_off * bs + slot) * hd;
    v = cache + (v_off * bs + slot) * hd;
  }
};

// The same for the deferred verify's fresh window: row row0 + (pos - pos0)
// of the in-operand fresh_k / fresh_v [N, hkv * d] (a group's fresh row t
// sits at key position pos0 + t).
template <typename T>
struct FreshRows {
  const T* fk;
  const T* fv;
  long long row0;
  int pos0, hd;
  __device__ void operator()(int pos, const T*& k, const T*& v) const {
    const long long r = row0 + pos - pos0;
    k = fk + r * hd;
    v = fv + r * hd;
  }
};

// Stage keys and values of positions [c0, c0 + kT) of KV head kh into
// f.ks / f.vs with 16-byte loads, zeros at and past c_end; rows(pos, k, v)
// names the K/V rows of a position below c_end. Does not end with a barrier.
template <int kT = kTile, typename T, typename Rows>
__device__ void stage_tile(Flash<T>& f, int kh, int c0, int c_end, const Rows& rows) {
  const int d = f.d, vecs = d / 8;
  for (int idx = threadIdx.x; idx < kT * vecs; idx += blockDim.x) {
    const int t = idx / vecs, c = (idx - t * vecs) * 8, pos = c0 + t;
    T* kd = f.ks + t * f.pitch + c;
    T* vd = f.vs + t * f.pitch + c;
    if (pos < c_end) {
      const T *kr, *vr;
      rows(pos, kr, vr);
      copy8(kd, kr + kh * d + c);
      copy8(vd, vr + kh * d + c);
    } else {
      zero8(kd);
      zero8(vd);
    }
  }
}

// Visibility in a cell [.., hi) of the key stream: key t of the tile at c0
// is visible to query vector qi iff its position is below hi and below its
// row's limit lim[qi / g] (shared memory).
struct CellMask {
  const int* lim;
  int g, c0, hi;
  __device__ bool operator()(int qi, int t) const {
    const int p = c0 + t;
    return p < hi && p < lim[qi / g];
  }
};

// Softmax-combine of one output element from (acc, m, l) partials: the
// cells i = 0, 1, ... (in that order) with use(i) true, each partial at
// acc[at(i) * d] and ml[at(i) * 2]; rounded once to T. Every kernel that
// folds partials in a combine pass does it here, so two kernels that give
// a row the same partials in the same order give it the same bits. Where
// m_out / l_out are given, the folded max (kMFloor where no cell is used)
// and sum go there.
template <typename T, typename Use, typename At>
__device__ __forceinline__ T fold_partials(const float* acc, const float* ml, int d, int c,
                                           int cells, const Use& use, const At& at,
                                           float* m_out = nullptr, float* l_out = nullptr) {
  float mg = kMFloor;
  for (int i = 0; i < cells; ++i)
    if (use(i)) mg = fmaxf(mg, ml[at(i) * 2]);
  float l = 0.f, a = 0.f;
  for (int i = 0; i < cells; ++i) {
    if (!use(i)) continue;
    const long long p = at(i);
    const float w = expf(ml[p * 2] - mg);
    l = fmaf(ml[p * 2 + 1], w, l);
    a = fmaf(acc[p * d + c], w, a);
  }
  if (m_out) *m_out = mg;
  if (l_out) *l_out = l;
  return from_f32<T>(a / fmaxf(l, 1e-30f));
}

// ---- 1-byte (int8 / e4m3) KV caches: K9c, and the f32 K9a/K9b, K10c/d, K11b/d ----
//
// A quantized cache holds 1-byte values in the folded [rows, Hkv * D]
// layout and one bf16 scale per (row, KV head) in [rows, Hkv]. The tile
// loader reads 16 values per 16-byte load, converts each to f32 (exact for
// both types), multiplies it by its slot's scale in f32 and rounds once to
// the query type T, then stores the tile in the layout flash_tile_update
// reads: the Pallas kernels' dequantization (_kv_head, out_dt = q.dtype).
// Everything after the load is the bf16/f32 kernels' code.

// One stored byte as the value of storage type S (int8_t or __nv_fp8_e4m3).
template <typename S>
__device__ __forceinline__ float q8_byte_to_f32(uint8_t b) {
  if constexpr (std::is_same<S, int8_t>::value) {
    return (float)(int8_t)b;
  } else {
    __nv_fp8_e4m3 x;
    x.__x = b;
    return static_cast<float>(x);
  }
}

// 16 consecutive 1-byte values at src (16-byte aligned) times `scale`,
// rounded to T, into dst (16-byte aligned).
template <typename T, typename S>
__device__ __forceinline__ void dequant16(T* dst, const uint8_t* src, float scale) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
  alignas(16) T vals[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) vals[i] = from_f32<T>(q8_byte_to_f32<S>(b[i]) * scale);
  copy8(dst, vals);
  copy8(dst + 8, vals + 8);
}

// Stage keys and values of positions [c0, c0 + kT) of KV head kh from a
// 1-byte cache (cache [rows, hkv * d], scales [rows, hkv]; layer block
// offsets k_off / v_off, block table row bt_row of m pages) into f.ks /
// f.vs, zeros past c_end. Does not end with a barrier.
template <typename T, typename S, int kT = kTile>
__device__ void stage_q8_tile(Flash<T>& f, const uint8_t* __restrict__ cache,
                              const __nv_bfloat16* __restrict__ scales, const int* bt_row,
                              int m, int bs, int hkv, int kh, long long k_off, long long v_off,
                              int c0, int c_end) {
  const int d = f.d, hd = hkv * d, vecs = d / 16;
  for (int idx = threadIdx.x; idx < kT * vecs; idx += blockDim.x) {
    const int t = idx / vecs, c = (idx - t * vecs) * 16, pos = c0 + t;
    T* kd = f.ks + t * f.pitch + c;
    T* vd = f.vs + t * f.pitch + c;
    if (pos < c_end) {
      const int page = min(pos / bs, m - 1);
      const long long slot = (long long)bt_row[page] * bs + pos % bs;
      const long long kr = k_off * bs + slot, vr = v_off * bs + slot;
      dequant16<T, S>(kd, cache + kr * hd + kh * d + c, to_f32(scales[kr * hkv + kh]));
      dequant16<T, S>(vd, cache + vr * hd + kh * d + c, to_f32(scales[vr * hkv + kh]));
    } else {
      zero8(kd);
      zero8(kd + 8);
      zero8(vd);
      zero8(vd + 8);
    }
  }
}

// Opts `kernel` into `bytes` of dynamic shared memory on the current
// device, for every launcher of the port. cudaFuncSetAttribute runs only
// for a size above every size opted into there before (the opt-in only
// grows), so a launch at a size seen before makes no such call. The
// record is keyed by (kernel address, device): its statics may be one
// object for every library that includes this header (the loader unifies
// such statics across libraries), and each library's kernels have
// addresses of their own.
inline cudaError_t flash_set_smem(const void* kernel, size_t bytes) {
  struct Opted {
    const void* kernel;
    int dev;
    size_t bytes;
  };
  static std::mutex mu;
  static std::vector<Opted> opted;
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidConfiguration;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  Opted* seen = nullptr;
  for (Opted& e : opted)
    if (e.kernel == kernel && e.dev == dev) seen = &e;
  if (seen && bytes <= seen->bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  if (seen)
    seen->bytes = bytes;
  else
    opted.push_back({kernel, dev, bytes});
  return cudaSuccess;
}

template <typename K>
inline cudaError_t flash_set_smem(K* kernel, size_t bytes) {
  return flash_set_smem(reinterpret_cast<const void*>(kernel), bytes);
}

}  // namespace npt
