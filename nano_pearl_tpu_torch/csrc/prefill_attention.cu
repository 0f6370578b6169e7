// Prefill attention for sm_90a: causal self-attention over the batch's
// fresh K/V (K3), and the same over a cached prefix read out of the paged
// cache first (K4).
//
// K3 npt_prefill_self. Replaces nano_pearl_tpu/ops/pallas/
//   prefill_attention.py _prefill_self_kernel (entry
//   prefill_self_attention_pallas).
// K4 npt_prefill_prefix. Replaces _prefill_prefix_kernel (entry
//   prefill_prefix_attention_pallas) in the same file.
//
// q [B * Lq, Hq, D], k/v [B * Lq, Hkv, D], pos [B, Lq] (-1 = padded row),
// out [B * Lq, Hq, D]. Key j of a sequence is visible to its query i iff
// 0 <= pos[j] <= pos[i]. Prefill positions rise with the row index, so a
// key tile that starts past the query tile's last row is never visible
// and is skipped. The running max starts at kMFloor, so a query that sees
// no key at all (a padded row) gets 0, not NaN.
//
// Grid (query tiles of qt rows, KV heads, B); each block folds the qt * G
// query vectors of one KV head over the key tiles up to its diagonal with
// flash_tile_update. qt is kQTile, halved until the block's shared memory
// fits (D 256 with many query heads per KV head, or f32); a row's result
// does not depend on qt (the tiles past its diagonal are exact no-ops).
// The head dim is any multiple of 16 from 16 to 256 (flash_tile.cuh).
//
// Bound on the H100: at the main path's shapes (Lq = 128, D = 128) each
// key tile is reused by few query rows, so the kernel moves ~bytes of
// q, k, v and out once per (query tile, key tile) pair and does
// ~4 * Lq^2 / 2 * Hq * D flops per sequence; both are far below the card's
// limits, and the fixed cost per block (staging, three barriers per tile)
// dominates.
#include "flash_tile.cuh"

namespace npt {

constexpr int kQTile = 16;  // query rows per block, at most

// The largest query tile of at most kQTile rows whose block's shared
// memory (flash_smem_bytes of qt * g query vectors plus extra(qt)) fits.
template <typename T, typename Extra>
int query_tile(int g, int d, const Extra& extra) {
  int qt = kQTile;
  while (qt > 1 && flash_smem_bytes<T>(qt * g, d, extra(qt)) > (size_t)kMaxSmem) qt /= 2;
  return qt;
}

struct CausalMask {
  const int* qpos;  // [qt] positions of the block's query rows
  const int* kpos;  // [kTile] positions of the staged keys
  int g;
  __device__ bool operator()(int qi, int t) const {
    const int kp = kpos[t];
    return kp >= 0 && kp <= qpos[qi / g];
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
prefill_self_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ pos, T* __restrict__ out, int lq, int hq, int hkv,
                    int d, float scale, int qt) {
  const int q0 = blockIdx.x * qt, kh = blockIdx.y, bi = blockIdx.z, tid = threadIdx.x;
  const int g = hq / hkv, nq = qt * g, hd = hkv * d;
  Flash<T> f;
  int* qpos_s = reinterpret_cast<int*>(flash_carve(f, nq, d));
  int* kpos_s = qpos_s + qt;
  const long long base = (long long)bi * lq;  // first flat row of the sequence

  for (int r = tid; r < qt; r += blockDim.x)
    qpos_s[r] = (q0 + r < lq) ? pos[base + q0 + r] : -1;
  for (int idx = tid; idx < nq * d; idx += blockDim.x) {
    const int qi = idx / d, c = idx - qi * d, i = q0 + qi / g;
    f.qs[idx] = (i < lq) ? to_f32(q[((base + i) * hq + kh * g + qi % g) * d + c]) : 0.f;
  }
  flash_init_stats(f);
  __syncthreads();

  const int k_end = min(lq, q0 + qt);  // keys past the diagonal are never visible
  const int vecs = d / 8;
  for (int c0 = 0; c0 < k_end; c0 += kTile) {
    for (int idx = tid; idx < kTile * vecs; idx += blockDim.x) {
      const int t = idx / vecs, c = (idx - t * vecs) * 8, j = c0 + t;
      T* kd = f.ks + t * f.pitch + c;
      T* vd = f.vs + t * f.pitch + c;
      if (j < k_end) {
        const long long off = (base + j) * hd + kh * d + c;
        copy8(kd, k + off);
        copy8(vd, v + off);
      } else {
        zero8(kd);
        zero8(vd);
      }
    }
    for (int t = tid; t < kTile; t += blockDim.x) kpos_s[t] = (c0 + t < k_end) ? pos[base + c0 + t] : -1;
    __syncthreads();
    flash_tile_update(f, scale, CausalMask{qpos_s, kpos_s, g});
  }

  for (int idx = tid; idx < nq * d; idx += blockDim.x) {
    const int qi = idx / d, c = idx - qi * d, i = q0 + qi / g;
    if (i < lq) out[((base + i) * hq + kh * g + qi % g) * d + c] = flash_out(f, idx);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pos, void* out, int b,
                   int lq, int hq, int hkv, int d, float scale, cudaStream_t stream) {
  const auto extra = [](int qt) { return sizeof(int) * (qt + kTile); };
  const int g = hq / hkv, qt = query_tile<T>(g, d, extra);
  const size_t smem = flash_smem_bytes<T>(qt * g, d, extra(qt));
  cudaError_t err = flash_set_smem(prefill_self_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + qt - 1) / qt, hkv, b);
  prefill_self_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos,
      static_cast<T*>(out), lq, hq, hkv, d, scale, qt);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- K4
//
// Prefill of sequences whose first nc[b] positions are already in the
// paged cache (a prefix-cache hit, or the earlier passes of a chunked
// prefill). q [B * Lq, Hq, D] and the fresh k/v [B * Lq, Hkv, D] hold the
// new rows; row i of sequence b sits at absolute position nc[b] + i and
// is real iff i < nn[b]. A real row attends to
//   - every cached position < nc[b], read through bt[b] [Mpre] out of the
//     cache [L * 2 * (NB + 1), BS, Hkv * D] at layer offsets k_off/v_off
//     (as K1), and
//   - the fresh keys j <= i (all real, since i < nn[b]).
// A padded row (i >= nn[b]) sees nothing and gets 0: the running max
// starts at kMFloor and the sum is clamped at 1e-30, so a sequence with
// nn = 0 writes zeros, not NaN.
//
// Grid (query tiles of qt rows, KV heads, B), as K3. Each block folds
// its qt * G query vectors first over the prefix in kTile-key tiles
// staged from the block table with 16-byte loads (one table read per
// key), then over the fresh tiles up to its diagonal, all with
// flash_tile_update. A tile with no real row returns after writing zeros.
//
// Bound on the H100: at the serving shapes (8 sequences x 512 cached + 64
// new rows, Hq 16, D 64) the kernel must move ~4.5 MB (q and out once,
// the prefix K/V once, the fresh K/V once) and do ~1.1 GFLOP, about
// 1.3 us of either; like K3 it is held back by its fixed cost per tile
// (staging, three barriers) and by CUDA-core arithmetic on a few blocks.

struct PrefixMask {
  int q0, g, nn, nc, c0;
  __device__ bool operator()(int qi, int t) const {
    return q0 + qi / g < nn && c0 + t < nc;
  }
};

struct FreshMask {
  int q0, g, nn, c0;
  __device__ bool operator()(int qi, int t) const {
    const int i = q0 + qi / g;
    return i < nn && c0 + t <= i;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
prefill_prefix_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ cache, const int* __restrict__ bt,
                      const int* __restrict__ ncs, const int* __restrict__ nns,
                      T* __restrict__ out, int lq, int mpre, int hq, int hkv, int d, int bs,
                      long long k_off, long long v_off, float scale, int qt) {
  const int q0 = blockIdx.x * qt, kh = blockIdx.y, bi = blockIdx.z, tid = threadIdx.x;
  const int g = hq / hkv, nq = qt * g, hd = hkv * d;
  const int nc = ncs[bi], nn = min(nns[bi], lq);
  const long long base = (long long)bi * lq;  // first flat row of the sequence
  const int rows = min(qt, lq - q0);

  if (q0 >= nn) {  // no real row in this tile: uniform over the block
    for (int idx = tid; idx < rows * g * d; idx += blockDim.x) {
      const int qi = idx / d, c = idx - qi * d, i = q0 + qi / g;
      out[((base + i) * hq + kh * g + qi % g) * d + c] = from_f32<T>(0.f);
    }
    return;
  }

  Flash<T> f;
  flash_carve(f, nq, d);
  for (int idx = tid; idx < nq * d; idx += blockDim.x) {
    const int qi = idx / d, c = idx - qi * d, i = q0 + qi / g;
    f.qs[idx] = (i < nn) ? to_f32(q[((base + i) * hq + kh * g + qi % g) * d + c]) : 0.f;
  }
  flash_init_stats(f);
  __syncthreads();

  const int vecs = d / 8;
  const int* bt_row = bt + (long long)bi * mpre;
  for (int c0 = 0; c0 < nc; c0 += kTile) {  // cached prefix, through the table
    for (int idx = tid; idx < kTile * vecs; idx += blockDim.x) {
      const int t = idx / vecs, c = (idx - t * vecs) * 8, pos = c0 + t;
      T* kd = f.ks + t * f.pitch + c;
      T* vd = f.vs + t * f.pitch + c;
      if (pos < nc) {
        const int page = min(pos / bs, mpre - 1);
        const long long slot = (long long)bt_row[page] * bs + pos % bs;
        copy8(kd, cache + (k_off * bs + slot) * hd + kh * d + c);
        copy8(vd, cache + (v_off * bs + slot) * hd + kh * d + c);
      } else {
        zero8(kd);
        zero8(vd);
      }
    }
    __syncthreads();
    flash_tile_update(f, scale, PrefixMask{q0, g, nn, nc, c0});
  }

  const int k_end = min(nn, q0 + qt);  // fresh keys past the diagonal are never visible
  for (int c0 = 0; c0 < k_end; c0 += kTile) {
    for (int idx = tid; idx < kTile * vecs; idx += blockDim.x) {
      const int t = idx / vecs, c = (idx - t * vecs) * 8, j = c0 + t;
      T* kd = f.ks + t * f.pitch + c;
      T* vd = f.vs + t * f.pitch + c;
      if (j < k_end) {
        const long long off = (base + j) * hd + kh * d + c;
        copy8(kd, k + off);
        copy8(vd, v + off);
      } else {
        zero8(kd);
        zero8(vd);
      }
    }
    __syncthreads();
    flash_tile_update(f, scale, FreshMask{q0, g, nn, c0});
  }

  for (int idx = tid; idx < rows * g * d; idx += blockDim.x) {
    const int qi = idx / d, c = idx - qi * d, i = q0 + qi / g;
    out[((base + i) * hq + kh * g + qi % g) * d + c] = flash_out(f, idx);
  }
}

template <typename T>
cudaError_t launch_prefix(const void* q, const void* k, const void* v, const void* cache,
                          const int* bt, const int* nc, const int* nn, void* out, int b, int lq,
                          int mpre, int hq, int hkv, int d, int bs, long long k_off,
                          long long v_off, float scale, cudaStream_t stream) {
  const auto extra = [](int) { return (size_t)0; };
  const int g = hq / hkv, qt = query_tile<T>(g, d, extra);
  const size_t smem = flash_smem_bytes<T>(qt * g, d, 0);
  cudaError_t err = flash_set_smem(prefill_prefix_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + qt - 1) / qt, hkv, b);
  prefill_prefix_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(cache), bt, nc, nn, static_cast<T*>(out), lq, mpre, hq, hkv, d, bs,
      k_off, v_off, scale, qt);
  return cudaGetLastError();
}

}  // namespace npt

extern "C" {

// Returns cudaGetLastError() after the launch.
int npt_prefill_self(const void* q, const void* k, const void* v, const int* pos, void* out,
                     int b, int lq, int hq, int hkv, int d, float scale, int is_bf16,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)npt::launch<__nv_bfloat16>(q, k, v, pos, out, b, lq, hq, hkv, d, scale, s);
  return (int)npt::launch<float>(q, k, v, pos, out, b, lq, hq, hkv, d, scale, s);
}

// q, out [b * lq, hq, d]; k, v [b * lq, hkv, d]; cache as K1; bt [b, mpre];
// nc, nn [b]. Returns cudaGetLastError() after the launch.
int npt_prefill_prefix(const void* q, const void* k, const void* v, const void* cache,
                       const int* bt, const int* nc, const int* nn, void* out, int b, int lq,
                       int mpre, int hq, int hkv, int d, int bs, long long k_off, long long v_off,
                       float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)npt::launch_prefix<__nv_bfloat16>(q, k, v, cache, bt, nc, nn, out, b, lq, mpre,
                                                  hq, hkv, d, bs, k_off, v_off, scale, s);
  return (int)npt::launch_prefix<float>(q, k, v, cache, bt, nc, nn, out, b, lq, mpre, hq, hkv, d,
                                        bs, k_off, v_off, scale, s);
}

const char* npt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
