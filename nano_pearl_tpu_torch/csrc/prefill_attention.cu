// Causal prefill self-attention over the batch's fresh K/V, for sm_90a.
//
// K3 npt_prefill_self. Replaces nano_pearl_tpu/ops/pallas/
//   prefill_attention.py _prefill_self_kernel (entry
//   prefill_self_attention_pallas).
//
// q [B * Lq, Hq, D], k/v [B * Lq, Hkv, D], pos [B, Lq] (-1 = padded row),
// out [B * Lq, Hq, D]. Key j of a sequence is visible to its query i iff
// 0 <= pos[j] <= pos[i]. Prefill positions rise with the row index, so a
// key tile that starts past the query tile's last row is never visible
// and is skipped. The running max starts at kMFloor, so a query that sees
// no key at all (a padded row) gets 0, not NaN.
//
// Grid (query tiles of kQTile rows, KV heads, B); each block folds the
// kQTile * G query vectors of one KV head over the key tiles up to its
// diagonal with flash_tile_update.
//
// Bound on the H100: at the main path's shapes (Lq = 128, D = 128) each
// key tile is reused by few query rows, so the kernel moves ~bytes of
// q, k, v and out once per (query tile, key tile) pair and does
// ~4 * Lq^2 / 2 * Hq * D flops per sequence; both are far below the card's
// limits, and the fixed cost per block (staging, three barriers per tile)
// dominates.
#include "flash_tile.cuh"

namespace npt {

constexpr int kQTile = 16;  // query rows per block

struct CausalMask {
  const int* qpos;  // [kQTile] positions of the block's query rows
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
                    int d, float scale) {
  const int q0 = blockIdx.x * kQTile, kh = blockIdx.y, bi = blockIdx.z, tid = threadIdx.x;
  const int g = hq / hkv, nq = kQTile * g, hd = hkv * d;
  Flash<T> f;
  int* qpos_s = reinterpret_cast<int*>(flash_carve(f, nq, d));
  int* kpos_s = qpos_s + kQTile;
  const long long base = (long long)bi * lq;  // first flat row of the sequence

  for (int r = tid; r < kQTile; r += blockDim.x)
    qpos_s[r] = (q0 + r < lq) ? pos[base + q0 + r] : -1;
  for (int idx = tid; idx < nq * d; idx += blockDim.x) {
    const int qi = idx / d, c = idx - qi * d, i = q0 + qi / g;
    f.qs[idx] = (i < lq) ? to_f32(q[((base + i) * hq + kh * g + qi % g) * d + c]) : 0.f;
  }
  flash_init_stats(f);
  __syncthreads();

  const int k_end = min(lq, q0 + kQTile);  // keys past the diagonal are never visible
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
  const size_t smem =
      flash_smem_bytes<T>(kQTile * (hq / hkv), d, sizeof(int) * (kQTile + kTile));
  cudaError_t err = flash_set_smem(prefill_self_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kQTile - 1) / kQTile, hkv, b);
  prefill_self_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos,
      static_cast<T*>(out), lq, hq, hkv, d, scale);
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

const char* npt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
