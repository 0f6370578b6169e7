// The deferred-write verify's whole-round KV writeback, for sm_90a: K12.
//
// npt_write_fresh stores one round's fresh K/V of every layer, fresh
// [L, 2, N, Hkv * D], into the paged cache [L, 2, NB + 1, BS, Hkv * D] at
// flat slots [N], in place. Replaces
// nano_pearl_tpu/ops/pallas/kv_writeback.py _kernel (entry
// write_fresh_pallas), parked in the JAX package for TPU-compiler
// reasons; the JAX package writes back with windowed dynamic-update-slices
// instead (ops/kv_cache.write_fresh_windows). Semantics of
// ops/kv_cache.write_fresh_jnp: every row goes to its own slot, padding
// rows into the garbage block. Where several rows name one slot, the last
// row wins, as a scatter applied in row order leaves it: a row skips its
// store when a later row names the same slot, so no two blocks write one
// slot and the result does not depend on their order. Slots outside the
// cache are dropped.
//
// Bound on the H100: bytes, read once and written once: 2 * L * 2 * N *
// Hkv * D elements (33 MB at the bench pair's 36 layers x 448 rows x 512
// bytes, about 10 us at 3.35 TB/s). One block per row copies the row's
// 2L planes with 16-byte loads and stores. The TPU kernel's contiguous-run
// DMAs exist for the TPU's DMA engine and have no counterpart here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace npt {

constexpr int kCopyThreads = 256;

__global__ void __launch_bounds__(kCopyThreads)
write_fresh_kernel(const uint4* __restrict__ fresh, uint4* __restrict__ cache,
                   const int* __restrict__ slots, int n, int planes, long long plane_rows,
                   int vecs) {
  const int row = blockIdx.x;
  const int slot = slots[row];
  int later = 0;
  for (int j = row + 1 + threadIdx.x; j < n; j += blockDim.x) later |= slots[j] == slot;
  if (__syncthreads_or(later) || slot < 0 || slot >= plane_rows) return;  // uniform
  const int total = planes * vecs;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int pl = i / vecs, v = i - pl * vecs;
    cache[((long long)pl * plane_rows + slot) * vecs + v] =
        fresh[((long long)pl * n + row) * vecs + v];
  }
}

}  // namespace npt

extern "C" {

// fresh [planes, n, row_bytes] and cache [planes, plane_rows, row_bytes]
// of one element type; row_bytes a multiple of 16 and both 16-byte
// aligned; slots [n] int32. Returns cudaGetLastError().
int npt_write_fresh(const void* fresh, void* cache, const int* slots, int n, int planes,
                    long long plane_rows, int row_bytes, void* stream) {
  if (row_bytes % 16 != 0 || n < 1) return (int)cudaErrorInvalidValue;
  npt::write_fresh_kernel<<<n, npt::kCopyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(fresh), static_cast<uint4*>(cache), slots, n, planes, plane_rows,
      row_bytes / 16);
  return (int)cudaGetLastError();
}

const char* npt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
