// The tensor-core tile of the bf16 attention kernels: the prefill kernels
// K3/K4 (csrc/prefill_attention.cu) and the page walk of K10a-d and K11a-d
// (csrc/paged_walk.cuh).
//
// A warp holds 16 query vectors as the rows of its products; this thread
// holds rows ra = lane / 4 and rb = ra + 8 of them. S = Q K^T and O += P V
// run on mma.sync m16n8k16 (bf16 in, f32 accumulate). Q's A-fragments come
// through ldmatrix (once, in registers, at D <= 128; from shared memory on
// each tile above, to spare registers), K's B-fragments through ldmatrix and
// V's through ldmatrix.trans, from tiles staged in shared memory with rows
// padded by 16 bytes (no bank conflicts). S, O, m and l stay in registers;
// a row's max and sum are reduced over its quad with shuffles in a fixed
// order. Scores go into log2 units inside the exponent's FMA, so each p is
// one FMA and one ex2.approx (relative error < 2^-22). A masked score is
// -inf, so its p is exactly 0 and a tile that a row sees nothing of
// rescales it by exactly 1. P feeds P V from the S accumulators as a hi +
// lo pair of bf16 parts (two products; P keeps about 16 bits); l is the sum
// of the f32 p.
//
// Every value of a row comes from that row's query, the tile's keys and
// values, and its mask alone, by operations whose order is fixed by the
// key's place in the tile: MMA rows are independent, and a quad reduces
// only its own row. So a row gives the same bits whichever other rows share
// its warp or block.
#pragma once

#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace npt {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// Key tags and row positions: key t of a tile is visible to a row iff
// tag[t] <= the row's position. An absent key (past the stream, padded, or
// another shard's) carries kNone; a padded row has position kNoRow.
constexpr int kNone = INT_MAX;
constexpr int kNoRow = INT_MIN;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zeros where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most n of this thread's newest copy groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A masked score: -inf, so that s * sl2 - m stays -inf at any scale (p
// exactly 0); the running max starts at kMFloor and stays finite.
__device__ __forceinline__ float masked() { return __int_as_float(0xff800000); }

// 2^x (ex2.approx: relative error < 2^-22; exactly 1 at 0, 0 at -inf).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// (x, y) as bf16 pairs hi = bf16(.) and lo = bf16(. - hi): hi + lo holds
// 16 bits of each value.
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// One online-softmax step of the warp's 16 rows over a tile of kKeys keys:
// kt, vt [kKeys, kD + 8] bf16 and tag [kKeys] in shared memory; qf the rows'
// Q A-fragments (kQRegs) or qw this lane's ldmatrix address of them; qpa,
// qpb the positions of rows ra and rb (visible iff tag <= position); sl2 the
// scale times log2 e. Updates the rows' running max m (log2 units), sum l
// and accumulators o (o[.][0..1] row ra, o[.][2..3] row rb).
template <int kD, int kKeys, bool kQRegs>
__device__ __forceinline__ void mma_tile_step(const unsigned (&qf)[kQRegs ? kD / 16 : 1][4],
                                              const __nv_bfloat16* qw, const __nv_bfloat16* kt,
                                              const __nv_bfloat16* vt, const int* tag, int qpa,
                                              int qpb, float sl2, float& m_a, float& m_b,
                                              float& l_a, float& l_b, float (&o)[kD / 8][4]) {
  constexpr int kP = kD + 8;      // shared-memory pitch (elements)
  constexpr int kNT = kKeys / 8;  // n8 tiles of S
  const int lane = threadIdx.x & 31;

  // S = Q K^T over the tile's keys.
  float s[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int ks16 = 0; ks16 < kD / 16; ++ks16) {
    unsigned af[4];
    if constexpr (kQRegs) {
      af[0] = qf[ks16][0];
      af[1] = qf[ks16][1];
      af[2] = qf[ks16][2];
      af[3] = qf[ks16][3];
    } else {
      ldsm_x4(af, qw + ks16 * 16);
    }
#pragma unroll
    for (int nb = 0; nb < kKeys / 16; ++nb) {
      unsigned b[4];
      ldsm_x4(b, kt + (nb * 16 + (lane & 7) + ((lane >> 4) << 3)) * kP + ks16 * 16 +
                     ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * nb], af, b[0], b[1]);
      mma_bf16(s[2 * nb + 1], af, b[2], b[3]);
    }
  }

  // Mask, then the online softmax of rows ra and rb (quad-wide).
  float mx_a = masked(), mx_b = masked();
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = tag[j * 8 + (lane & 3) * 2 + e];
      s[j][e] = key <= qpa ? s[j][e] : masked();
      s[j][2 + e] = key <= qpb ? s[j][2 + e] : masked();
      mx_a = fmaxf(mx_a, s[j][e]);
      mx_b = fmaxf(mx_b, s[j][2 + e]);
    }
  }
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(~0u, mx_a, x));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(~0u, mx_b, x));
  }
  const float mn_a = fmaxf(m_a, mx_a * sl2), mn_b = fmaxf(m_b, mx_b * sl2);
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[j][e] = ex2(fmaf(s[j][e], sl2, -mn_a));
      s[j][2 + e] = ex2(fmaf(s[j][2 + e], sl2, -mn_b));
      sum_a += s[j][e];
      sum_b += s[j][2 + e];
    }
  }
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    sum_a += __shfl_xor_sync(~0u, sum_a, x);
    sum_b += __shfl_xor_sync(~0u, sum_b, x);
  }
  const float al_a = ex2(m_a - mn_a), al_b = ex2(m_b - mn_b);
  l_a = fmaf(l_a, al_a, sum_a);
  l_b = fmaf(l_b, al_b, sum_b);
  m_a = mn_a;
  m_b = mn_b;
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    o[dt][0] *= al_a;
    o[dt][1] *= al_a;
    o[dt][2] *= al_b;
    o[dt][3] *= al_b;
  }

  // O += P V, P from the S accumulators as hi + lo bf16 A-fragments.
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    unsigned ph[4], pl[4];
    split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
    split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
    split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
    split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
    for (int dn = 0; dn < kD / 16; ++dn) {
      unsigned b[4];
      ldsm_x4_trans(b, vt + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * kP + dn * 16 +
                           ((lane >> 4) << 3));
      mma_bf16(o[2 * dn], ph, b[0], b[1]);
      mma_bf16(o[2 * dn + 1], ph, b[2], b[3]);
      mma_bf16(o[2 * dn], pl, b[0], b[1]);
      mma_bf16(o[2 * dn + 1], pl, b[2], b[3]);
    }
  }
}

}  // namespace npt
