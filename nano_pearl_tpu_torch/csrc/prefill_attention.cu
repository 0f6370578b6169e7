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
// key past the query tile's last real row is never visible and is not
// read. The running max starts at kMFloor, so a query that sees no key at
// all (a padded row) gets 0, not NaN. A query tile with no real row writes
// zeros and returns. The head dim is any multiple of 16 from 16 to 256.
//
// K4's rows: row i of sequence b sits at absolute position nc[b] + i and is
// real iff i < nn[b]. A real row attends to every cached position < nc[b],
// read through bt[b] [Mpre] out of the cache [L * 2 * (NB + 1), BS, Hkv * D]
// at layer offsets k_off/v_off (as K1), and to the fresh keys j <= i. An nc
// past the table (Mpre * BS) is taken as Mpre * BS, as the plain version's
// gather of Mpre pages takes it. Padded rows (i >= nn[b], all rows when
// nn = 0) give 0.
//
// Two routes, by the query type (prefill_plan picks the tiles of each and
// is exported as npt_prefill_plan, mirrored by ops/cuda/prefill_attention
// prefill_plan):
//
// bf16, tensor cores (prefill_mma_kernel<D, K4?>, on mma_tile.cuh's tile
//   step, which the page walk K10/K11 shares). A block takes one
//   (query tile of qt rows, KV head, sequence) and packs the qt * G query
//   vectors of the KV head (GQA) as the rows of its products, 16 to a warp
//   (about 64; a multiple of 16 where lcm(G, 16) rows fit eight warps).
//   S = Q K^T and O += P V run on mma.sync m16n8k16 bf16 -> f32. Q's
//   A-fragments are loaded once with ldmatrix (at D > 128 from shared
//   memory each tile, to spare registers), K's B-fragments with ldmatrix
//   and V's with ldmatrix.trans. S, O, m and l stay in registers (row max
//   and sum over each quad with shuffles), and P goes from the S
//   accumulators straight into A-fragments (FlashAttention-2's register
//   reuse): no score touches shared memory. Scores go into log2 units in
//   the exponent's FMA, so each p is one FMA and one ex2.approx (relative
//   error < 2^-22), and a key's visibility is one compare of its tag with
//   the row's position. Here the port departs from the Pallas kernel,
//   which rounds P once to bf16 (p.astype(v.dtype)) before P V: the port
//   splits P into a hi + lo pair of bf16 parts and runs two products, so P
//   keeps about 16 bits (relative error ~2^-16). With one bf16 P the
//   output misses the bf16 tolerance against the f32 reference at the
//   paths' shapes (tests/test_torch_prefill_tiles.py emulates both). l is
//   the sum of the f32 p, as in the Pallas kernel.
//   K/V tiles of 64 keys come in a ring of shared-memory stages filled with
//   16-byte cp.async.cg (K3 two, K4 three at D <= 128, else two): the copy
//   of tile n + stages - 1 is issued before the products of tile n, one
//   barrier a tile. Rows are padded by 16 bytes, so ldmatrix is free of
//   bank conflicts.
//   K3 and K4 share the kernel: K4's key stream is its nc cached keys
//   (through the block table: a block first resolves its cell's cache
//   slots into shared memory, so no copy waits on a table load) followed
//   by its fresh keys, K3's the fresh keys alone. K4 cuts a sequence's
//   stream of nc + nn keys into max(1, (nc + nn) / kCell) cells at fixed
//   positions from 0 (kCell keys each, the last one the rest), one block
//   per (query tile, KV head, sequence, cell). A sequence of one cell (a
//   prefix hit of up to 1,023 keys) is written by its blocks; the cells of
//   a longer one write f32 (acc, m, l) partials, and a combine kernel folds
//   each row's cells in order with fold_partials, as K1's split does. A
//   launch whose longest stream (Mpre * BS + Lq keys) is one cell launches
//   no combine. No atomics.
//   Row independence: a row's bits depend only on its query, its own
//   sequence's keys and the tile and cell boundaries, which are fixed by
//   key position. MMA rows are independent, each quad reduces its own
//   rows in a fixed order, a masked key is an exact no-op (p = 0), and the
//   combine reads only the row's own cells. So a row gives the same bits
//   at any bucket length, next to any other rows or sequences, and at any
//   qt (chip_smoke.py prefill_bitwise).
// f32, CUDA cores (prefill_self_kernel, prefill_prefix_kernel): the tensor
//   cores would take f32 operands as TF32 (about three decimal digits), and
//   the f32 exactness pairs hold the kernels at 1e-4. So the f32 route keeps
//   flash_tile_update (one thread's serial dot product per score), with
//   f32 query vectors and the score tile in shared memory, and no split.
//   It serves only the exactness pairs.
//
// Bound on the H100 (the bytes the function must move: q, k and v of the
// real rows, K4's cached rows, the whole output). K3 at the main path's
// shapes (32 prompts of 64 tokens in a 128-row bucket, 8x128 heads over
// 2): 6.3 MB of q, k, v and 8.4 MB of out, 14.7 MB (4.4 us at 3.35 TB/s),
// against 0.27 GFLOP (0.3 us at 989 TFLOP/s): bytes. K4 at the serve
// pair's prefix hit (8 x 512 cached + 64 new, 16x64 heads): 5.5 MB and
// 1.1 GFLOP, 1.6 us of bytes. At these shapes a launch's
// fixed cost and its longest block dominate, so the design cuts those:
// one barrier a tile, copies in flight while the tensor cores work, no
// work on rows or keys that nothing sees, and cells that spread a long
// stream over the 132 SMs. K4 at a chunked-prefill pass (2048 cached +
// 1024 new) needs 10.7 GFLOP, 10.9 us: operations. There mma.sync's issue
// rate and the softmax's per-score scalar work hold the kernel back (hi +
// lo P doubles P V's products); warpgroup MMA (wgmma) with TMA copies is
// the next step for it.
#include "flash_tile.cuh"
#include "mma_tile.cuh"

namespace npt {

constexpr int kQTile = 16;    // f32 route: query rows per block, at most
constexpr int kMmaRows = 64;  // bf16 route: query vectors per block, about
constexpr int kKeys = 64;     // bf16 route: keys per staged tile
constexpr int kCell = 512;    // bf16 K4: keys per partial (a multiple of kKeys)
// Key tags and row positions of the bf16 route (mma_tile.cuh): key t is
// visible to a row iff tag[t] <= pos(row). A cached key is visible to every
// real row, a fresh one to the rows at or past its position, an absent one
// (kNone: past the stream, or padded) to none; a padded row (kNoRow) sees
// nothing.
constexpr int kPre = INT_MIN + 1;  // tag of a cached key

// Tiles of one launch: qt query rows per block, threads per block, dynamic
// shared memory, K4's keys per cell (0: no split) and the bf16 route's K/V
// tiles in flight.
struct Plan {
  int qt, threads, cell, stages;
  size_t smem;
};

// K/V stages of the bf16 route's ring. K3's blocks fold one or two tiles
// (prompts of a bucket): two stages. K4's walk a cell of 8 to 15 tiles:
// three at D <= 128 (three blocks an SM at D 64), two above.
__host__ __device__ constexpr int mma_stages(int d, bool prefix) {
  return prefix && d <= 128 ? 3 : 2;
}

// Shared memory of the bf16 route: Q [rows, D + 8], K and V [stages, kKeys,
// D + 8] bf16, the key tags [stages, kKeys] and (K4 only) the cache slots
// of a cell's cached keys [2 * kCell] (a last cell holds up to 2 * kCell - 1).
inline size_t mma_smem_bytes(int rows, int d, int stages, bool prefix) {
  return sizeof(__nv_bfloat16) * (size_t)(d + 8) * (rows + 2 * stages * kKeys) +
         sizeof(int) * (stages * kKeys + (prefix ? 2 * kCell : 0));
}

// K4's cells of a sequence whose key stream (cached, then fresh) has
// n_keys keys: cell c < cells - 1 holds keys [c * kCell, (c + 1) * kCell),
// the last one the rest (kCell to 2 * kCell - 1 keys, or all of a shorter
// stream).
__host__ __device__ inline int key_cells(int n_keys) { return max(1, n_keys / kCell); }

inline int gcd_int(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// K3 (prefix false) or K4. bf16: qt * g query vectors a multiple of 16
// (lcm(g, 16) rows) where that fits eight warps, about kMmaRows of them;
// else qt = kMmaRows / g (at least 1) and the last warp's rows past qt * g
// idle. The registers a thread holds (O: D/2 f32, S: 32 f32) do not grow
// with qt. K4 splits in cells of kCell keys. f32: the largest qt <=
// kQTile whose flash_smem_bytes fits; no split.
inline Plan prefill_plan(int g, int d, bool bf16, bool prefix) {
  Plan p{};
  if (bf16) {
    const int unit = 16 / gcd_int(g, 16);
    p.qt = unit * g <= kThreads / 2 ? max(unit, kMmaRows / g / unit * unit) : max(1, kMmaRows / g);
    p.threads = 32 * ((p.qt * g + 15) / 16);
    p.cell = prefix ? kCell : 0;
    p.stages = mma_stages(d, prefix);
    p.smem = mma_smem_bytes(p.threads / 2, d, p.stages, prefix);
  } else {
    const auto smem = [&](int qt) {
      return flash_smem_bytes<float>(qt * g, d, sizeof(int) * (qt + kTile));
    };
    p.qt = kQTile;
    while (p.qt > 1 && smem(p.qt) > (size_t)kMaxSmem) p.qt /= 2;
    p.threads = kThreads;
    p.cell = 0;
    p.stages = 1;
    p.smem = smem(p.qt);
  }
  return p;
}

// ------------------------------------------------------- bf16: tensor cores

struct PrefillArgs {
  const __nv_bfloat16 *q, *k, *v, *cache;
  const int *pos, *bt, *ncs, *nns;  // K3: pos; K4: bt, ncs, nns
  __nv_bfloat16* out;
  float *part_acc, *part_ml;  // K4's partials [B * Lq, Hq, n_cells, D | 2] (n_cells > 1)
  long long k_off, v_off;
  int lq, hq, hkv, mpre, bs, qt, n_cells;
  float scale;
};

// One block of K3 or K4 (kPrefix): query tile blockIdx.x / n_cells, cell
// blockIdx.x % n_cells (K3: n_cells 1), KV head blockIdx.y, sequence
// blockIdx.z; blockDim.x / 32 warps of 16 query vectors each.
template <int kD, bool kPrefix>
__global__ void __launch_bounds__(kThreads) prefill_mma_kernel(const PrefillArgs a) {
  constexpr int kS = mma_stages(kD, kPrefix);  // K/V stages of the ring
  constexpr int kP = kD + 8;          // shared-memory pitch (elements)
  constexpr int kVecs = kD / 8;       // 16-byte pieces of a row
  constexpr bool kQRegs = kD <= 128;  // Q's A-fragments in registers
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nthr = blockDim.x;
  const int cell = blockIdx.x % a.n_cells, q0 = blockIdx.x / a.n_cells * a.qt;
  const int kh = blockIdx.y, bi = blockIdx.z;
  const int g = a.hq / a.hkv, nrows = a.qt * g, hd = a.hkv * kD;
  const long long base = (long long)bi * a.lq;  // first flat row of the sequence
  // nc within the table, so cells <= n_cells and a cell's slots fit kslot
  const int nc = kPrefix ? min(a.ncs[bi], a.mpre * a.bs) : 0;
  const int nn = kPrefix ? min(a.nns[bi], a.lq) : a.lq;
  const int cells = kPrefix ? key_cells(nc + nn) : 1;
  if (cell >= cells) return;  // uniform over the block
  const bool split = cells > 1;  // partials for the combine, else the output
  // Position of fresh row j < lq, -1 if padded.
  const auto fpos = [&](int j) {
    if constexpr (kPrefix) return j < nn ? j : -1;
    else return a.pos[base + j];
  };

  // One past the tile's last real row (qt <= 64), alike in every warp.
  const int rows = min(a.qt, a.lq - q0);
  const unsigned lo_real = __ballot_sync(~0u, lane < rows && fpos(q0 + lane) >= 0);
  const unsigned hi_real = __ballot_sync(~0u, lane + 32 < rows && fpos(q0 + lane + 32) >= 0);
  const int j_end = hi_real ? q0 + 64 - __clz(hi_real) : lo_real ? q0 + 32 - __clz(lo_real) : q0;
  if (j_end == q0) {  // no real row: uniform over the block
    if (!split) {     // else the combine writes the padded rows
      for (int idx = tid; idx < rows * g * kVecs; idx += nthr) {
        const int r = idx / kVecs, c = (idx - r * kVecs) * 8, i = q0 + r / g;
        *reinterpret_cast<uint4*>(a.out + ((base + i) * a.hq + kh * g + r % g) * kD + c) =
            make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }
  const int t_begin = cell * kCell;
  const int t_end = cell + 1 < cells ? min(nc + j_end, t_begin + kCell) : nc + j_end;
  if (t_begin >= t_end) return;  // past the tile's keys: the combine reads no such cell
  const int n_tiles = (t_end - t_begin + kKeys - 1) / kKeys;

  const int mrows = nthr / 2;  // 16 per warp
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [mrows, kP]
  __nv_bfloat16* ks = qs + mrows * kP;                               // [kS, kKeys, kP]
  __nv_bfloat16* vs = ks + kS * kKeys * kP;                          // [kS, kKeys, kP]
  int* ktag = reinterpret_cast<int*>(vs + kS * kKeys * kP);          // [kS, kKeys]
  int* kslot = ktag + kS * kKeys;                                     // K4: [2 * kCell]

  for (int idx = tid; idx < mrows * kVecs; idx += nthr) {
    const int r = idx / kVecs, c = (idx - r * kVecs) * 8, i = q0 + r / g;
    const bool ok = r < nrows && i < a.lq;
    cp_async16(qs + r * kP + c, ok ? a.q + ((base + i) * a.hq + kh * g + r % g) * kD + c : a.q, ok);
  }
  // The cache slots of the block's cached keys (under 2 * kCell), read
  // out of the block table once: a tile's copies then wait on no load.
  const int n_pre = max(0, min(nc, t_end) - t_begin);
  if (n_pre > 0) {  // uniform over the block
    const int* bt_row = a.bt + (long long)bi * a.mpre;
    for (int kk = tid; kk < n_pre; kk += nthr) {
      const int t = t_begin + kk;
      kslot[kk] = bt_row[t / a.bs] * a.bs + t % a.bs;
    }
    __syncthreads();
  }
  // This KV head's K/V rows: fresh ones of the sequence, and (K4) the
  // layer's cache planes, indexed by slot.
  const __nv_bfloat16* kf = a.k + base * hd + kh * kD;
  const __nv_bfloat16* vf = a.v + base * hd + kh * kD;
  const __nv_bfloat16* kc = kPrefix ? a.cache + a.k_off * a.bs * hd + kh * kD : kf;
  const __nv_bfloat16* vc = kPrefix ? a.cache + a.v_off * a.bs * hd + kh * kD : vf;
  // Keys [t0, t0 + kKeys) of the stream into stage st, zeros at and past
  // t_end, and their tags.
  const auto load_tile = [&](int n, int st) {
    const int t0 = t_begin + n * kKeys;
    __nv_bfloat16* kd = ks + st * kKeys * kP;
    __nv_bfloat16* vd = vs + st * kKeys * kP;
    for (int idx = tid; idx < kKeys * kVecs; idx += nthr) {
      const int kk = idx / kVecs, c = (idx - kk * kVecs) * 8, t = t0 + kk;
      const bool ok = t < t_end, cached = kPrefix && t < nc;
      const long long row = !ok ? 0 : cached ? kslot[t - t_begin] : t - nc;
      cp_async16(kd + kk * kP + c, (cached ? kc : kf) + row * hd + c, ok);
      cp_async16(vd + kk * kP + c, (cached ? vc : vf) + row * hd + c, ok);
    }
    for (int kk = tid; kk < kKeys; kk += nthr) {
      const int t = t0 + kk, fp = t >= nc && t < t_end ? fpos(t - nc) : -1;
      ktag[st * kKeys + kk] = t >= t_end ? kNone : t < nc ? kPre : fp >= 0 ? fp : kNone;
    }
  };
  for (int n = 0; n < kS - 1; ++n) {  // one group a stage, empty past the last tile
    if (n < n_tiles) load_tile(n, n);
    cp_async_commit();
  }

  // This thread's rows of the warp's 16: ra = lane / 4 and ra + 8.
  const int ra = warp * 16 + (lane >> 2), rb = ra + 8;
  const auto row_pos = [&](int r) {
    const int i = q0 + r / g, p = r < nrows && i < a.lq ? fpos(i) : -1;
    return p >= 0 ? p : kNoRow;
  };
  const int qpa = row_pos(ra), qpb = row_pos(rb);
  const __nv_bfloat16* qw = qs + (warp * 16 + (lane & 15)) * kP + (lane >> 4) * 8;
  unsigned qf[kQRegs ? kD / 16 : 1][4];
  float o[kD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  // Scores in log2 units (s * scale * log2 e): p = 2^(s * sl2 - m) is one
  // FMA and one ex2; m is the running max in those units (sl2 > 0, so the
  // max of the raw scores scales to it).
  const float sl2 = a.scale * kLog2e;
  float m_a = kMFloor, m_b = kMFloor, l_a = 0.f, l_b = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    const int st = n % kS;
    cp_async_wait<kS - 2>();  // tiles 0 .. n (and Q) have landed
    __syncthreads();          // ... for every thread; every warp is done with tile n - 1
    if (n + kS - 1 < n_tiles) load_tile(n + kS - 1, (n + kS - 1) % kS);  // into tile n - 1's stage
    cp_async_commit();
    if constexpr (kQRegs) {
      if (n == 0) {
#pragma unroll
        for (int ks16 = 0; ks16 < kD / 16; ++ks16) ldsm_x4(qf[ks16], qw + ks16 * 16);
      }
    }

    mma_tile_step<kD, kKeys, kQRegs>(qf, qw, ks + st * kKeys * kP, vs + st * kKeys * kP,
                                     ktag + st * kKeys, qpa, qpb, sl2, m_a, m_b, l_a, l_b, o);
  }

  // Rows ra (o[.][0..1]) and rb (o[.][2..3]): the output, or K4's partial.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra, i = q0 + r / g;
    if (r >= nrows || i >= a.lq) continue;
    const float m = half ? m_b : m_a, l = half ? l_b : l_a;
    const long long slot = (base + i) * a.hq + kh * g + r % g;
    if (split) {
      const long long p = slot * a.n_cells + cell;
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt)
        *reinterpret_cast<float2*>(a.part_acc + p * kD + dt * 8 + (lane & 3) * 2) =
            make_float2(o[dt][2 * half], o[dt][2 * half + 1]);
      if ((lane & 3) == 0)  // m in natural-log units, as fold_partials reads it
        *reinterpret_cast<float2*>(a.part_ml + p * 2) = make_float2(m * kLn2, l);
    } else {
      const float den = fmaxf(l, 1e-30f);
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(a.out + slot * kD + dt * 8 + (lane & 3) * 2) =
            __floats2bfloat162_rn(o[dt][2 * half] / den, o[dt][2 * half + 1] / den);
    }
  }
}

// K4's output row blockIdx.x (b * Lq + i) of a sequence of several cells:
// its cells that start at or before its last key (nc + i), folded in
// order; a padded row reads none and gets 0. A sequence of one cell was
// written by the main kernel.
// Grid (rows, ceil(hq * d / kThreads)): one output element a thread, so
// the cells' loads of different elements are in flight together.
__global__ void __launch_bounds__(kThreads)
prefill_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                       const int* __restrict__ ncs, const int* __restrict__ nns,
                       __nv_bfloat16* __restrict__ out, int lq, int hq, int d, int n_cells,
                       int max_nc) {
  const long long row = blockIdx.x;
  const int bi = (int)(row / lq), i = (int)(row - (long long)bi * lq);
  const int idx = blockIdx.y * blockDim.x + threadIdx.x;
  const int nc = min(ncs[bi], max_nc), nn = min(nns[bi], lq), seq_cells = key_cells(nc + nn);
  if (seq_cells == 1 || idx >= hq * d) return;
  const int cells = i < nn ? min(seq_cells, (nc + i + kCell) / kCell) : 0;
  const int h = idx / d, c = idx - h * d;
  const long long slot = row * hq + h;
  out[slot * d + c] = fold_partials<__nv_bfloat16>(
      part_acc, part_ml, d, c, cells, [](int) { return true; },
      [&](int x) { return slot * n_cells + x; });
}

// prefill_mma_kernel for head dim d (a multiple of 16 in [16, 256]) and
// K3's or K4's (prefix) stages on `grid`.
template <int kD = 16>
cudaError_t launch_mma(int d, bool prefix, const PrefillArgs& a, dim3 grid, const Plan& p,
                       cudaStream_t s) {
  if constexpr (kD > 256) {
    return cudaErrorInvalidValue;
  } else {
    if (d != kD) return launch_mma<kD + 16>(d, prefix, a, grid, p, s);
    const auto kernel = prefix ? prefill_mma_kernel<kD, true> : prefill_mma_kernel<kD, false>;
    cudaError_t err = flash_set_smem(kernel, p.smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, p.threads, p.smem, s>>>(a);
    return cudaGetLastError();
  }
}

// ------------------------------------------------------- f32: CUDA cores

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
  const int rows = min(qt, lq - q0);

  for (int r = tid; r < qt; r += blockDim.x)
    qpos_s[r] = (q0 + r < lq) ? pos[base + q0 + r] : -1;
  __syncthreads();
  int k_end = q0;  // one past the last real row: later keys are never visible
  for (int r = 0; r < rows; ++r)
    if (qpos_s[r] >= 0) k_end = q0 + r + 1;
  if (k_end == q0) {  // no real row: uniform over the block
    for (int idx = tid; idx < rows * g * d; idx += blockDim.x) {
      const int qi = idx / d, c = idx - qi * d, i = q0 + qi / g;
      out[((base + i) * hq + kh * g + qi % g) * d + c] = from_f32<T>(0.f);
    }
    return;
  }
  for (int idx = tid; idx < nq * d; idx += blockDim.x) {
    const int qi = idx / d, c = idx - qi * d, i = q0 + qi / g;
    f.qs[idx] = (i < lq) ? to_f32(q[((base + i) * hq + kh * g + qi % g) * d + c]) : 0.f;
  }
  flash_init_stats(f);
  __syncthreads();

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

// K4 on the f32 route: the prefix in kTile-key tiles staged from the block
// table with 16-byte loads (one table read per key), then the fresh tiles
// up to the diagonal, all with flash_tile_update.
template <typename T>
__global__ void __launch_bounds__(kThreads)
prefill_prefix_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ cache, const int* __restrict__ bt,
                      const int* __restrict__ ncs, const int* __restrict__ nns,
                      T* __restrict__ out, int lq, int mpre, int hq, int hkv, int d, int bs,
                      long long k_off, long long v_off, float scale, int qt) {
  const int q0 = blockIdx.x * qt, kh = blockIdx.y, bi = blockIdx.z, tid = threadIdx.x;
  const int g = hq / hkv, nq = qt * g, hd = hkv * d;
  const int nc = min(ncs[bi], mpre * bs), nn = min(nns[bi], lq);  // nc within the table
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
        const long long slot = (long long)bt_row[pos / bs] * bs + pos % bs;
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

// ------------------------------------------------------- launchers

cudaError_t launch_self(const void* q, const void* k, const void* v, const int* pos, void* out,
                        int b, int lq, int hq, int hkv, int d, float scale, bool bf16,
                        cudaStream_t s) {
  const Plan p = prefill_plan(hq / hkv, d, bf16, false);
  if (p.threads > kThreads) return cudaErrorInvalidConfiguration;
  const dim3 grid((lq + p.qt - 1) / p.qt, hkv, b);
  if (bf16) {
    PrefillArgs a{};
    a.q = static_cast<const __nv_bfloat16*>(q);
    a.k = static_cast<const __nv_bfloat16*>(k);
    a.v = static_cast<const __nv_bfloat16*>(v);
    a.pos = pos;
    a.out = static_cast<__nv_bfloat16*>(out);
    a.lq = lq;
    a.hq = hq;
    a.hkv = hkv;
    a.qt = p.qt;
    a.n_cells = 1;
    a.scale = scale;
    return launch_mma(d, false, a, grid, p, s);
  }
  cudaError_t err = flash_set_smem(prefill_self_kernel<float>, p.smem);
  if (err != cudaSuccess) return err;
  prefill_self_kernel<float><<<grid, kThreads, p.smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      pos, static_cast<float*>(out), lq, hq, hkv, d, scale, p.qt);
  return cudaGetLastError();
}

cudaError_t launch_prefix(const void* q, const void* k, const void* v, const void* cache,
                          const int* bt, const int* nc, const int* nn, void* out,
                          float* part_acc, float* part_ml, int b, int lq, int mpre, int hq,
                          int hkv, int d, int bs, long long k_off, long long v_off, float scale,
                          bool bf16, cudaStream_t s) {
  const Plan p = prefill_plan(hq / hkv, d, bf16, true);
  if (p.threads > kThreads) return cudaErrorInvalidConfiguration;
  const int q_tiles = (lq + p.qt - 1) / p.qt;
  if (bf16) {
    PrefillArgs a{};
    a.q = static_cast<const __nv_bfloat16*>(q);
    a.k = static_cast<const __nv_bfloat16*>(k);
    a.v = static_cast<const __nv_bfloat16*>(v);
    a.cache = static_cast<const __nv_bfloat16*>(cache);
    a.bt = bt;
    a.ncs = nc;
    a.nns = nn;
    a.out = static_cast<__nv_bfloat16*>(out);
    a.part_acc = part_acc;
    a.part_ml = part_ml;
    a.k_off = k_off;
    a.v_off = v_off;
    a.lq = lq;
    a.hq = hq;
    a.hkv = hkv;
    a.mpre = mpre;
    a.bs = bs;
    a.qt = p.qt;
    a.n_cells = key_cells(mpre * bs + lq);  // the most any sequence of the launch has
    a.scale = scale;
    cudaError_t err = launch_mma(d, true, a, dim3(q_tiles * a.n_cells, hkv, b), p, s);
    if (err != cudaSuccess || a.n_cells == 1) return err;
    const dim3 rows(b * lq, (hq * d + kThreads - 1) / kThreads);
    prefill_combine_kernel<<<rows, kThreads, 0, s>>>(part_acc, part_ml, nc, nn, a.out, lq, hq, d,
                                                     a.n_cells, mpre * bs);
    return cudaGetLastError();
  }
  cudaError_t err = flash_set_smem(prefill_prefix_kernel<float>, p.smem);
  if (err != cudaSuccess) return err;
  prefill_prefix_kernel<float><<<dim3(q_tiles, hkv, b), kThreads, p.smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(cache), bt, nc, nn, static_cast<float*>(out), lq, mpre, hq, hkv, d,
      bs, k_off, v_off, scale, p.qt);
  return cudaGetLastError();
}

}  // namespace npt

extern "C" {

// K3's (prefix 0) or K4's (prefix 1) tiles for g query heads per KV head,
// head dim d and bf16 (is_bf16) or f32 queries: what = 0 query rows per
// block (qt), 1 threads per block, 2 bytes of dynamic shared memory, 3 keys
// per cell (0: no split), 4 K/V stages (bf16). Exported to hold the Python
// mirror (prefill_plan) against it.
long long npt_prefill_plan(int g, int d, int is_bf16, int prefix, int what) {
  const npt::Plan p = npt::prefill_plan(g, d, is_bf16 != 0, prefix != 0);
  switch (what) {
    case 0: return p.qt;
    case 1: return p.threads;
    case 2: return (long long)p.smem;
    case 3: return p.cell;
    case 4: return p.stages;
    default: return -1;
  }
}

// Returns cudaGetLastError() after the launch.
int npt_prefill_self(const void* q, const void* k, const void* v, const int* pos, void* out,
                     int b, int lq, int hq, int hkv, int d, float scale, int is_bf16,
                     void* stream) {
  return (int)npt::launch_self(q, k, v, pos, out, b, lq, hq, hkv, d, scale, is_bf16 != 0,
                               static_cast<cudaStream_t>(stream));
}

// q, out [b * lq, hq, d]; k, v [b * lq, hkv, d]; cache as K1; bt [b, mpre];
// nc, nn [b]. bf16: part_acc [b * lq, hq, n_cells, d] and part_ml [b * lq,
// hq, n_cells, 2] f32 scratch, n_cells = max(1, (mpre * bs + lq) / cell)
// (K4's cell from npt_prefill_plan), unused (may be null) where n_cells is
// 1; f32: unused. Returns cudaGetLastError() after the launches.
int npt_prefill_prefix(const void* q, const void* k, const void* v, const void* cache,
                       const int* bt, const int* nc, const int* nn, void* out, float* part_acc,
                       float* part_ml, int b, int lq, int mpre, int hq, int hkv, int d, int bs,
                       long long k_off, long long v_off, float scale, int is_bf16, void* stream) {
  return (int)npt::launch_prefix(q, k, v, cache, bt, nc, nn, out, part_acc, part_ml, b, lq, mpre,
                                 hq, hkv, d, bs, k_off, v_off, scale, is_bf16 != 0,
                                 static_cast<cudaStream_t>(stream));
}

const char* npt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
