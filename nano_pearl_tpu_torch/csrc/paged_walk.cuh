// The page walk shared by the paged decode and packed verify of
// csrc/paged_walk.cu (the main path's K1 and K2, with bf16 queries, and
// over a 1-byte cache K9a and K9b; the fallbacks K10a-d), the per-shard
// partials kernels K11a-d of sequence parallelism and, with bf16 queries,
// the deferred verify's kernels K7 and K6b of the mono schedule, K6a of the
// db schedule and the split-boundary schedule's K8a and K8b
// (csrc/paged_attention_partials.cu); the mono schedule's K5 and, over a
// 1-byte cache, K9c launch paged_walk.cu's K1/K2 (K9a/K9b) launch with bf16
// queries. The f32 routes of K1/K2, K9a/K9b, K6a, K8a and K8b stay on
// paged_attention.cu's chunk template, those of K5, K7, K6b and K9c on
// mono_attention.cu. R rows of a group share one block
// table (R = 1: decode), each row masked at its own context; K11 also skips
// the slots `is_local` marks as another shard's and exports (o, m, l), as
// K7 does with every slot local. A context past the table (M * BS keys) is
// taken as M * BS, as the plain versions' gather of M pages takes it.
//
// Two routes, by the query type (walk_plan picks the tiles of each; it is
// exported as npt_walk_plan and mirrored by ops/cuda/paged_walk.walk_plan):
//
// bf16 queries (cache bf16, int8 or e4m3): tensor cores, walk_mma_kernel<D, kCells>
// (kCells: the launch has fresh or cut cells, K6a/K6b/K8a/K8b; the other
// launches keep the table's cells alone, with no cell arithmetic to pay).
// - The rows of the products are the R * G query vectors of one (group, KV
//   head), 16 to a warp (mma_tile.cuh's step: S = Q K^T and O += P V on
//   mma.sync m16n8k16, S, O, m and l in registers). A decode row's G
//   vectors fill part of one 16-row tile. At most 8 warps of rows a block;
//   a group's rows are spread over blocks beyond that (walk_plan's rpb).
//   Blocks hold at least 4 warps: the spare ones help copy and dequantize.
// - Cells: each table's key stream is cut into cells of `cell` keys at
//   fixed positions from key 0 (128 keys where Hkv <= 2, else 256: a
//   function of the cache's shape alone, never of R, the group count or
//   the batch, so a decode and a verify over the same table take the same
//   cells). One block per (group, KV head, row slice, cell). At the
//   chip_smoke rows (contexts 65-2300, pages of 256) chip_smoke.py counts
//   180 blocks that work for K11d on shard 0 of two (256-key cells would
//   give about half, under the 132 SMs), 415 for K10b, 820 for K10a and
//   302 for K11b; its K1/K2 rows print theirs (plan_blocks). A launch
//   of one cell (a table of M * BS <= cell keys, with no fresh or cut cell)
//   writes its outputs directly; otherwise each cell writes f32 (acc, m, l)
//   partials and a
//   combine kernel folds each row's cells in cell order with
//   fold_partials, as K1/K2's 256-key split does.
// - The fresh cell (K6a, K6b; bf16 route only): the deferred verify reads
//   the round's K/V from the fresh rows fk / fv [groups * R, Hkv * D] (row t
//   of group g at position ctx0[g] + t), not from the cache, which holds the
//   group's pre-round context ctx0[g] alone. The launch takes one more cell
//   after the table's: the cache cells cover [0, ctx0[g]), a row of
//   context ctx seeing min(ctx, ctx0[g]) of them; the last cell holds the R
//   fresh keys, tagged with their positions, a row seeing those below its
//   context (the tag <= position rule of mma_tile.cuh). Its keys come
//   straight from their fresh rows (no table). The combine folds a row's
//   cache cells with l > 0 in order, then the fresh cell: the order of the
//   Pallas kernel (cache chunks, then the window). ctx0 = 0 leaves every
//   cache cell empty. Nothing in the cell is one schedule's own but its
//   operands, so the db schedule's K6a and the mono schedule's K6b share
//   one launch (npt_fresh_walk) and give equal bits.
// - The cut cell (K8a, K8b; bf16 route only): a per-group position cut[g].
//   K8a (decode, cut = b1): the table's cell that holds b1 is cut there
//   into [k * cell, b1) and [b1, (k + 1) * cell), the second one's tiles
//   starting at b1, so the launch has one more cell (left empty where b1 is
//   a cell multiple or not inside the table). K8b (deferred verify, cut =
//   ctx0, R <= cell): the cache cells as K6a's, then the fresh window cut
//   at cstar = (ctx0 / cell + 1) * cell into [ctx0, cstar), tiles from
//   fresh row 0, and [cstar, ctx0 + R), tiles from fresh row cstar - ctx0.
//   WalkCells sets out every launch's cells; the walk and the combine both
//   read them there.
// - Copies: a block first resolves its cell's table slots (and, over a
//   1-byte cache, the K and V scales of each slot) into shared memory, so
//   no copy waits on a table load. K/V tiles of 64 keys then come through
//   a ring of 2-3 stages filled with 16-byte cp.async.cg: the copy of
//   tile n + stages - 1 is issued before the products of tile n, one
//   barrier a tile. Keys that no row of the block sees (past the slice's
//   longest context, or another shard's) are zero-filled, never read.
//   Over a 1-byte cache the ring carries the raw bytes; each tile is
//   dequantized in shared memory to bf16 (value x scale, rounded once to
//   the query type, as K9c and the plain versions do) before ldmatrix,
//   which costs a second barrier a tile.
// - P: the Pallas kernels round P once to the value type before P V
//   (_gr_update, p.astype(vdt), ops/pallas/paged_attention.py:140-195).
//   The port keeps P as hi + lo bf16 parts (about 16 bits) because its
//   plain versions keep f32 P: at K10b's and K11d's row shapes one bf16 P
//   meets the bf16 tolerance against them over contexts of 65-2300 keys,
//   but misses it over contexts of 1-64 (a verify right after a short
//   prompt), where hi + lo meets it (tests/test_torch_walk_tiles.py
//   emulates both).
// f32 queries: CUDA cores, paged_walk_kernel<float, S, kT, kPartial>. The
//   tensor cores would take f32 as TF32 (about three decimal digits), and
//   the f32 exactness pairs hold these kernels at 1e-4. One block per
//   (group, KV head, slice of the group's rows) walks the table a page at a
//   time in tiles of kT keys (16 or 32 for pages of that size, else 64)
//   with flash_tile.cuh's update, no split. It serves only the exactness
//   pairs.
//
// Bit for bit (bf16 route). A row's bits depend only on its query, its
// table, its context and the cell and tile boundaries, which key position
// fixes: MMA rows are independent and each quad reduces its own row
// (mma_tile.cuh); a key that a row does not see is -inf, so its p is
// exactly 0 (ex2(-inf) = 0), and a tile that a row sees nothing of
// rescales it by exactly 1 (its max is -inf, so m stays, and ex2(0) = 1);
// so the tiles a verify block folds past one of its rows' contexts leave
// that row as the decode block, which stops at the row's context, leaves
// it. A cell past a row's context is not folded for it, and a cell in which
// a row sees no key (past its context, or no local page) gives it l = 0:
// the block writes (m = -1e29, l = 0), floors and never garbage (0 x NaN
// is NaN), and the combine folds only cells with l > 0, of the row's own
// cells in order. A one-cell fold equals the direct write (expf(0) = 1,
// fmaf(x, 1, 0) = x). So K2 == K1, K9b == K9a, K10b == K10a, K10d == K10c,
// K11c == K11a and K11d == K11b at every R and G, and at any table width. A
// row with no visible key gives o = 0, and under K11 m = -1e29 and l = 0 exactly,
// which parallel/sp.merge_partials weighs 0. The f32 route gives the same
// property by its own argument (flash_tile.cuh: each value a fixed
// sequence of operations; a page skipped for every row of a table alike).
//
// K8b == K8a. Take b1 = ctx0 and R <= cell, and a K8b row of context ctx
// with ctx0 < ctx <= ctx0 + R (the draft's cache holding at positions
// ctx0 .. ctx - 1 the keys the verify gets in its fresh rows). Its cells
// with a key it sees are, in order: the cache cells below ctx0, the one
// holding ctx0 ending there; [ctx0, cstar); and, where ctx > cstar,
// [cstar, ctx). The K8a row of the same query and context has the same
// cells with the same tile starts: the table's cells below ctx0, the cut
// cell's halves [k * cell, ctx0) and [ctx0, cstar), and the next cell
// [cstar, cstar + cell), of which the row sees [cstar, ctx) (R <= cell
// puts ctx below cstar + cell). (ctx0 a cell multiple: no cut, and the
// window's second cell is empty.) A cell that
// the row does not see is folded by neither. By the argument above, equal
// tiles of equal keys give equal partials, and the combines fold equal
// partials in equal order: the rows are equal bit for bit, the
// decode/verify agreement of the layer-share ceiling without a per-layer
// cache write. The chunk template's f32 K8a/K8b (paged_attention.cu) gives
// it on 256-key chunks by the same partition.
//
// Bound on the H100: bytes (a group reads its context's K/V once per KV
// head; ~4 flops a byte at G 3-4, far below the card's ~295). The design
// cuts the fixed costs: cells spread a group's context over the SMs, the
// copies run while the tensor cores work, and no thread waits on a table
// load in the ring.
#pragma once

#include "flash_tile.cuh"
#include "mma_tile.cuh"

namespace npt {

// ------------------------------------------------------- the launch plan

constexpr int kWalkKeys = 64;     // bf16 route: keys per staged tile
constexpr int kWalkMaxWarps = 8;  // bf16 route: at most 128 query vectors a block
constexpr int kWalkMinWarps = 4;  // bf16 route: threads that copy, at least

// Tile width of the f32 route for pages of bs keys: the page when it holds
// 16 or 32 keys.
__host__ __device__ inline int tile_for(int bs) { return bs <= 16 ? 16 : bs <= 32 ? 32 : kTile; }

// bf16 route: keys per cell, from the cache's shape alone. Blocks per
// group and KV head grow as the cell shrinks, so few KV heads take the
// smaller cell.
__host__ __device__ inline int walk_cell_keys(int hkv) { return hkv <= 2 ? 128 : 256; }

// Tiles of one launch: keys per cell (0: no split), query vectors a warp
// holds (16; 0 on the f32 route), rows of a group per block, threads, K/V
// stages in flight and dynamic shared memory.
struct WalkPlan {
  int cell, warp_rows, rpb, threads, stages;
  size_t smem;
};

// bf16 route's shared memory: Q [mrows, D + 8] bf16; the ring of K and V
// [stages, 64, D + 8] bf16, or over a 1-byte cache [stages, 64, D + 16]
// raw bytes and the dequantized tile [64, D + 8] bf16; the tags [stages,
// 64]; a cell's slots [cell] and (1-byte cache) its K and V scales [cell]
// f32.
inline size_t walk_mma_smem(int mrows, int d, int stages, int cell, bool q8) {
  const size_t pitch = d + 8, keys = kWalkKeys;
  size_t b = 2 * pitch * mrows;
  b += q8 ? 2 * keys * (d + 16) * stages + 2 * 2 * pitch * keys : 2 * 2 * pitch * keys * stages;
  return b + 4 * keys * stages + 4 * (size_t)cell * (q8 ? 3 : 1);
}

// The plan for groups of `rows` rows, g query heads per KV head, hkv KV
// heads, head dim d, pages of bs keys; bf16 or f32 queries over a 1-byte
// cache (q8) or one of the query type. bf16: 16 query vectors a warp, the
// rows of up to 8 warps a block (all R * G where they fit), 3 stages at
// D <= 128 (2 above) but never more than a cell's tiles. f32: the
// CUDA-core page walk (flash_rows_per_block, 256 threads, no split).
inline WalkPlan walk_plan(int rows, int g, int hkv, int d, int bs, bool bf16, bool q8) {
  WalkPlan p{};
  if (bf16) {
    const auto mrows = [&](int r) { return (r * g + 15) / 16 * 16; };
    p.cell = walk_cell_keys(hkv);
    p.warp_rows = 16;
    p.rpb = min(rows, max(1, kWalkMaxWarps * 16 / g));
    p.stages = min(d <= 128 ? 3 : 2, p.cell / kWalkKeys);
    while (p.rpb > 1 && walk_mma_smem(mrows(p.rpb), d, p.stages, p.cell, q8) > (size_t)kMaxSmem)
      p.rpb = (p.rpb + 1) / 2;
    p.threads = 32 * max(kWalkMinWarps, mrows(p.rpb) / 16);
    p.smem = walk_mma_smem(mrows(p.rpb), d, p.stages, p.cell, q8);
  } else {
    const int kt = tile_for(bs);
    p.rpb = flash_rows_per_block<float>(rows, g, d, 0, kt);
    p.threads = kThreads;
    p.stages = 1;
    p.smem = flash_smem_bytes<float>(p.rpb * g, d, sizeof(int) * p.rpb, kt);
  }
  return p;
}

// Field `what` of walk_plan (0 cell, 1 warp rows, 2 rows per block, 3
// threads, 4 stages, 5 shared memory): npt_walk_plan's answer.
inline long long walk_plan_field(int rows, int g, int hkv, int d, int bs, bool bf16, bool q8,
                                 int what) {
  const WalkPlan p = walk_plan(rows, g, hkv, d, bs, bf16, q8);
  switch (what) {
    case 0: return p.cell;
    case 1: return p.warp_rows;
    case 2: return p.rpb;
    case 3: return p.threads;
    case 4: return p.stages;
    case 5: return (long long)p.smem;
    default: return -1;
  }
}

// log2 of a cell's keys, a power of two (walk_cell_keys): cells are cut
// with shifts and masks, no integer division.
__host__ __device__ inline int walk_cell_shift(int cell) {
#ifdef __CUDA_ARCH__
  return __ffs(cell) - 1;
#else
  return __builtin_ctz(cell);
#endif
}

// The cells of one group's launch (bf16 route), in fold order: cell i holds
// key positions [lo, hi) (empty where lo >= hi), read through the table or,
// in a fresh cell, from the fresh rows (position ctx0 + t is fresh row t);
// its tiles start at lo. From the table's `keys` = M * BS keys in cells of
// `cell` (a power of two):
// - the table's ceil(keys / cell) cells (at least one), each ending at the
//   table's keys a row may see (`cached`: keys, or min(keys, ctx0) with
//   the fresh cells);
// - K8a (a cut, no fresh cells): one more table cell, the one holding the
//   cut split there (the second half right after the first); where the cut
//   is no position inside a cell of the table (a cell multiple, <= 0 or
//   >= keys) the table's cells stay whole and the last cell is empty;
// - K6a/K6b (fresh cells): the window [ctx0, ctx0 + R);
// - K8b (both): the window cut at cstar, [ctx0, cstar) and [cstar, ctx0 + R).
// A row of context ctx sees a table cell's keys below min(ctx, cached) and
// a fresh cell's below ctx; its cells are those it sees a key of: the
// first `table_seen` table cells, then the first `fresh_seen` fresh cells.
struct WalkCells {
  int sh, n_table, cached, ctx0, end, cut, cstar;  // sh: log2 of the cell's keys
  bool slot, fresh;                                // the K8a cell; the fresh cells

  __host__ __device__ WalkCells(int keys, int cell, bool has_cut, int cut_, bool has_fresh,
                                int ctx0_, int rows)
      : sh(walk_cell_shift(cell)), n_table(max(1, (keys + cell - 1) >> sh)),
        cached(has_fresh ? min(keys, ctx0_) : keys), ctx0(ctx0_), end(ctx0_ + rows),
        cut(has_cut && !has_fresh && cut_ > 0 && cut_ < keys && (cut_ & (cell - 1)) ? cut_ : 0),
        cstar(has_cut && has_fresh ? ((ctx0_ >> sh) + 1) << sh : ctx0_ + rows),
        slot(has_cut && !has_fresh), fresh(has_fresh) {}

  // The cells of a launch, the same for every group.
  __host__ __device__ static int count(int keys, int cell, bool has_cut, bool has_fresh) {
    return max(1, (keys + cell - 1) >> walk_cell_shift(cell)) + has_cut + has_fresh;
  }

  __host__ __device__ void bounds(int i, int& lo, int& hi, bool& from_fresh) const {
    const int nt = n_table + slot, kb = cut >> sh;
    from_fresh = i >= nt;
    if (from_fresh) {
      lo = i == nt ? ctx0 : cstar;
      hi = i == nt ? min(cstar, end) : end;
    } else {
      lo = cut && i > kb ? (i == kb + 1 ? cut : (i - 1) << sh) : i << sh;
      hi = min(cut && i == kb ? cut : (cut && i > kb ? i : i + 1) << sh, cached);
    }
  }

  // How many of the table's cells a row sees a key of, `lim` = min(ctx,
  // cached) its keys there: those starting below lim, a prefix.
  __host__ __device__ int table_seen(int lim) const {
    return lim > 0 ? ((lim - 1) >> sh) + 1 + (cut && cut < lim) : 0;
  }
  // How many fresh cells a row of context ctx sees a key of, a prefix.
  __host__ __device__ int fresh_seen(int ctx) const {
    return fresh ? (ctx > ctx0) + (cstar < min(end, ctx)) : 0;
  }
  // The cell of the j-th partial a row folds, of `seen` table cells.
  __host__ __device__ int folded(int j, int seen) const {
    return j < seen ? j : n_table + slot + j - seen;
  }
};

// ------------------------------------------------------- bf16: tensor cores

struct WalkArgs {
  const __nv_bfloat16* q;       // [groups * rows, hq, d]
  const void* cache;            // bf16, or 1-byte values (kind 1 int8, 2 e4m3)
  const __nv_bfloat16* scales;  // 1-byte cache: [cache rows, hkv]
  const int *bt, *ctx;          // [groups, m], [groups * rows]
  const int* is_local;          // K11: [groups, m] (0: another shard's slot); else null
  const int* ctx0;              // the fresh cells: [groups] pre-round contexts; else null
  const __nv_bfloat16 *fk, *fv;  // the fresh cells: [groups * rows, hkv * d]; else null
  const int* cut;               // K8a: [groups] b1; K8b: ctx0 itself; else null
  __nv_bfloat16* out;           // [groups * rows, hq, d]
  float *m_out, *l_out;         // K11, K7: [groups * rows, hq]; else null
  float *part_acc, *part_ml;    // n_cells > 1: [groups * rows, hq, n_cells, d | 2]
  long long k_off, v_off;
  int rows, rpb, m, hq, hkv, bs, cell, n_cells, stages, kind;
  float scale;
};

// Group grp's cells (WalkCells) of the launch a describes.
__device__ __forceinline__ WalkCells walk_cells(const WalkArgs& a, int grp) {
  return WalkCells(a.m * a.bs, a.cell, a.cut != nullptr, a.cut ? a.cut[grp] : 0, a.fk != nullptr,
                   a.ctx0 ? a.ctx0[grp] : 0, a.rows);
}

// One block: cell blockIdx.x % n_cells of row slice blockIdx.x / n_cells,
// KV head blockIdx.y, group blockIdx.z. kCells: the launch has fresh or cut
// cells (K6a, K6b, K8a, K8b), in WalkCells' order; else the table's cells
// alone (K1, K2, K7, K10, K11), set out directly.
template <int kD, bool kCells>
__global__ void __launch_bounds__(kThreads) walk_mma_kernel(const WalkArgs a) {
  constexpr int kK = kWalkKeys;
  constexpr int kP = kD + 8;          // bf16 pitch (elements)
  constexpr int kRP = kD + 16;        // raw 1-byte pitch (bytes)
  constexpr int kVecs = kD / 8;       // 16-byte pieces of a bf16 row
  constexpr int kVecs8 = kD / 16;     // 16-byte pieces of a 1-byte row
  constexpr bool kQRegs = kD <= 128;  // Q's A-fragments in registers
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nthr = blockDim.x;
  const int cell = blockIdx.x % a.n_cells, slice = blockIdx.x / a.n_cells;
  const int kh = blockIdx.y, grp = blockIdx.z;
  const int g = a.hq / a.hkv, hd = a.hkv * kD, r0 = slice * a.rpb;
  const int nr = min(a.rpb, a.rows - r0), nq = nr * g, mrows = (a.rpb * g + 15) / 16 * 16;
  const long long row0 = (long long)grp * a.rows + r0;  // first row of the slice
  const bool direct = a.n_cells == 1, q8 = a.kind != 0;
  int lo, cell_hi;     // the cell's key positions
  int cached;          // the table's keys a row may see
  bool fresh = false;  // the cell's keys are fresh rows: position ctx0 + t is row t
  int src0 = 0;        // ... the fresh row of key lo
  if constexpr (kCells) {
    const WalkCells cells = walk_cells(a, grp);
    cells.bounds(cell, lo, cell_hi, fresh);
    cached = cells.cached;
    if (fresh) src0 = lo - cells.ctx0;
  } else {
    cached = a.m * a.bs;
    lo = cell * a.cell;
    cell_hi = min(lo + a.cell, cached);
  }
  // Row r of the slice: its keys below this position are visible (its
  // context, within the table's keys it may see for a table cell).
  const auto ctx_of = [&](int r) { return fresh ? a.ctx[row0 + r] : min(a.ctx[row0 + r], cached); };
  // The combine reads row r's partial of this cell: the row sees a key of it.
  const auto owns = [&](int r) { return direct || lo < min(cell_hi, ctx_of(r)); };

  int cm = 0;  // the slice's longest context, alike in every warp
  for (int r = lane; r < nr; r += 32) cm = max(cm, ctx_of(r));
  const int ctx_max = __reduce_max_sync(~0u, cm);
  const int hi = min(cell_hi, ctx_max);  // the keys [lo, hi) some row of the slice sees

  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [mrows, kP]
  const int stage_bytes = q8 ? kK * kRP : kK * kP * 2;
  unsigned char* kring = reinterpret_cast<unsigned char*>(qs + mrows * kP);  // [stages] tiles
  unsigned char* vring = kring + a.stages * stage_bytes;
  __nv_bfloat16* kbuf = reinterpret_cast<__nv_bfloat16*>(vring + a.stages * stage_bytes);
  __nv_bfloat16* vbuf = kbuf + (q8 ? kK * kP : 0);  // 1-byte cache: the dequantized tile
  int* tags = reinterpret_cast<int*>(vbuf + (q8 ? kK * kP : 0));  // [stages, kK]
  int* kslot = tags + a.stages * kK;                               // [cell], -1: not read
  float* kscl = reinterpret_cast<float*>(kslot + a.cell);          // 1-byte cache: [cell]
  float* vscl = kscl + a.cell;

  // Every row of the slice sees no key of this cell: o = 0, m = -1e29,
  // l = 0 (the direct outputs), or the floor partials of the rows the
  // combine folds this cell for.
  const auto write_empty = [&]() {
    for (int idx = tid; idx < nq; idx += nthr) {
      const int r = idx / g;
      const long long slot = (row0 + r) * a.hq + kh * g + idx % g;
      if (direct) {
        for (int c = 0; c < kD; c += 8)
          *reinterpret_cast<uint4*>(a.out + slot * kD + c) = make_uint4(0, 0, 0, 0);
        if (a.m_out) {
          a.m_out[slot] = kMFloor;
          a.l_out[slot] = 0.f;
        }
      } else if (owns(r)) {
        *reinterpret_cast<float2*>(a.part_ml + (slot * a.n_cells + cell) * 2) =
            make_float2(kMFloor, 0.f);
      }
    }
  };
  if (lo >= hi) {  // past every row's context (uniform over the block)
    if (direct) write_empty();  // else no row owns the cell
    return;
  }

  // The cell's slots (and 1-byte scales), read out of the table once; a
  // fresh cell's keys are its group's fresh rows.
  const int* bt_row = a.bt + (long long)grp * a.m;
  const int* loc_row = a.is_local ? a.is_local + (long long)grp * a.m : nullptr;
  int any = fresh;
  for (int kk = tid; !fresh && kk < hi - lo; kk += nthr) {
    const int t = lo + kk, page = t / a.bs;
    const bool local = !loc_row || loc_row[page];
    const int slot = local ? bt_row[page] * a.bs + t % a.bs : -1;
    kslot[kk] = slot;
    if (q8 && local) {
      kscl[kk] = __bfloat162float(a.scales[(a.k_off * a.bs + slot) * a.hkv + kh]);
      vscl[kk] = __bfloat162float(a.scales[(a.v_off * a.bs + slot) * a.hkv + kh]);
    }
    any |= local;
  }
  if (!__syncthreads_or(any)) {  // no local page in the cell: no work
    write_empty();
    return;
  }

  for (int idx = tid; idx < mrows * kVecs; idx += nthr) {
    const int r = idx / kVecs, c = (idx - r * kVecs) * 8;
    const bool ok = r < nq;
    cp_async16(qs + r * kP + c, ok ? a.q + ((row0 + r / g) * a.hq + kh * g + r % g) * kD + c : a.q,
               ok);
  }
  // This KV head's K/V planes of the layer, indexed by slot (elements); in
  // a fresh cell its group's fresh rows, indexed by fresh row.
  const long long kbase = a.k_off * a.bs * hd + kh * kD, vbase = a.v_off * a.bs * hd + kh * kD;
  const long long fbase = (long long)grp * a.rows * hd + kh * kD;
  const int n_tiles = (hi - lo + kK - 1) / kK;
  // Keys [lo + n * kK, + kK) into stage st (zeros where not read), and their
  // tags: the key's position, or kNone.
  const auto load_tile = [&](int n, int st) {
    const int t0 = n * kK;
    const auto slot_of = [&](int kk) {
      return t0 + kk < hi - lo ? (fresh ? src0 + t0 + kk : kslot[t0 + kk]) : -1;
    };
    for (int kk = tid; kk < kK; kk += nthr)
      tags[st * kK + kk] = slot_of(kk) >= 0 ? lo + t0 + kk : kNone;
    unsigned char* kd = kring + st * stage_bytes;
    unsigned char* vd = vring + st * stage_bytes;
    if (q8) {
      const uint8_t* c8 = static_cast<const uint8_t*>(a.cache);
      for (int idx = tid; idx < kK * kVecs8; idx += nthr) {
        const int kk = idx / kVecs8, c = (idx - kk * kVecs8) * 16, slot = slot_of(kk);
        const bool ok = slot >= 0;
        cp_async16(kd + kk * kRP + c, c8 + (ok ? kbase + (long long)slot * hd + c : 0), ok);
        cp_async16(vd + kk * kRP + c, c8 + (ok ? vbase + (long long)slot * hd + c : 0), ok);
      }
    } else {
      const __nv_bfloat16* cb = static_cast<const __nv_bfloat16*>(a.cache);
      const __nv_bfloat16* ks = fresh ? a.fk + fbase : cb + kbase;
      const __nv_bfloat16* vs = fresh ? a.fv + fbase : cb + vbase;
      for (int idx = tid; idx < kK * kVecs; idx += nthr) {
        const int kk = idx / kVecs, c = (idx - kk * kVecs) * 8, slot = slot_of(kk);
        const bool ok = slot >= 0;
        const long long at = ok ? (long long)slot * hd + c : 0;
        cp_async16(kd + (kk * kP + c) * 2, ok ? ks + at : cb, ok);
        cp_async16(vd + (kk * kP + c) * 2, ok ? vs + at : cb, ok);
      }
    }
  };
  // Stage st's raw 1-byte tile into kbuf / vbuf as bf16 (value x scale,
  // rounded once), zeros for keys not read.
  const auto dequant = [&](int st) {
    const unsigned char* kr = kring + st * stage_bytes;
    const unsigned char* vr = vring + st * stage_bytes;
    for (int idx = tid; idx < kK * kVecs8; idx += nthr) {
      const int kk = idx / kVecs8, c = (idx - kk * kVecs8) * 16, tag = tags[st * kK + kk];
      __nv_bfloat16* kd = kbuf + kk * kP + c;
      __nv_bfloat16* vd = vbuf + kk * kP + c;
      if (tag == kNone) {
        zero8(kd);
        zero8(kd + 8);
        zero8(vd);
        zero8(vd + 8);
      } else if (a.kind == 2) {
        dequant16<__nv_bfloat16, __nv_fp8_e4m3>(kd, kr + kk * kRP + c, kscl[tag - lo]);
        dequant16<__nv_bfloat16, __nv_fp8_e4m3>(vd, vr + kk * kRP + c, vscl[tag - lo]);
      } else {
        dequant16<__nv_bfloat16, int8_t>(kd, kr + kk * kRP + c, kscl[tag - lo]);
        dequant16<__nv_bfloat16, int8_t>(vd, vr + kk * kRP + c, vscl[tag - lo]);
      }
    }
  };
  for (int n = 0; n < a.stages - 1; ++n) {  // one group a stage, empty past the last tile
    if (n < n_tiles) load_tile(n, n);
    cp_async_commit();
  }

  // This thread's rows of the warp's 16: ra = lane / 4 and ra + 8, at
  // position ctx - 1 (keys t <= ctx - 1 visible), padded rows at kNoRow.
  const int ra = warp * 16 + (lane >> 2), rb = ra + 8;
  const int qpa = ra < nq ? ctx_of(ra / g) - 1 : kNoRow;
  const int qpb = rb < nq ? ctx_of(rb / g) - 1 : kNoRow;
  const bool active = warp * 16 < nq;  // the warp holds a real row (uniform over it)
  const __nv_bfloat16* qw = qs + (warp * 16 + (lane & 15)) * kP + (lane >> 4) * 8;
  unsigned qf[kQRegs ? kD / 16 : 1][4];
  float o[kD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  const float sl2 = a.scale * kLog2e;
  float m_a = kMFloor, m_b = kMFloor, l_a = 0.f, l_b = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    const int st = n % a.stages;
    if (a.stages == 3)  // tiles 0 .. n (and Q) have landed
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // ... for every thread; every warp is done with tile n - 1
    if (n + a.stages - 1 < n_tiles) load_tile(n + a.stages - 1, (n + a.stages - 1) % a.stages);
    cp_async_commit();
    const __nv_bfloat16* kt = reinterpret_cast<const __nv_bfloat16*>(kring + st * stage_bytes);
    const __nv_bfloat16* vt = reinterpret_cast<const __nv_bfloat16*>(vring + st * stage_bytes);
    if (q8) {
      dequant(st);
      __syncthreads();
      kt = kbuf;
      vt = vbuf;
    }
    if (active) {
      if constexpr (kQRegs) {
        if (n == 0) {
#pragma unroll
          for (int ks16 = 0; ks16 < kD / 16; ++ks16) ldsm_x4(qf[ks16], qw + ks16 * 16);
        }
      }
      mma_tile_step<kD, kK, kQRegs>(qf, qw, kt, vt, tags + st * kK, qpa, qpb, sl2, m_a, m_b, l_a,
                                    l_b, o);
    }
  }
  if (!active) return;

  // Rows ra (o[.][0..1]) and rb (o[.][2..3]): the outputs, or the cell's
  // partial where the combine folds it (m in natural-log units, as
  // fold_partials reads it; -1e29 where the row saw no key).
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (r >= nq || !owns(r / g)) continue;
    const float l = half ? l_b : l_a, m = l > 0.f ? (half ? m_b : m_a) * kLn2 : kMFloor;
    const long long slot = (row0 + r / g) * a.hq + kh * g + r % g;
    if (direct) {
      const float den = fmaxf(l, 1e-30f);
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(a.out + slot * kD + dt * 8 + (lane & 3) * 2) =
            __floats2bfloat162_rn(o[dt][2 * half] / den, o[dt][2 * half + 1] / den);
      if (a.m_out && (lane & 3) == 0) {
        a.m_out[slot] = m;
        a.l_out[slot] = l;
      }
    } else {
      const long long p = slot * a.n_cells + cell;
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt)
        *reinterpret_cast<float2*>(a.part_acc + p * kD + dt * 8 + (lane & 3) * 2) =
            make_float2(o[dt][2 * half], o[dt][2 * half + 1]);
      if ((lane & 3) == 0) *reinterpret_cast<float2*>(a.part_ml + p * 2) = make_float2(m, l);
    }
  }
}

// Output row blockIdx.x of a launch of several cells: the row's cells (the
// table cells it sees a key of, then, with kCells, the fresh cells it sees
// a key of, in WalkCells' order), those with l > 0, folded in order (none:
// o = 0, m = -1e29, l = 0). Grid (rows, ceil(hq * d / kThreads)): one output
// element a thread.
template <bool kCells>
__global__ void __launch_bounds__(kThreads) walk_combine_kernel(const WalkArgs a, int d) {
  const long long row = blockIdx.x;
  const int idx = blockIdx.y * blockDim.x + threadIdx.x;
  if (idx >= a.hq * d) return;
  const int ctx = a.ctx[row];
  int seen, n, fresh0 = 0;  // the row's table cells, all its cells; the first fresh cell
  if constexpr (kCells) {
    const WalkCells cells = walk_cells(a, (int)blockIdx.x / a.rows);
    seen = cells.table_seen(min(ctx, cells.cached));
    n = seen + cells.fresh_seen(ctx);
    fresh0 = cells.folded(seen, seen);
  } else {
    seen = n = (min(ctx, a.m * a.bs) + a.cell - 1) / a.cell;
  }
  const int h = idx / d, c = idx - h * d;
  const long long slot = row * a.hq + h, first = slot * a.n_cells;
  const auto at = [&](int j) { return first + (j < seen ? j : fresh0 + j - seen); };
  float mg, l;
  a.out[slot * d + c] = fold_partials<__nv_bfloat16>(
      a.part_acc, a.part_ml, d, c, n, [&](int j) { return a.part_ml[at(j) * 2 + 1] > 0.f; }, at,
      &mg, &l);
  if (a.m_out && c == 0) {
    a.m_out[slot] = mg;
    a.l_out[slot] = l;
  }
}

template <bool kCells, int kD = 16>
cudaError_t launch_walk_mma(int d, const WalkArgs& a, dim3 grid, const WalkPlan& p,
                            cudaStream_t s) {
  if constexpr (kD > 256) {
    return cudaErrorInvalidValue;
  } else {
    if (d != kD) return launch_walk_mma<kCells, kD + 16>(d, a, grid, p, s);
    cudaError_t err = flash_set_smem(walk_mma_kernel<kD, kCells>, p.smem);
    if (err != cudaSuccess) return err;
    walk_mma_kernel<kD, kCells><<<grid, p.threads, p.smem, s>>>(a);
    return cudaGetLastError();
  }
}

// The bf16 walk over `groups` groups of `rows` rows: kind 0 a bf16 cache, 1
// int8, 2 e4m3 (with `scales`); is_local for K11, m_out and l_out for K11
// and K7 (else null); ctx0, fk and fv for the fresh cells (K6a, K6b, K8b: a
// bf16 cache; else null); cut for K8a (b1) and K8b (ctx0 itself, rows <=
// cell); part_acc / part_ml the partials of WalkCells::count cells (null
// where that is 1). kCells: the launch has fresh or cut cells.
template <bool kCells = false>
cudaError_t launch_walk_bf16(int groups, int rows, const void* q, const void* cache,
                                    const void* scales, const int* bt, const int* ctx,
                                    const int* is_local, void* out, float* m_out, float* l_out,
                                    float* part_acc, float* part_ml, int m, int hq, int hkv, int d,
                                    int bs, long long k_off, long long v_off, float scale,
                                    int kind, void* stream, const int* ctx0 = nullptr,
                                    const void* fk = nullptr, const void* fv = nullptr,
                                    const int* cut = nullptr) {
  const WalkPlan p = walk_plan(rows, hq / hkv, hkv, d, bs, true, kind != 0);
  if (p.threads > kThreads) return cudaErrorInvalidConfiguration;
  if (fk && (kind != 0 || !ctx0 || !fv)) return cudaErrorInvalidValue;
  if (fk && cut && (cut != ctx0 || rows > p.cell)) return cudaErrorInvalidValue;
  if (kCells != (fk || cut)) return cudaErrorInvalidValue;
  WalkArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.cache = cache;
  a.scales = static_cast<const __nv_bfloat16*>(scales);
  a.bt = bt;
  a.ctx = ctx;
  a.is_local = is_local;
  a.ctx0 = ctx0;
  a.fk = static_cast<const __nv_bfloat16*>(fk);
  a.fv = static_cast<const __nv_bfloat16*>(fv);
  a.cut = cut;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.m_out = m_out;
  a.l_out = l_out;
  a.part_acc = part_acc;
  a.part_ml = part_ml;
  a.k_off = k_off;
  a.v_off = v_off;
  a.rows = rows;
  a.rpb = p.rpb;
  a.m = m;
  a.hq = hq;
  a.hkv = hkv;
  a.bs = bs;
  a.cell = p.cell;
  a.n_cells = WalkCells::count(m * bs, p.cell, cut != nullptr, fk != nullptr);
  a.stages = p.stages;
  a.kind = kind;
  a.scale = scale;
  if (a.n_cells > 1 && (!part_acc || !part_ml)) return cudaErrorInvalidValue;
  const int slices = (rows + p.rpb - 1) / p.rpb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_walk_mma<kCells>(d, a, dim3(a.n_cells * slices, hkv, groups), p, s);
  if (err != cudaSuccess || a.n_cells == 1) return err;
  const dim3 combine(groups * rows, (hq * d + kThreads - 1) / kThreads);
  walk_combine_kernel<kCells><<<combine, kThreads, 0, s>>>(a, d);
  return cudaGetLastError();
}

// ------------------------------------------------------- f32: CUDA cores

// q, out [groups * rows, hq, d]; bt [groups, m]; ctx [groups * rows]. Block
// (group, kv head, slice) folds rows [slice * rpb, slice * rpb + rpb) of the
// group. S: float, or int8_t / __nv_fp8_e4m3 with `scales` [rows, hkv] bf16.
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
  for (int r = tid; r < nr; r += blockDim.x) ctx_s[r] = min(ctx[row0 + r], m * bs);
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
      if (!is_local[(long long)grp * m + p0 / bs]) continue;  // uniform over the block
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

template <typename S, bool kPartial, int kT>
cudaError_t launch_walk_tile(int groups, int rows, const void* q, const void* cache,
                             const void* scales, const int* bt, const int* ctx, const int* is_local,
                             void* out, float* m_out, float* l_out, int m, int hq, int hkv, int d,
                             int bs, long long k_off, long long v_off, float scale,
                             cudaStream_t stream) {
  const WalkPlan p = walk_plan(rows, hq / hkv, hkv, d, bs, false, !std::is_same<S, float>::value);
  auto kernel = paged_walk_kernel<float, S, kT, kPartial>;
  cudaError_t err = flash_set_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(groups, hkv, (rows + p.rpb - 1) / p.rpb);
  kernel<<<grid, kThreads, p.smem, stream>>>(
      static_cast<const float*>(q), static_cast<const S*>(cache),
      static_cast<const __nv_bfloat16*>(scales), bt, ctx, is_local, static_cast<float*>(out),
      m_out, l_out, rows, p.rpb, m, hq, hkv, d, bs, k_off, v_off, scale);
  return cudaGetLastError();
}

// The f32 walk at the tile width of the cache's pages; S float, or int8_t /
// __nv_fp8_e4m3 over a 1-byte cache.
template <typename S, bool kPartial>
cudaError_t launch_walk_f32(int groups, int rows, const void* q, const void* cache,
                            const void* scales, const int* bt, const int* ctx, const int* is_local,
                            void* out, float* m_out, float* l_out, int m, int hq, int hkv, int d,
                            int bs, long long k_off, long long v_off, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_for(bs)) {
    case 16:
      return launch_walk_tile<S, kPartial, 16>(groups, rows, q, cache, scales, bt, ctx, is_local,
                                               out, m_out, l_out, m, hq, hkv, d, bs, k_off, v_off,
                                               scale, s);
    case 32:
      return launch_walk_tile<S, kPartial, 32>(groups, rows, q, cache, scales, bt, ctx, is_local,
                                               out, m_out, l_out, m, hq, hkv, d, bs, k_off, v_off,
                                               scale, s);
    default:
      return launch_walk_tile<S, kPartial, kTile>(groups, rows, q, cache, scales, bt, ctx,
                                                  is_local, out, m_out, l_out, m, hq, hkv, d, bs,
                                                  k_off, v_off, scale, s);
  }
}

// The whole walk: bf16 queries on the tensor cores (cache kind 0 bf16, 1
// int8, 2 e4m3), f32 on CUDA cores.
template <bool kPartial>
cudaError_t launch_walk(bool bf16, int kind, int groups, int rows, const void* q,
                        const void* cache, const void* scales, const int* bt, const int* ctx,
                        const int* is_local, void* out, float* m_out, float* l_out,
                        float* part_acc, float* part_ml, int m, int hq, int hkv, int d, int bs,
                        long long k_off, long long v_off, float scale, void* stream) {
  if (rows < 1 || d % 16 || d < 16 || d > 256 || hq % hkv) return cudaErrorInvalidValue;
  if (bf16)
    return launch_walk_bf16(groups, rows, q, cache, scales, bt, ctx, is_local, out, m_out, l_out,
                            part_acc, part_ml, m, hq, hkv, d, bs, k_off, v_off, scale, kind,
                            stream);
  if (kind == 2)
    return launch_walk_f32<__nv_fp8_e4m3, kPartial>(groups, rows, q, cache, scales, bt, ctx,
                                                    is_local, out, m_out, l_out, m, hq, hkv, d, bs,
                                                    k_off, v_off, scale, stream);
  if (kind == 1)
    return launch_walk_f32<int8_t, kPartial>(groups, rows, q, cache, scales, bt, ctx, is_local,
                                             out, m_out, l_out, m, hq, hkv, d, bs, k_off, v_off,
                                             scale, stream);
  return launch_walk_f32<float, kPartial>(groups, rows, q, cache, scales, bt, ctx, is_local, out,
                                          m_out, l_out, m, hq, hkv, d, bs, k_off, v_off, scale,
                                          stream);
}

}  // namespace npt
