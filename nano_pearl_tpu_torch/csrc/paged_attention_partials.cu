// Per-shard flash partials of sequence parallelism, for sm_90a: decode and
// packed verify over ONE shard of a block-sharded paged cache, exporting
// (o, m, l) for the cross-shard softmax merge (parallel/sp.py).
//
// K11a npt_partials (rows 1, bf16/f32 cache): per-shard decode partials.
//   Replaces nano_pearl_tpu/ops/pallas/paged_attention.py _kernel_partial
//   (entry paged_attention_pallas_partials).
// K11c npt_partials (rows >= 1): per-shard packed-verify partials, R rows
//   of one sequence sharing its block table. Replaces
//   _grouped_kernel_partial (entry paged_attention_pallas_grouped_partials).
// K11b / K11d npt_partials_q8: K11a / K11c over a 1-byte shard (int8 or
//   e4m3) with a bf16 scale per (slot, KV head), dequantized in the tile
//   load and rounded to the query type as K9a-c and K10c/K10d do. Replace
//   _kernel_partial_q8 and _grouped_kernel_partial_q8 (same entries).
//
// The same walk also carries the bf16 route of the deferred verify's and
// the split-boundary schedule's kernels (wrappers in
// ops/cuda/mono_attention.py and ops/cuda/paged_attention.py; their f32
// routes stay on csrc/mono_attention.cu's mono template (K7, K6b) and on
// csrc/paged_attention.cu's chunk template (K6a, K8a, K8b)):
// K7 npt_partials with is_local null: every slot local, so (o, m, l) over
//   the pre-round cache, K11c's launch without the shard mask. Replaces
//   _grouped_kernel_db_mono_partial (entry
//   paged_attention_pallas_grouped_cache_partials).
// K6b npt_fresh_walk: the deferred-write packed verify in one walk, the
//   cache cells below each group's pre-round context ctx0, then one fresh
//   cell of the round's K/V from the in-operand fresh rows (paged_walk.cuh
//   has the details), returning o normalised. Replaces
//   _grouped_kernel_db_mono_fresh (entry _mono_call_fresh).
// K6a npt_fresh_walk: the same launch on the db schedule. K6a and K6b
//   compute one function (the port's plain version of both is
//   paged_attention_grouped_fresh_ref), so a K6a row equals the K6b row of
//   the same inputs bit for bit. Replaces _grouped_kernel_db_fresh (entry
//   paged_attention_pallas_grouped_fresh).
// K8a npt_cut_walk with a cut and no fresh rows: the split-boundary
//   schedule's decode, each row's table cell that holds its boundary b1 cut
//   there. Replaces _kernel_db_split (entry paged_attention_pallas_split).
// K8b npt_cut_walk with the fresh rows and cut = ctx0: K6a with the fresh
//   window cut at the cell multiple inside it, so that a K8b row folds the
//   cells of the K8a row of the same context at b1 = ctx0 and equals it bit
//   for bit (paged_walk.cuh carries the argument). Replaces
//   _grouped_kernel_db_fresh_split (entry
//   paged_attention_pallas_grouped_fresh_split).
//
// The caller hands each row (group) a table of LOCAL block ids, clamped
// into the shard, and is_local [tables, m]: a slot that is not local is
// another shard's and is skipped, like a slot at or past the context. The
// statistics start at m = -1e29, l = 0, acc = 0 (the Pallas kernels'
// _init_scratch_floor), so a row with no local visible key gives o = 0,
// m = -1e29 and l = 0, which the merge weighs 0. Outputs: o = acc /
// max(l, 1e-30) in the query's type (the Pallas entries return q.dtype),
// m and l in f32.
//
// Layout: the page walk of K1/K2, K9a/K9b and K10a-d (paged_walk.cuh), which
// takes every head dim 16..256 and every Hkv * D and carries the argument
// that a K11c row equals the K11a row of the same query, context and table
// bit for bit (K11d's K11b's): the layer-share pair's draft decodes through
// K11a and its target verifies through K11c, and the merge is one
// elementwise function of (o, m, l), so the ceiling holds under sp as
// without. A cell that holds no local page does no work: its block writes
// the floor partials (m = -1e29, l = 0) and the combine skips them.
//
// Bound on the H100: bytes (a group reads its shard's share of its
// context's K/V once per KV head: G flops per byte at decode, R * G at a
// packed verify of R rows, 56 at the bench's 14 x 4, far below the card's
// ~295).
#include "paged_walk.cuh"

extern "C" {

// walk_plan's field `what`, as npt_walk_plan in paged_walk.cu.
long long npt_walk_plan(int rows, int g, int hkv, int d, int bs, int is_bf16, int q8, int what) {
  return npt::walk_plan_field(rows, g, hkv, d, bs, is_bf16 != 0, q8 != 0, what);
}

// K11a (rows 1) / K11c: q, o [b * rows, hq, d] bf16 or f32 (is_bf16), the
// shard's cache of the same type [L, 2, NB1_loc, bs, hkv * d]; bt [b, m]
// local block ids; ctx [b * rows] global contexts; is_local [b, m] int32,
// or null with bf16 queries (every slot local: K7 over the whole cache,
// ctx the cache-side contexts, >= 0); m_out, l_out [b * rows, hq] f32;
// part_acc / part_ml as npt_walk's. Returns cudaGetLastError() after
// the launches.
int npt_partials(const void* q, const void* cache, const int* bt, const int* ctx,
                 const int* is_local, void* out, float* m_out, float* l_out, float* part_acc,
                 float* part_ml, int b, int rows, int m, int hq, int hkv, int d, int bs,
                 long long k_off, long long v_off, float scale, int is_bf16, void* stream) {
  if (!is_local && !is_bf16) return (int)cudaErrorInvalidValue;  // the f32 walk reads the mask
  return (int)npt::launch_walk<true>(is_bf16 != 0, 0, b, rows, q, cache, nullptr, bt, ctx,
                                     is_local, out, m_out, l_out, part_acc, part_ml, m, hq, hkv, d,
                                     bs, k_off, v_off, scale, stream);
}

// K11b (rows 1) / K11d: npt_partials over a 1-byte shard (int8, or e4m3
// with is_fp8) and its bf16 scales [rows, hkv].
int npt_partials_q8(const void* q, const void* cache, const void* scales, const int* bt,
                    const int* ctx, const int* is_local, void* out, float* m_out, float* l_out,
                    float* part_acc, float* part_ml, int b, int rows, int m, int hq, int hkv,
                    int d, int bs, long long k_off, long long v_off, float scale, int is_bf16,
                    int is_fp8, void* stream) {
  return (int)npt::launch_walk<true>(is_bf16 != 0, is_fp8 ? 2 : 1, b, rows, q, cache, scales, bt,
                                     ctx, is_local, out, m_out, l_out, part_acc, part_ml, m, hq,
                                     hkv, d, bs, k_off, v_off, scale, stream);
}

// K6a / K6b: q, o [b * rows, hq, d] bf16 (is_bf16 must be set), the cache
// bf16 [L, 2, NB+1, bs, hkv * d] holding each group's pre-round context ctx0
// [b] alone; bt [b, m]; ctx [b * rows] each row's context with its visible
// fresh rows; fk / fv [b * rows, hkv * d] bf16 the fresh rows (row t of
// group g at position ctx0[g] + t), 16-byte aligned; part_acc / part_ml
// [b * rows, hq, ceil(m * bs / cell) + 1, d | 2] f32 scratch (walk_plan's
// cell). Returns cudaGetLastError() after the launches.
int npt_fresh_walk(const void* q, const void* cache, const int* bt, const int* ctx,
                   const int* ctx0, const void* fk, const void* fv, void* out, float* part_acc,
                   float* part_ml, int b, int rows, int m, int hq, int hkv, int d, int bs,
                   long long k_off, long long v_off, float scale, int is_bf16, void* stream) {
  if (!is_bf16 || rows < 1 || d % 16 || d < 16 || d > 256 || hq % hkv)
    return (int)cudaErrorInvalidValue;
  return (int)npt::launch_walk_bf16<true>(b, rows, q, cache, nullptr, bt, ctx, nullptr, out,
                                          nullptr, nullptr, part_acc, part_ml, m, hq, hkv, d, bs,
                                          k_off, v_off, scale, 0, stream, ctx0, fk, fv);
}

// K8a (ctx0, fk, fv null; rows 1): cut [b] int32, each row's boundary b1;
// otherwise as npt_walk over a bf16 cache, with part_acc / part_ml of
// ceil(m * bs / cell) + 1 cells. K8b (cut == ctx0, 1 <= rows <= cell):
// npt_fresh_walk's arguments, with ceil(m * bs / cell) + 2 cells. bf16
// queries alone (is_bf16 must be set).
int npt_cut_walk(const void* q, const void* cache, const int* bt, const int* ctx, const int* cut,
                 const int* ctx0, const void* fk, const void* fv, void* out, float* part_acc,
                 float* part_ml, int b, int rows, int m, int hq, int hkv, int d, int bs,
                 long long k_off, long long v_off, float scale, int is_bf16, void* stream) {
  if (!is_bf16 || !cut || rows < 1 || d % 16 || d < 16 || d > 256 || hq % hkv)
    return (int)cudaErrorInvalidValue;
  if (!fk && rows != 1) return (int)cudaErrorInvalidValue;  // K8a is a decode
  return (int)npt::launch_walk_bf16<true>(b, rows, q, cache, nullptr, bt, ctx, nullptr, out,
                                          nullptr, nullptr, part_acc, part_ml, m, hq, hkv, d, bs,
                                          k_off, v_off, scale, 0, stream, ctx0, fk, fv, cut);
}

// Field `what` of cell i of one group's launch (npt::WalkCells, as the walk
// and its combine read it; mirrored by ops/cuda/paged_walk.launch_cells and
// row_cells): 0 lo, 1 hi, 2 from the fresh rows, 3 the launch's cell count,
// 4 how many partials a row of context ctx folds, 5 the cell of the i-th
// of them. A table of `keys` keys in cells of `cell`; has_cut with `cut`
// (K8a's b1, or K8b's ctx0), has_fresh with ctx0 and rows.
int npt_walk_cells(int keys, int cell, int has_cut, int cut, int has_fresh, int ctx0, int rows,
                   int ctx, int i, int what) {
  const npt::WalkCells c(keys, cell, has_cut != 0, cut, has_fresh != 0, ctx0, rows);
  int lo, hi;
  bool fresh;
  c.bounds(i, lo, hi, fresh);
  const int seen = c.table_seen(min(ctx, c.cached));
  switch (what) {
    case 0: return lo;
    case 1: return hi;
    case 2: return fresh;
    case 3: return npt::WalkCells::count(keys, cell, has_cut != 0, has_fresh != 0);
    case 4: return seen + c.fresh_seen(ctx);
    case 5: return c.folded(i, seen);
    default: return -1;
  }
}

const char* npt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
