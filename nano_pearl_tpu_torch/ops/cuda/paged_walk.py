"""The launch plan of the page walk (``csrc/paged_walk.cuh``) behind K10a-d,
K11a-d and the bf16 route of K1, K2, K5, K6a, K6b, K7, K8a, K8b and K9a-c,
mirrored in Python; the launch their wrappers share (``paged_attention.py``,
``paged_attention_fallback.py``, ``paged_attention_partials.py``,
``mono_attention.py``); the walk's library of decode and packed verify
(``csrc/paged_walk.cu``: ``npt_walk``, ``npt_walk_q8``, loaded by ``_lib``),
which K1/K2, K9a/K9b, K5/K9c and K10a-d launch; and the input checks of every
paged-attention wrapper.

``walk_plan`` is the mirror of the launchers' ``walk_plan``, which both
walk libraries export as ``npt_walk_plan``; the CPU tests check the mirror and
the card tests hold it against the export. bf16 queries run on the tensor
cores: 16 query vectors a warp, a group's rows over up to 8 warps a block,
each table's key stream cut into cells of ``cell_keys(hkv)`` keys at fixed
positions (``key_cells``), one block per (group, KV head, row slice, cell)
and, where the table holds more than one cell, f32 partials that a
combine kernel folds. K6a's and K6b's launch adds one cell after the
table's, the round's fresh keys read from their rows (``fresh_cells``);
K8a's cuts the table cell that holds each row's boundary b1 in two
(``key_cells``' cut), K8b's cuts the fresh window at the cell multiple
inside it. ``launch_cells`` lists a launch's cells as the card's
``WalkCells`` does (exported as ``npt_walk_cells``), ``row_cells`` those a
row folds. f32 queries walk the table a page at a time on CUDA cores with
no split (``rows_per_block``'s row slices).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from nano_pearl_tpu_torch.ops.attention import check_head_dim
from nano_pearl_tpu_torch.ops.cuda import build
from nano_pearl_tpu_torch.ops.kv_cache import cache_is_quantized, global_block_offsets

_SUPPORTED = (torch.bfloat16, torch.float32)
_Q8 = (torch.int8, torch.float8_e4m3fn)
MAX_SMEM = 232448  # bytes of shared memory a block may opt into on sm_90 (kMaxSmem)
THREADS = 256  # threads per block, at most (kThreads)
KEYS = 64  # bf16: keys per staged tile (kWalkKeys)
MAX_WARPS = 8  # bf16: warps of query vectors a block, at most (kWalkMaxWarps)
MIN_WARPS = 4  # bf16: warps a block, at least (kWalkMinWarps)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _lib() -> ctypes.CDLL:
    """``csrc/paged_walk.cu``'s library: ``npt_walk`` over a bf16/f32 cache,
    ``npt_walk_q8`` over a 1-byte one, and ``npt_walk_plan``."""
    lib = build.load("paged_walk")
    if not getattr(lib, "_npt_typed", False):
        tail = [_I] * 7 + [_LL, _LL, _F, _I]
        lib.npt_walk.argtypes = [_P] * 7 + tail + [_P]
        lib.npt_walk_q8.argtypes = [_P] * 8 + tail + [_I, _P]
        lib.npt_walk.restype = _I
        lib.npt_walk_q8.restype = _I
        lib.npt_walk_plan.argtypes = [_I] * 8
        lib.npt_walk_plan.restype = _LL
        lib._npt_typed = True
    return lib


def rows_per_block(rows: int, g: int, d: int, itemsize: int, fixed: int = 0, tile: int = 64) -> int:
    """Rows of a packed-verify group that one CUDA block folds, as every
    attention launcher of the port picks them (``flash_rows_per_block`` in
    ``csrc/flash_tile.cuh``, exported as ``npt_rows_per_block``): all
    ``rows``, halved (rounding up) while their ``rows * g`` query vectors
    of ``d`` f32 values, their scores over a ``tile``-key tile, their
    statistics, one int per row, ``fixed`` bytes more and the staged K/V
    tile of ``itemsize``-byte elements exceed the block's shared memory.
    Rows are independent, so the split changes no bit of any row."""

    def smem(r: int) -> int:
        nq = r * g
        return 2 * itemsize * tile * (d + 8) + 4 * (2 * nq * d + nq * tile + 3 * nq) + 4 * r + fixed

    rpb = rows
    while rpb > 1 and smem(rpb) > MAX_SMEM:
        rpb = (rpb + 1) // 2
    return rpb


def _check_inputs(q, cache, block_tables, context_lens, n_tables: int, n_rows: int, quant=False):
    """Validate what the kernel takes (a quantized cache for the K9
    kernels, a bf16/f32 one otherwise); returns (hq, hkv, d, bs, m)."""
    if cache_is_quantized(cache) != quant:
        raise ValueError(f"this kernel takes a {'quantized' if quant else 'bf16/f32'} cache")
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"q must be on a CUDA device, got {dev}")
    planes = (("cache.q", cache.q), ("cache.s", cache.s)) if quant else (("cache", cache),)
    for name, t in (("q", q), ("block_tables", block_tables), ("context_lens", context_lens), *planes):
        if t.device != dev:
            raise ValueError(f"{name} must be on q's CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if quant:
        if q.dtype not in _SUPPORTED or cache.q.dtype not in _Q8 or cache.s.dtype != torch.bfloat16:
            raise ValueError(f"q must be bf16/f32, the cache int8/e4m3 with bf16 scales: "
                             f"{q.dtype}, {cache.q.dtype}, {cache.s.dtype}")
        if tuple(cache.s.shape) != tuple(cache.q.shape[:-1]) + (cache.q.shape[-1] // q.shape[-1],):
            raise ValueError(f"scales {tuple(cache.s.shape)} are not one per slot and KV head")
    elif q.dtype not in _SUPPORTED or cache.dtype != q.dtype:
        raise ValueError(f"q/cache dtype must match and be bf16 or f32: {q.dtype}, {cache.dtype}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise ValueError("block_tables and context_lens must be int32")
    if q.ndim != 3 or cache.ndim != 5:
        raise ValueError(f"q must be [N, Hq, D] and cache [L, 2, NB+1, BS, Hkv*D]: {q.shape}, {cache.shape}")
    n, hq, d = q.shape
    check_head_dim(d)
    if cache.shape[1] != 2 or cache.shape[-1] % d:
        raise ValueError(f"cache shape {tuple(cache.shape)} does not fold head_dim {d}")
    hkv = cache.shape[-1] // d
    if hq % hkv:
        raise ValueError(f"Hq {hq} is not a multiple of Hkv {hkv}")
    if n != n_rows or block_tables.ndim != 2 or block_tables.shape[0] != n_tables:
        raise ValueError(f"q rows {n} / block_tables {tuple(block_tables.shape)} mismatch")
    if context_lens.shape != (n_rows,):
        raise ValueError(f"context_lens shape {tuple(context_lens.shape)} != ({n_rows},)")
    return hq, hkv, d, cache.shape[3], block_tables.shape[1]


def _check_fresh(q, ctx0, fresh_k, fresh_v, groups: int, hkv: int, d: int) -> None:
    """The deferred verify's extra operands: ctx0 [groups] int32, fresh K/V
    [N, Hkv, D] in q's dtype, all contiguous on q's device."""
    for name, t in {"ctx0": ctx0, "fresh_k": fresh_k, "fresh_v": fresh_v}.items():
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on q's device, got {t.device}")
    if ctx0.dtype != torch.int32 or ctx0.shape != (groups,):
        raise ValueError(f"ctx0 must be int32 [{groups}], got {ctx0.dtype} {tuple(ctx0.shape)}")
    want = (q.shape[0], hkv, d)
    for name, t in (("fresh_k", fresh_k), ("fresh_v", fresh_v)):
        if t.dtype != q.dtype or tuple(t.shape) != want:
            raise ValueError(f"{name} must be {q.dtype} {want}, got {t.dtype} {tuple(t.shape)}")


def cell_keys(hkv: int) -> int:
    """Keys per cell of the bf16 route, from the cache's shape alone (never
    from the rows, the group count or the batch): 128 where the cache has
    at most 2 KV heads, else 256 (``walk_cell_keys``)."""
    return 128 if hkv <= 2 else 256


def tile_for(bs: int) -> int:
    """Keys per tile of the f32 route: the page where it holds 16 or 32."""
    return 16 if bs <= 16 else 32 if bs <= 32 else 64


@dataclass(frozen=True)
class WalkPlan:
    """The tiles of one launch: keys per ``cell`` (0: no split), query
    vectors a warp holds (``warp_rows``; 0 on the f32 route), rows of a
    group per block (``rpb``), ``threads`` per block, K/V ``stages`` in
    flight and ``smem`` bytes of dynamic shared memory."""

    cell: int
    warp_rows: int
    rpb: int
    threads: int
    stages: int
    smem: int


def _mma_smem(mrows: int, d: int, stages: int, cell: int, q8: bool) -> int:
    pitch = d + 8
    ring = 2 * KEYS * (d + 16) * stages + 2 * 2 * pitch * KEYS if q8 else 2 * 2 * pitch * KEYS * stages
    return 2 * pitch * mrows + ring + 4 * KEYS * stages + 4 * cell * (3 if q8 else 1)


@functools.lru_cache(maxsize=None)
def walk_plan(rows: int, g: int, hkv: int, d: int, bs: int, itemsize: int, q8: bool = False) -> WalkPlan:
    """The launchers' plan for groups of ``rows`` rows, ``g`` query heads
    per KV head, ``hkv`` KV heads, head dim ``d``, pages of ``bs`` keys and
    ``itemsize``-byte queries over a 1-byte (``q8``) cache or one of the
    query type. bf16: rows packed 16 a warp, all ``rows * g`` query vectors
    in one block where they fill at most 8 warps (else ``128 // g`` rows a
    block), at least 4 warps; Q, a ring of K/V tiles of ``KEYS`` keys (3
    stages at D <= 128, else 2, never more than a cell's tiles; over a
    1-byte cache raw bytes and one dequantized bf16 tile), their tags, and a
    cell's slots (and K/V scales) in shared memory, halving the rows while
    that exceeds ``MAX_SMEM``. f32: ``rows_per_block``'s slices of 256
    threads, no split."""
    if itemsize == 2:
        cell = cell_keys(hkv)
        stages = min(3 if d <= 128 else 2, cell // KEYS)

        def mrows(r: int) -> int:
            return -(-r * g // 16) * 16

        rpb = min(rows, max(1, MAX_WARPS * 16 // g))
        while rpb > 1 and _mma_smem(mrows(rpb), d, stages, cell, q8) > MAX_SMEM:
            rpb = (rpb + 1) // 2
        threads = 32 * max(MIN_WARPS, mrows(rpb) // 16)
        return WalkPlan(cell, 16, rpb, threads, stages, _mma_smem(mrows(rpb), d, stages, cell, q8))
    kt = tile_for(bs)
    rpb = rows_per_block(rows, g, d, 4, tile=kt)
    nq = rpb * g
    smem = 2 * 4 * kt * (d + 8) + 4 * (2 * nq * d + nq * kt + 3 * nq) + 4 * rpb
    return WalkPlan(0, 0, rpb, THREADS, 1, smem)


def n_cells(n_keys: int, cell: int, cut: bool = False, fresh: bool = False) -> int:
    """How many cells the bf16 route launches for a table of ``n_keys`` keys
    (``WalkCells::count``): ``ceil(n_keys / cell)``, at least one, one more
    with a ``cut`` (K8a's cut cell; K8b's second fresh cell) and one more
    with the ``fresh`` cells (K6a, K6b, K8b)."""
    return max(1, -(-n_keys // cell)) + int(cut) + int(fresh)


def key_cells(n_keys: int, cell: int, cut: int | None = None) -> list[tuple[int, int]]:
    """The key ranges [lo, hi) the bf16 route cuts a table of ``n_keys = M *
    BS`` keys into, in fold order: cell c = [c * cell, min((c + 1) * cell,
    n_keys)). With ``cut`` (K8a's b1) one cell more: the cell that holds the
    cut split there, its second half right after it; where the cut is no
    position inside a cell (a cell multiple, <= 0 or >= n_keys) the cells
    stay whole and the last one is empty (lo >= hi). A row of context ctx
    folds the cells that start below min(ctx, n_keys), in this order."""
    n = max(1, -(-n_keys // cell))
    cells = [(c * cell, min((c + 1) * cell, n_keys)) for c in range(n)]
    if cut is None:
        return cells
    if 0 < cut < n_keys and cut % cell:
        kb = cut // cell
        return cells[:kb] + [(kb * cell, cut), (cut, cells[kb][1])] + cells[kb + 1 :]
    return cells + [(n * cell, n_keys)]


def fresh_cells(ctx0: int, rows: int, cell: int, split: bool = False) -> list[tuple[int, int]]:
    """The fresh cells of a deferred verify's group at pre-round context
    ``ctx0`` with ``rows`` fresh rows (positions ctx0 .. ctx0 + rows - 1):
    the window in one cell (K6a, K6b) or, with ``split`` (K8b, rows <=
    cell), cut at the cell multiple cstar = (ctx0 // cell + 1) * cell into
    [ctx0, cstar) and [cstar, ctx0 + rows) (empty where cstar >= ctx0 +
    rows)."""
    end = ctx0 + rows
    if not split:
        return [(ctx0, end)]
    cstar = (ctx0 // cell + 1) * cell
    return [(ctx0, min(cstar, end)), (cstar, end)]


def launch_cells(n_keys: int, cell: int, cut: int | None = None, ctx0: int | None = None,
                 rows: int = 0) -> list[tuple[int, int, bool]]:
    """Every cell of one group's launch, (lo, hi, from the fresh rows), in
    the launch's order (``WalkCells::bounds``): the table's cells (K8a's
    ``cut`` included), and with ``ctx0`` (K6a, K6b; K8b with ``cut`` =
    ctx0) each table cell ended at min(n_keys, ctx0), then the fresh
    cells."""
    if ctx0 is None:
        return [(lo, hi, False) for lo, hi in key_cells(n_keys, cell, cut)]
    if cut not in (None, ctx0):
        raise ValueError(f"the fresh cells are cut at their pre-round context {ctx0} alone, not {cut}")
    cached = min(n_keys, ctx0)
    table = [(lo, min(hi, cached), False) for lo, hi in key_cells(n_keys, cell)]
    return table + [(lo, hi, True) for lo, hi in fresh_cells(ctx0, rows, cell, cut is not None)]


def row_cells(n_keys: int, cell: int, ctx: int, cut: int | None = None, ctx0: int | None = None,
              rows: int = 0) -> list[int]:
    """The cells of ``launch_cells`` whose partials the combine folds for a
    row of context ``ctx`` (before it drops those with l = 0), in order: the
    cells the row sees a key of, a table cell's below min(ctx, n_keys,
    ctx0) and a fresh cell's below ctx. The walk writes a row's partial in
    just these cells."""
    lim = min(ctx, n_keys) if ctx0 is None else min(ctx, n_keys, ctx0)
    return [i for i, (lo, hi, fresh) in enumerate(launch_cells(n_keys, cell, cut, ctx0, rows))
            if lo < min(hi, ctx if fresh else lim)]


def launch(lib, fn, quant: bool, q, cache, layer_idx, tables, context_lens, scale, rows: int,
           before: tuple = (), after: tuple = (), fresh: tuple | None = None, cut=None):
    """Validate and launch ``fn`` (``npt_walk`` / ``npt_partials`` or
    their ``_q8`` twins, ``npt_fresh_walk``, ``npt_cut_walk``) on
    ``tables.shape[0]`` groups of ``rows`` rows: ``fn(q, cache[, scales],
    tables, contexts, *before, out, *after, part_acc, part_ml, groups, rows,
    m, hq, hkv, d, bs, k_off, v_off, scale, is_bf16[, is_fp8], stream)``,
    where ``before`` / ``after`` are the extra device tensors of the partials
    kernels (is_local, None for K7's every slot local; m, l). ``fresh`` (K6a,
    K6b): (ctx0, fresh K, fresh V), passed as ``before``; their fresh cell
    adds one to the table's cells. ``cut`` (bf16 alone: K8a's b1 [groups],
    or K8b's ctx0 with ``fresh``, rows <= ``cell_keys(hkv)``): passed with
    the fresh operands (None without them) as ``before``; it adds one cell
    more. Allocates the output and, where the bf16 route has several cells,
    the partials scratch; raises on a launch error. Returns the output."""
    if rows < 1:
        raise ValueError(f"rows_per_group must be >= 1, got {rows}")
    groups = tables.shape[0]
    hq, hkv, d, bs, m = _check_inputs(q, cache, tables, context_lens, groups, groups * rows, quant=quant)
    if q.element_size() == 2 and hq // hkv > MAX_WARPS * 16:  # one row's query vectors exceed 8 warps
        raise ValueError(f"{hq // hkv} query heads per KV head do not fit one block (at most 128)")
    if fresh is not None:
        _check_fresh(q, *fresh, groups, hkv, d)
        if q.element_size() != 2 or fresh[1].data_ptr() % 16 or fresh[2].data_ptr() % 16:
            raise ValueError("the fresh cell takes bf16 queries and fresh rows at 16-byte boundaries")
        before = fresh
    if cut is not None:
        if (cut.device != q.device or cut.dtype != torch.int32 or cut.shape != (groups,)
                or not cut.is_contiguous()):
            raise ValueError(f"the cut must be contiguous int32 [{groups}] on q's device")
        if q.element_size() != 2:
            raise ValueError("the cut cell takes bf16 queries")
        if fresh is not None and (cut is not fresh[0] or rows > cell_keys(hkv)):
            raise ValueError(f"the fresh window is cut at ctx0 alone, with at most {cell_keys(hkv)} rows a group")
        before = (cut, *(fresh if fresh is not None else (None, None, None)))
    k_off, v_off = global_block_offsets(cache, layer_idx)
    out = torch.empty_like(q)
    # the bf16 route's cells (the f32 route has none)
    cells = n_cells(m * bs, cell_keys(hkv), cut is not None, fresh is not None) if q.element_size() == 2 else 1
    scratch = part_acc = part_ml = None
    if cells > 1:  # (acc [.., d], then (m, l) [.., 2]) of every row, head and cell in one scratch
        slots = groups * rows * hq * cells
        scratch = torch.empty(slots * (d + 2), dtype=torch.float32, device=q.device)
        part_acc = scratch.data_ptr()
        part_ml = part_acc + slots * d * 4
    stream = torch.cuda.current_stream(q.device).cuda_stream
    head = (q.data_ptr(), cache.q.data_ptr(), cache.s.data_ptr()) if quant else (q.data_ptr(), cache.data_ptr())
    ptrs = (tables.data_ptr(), context_lens.data_ptr(), *(t if t is None else t.data_ptr() for t in before),
            out.data_ptr(), *(t.data_ptr() for t in after), part_acc, part_ml)
    common = (groups, rows, m, hq, hkv, d, bs, k_off, v_off, float(scale), int(q.dtype == torch.bfloat16))
    tail = (int(cache.q.dtype == torch.float8_e4m3fn),) if quant else ()
    err = fn(*head, *ptrs, *common, *tail, stream)
    build.check(lib, err, fn.__name__)
    return out
