"""The launch plan of the page walk behind K10a-d, K11a-d and the bf16
route of K7 and K6b (``csrc/paged_walk.cuh``), mirrored in Python, and the
launch their wrappers share (``paged_attention_fallback.py``,
``paged_attention_partials.py``, ``mono_attention.py``).

``walk_plan`` is the mirror of the launchers' ``walk_plan``, which both
libraries export as ``npt_walk_plan``; the CPU tests check the mirror and
the card tests hold it against the export. bf16 queries run on the tensor
cores: 16 query vectors a warp, a group's rows over up to 8 warps a block,
each table's key stream cut into cells of ``cell_keys(hkv)`` keys at fixed
positions (``key_cells``), one block per (group, KV head, row slice, cell)
and, where the table holds more than one cell, f32 partials that a
combine kernel folds. K6b's launch adds one cell after the table's, the
round's fresh keys read from their rows (``fresh``). f32 queries walk the
table a page at a time on CUDA cores with no split (``rows_per_block``'s
row slices).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from nano_pearl_tpu_torch.ops.cuda import build
from nano_pearl_tpu_torch.ops.cuda.paged_attention import MAX_SMEM, _check_fresh, _check_inputs, rows_per_block
from nano_pearl_tpu_torch.ops.kv_cache import global_block_offsets

THREADS = 256  # threads per block, at most (kThreads)
KEYS = 64  # bf16: keys per staged tile (kWalkKeys)
MAX_WARPS = 8  # bf16: warps of query vectors a block, at most (kWalkMaxWarps)
MIN_WARPS = 4  # bf16: warps a block, at least (kWalkMinWarps)


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


def n_cells(n_keys: int, cell: int) -> int:
    """How many cells the bf16 route cuts a table of ``n_keys`` keys into:
    ``ceil(n_keys / cell)``, at least one (the launchers' ``n_cells``)."""
    return max(1, -(-n_keys // cell))


def key_cells(n_keys: int, cell: int) -> list[tuple[int, int]]:
    """The key ranges [lo, hi) the bf16 route cuts a table of ``n_keys =
    M * BS`` keys into: ``n_cells`` of them, cell c = [c * cell, min((c + 1)
    * cell, n_keys)). A row of context ctx folds the cells that start below
    min(ctx, n_keys), in this order."""
    return [(c * cell, min((c + 1) * cell, n_keys)) for c in range(n_cells(n_keys, cell))]


def launch(lib, fn, quant: bool, q, cache, layer_idx, tables, context_lens, scale, rows: int,
           before: tuple = (), after: tuple = (), fresh: tuple | None = None):
    """Validate and launch ``fn`` (``npt_fallback`` / ``npt_partials`` or
    their ``_q8`` twins, ``npt_fresh_walk``) on ``tables.shape[0]`` groups
    of ``rows`` rows: ``fn(q, cache[, scales], tables, contexts, *before,
    out, *after, part_acc, part_ml, groups, rows, m, hq, hkv, d, bs, k_off,
    v_off, scale, is_bf16[, is_fp8], stream)``, where ``before`` / ``after``
    are the extra device tensors of the partials kernels (is_local, None
    for K7's every slot local; m, l). ``fresh`` (K6b): (ctx0, fresh K,
    fresh V), passed as ``before``; their fresh cell adds one to the
    table's cells. Allocates the output and, where the bf16 route has
    several cells, the partials scratch; raises on a launch error. Returns
    the output."""
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
    k_off, v_off = global_block_offsets(cache, layer_idx)
    out = torch.empty_like(q)
    cells = n_cells(m * bs, cell_keys(hkv)) + (fresh is not None) if q.element_size() == 2 else 1  # bf16 only
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
