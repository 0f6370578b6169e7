"""Kernels K1 (paged decode) and K2 (packed verify), their twins K9a/K9b
over a 1-byte cache, and the schedule overrides' K8a, K6a and K8b:
wrappers of ``csrc/paged_attention.cu`` and, for bf16 queries, of the
page walk's exports in ``csrc/paged_walk.cu`` (K1/K2, K9a/K9b) and
``csrc/paged_attention_partials.cu`` (K6a, K8a, K8b).

K1 ``paged_decode`` replaces ``_kernel_db`` (entry
``paged_attention_pallas``) and K2 ``paged_verify`` replaces
``_grouped_kernel_db`` (entry ``paged_attention_pallas_grouped``), both
in nano_pearl_tpu/ops/pallas/paged_attention.py. Their plain versions
are ``paged_attention_ref`` and ``paged_attention_grouped_ref``
(ops/attention.py).

What bounds them on the H100: bytes. A row reads ``ctx * 2 * Hkv * D``
cache elements and does ``4 * ctx * Hq * D`` flops, about 4 flops per
byte in bf16 at G = Hq / Hkv = 4, far under the card's ~295 flops per
byte (8 over a 1-byte cache). K1, K2, K9a and K9b share one launch path
(``_attend``), which picks the route by the query type:

- bf16 queries (the main path, the server, the quantized path): the
  tensor-core page walk of ``csrc/paged_walk.cuh``, K10a-d's launch
  (``paged_walk.launch`` of the export ``npt_walk``, over a 1-byte cache
  ``npt_walk_q8``). The R * G query vectors of a (group, KV
  head) sit 16 to a warp on ``mma.sync``; each table's key stream is cut
  into cells of 128 keys (Hkv <= 2, else 256) at fixed positions, one
  block per (group, KV head, row slice, cell), K/V pages arrive through a
  ``cp.async`` ring, and a combine folds each row's cells in order.
- f32 queries (the exactness pairs): the chunk template of
  ``csrc/paged_attention.cu`` on CUDA cores (the tensor cores would take
  f32 as TF32): one block per (sequence, KV head, 256-position key chunk)
  streams the chunk's pages in 64-key tiles and folds every query head of
  the group (and, for K2, every packed row) into f32 online-softmax
  partials; a second launch combines each row's partials in chunk order.

Either way a K2 row and the K1 row of the same query, context and table
fold the same cells (or chunks) with the same arithmetic and agree bit for
bit (the draft/verify agreement PEARL relies on at the layer-share
ceiling; ``paged_walk.cuh`` and ``paged_attention.cu`` carry the argument).

K9a ``paged_decode_q8`` and K9b ``paged_verify_q8`` are K1 and K2 over
a quantized cache (``QuantKVCache``: 1-byte int8 or e4m3 values and a
bf16 scale per slot and KV head). They replace ``_kernel_db_q8v2``
(entry ``_db_call_q8_single``) and ``_grouped_kernel_db_q8v2`` (entry
``_db_call_q8_grouped``). Both routes copy the raw bytes, half those of a
bf16 cache, and dequantize each tile once in shared memory (value x
scale, rounded to the query's dtype, as the plain versions round it): the
walk's 1-byte path for bf16 queries (K10c/K10d's launch), the chunk
template's ``npt_paged_decode_q8`` / ``npt_paged_verify_q8`` for f32
ones. Either way K9b rows equal K9a rows bit for bit. Same plain
versions: they read either cache kind.

K8a ``paged_decode_split``, K6a ``paged_verify_fresh`` and K8b
``paged_verify_fresh_split`` are the kernel-schedule overrides' decode
and deferred-write verify (``engine/runner.py``). They replace
``_kernel_db_split`` (entry ``paged_attention_pallas_split``),
``_grouped_kernel_db_fresh`` (entry ``paged_attention_pallas_grouped_fresh``)
and ``_grouped_kernel_db_fresh_split`` (entry
``paged_attention_pallas_grouped_fresh_split``). K6a is K2 over the
pre-round cache (each row's context clamped to its group's ctx0) with one
more partial per (group, head) read from the in-operand fresh rows; K8a
is K1 with the cell that holds a per-row boundary b1 cut in two there;
K8b is K6a with the fresh window cut at the cell multiple inside it.
Given the same keys, a K8b row equals the K8a row of the same query and
context at b1 = ctx0 bit for bit. Plain versions: ``paged_attention_ref``
for K8a (the boundary changes only the rounding, as the JAX package's jnp
path ignores it) and ``paged_attention_grouped_fresh_ref`` for K6a and
K8b. They take the same two routes as K1/K2:

- bf16 queries: the tensor-core page walk (``paged_walk.launch``). K6a
  launches K6b's ``npt_fresh_walk`` (the cache cells below each group's
  ctx0, then one fresh cell), so a K6a row equals the K6b row of the same
  inputs bit for bit; K8a and K8b launch ``npt_cut_walk``, the walk with a
  cut cell: K8a's table cell that holds b1 is cut there, K8b's fresh window
  is cut at the multiple of ``cell_keys(hkv)`` inside it (its groups hold
  at most that many rows), so that both fold the same cells
  (``csrc/paged_walk.cuh`` carries the argument).
- f32 queries: the CUDA-core cells of ``csrc/paged_attention.cu`` (256-key
  chunks, the same partition, set out there).

Each wrapper takes the plain version for CPU tensors, launches the
kernel for CUDA tensors (counting the launch in ``.launches``), and
raises on anything else, a cache of the other kind included.
"""

from __future__ import annotations

import ctypes

import torch

from nano_pearl_tpu_torch.ops.attention import (
    paged_attention_grouped_fresh_ref,
    paged_attention_grouped_ref,
    paged_attention_ref,
)
from nano_pearl_tpu_torch.ops.cuda import build, paged_attention_partials, paged_walk
from nano_pearl_tpu_torch.ops.cuda.paged_walk import _check_fresh, _check_inputs
from nano_pearl_tpu_torch.ops.kv_cache import global_block_offsets

plain_decode = paged_attention_ref
plain_verify = paged_attention_grouped_ref
plain_fresh = paged_attention_grouped_fresh_ref

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    if not getattr(lib, "_npt_typed", False):
        common = [_I, _I, _I, _I, _I, _LL, _LL, _F, _I, _P]
        lib.npt_paged_decode.argtypes = [_P] * 7 + [_I] + common
        lib.npt_paged_verify.argtypes = [_P] * 7 + [_I, _I] + common
        lib.npt_paged_decode_q8.argtypes = [_P] * 8 + [_I] + common[:-1] + [_I, _P]
        lib.npt_paged_verify_q8.argtypes = [_P] * 8 + [_I, _I] + common[:-1] + [_I, _P]
        lib.npt_paged_decode_split.argtypes = [_P] * 8 + [_I] + common
        lib.npt_paged_verify_fresh.argtypes = [_P] * 10 + [_I, _I] + common[:-2] + [_I, _I, _P]
        for fn in ("npt_paged_decode", "npt_paged_verify", "npt_paged_decode_q8", "npt_paged_verify_q8",
                   "npt_paged_decode_split", "npt_paged_verify_fresh"):
            getattr(lib, fn).restype = _I
        lib.npt_chunk_tokens.restype = _I
        lib.npt_rows_per_block.argtypes = [_I, _I, _I, _I, _LL, _I]
        lib.npt_rows_per_block.restype = _I
        lib._npt_typed = True
    return lib


def _scratch(lib, rows: int, hq: int, d: int, m: int, bs: int, device, extra: int = 0):
    """f32 (acc, (m, l)) partials of every row, head and key chunk (and
    ``extra`` more cells per row and head: K8a's cut chunk, K6a/K8b's fresh
    window)."""
    n_chunks = -(-m * bs // lib.npt_chunk_tokens()) + extra
    acc = torch.empty((rows, hq, n_chunks, d), dtype=torch.float32, device=device)
    ml = torch.empty((rows, hq, n_chunks, 2), dtype=torch.float32, device=device)
    return acc, ml


def _launch(fn: str, q, cache, layer_idx, tables, context_lens, scale, rows: int):
    """Run ``fn`` (``npt_paged_decode`` / ``npt_paged_verify`` or their
    ``_q8`` twins over a quantized cache, f32 queries alone) on the chunk
    template, ``tables.shape[0]`` groups of ``rows`` rows; returns the
    output."""
    quant = fn.endswith("_q8")
    groups = tables.shape[0]
    hq, hkv, d, bs, m = _check_inputs(q, cache, tables, context_lens, groups, groups * rows, quant=quant)
    k_off, v_off = global_block_offsets(cache, layer_idx)
    out = torch.empty_like(q)
    lib = _lib()
    acc, ml = _scratch(lib, groups * rows, hq, d, m, bs, q.device)
    is_bf16 = int(q.dtype == torch.bfloat16)
    # the C interfaces differ only in the cache's pointers, the verify's row
    # count and the trailing type flags
    cache_ptrs = (cache.q.data_ptr(), cache.s.data_ptr()) if quant else (cache.data_ptr(),)
    flags = (is_bf16, int(cache.q.dtype == torch.float8_e4m3fn)) if quant else (is_bf16,)
    counts = (groups,) if "decode" in fn else (groups, rows)
    err = getattr(lib, fn)(
        q.data_ptr(), *cache_ptrs, tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        acc.data_ptr(), ml.data_ptr(), *counts, m, hq, hkv, d, bs, k_off, v_off, float(scale),
        *flags, torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, err, fn[len("npt_"):])
    return out


def _fresh_rows(rows_per_group, name: str, hkv: int) -> int:
    """Rows per group of a deferred verify: 1 .. one of the walk's cells,
    ``cell_keys(hkv)`` keys (the fresh window crosses at most one cell
    multiple, and so at most one of the chunk template's, which K8b's
    partition and its equality with K8a rest on)."""
    r, cell = int(rows_per_group), paged_walk.cell_keys(hkv)
    if not 1 <= r <= cell:
        raise ValueError(f"{name} takes 1 <= rows_per_group <= {cell}, got {r}")
    return r


def _verify_rows(rows_per_group, name: str) -> int:
    r = int(rows_per_group)
    if r < 2:
        raise ValueError(f"{name} takes rows_per_group >= 2 (use the decode kernel for 1)")
    return r


def _attend(q, cache, layer_idx, tables, context_lens, scale, rows: int, quant: bool = False):
    """K1 (``rows`` 1) and K2 (K9a and K9b over a ``quant`` cache) on
    ``tables.shape[0]`` groups of ``rows`` rows, one launch path for all
    four: bf16 queries on the page walk, f32 on the chunk template. Returns
    the output."""
    if q.dtype == torch.bfloat16:
        lib = paged_walk._lib()
        return paged_walk.launch(lib, lib.npt_walk_q8 if quant else lib.npt_walk, quant, q, cache, layer_idx,
                                 tables, context_lens, scale, rows)
    fn = ("npt_paged_verify" if rows > 1 else "npt_paged_decode") + ("_q8" if quant else "")
    return _launch(fn, q, cache, layer_idx, tables, context_lens, scale, rows)


def paged_decode(q, cache, layer_idx, block_tables, context_lens, scale):
    """K1: q [N, Hq, D] against its own block table row and context."""
    if q.device.type == "cpu":
        return plain_decode(q, cache, layer_idx, block_tables, context_lens, scale)
    out = _attend(q, cache, layer_idx, block_tables, context_lens, scale, 1)
    paged_decode.launches += 1
    return out


def paged_verify(q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group):
    """K2: q [B*R, Hq, D]; the R rows of a group share its block table
    row and each has its own context length."""
    if q.device.type == "cpu":
        return plain_verify(
            q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group
        )
    out = _attend(q, cache, layer_idx, group_tables, context_lens, scale,
                  _verify_rows(rows_per_group, "paged_verify"))
    paged_verify.launches += 1
    return out


def paged_decode_q8(q, cache, layer_idx, block_tables, context_lens, scale):
    """K9a: K1 over a quantized cache."""
    if q.device.type == "cpu":
        return plain_decode(q, cache, layer_idx, block_tables, context_lens, scale)
    out = _attend(q, cache, layer_idx, block_tables, context_lens, scale, 1, quant=True)
    paged_decode_q8.launches += 1
    return out


def paged_verify_q8(q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group):
    """K9b: K2 over a quantized cache."""
    if q.device.type == "cpu":
        return plain_verify(
            q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group
        )
    out = _attend(q, cache, layer_idx, group_tables, context_lens, scale,
                  _verify_rows(rows_per_group, "paged_verify_q8"), quant=True)
    paged_verify_q8.launches += 1
    return out


def _decode_split_f32(q, cache, layer_idx, block_tables, context_lens, b1, scale):
    """K8a's f32 route: the chunk template's cells, the chunk that holds b1
    cut there; returns the output."""
    n = q.shape[0]
    hq, hkv, d, bs, m = _check_inputs(q, cache, block_tables, context_lens, n, n)
    k_off, v_off = global_block_offsets(cache, layer_idx)
    out = torch.empty_like(q)
    lib = _lib()
    acc, ml = _scratch(lib, n, hq, d, m, bs, q.device, extra=1)
    err = lib.npt_paged_decode_split(
        q.data_ptr(), cache.data_ptr(), block_tables.data_ptr(), context_lens.data_ptr(),
        b1.data_ptr(), out.data_ptr(), acc.data_ptr(), ml.data_ptr(), n, m, hq, hkv, d, bs,
        k_off, v_off, float(scale), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, err, "paged_decode_split")
    return out


def paged_decode_split(q, cache, layer_idx, block_tables, context_lens, b1, scale):
    """K8a: K1 with the key cell (bf16) or chunk (f32) that holds b1[i]
    (int32 [N]) cut there for row i; the plain version ignores b1."""
    if q.device.type == "cpu":
        return plain_decode(q, cache, layer_idx, block_tables, context_lens, scale)
    n = q.shape[0]
    if b1.device != q.device or b1.dtype != torch.int32 or b1.shape != (n,) or not b1.is_contiguous():
        raise ValueError(f"b1 must be contiguous int32 [{n}] on q's device")
    if q.dtype == torch.bfloat16:  # the walk with a cut cell
        lib = paged_attention_partials._lib()
        out = paged_walk.launch(lib, lib.npt_cut_walk, False, q, cache, layer_idx, block_tables, context_lens,
                                scale, 1, cut=b1)
    else:
        out = _decode_split_f32(q, cache, layer_idx, block_tables, context_lens, b1, scale)
    paged_decode_split.launches += 1
    return out


def _fresh_f32(split: bool, q, cache, layer_idx, group_tables, context_lens, ctx0, fresh_k, fresh_v, scale,
               rows: int):
    """K6a's (K8b's with ``split``) f32 route: the chunk template's cells,
    then the fresh window (cut at the chunk multiple inside it); returns the
    output."""
    groups = group_tables.shape[0]
    hq, hkv, d, bs, m = _check_inputs(q, cache, group_tables, context_lens, groups, groups * rows)
    _check_fresh(q, ctx0, fresh_k, fresh_v, groups, hkv, d)
    k_off, v_off = global_block_offsets(cache, layer_idx)
    out = torch.empty_like(q)
    lib = _lib()
    acc, ml = _scratch(lib, groups * rows, hq, d, m, bs, q.device, extra=2)
    err = lib.npt_paged_verify_fresh(
        q.data_ptr(), cache.data_ptr(), fresh_k.data_ptr(), fresh_v.data_ptr(),
        group_tables.data_ptr(), context_lens.data_ptr(), ctx0.data_ptr(), out.data_ptr(),
        acc.data_ptr(), ml.data_ptr(), groups, rows, m, hq, hkv, d, bs, k_off, v_off, float(scale),
        int(split), int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, err, "paged_verify_fresh_split" if split else "paged_verify_fresh")
    return out


def _launch_fresh(split: bool, q, cache, layer_idx, group_tables, context_lens, ctx0, fresh_k, fresh_v,
                  scale, rows_per_group):
    """K6a (K8b with ``split``) on either route: bf16 queries on the walk
    (K6b's launch, or the cut walk), f32 on the chunk template."""
    name = "paged_verify_fresh_split" if split else "paged_verify_fresh"
    r = _fresh_rows(rows_per_group, name, cache.shape[-1] // q.shape[-1])
    if q.dtype != torch.bfloat16:
        return _fresh_f32(split, q, cache, layer_idx, group_tables, context_lens, ctx0, fresh_k, fresh_v, scale, r)
    lib = paged_attention_partials._lib()
    return paged_walk.launch(lib, lib.npt_cut_walk if split else lib.npt_fresh_walk, False, q, cache, layer_idx,
                             group_tables, context_lens, scale, r, fresh=(ctx0, fresh_k, fresh_v),
                             cut=ctx0 if split else None)


def paged_verify_fresh(q, cache, layer_idx, group_tables, context_lens, ctx0, fresh_k, fresh_v,
                       scale, rows_per_group):
    """K6a: the deferred-write packed verify of q [B*R, Hq, D]: the cache
    (positions < ctx0[g] of group g, read-only) plus the fresh rows
    fresh_k/v [B*R, Hkv, D], row t of a group at position ctx0[g] + t;
    context_lens [B*R] each row's context with its visible fresh rows."""
    if q.device.type == "cpu":
        return plain_fresh(q, cache, layer_idx, group_tables, context_lens, ctx0, fresh_k, fresh_v, scale)
    out = _launch_fresh(False, q, cache, layer_idx, group_tables, context_lens, ctx0, fresh_k, fresh_v,
                        scale, rows_per_group)
    paged_verify_fresh.launches += 1
    return out


def paged_verify_fresh_split(q, cache, layer_idx, group_tables, context_lens, ctx0, fresh_k, fresh_v,
                             scale, rows_per_group):
    """K8b: K6a on the split-boundary schedule, its rows bitwise equal to
    K8a's at b1 = ctx0."""
    if q.device.type == "cpu":
        return plain_fresh(q, cache, layer_idx, group_tables, context_lens, ctx0, fresh_k, fresh_v, scale)
    out = _launch_fresh(True, q, cache, layer_idx, group_tables, context_lens, ctx0, fresh_k, fresh_v,
                        scale, rows_per_group)
    paged_verify_fresh_split.launches += 1
    return out


paged_decode.launches = 0
paged_verify.launches = 0
paged_decode_q8.launches = 0
paged_verify_q8.launches = 0
paged_decode_split.launches = 0
paged_verify_fresh.launches = 0
paged_verify_fresh_split.launches = 0
