"""Kernels K1 (paged decode) and K2 (packed verify): wrappers of
``csrc/paged_attention.cu``.

K1 ``paged_decode`` replaces ``_kernel_db`` (entry
``paged_attention_pallas``) and K2 ``paged_verify`` replaces
``_grouped_kernel_db`` (entry ``paged_attention_pallas_grouped``), both
in nano_pearl_tpu/ops/pallas/paged_attention.py. Their plain versions
are ``paged_attention_ref`` and ``paged_attention_grouped_ref``
(ops/attention.py).

What bounds them on the H100: bytes. A row reads ``ctx * 2 * Hkv * D``
cache elements and does ``4 * ctx * Hq * D`` flops, about 4 flops per
byte in bf16 at G = Hq / Hkv = 4, far under the card's ~295 flops per
byte. The design answer: one block per (sequence, KV head, 256-position
key chunk) streams the chunk's pages once, in 64-key tiles staged in
shared memory with 16-byte loads, and folds every query head of the
group (and, for K2, every packed row) into f32 online-softmax partials,
so each K/V byte is read once per sequence and the card gets
sequences x heads x chunks blocks; a second launch combines each row's
partials in chunk order. K1 is K2's code with one row, so a K2 row and
the K1 row of the same query and context fold the same tiles and
partials with the same arithmetic and agree bit for bit (the
draft/verify agreement PEARL relies on at the layer-share ceiling).

K9a ``paged_decode_q8`` and K9b ``paged_verify_q8`` are K1 and K2 over
a quantized cache (``QuantKVCache``: 1-byte int8 or e4m3 values and a
bf16 scale per slot and KV head). They replace ``_kernel_db_q8v2``
(entry ``_db_call_q8_single``) and ``_grouped_kernel_db_q8v2`` (entry
``_db_call_q8_grouped``). Their tile loader reads 16 one-byte values per
16-byte load and stores the tile dequantized and rounded to the query's
dtype in the layout the shared tile update reads, so they read half
K1/K2's cache bytes and K9b rows equal K9a rows bit for bit. Same plain
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
is K1 with the chunk that holds a per-row boundary b1 cut in two there;
K8b is K6a with the fresh window cut at the chunk multiple inside it.
Given the same keys, a K8b row equals the K8a row of the same query and
context at b1 = ctx0 bit for bit (the cell partition is set out in
``csrc/paged_attention.cu``). Plain versions: ``paged_attention_ref`` for
K8a (the boundary changes only the rounding, as the JAX package's jnp
path ignores it) and ``paged_attention_grouped_fresh_ref`` for K6a and
K8b.

Each wrapper takes the plain version for CPU tensors, launches the
kernel for CUDA tensors (counting the launch in ``.launches``), and
raises on anything else, a cache of the other kind included.
"""

from __future__ import annotations

import ctypes

import torch

from nano_pearl_tpu_torch.ops.attention import (
    check_head_dim,
    paged_attention_grouped_fresh_ref,
    paged_attention_grouped_ref,
    paged_attention_ref,
)
from nano_pearl_tpu_torch.ops.cuda import build
from nano_pearl_tpu_torch.ops.kv_cache import cache_is_quantized, global_block_offsets

plain_decode = paged_attention_ref
plain_verify = paged_attention_grouped_ref
plain_fresh = paged_attention_grouped_fresh_ref

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SUPPORTED = (torch.bfloat16, torch.float32)
_Q8 = (torch.int8, torch.float8_e4m3fn)


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


MAX_SMEM = 232448  # bytes of shared memory a block may opt into on sm_90 (kMaxSmem)


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


def _scratch(lib, rows: int, hq: int, d: int, m: int, bs: int, device, extra: int = 0):
    """f32 (acc, (m, l)) partials of every row, head and key chunk (and
    ``extra`` more cells per row and head: K8a's cut chunk, K6a/K8b's fresh
    window)."""
    n_chunks = -(-m * bs // lib.npt_chunk_tokens()) + extra
    acc = torch.empty((rows, hq, n_chunks, d), dtype=torch.float32, device=device)
    ml = torch.empty((rows, hq, n_chunks, 2), dtype=torch.float32, device=device)
    return acc, ml


def _check_inputs(q, cache, block_tables, context_lens, n_tables: int, n_rows: int, quant=False):
    """Validate what the kernel takes (a quantized cache for the K9
    kernels, a bf16/f32 one otherwise); returns (hq, hkv, d, bs, m)."""
    if cache_is_quantized(cache) != quant:
        raise ValueError(f"this kernel takes a {'quantized' if quant else 'bf16/f32'} cache")
    tensors = {"q": q, "block_tables": block_tables, "context_lens": context_lens}
    tensors.update({"cache.q": cache.q, "cache.s": cache.s} if quant else {"cache": cache})
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
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


def _launch(fn: str, q, cache, layer_idx, tables, context_lens, scale, rows: int):
    """Run ``fn`` (``npt_paged_decode`` / ``npt_paged_verify``, or their
    ``_q8`` twins over a quantized cache) on ``tables.shape[0]`` groups of
    ``rows`` rows; returns the output."""
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


def _fresh_rows(rows_per_group, name: str) -> int:
    """Rows per group of a deferred verify: 1 .. one key chunk (the fresh
    window crosses at most one chunk multiple, which K8b's partition and
    its equality with K8a rest on)."""
    r, chunk = int(rows_per_group), _lib().npt_chunk_tokens()
    if not 1 <= r <= chunk:
        raise ValueError(f"{name} takes 1 <= rows_per_group <= {chunk}, got {r}")
    return r


def _verify_rows(rows_per_group, name: str) -> int:
    r = int(rows_per_group)
    if r < 2:
        raise ValueError(f"{name} takes rows_per_group >= 2 (use the decode kernel for 1)")
    return r


def paged_decode(q, cache, layer_idx, block_tables, context_lens, scale):
    """K1: q [N, Hq, D] against its own block table row and context."""
    if q.device.type == "cpu":
        return plain_decode(q, cache, layer_idx, block_tables, context_lens, scale)
    out = _launch("npt_paged_decode", q, cache, layer_idx, block_tables, context_lens, scale, 1)
    paged_decode.launches += 1
    return out


def paged_verify(q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group):
    """K2: q [B*R, Hq, D]; the R rows of a group share its block table
    row and each has its own context length."""
    if q.device.type == "cpu":
        return plain_verify(
            q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group
        )
    r = _verify_rows(rows_per_group, "paged_verify")
    out = _launch("npt_paged_verify", q, cache, layer_idx, group_tables, context_lens, scale, r)
    paged_verify.launches += 1
    return out


def paged_decode_q8(q, cache, layer_idx, block_tables, context_lens, scale):
    """K9a: K1 over a quantized cache."""
    if q.device.type == "cpu":
        return plain_decode(q, cache, layer_idx, block_tables, context_lens, scale)
    out = _launch("npt_paged_decode_q8", q, cache, layer_idx, block_tables, context_lens, scale, 1)
    paged_decode_q8.launches += 1
    return out


def paged_verify_q8(q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group):
    """K9b: K2 over a quantized cache."""
    if q.device.type == "cpu":
        return plain_verify(
            q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group
        )
    r = _verify_rows(rows_per_group, "paged_verify_q8")
    out = _launch("npt_paged_verify_q8", q, cache, layer_idx, group_tables, context_lens, scale, r)
    paged_verify_q8.launches += 1
    return out


def paged_decode_split(q, cache, layer_idx, block_tables, context_lens, b1, scale):
    """K8a: K1 with the key chunk that holds b1[i] (int32 [N]) cut there for
    row i; the plain version ignores b1."""
    if q.device.type == "cpu":
        return plain_decode(q, cache, layer_idx, block_tables, context_lens, scale)
    n = q.shape[0]
    hq, hkv, d, bs, m = _check_inputs(q, cache, block_tables, context_lens, n, n)
    if b1.device != q.device or b1.dtype != torch.int32 or b1.shape != (n,) or not b1.is_contiguous():
        raise ValueError(f"b1 must be contiguous int32 [{n}] on q's device")
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
    paged_decode_split.launches += 1
    return out


def _launch_fresh(split: bool, q, cache, layer_idx, group_tables, context_lens, ctx0, fresh_k, fresh_v,
                  scale, rows_per_group):
    name = "paged_verify_fresh_split" if split else "paged_verify_fresh"
    r = _fresh_rows(rows_per_group, name)
    groups = group_tables.shape[0]
    hq, hkv, d, bs, m = _check_inputs(q, cache, group_tables, context_lens, groups, groups * r)
    _check_fresh(q, ctx0, fresh_k, fresh_v, groups, hkv, d)
    k_off, v_off = global_block_offsets(cache, layer_idx)
    out = torch.empty_like(q)
    lib = _lib()
    acc, ml = _scratch(lib, groups * r, hq, d, m, bs, q.device, extra=2)
    err = lib.npt_paged_verify_fresh(
        q.data_ptr(), cache.data_ptr(), fresh_k.data_ptr(), fresh_v.data_ptr(),
        group_tables.data_ptr(), context_lens.data_ptr(), ctx0.data_ptr(), out.data_ptr(),
        acc.data_ptr(), ml.data_ptr(), groups, r, m, hq, hkv, d, bs, k_off, v_off, float(scale),
        int(split), int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, err, name)
    return out


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
