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

Each wrapper takes the plain version for CPU tensors, launches the
kernel for CUDA tensors (counting the launch in ``.launches``), and
raises on anything else, a cache of the other kind included.
"""

from __future__ import annotations

import ctypes

import torch

from nano_pearl_tpu_torch.ops.attention import (
    paged_attention_grouped_ref,
    paged_attention_ref,
)
from nano_pearl_tpu_torch.ops.cuda import build
from nano_pearl_tpu_torch.ops.kv_cache import cache_is_quantized, global_block_offsets

plain_decode = paged_attention_ref
plain_verify = paged_attention_grouped_ref

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
        for fn in ("npt_paged_decode", "npt_paged_verify", "npt_paged_decode_q8", "npt_paged_verify_q8"):
            getattr(lib, fn).restype = _I
        lib.npt_chunk_tokens.restype = _I
        lib._npt_typed = True
    return lib


def _scratch(lib, rows: int, hq: int, d: int, m: int, bs: int, device):
    """f32 (acc, (m, l)) partials of every row, head and key chunk."""
    n_chunks = -(-m * bs // lib.npt_chunk_tokens())
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
    if d not in (64, 128):
        raise ValueError(f"head_dim {d} not supported (64 or 128)")
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


paged_decode.launches = 0
paged_verify.launches = 0
paged_decode_q8.launches = 0
paged_verify_q8.launches = 0
