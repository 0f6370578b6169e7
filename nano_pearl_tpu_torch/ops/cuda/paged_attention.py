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

Each wrapper takes the plain version for CPU tensors, launches the
kernel for CUDA tensors (counting the launch in ``.launches``), and
raises on anything else.
"""

from __future__ import annotations

import ctypes

import torch

from nano_pearl_tpu_torch.ops.attention import (
    paged_attention_grouped_ref,
    paged_attention_ref,
)
from nano_pearl_tpu_torch.ops.cuda import build
from nano_pearl_tpu_torch.ops.kv_cache import global_block_offsets

plain_decode = paged_attention_ref
plain_verify = paged_attention_grouped_ref

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SUPPORTED = (torch.bfloat16, torch.float32)


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    if not getattr(lib, "_npt_typed", False):
        common = [_I, _I, _I, _I, _I, _LL, _LL, _F, _I, _P]
        lib.npt_paged_decode.argtypes = [_P] * 7 + [_I] + common
        lib.npt_paged_verify.argtypes = [_P] * 7 + [_I, _I] + common
        lib.npt_paged_decode.restype = _I
        lib.npt_paged_verify.restype = _I
        lib.npt_chunk_tokens.restype = _I
        lib._npt_typed = True
    return lib


def _scratch(lib, rows: int, hq: int, d: int, m: int, bs: int, device):
    """f32 (acc, (m, l)) partials of every row, head and key chunk."""
    n_chunks = -(-m * bs // lib.npt_chunk_tokens())
    acc = torch.empty((rows, hq, n_chunks, d), dtype=torch.float32, device=device)
    ml = torch.empty((rows, hq, n_chunks, 2), dtype=torch.float32, device=device)
    return acc, ml


def _check_inputs(q, cache, block_tables, context_lens, n_tables: int, n_rows: int):
    """Validate what the kernel takes; returns (hq, hkv, d, bs, m)."""
    tensors = {"q": q, "cache": cache, "block_tables": block_tables, "context_lens": context_lens}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _SUPPORTED or cache.dtype != q.dtype:
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


def paged_decode(q, cache, layer_idx, block_tables, context_lens, scale):
    """K1: q [N, Hq, D] against its own block table row and context."""
    if q.device.type == "cpu":
        return plain_decode(q, cache, layer_idx, block_tables, context_lens, scale)
    n = q.shape[0]
    hq, hkv, d, bs, m = _check_inputs(q, cache, block_tables, context_lens, n, n)
    k_off, v_off = global_block_offsets(cache, layer_idx)
    out = torch.empty_like(q)
    lib = _lib()
    acc, ml = _scratch(lib, n, hq, d, m, bs, q.device)
    err = lib.npt_paged_decode(
        q.data_ptr(), cache.data_ptr(), block_tables.data_ptr(), context_lens.data_ptr(),
        out.data_ptr(), acc.data_ptr(), ml.data_ptr(), n, m, hq, hkv, d, bs, k_off, v_off, float(scale),
        int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, err, "paged_decode")
    paged_decode.launches += 1
    return out


def paged_verify(q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group):
    """K2: q [B*R, Hq, D]; the R rows of a group share its block table
    row and each has its own context length."""
    if q.device.type == "cpu":
        return plain_verify(
            q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group
        )
    r = int(rows_per_group)
    b = group_tables.shape[0]
    if r < 2:
        raise ValueError("paged_verify takes rows_per_group >= 2 (use paged_decode for 1)")
    hq, hkv, d, bs, m = _check_inputs(q, cache, group_tables, context_lens, b, b * r)
    k_off, v_off = global_block_offsets(cache, layer_idx)
    out = torch.empty_like(q)
    lib = _lib()
    acc, ml = _scratch(lib, b * r, hq, d, m, bs, q.device)
    err = lib.npt_paged_verify(
        q.data_ptr(), cache.data_ptr(), group_tables.data_ptr(), context_lens.data_ptr(),
        out.data_ptr(), acc.data_ptr(), ml.data_ptr(), b, r, m, hq, hkv, d, bs, k_off, v_off, float(scale),
        int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, err, "paged_verify")
    paged_verify.launches += 1
    return out


paged_decode.launches = 0
paged_verify.launches = 0
