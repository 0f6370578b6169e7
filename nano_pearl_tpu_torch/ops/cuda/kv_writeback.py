"""Kernel K12 (the deferred verify's whole-round KV writeback): wrapper of
``csrc/kv_writeback.cu``.

``write_fresh_kernel`` replaces ``_kernel`` (entry ``write_fresh_pallas``)
of nano_pearl_tpu/ops/pallas/kv_writeback.py. Its plain version is
``write_fresh_ref`` (ops/kv_cache.py), the semantics of
``write_fresh_jnp``.

What bounds it on the H100: bytes, each fresh row read once and written
once. The design answer: one block per row copies the row's L x 2 planes
with 16-byte loads and stores; a row whose slot a later row also names
skips its store, so the last row wins without any ordering between blocks.

The wrapper takes the plain version for CPU tensors, launches the kernel
for CUDA tensors (counting the launch in ``.launches``), and raises on
anything else.
"""

from __future__ import annotations

import ctypes

import torch

from nano_pearl_tpu_torch.ops.cuda import build
from nano_pearl_tpu_torch.ops.kv_cache import write_fresh_ref

plain_write_fresh = write_fresh_ref

_SUPPORTED = (torch.bfloat16, torch.float32)


def _lib() -> ctypes.CDLL:
    lib = build.load("kv_writeback")
    if not getattr(lib, "_npt_typed", False):
        lib.npt_write_fresh.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.npt_write_fresh.restype = ctypes.c_int
        lib._npt_typed = True
    return lib


def write_fresh_kernel(cache, fresh, slots):
    """K12: ``fresh`` [L, 2, N, Hkv*D] into ``cache`` [L, 2, NB+1, BS,
    Hkv*D] at flat ``slots`` [N] int32, in place; returns ``cache``."""
    if cache.device.type == "cpu":
        return plain_write_fresh(cache, fresh, slots)
    for name, t in {"cache": cache, "fresh": fresh, "slots": slots}.items():
        if t.device != cache.device:
            raise ValueError(f"{name} must be on the cache's CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cache.dtype not in _SUPPORTED or fresh.dtype != cache.dtype:
        raise ValueError(f"cache/fresh dtype must match and be bf16 or f32: {cache.dtype}, {fresh.dtype}")
    if slots.dtype != torch.int32 or slots.ndim != 1:
        raise ValueError("slots must be a 1-d int32 tensor")
    if cache.ndim != 5 or cache.shape[1] != 2:
        raise ValueError(f"cache must be [L, 2, NB+1, BS, Hkv*D]: {tuple(cache.shape)}")
    l, _, nb1, bs, hd = cache.shape
    n = slots.shape[0]
    if fresh.shape != (l, 2, n, hd) or n == 0:
        raise ValueError(f"fresh {tuple(fresh.shape)} != ({l}, 2, {n}, {hd}), n >= 1")
    row_bytes = hd * cache.element_size()
    if row_bytes % 16 or cache.data_ptr() % 16 or fresh.data_ptr() % 16:
        raise ValueError("rows must be whole 16-byte vectors, 16-byte aligned")
    lib = _lib()
    err = lib.npt_write_fresh(
        fresh.data_ptr(), cache.data_ptr(), slots.data_ptr(), n, 2 * l, nb1 * bs, row_bytes,
        torch.cuda.current_stream(cache.device).cuda_stream,
    )
    build.check(lib, err, "write_fresh")
    write_fresh_kernel.launches += 1
    return cache


write_fresh_kernel.launches = 0
