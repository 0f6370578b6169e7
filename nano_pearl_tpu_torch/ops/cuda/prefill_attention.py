"""Kernels K3 (causal prefill self-attention) and K4 (prefill over a
cached prefix): wrappers of ``csrc/prefill_attention.cu``.

K3 ``prefill_self`` replaces ``_prefill_self_kernel`` (entry
``prefill_self_attention_pallas``) and K4 ``prefill_prefix`` replaces
``_prefill_prefix_kernel`` (entry ``prefill_prefix_attention_pallas``),
both in nano_pearl_tpu/ops/pallas/prefill_attention.py. Their plain
versions are ``prefill_self_attention_ref`` and
``prefill_prefix_attention_ref`` (ops/attention.py).

What bounds them on the H100: at prefill shapes (K3: Lq = 128 rows per
sequence, D = 128; K4: 64 new rows over a 512-token prefix) the
unavoidable traffic (q, the fresh k/v and K4's cached prefix read once,
the output written once) and the flops are both small; the kernels'
fixed cost per block dominates. The design answer: one block per
(16-row query tile, KV head, sequence) keeps the flash statistics of
its 16 * G query vectors in shared memory, stages 64-key tiles once per
block (K4 first walks the prefix pages through the block table), and
stops at the diagonal, so no score tile reaches device memory and no
key tile above the diagonal is read.

Each wrapper takes the plain version for CPU tensors, launches the
kernel for CUDA tensors (counting the launch in ``.launches``), and
raises on anything else.
"""

from __future__ import annotations

import ctypes

import torch

from nano_pearl_tpu_torch.ops.attention import (
    check_head_dim,
    prefill_prefix_attention_ref,
    prefill_self_attention_ref,
)
from nano_pearl_tpu_torch.ops.cuda import build
from nano_pearl_tpu_torch.ops.kv_cache import global_block_offsets

plain_prefill = prefill_self_attention_ref
plain_prefix = prefill_prefix_attention_ref

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = build.load("prefill_attention")
    if not getattr(lib, "_npt_typed", False):
        lib.npt_prefill_self.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P]
        lib.npt_prefill_self.restype = _I
        lib.npt_prefill_prefix.argtypes = (
            [_P] * 8 + [_I] * 7 + [_LL, _LL, _F, _I, _P]
        )
        lib.npt_prefill_prefix.restype = _I
        lib._npt_typed = True
    return lib


def _check_fresh(q, k, v, extra: dict):
    """Validate q/k/v [N, H, D] and the int32 ``extra`` tensors on q's
    CUDA device; returns (n, hq, hkv, d)."""
    for name, t in {"q": q, "k": k, "v": v, **extra}.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in extra and t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes must match and be bf16 or f32: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape:
        raise ValueError(f"q/k/v must be [N, H, D]: {q.shape}, {k.shape}, {v.shape}")
    n, hq, d = q.shape
    hkv = k.shape[1]
    check_head_dim(d)
    if k.shape[0] != n or k.shape[2] != d or hq % hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}")
    return n, hq, hkv, d


def prefill_self(q, k, v, q_positions, scale):
    """K3: q [B*Lq, Hq, D], k/v [B*Lq, Hkv, D], q_positions [B, Lq] int32
    (-1 = padded row) -> [B*Lq, Hq, D]."""
    if q.device.type == "cpu":
        return plain_prefill(q, k, v, q_positions, scale)
    n, hq, hkv, d = _check_fresh(q, k, v, {"q_positions": q_positions})
    if q_positions.ndim != 2 or n != q_positions.numel():
        raise ValueError(f"q_positions {tuple(q_positions.shape)} must be [B, Lq] with B * Lq = {n}")
    b, lq = q_positions.shape
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.npt_prefill_self(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(), out.data_ptr(),
        b, lq, hq, hkv, d, float(scale), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, err, "prefill_self")
    prefill_self.launches += 1
    return out


def prefill_prefix(q, k, v, cache, layer_idx, bt_pre, num_cached, n_new, scale):
    """K4: q [B*Lq, Hq, D] and fresh k/v [B*Lq, Hkv, D]; row i of sequence
    b sits at position num_cached[b] + i, is real iff i < n_new[b], and
    attends to the cached prefix (through bt_pre [B, Mpre]) and the fresh
    keys j <= i; padded rows give 0."""
    if q.device.type == "cpu":
        return plain_prefix(q, k, v, cache, layer_idx, bt_pre, num_cached, n_new, scale)
    n, hq, hkv, d = _check_fresh(
        q, k, v, {"bt_pre": bt_pre, "num_cached": num_cached, "n_new": n_new}
    )
    if cache.device != q.device or not cache.is_contiguous() or cache.dtype != q.dtype:
        raise ValueError(f"cache must be a contiguous {q.dtype} tensor on q's device")
    if cache.ndim != 5 or cache.shape[1] != 2 or cache.shape[-1] != hkv * d:
        raise ValueError(f"cache shape {tuple(cache.shape)} does not fold {hkv} x {d}")
    if bt_pre.ndim != 2 or bt_pre.shape[1] < 1:
        raise ValueError(f"bt_pre must be [B, Mpre >= 1], got {tuple(bt_pre.shape)}")
    b, mpre = bt_pre.shape
    if num_cached.shape != (b,) or n_new.shape != (b,) or n % b:
        raise ValueError(f"num_cached/n_new must be [{b}] and q rows a multiple of {b}")
    bs = cache.shape[3]
    k_off, v_off = global_block_offsets(cache, layer_idx)
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.npt_prefill_prefix(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cache.data_ptr(), bt_pre.data_ptr(),
        num_cached.data_ptr(), n_new.data_ptr(), out.data_ptr(), b, n // b, mpre, hq, hkv, d,
        bs, k_off, v_off, float(scale), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, err, "prefill_prefix")
    prefill_prefix.launches += 1
    return out


prefill_self.launches = 0
prefill_prefix.launches = 0
