"""Kernel K3 (causal prefill self-attention): wrapper of
``csrc/prefill_attention.cu``.

K3 ``prefill_self`` replaces ``_prefill_self_kernel`` (entry
``prefill_self_attention_pallas``) in
nano_pearl_tpu/ops/pallas/prefill_attention.py. Its plain version is
``prefill_self_attention_ref`` (ops/attention.py).

What bounds it on the H100: at prefill shapes (Lq = 128 rows per
sequence, D = 128) the unavoidable traffic (q, k, v read once, the
output written once) and the causal flops are both small; the kernel's
fixed cost per block dominates. The design answer: one block per
(16-row query tile, KV head, sequence) keeps the flash statistics of
its 16 * G query vectors in shared memory, stages 64-key tiles once per
block, and stops at the diagonal, so no score tile reaches device
memory and no key tile above the diagonal is read.

The wrapper takes the plain version for CPU tensors, launches the
kernel for CUDA tensors (counting the launch in ``.launches``), and
raises on anything else.
"""

from __future__ import annotations

import ctypes

import torch

from nano_pearl_tpu_torch.ops.attention import prefill_self_attention_ref
from nano_pearl_tpu_torch.ops.cuda import build

plain_prefill = prefill_self_attention_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = build.load("prefill_attention")
    if not getattr(lib, "_npt_typed", False):
        lib.npt_prefill_self.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P]
        lib.npt_prefill_self.restype = _I
        lib._npt_typed = True
    return lib


def prefill_self(q, k, v, q_positions, scale):
    """K3: q [B*Lq, Hq, D], k/v [B*Lq, Hkv, D], q_positions [B, Lq] int32
    (-1 = padded row) -> [B*Lq, Hq, D]."""
    if q.device.type == "cpu":
        return plain_prefill(q, k, v, q_positions, scale)
    for name, t in {"q": q, "k": k, "v": v, "q_positions": q_positions}.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes must match and be bf16 or f32: {q.dtype}, {k.dtype}, {v.dtype}")
    if q_positions.dtype != torch.int32 or q_positions.ndim != 2:
        raise ValueError("q_positions must be int32 [B, Lq]")
    b, lq = q_positions.shape
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape:
        raise ValueError(f"q/k/v must be [N, H, D]: {q.shape}, {k.shape}, {v.shape}")
    n, hq, d = q.shape
    hkv = k.shape[1]
    if d not in (64, 128):
        raise ValueError(f"head_dim {d} not supported (64 or 128)")
    if n != b * lq or k.shape[0] != n or k.shape[2] != d or hq % hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, B={b}, Lq={lq}")
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


prefill_self.launches = 0
