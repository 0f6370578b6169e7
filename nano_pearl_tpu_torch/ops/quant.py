"""Weight-only int8/fp8 quantization (counterpart of
nano_pearl_tpu/ops/quant.py).

Scheme, as in the JAX package: symmetric, per output channel, 1-byte
storage. A quantized weight is a dict ``{"q": int8 | float8_e4m3fn, "s":
float32}`` whose scale ``s`` keeps the weight's shape with the
contraction axis reduced to 1 (``[L, 1, out]`` for stacked ``[L, in,
out]`` weights, ``[L, E, 1, out]`` for stacked MoE experts ``[L, E, in,
out]``, ``[V, 1]`` for the ``[out, in]`` LM head), and every
product goes through ``mm`` / ``mm_t``: ``(x @ q.to(x.dtype)) * s``, the
reference's order of operations (not ``x @ (q * s)``). The product is a
plain matrix product of the 1-byte weight cast to ``x``'s type, as the
JAX package leaves it to XLA (no fused dequantizing GEMM yet).
"""

from __future__ import annotations

import torch

# keys quantized when ModelConfig.quant is set (an MoE model's expert
# stacks under the MLP's keys; its router stays plain); their output
# channel is the LAST axis (weights stored [in, out])
QUANTIZED_LAYER_KEYS = ("wq", "wk", "wv", "wo", "wgate", "wup", "wdown")

FP8_DTYPE = torch.float8_e4m3fn
FP8_MAX = 448.0  # largest finite e4m3fn value
WEIGHT_QUANT_KINDS = ("int8", "fp8")


def quantize_int8(w: torch.Tensor, contract_axis: int = -2) -> dict:
    """q = round(w / s) clipped to +-127 (round half to even, as
    ``jnp.round``), s = max(amax, 1e-8) / 127 with amax over the
    contraction axis only."""
    wf = w.float()
    amax = wf.abs().amax(dim=contract_axis, keepdim=True)
    s = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def quantize_fp8(w: torch.Tensor, contract_axis: int = -2) -> dict:
    """q = w / s in e4m3 (clipped to +-448 before the cast, as JAX), s =
    max(amax, 1e-8) / 448."""
    wf = w.float()
    amax = wf.abs().amax(dim=contract_axis, keepdim=True)
    s = torch.clamp(amax, min=1e-8) / FP8_MAX
    q = torch.clamp(wf / s, -FP8_MAX, FP8_MAX).to(FP8_DTYPE)
    return {"q": q, "s": s}


def quantize_weight(w: torch.Tensor, kind: str, contract_axis: int = -2) -> dict:
    if kind == "int8":
        return quantize_int8(w, contract_axis)
    if kind == "fp8":
        return quantize_fp8(w, contract_axis)
    raise ValueError(f"unknown weight quantization kind {kind!r}")


def quant_storage_dtype(kind: str) -> torch.dtype:
    if kind not in WEIGHT_QUANT_KINDS:
        raise ValueError(f"unknown quantization kind {kind!r}")
    return torch.int8 if kind == "int8" else FP8_DTYPE


def dequantize(w: dict, dtype=torch.bfloat16) -> torch.Tensor:
    return (w["q"].float() * w["s"]).to(dtype)


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def layer_weight(w, li: int):
    """Layer ``li`` of a stacked weight, plain or quantized."""
    if is_quantized(w):
        return {"q": w["q"][li], "s": w["s"][li]}
    return w[li]


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a plain or quantized weight stored [in, out]."""
    if is_quantized(w):
        return (x @ w["q"].to(x.dtype)) * w["s"].reshape(w["s"].shape[-1]).to(x.dtype)
    return x @ w


def mm_t(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w.T for a plain or quantized weight stored [out, in] (the LM
    head; its output channel is axis 0)."""
    if is_quantized(w):
        return (x @ w["q"].to(x.dtype).T) * w["s"].reshape(w["s"].shape[0]).to(x.dtype)
    return x @ w.T
