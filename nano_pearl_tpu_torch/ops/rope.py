"""Rotary position embeddings (counterpart of nano_pearl_tpu/ops/rope.py).

Neox-style half-split rotation computed in f32 from a precomputed
``[max_position, head_dim]`` table (first half cos, second half sin)
gathered by position. Supports the "llama3" and "linear" rope scalings.
"""

from __future__ import annotations

import math

import torch


def _scale_inv_freq(inv_freq: torch.Tensor, scaling: dict) -> torch.Tensor:
    """Frequency-domain rope scaling: "llama3" (Llama 3.1+, as
    transformers' ROPE_INIT_FUNCTIONS["llama3"]) and "linear"."""
    kind = scaling.get("rope_type", scaling.get("type"))
    factor = float(scaling["factor"])
    if kind == "linear":
        return inv_freq / factor
    if kind == "llama3":
        low = float(scaling["low_freq_factor"])
        high = float(scaling["high_freq_factor"])
        old_len = float(scaling["original_max_position_embeddings"])
        wavelen = 2.0 * math.pi / inv_freq
        smooth = (old_len / wavelen - low) / (high - low)
        smoothed = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        return torch.where(
            wavelen < old_len / high,  # high-frequency: keep
            inv_freq,
            torch.where(wavelen > old_len / low, inv_freq / factor, smoothed),
        )
    raise NotImplementedError(f"rope_scaling type {kind!r} not supported")


def build_rope_table(
    head_dim: int,
    max_position: int,
    base: float,
    rope_scaling: dict | None = None,
    device=None,
) -> torch.Tensor:
    """[max_position, head_dim] f32 table: first half cos, second half sin."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (base**exps)
    if rope_scaling:
        inv_freq = _scale_inv_freq(inv_freq, rope_scaling)
    t = torch.arange(max_position, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)  # [max_pos, head_dim // 2]
    return torch.cat([torch.cos(freqs), torch.sin(freqs)], dim=-1)


def apply_rope(x: torch.Tensor, rope_rows: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` [N, heads, head_dim] by per-row table entries
    ``rope_rows`` [N, head_dim]; f32 math, result in ``x``'s dtype."""
    half = x.shape[-1] // 2
    cos = rope_rows[:, None, :half]
    sin = rope_rows[:, None, half:]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)
