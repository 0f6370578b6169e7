"""Paged KV cache storage (counterpart of nano_pearl_tpu/ops/kv_cache.py).

Layout, as in the JAX package: one tensor per model,
``[L, 2, num_blocks + 1, block_size, n_kv_heads * head_dim]``, with the
head and head-dim axes folded into one trailing axis; head ``h``'s K/V
are the columns ``[h*D, (h+1)*D)``. The last block (index
``num_blocks``) is the garbage block: padded rows write there instead of
being skipped.

A quantized cache (``make_kv_cache(..., quant="int8" | "fp8")``) is a
``QuantKVCache``: the 1-byte values ``q`` in the same folded layout and
one bf16 scale per (slot, KV head) in ``s``, ``[L, 2, NB+1, BS, Hkv]``.
The JAX package strides its scales ``[..., Hkv * stride]`` to fill the
TPU's 128-lane tile (``kv_scale_stride``); Hopper has no such rule, so
the scales are stored compactly and the cache takes ``Hkv * (D + 2)``
bytes per slot, about half the bf16 cache's ``Hkv * D * 2``.

Unlike the JAX package, ``write_kv`` updates the cache in place (one
``index_copy_`` per layer, no copy of the cache) and returns it, and so
does the deferred verify's whole-round writeback ``write_fresh`` (kernel
K12 on the card, ``write_fresh_ref`` on the CPU).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nano_pearl_tpu_torch.ops.quant import FP8_MAX, quant_storage_dtype

_CACHE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class QuantKVCache(NamedTuple):
    """A 1-byte paged cache: ``q`` int8 or float8_e4m3fn [L, 2, NB+1, BS,
    Hkv*D] and ``s`` bf16 [L, 2, NB+1, BS, Hkv]; head ``h``'s value at a
    slot is ``float(q[..., h*D + c]) * float(s[..., h])``."""

    q: torch.Tensor
    s: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.ndim


def make_kv_cache(
    num_layers: int,
    num_blocks: int,
    block_size: int,
    n_kv_heads: int,
    head_dim: int,
    dtype=torch.bfloat16,
    device=None,
    quant: str | None = None,
):
    """Zeroed paged cache with the +1 garbage block at index ``num_blocks``:
    a bf16 or f32 tensor, or with ``quant`` ("int8" or "fp8") a
    ``QuantKVCache``."""
    shape = (num_layers, 2, num_blocks + 1, block_size, n_kv_heads * head_dim)
    if quant is not None:
        q = torch.zeros(shape, dtype=quant_storage_dtype(quant), device=device)
        s = torch.zeros(shape[:-1] + (n_kv_heads,), dtype=torch.bfloat16, device=device)
        return QuantKVCache(q, s)
    if isinstance(dtype, str):
        dtype = _CACHE_DTYPES.get(dtype, dtype)
    if dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"KV cache dtype {dtype} is not supported by the port")
    return torch.zeros(shape, dtype=dtype, device=device)


def cache_is_quantized(cache) -> bool:
    return isinstance(cache, QuantKVCache)


def cache_nbytes(cache) -> int:
    parts = (cache.q, cache.s) if cache_is_quantized(cache) else (cache,)
    return sum(t.numel() * t.element_size() for t in parts)


def dequant_rows(q_rows: torch.Tensor, s_rows: torch.Tensor, head_dim: int) -> torch.Tensor:
    """1-byte rows [..., Hkv*D] times their scales [..., Hkv] -> f32
    [..., Hkv, D] (``dequant_rows`` of the JAX package, compact scales)."""
    hkv = q_rows.shape[-1] // head_dim
    unfolded = q_rows.reshape(q_rows.shape[:-1] + (hkv, head_dim))
    return unfolded.float() * s_rows.float()[..., None]


def global_block_offsets(cache, layer_idx: int) -> tuple[int, int]:
    """(k_off, v_off): block-index offsets of layer ``layer_idx`` in the
    cache viewed as ``[L * 2 * (NB + 1), BS, Hkv * D]`` (either kind)."""
    nb1 = cache.shape[2]
    k_off = (layer_idx * 2) * nb1
    return k_off, k_off + nb1


def _quantize_rows(x: torch.Tensor, qdtype: torch.dtype):
    """Rows [N, Hkv, D] -> (1-byte values [N, Hkv*D], bf16 scales [N, Hkv]):
    amax per (row, head), scale = max(amax, 1e-8) / qmax rounded to bf16
    FIRST, then the values quantized with the rounded scale, so the stored
    values and scale are exact for each other (``write_kv`` of the JAX
    package)."""
    n = x.shape[0]
    xf = x.float()
    qmax = 127.0 if qdtype == torch.int8 else FP8_MAX
    s = (torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / qmax).to(torch.bfloat16)
    y = xf / s.float()[..., None]
    if qdtype == torch.int8:
        q = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    else:
        q = torch.clamp(y, -FP8_MAX, FP8_MAX).to(qdtype)
    return q.reshape(n, -1), s


def write_kv(
    cache,  # [L, 2, NB+1, BS, Hkv*D] tensor or QuantKVCache
    k: torch.Tensor,  # [N, Hkv, D]
    v: torch.Tensor,  # [N, Hkv, D]
    slots: torch.Tensor,  # [N] int flat slot = block_id * BS + offset
    layer_idx: int,
):
    """Store new K/V rows at their flat slots, in place; a quantized cache
    stores them quantized per (row, head). Padded rows carry slots inside
    the garbage block; several may share one garbage slot, whose content
    is never read unmasked."""
    n = k.shape[0]
    hd = cache.shape[-1]
    bs = cache.shape[3]
    k_off, v_off = global_block_offsets(cache, layer_idx)
    slots = slots.long()
    idx = torch.cat([k_off * bs + slots, v_off * bs + slots])
    if cache_is_quantized(cache):
        vals, scales = _quantize_rows(torch.cat([k, v]), cache.q.dtype)
        # a byte copy through uint8 views: index_copy_ of every 1-byte type
        cache.q.view(torch.uint8).view(-1, hd).index_copy_(0, idx, vals.view(torch.uint8))
        cache.s.view(-1, cache.s.shape[-1]).index_copy_(0, idx, scales)
        return cache
    vals = torch.cat([k.reshape(n, hd), v.reshape(n, hd)]).to(cache.dtype)
    cache.view(-1, hd).index_copy_(0, idx, vals)
    return cache


def write_fresh_ref(
    cache: torch.Tensor,  # [L, 2, NB+1, BS, Hkv*D]
    fresh: torch.Tensor,  # [L, 2, N, Hkv*D] one round's K/V of every layer
    slots: torch.Tensor,  # [N] int flat slot per row
) -> torch.Tensor:
    """Store a round's fresh K/V of every layer at their flat slots, in
    place: the semantics of ``write_fresh_jnp`` (L x 2 row scatters in one).
    Where several rows name one slot (padding rows in the garbage block)
    the last row wins, as a scatter applied in row order leaves it. Slots
    outside ``[0, (NB+1)*BS)`` are dropped."""
    l, two, nb1, bs, hd = cache.shape
    n = slots.shape[0]
    s = slots.long()
    later = torch.arange(n, device=s.device)
    dup = ((s[None, :] == s[:, None]) & (later[None, :] > later[:, None])).any(dim=1)
    keep = ~dup & (s >= 0) & (s < nb1 * bs)
    rows = cache.view(l * two, nb1 * bs, hd)
    rows[:, s[keep]] = fresh.reshape(l * two, n, hd)[:, keep].to(cache.dtype)
    return cache


def write_fresh(cache: torch.Tensor, fresh: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """The deferred verify's writeback: kernel K12 on the card, the plain
    version on the CPU. Updates ``cache`` in place and returns it."""
    from nano_pearl_tpu_torch.ops.cuda.kv_writeback import write_fresh_kernel

    return write_fresh_kernel(cache, fresh, slots)


def garbage_slots(num_blocks: int, block_size: int, n: int, device=None) -> torch.Tensor:
    """Distinct slots inside the garbage block for n padded rows."""
    base = num_blocks * block_size
    return base + torch.arange(n, dtype=torch.int32, device=device) % block_size
