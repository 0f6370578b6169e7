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

Under sequence parallelism a model's cache is a ``ShardedKVCache``
(``make_sharded_kv_cache``, the block-axis sharding of the JAX package's
``parallel/sp.py`` ``_cache_spec``): ``sp`` shards, each a cache of
either kind of ``(NB + 1) / sp`` blocks, shard ``s`` owning the global
block ids ``[s * nb1_local, (s + 1) * nb1_local)`` (the garbage block NB
lands in the last shard). Each shard's rows sit in a flat buffer with one
more row, a sink that ``parallel/sp.sp_write_kv`` sends the rows of the
other shards to (the JAX package's always-out-of-bounds ``mode="drop"``
index); no kernel reads it.

Under tensor parallelism a model's cache is a ``TPKVCache``: one cache of
either kind per rank, on the rank's device, holding the rank's
``Hkv / tp`` KV heads (the JAX package shards the folded head axis over
``tp``, and a quantized cache's scales by head, as its
``kv_scale_stride`` does): ``[L, 2, NB+1, BS, (Hkv / tp) * D]``.
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


class ShardedKVCache(NamedTuple):
    """A paged cache whose block axis is sharded over ``sp`` shards:
    ``shards[s]`` is shard s's cache ``[L, 2, nb1_local, BS, Hkv*D]`` (a
    tensor or a ``QuantKVCache``), a view of the first rows of
    ``flats[s]`` (``[L * 2 * nb1_local * BS + 1, Hkv*D]``, or a
    ``QuantKVCache`` of such values and ``[..., Hkv]`` scales) whose last
    row is the sink of writes that belong to other shards."""

    shards: tuple
    flats: tuple

    @property
    def sp_size(self) -> int:
        return len(self.shards)

    @property
    def nb1_local(self) -> int:
        return self.shards[0].shape[2]

    @property
    def shape(self) -> torch.Size:
        """The global cache's shape, [L, 2, NB+1, BS, Hkv*D]."""
        l, two, nb1, bs, hd = self.shards[0].shape
        return torch.Size((l, two, nb1 * self.sp_size, bs, hd))


class TPKVCache(NamedTuple):
    """A paged cache whose KV heads are split over tensor-parallel ranks:
    ``ranks[r]`` is rank r's cache (a tensor or a ``QuantKVCache``) of its
    ``Hkv / tp`` heads, on its device."""

    ranks: tuple

    @property
    def tp_size(self) -> int:
        return len(self.ranks)

    @property
    def shape(self) -> torch.Size:
        """The whole cache's shape, [L, 2, NB+1, BS, Hkv*D]."""
        l, two, nb1, bs, hd = self.ranks[0].shape
        return torch.Size((l, two, nb1, bs, hd * self.tp_size))


def split_kv_heads(cache, tp: int, devices=None) -> TPKVCache:
    """A copy of ``cache``'s KV heads split over ``tp`` ranks (rank r's on
    ``devices[r]``, default: the cache's device): values by columns of the
    folded head axis, a quantized cache's scales by head."""
    devices = list(devices) if devices is not None else [None] * tp

    def part(t, r):
        c = torch.chunk(t, tp, dim=-1)[r]
        return (c if devices[r] is None else c.to(devices[r])).contiguous()

    if cache_is_quantized(cache):
        return TPKVCache(tuple(QuantKVCache(part(cache.q, r), part(cache.s, r)) for r in range(tp)))
    return TPKVCache(tuple(part(cache, r) for r in range(tp)))


def make_sharded_kv_cache(
    num_layers: int,
    num_blocks: int,
    block_size: int,
    n_kv_heads: int,
    head_dim: int,
    sp: int,
    dtype=torch.bfloat16,
    device=None,
    quant: str | None = None,
) -> ShardedKVCache:
    """``make_kv_cache``'s ``num_blocks + 1`` blocks split over ``sp``
    shards on ``device`` (one device, or a list with one per shard); the
    block count plus the garbage block must divide by ``sp``."""
    if (num_blocks + 1) % sp:
        raise ValueError(f"num_blocks + 1 = {num_blocks + 1} does not divide over sp = {sp}")
    devices = device if isinstance(device, (list, tuple)) else [device] * sp
    nb1 = (num_blocks + 1) // sp
    hd = n_kv_heads * head_dim
    rows = num_layers * 2 * nb1 * block_size
    shape = (num_layers, 2, nb1, block_size, hd)
    if isinstance(dtype, str):
        dtype = _CACHE_DTYPES.get(dtype, dtype)
    shards, flats = [], []
    for dev in devices:
        if quant is not None:
            q = torch.zeros((rows + 1, hd), dtype=quant_storage_dtype(quant), device=dev)
            sc = torch.zeros((rows + 1, n_kv_heads), dtype=torch.bfloat16, device=dev)
            flats.append(QuantKVCache(q, sc))
            shards.append(QuantKVCache(q[:rows].view(shape), sc[:rows].view(shape[:-1] + (n_kv_heads,))))
        else:
            if dtype not in (torch.bfloat16, torch.float32):
                raise NotImplementedError(f"KV cache dtype {dtype} is not supported by the port")
            flat = torch.zeros((rows + 1, hd), dtype=dtype, device=dev)
            flats.append(flat)
            shards.append(flat[:rows].view(shape))
    return ShardedKVCache(tuple(shards), tuple(flats))


def cache_is_quantized(cache) -> bool:
    if isinstance(cache, ShardedKVCache):
        return cache_is_quantized(cache.shards[0])
    if isinstance(cache, TPKVCache):
        return cache_is_quantized(cache.ranks[0])
    return isinstance(cache, QuantKVCache)


def cache_nbytes(cache) -> int:
    """Bytes the cache's tensors take (a sharded cache's flat buffers, sink
    rows included; every tensor-parallel rank's cache)."""
    if isinstance(cache, ShardedKVCache):
        return sum(cache_nbytes(f) for f in cache.flats)
    if isinstance(cache, TPKVCache):
        return sum(cache_nbytes(c) for c in cache.ranks)
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
    bs = cache.shape[3]
    k_off, v_off = global_block_offsets(cache, layer_idx)
    slots = slots.long()
    idx = torch.cat([k_off * bs + slots, v_off * bs + slots])
    if cache_is_quantized(cache):
        hd = cache.shape[-1]
        flat = QuantKVCache(cache.q.view(-1, hd), cache.s.view(-1, cache.s.shape[-1]))
    else:
        flat = cache.view(-1, cache.shape[-1])
    store_rows(flat, kv_rows(flat, k, v), idx)
    return cache


def kv_rows(flat, k: torch.Tensor, v: torch.Tensor):
    """The stored form of K/V rows [N, Hkv, D] for a cache of ``flat``'s
    kind: [2N, Hkv*D] in its dtype (the N K rows, then the N V rows), or
    for a quantized cache the pair (1-byte values [2N, Hkv*D], bf16 scales
    [2N, Hkv])."""
    if cache_is_quantized(flat):
        return _quantize_rows(torch.cat([k, v]), flat.q.dtype)
    n, hd = k.shape[0], flat.shape[-1]
    return torch.cat([k.reshape(n, hd), v.reshape(n, hd)]).to(flat.dtype)


def store_rows(flat, rows, idx: torch.Tensor) -> None:
    """Copy ``kv_rows``' output to the rows ``idx`` [2N] of a cache viewed
    flat (``[R, Hkv*D]``, or a ``QuantKVCache`` of ``[R, Hkv*D]`` values and
    ``[R, Hkv]`` scales), in place."""
    if cache_is_quantized(flat):
        vals, scales = rows
        # a byte copy through uint8 views: index_copy_ of every 1-byte type
        flat.q.view(torch.uint8).index_copy_(0, idx, vals.view(torch.uint8))
        flat.s.index_copy_(0, idx, scales)
    else:
        flat.index_copy_(0, idx, rows)


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
