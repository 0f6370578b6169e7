"""Paged KV cache storage (counterpart of nano_pearl_tpu/ops/kv_cache.py).

Layout, as in the JAX package: one tensor per model,
``[L, 2, num_blocks + 1, block_size, n_kv_heads * head_dim]``, with the
head and head-dim axes folded into one trailing axis; head ``h``'s K/V
are the columns ``[h*D, (h+1)*D)``. The last block (index
``num_blocks``) is the garbage block: padded rows write there instead of
being skipped.

Unlike the JAX package, ``write_kv`` updates the cache in place (one
``index_copy_`` per layer, no copy of the cache) and returns it, and so
does the deferred verify's whole-round writeback ``write_fresh`` (kernel
K12 on the card, ``write_fresh_ref`` on the CPU).
"""

from __future__ import annotations

import torch

_CACHE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_kv_cache(
    num_layers: int,
    num_blocks: int,
    block_size: int,
    n_kv_heads: int,
    head_dim: int,
    dtype=torch.bfloat16,
    device=None,
) -> torch.Tensor:
    """Zeroed paged cache with the +1 garbage block at index ``num_blocks``.
    bf16 and f32 only (the quantised layouts are not ported yet)."""
    if isinstance(dtype, str):
        dtype = _CACHE_DTYPES.get(dtype, dtype)
    if dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"KV cache dtype {dtype} is not supported by the port")
    shape = (num_layers, 2, num_blocks + 1, block_size, n_kv_heads * head_dim)
    return torch.zeros(shape, dtype=dtype, device=device)


def global_block_offsets(cache: torch.Tensor, layer_idx: int) -> tuple[int, int]:
    """(k_off, v_off): block-index offsets of layer ``layer_idx`` in the
    cache viewed as ``[L * 2 * (NB + 1), BS, Hkv * D]``."""
    nb1 = cache.shape[2]
    k_off = (layer_idx * 2) * nb1
    return k_off, k_off + nb1


def write_kv(
    cache: torch.Tensor,  # [L, 2, NB+1, BS, Hkv*D]
    k: torch.Tensor,  # [N, Hkv, D]
    v: torch.Tensor,  # [N, Hkv, D]
    slots: torch.Tensor,  # [N] int flat slot = block_id * BS + offset
    layer_idx: int,
) -> torch.Tensor:
    """Store new K/V rows at their flat slots, in place. Padded rows carry
    slots inside the garbage block; several may share one garbage slot,
    whose content is never read unmasked."""
    n = k.shape[0]
    hd = cache.shape[-1]
    bs = cache.shape[3]
    k_off, v_off = global_block_offsets(cache, layer_idx)
    slots = slots.long()
    idx = torch.cat([k_off * bs + slots, v_off * bs + slots])
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
