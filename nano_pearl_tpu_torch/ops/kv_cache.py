"""Paged KV cache storage (counterpart of nano_pearl_tpu/ops/kv_cache.py).

Layout, as in the JAX package: one tensor per model,
``[L, 2, num_blocks + 1, block_size, n_kv_heads * head_dim]``, with the
head and head-dim axes folded into one trailing axis; head ``h``'s K/V
are the columns ``[h*D, (h+1)*D)``. The last block (index
``num_blocks``) is the garbage block: padded rows write there instead of
being skipped.

Unlike the JAX package, ``write_kv`` updates the cache in place (one
``index_copy_`` per layer, no copy of the cache) and returns it.
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


def garbage_slots(num_blocks: int, block_size: int, n: int, device=None) -> torch.Tensor:
    """Distinct slots inside the garbage block for n padded rows."""
    base = num_blocks * block_size
    return base + torch.arange(n, dtype=torch.int32, device=device) % block_size
