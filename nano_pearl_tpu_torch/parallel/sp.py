"""Sequence (context) parallelism: the KV cache sharded over blocks
(counterpart of nano_pearl_tpu/parallel/sp.py).

A group of ``sp`` shards holds the paged cache's block axis split into
contiguous ranges (``ops/kv_cache.ShardedKVCache``: shard s owns the
global block ids ``[s * nb1_local, (s + 1) * nb1_local)``); every other
layer of the model is unchanged (weights are not sharded). The JAX
package runs each shard on its own device inside ``jax.shard_map`` and
merges with ``pmax``/``psum``; the port runs an in-process sp group (see
``parallel/mesh.py``): one kernel launch per shard, then the same merge
as torch ops in a fixed shard order, shard 0 first.

- writes: each shard localizes the global flat slots to its block range
  and sends the other shards' rows to its sink row (``sp_write_kv``);
- decode and packed-verify reads: each shard's flash partials (o, m, l)
  over its own blocks, the other shards' table slots skipped (kernels
  K11a / K11c, K11b / K11d over a quantized shard; their plain versions
  on the CPU), merged by ``merge_partials``;
- prefill over cached prefixes: ``sp_prefill_attention``, torch ops on
  every device, as the JAX package's jnp path (it has no kernel there).
  A fresh batch prefills through K3, which reads no cache.
"""

from __future__ import annotations

import torch

from nano_pearl_tpu_torch.ops.attention import NEG_INF, _gather_kv
from nano_pearl_tpu_torch.ops.kv_cache import (
    ShardedKVCache,
    cache_is_quantized,
    global_block_offsets,
    kv_rows,
    store_rows,
)


def shard_tables(tables: torch.Tensor, cache: ShardedKVCache) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """(local ids, is_local) of global block tables [..., M] for each
    shard: ids localized to the shard and clamped into ``[0, nb1_local -
    1]``, is_local int32 1 where the id is the shard's (``_local_kv`` of
    the JAX package). The JAX package's ``_dma_friendly_local_tables``
    also repeats the previous local id in a non-local slot, only to spare
    the TPU pipeline a copy; the port's kernels never read a non-local
    slot, so plain clamping gives the same result. Computed once per
    forward and reused by every layer."""
    nb1 = cache.nb1_local
    out = []
    for s in range(cache.sp_size):
        base = s * nb1
        is_local = ((tables >= base) & (tables < base + nb1)).to(torch.int32)
        out.append((torch.clamp(tables - base, 0, nb1 - 1).to(torch.int32).contiguous(), is_local))
    return out


def sp_write_kv(cache: ShardedKVCache, k: torch.Tensor, v: torch.Tensor, slots: torch.Tensor, layer_idx: int):
    """``ops/kv_cache.write_kv`` over a block-sharded cache, in place: each
    shard rewrites the global slots [N] to its local range and sends the
    rows outside it to its sink row, past every layer's rows (the JAX
    package sends them to an always-out-of-bounds flat index that its
    scatter's ``mode="drop"`` discards; a negative local id would alias
    another layer's rows). K/V [N, Hkv, D] are converted to the stored form
    once (quantized per row and head over a 1-byte cache)."""
    nb1 = cache.nb1_local
    bs = cache.shape[3]
    sink = cache.flats[0].shape[0] - 1  # L * 2 * nb1_local * BS: the first row past the layers
    k_off, v_off = global_block_offsets(cache.shards[0], layer_idx)
    slots = slots.long()
    block, offset = slots // bs, slots % bs
    rows = kv_rows(cache.flats[0], k, v)
    for s, flat in enumerate(cache.flats):
        local = block - s * nb1
        ok = (local >= 0) & (local < nb1)
        local_slots = local * bs + offset
        idx = torch.cat([torch.where(ok, k_off * bs + local_slots, sink),
                         torch.where(ok, v_off * bs + local_slots, sink)])
        store_rows(flat, rows, idx)
    return cache


def merge_partials(parts: list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]], dtype) -> torch.Tensor:
    """Cross-shard softmax merge of flash partials (o in q's dtype [N, Hq,
    D], m and l f32 [N, Hq]) given in shard order (``_merge_partials`` of
    the JAX package): m_glob = max_s m_s, w_s = l_s * exp(m_s - m_glob), o
    = sum_s w_s * o_s / max(sum_s w_s, 1e-30), rounded to ``dtype``. Shard
    0 first, elementwise ops only: the same bits for a row whatever the
    batch, so decode and packed verify merge alike. A shard with no local
    key has l = 0 and adds nothing."""
    m_glob = parts[0][1]
    for _, m, _ in parts[1:]:
        m_glob = torch.maximum(m_glob, m)
    num = den = None
    for o, m, l in parts:  # noqa: E741
        w = l * torch.exp(m - m_glob)
        term = o.float() * w[..., None]
        num = term if num is None else num + term
        den = w if den is None else den + w
    return (num / torch.clamp(den, min=1e-30)[..., None]).to(dtype)


def partials_kernel(kind: str, shard):
    """The wrapper of the per-shard partials kernel: decode K11a (K11b over
    a quantized shard), verify K11c (K11d)."""
    from nano_pearl_tpu_torch.ops.cuda import paged_attention_partials as kpp

    quant = "_q8" if cache_is_quantized(shard) else ""
    return getattr(kpp, f"paged_{kind}_partials{quant}")


def sp_paged_attention(q, cache: ShardedKVCache, layer_idx, block_tables, context_lens, scale, tables=None):
    """Decode attention (one row per block-table row, per-row contexts) over
    a block-sharded cache: K11a (K11b) per shard, then ``merge_partials``.
    ``tables``: ``shard_tables(block_tables, cache)``, when the caller has
    them already."""
    tables = tables or shard_tables(block_tables, cache)
    parts = [partials_kernel("decode", shard)(q, shard, layer_idx, local, context_lens, is_local, scale)
             for shard, (local, is_local) in zip(cache.shards, tables)]
    return merge_partials(parts, q.dtype)


def sp_paged_attention_grouped(q, cache: ShardedKVCache, layer_idx, group_tables, context_lens, scale,
                               rows_per_group, tables=None):
    """Packed-verify attention (``rows_per_group`` rows of a sequence share
    its table row) over a block-sharded cache: K11c (K11d) per shard, then
    ``merge_partials``. The JAX package's jnp branch repeats the tables per
    row instead; the port's plain version of K11c is its CPU path."""
    tables = tables or shard_tables(group_tables, cache)
    parts = [partials_kernel("verify", shard)(q, shard, layer_idx, local, context_lens, is_local, scale,
                                              rows_per_group)
             for shard, (local, is_local) in zip(cache.shards, tables)]
    return merge_partials(parts, q.dtype)


def sp_prefill_attention(q, cache: ShardedKVCache, layer_idx, block_tables, q_positions, scale, tables=None):
    """Ragged causal prefill over a block-sharded cache that holds the new
    tokens' K/V already (``sp_prefill_attention`` of the JAX package, its
    jnp arithmetic): key position p is visible to a query at position
    ``pos`` iff p <= pos and p's table slot is the shard's; per-shard
    scores, the global max over shards, exp, and the sums over shards in
    shard order. Padded queries (position -1) give 0. q [N = B*Lq, Hq, D],
    block_tables [B, M] global ids, q_positions [B, Lq]. Queries run in
    chunks of 128 rows to bound the score tile."""
    b, m = block_tables.shape
    n, hq, d = q.shape
    lq = n // b
    tables = tables or shard_tables(block_tables, cache)
    kv = []
    for shard, (local, is_local) in zip(cache.shards, tables):
        k, v = _gather_kv(shard, layer_idx, local, d)  # [B, S, Hkv, D]
        bs = k.shape[1] // m
        kv.append((k.float(), v.float(), is_local.bool().repeat_interleave(bs, dim=1)))
    s_len, hkv = kv[0][0].shape[1], kv[0][0].shape[2]
    g = hq // hkv
    qb = q.reshape(b, lq, hkv, g, d).float()
    kv_pos = torch.arange(s_len, device=q.device)
    outs = []
    for c0 in range(0, lq, 128):
        qpos = q_positions[:, c0 : c0 + 128]
        scores, vis = [], []
        for k, _, local in kv:
            visible = (kv_pos[None, None, :] <= qpos[:, :, None]) & local[:, None, :]  # [B, C, S]
            sc = torch.einsum("blkgd,bskd->bklgs", qb[:, c0 : c0 + 128], k) * scale
            scores.append(torch.where(visible[:, None, :, None, :], sc, torch.full_like(sc, NEG_INF)))
            vis.append(visible)
        m_glob = scores[0].amax(dim=-1, keepdim=True)
        for sc in scores[1:]:
            m_glob = torch.maximum(m_glob, sc.amax(dim=-1, keepdim=True))
        num = den = None
        for sc, visible, (_, v, _) in zip(scores, vis, kv):
            p = torch.where(visible[:, None, :, None, :], torch.exp(sc - m_glob), torch.zeros_like(sc))
            part_num = torch.einsum("bklgs,bskd->blkgd", p, v)
            part_den = p.sum(dim=-1)  # [B, Hkv, C, G]
            num = part_num if num is None else num + part_num
            den = part_den if den is None else den + part_den
        outs.append(num / torch.clamp(den.permute(0, 2, 1, 3)[..., None], min=1e-30))
    return torch.cat(outs, dim=1).reshape(n, hq, d).to(q.dtype)
