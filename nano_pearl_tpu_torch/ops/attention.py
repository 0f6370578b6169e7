"""Paged attention with per-row context lengths (counterpart of
nano_pearl_tpu/ops/attention.py).

The plain PyTorch versions here (gather + masked softmax, f32
accumulation) are the reference each hand-written CUDA kernel is held
against, and what the kernels' wrappers run for tensors on the CPU:

- ``paged_attention_ref``: decode, one query row per sequence
  (``paged_attention_jnp``); kernel K1.
- ``paged_attention_grouped_ref``: packed verify, ``rows_per_group``
  rows of one sequence sharing a block table (the jnp branch of
  ``paged_attention_grouped``); kernel K2.
- ``prefill_self_attention_ref``: causal prefill over the batch's fresh
  K/V (``prefill_self_attention_jnp``); kernel K3.
- ``prefill_prefix_attention_ref``: prefill over a cached prefix read
  through the block table plus the fresh causal window
  (``gather_prefix_kv`` + ``prefill_prefix_attention_jnp``); kernel K4.

The dispatchers ``paged_attention``, ``paged_attention_grouped``,
``prefill_self_attention`` and ``prefill_prefix_attention`` hand every
call to the kernel's wrapper in
``ops/cuda``, which takes the plain version only for CPU tensors and
launches the kernel (or raises) for CUDA tensors.
"""

from __future__ import annotations

import torch

from nano_pearl_tpu_torch.ops.kv_cache import global_block_offsets

NEG_INF = -1e30


def _gather_kv(cache: torch.Tensor, layer_idx: int, block_tables: torch.Tensor, head_dim: int):
    """K and V rows of the given block-table rows: [..., M*BS, Hkv, D]."""
    bs, hd = cache.shape[3], cache.shape[4]
    hkv = hd // head_dim
    lead = block_tables.shape[:-1]
    s_len = block_tables.shape[-1] * bs
    k_off, v_off = global_block_offsets(cache, layer_idx)
    blocks = cache.view(-1, bs, hd)
    bt = block_tables.long()
    k = blocks[bt + k_off].reshape(*lead, s_len, hkv, head_dim)
    v = blocks[bt + v_off].reshape(*lead, s_len, hkv, head_dim)
    return k, v


def _masked_softmax(scores: torch.Tensor, visible: torch.Tensor) -> torch.Tensor:
    scores = torch.where(visible, scores, torch.full_like(scores, NEG_INF))
    mx = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - mx)
    return p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)


def paged_attention_ref(
    q: torch.Tensor,  # [N, Hq, D]
    cache: torch.Tensor,  # [L, 2, NB+1, BS, Hkv*D]
    layer_idx: int,
    block_tables: torch.Tensor,  # [N, M] int32
    context_lens: torch.Tensor,  # [N] int32, valid KV tokens incl. self
    scale: float,
) -> torch.Tensor:
    n, hq, d = q.shape
    k, v = _gather_kv(cache, layer_idx, block_tables, d)  # [N, S, Hkv, D]
    s, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(n, hkv, hq // hkv, d).float()
    scores = torch.einsum("nkgd,nskd->nkgs", qg, k.float()) * scale
    valid = torch.arange(s, device=q.device)[None, :] < context_lens[:, None]
    p = _masked_softmax(scores, valid[:, None, None, :])
    out = torch.einsum("nkgs,nskd->nkgd", p, v.float())
    return out.reshape(n, hq, d).to(q.dtype)


def paged_attention_grouped_ref(
    q: torch.Tensor,  # [B*R, Hq, D]
    cache: torch.Tensor,
    layer_idx: int,
    group_tables: torch.Tensor,  # [B, M]
    context_lens: torch.Tensor,  # [B*R] per-row (staircase) context
    scale: float,
    rows_per_group: int,
) -> torch.Tensor:
    """Row for row the same arithmetic as ``paged_attention_ref`` with the
    group's table repeated, but each group's K/V are gathered once."""
    n, hq, d = q.shape
    b, r = group_tables.shape[0], rows_per_group
    k, v = _gather_kv(cache, layer_idx, group_tables, d)  # [B, S, Hkv, D]
    s, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, r, hkv, hq // hkv, d).float()
    scores = torch.einsum("brkgd,bskd->brkgs", qg, k.float()) * scale
    ctx = context_lens.reshape(b, r)
    valid = torch.arange(s, device=q.device)[None, None, :] < ctx[:, :, None]
    p = _masked_softmax(scores, valid[:, :, None, None, :])
    out = torch.einsum("brkgs,bskd->brkgd", p, v.float())
    return out.reshape(n, hq, d).to(q.dtype)


def prefill_self_attention_ref(
    q: torch.Tensor,  # [N = B*Lq, Hq, D] flat new-token queries, seq-major
    k: torch.Tensor,  # [N, Hkv, D] the batch's fresh post-rope keys
    v: torch.Tensor,  # [N, Hkv, D]
    q_positions: torch.Tensor,  # [B, Lq] int32 absolute positions; -1 = padded
    scale: float,
) -> torch.Tensor:
    """Causal prefill self-attention: key j is visible to query i iff
    ``0 <= pos[j] <= pos[i]``. Queries run in chunks of 128 rows to bound
    the materialised score tile."""
    b, lq = q_positions.shape
    n, hq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qb = q.reshape(b, lq, hkv, g, d).float()
    kb = k.reshape(b, lq, hkv, d).float()
    vb = v.reshape(b, lq, hkv, d).float()
    kpos = q_positions
    outs = []
    for c0 in range(0, lq, 128):
        qc, qpos = qb[:, c0 : c0 + 128], q_positions[:, c0 : c0 + 128]
        scores = torch.einsum("blkgd,bskd->bklgs", qc, kb) * scale
        visible = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[:, :, None])
        p = _masked_softmax(scores, visible[:, None, :, None, :])
        outs.append(torch.einsum("bklgs,bskd->blkgd", p, vb))
    return torch.cat(outs, dim=1).reshape(n, hq, d).to(q.dtype)


def prefill_prefix_attention_ref(
    q: torch.Tensor,  # [N = B*Lq, Hq, D] flat new-token queries, seq-major
    k: torch.Tensor,  # [N, Hkv, D] fresh post-rope keys of the new tokens
    v: torch.Tensor,  # [N, Hkv, D]
    cache: torch.Tensor,  # [L, 2, NB+1, BS, Hkv*D], the new tokens' K/V already written
    layer_idx: int,
    bt_pre: torch.Tensor,  # [B, Mpre] int32 pages of the cached prefix
    num_cached: torch.Tensor,  # [B] int32 cached-prefix lengths
    n_new: torch.Tensor,  # [B] int32 real new rows per sequence
    scale: float,
) -> torch.Tensor:
    """Prefill of sequences whose first ``num_cached[b]`` positions are in
    the paged cache (``gather_prefix_kv`` + ``prefill_prefix_attention_jnp``
    of the JAX package, as one softmax over prefix and fresh keys). Row i
    of sequence b sits at position ``num_cached[b] + i`` and is real iff
    ``i < n_new[b]``; it sees every cached position and the fresh keys
    ``j <= i``. Padded rows see nothing and give 0. Queries run in chunks
    of 128 rows to bound the score tile."""
    b, _ = bt_pre.shape
    n, hq, d = q.shape
    lq = n // b
    hkv = k.shape[1]
    g = hq // hkv
    pk, pv = _gather_kv(cache, layer_idx, bt_pre, d)  # [B, S_pre, Hkv, D]
    keys = torch.cat([pk.float(), k.reshape(b, lq, hkv, d).float()], dim=1)
    vals = torch.cat([pv.float(), v.reshape(b, lq, hkv, d).float()], dim=1)
    s_pre = pk.shape[1]
    qb = q.reshape(b, lq, hkv, g, d).float()
    dev = q.device
    nc, nn = num_cached.to(dev).long(), n_new.to(dev).long()
    s_idx = torch.arange(s_pre, device=dev)
    j_idx = torch.arange(lq, device=dev)
    outs = []
    for c0 in range(0, lq, 128):
        i_idx = torch.arange(c0, min(lq, c0 + 128), device=dev)
        real = i_idx[None, :] < nn[:, None]  # [B, C]
        vis_pre = real[:, :, None] & (s_idx[None, None, :] < nc[:, None, None])
        vis_new = real[:, :, None] & (j_idx[None, None, :] <= i_idx[None, :, None])
        visible = torch.cat([vis_pre, vis_new], dim=2)[:, None, :, None, :]  # [B,1,C,1,S]
        scores = torch.einsum("blkgd,bskd->bklgs", qb[:, c0 : c0 + 128], keys) * scale
        scores = torch.where(visible, scores, torch.full_like(scores, NEG_INF))
        # rows with nothing visible: the max floor makes every p underflow to 0
        mx = torch.clamp(scores.amax(dim=-1, keepdim=True), min=-1e29)
        p = torch.where(visible, torch.exp(scores - mx), torch.zeros_like(scores))
        p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        outs.append(torch.einsum("bklgs,bskd->blkgd", p, vals))
    return torch.cat(outs, dim=1).reshape(n, hq, d).to(q.dtype)


def paged_attention(q, cache, layer_idx, block_tables, context_lens, scale):
    """Decode attention: kernel K1 on the card, the plain version on the CPU."""
    from nano_pearl_tpu_torch.ops.cuda.paged_attention import paged_decode

    return paged_decode(q, cache, layer_idx, block_tables, context_lens, scale)


def paged_attention_grouped(
    q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group
):
    """Packed-verify attention: kernel K2 on the card, the plain version on
    the CPU."""
    from nano_pearl_tpu_torch.ops.cuda.paged_attention import paged_verify

    return paged_verify(
        q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group
    )


def prefill_self_attention(q, k, v, q_positions, scale):
    """Fresh-KV prefill attention: kernel K3 on the card, the plain version
    on the CPU."""
    from nano_pearl_tpu_torch.ops.cuda.prefill_attention import prefill_self

    return prefill_self(q, k, v, q_positions, scale)


def prefill_prefix_attention(q, k, v, cache, layer_idx, bt_pre, num_cached, n_new, scale):
    """Prefill over a cached prefix plus the fresh causal window: kernel K4
    on the card, the plain version on the CPU."""
    from nano_pearl_tpu_torch.ops.cuda.prefill_attention import prefill_prefix

    return prefill_prefix(q, k, v, cache, layer_idx, bt_pre, num_cached, n_new, scale)
