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
- Kernel K5 (the "throughput" profile's mono schedule) computes what K1
  and K2 compute, so its plain versions are ``paged_attention_ref`` and
  ``paged_attention_grouped_ref``.
- ``paged_attention_grouped_cache_partials_ref``: flash partials
  (o, m, l) of grouped attention over the pre-round cache only; kernel
  K7, the cache half of the deferred-write verify.
- ``fresh_window_partials`` and ``merge_attn_partials``: the fresh-window
  half of the deferred verify and the (m, l) softmax merge of the two
  halves, plain torch ops on every device as in the JAX package.
- ``paged_attention_grouped_fresh_ref``: the deferred verify's attention
  as one softmax over cache and fresh keys
  (``paged_attention_grouped_fresh_jnp``), the yardstick of the merge and
  the plain version of kernels K6a (db schedule), K6b (mono schedule, the
  fresh window in the kernel) and K8b (split-boundary schedule).
- Kernel K8a (the split-boundary decode) computes what K1 computes, with
  another rounding: its plain version is ``paged_attention_ref``, which
  ignores the boundary, as the JAX package's jnp path does.
- ``paged_attention_partials_ref`` and
  ``paged_attention_grouped_partials_ref``: flash partials (o, m, l) of
  decode and packed-verify attention over ONE shard of a block-sharded
  cache (sequence parallelism, ``parallel/sp.py``), its slots marked by
  ``is_local``; kernels K11a and K11c (K11b and K11d over a quantized
  shard).
- Kernels K10a/K10b (the fallbacks of decode and packed verify, at the
  shapes the JAX package's fast kernels do not take: ``Hkv * D % 128``,
  and ``BS % 32`` over a 1-byte cache, see ``attention_kernel``) compute
  what K1/K2 compute; their plain versions are ``paged_attention_ref``
  and ``paged_attention_grouped_ref``.

Every plain version reads either cache kind. Over a quantized cache
(``QuantKVCache``) the decode, packed-verify and mono plain versions are
those of kernels K9a, K9b and K9c (K10c and K10d): the gathered 1-byte rows are
dequantized per (slot, head) and rounded to the query's dtype, as the
kernels round their dequantized tiles; the prefix prefill dequantizes to
f32 and attends with torch ops on every device, as the JAX package falls
back to its jnp path there (its K4 takes no quantized cache).

The dispatchers ``paged_attention``, ``paged_attention_grouped``,
``paged_attention_mono``, ``paged_attention_grouped_fresh``,
``paged_attention_split``, ``prefill_self_attention`` and
``prefill_prefix_attention`` hand every kernel call to the kernel's
wrapper in ``ops/cuda`` (decode, verify and mono through the route
``attention_kernel``), which takes the plain version only for CPU tensors
and launches the kernel (or raises) for CUDA tensors. Every kernel takes
the head dims ``check_head_dim`` allows.
"""

from __future__ import annotations

import os

import torch

from nano_pearl_tpu_torch.ops.kv_cache import (
    cache_is_quantized,
    dequant_rows,
    global_block_offsets,
)

NEG_INF = -1e30
M_FLOOR = -1e29  # running-max floor of the partials: nothing visible gives l = 0


def check_head_dim(d: int) -> None:
    """The head dims every attention kernel takes: multiples of 16 (one
    16-byte load of a 1-byte cache) from 16 to 256."""
    if d % 16 or not 16 <= d <= 256:
        raise ValueError(f"head_dim {d} not supported (a multiple of 16 from 16 to 256)")


def _gather_kv(cache, layer_idx: int, block_tables: torch.Tensor, head_dim: int, out_dtype=None):
    """K and V rows of the given block-table rows: [..., M*BS, Hkv, D] in
    the cache's dtype. A quantized cache is dequantized after the gather
    (``_gather_kv`` of the JAX package): f32, or rounded once to
    ``out_dtype`` where it is given, as the kernels K9a-c round the
    dequantized tile to the query's dtype (the Pallas kernels' ``_kv_head``
    with ``out_dt = q.dtype``)."""
    bs, hd = cache.shape[3], cache.shape[4]
    hkv = hd // head_dim
    lead = block_tables.shape[:-1]
    s_len = block_tables.shape[-1] * bs
    k_off, v_off = global_block_offsets(cache, layer_idx)
    bt = block_tables.long()
    if cache_is_quantized(cache):
        qb = cache.q.view(-1, bs, hd)
        sb = cache.s.view(-1, bs, hkv)
        kv = []
        for off in (k_off, v_off):
            rows = dequant_rows(qb[bt + off], sb[bt + off], head_dim)
            rows = rows.reshape(*lead, s_len, hkv, head_dim)
            kv.append(rows if out_dtype is None else rows.to(out_dtype))
        return tuple(kv)
    blocks = cache.view(-1, bs, hd)
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
    k, v = _gather_kv(cache, layer_idx, block_tables, d, q.dtype)  # [N, S, Hkv, D]
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
    k, v = _gather_kv(cache, layer_idx, group_tables, d, q.dtype)  # [B, S, Hkv, D]
    s, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, r, hkv, hq // hkv, d).float()
    scores = torch.einsum("brkgd,bskd->brkgs", qg, k.float()) * scale
    ctx = context_lens.reshape(b, r)
    valid = torch.arange(s, device=q.device)[None, None, :] < ctx[:, :, None]
    p = _masked_softmax(scores, valid[:, :, None, None, :])
    out = torch.einsum("brkgs,bskd->brkgd", p, v.float())
    return out.reshape(n, hq, d).to(q.dtype)


def _flash_partials(scores: torch.Tensor, visible: torch.Tensor, v: torch.Tensor, dtype):
    """(o normalised by its own sum, in ``dtype``; m, the row max floored at
    ``M_FLOOR``; l, the sum of exp(s - m)) of scores [B, R, Hkv, G, S]
    with ``visible`` [B, R, S] against values v [B, S, Hkv, D] f32; o is
    [B*R, Hq, D], m and l f32 [B*R, Hq]."""
    b, r, hkv, g, _ = scores.shape
    vis = visible[:, :, None, None, :]
    scores = torch.where(vis, scores, torch.full_like(scores, M_FLOOR))
    m = scores.amax(dim=-1)  # [B, R, Hkv, G]
    p = torch.where(vis, torch.exp(scores - m[..., None]), torch.zeros_like(scores))
    l = p.sum(dim=-1)  # noqa: E741
    o = torch.einsum("brkgs,bskd->brkgd", p, v) / torch.clamp(l, min=1e-30)[..., None]
    n, hq = b * r, hkv * g
    return o.reshape(n, hq, -1).to(dtype), m.reshape(n, hq), l.reshape(n, hq)


def paged_attention_grouped_cache_partials_ref(
    q: torch.Tensor,  # [B*R, Hq, D]
    cache: torch.Tensor,  # [L, 2, NB+1, BS, Hkv*D], read only
    layer_idx: int,
    group_tables: torch.Tensor,  # [B, M]
    context_lens: torch.Tensor,  # [B*R] cache-side context per row (may be 0)
    scale: float,
    rows_per_group: int,
):
    """Flash partials of grouped attention over the cache only: (o
    normalised by its own sum, in q's dtype; m, the row max floored at
    ``M_FLOOR``; l, the sum of exp(s - m)), m and l f32 [B*R, Hq]. A row
    with context 0 gives o = 0, m = M_FLOOR and l = 0, as the Pallas
    kernel's ``_init_scratch_floor`` start does."""
    n, hq, d = q.shape
    b, r = group_tables.shape[0], rows_per_group
    k, v = _gather_kv(cache, layer_idx, group_tables, d)  # [B, S, Hkv, D]
    s, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, r, hkv, hq // hkv, d).float()
    scores = torch.einsum("brkgd,bskd->brkgs", qg, k.float()) * scale
    ctx = context_lens.reshape(b, r)
    vis = torch.arange(s, device=q.device)[None, None, :] < ctx[:, :, None]
    return _flash_partials(scores, vis, v.float(), q.dtype)


def paged_attention_grouped_partials_ref(
    q: torch.Tensor,  # [B*R, Hq, D]
    cache,  # ONE shard [L, 2, NB1_loc, BS, Hkv*D] (tensor or QuantKVCache), read only
    layer_idx: int,
    group_tables: torch.Tensor,  # [B, M] LOCAL block ids, clamped into the shard
    context_lens: torch.Tensor,  # [B*R] global per-row context
    is_local: torch.Tensor,  # [B, M] int32, 1 where the slot is this shard's
    scale: float,
    rows_per_group: int,
):
    """Flash partials of packed-verify attention over one shard's blocks
    (``paged_attention_pallas_grouped_partials`` of the JAX package): the
    decode partials (``paged_attention_partials_ref``) of every row with
    its group's table and ``is_local`` row repeated, as the JAX package's
    jnp branch repeats the tables. Each row is then computed by the very
    products the decode runs, whatever shapes the host's BLAS rounds
    alike, so a verify row equals its decode row bit for bit."""
    r = rows_per_group
    return paged_attention_partials_ref(
        q, cache, layer_idx, group_tables.repeat_interleave(r, 0), context_lens,
        is_local.repeat_interleave(r, 0), scale,
    )


def paged_attention_partials_ref(q, cache, layer_idx, block_tables, context_lens, is_local, scale):
    """Decode flash partials over one shard (``paged_attention_pallas_partials``
    of the JAX package): (o normalised by its own sum, in q's dtype; m, the
    row max floored at ``M_FLOOR``; l, the sum of exp(s - m)), m and l f32
    [N, Hq]. Key p of a row is visible iff p < its context and its table
    slot is local; a row with no visible key gives o = 0, m = M_FLOOR and
    l = 0. A quantized shard is dequantized and rounded to q's dtype, as
    the K9 plain versions read it."""
    n, hq, d = q.shape
    k, v = _gather_kv(cache, layer_idx, block_tables, d, q.dtype)  # [N, S, Hkv, D]
    s, hkv = k.shape[1], k.shape[2]
    bs = s // block_tables.shape[1]
    qg = q.reshape(n, 1, hkv, hq // hkv, d).float()
    scores = torch.einsum("nrkgd,nskd->nrkgs", qg, k.float()) * scale
    local = is_local.bool().repeat_interleave(bs, dim=1)  # [N, S]
    vis = (torch.arange(s, device=q.device)[None, None, :] < context_lens[:, None, None]) & local[:, None, :]
    return _flash_partials(scores, vis, v.float(), q.dtype)


def fresh_window_partials(
    q: torch.Tensor,  # [B*R, Hq, D]
    fresh_k: torch.Tensor,  # [B*R, Hkv, D] this layer's post-rope fresh keys
    fresh_v: torch.Tensor,  # [B*R, Hkv, D]
    context_lens: torch.Tensor,  # [B*R] per-row context incl. visible fresh rows
    ctx0: torch.Tensor,  # [B] pre-round context per group
    scale: float,
    rows_per_group: int,
):
    """Flash partials (o normalised, m, l) of each packed-verify row over
    its group's fresh window only: fresh row t sits at position ctx0 + t
    and row i sees it iff that position < context_lens[i]. Dense [B, R, R]
    scores in f32, as ``fresh_window_partials`` of the JAX package; o is
    rounded to q's dtype there too."""
    n, hq, d = q.shape
    r = rows_per_group
    b = n // r
    hkv = fresh_k.shape[1]
    qb = q.reshape(b, r, hkv, hq // hkv, d).float()
    fk = fresh_k.reshape(b, r, hkv, d).float()
    fv = fresh_v.reshape(b, r, hkv, d).float()
    scores = torch.einsum("brkgd,bskd->brkgs", qb, fk) * scale
    pos_f = ctx0[:, None, None] + torch.arange(r, device=q.device)[None, None, :]
    vis = pos_f < context_lens.reshape(b, r)[:, :, None]
    return _flash_partials(scores, vis, fv, q.dtype)


def merge_attn_partials(o1, m1, l1, o2, m2, l2, dtype):
    """Softmax-combine two flash partial sets (o normalised by its own sum,
    m the row max, l the sum of exp); a side with nothing visible carries
    l = 0 and adds nothing."""
    m_g = torch.maximum(m1, m2)
    w1 = l1 * torch.exp(m1 - m_g)
    w2 = l2 * torch.exp(m2 - m_g)
    num = o1.float() * w1[..., None] + o2.float() * w2[..., None]
    return (num / torch.clamp(w1 + w2, min=1e-30)[..., None]).to(dtype)


def paged_attention_grouped_fresh_ref(
    q: torch.Tensor,  # [B*R, Hq, D]
    cache: torch.Tensor,  # holds the pre-round context only (positions < ctx0)
    layer_idx: int,
    group_tables: torch.Tensor,  # [B, M]
    context_lens: torch.Tensor,  # [B*R] per-row context incl. visible fresh rows
    ctx0: torch.Tensor,  # [B] pre-round context per group
    fresh_k: torch.Tensor,  # [B*R, Hkv, D]
    fresh_v: torch.Tensor,  # [B*R, Hkv, D]
    scale: float,
) -> torch.Tensor:
    """The deferred-write verify's attention as one softmax: cache position
    p is visible iff p < min(ctx_row, ctx0), fresh row t (position ctx0 +
    t) iff ctx0 + t < ctx_row. Equals writing the fresh rows and then
    running ``paged_attention_grouped_ref``."""
    n, hq, d = q.shape
    b = group_tables.shape[0]
    r = n // b
    k, v = _gather_kv(cache, layer_idx, group_tables, d)  # [B, S, Hkv, D]
    s, hkv = k.shape[1], k.shape[2]
    k = torch.cat([k.float(), fresh_k.reshape(b, r, hkv, d).float()], dim=1)
    v = torch.cat([v.float(), fresh_v.reshape(b, r, hkv, d).float()], dim=1)
    qb = q.reshape(b, r, hkv, hq // hkv, d).float()
    scores = torch.einsum("brkgd,bskd->brkgs", qb, k) * scale
    ctx = context_lens.reshape(b, r)
    lim_c = torch.minimum(ctx, ctx0[:, None])[:, :, None]
    vis_c = torch.arange(s, device=q.device)[None, None, :] < lim_c
    vis_f = ctx0[:, None, None] + torch.arange(r, device=q.device)[None, None, :] < ctx[:, :, None]
    visible = torch.cat([vis_c, vis_f], dim=2)[:, :, None, None, :]
    p = _masked_softmax(scores, visible)
    out = torch.einsum("brkgs,bskd->brkgd", p, v)
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


def attention_kernel(kind: str, cache, mono: bool = False):
    """The wrapper of the kernel that runs a decode (``kind`` "decode", one
    row per block-table row) or a packed verify ("verify", rows sharing a
    group's table) over ``cache``, by the JAX package's gates: its fast
    kernels take a folded head axis ``Hkv * D`` that is a multiple of 128
    and, over a 1-byte cache, block sizes that are multiples of 32
    (``_q8_fastpath_ok``; on one device its strided scale width always
    passes). There:

    - decode: K1 (K9a over a quantized cache); verify: K2 (K9b); their
      bf16 route runs on the page walk that K10a-d launch, but each
      counts its own launches;
    - on the mono schedule (``mono``) both K5 (K9c).

    Every other shape goes to the fallbacks, on either schedule: decode
    K10a (K10c over a quantized cache), verify K10b (K10d)."""
    from nano_pearl_tpu_torch.ops.cuda import mono_attention as kmo
    from nano_pearl_tpu_torch.ops.cuda import paged_attention as kpa
    from nano_pearl_tpu_torch.ops.cuda import paged_attention_fallback as kfb

    if kind not in ("decode", "verify"):
        raise ValueError(f"kind must be 'decode' or 'verify', got {kind!r}")
    quant = cache_is_quantized(cache)
    fast = cache.shape[-1] % 128 == 0 and (not quant or cache.shape[3] % 32 == 0)
    if not fast:
        if kind == "decode":
            return kfb.paged_decode_fallback_q8 if quant else kfb.paged_decode_fallback
        return kfb.paged_verify_fallback_q8 if quant else kfb.paged_verify_fallback
    if mono:
        return kmo.mono_q8 if quant else kmo.mono_attention
    if kind == "decode":
        return kpa.paged_decode_q8 if quant else kpa.paged_decode
    return kpa.paged_verify_q8 if quant else kpa.paged_verify


def paged_attention(q, cache, layer_idx, block_tables, context_lens, scale):
    """Decode attention: the kernel ``attention_kernel`` picks (K1, K9a,
    K10a or K10c) on the card, its plain version on the CPU."""
    fn = attention_kernel("decode", cache)
    return fn(q, cache, layer_idx, block_tables, context_lens, scale)


def paged_attention_grouped(
    q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group
):
    """Packed-verify attention: the kernel ``attention_kernel`` picks (K2,
    K9b, K10b or K10d) on the card, its plain version on the CPU. A group
    of one row (a verify at gamma 1, on the adaptive ladder) is a decode
    row of its table: the decode kernel takes it (K2 and K9b take two rows
    a group or more; their rows equal the decode kernel's bit for bit)."""
    if rows_per_group == 1:
        return paged_attention(q, cache, layer_idx, group_tables, context_lens, scale)
    fn = attention_kernel("verify", cache)
    return fn(q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group)


def paged_attention_mono(q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group=1):
    """Grouped paged attention on the mono schedule (decode at
    ``rows_per_group`` 1): K5 (K9c over a quantized cache) where its gate
    passes, else the fallback of the call's kind (K10a-d, as the JAX
    package gates before it resolves the schedule); the plain version on
    the CPU."""
    kind = "decode" if rows_per_group == 1 else "verify"
    fn = attention_kernel(kind, cache, mono=True)
    if fn.__name__.startswith("paged_decode"):
        return fn(q, cache, layer_idx, group_tables, context_lens, scale)
    return fn(q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group)


def paged_attention_grouped_fresh(
    q, cache, layer_idx, group_tables, context_lens, ctx0, fresh_k, fresh_v, scale, rows_per_group,
    mono=True, split=False, fresh_mode=None,
):
    """The deferred-write verify's attention (the cache holds no fresh
    row), by the JAX package's three-way choice:

    - ``split``: kernel K8b (the split-boundary schedule);
    - ``mono`` with ``fresh_mode`` "merge" (the default): kernel K7's
      partials over the pre-round cache (cache-side context
      ``min(ctx_row, ctx0)``), the fresh window's partials as plain ops,
      and their (m, l) merge;
    - ``mono`` with "kernel": kernel K6b, the fresh window in the same
      launch;
    - not ``mono``: kernel K6a (the db schedule).

    ``fresh_mode`` None reads ``NANO_PEARL_FRESH_MODE`` here, as the JAX
    package's dispatch does (the runner resolves it once and passes it)."""
    from nano_pearl_tpu_torch.ops.cuda import mono_attention as kmo
    from nano_pearl_tpu_torch.ops.cuda import paged_attention as kpa

    r = rows_per_group
    fresh = (q, cache, layer_idx, group_tables, context_lens, ctx0, fresh_k.contiguous(),
             fresh_v.contiguous(), scale, r)
    if split:
        return kpa.paged_verify_fresh_split(*fresh)
    if not mono:
        return kpa.paged_verify_fresh(*fresh)
    if fresh_mode is None:
        fresh_mode = os.environ.get("NANO_PEARL_FRESH_MODE", "merge")
    if fresh_mode != "merge":
        return kmo.mono_fresh(*fresh)
    ctx_cache = torch.minimum(context_lens, ctx0.repeat_interleave(r)).contiguous()
    oc, mc, lc = kmo.cache_partials(q, cache, layer_idx, group_tables, ctx_cache, scale, r)
    of, mf, lf = fresh_window_partials(q, fresh_k, fresh_v, context_lens, ctx0, scale, r)
    return merge_attn_partials(oc, mc, lc, of, mf, lf, q.dtype)


def paged_attention_split(q, cache, layer_idx, block_tables, context_lens, b1, scale):
    """Decode attention on the split-boundary schedule: kernel K8a on the
    card (row i's key stream cut at b1[i], the start of the fresh window
    of the verify that checks its token, besides the key chunks), the
    plain version on the CPU."""
    from nano_pearl_tpu_torch.ops.cuda.paged_attention import paged_decode_split

    return paged_decode_split(q, cache, layer_idx, block_tables, context_lens, b1, scale)


def prefill_self_attention(q, k, v, q_positions, scale):
    """Fresh-KV prefill attention: kernel K3 on the card, the plain version
    on the CPU."""
    from nano_pearl_tpu_torch.ops.cuda.prefill_attention import prefill_self

    return prefill_self(q, k, v, q_positions, scale)


def prefill_prefix_attention(q, k, v, cache, layer_idx, bt_pre, num_cached, n_new, scale):
    """Prefill over a cached prefix plus the fresh causal window: kernel K4
    on the card, the plain version on the CPU. Over a quantized cache the
    plain version on every device, as the JAX package gates its K4 off
    for quantized caches and runs its jnp path."""
    from nano_pearl_tpu_torch.ops.cuda.prefill_attention import prefill_prefix

    if cache_is_quantized(cache):
        return prefill_prefix_attention_ref(q, k, v, cache, layer_idx, bt_pre, num_cached, n_new, scale)

    return prefill_prefix(q, k, v, cache, layer_idx, bt_pre, num_cached, n_new, scale)
