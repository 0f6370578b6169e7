"""Per-model device runner: weights, paged KV cache and step functions
(counterpart of nano_pearl_tpu/engine/runner.py).

One ``GroupRunner`` owns one model's weights, rope table and KV cache on
one device and runs its phases eagerly. Its weights are the ones handed
in, else the HF checkpoint at ``ModelConfig.model_path`` (a directory
given to ``PearlConfig``, read by ``utils/loader.load_params``), else
random ones from the seed (with a warning):

- ``prefill``: prefill of a batch, or one block-aligned pass of a
  chunked prefill. A batch with no prefix-cache hit attends over its
  fresh K/V (kernel K3); a batch with hits reads the cached prefix pages
  straight out of the cache (kernel K4);
- ``decode_step``: one decode step over B rows (AR and the draft's
  gamma-scan, a Python loop of these steps in engine/fused.py);
- ``packed_verify_forward``: the target's packed verify, cut into chunks
  of at most ``verify_group_cap`` sequences (B=32 runs as two chunks of
  16 groups under the "ceiling" profile, as one under "throughput").

The kernel schedule follows ``PearlConfig.perf_profile``, resolved once
here:

- "ceiling": decode through K1; the classic write-then-read verify, each
  layer storing its K/V (``write_kv``) before K2 reads them back;
- "throughput": decode through K5 (the mono schedule); the deferred-write
  verify: each layer collects its fresh K/V into a dense [L, 2, N,
  Hkv*D] buffer and attends the pre-round cache through K7 merged with
  the fresh window, and one K12 writeback stores the round after the
  layers.

The JAX package's environment overrides (its runner.py:81-140, 475-509)
are read once, in ``GroupRunner.__init__``, and never written back to
``os.environ``, so engines of different schedules coexist in one
process. Unset, the profile decides; set:

- ``NANO_PEARL_MONO=0/1``: the mono schedule (K5 decode) off or on;
- ``NANO_PEARL_DEFERRED_VERIFY=0/1``: the deferred-write verify off or
  on. Off the mono schedule it runs through K6a (the db schedule);
- ``NANO_PEARL_VERIFY_GROUP_CAP=<n>``: ``verify_group_cap``;
- ``NANO_PEARL_SPLIT=1``: the split-boundary schedule: the draft's
  gamma-scan decodes through K8a and the deferred verify runs through
  K8b, whose cells match K8a's, so decode and verify agree bit for bit
  without a per-layer cache write (engine/fused.py passes the boundary
  b1). AR and other decodes keep K1, as in the JAX package;
- ``NANO_PEARL_VERIFY_ROWWISE=1``: no deferred verify; the verify's
  attention runs through the decode kernel (K1, or K5 on the mono
  schedule) with each group's block table repeated for its rows;
- ``NANO_PEARL_FRESH_MODE=merge/kernel``: on the mono schedule, K7 + the
  fresh window as torch ops + their merge ("merge", the default), or K6b
  with the window folded in the same launch ("kernel"). The JAX package
  reads it in its dispatch when the program is traced, once per shape;
  the port's dispatch (``ops/attention.paged_attention_grouped_fresh``)
  reads it only when its caller passes none, and the runner resolves it
  here.

The gates are the JAX package's (the port runs one device): the split
schedule needs the db schedule (not mono), an unquantized cache and a
folded head axis ``Hkv * D`` that is a multiple of 128; the deferred
verify needs the last two, and is on when requested or under the split
schedule. Where a gate turns a requested override off, the runner logs
it once; the JAX package turns it off silently.

Quantization, as in the JAX package: ``ModelConfig.quant`` quantizes the
plain weights handed in at load (``params_from_numpy`` /
``quantize_params``); ``ModelConfig.kv_quant`` allocates a 1-byte cache
(``QuantKVCache``). A quantized cache turns the deferred verify and K4
off (JAX's ``runner.py`` gates both on ``kv_quant is None``): the
verify is the classic write-then-read one, through K9b under "ceiling"
and K9c under "throughput"; decode goes through K9a or K9c; a prefix hit
prefills through torch ops (the JAX package's jnp path).

MoE models (``ModelConfig.is_moe``) run ``ops/moe.moe_mlp`` in place of
the dense MLP. Every prefill flavour lets it take the sorted dispatch (at
128 rows or more, unquantized experts), as the draft and the target
prefill the same rows; decode never does, nor the ceiling profile's
verify, so that the draft's decode and the target's verify round alike
(the throughput profile's verify does: its acceptance is set by the
models, not by rounding), as in the JAX package. ``ModelConfig.fuse_proj``
fuses a dense model's projections (``fuse_projections``) once its
weights are on the device and quantized.

Decode and verify attention go through the route
``ops/attention.attention_kernel``, by the JAX package's gates: at a folded
head axis ``Hkv * D`` that is not a multiple of 128 (over a 1-byte cache
also at blocks that are not a multiple of 32) every schedule takes the
fallbacks K10a (decode) and K10b (verify), K10c / K10d over a quantized
cache, in place of K1/K2, K5 or K9a-c.

Sequence parallelism (``PearlConfig.draft_sp`` / ``target_sp`` > 1, the
JAX package's sp group; ``parallel/mesh.GroupPlacement``): the runner's
cache is a ``ShardedKVCache`` of ``sp`` shards, its block count rounded
so that the blocks plus the garbage block divide over sp (the JAX
package's rounding). Every layer writes through ``parallel/sp.sp_write_kv``;
decode reads through ``sp_paged_attention`` (K11a per shard, K11b over a
quantized cache), the packed verify through ``sp_paged_attention_grouped``
(K11c / K11d), both merging the shards' partials; a fresh prefill runs K3
(it reads no cache) and a prefill with cached prefixes
``sp_prefill_attention`` (torch ops, as the JAX package's jnp path: K4
reads an unsharded cache). As in the JAX package, sp turns the split
schedule, the deferred verify (so the throughput profile verifies with the
classic write-then-read verify) and the mono schedule (attention under sp
takes the partials kernels only) off, each logged where it was asked for.

Tensor parallelism (``PearlConfig.draft_tp`` / ``target_tp`` > 1, a
placement of ``tp`` devices, ``parallel/mesh.py``): the runner pads numpy
weights to the ``pad_for_tp`` shapes, quantizes and fuses them as above,
then keeps one weight shard (``parallel/sharding.shard_params``), one rope
table and one cache shard of its ``Hkv / tp`` KV heads (a ``TPKVCache``)
on each rank's device, and runs ``forward_tp``: each rank launches its
own products and attention kernel, the host sums the ranks' wo and wdown
products in rank order and joins the logits over the vocab shards.
Every phase takes its inputs on the runner's ``device`` (the engine's) and
returns its logits there, wherever the ranks sit. As in the JAX package,
tp turns the split schedule off (logged), and the other gates read the
rank's folded head axis ``Hkv / tp * D``.

The KV cache is allocated after both models' weights are on the device
(``allocate_kv``), so that ``kv_num_blocks`` can size both pools of a
shared card from one budget.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from nano_pearl_tpu_torch.config import ModelConfig, PearlConfig
from nano_pearl_tpu_torch.engine.sequence import SeqView
from nano_pearl_tpu_torch.models.transformer import (
    check_supported,
    compute_logits,
    compute_logits_tp,
    forward,
    forward_tp,
    fuse_projections,
    init_params_numpy,
    make_rope_table,
    params_from_numpy,
    quantize_params,
    torch_dtype,
)
from nano_pearl_tpu_torch.ops.attention import (
    paged_attention,
    paged_attention_grouped,
    paged_attention_grouped_fresh,
    paged_attention_mono,
    paged_attention_split,
    prefill_prefix_attention,
    prefill_self_attention,
)
from nano_pearl_tpu_torch.ops.kv_cache import (
    TPKVCache,
    cache_nbytes,
    make_kv_cache,
    make_sharded_kv_cache,
    write_fresh,
    write_kv,
)
from nano_pearl_tpu_torch.ops.quant import is_quantized
from nano_pearl_tpu_torch.ops.sampling import apply_top_k_top_p, greedy, sample
from nano_pearl_tpu_torch.ops.verify import VerifyResult, verify_verdict
from nano_pearl_tpu_torch.parallel.mesh import GroupPlacement
from nano_pearl_tpu_torch.parallel.sharding import TPRank, shard_params
from nano_pearl_tpu_torch.parallel.sp import (
    shard_tables,
    sp_paged_attention,
    sp_paged_attention_grouped,
    sp_prefill_attention,
    sp_write_kv,
)
from nano_pearl_tpu_torch.utils.loader import load_params, pad_params
from nano_pearl_tpu_torch.utils.logging import logger

_DEFAULT_CPU_BLOCKS = 512


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _is_numpy_tree(params: dict) -> bool:
    return isinstance(params["embed"], np.ndarray)


def device_kv_budget(device: torch.device, hbm_utilization: float) -> int | None:
    """Bytes the KV caches may take on ``device``: ``hbm_utilization`` of
    the card less what is in use (the allocator's cached, unused memory
    counts as free), as the reference's allocate_kv_cache; None on the CPU."""
    if device.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return int(total * hbm_utilization - (total - free))


def kv_num_blocks(pcfg: PearlConfig, block_bytes: list[int], budget: int | None) -> int:
    """Blocks of each KV pool. Pools that share one device get the same
    count from one budget: ``budget // sum(block_bytes)`` (the scheduler
    can use no more than the smaller pool). ``num_kvcache_blocks > 0``
    fixes the count; on the CPU (``budget`` None) a small default."""
    if pcfg.num_kvcache_blocks > 0:
        return pcfg.num_kvcache_blocks
    if budget is None:
        return _DEFAULT_CPU_BLOCKS
    num = budget // sum(block_bytes)
    if num <= 0:
        raise RuntimeError(
            f"not enough device memory for one KV block of each model "
            f"({budget} bytes free for {sum(block_bytes)} bytes a block)"
        )
    return num


def sp_num_blocks(num_blocks: int, sp: int) -> int:
    """Blocks of a pool sharded over ``sp``: rounded down so that the
    blocks plus the garbage block divide over sp (the JAX package's
    runner), at least sp - 1."""
    if sp == 1:
        return num_blocks
    return max(sp - 1, (num_blocks + 1) // sp * sp - 1)


class GroupRunner:
    def __init__(
        self,
        pcfg: PearlConfig,
        mcfg: ModelConfig,
        device: torch.device,
        *,
        name: str,
        params: dict | None = None,
        seed: int = 0,
        placement: GroupPlacement | None = None,
    ):
        check_supported(mcfg, device)
        self.pcfg = pcfg
        self.cfg = mcfg
        self.device = device
        self.name = name
        self.placement = placement or GroupPlacement((device,))
        self.sp_size = self.placement.sp_size
        self.tp_size = self.placement.tp_size
        self._kv_write = sp_write_kv if self.sp_size > 1 else write_kv
        self.block_size = pcfg.kvcache_block_size
        self.scale = mcfg.head_dim**-0.5
        self._resolve_schedule(pcfg, mcfg)
        if params is None and mcfg.model_path:
            params = load_params(mcfg, mcfg.model_path)
        elif params is None:
            logger.warning(f"[{name}] no weights given and no checkpoint path; random-initializing")
            params = init_params_numpy(mcfg, np.random.default_rng(seed))
        if _is_numpy_tree(params):
            if self.tp_size > 1:  # the ranks' split axes must divide tp
                params = pad_params(params, mcfg)
            params = params_from_numpy(params, mcfg, device)
        elif mcfg.quant and not is_quantized(params["layers"]["wq"]):
            params = quantize_params(params, mcfg)
        if mcfg.fuse_proj and not mcfg.is_moe:
            params = dict(params, layers=fuse_projections(params["layers"]))
        self.ranks = None
        if self.tp_size > 1:  # one weight shard and rope table per rank, on its device
            devs = self.placement.devices
            self.ranks = [
                TPRank(dev, shard, make_rope_table(mcfg, dev))
                for dev, shard in zip(devs, shard_params(params, mcfg, self.tp_size, devs))
            ]
            params = None
        self.params = params  # the whole tree (tp 1); under tp the ranks hold the shards
        self.rope_table = make_rope_table(mcfg, device)
        self.kv = None
        self.num_blocks = 0
        if pcfg.num_kvcache_blocks > 0:  # a fixed pool needs no shared budget
            self.allocate_kv(pcfg.num_kvcache_blocks)

    def _resolve_schedule(self, pcfg: PearlConfig, mcfg: ModelConfig) -> None:
        """The kernel schedule from the profile and the environment
        overrides (module doc), as the JAX package's runner resolves it."""
        env = os.environ
        throughput = pcfg.perf_profile == "throughput"
        mono = env.get("NANO_PEARL_MONO")
        self.use_mono = mono == "1" if mono is not None else throughput
        deferred = env.get("NANO_PEARL_DEFERRED_VERIFY")
        deferred_requested = deferred == "1" if deferred is not None else throughput
        cap = env.get("NANO_PEARL_VERIFY_GROUP_CAP")
        self.verify_group_cap = int(cap) if cap is not None else pcfg.verify_group_cap
        aligned = mcfg.num_key_value_heads // self.tp_size * mcfg.head_dim % 128 == 0  # a rank's heads
        plain_cache = mcfg.kv_quant is None
        split_requested = env.get("NANO_PEARL_SPLIT") == "1"
        self.split = split_requested and not self.use_mono and plain_cache and aligned and self.tp_size == 1
        self.deferred_verify = (deferred_requested or self.split) and aligned and plain_cache
        self.verify_rowwise = env.get("NANO_PEARL_VERIFY_ROWWISE", "0") == "1"
        if self.verify_rowwise:
            self.deferred_verify = False
        self.fresh_mode = env.get("NANO_PEARL_FRESH_MODE", "merge")
        # the packed verify's MoE dispatch (module doc): sorted only where
        # acceptance does not rest on decode and verify rounding alike
        self.moe_ragged_verify = throughput
        dropped = [name for name, requested, on in (
            ("NANO_PEARL_SPLIT", split_requested, self.split),
            ("NANO_PEARL_DEFERRED_VERIFY", deferred == "1", self.deferred_verify),
        ) if requested and not on]
        if dropped:
            logger.info(
                f"[{self.name}] {', '.join(dropped)} off: the split schedule needs the db schedule "
                "(not mono) and tp 1, both an unquantized cache and Hkv/tp*D % 128 == 0, and the "
                "deferred verify no NANO_PEARL_VERIFY_ROWWISE"
            )
        if self.sp_size > 1:
            sp_dropped = [name for name, on in (
                ("the split schedule", self.split), ("the deferred verify", self.deferred_verify),
                ("the mono schedule", self.use_mono),
            ) if on]
            self.split = self.deferred_verify = self.use_mono = False
            if sp_dropped:
                logger.info(
                    f"[{self.name}] {', '.join(sp_dropped)} off under sequence parallelism "
                    f"(sp {self.sp_size}): its attention runs the per-shard partials kernels "
                    "and the classic verify, as in the JAX package"
                )

    @property
    def block_bytes(self) -> int:
        """Bytes of one KV block over all layers (K and V). A quantized cache
        holds ``Hkv * (D + 2)`` bytes a slot: 1-byte values and one bf16
        scale per KV head."""
        mcfg = self.cfg
        hkv, d = mcfg.num_key_value_heads, mcfg.head_dim
        per_slot = hkv * (d + 2) if mcfg.kv_quant else hkv * d * torch_dtype(mcfg).itemsize
        return mcfg.num_hidden_layers * 2 * self.block_size * per_slot

    def allocate_kv(self, num_blocks: int) -> None:
        """The paged cache of ``num_blocks`` blocks plus the garbage block;
        under sp sharded over the placement's devices, the count rounded
        first (``sp_num_blocks``)."""
        mcfg = self.cfg
        num_blocks = sp_num_blocks(num_blocks, self.sp_size)
        self.num_blocks = num_blocks
        dims = (mcfg.num_hidden_layers, num_blocks, self.block_size, mcfg.num_key_value_heads, mcfg.head_dim)
        if self.sp_size > 1:
            self.kv = make_sharded_kv_cache(
                *dims, self.sp_size, dtype=torch_dtype(mcfg), device=list(self.placement.devices),
                quant=mcfg.kv_quant,
            )
        elif self.tp_size > 1:  # each rank's KV heads on its device
            local = (*dims[:3], mcfg.num_key_value_heads // self.tp_size, mcfg.head_dim)
            self.kv = TPKVCache(tuple(
                make_kv_cache(*local, dtype=torch_dtype(mcfg), device=r.device, quant=mcfg.kv_quant)
                for r in self.ranks
            ))
        else:
            self.kv = make_kv_cache(*dims, dtype=torch_dtype(mcfg), device=self.device, quant=mcfg.kv_quant)
        self.garbage_block = num_blocks  # the extra block of make_kv_cache
        shards = f", {self.sp_size} shards" if self.sp_size > 1 else ""
        shards += f", {self.tp_size} tp ranks" if self.tp_size > 1 else ""
        logger.info(
            f"[{self.name}] kv cache: {num_blocks} blocks x {self.block_size} tokens "
            f"({cache_nbytes(self.kv) / 2**30:.2f} GiB{', ' + mcfg.kv_quant if mcfg.kv_quant else ''}"
            f"{shards})",
            color="green",
        )

    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def _forward(self, tokens, positions, slots, attn_fn, attn_args, kv_write_fns=None, moe_ragged=False):
        """The decoder stack over the group: ``forward`` on one device, or
        ``forward_tp`` over the tensor-parallel ranks. ``kv_write_fns``: one
        K/V hook per rank (one without tp); default: the runner's cache
        write. Returns the final hidden, under tp {device: hidden}."""
        fns = kv_write_fns or [self._kv_write] * self.tp_size
        if self.tp_size > 1:
            return forward_tp(self.cfg, self.ranks, self.kv.ranks, tokens, positions, slots, attn_fn, attn_args, fns)
        return forward(
            self.cfg, self.params, self.kv, tokens, positions, slots, self.rope_table, attn_fn, attn_args,
            kv_write_fn=fns[0], moe_ragged=moe_ragged,
        )

    def _logits(self, hidden, rows: torch.Tensor | None = None) -> torch.Tensor:
        """Logits of ``hidden`` (``_forward``'s output; ``rows``: only those
        rows) on the runner's device, the padded vocab masked."""
        if self.tp_size > 1:
            if rows is not None:
                hidden = {dev: h[rows.to(dev)] for dev, h in hidden.items()}
            return compute_logits_tp(self.cfg, self.ranks, hidden, self.device)
        return compute_logits(self.cfg, self.params, hidden if rows is None else hidden[rows])

    # ------------------------------------------------------------- phases

    def prefill(
        self, views: list[SeqView], lq_pad: int, b_pad: int, limit: int | None = None
    ) -> torch.Tensor:
        """Prefill the uncached tokens of ``views``; returns logits [b_pad, V]
        at each view's last processed row. A batch with no cache hit takes
        the fresh-KV kernel K3; otherwise K4 reads the cached prefix out of
        the cache, also where one view's cached blocks are written by
        another view of this batch: every layer stores its K/V before its
        attention runs. ``limit`` caps the new tokens of each view (a
        chunked-prefill pass); the caller advances ``num_cached_tokens`` and
        discards the logits."""
        bs = self.block_size
        # K4 reads the first m_pre table columns, a power of two covering
        # the longest cached prefix; the rest of each row is the garbage block
        m_pre = next_pow2(max(1, -(-max(v.num_cached_tokens for v in views) // bs)))
        tokens = np.zeros((b_pad, lq_pad), np.int32)
        positions = np.zeros((b_pad, lq_pad), np.int32)
        q_positions = np.full((b_pad, lq_pad), -1, np.int32)
        slots = np.full((b_pad, lq_pad), self.garbage_block * bs, np.int32)
        block_tables = np.full((b_pad, m_pre), self.garbage_block, np.int32)
        num_cached = np.zeros((b_pad,), np.int32)
        n_new = np.zeros((b_pad,), np.int32)
        sel_rows = np.zeros((b_pad,), np.int64)
        for i, v in enumerate(views):
            start = v.num_cached_tokens
            end = len(v) if limit is None else min(start + limit, len(v))
            n = end - start
            if not 0 < n <= lq_pad:
                raise ValueError(f"[{self.name}] {n} new tokens do not fit {lq_pad} rows")
            tokens[i, :n] = v.token_ids[start:end]
            positions[i, :n] = np.arange(start, end)
            q_positions[i, :n] = positions[i, :n]
            slots[i, :n] = [v.token_to_slot(t) for t in range(start, end)]
            prefix_pages = v.block_table[:m_pre]
            block_tables[i, : len(prefix_pages)] = prefix_pages
            num_cached[i], n_new[i] = start, n
            sel_rows[i] = i * lq_pad + n - 1
        if not num_cached.any():
            attn_fn, attn_args = _fresh_prefill, (self._tensor(q_positions), self.scale)
        elif self.sp_size > 1:
            # every view's whole table: the keys come out of the sharded cache
            m = max(len(v.block_table) for v in views)
            tables = np.full((b_pad, m), self.garbage_block, np.int32)
            for i, v in enumerate(views):
                tables[i, : len(v.block_table)] = v.block_table
            tables = self._tensor(tables)
            attn_fn = sp_prefill_attention
            attn_args = (tables, self._tensor(q_positions), self.scale, shard_tables(tables, self.kv))
        else:
            attn_fn = _prefix_prefill
            attn_args = (
                self._tensor(block_tables), self._tensor(num_cached), self._tensor(n_new),
                self.scale,
            )
        hidden = self._forward(
            self._tensor(tokens.reshape(-1)), self._tensor(positions.reshape(-1)), self._tensor(slots.reshape(-1)),
            attn_fn, attn_args, moe_ragged=True,
        )
        return self._logits(hidden, self._tensor(sel_rows, torch.long))

    def decode_step(self, tokens, positions, slots, block_tables, context_lens, b1=None) -> torch.Tensor:
        """One decode step over B rows (device tensors); returns logits [B, V].
        Attention through K5 on the mono schedule, K1 otherwise (K9c and K9a
        over a quantized cache); with ``b1`` (the gamma-scan under the split
        schedule, engine/fused.py) through K8a, each row's key stream cut
        at its b1."""
        if self.sp_size > 1:
            attn = sp_paged_attention
            args = (block_tables, context_lens, self.scale, shard_tables(block_tables, self.kv))
        elif b1 is not None:
            attn, args = _split_decode, (block_tables, context_lens, b1, self.scale)
        else:
            attn = paged_attention_mono if self.use_mono else paged_attention
            args = (block_tables, context_lens, self.scale)
        return self._logits(self._forward(tokens, positions, slots, attn, args))

    def _verify_chunking(self, b: int, gamma: int) -> tuple[int, int]:
        """(chunks, sequence groups per chunk) of the packed verify of b
        sequences: chunks of ``verify_group_cap`` groups, the last one
        padded, so that every chunk runs its products at one row count
        whatever the batch. The draft's decode pads to the same count, and a
        window drafted at one batch size may be verified at another (the
        batch changes between serving steps). Unchunked without a cap, or
        when ``cap * gamma < 8`` rows would fall out of the GEMM shape class
        the cap exists to hit."""
        cap = self.verify_group_cap
        if not cap or cap * gamma < 8:
            return 1, b
        return -(-b // cap), cap

    def verify_chunk_rows(self, b: int, gamma: int) -> int:
        """Rows of one packed-verify chunk of a b-sequence batch."""
        return self._verify_chunking(b, gamma)[1] * gamma

    def decode_call_rows(self, b: int, gamma: int) -> int:
        """Rows of one gamma-scan decode call over b rows: one verify chunk's
        rows while a cap chunks the verify, so that the draft's decode and
        the target's verify run their products at one shape (the ceiling
        profile's bitwise agreement, engine/fused.py); without a cap (the
        throughput profile's default) the b rows of the batch bucket, as
        the JAX package decodes."""
        return self.verify_chunk_rows(b, gamma) if self.verify_group_cap else b

    def verify_chunks(self, tokens, positions, slots, block_tables, context_lens, gamma: int):
        """The packed verify's inputs cut into chunks: a list of (tokens,
        positions, slots, block_tables, context_lens) of one chunk each,
        the last padded with groups at position 0 with context 1 in the
        garbage block."""
        b = block_tables.shape[0]
        k, groups = self._verify_chunking(b, gamma)
        pad = k * groups - b
        if pad:
            dev, n = tokens.device, pad * gamma
            zeros = torch.zeros(n, dtype=tokens.dtype, device=dev)
            garbage = self.garbage_block * self.block_size
            tokens, positions = torch.cat([tokens, zeros]), torch.cat([positions, zeros])
            slots = torch.cat([slots, garbage + torch.arange(n, dtype=slots.dtype, device=dev) % gamma])
            context_lens = torch.cat([context_lens, zeros + 1])
            block_tables = torch.cat([block_tables, torch.full(
                (pad, block_tables.shape[1]), self.garbage_block, dtype=block_tables.dtype, device=dev
            )])
        r = groups * gamma
        return [
            (tokens[c * r : (c + 1) * r], positions[c * r : (c + 1) * r], slots[c * r : (c + 1) * r],
             block_tables[c * groups : (c + 1) * groups], context_lens[c * r : (c + 1) * r])
            for c in range(k)
        ]

    def packed_verify_forward(
        self, tokens, positions, slots, block_tables, context_lens, gamma: int
    ) -> torch.Tensor:
        """The target's packed verify on flat [B*gamma] rows; returns the
        logits [B*gamma, V]. Chunks are disjoint sequences, so the only
        state they share is the cache, written chunk after chunk. The LM
        head runs per chunk too, so every product of the verify has the
        chunk's row count. Each chunk runs the deferred-write forward under
        the throughput profile, the classic write-then-read one otherwise."""
        fwd = self._deferred_forward if self.deferred_verify else self._classic_forward
        logits = [
            self._logits(fwd(*chunk, gamma))
            for chunk in self.verify_chunks(
                tokens, positions, slots, block_tables, context_lens, gamma
            )
        ]
        out = logits[0] if len(logits) == 1 else torch.cat(logits)
        return out[: tokens.shape[0]]

    def _classic_forward(self, tokens, positions, slots, block_tables, context_lens, gamma):
        """Each layer writes its K/V into the cache, then K2 reads the
        group's context back through the block table (K9b over a quantized
        cache; on the mono schedule, which takes this verify only over a
        quantized cache or under an override, K5 / K9c). Under
        ``NANO_PEARL_VERIFY_ROWWISE`` the decode kernel reads it instead,
        each row through its group's table repeated. Under sp the per-shard
        partials kernels read it (K11c, or K11a with the table repeated)
        and the shards merge."""
        if self.sp_size > 1 and self.verify_rowwise:
            rows = block_tables.repeat_interleave(gamma, 0)
            attn, args = sp_paged_attention, (rows, context_lens, self.scale, shard_tables(rows, self.kv))
        elif self.sp_size > 1:
            attn = sp_paged_attention_grouped
            args = (block_tables, context_lens, self.scale, gamma, shard_tables(block_tables, self.kv))
        elif self.verify_rowwise:
            attn = paged_attention_mono if self.use_mono else paged_attention
            rows = block_tables.repeat_interleave(gamma, 0)
            args = (rows, context_lens, self.scale)
        else:
            attn = paged_attention_mono if self.use_mono else paged_attention_grouped
            args = (block_tables, context_lens, self.scale, gamma)
        return self._forward(tokens, positions, slots, attn, args, moe_ragged=self.moe_ragged_verify)

    def _deferred_forward(self, tokens, positions, slots, block_tables, context_lens, gamma):
        """Deferred-write packed verify of one chunk (``_deferred_forward``
        of the JAX package): each layer collects its fresh K/V into a dense
        [L, 2, N, Hkv*D] buffer and leaves the cache alone; attention reads
        the pre-round cache plus the fresh window
        (``paged_attention_grouped_fresh``); one writeback stores the whole
        round after the layers (K12)."""
        cfg = self.cfg
        n = tokens.shape[0]
        b = n // gamma
        # pre-round context per group: row 0 is always a real row whose
        # context holds exactly itself of the fresh window
        ctx0 = context_lens.reshape(b, gamma)[:, 0] - 1
        caches = self.kv.ranks if self.tp_size > 1 else (self.kv,)
        hd = cfg.num_key_value_heads // self.tp_size * cfg.head_dim
        fresh = [
            torch.empty((cfg.num_hidden_layers, 2, n, hd), dtype=c.dtype, device=c.device) for c in caches
        ]  # one buffer per rank (one without tp)

        def collector(buf):
            def collect(cache, k, v, slots, li):
                torch.stack((k.reshape(n, hd), v.reshape(n, hd)), out=buf[li])

            return collect

        hidden = self._forward(
            tokens, positions, slots, _deferred_attn,
            (block_tables, context_lens, ctx0, self.scale, gamma, self.fresh_schedule),
            kv_write_fns=[collector(buf) for buf in fresh], moe_ragged=self.moe_ragged_verify,
        )
        for cache, buf in zip(caches, fresh):
            write_fresh(cache, buf, slots.to(buf.device))
        return hidden

    @property
    def fresh_schedule(self) -> dict:
        """The deferred verify's kernel choice (``paged_attention_grouped_fresh``)."""
        return dict(mono=self.use_mono, split=self.split, fresh_mode=self.fresh_mode)

    # ------------------------------------------- per-view entry points
    # The overlap loop (engine/pearl.py pearl_round) and the per-step AR
    # build each call's inputs from the host's SeqViews, as the JAX
    # package's runner does (its runner.py:963-1055). Every tensor is made
    # on the caller's current stream, the one that reads it.

    def _decode_arrays(self, views: list[SeqView], b_pad: int, m_pad: int, with_slots: bool):
        """(tokens, positions, context_lens, block_tables, slots) of one
        decode step at each view's last token; padded rows sit at position
        0 with context 1 in the garbage block."""
        bs = self.block_size
        tokens = np.zeros((b_pad,), np.int32)
        positions = np.zeros((b_pad,), np.int32)
        context_lens = np.ones((b_pad,), np.int32)
        block_tables = np.full((b_pad, m_pad), self.garbage_block, np.int32)
        slots = np.full((b_pad,), self.garbage_block * bs, np.int32)
        for i, v in enumerate(views):
            n = len(v)
            tokens[i] = v.last_token
            positions[i] = n - 1
            context_lens[i] = n
            block_tables[i, : len(v.block_table)] = v.block_table
            if with_slots:
                slots[i] = v.token_to_slot(n - 1)
        return tokens, positions, context_lens, block_tables, slots

    def decode(self, views: list[SeqView], b_pad: int, m_pad: int) -> torch.Tensor:
        """One AR decode step over ``views``; returns logits [b_pad, V]."""
        tokens, positions, ctx, bt, slots = map(self._tensor, self._decode_arrays(views, b_pad, m_pad, True))
        return self.decode_step(tokens, positions, slots, bt, ctx)

    def gamma_scan(self, views: list[SeqView], gamma: int, b_pad: int, m_pad: int, is_pre: np.ndarray,
                   scan) -> torch.Tensor:
        """The draft's round over ``views``: ``scan`` is the fused loop's
        gamma-scan (``FusedPearl._draft_gamma``), so decode calls, their
        rows and the split schedule's step-0 boundary ``b1 = len -
        num_input`` are the fused loop's. Block tables must already cover
        len + gamma tokens. Returns the draft tokens [b_pad, gamma]."""
        tokens, positions, ctx, bt, _ = self._decode_arrays(views, b_pad, m_pad, False)
        b1 = np.zeros((b_pad,), np.int32)
        for i, v in enumerate(views):
            b1[i] = len(v) - (1 if is_pre[i] else gamma)
        return scan(*map(self._tensor, (tokens, positions, bt, ctx)), gamma, b1=self._tensor(b1))

    def verify_forward(self, views: list[SeqView], is_pre: np.ndarray, gamma: int, b_pad: int,
                       m_pad: int) -> torch.Tensor:
        """The target's packed verify over each view's last ``num_input``
        tokens (1 before verify, else gamma); returns logits [b_pad, gamma,
        V], row j of sequence i after token len - num_input + j. Padded rows
        take distinct slots of the garbage block, as the fused loop's."""
        bs = self.block_size
        tokens = np.zeros((b_pad, gamma), np.int32)
        positions = np.zeros((b_pad, gamma), np.int32)
        context_lens = np.ones((b_pad, gamma), np.int32)
        slots = np.tile(self.garbage_block * bs + np.arange(gamma, dtype=np.int32) % bs, (b_pad, 1))
        block_tables = np.full((b_pad, m_pad), self.garbage_block, np.int32)
        for i, v in enumerate(views):
            num_input = 1 if is_pre[i] else gamma
            n = len(v)
            tokens[i, :num_input] = v.token_ids[n - num_input :]
            pos = np.arange(n - num_input, n)
            positions[i, :num_input] = pos
            context_lens[i, :num_input] = pos + 1
            slots[i, :num_input] = [v.token_to_slot(p) for p in pos]
            block_tables[i, : len(v.block_table)] = v.block_table
        flat = lambda a: self._tensor(a.reshape(-1))  # noqa: E731
        logits = self.packed_verify_forward(
            flat(tokens), flat(positions), flat(slots), self._tensor(block_tables), flat(context_lens), gamma
        )
        return logits.reshape(b_pad, gamma, -1)

    def verdict(self, logits, tbv, is_pre, temps, num_completion, max_tokens, ignore_eos, gamma: int,
                generator: torch.Generator | None, top_ks=None, top_ps=None, stops=None,
                r=None, gumbel=None) -> VerifyResult:
        """The verdict of one round on ``logits`` [b_pad, gamma, V] (host
        arrays for the rest). ``top_ks``/``top_ps`` None: no row filters;
        ``stops``: the per-request [B, S] stop matrix (EOS plus the
        request's stop tokens, -1 padded), None: the global EOS list.
        ``r``/``gumbel`` replace the drawn noise (tests)."""
        greedy_only = bool(np.all(np.asarray(temps) == 0.0))
        t = self._tensor(temps, torch.float32)
        if top_ks is not None and not greedy_only:
            logits = apply_top_k_top_p(
                logits, self._tensor(top_ks)[:, None], self._tensor(top_ps, torch.float32)[:, None], t[:, None]
            )
        eos = stops if stops is not None else self.cfg.eos_ids
        return verify_verdict(
            logits, self._tensor(tbv), self._tensor(is_pre, torch.bool), t, self._tensor(num_completion),
            self._tensor(max_tokens), self._tensor(ignore_eos, torch.bool), self._tensor(eos), gamma,
            greedy=greedy_only, generator=generator, r=r, gumbel=gumbel,
        )

    def sample_tokens(
        self, logits, temps: np.ndarray, generator: torch.Generator | None,
        top_ks: np.ndarray | None = None, top_ps: np.ndarray | None = None,
    ):
        """Greedy when every row is at T=0, else Gumbel-max sampling of the
        top-k/top-p filtered logits (``top_ks``/``top_ps`` None: unfiltered)."""
        if np.all(np.asarray(temps) == 0.0):
            return greedy(logits)
        t = self._tensor(temps, torch.float32)
        if top_ks is not None:
            logits = apply_top_k_top_p(
                logits, self._tensor(top_ks), self._tensor(top_ps, torch.float32), t
            )
        return sample(logits, t, generator=generator)


def _fresh_prefill(q, k, v, q_positions, scale):
    return prefill_self_attention(q, k, v, q_positions, scale)


_fresh_prefill.wants_fresh_kv = True


def _prefix_prefill(q, k, v, cache, layer_idx, bt_pre, num_cached, n_new, scale):
    return prefill_prefix_attention(q, k, v, cache, layer_idx, bt_pre, num_cached, n_new, scale)


_prefix_prefill.wants_fresh_and_cache = True


def _deferred_attn(q, k, v, cache, layer_idx, group_tables, context_lens, ctx0, scale, gamma, schedule):
    return paged_attention_grouped_fresh(
        q, cache, layer_idx, group_tables, context_lens, ctx0, k, v, scale, gamma, **schedule
    )


_deferred_attn.wants_fresh_and_cache = True


def _split_decode(q, cache, layer_idx, block_tables, context_lens, b1, scale):
    return paged_attention_split(q, cache, layer_idx, block_tables, context_lens, b1, scale)
