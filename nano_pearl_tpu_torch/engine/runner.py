"""Per-model device runner: weights, paged KV cache and step functions
(counterpart of nano_pearl_tpu/engine/runner.py, "ceiling" profile).

One ``GroupRunner`` owns one model's weights, rope table and KV cache on
one device and runs its phases eagerly:

- ``prefill``: fresh-KV prefill of a batch (no prefix-cache hits);
- ``decode_step``: one decode step over B rows (AR and the draft's
  gamma-scan, a Python loop of these steps in engine/fused.py);
- ``packed_verify_forward``: the target's classic write-then-read packed
  verify, cut into chunks of at most ``verify_group_cap`` sequences so
  B=32 runs as two chunks of 16 groups.

Prefix-cache hits and chunked prefill need the paged-prefix prefill
kernel, which is not ported yet; they raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from nano_pearl_tpu_torch.config import ModelConfig, PearlConfig
from nano_pearl_tpu_torch.engine.sequence import SeqView
from nano_pearl_tpu_torch.models.transformer import (
    check_supported,
    compute_logits,
    forward,
    init_params_numpy,
    make_rope_table,
    params_from_numpy,
    torch_dtype,
)
from nano_pearl_tpu_torch.ops.attention import (
    paged_attention,
    paged_attention_grouped,
    prefill_self_attention,
)
from nano_pearl_tpu_torch.ops.kv_cache import make_kv_cache
from nano_pearl_tpu_torch.ops.sampling import greedy, sample
from nano_pearl_tpu_torch.utils.logging import logger

_DEFAULT_CPU_BLOCKS = 512


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _is_numpy_tree(params: dict) -> bool:
    return isinstance(params["embed"], np.ndarray)


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
    ):
        check_supported(mcfg)
        self.pcfg = pcfg
        self.cfg = mcfg
        self.device = device
        self.name = name
        self.block_size = pcfg.kvcache_block_size
        self.scale = mcfg.head_dim**-0.5
        self.verify_group_cap = pcfg.verify_group_cap
        if params is None:
            logger.warning(f"[{name}] no weights given; random-initializing")
            params = init_params_numpy(mcfg, np.random.default_rng(seed))
        if _is_numpy_tree(params):
            params = params_from_numpy(params, mcfg, device)
        self.params = params
        self.rope_table = make_rope_table(mcfg, device)
        self.num_blocks = self._decide_num_blocks()
        self.kv = make_kv_cache(
            mcfg.num_hidden_layers, self.num_blocks, self.block_size,
            mcfg.num_key_value_heads, mcfg.head_dim, dtype=torch_dtype(mcfg),
            device=device,
        )
        self.garbage_block = self.num_blocks  # the extra block of make_kv_cache
        logger.info(
            f"[{name}] kv cache: {self.num_blocks} blocks x {self.block_size} tokens "
            f"({self.kv.numel() * self.kv.element_size() / 2**30:.2f} GiB)",
            color="green",
        )

    def _decide_num_blocks(self) -> int:
        pcfg, mcfg = self.pcfg, self.cfg
        if pcfg.num_kvcache_blocks > 0:
            return pcfg.num_kvcache_blocks
        if self.device.type != "cuda":
            return _DEFAULT_CPU_BLOCKS
        # from the device's free memory, like the reference's allocate_kv_cache
        free, total = torch.cuda.mem_get_info(self.device)
        budget = total * pcfg.hbm_utilization - (total - free)
        per_slot = mcfg.num_key_value_heads * mcfg.head_dim * torch_dtype(mcfg).itemsize
        block_bytes = mcfg.num_hidden_layers * 2 * self.block_size * per_slot
        num = int(budget) // block_bytes
        if num <= 0:
            raise RuntimeError(f"[{self.name}] not enough device memory for any KV block")
        return num

    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    # ------------------------------------------------------------- phases

    def prefill(
        self, views: list[SeqView], lq_pad: int, b_pad: int, fresh_only: bool = True
    ) -> torch.Tensor:
        """Fresh-KV prefill of ``views``; returns logits [b_pad, V] at each
        sequence's last prompt row."""
        if not fresh_only or any(v.num_cached_tokens for v in views):
            raise NotImplementedError(
                "prefix-cache hits need the paged-prefix prefill kernel (not ported yet)"
            )
        bs = self.block_size
        tokens = np.zeros((b_pad, lq_pad), np.int32)
        positions = np.zeros((b_pad, lq_pad), np.int32)
        q_positions = np.full((b_pad, lq_pad), -1, np.int32)
        slots = np.full((b_pad, lq_pad), self.garbage_block * bs, np.int32)
        sel_rows = np.zeros((b_pad,), np.int64)
        for i, v in enumerate(views):
            n = len(v.token_ids)
            if not 0 < n <= lq_pad:
                raise ValueError(f"[{self.name}] prompt of {n} tokens does not fit {lq_pad} rows")
            tokens[i, :n] = v.token_ids
            positions[i, :n] = np.arange(n)
            q_positions[i, :n] = positions[i, :n]
            slots[i, :n] = [v.token_to_slot(t) for t in range(n)]
            sel_rows[i] = i * lq_pad + n - 1
        hidden = forward(
            self.cfg, self.params, self.kv, self._tensor(tokens.reshape(-1)),
            self._tensor(positions.reshape(-1)), self._tensor(slots.reshape(-1)),
            self.rope_table, _fresh_prefill, (self._tensor(q_positions), self.scale),
        )
        return compute_logits(self.cfg, self.params, hidden[self._tensor(sel_rows, torch.long)])

    def decode_step(self, tokens, positions, slots, block_tables, context_lens) -> torch.Tensor:
        """One decode step over B rows (device tensors); returns logits [B, V]."""
        hidden = forward(
            self.cfg, self.params, self.kv, tokens, positions, slots, self.rope_table,
            paged_attention, (block_tables, context_lens, self.scale),
        )
        return compute_logits(self.cfg, self.params, hidden)

    def _verify_chunks(self, b: int, gamma: int) -> int:
        """Number of sequence chunks of the packed verify (1 = unchunked)."""
        cap = self.verify_group_cap
        if not cap or b <= cap:
            return 1
        k = -(-b // cap)
        while b % k:
            k += 1
        if (b // k) * gamma < 8:
            # chunks this small fall out of the GEMM shape class the cap
            # exists to hit: run unchunked
            logger.warning(
                f"[{self.name}] verify_group_cap={cap}: batch {b} only divides into "
                f"{b // k}-group chunks ({b // k * gamma} rows < 8); verify runs unchunked"
            )
            return 1
        return k

    def packed_verify_forward(
        self, tokens, positions, slots, block_tables, context_lens, gamma: int
    ) -> torch.Tensor:
        """The target's packed verify on flat [B*gamma] rows; returns the
        hidden [B*gamma, H]. Chunks are disjoint sequences, so the only
        state they share is the cache, written chunk after chunk."""
        b = block_tables.shape[0]
        k = self._verify_chunks(b, gamma)
        nc, bc = tokens.shape[0] // k, b // k
        hiddens = []
        for c in range(k):
            rows = slice(c * nc, (c + 1) * nc)
            hiddens.append(forward(
                self.cfg, self.params, self.kv, tokens[rows], positions[rows], slots[rows],
                self.rope_table, paged_attention_grouped,
                (block_tables[c * bc : (c + 1) * bc], context_lens[rows], self.scale, gamma),
            ))
        return hiddens[0] if k == 1 else torch.cat(hiddens)

    def sample_tokens(self, logits, temps: np.ndarray, generator: torch.Generator | None):
        if np.all(np.asarray(temps) == 0.0):
            return greedy(logits)
        return sample(logits, self._tensor(temps, torch.float32), generator=generator)


def _fresh_prefill(q, k, v, q_positions, scale):
    return prefill_self_attention(q, k, v, q_positions, scale)


_fresh_prefill.wants_fresh_kv = True
