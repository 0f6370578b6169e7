"""Paged KV block allocator with hash-based prefix caching and PEARL rollback.

Reference: nano_pearl/pearl_engine/block_manager.py. Same capabilities —
chained xxhash64 prefix cache with ref-counting, incremental growth,
rollback that frees whole tail blocks — implemented against ``SeqView``s
(one manager per model group; the draft and target views have
independent block tables over independent device caches).

Capability extension over the reference's ``can_append``/``may_append``
single-token growth: ``ensure_capacity`` grows a view's table by any
number of future tokens in one call, which the PEARL loop uses to
reserve the whole gamma-token draft window before dispatching the
compiled gamma-step scan (no host round-trip per drafted token).

Under sequence parallelism (``shards`` > 1: the device cache's block axis
split into ``shards`` contiguous ranges, ``parallel/sp.py``) a view's
page i is taken from shard ``i % shards`` while that shard has a free
block (any shard's otherwise). The JAX package's manager is shard-blind:
its FIFO free list puts a page in whichever range comes next, so two
pools with different histories (the AR baseline takes target blocks
only) split a sequence's keys between the shards differently, and the
merge of the shards' partials then rounds the draft's decode and the
target's verify apart. Striping keeps the split a function of the page
index alone, and spreads every sequence's keys over the shards.
"""

from __future__ import annotations

import hashlib
from collections import deque

import numpy as np

from nano_pearl_tpu_torch.engine.sequence import SeqView


def chain_hash(token_ids: list[int], prefix: int = -1) -> int:
    """Chained 64-bit block hash (reference: block_manager.py:35-41).
    The JAX package uses xxhash64; the port uses the standard library's
    blake2b cut to 8 bytes, so it needs no package beyond torch and
    numpy. Hash values only key this process's prefix cache."""
    h = hashlib.blake2b(digest_size=8)
    if prefix != -1:
        h.update(prefix.to_bytes(8, "little"))
    h.update(np.asarray(token_ids, dtype=np.int64).tobytes())
    return int.from_bytes(h.digest(), "little")


class _Block:
    __slots__ = ("block_id", "ref_count", "hash", "token_ids")

    def __init__(self, block_id: int):
        self.block_id = block_id
        self.ref_count = 0
        self.hash = -1
        self.token_ids: list[int] = []


class BlockManager:
    def __init__(self, num_blocks: int, block_size: int, shards: int = 1):
        assert num_blocks > 0 and (num_blocks + 1) % shards == 0
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.shards = shards
        self.blocks_per_shard = (num_blocks + 1) // shards  # the garbage block is the last shard's
        self.blocks = [_Block(i) for i in range(num_blocks)]
        self.hash_to_block: dict[int, int] = {}
        self.free_ids: deque[int] = deque(range(num_blocks))
        self.used_ids: set[int] = set()

    @property
    def num_free_blocks(self) -> int:
        return len(self.free_ids)

    def _next_free(self, page: int) -> int:
        """The block for a view's page ``page``: the first free one, from
        shard ``page % shards`` where it has one (module doc)."""
        if self.shards > 1:
            want = page % self.shards
            for block_id in self.free_ids:
                if block_id // self.blocks_per_shard == want:
                    return block_id
        return self.free_ids[0]

    def _take(self, block_id: int) -> _Block:
        blk = self.blocks[block_id]
        assert blk.ref_count == 0
        blk.ref_count = 1
        blk.hash = -1
        blk.token_ids = []
        self.free_ids.remove(block_id)
        self.used_ids.add(block_id)
        return blk

    def _release(self, block_id: int):
        blk = self.blocks[block_id]
        blk.ref_count -= 1
        if blk.ref_count == 0:
            self.used_ids.remove(block_id)
            self.free_ids.append(block_id)

    def can_allocate(self, view: SeqView) -> bool:
        return self.num_free_blocks >= view.num_blocks

    def allocate(self, view: SeqView):
        """Allocate a fresh view's table, reusing prefix-cached full blocks
        (reference: block_manager.py:56-82)."""
        assert not view.block_table
        h = -1
        miss = False
        for i in range(view.num_blocks):
            toks = view.block_tokens(i)
            full = len(toks) == self.block_size
            h = chain_hash(toks, h) if full else -1
            cached = self.hash_to_block.get(h, -1)
            if cached == -1 or self.blocks[cached].token_ids != toks:
                miss = True
            if miss:
                blk = self._take(self._next_free(i))
            else:
                view.num_cached_tokens += self.block_size
                blk = self.blocks[cached]
                if cached in self.used_ids:
                    blk.ref_count += 1
                else:
                    blk = self._take(cached)
            if h != -1:
                blk.hash = h
                blk.token_ids = toks
                self.hash_to_block[h] = blk.block_id
            view.block_table.append(blk.block_id)
        if view.num_cached_tokens == len(view):
            # fully-cached prompt: force at least the last block through
            # prefill so there is a query row to sample from (the
            # reference never hits this because its last block is full
            # only when hashes diverge; our guard makes it explicit)
            view.num_cached_tokens -= self.block_size

    def deallocate(self, view: SeqView):
        for block_id in reversed(view.block_table):
            self._release(block_id)
        view.block_table.clear()
        view.num_cached_tokens = 0

    def rollback(self, view: SeqView, n: int):
        """Truncate n tokens, freeing tail blocks that fall empty
        (reference: block_manager.py:93-106). KV data is never moved.
        The table may hold unfilled lookahead blocks beyond the blocks
        the current length occupies (``ensure_capacity`` reservations) —
        every entry past the new length is released, not just the
        previously-occupied range (releasing only [after:before] while
        deleting [after:] leaked each reservation on reject)."""
        view.truncate(n)
        after = view.num_blocks
        for block_id in view.block_table[after:]:
            self._release(block_id)
        del view.block_table[after:]

    def blocks_needed(self, view: SeqView, extra_tokens: int) -> int:
        """Free blocks ``ensure_capacity(view, extra_tokens)`` would take."""
        return max(0, -(-(len(view) + extra_tokens) // self.block_size) - len(view.block_table))

    def can_ensure(self, view: SeqView, extra_tokens: int) -> bool:
        return self.num_free_blocks >= self.blocks_needed(view, extra_tokens)

    def ensure_capacity(self, view: SeqView, extra_tokens: int):
        """Grow the table to hold ``extra_tokens`` beyond the current
        length, hashing blocks that became full since the last growth
        (generalizes reference may_append, block_manager.py:108-141)."""
        target_blocks = -(-(len(view) + extra_tokens) // self.block_size)
        self._hash_full_blocks(view)
        while len(view.block_table) < target_blocks:
            blk = self._take(self._next_free(len(view.block_table)))
            view.block_table.append(blk.block_id)

    def _hash_full_blocks(self, view: SeqView):
        """Lazily publish hashes for fully-written blocks so later
        requests can prefix-hit them (reference: block_manager.py:125-141)."""
        num_full = len(view) // self.block_size
        for i in range(len(view.block_table)):
            if i >= num_full:
                break
            blk = self.blocks[view.block_table[i]]
            if blk.hash == -1:
                prev = self.blocks[view.block_table[i - 1]].hash if i > 0 else -1
                toks = view.block_tokens(i)
                blk.hash = chain_hash(toks, prev)
                blk.token_ids = toks
                self.hash_to_block[blk.hash] = blk.block_id

    def clear_prefix_cache(self):
        """Reference: scheduler.py:86-99 (clear) wipes hashes."""
        self.hash_to_block.clear()
        for blk in self.blocks:
            blk.hash = -1
            blk.token_ids = []
