"""Request scheduler (reference: nano_pearl/pearl_engine/scheduler.py).

Single-controller redesign: the reference replicates an identical
scheduler into every worker and relies on deterministic replay for
coherence; here ONE scheduler coordinates both model groups' block
managers, so admission decisions are consistent by construction. A
sequence is admitted only when BOTH groups can allocate its prompt
blocks (the reference implicitly assumes this because each replica
checks its own pool and they must agree).

``PearlConfig.native_block_manager`` swaps both pools' Python
``BlockManager`` for the C++ one (engine/native.py), which takes the same
decisions; a failed build of it raises.
"""

from __future__ import annotations

from collections import deque

from nano_pearl_tpu_torch.config import PearlConfig
from nano_pearl_tpu_torch.engine.block_manager import BlockManager
from nano_pearl_tpu_torch.engine.sequence import Sequence, SequenceStatus
from nano_pearl_tpu_torch.utils.logging import logger


def is_eos(token_id: int, eos_ids: list[int]) -> bool:
    return token_id in eos_ids


class Scheduler:
    def __init__(self, config: PearlConfig, draft_blocks: int, target_blocks: int):
        self.max_num_seqs = config.max_num_seqs
        self.max_num_batched_tokens = config.max_num_batched_tokens
        self.eos = config.eos
        self.block_size = config.kvcache_block_size
        manager = BlockManager
        if config.native_block_manager:
            # the C++ manager or an error: no fallback to the Python one
            from nano_pearl_tpu_torch.engine.native import NativeBlockManager as manager
        self.draft_bm = manager(draft_blocks, self.block_size, config.draft_sp)
        self.target_bm = manager(target_blocks, self.block_size, config.target_sp)
        self.waiting: deque[Sequence] = deque()
        self.running: deque[Sequence] = deque()
        self.finished: list[Sequence] = []

    def is_finished(self) -> bool:
        return not self.waiting and not self.running

    def add(self, seq: Sequence):
        self.waiting.append(seq)

    # ---- prefill admission (reference: scheduler.py:32-51) ----
    def schedule_prefill(self) -> list[Sequence]:
        scheduled: list[Sequence] = []
        num_tokens = 0
        # NB: admitted seqs join self.running inside the loop, so the seat
        # check must use the count of seqs that were running BEFORE this
        # admission pass (counting running+scheduled would tally each
        # admitted seq twice and halve every batch).
        already_running = len(self.running)
        # blocks the already-scheduled seqs will WRITE during this batch's
        # forward: a later seq whose prefix-cache hit lands on one of them
        # would read blocks not yet written — defer it one batch instead,
        # by which time the blocks are written.
        written_d: set[int] = set()
        written_t: set[int] = set()
        while self.waiting and already_running + len(scheduled) < self.max_num_seqs:
            seq = self.waiting[0]
            new_tokens = len(seq.target)  # upper bound; prefix hits reduce it
            # A prompt larger than the whole token budget can never satisfy
            # the sum check: admit it ALONE and let prefill_all process it
            # in block-aligned chunks (chunked prefill — the reference
            # cannot admit these at all: scheduler.py:39 plus the single
            # prefill() call per generate).
            oversized = new_tokens > self.max_num_batched_tokens
            if oversized and scheduled:
                break
            if not oversized and num_tokens + new_tokens > self.max_num_batched_tokens:
                break
            if not (self.draft_bm.can_allocate(seq.draft) and self.target_bm.can_allocate(seq.target)):
                logger.warning("prefill admission blocked: out of KV blocks")
                break
            self.draft_bm.allocate(seq.draft)
            self.target_bm.allocate(seq.target)
            if scheduled and (
                written_d.intersection(
                    seq.draft.block_table[: seq.draft.num_cached_blocks]
                )
                or written_t.intersection(
                    seq.target.block_table[: seq.target.num_cached_blocks]
                )
            ):
                # within-batch prefix sharing: defer to the next batch
                self.draft_bm.deallocate(seq.draft)
                self.target_bm.deallocate(seq.target)
                break
            written_d.update(
                seq.draft.block_table[seq.draft.num_cached_blocks:]
            )
            written_t.update(
                seq.target.block_table[seq.target.num_cached_blocks:]
            )
            num_tokens += max(
                len(seq.draft) - seq.draft.num_cached_tokens,
                len(seq.target) - seq.target.num_cached_tokens,
            )
            seq.status = SequenceStatus.RUNNING
            self.waiting.popleft()
            self.running.append(seq)
            scheduled.append(seq)
            if oversized:
                break
        return scheduled

    # ---- AR decode batch with preemption (reference: scheduler.py:53-67) ----
    def schedule_decode(
        self, lookahead=1, *, ar_only: bool = False, strict: bool = True
    ) -> list[Sequence]:
        """Reserve ``lookahead`` tokens of KV growth (an int, or a
        per-sequence callable — the fused loop reserves whole chunks of
        rounds) for every running sequence, preempting from the tail of
        the batch when blocks run out. ``ar_only`` skips the draft pool
        (target-only AR baseline: draft views own no blocks). With
        ``strict=False`` (continuous serving) an empty result is returned
        instead of asserting — preempted requests simply wait in the
        queue for blocks to free up."""
        need = lookahead if callable(lookahead) else (lambda s: lookahead)
        scheduled: list[Sequence] = []
        batch = list(self.running)
        for seq in batch:
            if seq.status != SequenceStatus.RUNNING:
                continue  # preempted as a victim earlier in this pass
            while not (
                (ar_only or self.draft_bm.can_ensure(seq.draft, need(seq)))
                and self.target_bm.can_ensure(seq.target, need(seq))
            ):
                victim = None
                for cand in reversed(self.running):
                    if cand is not seq and cand not in scheduled:
                        victim = cand
                        break
                self.preempt(victim if victim is not None else seq)
                if victim is None:
                    break
            else:
                if not ar_only:
                    self.draft_bm.ensure_capacity(seq.draft, need(seq))
                self.target_bm.ensure_capacity(seq.target, need(seq))
                scheduled.append(seq)
        if strict:
            assert scheduled, "decode scheduled nothing (all sequences preempted)"
        return scheduled

    def drop_unverified(self, seq: Sequence):
        """Return a request whose last round accepted to the pre-verify
        state: roll its window's unverified tail (``window - 1`` tokens,
        no target KV behind them) back in both views. The last token left
        is verified and becomes the next round's one-token verify input.
        A round at another window checks other positions, and a re-prefill
        after preemption reads the whole stream: either would commit the
        tail unverified."""
        if seq.pre_verify:
            return
        if seq.window > 1:
            self.draft_bm.rollback(seq.draft, seq.window - 1)
            self.target_bm.rollback(seq.target, seq.window - 1)
        seq.pre_verify = True

    def preempt(self, seq: Sequence):
        self.drop_unverified(seq)
        seq.status = SequenceStatus.WAITING
        self.draft_bm.deallocate(seq.draft)
        self.target_bm.deallocate(seq.target)
        self.running.remove(seq)
        self.waiting.appendleft(seq)

    def cancel(self, seq_id: int) -> bool:
        """Abort a request by id (serving control-plane; beyond the
        reference, which has no cancellation). Waiting sequences are
        dropped outright; running sequences release their KV blocks.
        The sequence is NOT added to ``finished`` — its partial output
        is discarded."""
        for seq in self.waiting:
            if seq.seq_id == seq_id:
                seq.status = SequenceStatus.FINISHED
                self.waiting.remove(seq)
                return True
        for seq in self.running:
            if seq.seq_id == seq_id:
                seq.status = SequenceStatus.FINISHED
                self.draft_bm.deallocate(seq.draft)
                self.target_bm.deallocate(seq.target)
                self.running.remove(seq)
                return True
        return False

    def finish(self, seq: Sequence):
        # Per-request stops truncate the completion at the first hit
        # (serving semantics; PEARL's accept-finish may have committed up
        # to gamma tokens past it in the same window). EOS keeps the
        # reference's untrimmed behavior (overshoot <= gamma, deviation
        # documented in PARITY.md). Safe for streaming: the rollback-proof
        # frontier (len - gamma) never passes the stop before finish.
        if seq.stop_token_ids and not seq.ignore_eos:
            comp = seq.completion_token_ids
            for k, t in enumerate(comp):
                if t in seq.stop_token_ids:
                    if len(comp) - (k + 1):
                        seq.target.truncate(len(comp) - (k + 1))
                    break
        seq.status = SequenceStatus.FINISHED
        self.draft_bm.deallocate(seq.draft)
        self.target_bm.deallocate(seq.target)
        self.running.remove(seq)
        self.finished.append(seq)

    # ---- AR postprocess (reference: scheduler.py:74-81) ----
    def postprocess_ar(self, seqs: list[Sequence], token_ids: list[int]):
        """Append one sampled token to the target view (AR mode runs the
        target model only) and finish on EOS/max_tokens."""
        for seq, token_id in zip(seqs, token_ids):
            seq.target.append(token_id)
            stopped = is_eos(token_id, self.eos) or token_id in seq.stop_token_ids
            if (not seq.ignore_eos and stopped) or (
                seq.num_completion_tokens == seq.max_tokens
            ):
                self.finish(seq)

    def clear(self):
        """Reference: scheduler.py:86-99."""
        for q in (list(self.waiting), list(self.running)):
            for seq in q:
                self.draft_bm.deallocate(seq.draft)
                self.target_bm.deallocate(seq.target)
        self.waiting.clear()
        self.running.clear()
        self.finished.clear()
        self.draft_bm.clear_prefix_cache()
        self.target_bm.clear_prefix_cache()
