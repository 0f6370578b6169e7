"""PEARL orchestration over the fused round loop (counterpart of
nano_pearl_tpu/engine/pearl.py, fused path only).

Draft and target share one device, so every round runs through
``FusedPearl``: the host prefills, builds the device state machine from
the scheduler's sequences, runs chunks of rounds, and pulls the state
back into the host ``Sequence`` objects. Rollback never touches KV
contents: accepted and rolled-back state is length bookkeeping.

Continuous serving (``serve_round``) admits whatever prefills fit and
advances the running batch by a fixed number of fused rounds; prompts
over ``max_num_batched_tokens`` prefill in block-aligned chunk passes.

Not ported yet: the overlap mode (draft and target on separate
devices), acceptance-adaptive gamma and the parallel layouts.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nano_pearl_tpu_torch.config import PearlConfig
from nano_pearl_tpu_torch.engine.fused import FusedPearl
from nano_pearl_tpu_torch.engine.runner import GroupRunner, next_pow2
from nano_pearl_tpu_torch.engine.scheduler import Scheduler, is_eos


class PearlOrchestrator:
    def __init__(
        self,
        pcfg: PearlConfig,
        draft: GroupRunner,
        target: GroupRunner,
        scheduler: Scheduler,
        generator: torch.Generator,
    ):
        self.pcfg = pcfg
        self.draft = draft
        self.target = target
        self.scheduler = scheduler
        self.generator = generator
        self.device = target.device
        self.fused = FusedPearl(pcfg, draft, target)
        self.last_gamma = pcfg.gamma
        # serving counters (engine.stats): prompt tokens served from the
        # prefix cache, and chunked-prefill passes run
        self.prefix_hit_tokens = 0
        self.chunked_passes = 0

    def _sync(self):
        """Wait until the device has finished all queued work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- prefill

    def prefill_all(self, target_only: bool = False, strict: bool = True):
        """Prefill every waiting request, in as many admission batches as
        needed. The target's sample is the first committed token of BOTH
        streams, so draft and target streams stay identical after every
        verify-apply. With ``strict=False`` (continuous serving) an
        admission held back by seats or KV blocks leaves the rest waiting
        for a later round instead of raising."""
        while self.scheduler.waiting:
            seqs = self.scheduler.schedule_prefill()
            if not seqs:
                if not strict:
                    return
                raise RuntimeError("prefill admission made no progress (out of KV blocks?)")
            self.prefix_hit_tokens += sum(s.target.num_cached_tokens for s in seqs)
            self._drain_oversized(seqs, target_only)
            b = len(seqs)
            b_pad = self.pcfg.prefill_bucket_batch(b)
            lq_d = max(len(s.draft) - s.draft.num_cached_tokens for s in seqs)
            lq_t = max(len(s.target) - s.target.num_cached_tokens for s in seqs)
            temps = np.zeros((b_pad,), np.float32)
            temps[:b] = [s.temperature for s in seqs]
            tk = tp = None
            if any(s.top_k > 0 or s.top_p < 1.0 for s in seqs):
                tk = np.zeros((b_pad,), np.int32)
                tp = np.ones((b_pad,), np.float32)
                tk[:b] = [max(s.top_k, 0) for s in seqs]
                tp[:b] = [min(s.top_p, 1.0) for s in seqs]
            if not target_only:
                self.draft.prefill([s.draft for s in seqs], self.pcfg.bucket_tokens(lq_d), b_pad)
            logits_t = self.target.prefill(
                [s.target for s in seqs], self.pcfg.bucket_tokens(lq_t), b_pad
            )
            toks_t = self.target.sample_tokens(logits_t, temps, self.generator, tk, tp).cpu().numpy()
            t_now = time.perf_counter()
            for i, seq in enumerate(seqs):
                if not target_only:
                    seq.draft.append(int(toks_t[i]))
                seq.target.append(int(toks_t[i]))
                if seq.t_first is None:
                    seq.t_first = t_now  # first committed token: the TTFT stamp
            for i, seq in enumerate(list(seqs)):
                tok = int(toks_t[i])
                stopped = is_eos(tok, self.scheduler.eos) or tok in seq.stop_token_ids
                if (not seq.ignore_eos and stopped) or seq.num_completion_tokens == seq.max_tokens:
                    self.scheduler.finish(seq)

    def _drain_oversized(self, seqs, target_only: bool):
        """Chunked prefill: a view with more uncached tokens than
        ``max_num_batched_tokens`` (the scheduler admits such a prompt
        alone) prefills block-aligned passes of ``chunk`` tokens whose
        logits are discarded, until at most ``chunk`` tokens are left for
        the batch's sampling pass. Each non-first pass reads the passes
        before it out of the cache, as a prefix-cache hit (kernel K4).
        Views drain one by one: a re-admitted preempted sequence's draft
        view may run ahead of its target view."""
        bs = self.scheduler.block_size
        budget = self.pcfg.max_num_batched_tokens
        chunk = (budget // bs) * bs
        for s in seqs:
            pairs = [(self.target, s.target)]
            if not target_only:
                pairs.insert(0, (self.draft, s.draft))
            for runner, view in pairs:
                if len(view) - view.num_cached_tokens <= budget:
                    continue
                while len(view) - view.num_cached_tokens > chunk:
                    runner.prefill(
                        [view], self.pcfg.bucket_tokens(chunk), self.pcfg.prefill_bucket_batch(1),
                        limit=chunk,
                    )
                    view.num_cached_tokens += chunk
                    self.chunked_passes += 1

    # --------------------------------------------------------------- loops

    def generate_loop(self) -> float:
        """PEARL to completion; returns elapsed seconds."""
        start = time.perf_counter()
        self.prefill_all()
        while not self.scheduler.is_finished():
            self._fused_pearl_run(self.pcfg.gamma, num_steps=None)
            if self.scheduler.waiting:
                self.prefill_all()
        self._sync()
        return time.perf_counter() - start

    def bench_loop(self, num_pearl_steps: int, reserve_steps: int | None = None) -> float:
        """Fixed round count with EOS ignored and max_tokens unbounded, so the
        batch stays constant for the whole measurement."""
        start = time.perf_counter()
        self.prefill_all()
        for seq in self.scheduler.running:
            seq.max_tokens = 10**9
            seq.ignore_eos = True
        self._fused_pearl_run(self.pcfg.gamma, num_steps=num_pearl_steps, reserve_steps=reserve_steps)
        self._sync()
        elapsed = time.perf_counter() - start
        for seq in self.scheduler.running:
            seq.num_acc_tokens.append(seq.cur_acc_tokens)
            seq.cur_acc_tokens = 0
        return elapsed

    def ar_bench_loop(self, num_steps: int, reserve_steps: int | None = None) -> float:
        """Fixed-step target-only AR baseline, the AR twin of bench_loop."""
        start = time.perf_counter()
        self.prefill_all(target_only=True)
        for seq in self.scheduler.running:
            seq.max_tokens = 10**9
            seq.ignore_eos = True
        cap = max(num_steps, reserve_steps or 0) + 2
        seqs = self.scheduler.schedule_decode(
            lookahead=lambda s: cap, ar_only=True, strict=False
        ) if self.scheduler.running else []
        if seqs:
            state = self._build_fused_state(seqs, ar_only=True)
            remaining = num_steps
            while remaining > 0:
                chunk = min(remaining, self.pcfg.max_dispatch_steps)
                state = self.fused.run_ar(state, chunk, self.generator)
                remaining -= chunk
                if bool(state["finished"].all()):
                    break
            self._fused_sync(seqs, state, ar_only=True)
        self._sync()
        return time.perf_counter() - start

    def ar_loop(self) -> float:
        """Target-only autoregressive baseline to completion."""
        start = time.perf_counter()
        self.prefill_all(target_only=True)
        while not self.scheduler.is_finished():
            self._fused_ar_run()
            if self.scheduler.waiting:
                self.prefill_all(target_only=True)
        self._sync()
        return time.perf_counter() - start

    def serve_round(self, fused_rounds: int = 8) -> None:
        """One continuous-batching iteration: admit whatever prefills fit,
        then advance the running batch by up to ``fused_rounds`` PEARL
        rounds. Requests admitted between calls join the batch in
        pre-verify state; the round loop needs no special case for them."""
        if self.scheduler.waiting:
            self.prefill_all(strict=False)
        if not self.scheduler.running:
            return
        self.last_gamma = self.pcfg.gamma
        self._fused_pearl_run(self.pcfg.gamma, num_steps=fused_rounds)

    # ------------------------------------------------------ fused execution

    def _tables(self, views, garbage: int, b_pad: int) -> np.ndarray:
        m = next_pow2(max(8, max(len(v.block_table) for v in views)))
        bt = np.full((b_pad, m), garbage, np.int32)
        for i, v in enumerate(views):
            bt[i, : len(v.block_table)] = v.block_table
        return bt

    def _build_fused_state(self, seqs, ar_only: bool = False) -> dict:
        """The device state machine of the round loop. KV growth must
        already be reserved (schedule_decode with a per-sequence capacity)."""
        pcfg = self.pcfg
        b = len(seqs)
        b_pad = pcfg.bucket_batch(b)
        lbuf = pcfg.max_model_len + 8 * pcfg.gamma + 64
        tokens = np.zeros((b_pad, lbuf), np.int32)
        length = np.ones((b_pad,), np.int32)
        prompt_len = np.ones((b_pad,), np.int32)
        pre = np.zeros((b_pad,), bool)
        finished = np.ones((b_pad,), bool)  # padding rows stay finished
        temps = np.zeros((b_pad,), np.float32)
        max_tokens = np.full((b_pad,), 2**30, np.int32)
        ignore_eos = np.ones((b_pad,), bool)
        cur_acc = np.zeros((b_pad,), np.int32)
        tk = np.zeros((b_pad,), np.int32)
        tp = np.ones((b_pad,), np.float32)
        for i, s in enumerate(seqs):
            stream = s.target.token_ids
            tokens[i, : len(stream)] = stream
            length[i] = len(stream)
            prompt_len[i] = s.num_prompt_tokens
            pre[i] = s.pre_verify
            finished[i] = False
            temps[i] = s.temperature
            max_tokens[i] = min(s.max_tokens, 2**30)
            ignore_eos[i] = s.ignore_eos
            cur_acc[i] = s.cur_acc_tokens
            tk[i] = max(s.top_k, 0)
            tp[i] = min(s.top_p, 1.0)
        # stop set: the global EOS list [E], or a per-request [B, S] matrix
        # (EOS + the request's stop_token_ids, -1 padded) when any request
        # carries stops
        eos = [int(t) for t in self.target.cfg.eos_ids]
        if any(s.stop_token_ids for s in seqs):
            width = len(eos) + max(len(s.stop_token_ids) for s in seqs)
            eos_ids = np.full((b_pad, width), -1, np.int32)
            eos_ids[:, : len(eos)] = eos
            for i, s in enumerate(seqs):
                eos_ids[i, len(eos) : len(eos) + len(s.stop_token_ids)] = list(s.stop_token_ids)
        else:
            eos_ids = np.asarray(eos, np.int32)
        state = {
            "tokens": tokens, "length": length, "pre": pre, "finished": finished,
            "cur_acc": cur_acc, "emitted": np.zeros((b_pad,), np.int32),
            "emit_cnt": np.zeros((b_pad,), np.int32), "rounds": np.zeros((b_pad,), np.int32),
            "bt_t": self._tables([s.target for s in seqs], self.target.garbage_block, b_pad),
            "temps": temps, "max_tokens": max_tokens, "ignore_eos": ignore_eos,
            "prompt_len": prompt_len, "eos_ids": eos_ids, "tk": tk, "tp": tp,
        }
        if not ar_only:
            state["bt_d"] = self._tables([s.draft for s in seqs], self.draft.garbage_block, b_pad)
        return {k: torch.from_numpy(v).to(self.device) for k, v in state.items()}

    def _fused_chunk_rounds(self, gamma: int, b: int) -> int:
        """Rounds per chunk of a variable-length run: enough to amortise the
        host work between chunks, few enough that one chunk's whole-batch
        reservation fits in about half the smaller KV pool."""
        pool_tokens = (
            min(self.scheduler.draft_bm.num_blocks, self.scheduler.target_bm.num_blocks)
            * self.pcfg.kvcache_block_size
        )
        return max(1, min(128, pool_tokens // (2 * (gamma + 1) * max(1, b))))

    def _reserve(self, seqs, state, extra_fn, ar_only: bool) -> bool:
        """Grow each unfinished row's block reservation from the device
        lengths and refresh the block tables; False when the pools cannot
        hold it."""
        length = state["length"].cpu().numpy()
        fin = state["finished"].cpu().numpy()
        sch = self.scheduler
        grow = []
        for i, s in enumerate(seqs):
            if fin[i]:
                continue
            extra = int(length[i]) - len(s.target.token_ids) + extra_fn(s, int(length[i]))
            grow.append((s, max(0, extra)))
        for s, extra in grow:
            if not sch.target_bm.can_ensure(s.target, extra):
                return False
            if not ar_only and not sch.draft_bm.can_ensure(s.draft, extra):
                return False
        for s, extra in grow:
            sch.target_bm.ensure_capacity(s.target, extra)
            if not ar_only:
                sch.draft_bm.ensure_capacity(s.draft, extra)
        b_pad = state["length"].shape[0]
        state["bt_t"] = torch.from_numpy(
            self._tables([s.target for s in seqs], self.target.garbage_block, b_pad)
        ).to(self.device)
        if not ar_only:
            state["bt_d"] = torch.from_numpy(
                self._tables([s.draft for s in seqs], self.draft.garbage_block, b_pad)
            ).to(self.device)
        return True

    def _fused_pearl_run(self, gamma: int, num_steps: int | None,
                         reserve_steps: int | None = None):
        """PEARL to completion (num_steps=None) or for a fixed number of
        rounds. Under KV pressure a variable-length run stalls, syncs back
        and restarts (rescheduling preempts to make room)."""
        while True:
            if not self.scheduler.running:
                return
            if num_steps is not None:
                cap_steps = max(num_steps, reserve_steps or 0)
                cap_fn = lambda s: cap_steps * gamma + 2 * gamma + 4  # noqa: E731
                chunk = None
            else:
                chunk = self._fused_chunk_rounds(gamma, len(self.scheduler.running))
                cap_fn = lambda s: (  # noqa: E731
                    min(s.max_tokens - s.num_completion_tokens, chunk * gamma) + 2 * gamma + 4
                )
            seqs = self.scheduler.schedule_decode(lookahead=cap_fn, strict=False)
            if not seqs:
                return
            if num_steps is not None:
                remaining = num_steps
            else:
                remaining = max(s.max_tokens - s.num_completion_tokens for s in seqs) + 1
            state = self._build_fused_state(seqs)
            stalled, first = False, True
            while remaining > 0:
                if not first and num_steps is None:
                    extra_fn = lambda s, n: min(  # noqa: E731
                        s.max_tokens - (n - s.num_prompt_tokens), chunk * gamma
                    ) + 2 * gamma + 4
                    if not self._reserve(seqs, state, extra_fn, ar_only=False):
                        stalled = True
                        break
                cap = self.pcfg.max_dispatch_rounds
                n = min(remaining, cap if num_steps is not None else min(chunk, cap))
                state = self.fused.run_pearl(state, gamma, n, self.generator)
                remaining -= n
                first = False
                if bool(state["finished"].all()):
                    break
            self._fused_sync(seqs, state)
            if not stalled:
                return

    def _fused_ar_run(self):
        sch = self.scheduler
        while True:
            if not sch.running:
                return
            chunk = min(self._fused_chunk_rounds(0, len(sch.running)) * 8, self.pcfg.max_dispatch_steps)
            cap_fn = lambda s: min(s.max_tokens - s.num_completion_tokens, chunk) + 2  # noqa: E731
            seqs = sch.schedule_decode(lookahead=cap_fn, ar_only=True, strict=False)
            if not seqs:
                return
            state = self._build_fused_state(seqs, ar_only=True)
            remaining = max(s.max_tokens - s.num_completion_tokens for s in seqs) + 1
            stalled, first = False, True
            while remaining > 0:
                if not first:
                    extra_fn = lambda s, n: min(s.max_tokens - (n - s.num_prompt_tokens), chunk) + 2  # noqa: E731
                    if not self._reserve(seqs, state, extra_fn, ar_only=True):
                        stalled = True
                        break
                n = min(remaining, chunk)
                state = self.fused.run_ar(state, n, self.generator)
                remaining -= n
                first = False
                if bool(state["finished"].all()):
                    break
            self._fused_sync(seqs, state, ar_only=True)
            if not stalled:
                return

    def _fused_sync(self, seqs, state, ar_only: bool = False):
        """Pull the device state machine back into the host Sequences."""
        sch = self.scheduler
        keys = ["tokens", "length", "finished"]
        if not ar_only:
            keys += ["pre", "cur_acc", "emitted", "emit_cnt", "rounds"]
        fetched = {k: state[k].cpu().numpy() for k in keys}
        tokens, length, finished = fetched["tokens"], fetched["length"], fetched["finished"]
        for i, seq in enumerate(seqs):
            stream = tokens[i, : int(length[i])].tolist()
            seq.target.token_ids = stream
            if not ar_only:
                seq.draft.token_ids = list(stream)
                seq.pre_verify = bool(fetched["pre"][i])
                seq.cur_acc_tokens = int(fetched["cur_acc"][i])
                seq.num_rounds += int(fetched["rounds"][i])
                tot, cnt = float(fetched["emitted"][i]), int(fetched["emit_cnt"][i])
                if cnt:
                    # per-emit values are not kept on the device; a flat
                    # split keeps their sum and count (so MAT is exact)
                    seq.num_acc_tokens.extend([tot / cnt] * cnt)
            if finished[i]:
                sch.finish(seq)
