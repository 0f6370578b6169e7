"""PEARL orchestration (counterpart of nano_pearl_tpu/engine/pearl.py).

Draft and target share the engine's one device, and two execution modes
drive them (``PearlConfig.execution_mode``):

- "auto" / "fused" (the default): every round runs through ``FusedPearl``.
  The host prefills, builds the device state machine from the
  scheduler's sequences, runs chunks of rounds, and pulls the state back
  into the host ``Sequence`` objects.
- "overlap": the per-round host loop (``pearl_round``), the JAX
  package's loop for draft and target on disjoint devices. On a CUDA
  device the draft runs on a stream of its own and the target on
  another: each round the host enqueues the draft's gamma-scan on the
  draft stream and the target's packed verify on the target stream
  before any host read, waits on an event of the draft stream alone to
  read the draft tokens, and enqueues the verdict on the target stream.
  Every tensor of a round is made on the stream that reads it, so no
  block of the caching allocator crosses streams; prefill and AR run on
  the current stream, joined to both at a round's edges. On the CPU the
  same calls run in the same order on no stream.

The AR baseline runs the fused AR loop in every mode.

Rollback never touches KV contents: accepted and rolled-back state is
length and block bookkeeping.

``gamma=-1`` turns on acceptance-adaptive gamma: ``auto_set_gamma``
profiles both models' decode speed for a seed gamma per batch size, and
an EWMA of the observed committed tokens per round re-picks gamma from a
round-time model, at chunk boundaries of a fused run and every overlap
round (``_adapt_gamma``; the host logic is the JAX package's, verbatim).
A request whose last round accepted holds its window's unverified tail,
which only a verify at that window checks: before rounds at another
window it drops that tail and returns to the pre-verify state
(``_rewindow``), which the JAX package does not do.

Continuous serving (``serve_round``) admits whatever prefills fit and
advances the running batch by a fixed number of fused rounds, or one
overlap round; prompts over ``max_num_batched_tokens`` prefill in
block-aligned chunk passes.

Not ported yet: the parallel layouts (ROADMAP 14b).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from nano_pearl_tpu_torch.config import PearlConfig, SamplingParams
from nano_pearl_tpu_torch.engine.fused import FusedPearl
from nano_pearl_tpu_torch.engine.runner import GroupRunner, next_pow2
from nano_pearl_tpu_torch.engine.scheduler import Scheduler, is_eos
from nano_pearl_tpu_torch.engine.sequence import Sequence
from nano_pearl_tpu_torch.ops.sampling import greedy
from nano_pearl_tpu_torch.utils.logging import logger

EXECUTION_MODES = ("auto", "fused", "overlap")


class PearlOrchestrator:
    def __init__(
        self,
        pcfg: PearlConfig,
        draft: GroupRunner,
        target: GroupRunner,
        scheduler: Scheduler,
        generator: torch.Generator,
    ):
        if pcfg.execution_mode not in EXECUTION_MODES:
            raise ValueError(f"unknown execution_mode {pcfg.execution_mode!r} (expected one of {EXECUTION_MODES})")
        self.pcfg = pcfg
        self.draft = draft
        self.target = target
        self.scheduler = scheduler
        self.generator = generator
        self.device = target.device
        # The fused AR loop serves every mode; the fused PEARL loop runs
        # unless overlap is asked for (one device: JAX's
        # FusedPearl.compatible always holds).
        self._fused_impl = FusedPearl(pcfg, draft, target)
        self.fused: FusedPearl | None = self._fused_impl if pcfg.execution_mode != "overlap" else None
        # overlap on CUDA: (draft stream, target stream); None on the CPU
        self.streams = None
        if self.fused is None and self.device.type == "cuda":
            self.streams = (torch.cuda.Stream(self.device), torch.cuda.Stream(self.device))
        # gamma of the most recent round: bounds the committed stream's
        # unverified tail for token streaming (engine.serve_step
        # with_deltas); 0 until a round has run (post-prefill state is
        # fully verified)
        self.last_gamma = 0
        # serving counters (engine.stats): prompt tokens served from the
        # prefix cache, and chunked-prefill passes run
        self.prefix_hit_tokens = 0
        self.chunked_passes = 0
        # Acceptance-adaptive gamma (gamma == -1), as the JAX package: the
        # speed-ratio gamma of auto_set_gamma per batch size, an EWMA of
        # the per-token agreement probability p (inverted from committed
        # tokens per round), measured round times per (gamma, batch
        # bucket) (_round_seen drops each key's first sample, _round_best
        # keeps the least of the rest), and a per-gamma EWMA of committed
        # tokens per round whose entries age (_commit_age, _commit_tick).
        self.gamma_list: dict[int, int] | None = None
        self._speeds: dict[int, tuple[float, float]] = {}
        self._p_ewma: float | None = None
        self._round_best: dict[tuple[int, int], float] = {}
        self._round_seen: set[tuple[int, int]] = set()
        self._commit_obs: dict[int, float] = {}
        self._commit_age: dict[int, int] = {}
        self._commit_tick = 0
        # calibration override: _pick_gamma returns it verbatim (the bench's
        # warm-up measures the settled gamma's ladder neighbours)
        self.force_gamma: int | None = None
        self._gamma_ladder = (1, 2, 3, 4, 6, 8, 10, 12, 14, 16)

    def _sync(self):
        """Wait until the device has finished all queued work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _on(self, stream):
        """Run the block's device work on ``stream`` (a no-op without one)."""
        return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()

    def _fetch(self, stream, *tensors) -> list[np.ndarray]:
        """Host copies of ``tensors``, read once ``stream``'s work before
        them is done: an event of that stream alone is waited on."""
        if stream is None:
            return [t.cpu().numpy() for t in tensors]
        with torch.cuda.stream(stream):
            host = [t.to("cpu", non_blocking=True) for t in tensors]
            done = torch.cuda.Event()
            done.record(stream)
        done.synchronize()
        return [h.numpy() for h in host]

    @staticmethod
    def _tk_tp(seqs, b_pad):
        """Per-row top_k/top_p arrays, or (None, None) when every row has
        filtering disabled."""
        if all(s.top_k <= 0 and s.top_p >= 1.0 for s in seqs):
            return None, None
        tk = np.zeros((b_pad,), np.int32)
        tp = np.ones((b_pad,), np.float32)
        for i, s in enumerate(seqs):
            tk[i] = max(s.top_k, 0)
            tp[i] = min(s.top_p, 1.0)
        return tk, tp

    def _stop_matrix(self, seqs, b_pad: int) -> np.ndarray | None:
        """The per-request stop matrix [b_pad, S] (global EOS plus each
        request's stop tokens, -1 padded: never a token id) when any request
        carries stops, else None (the global EOS list serves)."""
        if not any(s.stop_token_ids for s in seqs):
            return None
        eos = [int(t) for t in self.target.cfg.eos_ids]
        stops = np.full((b_pad, len(eos) + max(len(s.stop_token_ids) for s in seqs)), -1, np.int32)
        stops[:, : len(eos)] = eos
        for i, s in enumerate(seqs):
            stops[i, len(eos) : len(eos) + len(s.stop_token_ids)] = s.stop_token_ids
        return stops

    def _m_pad(self, views) -> int:
        m = max(len(v.block_table) for v in views)
        return min(next_pow2(max(m, 8)), self.pcfg.max_blocks_per_seq)

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
            tk, tp = self._tk_tp(seqs, b_pad)
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

    # --------------------------------------------------------------- rounds

    def _rewindow(self, gamma: int):
        """Ready the running batch for rounds at window ``gamma``: a request
        whose last round accepted at another window drops that window's
        unverified tail (``Scheduler.drop_unverified``)."""
        for s in self.scheduler.running:
            if s.window != gamma:
                self.scheduler.drop_unverified(s)
                s.window = gamma

    def pearl_round(self, gamma: int):
        """One PEARL round of the overlap mode over the running batch."""
        sch = self.scheduler
        self._rewindow(gamma)
        seqs = sch.schedule_decode(lookahead=gamma + 1)
        b = len(seqs)
        b_pad = self.pcfg.bucket_batch(b)
        is_pre = np.zeros((b_pad,), bool)
        is_pre[:b] = [s.pre_verify for s in seqs]
        draft_views = [s.draft for s in seqs]
        target_views = [s.target for s in seqs]
        ds, ts = self.streams or (None, None)
        if ds is not None:
            # join: both streams start after the current stream's work
            # (prefill, AR, the previous fused run)
            ds.wait_stream(torch.cuda.current_stream(self.device))
            ts.wait_stream(torch.cuda.current_stream(self.device))

        # 1+2: enqueue both models' rounds before any host read
        with self._on(ds):
            toks_dev = self.draft.gamma_scan(
                draft_views, gamma, b_pad, self._m_pad(draft_views), is_pre, self._fused_impl._draft_gamma
            )
        with self._on(ts):
            logits_dev = self.target.verify_forward(target_views, is_pre, gamma, b_pad, self._m_pad(target_views))

        # 3: the draft tokens [b, gamma], read on the draft stream alone
        (g_toks,) = self._fetch(ds, toks_dev[:b])

        # 4: the to-be-verified window: the target's forward over its
        # last-appended tokens scores the previous draft round shifted by
        # one plus the first token of this round
        tbv = np.zeros((b_pad, gamma), np.int32)
        for i, seq in enumerate(seqs):
            if is_pre[i]:
                tbv[i, 0] = g_toks[i, 0]
            else:
                tail = seq.draft.token_ids[-(gamma - 1):] if gamma > 1 else []
                tbv[i, : gamma - 1] = tail
                tbv[i, gamma - 1] = g_toks[i, 0]

        # 5: commit this round's draft tokens to the draft view
        for i, seq in enumerate(seqs):
            seq.draft.token_ids.extend(int(t) for t in g_toks[i])

        # 6: the verdict on the target stream, then its five vectors
        num_completion = np.zeros((b_pad,), np.int32)
        max_tokens = np.full((b_pad,), 2**30, np.int32)
        ignore_eos = np.ones((b_pad,), bool)
        temps = np.zeros((b_pad,), np.float32)
        for i, s in enumerate(seqs):
            num_completion[i] = s.num_completion_tokens
            max_tokens[i] = min(s.max_tokens, 2**30)
            ignore_eos[i] = s.ignore_eos
            temps[i] = s.temperature
        tk, tp = self._tk_tp(seqs, b_pad)
        with self._on(ts):
            res = self.target.verdict(
                logits_dev, tbv, is_pre, temps, num_completion, max_tokens, ignore_eos, gamma,
                self.generator, top_ks=tk, top_ps=tp, stops=self._stop_matrix(seqs, b_pad),
            )
            packed = torch.stack([res.acc.to(torch.int32), res.rollout, res.revise,
                                  res.finish.to(torch.int32), res.n_acc])[:, :b]
        (packed,) = self._fetch(ts, packed)
        acc, rollout, revise, finish, n_acc = packed
        if ds is not None:
            # join: later work on the current stream sees both caches' writes
            torch.cuda.current_stream(self.device).wait_stream(ds)
            torch.cuda.current_stream(self.device).wait_stream(ts)

        # 7: apply the state machine to both views
        lens0 = [len(s.target) for s in seqs]
        for i, seq in enumerate(seqs):
            self._apply_verdict(
                seq, bool(acc[i]), int(rollout[i]), int(revise[i]), bool(finish[i]), int(n_acc[i]),
                g_toks[i], gamma,
            )
        if seqs:
            # the adaptive-gamma estimator takes the round's mean committed
            # growth (a rejection may shrink a stream)
            delta = float(np.mean([len(s.target) - l0 for s, l0 in zip(seqs, lens0)]))
            self._note_commit_rate(delta, gamma)

    def _apply_verdict(self, seq: Sequence, acc: bool, rollout: int, revise: int,
                       finish: bool, n_acc: int, g_toks: np.ndarray, gamma: int):
        sch = self.scheduler
        was_pre = seq.pre_verify
        seq.num_rounds += 1
        # MAT bookkeeping: the emitted count includes the revise token on
        # rejection
        if acc:
            seq.cur_acc_tokens += n_acc
        else:
            seq.num_acc_tokens.append(seq.cur_acc_tokens + n_acc + 1)
            seq.cur_acc_tokens = 0
        # the committed (target) view
        if acc:
            seq.target.token_ids.extend(int(t) for t in g_toks)
        else:
            if not was_pre and rollout > 1:
                sch.target_bm.rollback(seq.target, rollout - 1)
            seq.target.append(revise)
        # the draft view
        if finish:
            seq.num_acc_tokens.append(seq.cur_acc_tokens)
            seq.cur_acc_tokens = 0
            sch.finish(seq)
            return
        if acc:
            seq.pre_verify = False
        else:
            seq.pre_verify = True
            sch.draft_bm.rollback(seq.draft, gamma)
            if not was_pre and rollout > 1:
                sch.draft_bm.rollback(seq.draft, rollout - 1)
            seq.draft.append(revise)

    # ------------------------------------------------------------ gamma

    def _pick_gamma(self) -> int:
        if self.pcfg.gamma != -1:
            return self.pcfg.gamma
        if self.force_gamma is not None:
            return self.force_gamma
        assert self.gamma_list, "gamma=-1 requires auto_set_gamma() first"
        b = len(self.scheduler.running)
        for bs in sorted(self.gamma_list):
            if bs >= b:
                return self._adapt_gamma(self.gamma_list[bs])
        return self._adapt_gamma(self.gamma_list[max(self.gamma_list)])

    @staticmethod
    def _expected_commit(gamma: int, p: float) -> float:
        """Long-run committed tokens per PEARL round under per-token
        agreement probability p: the geometric series 1 + p + ... +
        p^(gamma-1) (a rejection at position k still commits k accepted
        tokens plus the revise token; full agreement commits gamma)."""
        if p >= 0.9999:
            return float(gamma)
        return (1.0 - p**gamma) / (1.0 - p)

    def _estimate_p(self, m_obs: float, gamma: int) -> float:
        """Invert _expected_commit(gamma, .) = m_obs by bisection."""
        if m_obs >= gamma - 1e-6:
            return 1.0
        m_obs = max(m_obs, 0.05)
        lo, hi = 0.0, 0.99999
        for _ in range(40):
            mid = (lo + hi) / 2
            if self._expected_commit(gamma, mid) < m_obs:
                lo = mid
            else:
                hi = mid
        return (lo + hi) / 2

    def _note_commit_rate(self, tokens_per_round: float, gamma: int, rounds: int = 1):
        """Fold an observed committed-tokens/round sample (over ``rounds``
        rounds at draft window ``gamma``) into the p EWMA and the
        per-gamma empirical commit table."""
        if gamma < 1 or rounds < 1:
            return
        est = self._estimate_p(tokens_per_round, gamma)
        a = 1.0 - 0.75 ** min(rounds, 16)  # per-round alpha 0.25
        self._p_ewma = est if self._p_ewma is None else (
            (1 - a) * self._p_ewma + a * est
        )
        cur = self._commit_obs.get(gamma)
        self._commit_obs[gamma] = tokens_per_round if cur is None else (
            (1 - a) * cur + a * tokens_per_round
        )
        self._commit_tick += 1
        self._commit_age[gamma] = self._commit_tick

    def _note_round_time(self, gamma: int, b: int, seconds_per_round: float):
        """Fold a measured fused-chunk seconds/round sample into the
        per-(gamma, batch-bucket) table. The first sample of each key is
        dropped (the first chunk at a gamma warms its kernels and
        allocations), later samples keep the minimum (host contention
        only ever slows a chunk down)."""
        key = (gamma, self.pcfg.bucket_batch(max(1, b)))
        if key not in self._round_seen:
            self._round_seen.add(key)
            return
        cur = self._round_best.get(key)
        self._round_best[key] = (
            seconds_per_round if cur is None else min(cur, seconds_per_round)
        )

    def _round_time_model(self, b: int):
        """T(gamma) for the current batch bucket. Prefers measured fused
        chunk times (least-squares line over the observed gammas: the
        intercept absorbs the verdict's and the bookkeeping's fixed
        costs); falls back to the auto_set_gamma speed profile when fewer
        than two gammas have been measured."""
        bs_b = self.pcfg.bucket_batch(max(1, b))
        meas = {g: t for (g, b2), t in self._round_best.items() if b2 == bs_b}
        if len(meas) >= 2:
            gs = np.array(sorted(meas), np.float64)
            ts = np.array([meas[int(g)] for g in gs], np.float64)
            td, c = np.polyfit(gs, ts, 1)
            td = max(float(td), 1e-7)
            c = max(float(c), 1e-7)
            return lambda g: meas.get(g, c + td * g)
        if not self._speeds:
            return None
        bs = min(self._speeds, key=lambda k: abs(k - b))
        sd, st = self._speeds[bs]
        if sd <= 0 or st <= 0:
            return None
        td, tv = 1.0 / sd, 1.0 / st
        fused = self.fused is not None
        if meas:  # one sample: anchor the profile slope at it
            g0, t0 = next(iter(meas.items()))
            return lambda g: meas.get(g, max(t0 + (g - g0) * td, 1e-7))
        if fused:
            return lambda g: g * td + tv
        return lambda g: max(g * td, tv) + 0.25 * tv

    def _adapt_gamma(self, base_gamma: int) -> int:
        """Acceptance-aware gamma: maximize E[committed/round] / T(round).
        T(gamma) comes from _round_time_model. Hysteresis: switch only on
        a >= 10% modelled gain."""
        if self._p_ewma is None:
            return base_gamma
        b = max(1, len(self.scheduler.running))
        tmodel = self._round_time_model(b)
        if tmodel is None:
            return base_gamma
        p = self._p_ewma

        def obs_blend(g: int) -> float:
            """Observed commit EWMA at g, decayed toward the geometric
            model with staleness (half-life 64 notes)."""
            geo = self._expected_commit(g, p)
            age = self._commit_tick - self._commit_age.get(g, self._commit_tick)
            w = 0.5 ** (age / 64.0)
            return w * self._commit_obs[g] + (1.0 - w) * geo

        def commit_est(g: int) -> float:
            """E[committed/round] at window g: the observed per-gamma EWMA
            when g has been run; otherwise the geometric model rescaled
            through the nearest observed gamma."""
            if g in self._commit_obs:
                return obs_blend(g)
            geo = self._expected_commit(g, p)
            if not self._commit_obs:
                return geo
            g0 = min(self._commit_obs, key=lambda k: abs(k - g))
            geo0 = max(self._expected_commit(g0, p), 1e-6)
            return min(float(g), geo * obs_blend(g0) / geo0)

        def score(g: int) -> float:
            return commit_est(g) / tmodel(g)

        best = max(self._gamma_ladder, key=score)
        if score(best) < 1.10 * score(base_gamma):
            return base_gamma
        if best != base_gamma:
            logger.info(f"adaptive gamma: {base_gamma} -> {best} (p_hat {p:.3f}, bs {b})")
        return best

    def auto_set_gamma(self, profile_steps: int = 12, skip_first: int = 3,
                       batch_sizes=(1, 2, 4, 8, 16, 32), seq_len: int = 256):
        """Profile draft vs target decode speed and set gamma per batch
        size to their ratio (the reference's auto_set_gamma). Each timed
        step synchronizes the device before it starts and reads its tokens
        back. The dummy prompts differ from each other: identical ones
        would share prefix blocks, and the scheduler admits a batch whose
        requests share blocks written in that batch one request at a time
        (the JAX package's profile, whose prompts are identical, admits one
        of them and falls back to gamma 4 with no speeds). They stay short
        enough to grow ``profile_steps`` tokens within max_model_len."""
        gamma_list = {}
        seq_len = min(seq_len, self.pcfg.max_model_len - profile_steps)
        vocab = self.target.cfg.vocab_size
        for bs in batch_sizes:
            if bs > self.pcfg.max_num_seqs:
                break
            seqs = [
                Sequence([1 + i % (vocab - 1)] * seq_len, SamplingParams(temperature=0.0),
                         self.pcfg.kvcache_block_size)
                for i in range(bs)
            ]
            for s in seqs:
                self.scheduler.add(s)
            admitted = self.scheduler.schedule_prefill()
            if len(admitted) < bs:
                self.scheduler.clear()
                break
            speeds = {}
            for runner, bm, views in (
                (self.draft, self.scheduler.draft_bm, [s.draft for s in seqs]),
                (self.target, self.scheduler.target_bm, [s.target for s in seqs]),
            ):
                times = []
                for _ in range(profile_steps):
                    for v in views:
                        bm.ensure_capacity(v, 1)
                    self._sync()
                    t0 = time.perf_counter()
                    logits = runner.decode(views, self.pcfg.bucket_batch(bs), self._m_pad(views))
                    toks = greedy(logits).cpu().numpy()
                    times.append(time.perf_counter() - t0)
                    for v, t in zip(views, toks[:bs]):
                        v.append(int(t))
                good = times[skip_first:]
                speeds[runner.name] = len(good) / sum(good) if good else 0.0
            self._speeds[bs] = (speeds["draft"], speeds["target"])
            gamma_list[bs] = max(1, round(speeds["draft"] / speeds["target"]))
            logger.info(
                f"auto-gamma bs={bs}: draft {speeds['draft']:.1f} it/s, "
                f"target {speeds['target']:.1f} it/s -> gamma {gamma_list[bs]}"
            )
            self.scheduler.clear()
        self.gamma_list = gamma_list or {1: 4}

    # --------------------------------------------------------------- loops

    def generate_loop(self) -> float:
        """PEARL to completion; returns elapsed seconds."""
        start = time.perf_counter()
        self.prefill_all()
        while not self.scheduler.is_finished():
            gamma = self._pick_gamma() if self.scheduler.running else 1
            self.last_gamma = gamma
            if self.fused is not None:
                self._fused_pearl_run(gamma, num_steps=None)
            else:
                while self.scheduler.running:
                    self.pearl_round(gamma)
                    if self.pcfg.gamma == -1 and self.scheduler.running:
                        gamma = self.last_gamma = self._pick_gamma()
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
        gamma = self._pick_gamma() if self.scheduler.running else 1
        self.last_gamma = gamma
        if self.fused is not None:
            self._fused_pearl_run(gamma, num_steps=num_pearl_steps, reserve_steps=reserve_steps)
        else:
            for _ in range(num_pearl_steps):
                self.pearl_round(gamma)
                if self.pcfg.gamma == -1 and self.scheduler.running:
                    gamma = self.last_gamma = self._pick_gamma()
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
                state = self._fused_impl.run_ar(state, chunk, self.generator)
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
        then advance the running batch by up to ``fused_rounds`` fused
        rounds, or by one overlap round. Requests admitted between calls
        join the batch in pre-verify state; the round loop needs no special
        case for them."""
        if self.scheduler.waiting:
            self.prefill_all(strict=False)
        if not self.scheduler.running:
            return
        gamma = self._pick_gamma()
        self.last_gamma = gamma
        if self.fused is not None:
            self._fused_pearl_run(gamma, num_steps=fused_rounds)
        else:
            self.pearl_round(gamma)

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
        lbuf = pcfg.max_model_len + 8 * (pcfg.gamma if pcfg.gamma > 0 else 8) + 64
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
        # stop set: the per-request matrix, or the global EOS list [E]
        eos_ids = self._stop_matrix(seqs, b_pad)
        if eos_ids is None:
            eos_ids = np.asarray(self.target.cfg.eos_ids, np.int32)
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
        # the rows' growth together must fit each pool
        if sum(sch.target_bm.blocks_needed(s.target, extra) for s, extra in grow) > sch.target_bm.num_free_blocks:
            return False
        if not ar_only and (
            sum(sch.draft_bm.blocks_needed(s.draft, extra) for s, extra in grow) > sch.draft_bm.num_free_blocks
        ):
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
        and restarts (rescheduling preempts to make room).

        After each chunk the device lengths feed the adaptive-gamma
        estimator (committed tokens per round over the rows still live at
        the chunk's start) and the chunk's seconds per round its round-time
        table. With gamma == -1 (and no ``force_gamma``) gamma is re-picked
        at chunk boundaries: a switch syncs the state back and restarts
        with the new window (``_rewindow``); a fixed-step run carries its
        remaining rounds across the switch."""
        while True:
            if not self.scheduler.running:
                return
            self._rewindow(gamma)
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
            b = len(seqs)
            prev_len = np.array([len(s.target) for s in seqs])
            prev_fin = np.zeros((b,), bool)
            stalled, first, regamma = False, True, None
            while remaining > 0:
                if not first and num_steps is None:
                    extra_fn = lambda s, n: min(  # noqa: E731
                        s.max_tokens - (n - s.num_prompt_tokens), chunk * gamma
                    ) + 2 * gamma + 4
                    if not self._reserve(seqs, state, extra_fn, ar_only=False):
                        stalled = True
                        break
                t_chunk = time.perf_counter()
                cap = self.pcfg.max_dispatch_rounds
                n = min(remaining, cap if num_steps is not None else min(chunk, cap))
                state = self.fused.run_pearl(state, gamma, n, self.generator)
                remaining -= n
                first = False
                length, fin = torch.stack([state["length"], state["finished"].to(torch.int32)]).cpu().numpy()
                length, fin = length[:b], fin.astype(bool)
                rounds = state["rounds_done"]
                if rounds > 0:
                    live = ~prev_fin
                    if live.any():
                        self._note_commit_rate(float(np.mean(length[live] - prev_len[live])) / rounds, gamma, rounds)
                    self._note_round_time(gamma, b, (time.perf_counter() - t_chunk) / rounds)
                prev_len, prev_fin = length, fin[:b]
                if remaining <= 0 or fin.all():
                    break
                if self.pcfg.gamma == -1 and self.force_gamma is None:
                    g2 = self._adapt_gamma(gamma)
                    if g2 != gamma:
                        regamma = g2
                        break
            self._fused_sync(seqs, state)
            if regamma is not None:
                gamma = self.last_gamma = regamma
                if num_steps is not None:
                    num_steps = remaining
                continue
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
                state = self._fused_impl.run_ar(state, n, self.generator)
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
