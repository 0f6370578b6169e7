"""User-facing engine (counterpart of nano_pearl_tpu/engine/engine.py).

    engine = PearlEngine(config)                 # on the CUDA device
    engine = PearlEngine(config, device="cpu")   # plain versions, for tests
    engine.add_request(token_ids, SamplingParams(...))
    token_ids, num_tokens, num_acc_tokens, elapsed = engine.generate_token_ids()
    ... = engine.AR_generate_token_ids()
    ... = engine.bench_generate(num_pearl_steps=100)

    # continuous serving (nano_pearl_tpu_torch/serve.py drives these)
    seq_id = engine.submit(token_ids, SamplingParams(...))
    done, deltas = engine.serve_step(fused_rounds=4, with_deltas=True)
    engine.cancel(seq_id); engine.stats()

Kernels by ``PearlConfig.perf_profile`` (engine/runner.py):

- "ceiling" (the default): prefill K3, or K4 on prefix-cache hits; decode
  (the draft's gamma-scan, AR) K1; the classic chunked packed verify K2;
- "throughput": prefill K3/K4; decode K5 (mono schedule); the
  deferred-write packed verify K7 (cache-side partials, merged with the
  fresh window as plain ops) and one K12 writeback per round;
- the JAX package's ``NANO_PEARL_*`` overrides, read when the engine is
  built (engine/runner.py): ``SPLIT=1`` decodes the gamma-scan through
  K8a and verifies through K8b, ``DEFERRED_VERIFY=1`` on the ceiling
  profile verifies through K6a, ``FRESH_MODE=kernel`` on the throughput
  profile through K6b.

At a folded head axis ``Hkv * D`` that is not a multiple of 128 (and,
over a 1-byte cache, at blocks that are not a multiple of 32) decode and
verify take the fallbacks K10a/K10b (K10c/K10d), as the JAX package does.
``draft_model`` / ``target_model`` may be HF checkpoint directories: the
engine loads them (``utils/loader.py``); weights handed in take
precedence, and random ones are drawn only when neither is given.

With ``num_kvcache_blocks=-1`` both models' KV pools are sized together
from one budget per device. ``execution_mode``
"auto" or "fused" (the default) runs the fused round loop
(engine/fused.py); "overlap" the per-round host loop, with the draft on
one CUDA stream and the target on another (engine/pearl.py). ``gamma=-1``
profiles both models' decode speed at build (``auto_set_gamma`` over
``gamma_profile_batches``) and then adapts gamma to the observed
acceptance. The entry points run on CUDA unless the caller asks for the
CPU; with no CUDA device and no explicit ``device="cpu"`` the engine
raises.

``draft_sp`` / ``target_sp`` > 1 shard a group's KV cache over the
blocks (sequence parallelism, ``parallel/sp.py``): decode and verify run
the per-shard partials kernels K11a/K11c (K11b/K11d over a quantized
cache) and merge them. ``draft_tp`` / ``target_tp`` > 1 shard a group's
weights and KV heads over tensor-parallel ranks (``parallel/sharding.py``,
``parallel/tp_attn.py``): each rank launches its own products and
kernels, and the host sums the ranks' partial products. The groups sit on
``config.devices`` (torch devices or strings; default: the engine's one
device) by ``config.placement`` (``parallel/mesh.build_group_placements``:
"disjoint" slices, shared round-robin where they run short, or "union");
the engine's device, where the round loop's state lives, is ``device``,
else the first of ``config.devices``; a group of one rank and one shard
runs there, whatever device its placement names. The KV budget is taken once per
distinct device and shared by every shard and rank on it. Still refused,
each by name: pipeline and expert parallelism, tp with sp > 1, tp over an
MoE model, tp under the overlap mode.
"""

from __future__ import annotations

import time
from collections import deque

import torch

from nano_pearl_tpu_torch.config import PearlConfig, SamplingParams
from nano_pearl_tpu_torch.engine import runner as runner_mod
from nano_pearl_tpu_torch.engine.pearl import PearlOrchestrator
from nano_pearl_tpu_torch.engine.runner import GroupRunner
from nano_pearl_tpu_torch.engine.scheduler import Scheduler
from nano_pearl_tpu_torch.engine.sequence import Sequence
from nano_pearl_tpu_torch.parallel.mesh import build_group_placements
from nano_pearl_tpu_torch.utils.logging import logger


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the current CUDA device; raises when no
    CUDA device exists and the caller did not ask for the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' to run "
            "its plain PyTorch versions"
        )
    return torch.device("cuda", torch.cuda.current_device())


def _check_config(config: PearlConfig) -> None:
    """Raise on a gamma that is neither a window nor -1 (adaptive), and on
    the parallel layouts the port does not run yet, each by name."""
    if config.gamma == 0 or config.gamma < -1:
        raise ValueError(f"gamma must be a draft window >= 1, or -1 (adaptive); got {config.gamma}")
    tp = max(config.draft_tp, config.target_tp) > 1
    unsupported = {
        "pipeline parallelism (draft_pp / target_pp > 1)": max(config.draft_pp, config.target_pp) > 1,
        "expert parallelism (draft_ep / target_ep > 1)": max(config.draft_ep, config.target_ep) > 1,
        "tensor parallelism with sequence parallelism (tp > 1 with sp > 1)":
            tp and max(config.draft_sp, config.target_sp) > 1,
        "tensor parallelism over an MoE model": tp and (
            config.draft_config.is_moe or config.target_config.is_moe
        ),
        'tensor parallelism under execution_mode="overlap"': tp and config.execution_mode == "overlap",
    }
    missing = [k for k, v in unsupported.items() if v]
    if missing:
        raise NotImplementedError("not ported yet: " + ", ".join(missing))


def resolve_devices(config: PearlConfig, device) -> tuple[torch.device, list[torch.device]]:
    """(the engine's device, the devices its groups are placed over):
    ``config.devices`` (torch devices or strings) where given, the engine's
    device then the first of them unless ``device`` names it; else the one
    device ``resolve_device(device)``."""
    if config.devices is None:
        dev = resolve_device(device)
        return dev, [dev]
    devices = [torch.device(d) for d in config.devices]
    if not devices:
        raise ValueError("config.devices is empty")
    return (resolve_device(device) if device is not None else devices[0]), devices


class PearlEngine:
    def __init__(
        self,
        config: PearlConfig,
        draft_params: dict | None = None,
        target_params: dict | None = None,
        device=None,
    ):
        """``draft_params``/``target_params``: weights in the JAX package's
        pytree layout, as numpy arrays or as the port's tensors; when
        omitted, the checkpoint of a model given as a directory, else
        random weights from ``config.seed``."""
        _check_config(config)
        self.config = config
        self.device, devices = resolve_devices(config, device)
        draft_at, target_at = build_group_placements(
            devices, config.draft_tp, config.target_tp, config.placement, config.draft_sp, config.target_sp
        )
        self.draft = GroupRunner(
            config, config.draft_config, self.device, name="draft",
            params=draft_params, seed=config.seed, placement=draft_at,
        )
        self.target = GroupRunner(
            config, config.target_config, self.device, name="target",
            params=target_params, seed=config.seed + 1, placement=target_at,
        )
        if self.draft.kv is None:
            self._allocate_kv()
        self.scheduler = Scheduler(config, self.draft.num_blocks, self.target.num_blocks)
        self.generator = torch.Generator(self.device).manual_seed(config.seed)
        self.orchestrator = PearlOrchestrator(
            config, self.draft, self.target, self.scheduler, self.generator
        )
        self._completed_requests = 0
        self._completed_tokens = 0
        self._completed_rounds = 0
        self._lat = deque(maxlen=512)  # recent completions' (ttft, tpot, e2e)
        if config.gamma == -1:
            batches = config.gamma_profile_batches
            self.orchestrator.auto_set_gamma(**({"batch_sizes": tuple(batches)} if batches else {}))
        if config.warmup:
            self.warmup(batches=config.warmup if isinstance(config.warmup, tuple) else (1,))
        logger.info(f"PearlEngine ready on {self.device}.", color="green")

    def _allocate_kv(self) -> None:
        """Both caches from one budget per distinct device, measured with
        both models' weights on the devices: every pool and every sp shard
        or tp rank on a device shares its budget (the JAX package multiplies
        by sp and tp because its shards sit on distinct chips). A device
        takes, per global block of a pool, that pool's block bytes (every
        rank's and shard's) times its share of the pool's devices; the count
        is the least any device affords."""
        share: dict[torch.device, list[int]] = {}
        for r in (self.draft, self.target):
            n = len(r.placement.devices)
            for dev in r.placement.distinct_devices:
                on_dev = r.placement.devices.count(dev)
                share.setdefault(dev, []).append(-(-r.block_bytes * on_dev // n))
        num = min(
            runner_mod.kv_num_blocks(
                self.config, block_bytes, runner_mod.device_kv_budget(dev, self.config.hbm_utilization)
            )
            for dev, block_bytes in share.items()
        )
        self.draft.allocate_kv(num)
        self.target.allocate_kv(num)

    def add_request(self, prompt, sampling_params: SamplingParams | None = None) -> int:
        """Queue a request given as token ids (the port has no tokenizer)."""
        sampling_params = sampling_params or SamplingParams()
        if isinstance(prompt, str):
            raise NotImplementedError("string prompts need a tokenizer; pass token ids")
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) + sampling_params.max_tokens > self.config.max_model_len:
            raise ValueError("prompt + max_tokens exceeds max_model_len")
        seq = Sequence(list(prompt), sampling_params, self.config.kvcache_block_size)
        seq.t_submit = time.perf_counter()
        self.scheduler.add(seq)
        return seq.seq_id

    def _collect(self, seqs: list[Sequence]):
        seqs = sorted(seqs, key=lambda s: s.seq_id)
        token_ids = [s.completion_token_ids for s in seqs]
        num_acc = [list(s.num_acc_tokens) for s in seqs]
        return [len(t) for t in token_ids], num_acc, token_ids

    def generate_token_ids(self):
        """PEARL generation; returns (token_ids, num_tokens, num_acc, elapsed)."""
        elapsed = self.orchestrator.generate_loop()
        num_tokens, num_acc, token_ids = self._collect(self.scheduler.finished)
        self.scheduler.clear()
        return token_ids, num_tokens, num_acc, elapsed

    def AR_generate_token_ids(self):
        """Target-only autoregressive baseline; returns
        (token_ids, num_tokens, None, elapsed)."""
        elapsed = self.orchestrator.ar_loop()
        num_tokens, _, token_ids = self._collect(self.scheduler.finished)
        self.scheduler.clear()
        return token_ids, num_tokens, None, elapsed

    def bench_generate(self, num_pearl_steps: int = 100, reserve_steps: int | None = None):
        """Fixed-round PEARL benchmark; returns
        (token_ids, num_tokens, num_acc, elapsed)."""
        elapsed = self.orchestrator.bench_loop(num_pearl_steps, reserve_steps)
        num_tokens, num_acc, token_ids = self._collect(
            list(self.scheduler.running) + self.scheduler.finished
        )
        self.scheduler.clear()
        return token_ids, num_tokens, num_acc, elapsed

    def AR_bench_generate(self, num_steps: int = 100, reserve_steps: int | None = None):
        """Fixed-step target-only AR benchmark, the baseline twin of
        bench_generate; returns (token_ids, num_tokens, None, elapsed)."""
        elapsed = self.orchestrator.ar_bench_loop(num_steps, reserve_steps)
        num_tokens, _, token_ids = self._collect(
            list(self.scheduler.running) + self.scheduler.finished
        )
        self.scheduler.clear()
        return token_ids, num_tokens, None, elapsed

    def warmup(self, batches=(1,), prompt_len: int = 16, rounds: int = 2) -> None:
        """Drive dummy requests through real serve rounds at each batch size
        in ``batches`` (cuBLAS handles, kernel libraries, the allocator's
        pools), then discard every trace of them, prefix cache included.
        Each request runs ``rounds`` windows of the configured gamma, at
        ``gamma=-1`` of the adaptive ladder's top."""
        t0 = time.perf_counter()
        gamma = self.config.gamma if self.config.gamma > 0 else max(self.orchestrator._gamma_ladder)
        for b in batches:
            for i in range(min(b, self.config.max_num_seqs)):
                self.add_request(
                    [2 + (i % 7)] * prompt_len,
                    SamplingParams(
                        temperature=0.0, max_tokens=rounds * gamma + 2,
                        ignore_eos=True,
                    ),
                )
            while self.has_work:
                self.orchestrator.serve_round()
            self.scheduler.finished.clear()
        self.scheduler.clear()
        logger.info(f"warmup({batches}) took {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------- continuous serving

    def submit(self, prompt, sampling_params: SamplingParams | None = None) -> int:
        """Queue a request for continuous serving: it joins the running
        batch at the next ``serve_step``."""
        return self.add_request(prompt, sampling_params)

    def serve_step(self, fused_rounds: int = 8, with_deltas: bool = False):
        """Admit what fits and advance the batch by up to ``fused_rounds``
        rounds; returns the requests that finished, as (seq_id,
        completion_token_ids, num_acc_tokens).

        With ``with_deltas`` returns ``(done, deltas)``, deltas being
        (seq_id, new_token_ids, finished). Only the rollback-proof prefix
        is streamed: after an accepted round the last ``window`` committed
        tokens (the gamma of the request's last round) are not all verified
        (the next verdict may cut them and put a revise token in their
        place), so the stable frontier is len(target) - window; after a
        rejected round (pre-verify) the whole stream is verified. A
        consumer never sees a token taken back."""
        self.orchestrator.serve_round(fused_rounds)
        done, deltas = [], []
        now = time.perf_counter()
        for seq in self.scheduler.finished:
            comp = seq.completion_token_ids
            done.append((seq.seq_id, comp, list(seq.num_acc_tokens)))
            if with_deltas:
                deltas.append((seq.seq_id, comp[seq.num_streamed :], True))
                seq.num_streamed = len(comp)
            self._completed_requests += 1
            self._completed_tokens += len(comp)
            self._completed_rounds += seq.num_rounds
            if seq.t_submit is not None and seq.t_first is not None:
                self._lat.append((
                    seq.t_first - seq.t_submit,  # TTFT
                    (now - seq.t_first) / max(1, len(comp) - 1),  # TPOT
                    now - seq.t_submit,  # end to end
                ))
        self.scheduler.finished.clear()
        if not with_deltas:
            return done
        for seq in self.scheduler.running:
            stable = len(seq.target) - (0 if seq.pre_verify else seq.window)
            new = seq.target.token_ids[seq.num_prompt_tokens + seq.num_streamed : stable]
            if new:
                deltas.append((seq.seq_id, new, False))
                seq.num_streamed += len(new)
        return done, deltas

    def cancel(self, request_id: int) -> bool:
        """Abort a queued or running request; its KV blocks are freed and
        its partial output is dropped. Safe between serve_steps: the round
        loop's state is rebuilt from the scheduler every step."""
        return self.scheduler.cancel(request_id)

    def stats(self) -> dict:
        """Queue and batch occupancy, free KV blocks of both pools,
        completion counters, MAT of the completed requests (committed
        tokens per PEARL round, the prefill's token left out, as bench.py
        counts it), prefix-cache and chunked-prefill counters, and latency
        percentiles."""
        sch, orch = self.scheduler, self.orchestrator
        rounds = self._completed_rounds
        return {
            "waiting": len(sch.waiting),
            "running": len(sch.running),
            "draft_free_blocks": sch.draft_bm.num_free_blocks,
            "target_free_blocks": sch.target_bm.num_free_blocks,
            "completed_requests": self._completed_requests,
            "completed_tokens": self._completed_tokens,
            "mat": (self._completed_tokens - self._completed_requests) / rounds if rounds else None,
            "prefix_hit_tokens": orch.prefix_hit_tokens,
            "chunked_prefill_passes": orch.chunked_passes,
            **self._latency_stats(),
        }

    def _latency_stats(self) -> dict:
        """TTFT / TPOT / end-to-end p50 and p95 (seconds) over the last 512
        completions. TTFT: submit to the first committed token (the prefill
        sample); TPOT: mean time per token after it. HTTP handler threads
        read this while the driver thread appends: ``list()`` copies the
        deque in one call, where iterating it could see it change."""
        lat = list(self._lat)
        if not lat:
            return {}
        out = {}
        for i, name in enumerate(("ttft", "tpot", "e2e")):
            vals = sorted(v[i] for v in lat)
            out[f"{name}_p50_s"] = round(vals[len(vals) // 2], 4)
            out[f"{name}_p95_s"] = round(vals[min(len(vals) - 1, int(len(vals) * 0.95))], 4)
        return out

    @property
    def has_work(self) -> bool:
        return not self.scheduler.is_finished()
