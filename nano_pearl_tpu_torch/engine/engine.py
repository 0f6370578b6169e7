"""User-facing engine (counterpart of nano_pearl_tpu/engine/engine.py).

    engine = PearlEngine(config)                 # on the CUDA device
    engine = PearlEngine(config, device="cpu")   # plain versions, for tests
    engine.add_request(token_ids, SamplingParams(...))
    token_ids, num_tokens, num_acc_tokens, elapsed = engine.generate_token_ids()
    ... = engine.AR_generate_token_ids()
    ... = engine.bench_generate(num_pearl_steps=100)

The port runs the fused path on one device: draft and target share it.
Its entry points run on CUDA unless the caller asks for the CPU; with no
CUDA device and no explicit ``device="cpu"`` the engine raises.
"""

from __future__ import annotations

import torch

from nano_pearl_tpu_torch.config import PearlConfig, SamplingParams
from nano_pearl_tpu_torch.engine.pearl import PearlOrchestrator
from nano_pearl_tpu_torch.engine.runner import GroupRunner
from nano_pearl_tpu_torch.engine.scheduler import Scheduler
from nano_pearl_tpu_torch.engine.sequence import Sequence
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
    """Raise on engine features the port does not run yet."""
    unsupported = {
        "tensor/sequence/pipeline/expert parallel groups": any(
            x != 1 for x in (
                config.draft_tp, config.target_tp, config.draft_sp, config.target_sp,
                config.draft_pp, config.target_pp, config.draft_ep, config.target_ep,
            )
        ),
        "execution_mode='overlap'": config.execution_mode == "overlap",
        "acceptance-adaptive gamma (gamma=-1)": config.gamma <= 0,
        "the 'throughput' perf profile": config.perf_profile != "ceiling",
        "engine warmup": bool(config.warmup),
        "an explicit device list": config.devices is not None,
    }
    missing = [k for k, v in unsupported.items() if v]
    if missing:
        raise NotImplementedError("not ported yet: " + ", ".join(missing))


class PearlEngine:
    def __init__(
        self,
        config: PearlConfig,
        draft_params: dict | None = None,
        target_params: dict | None = None,
        device=None,
    ):
        """``draft_params``/``target_params``: weights in the JAX package's
        pytree layout, as numpy arrays or as the port's tensors; random
        weights from ``config.seed`` when omitted."""
        _check_config(config)
        self.config = config
        self.device = resolve_device(device)
        self.draft = GroupRunner(
            config, config.draft_config, self.device, name="draft",
            params=draft_params, seed=config.seed,
        )
        self.target = GroupRunner(
            config, config.target_config, self.device, name="target",
            params=target_params, seed=config.seed + 1,
        )
        self.scheduler = Scheduler(config, self.draft.num_blocks, self.target.num_blocks)
        self.generator = torch.Generator(self.device).manual_seed(config.seed)
        self.orchestrator = PearlOrchestrator(
            config, self.draft, self.target, self.scheduler, self.generator
        )
        logger.info(f"PearlEngine ready on {self.device}.", color="green")

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
