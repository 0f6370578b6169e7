"""Data-parallel serving: N whole PEARL replicas behind one controller
(counterpart of nano_pearl_tpu/engine/dp.py).

Each replica is a complete draft + target ``PearlEngine`` on its own slice
of the devices (``config.devices``, default the one device ``device``
names): ``draft_tp`` devices a replica under union placement, else
``draft_tp * draft_sp + target_tp * target_sp``. Where the devices run
short, the replicas share them round-robin, with the JAX package's
warning (correctness only, no scaling). Replica r draws its random
weights, where none are handed in, and its sampling noise from
``config.seed + r``.

Requests go to the least-loaded replica (queued + running sequences) at
submit time. Sequence ids are process-wide (engine/sequence.py), so the
replicas' results merge by id. ``generate_token_ids`` runs the replicas'
round loops one after another: the port's fused loop reads its state on
the host every chunk, so one host thread cannot keep two replicas' loops
in flight at once as the JAX package's asynchronous dispatch does.
"""

from __future__ import annotations

import time
from dataclasses import replace

from nano_pearl_tpu_torch.config import PearlConfig, SamplingParams
from nano_pearl_tpu_torch.engine.engine import PearlEngine, resolve_devices
from nano_pearl_tpu_torch.utils.logging import logger


class DataParallelEngine:
    def __init__(
        self,
        config: PearlConfig,
        dp: int,
        draft_params: dict | None = None,
        target_params: dict | None = None,
        device=None,
    ):
        if dp < 1:
            raise ValueError(f"dp must be >= 1, got {dp}")
        _, devices = resolve_devices(config, device)
        if config.placement == "union":
            per = config.draft_tp * config.draft_sp
        else:
            per = config.draft_tp * config.draft_sp + config.target_tp * config.target_sp
        if len(devices) < dp * per:
            if dp * per > 1:
                logger.warning(
                    f"{len(devices)} device(s) for dp={dp} x {per}; replicas will "
                    "share devices (correctness only, no scaling)."
                )
            slices = [[devices[(r * per + i) % len(devices)] for i in range(per)] for r in range(dp)]
        else:
            slices = [devices[r * per : (r + 1) * per] for r in range(dp)]
        self.replicas = [
            PearlEngine(replace(config, devices=slices[r], seed=config.seed + r), draft_params, target_params)
            for r in range(dp)
        ]
        self.config = config
        self.dp = dp

    # ------------------------------------------------------------- routing

    def _least_loaded(self) -> PearlEngine:
        return min(self.replicas, key=lambda r: len(r.scheduler.waiting) + len(r.scheduler.running))

    def add_request(self, prompt, sampling_params: SamplingParams | None = None) -> int:
        return self._least_loaded().add_request(prompt, sampling_params)

    submit = add_request

    # ----------------------------------------------------------- generation

    def generate_token_ids(self):
        """PEARL generation on every replica; returns (token_ids,
        num_tokens, num_acc, elapsed) merged in sequence-id order, the
        contract of ``PearlEngine.generate_token_ids``."""
        start = time.perf_counter()
        results = []
        for eng in self.replicas:
            if eng.scheduler.is_finished():
                continue
            eng.orchestrator.generate_loop()
            finished = eng.scheduler.finished
            num_tokens, num_acc, token_ids = eng._collect(finished)
            ids = sorted(s.seq_id for s in finished)
            results.extend(zip(ids, token_ids, num_tokens, num_acc))
            eng.scheduler.clear()
        results.sort(key=lambda x: x[0])
        return [r[1] for r in results], [r[2] for r in results], [r[3] for r in results], time.perf_counter() - start

    # ------------------------------------------------- continuous serving

    def serve_step(self, fused_rounds: int = 8):
        """One continuous-batching step on every replica; returns the newly
        finished (seq_id, completion_token_ids, num_acc_tokens)."""
        done = []
        for eng in self.replicas:
            done.extend(eng.serve_step(fused_rounds))
        return done

    @property
    def has_work(self) -> bool:
        return any(eng.has_work for eng in self.replicas)
