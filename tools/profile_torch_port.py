#!/usr/bin/env python3
"""Where the time goes on the card: the PyTorch port's main path under
torch.profiler.

    python3 tools/profile_torch_port.py

Builds the bench's bf16 3L/36L layer-share pair at B=32, gamma=14 (as
chip_smoke.py does) and drives chip_smoke.py's main-path window: 145 PEARL
rounds, then 2174 AR steps, on the same prompts. Each loop runs twice:

- unprofiled: CUDA events before the first round (step) and after each
  give the loop's time as the device sees it, its prefill left out;
- profiled: every PEARL_SAMPLE-th round (AR_SAMPLE-th step) is recorded
  alone, between two synchronisations, so the samples spread over the
  whole window and see its growing contexts.

For each loop it prints one JSON line: loop ms per round, sampled device
kernel ms per round, the device's idle share (1 - kernel time / loop
time; the kernels run on one stream), launches per round, and the
kernels with the most device time, after the card's name and power
limit. Needs one CUDA card.
"""

from __future__ import annotations

import json
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, schedule

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import add_requests, nvidia_smi, pair_engine  # noqa: E402

BATCH, GAMMA, ROUNDS, PROMPT = 32, 14, 145, 64
AR_STEPS = ROUNDS * (GAMMA + 1) - 1  # chip_smoke.py's AR window
PEARL_SAMPLE, AR_SAMPLE = 5, 50


class PerRound:
    """Stands in for the method a loop calls once per round (step): a CUDA
    event before the first call and after each; with a profiler, a
    synchronisation and a profiler step after each call, so that every
    recorded window holds exactly one round."""

    def __init__(self, owner, name: str, prof=None):
        self.owner, self.name, self.orig, self.prof = owner, name, getattr(owner, name), prof
        self.start = self.end = None
        self.calls = 0

    def __call__(self, *args, **kwargs):
        if self.start is None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        out = self.orig(*args, **kwargs)
        self.calls += 1
        if self.prof is None:
            self.end = torch.cuda.Event(enable_timing=True)
            self.end.record()
        else:
            torch.cuda.synchronize()
            self.prof.step()
        return out

    def __enter__(self):
        setattr(self.owner, self.name, self)
        return self

    def __exit__(self, *exc):
        delattr(self.owner, self.name)


class Windows:
    """on_trace_ready handler: sums the device work of each recorded window."""

    def __init__(self):
        self.n, self.us, self.launches = 0, 0.0, 0
        self.us_by_name, self.count_by_name = Counter(), Counter()

    def __call__(self, prof) -> None:
        for e in prof.key_averages():
            # the profiler's own "ProfilerStep#n" annotation shows up as a
            # device event spanning the whole window: not a kernel
            if e.key.startswith("ProfilerStep"):
                continue
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
                self.us += e.self_device_time_total
                self.launches += e.count
                self.us_by_name[e.key[:90]] += e.self_device_time_total
                self.count_by_name[e.key[:90]] += e.count
        self.n += 1


def measure(engine, label: str, unit: str, owner, name: str, sample: int, drive) -> dict:
    add_requests(engine, np.random.default_rng(1), BATCH, PROMPT, ROUNDS * (GAMMA + 1))
    with PerRound(owner, name) as timed:
        drive()
    loop_ms = timed.start.elapsed_time(timed.end)
    n = timed.calls

    windows = Windows()
    add_requests(engine, np.random.default_rng(1), BATCH, PROMPT, ROUNDS * (GAMMA + 1))
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
        schedule=schedule(wait=sample - 2, warmup=1, active=1),
        on_trace_ready=windows,
    ) as prof, PerRound(owner, name, prof):
        t0 = time.perf_counter()
        drive()
        profiled_s = time.perf_counter() - t0
    if windows.n == 0:
        raise RuntimeError(f"{label}: the profiler recorded no window")
    kernel_ms = windows.us / 1e3 / windows.n
    if not 0 < kernel_ms <= loop_ms / n:
        raise RuntimeError(f"{label}: {kernel_ms} device ms per {unit} against a loop of {loop_ms / n} ms")
    top = windows.us_by_name.most_common(12)
    return {
        "phase": label,
        unit + "s": n,
        "sampled_" + unit + "s": windows.n,
        "loop_ms_per_" + unit: loop_ms / n,
        "device_kernel_ms_per_" + unit: kernel_ms,
        "device_idle_share": 1.0 - kernel_ms / (loop_ms / n),
        "device_launches_per_" + unit: windows.launches / windows.n,
        "profiled_run_s": profiled_s,
        "top_kernels": [
            {"name": k, "ms_per_" + unit: us / 1e3 / windows.n,
             "launches_per_" + unit: windows.count_by_name[k] / windows.n}
            for k, us in top
        ],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(nvidia_smi(), flush=True)
    engine = pair_engine(3, 36, "bfloat16", BATCH, GAMMA, ROUNDS, PROMPT, dev)
    fused = engine.orchestrator.fused
    # warm-up, as chip_smoke.py does, not measured
    add_requests(engine, np.random.default_rng(0), BATCH, PROMPT, ROUNDS * (GAMMA + 1))
    engine.bench_generate(num_pearl_steps=2, reserve_steps=ROUNDS)
    add_requests(engine, np.random.default_rng(0), BATCH, PROMPT, ROUNDS * (GAMMA + 1))
    engine.AR_bench_generate(num_steps=4, reserve_steps=AR_STEPS)

    out = measure(engine, "pearl", "round", fused, "_pearl_round", PEARL_SAMPLE,
                  lambda: engine.bench_generate(num_pearl_steps=ROUNDS))
    print(json.dumps(out), flush=True)
    out = measure(engine, "ar", "step", fused.target, "decode_step", AR_SAMPLE,
                  lambda: engine.AR_bench_generate(num_steps=AR_STEPS))
    print(json.dumps(out), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
