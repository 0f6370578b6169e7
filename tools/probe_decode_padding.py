#!/usr/bin/env python3
"""What the gamma-scan's decode padding costs on the card.

    python3 tools/probe_decode_padding.py [--cases bench,1,8,136]

engine/fused.py runs the draft's decode in calls of one verify chunk's
rows (``FusedPearl.decode_chunking``), so that decode and verify round
alike. This script times PEARL rounds with that chunking ("engine") and
with one decode call over the batch's own rows ("unpadded", the layout
before the fix), in one process, in the order engine, unpadded,
unpadded, engine, twice:

- the bench pair (bf16 3L/36L, 8x128 heads), B=32, gamma=14: 224 rows
  against 32;
- the serve pair (bf16 3L/36L, 16x64 heads), gamma=8, at B=1 and B=8
  (batch bucket 8): 128 rows against 8; at B=136 (bucket 256): two calls
  of 128 rows against one of 256.

A round's time is the wall time of ``FusedPearl.run_pearl`` between two
synchronisations over ROUNDS rounds, prefill left out. The loop is
host-bound, so that time carries the host's spread; one more run per
variant (engine, unpadded, unpadded, engine) of 5 rounds, or 2 above 32
sequences (the profiler's own cost grows with the launches), sums the
device's kernel time under torch.profiler, which the padding changes and
the host does not. ``--cases`` picks the bench pair ("bench") and the
serve pair's batch sizes. For each case it prints one JSON line:
ms per round, device kernel ms per round and MAT of each run, after the
card's name and power limit. Needs one CUDA card.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import add_requests, nvidia_smi, pair_engine, serve_args  # noqa: E402

ROUNDS = 40
ORDER = ("engine", "unpadded", "unpadded", "engine") * 2


def serve_engine(batch: int):
    from nano_pearl_tpu_torch import serve

    return serve.build_engine(serve_args(), num_kvcache_blocks=batch * 4 + 16, max_num_seqs=256)


def device_kernel_us(prof) -> float:
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def time_rounds(engine, batch: int, variant: str, rounds: int, profiled: bool = False):
    """(ms per round, MAT) of one bench_generate run of ``rounds`` rounds;
    with ``profiled``, device kernel ms per round in place of the wall
    time."""
    from torch.profiler import ProfilerActivity, profile

    fused = engine.orchestrator.fused
    if variant == "unpadded":
        fused.decode_chunking = lambda b, gamma: (1, b)
    spent = [0.0]
    run_pearl = fused.run_pearl

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        if profiled:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = run_pearl(*args, **kwargs)
                torch.cuda.synchronize()
            spent[0] += device_kernel_us(prof) / 1e6
            return out
        t0 = time.perf_counter()
        out = run_pearl(*args, **kwargs)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        return out

    fused.run_pearl = timed
    try:
        add_requests(engine, np.random.default_rng(1), batch, 64, 512)
        _, num_tokens, _, _ = engine.bench_generate(num_pearl_steps=rounds)
    finally:
        for name in ("run_pearl", "decode_chunking"):
            fused.__dict__.pop(name, None)
    return spent[0] * 1e3 / rounds, float(np.mean([(n - 1) / rounds for n in num_tokens]))


def case(name: str, engine, batch: int) -> dict:
    add_requests(engine, np.random.default_rng(0), batch, 64, 512)
    engine.bench_generate(num_pearl_steps=4)  # warm-up, not measured
    runs = {"engine": [], "unpadded": []}
    device = {"engine": [], "unpadded": []}
    for variant in ORDER:
        runs[variant].append(time_rounds(engine, batch, variant, ROUNDS))
    profiled_rounds = 5 if batch <= 32 else 2
    for variant in ORDER[:4]:
        device[variant].append(time_rounds(engine, batch, variant, profiled_rounds, profiled=True)[0])
    fused = engine.orchestrator.fused
    b_pad = engine.config.bucket_batch(batch)
    out = {
        "case": name, "batch": batch, "batch_bucket": b_pad, "rounds_per_run": ROUNDS,
        "engine_decode_calls_x_rows": list(fused.decode_chunking(b_pad, engine.config.gamma)),
        "unpadded_decode_rows": b_pad,
        **{f"{v}_ms_per_round": [r[0] for r in rs] for v, rs in runs.items()},
        **{f"{v}_mat": [r[1] for r in rs] for v, rs in runs.items()},
        **{f"{v}_device_kernel_ms_per_round": ms for v, ms in device.items()},
    }
    e, u = (float(np.mean([r[0] for r in runs[v]])) for v in ("engine", "unpadded"))
    out["engine_over_unpadded"] = e / u
    e, u = (float(np.mean(device[v])) for v in ("engine", "unpadded"))
    out["device_engine_over_unpadded"] = e / u if u > 0 else None  # None: no device event seen
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cases", default="bench,1,8,136",
                   help="comma-separated: 'bench' and/or serve-pair batch sizes")
    cases = p.parse_args().cases.split(",")
    if not torch.cuda.is_available():
        print("probe_decode_padding: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(nvidia_smi(), flush=True)
    if "bench" in cases:
        engine = pair_engine(3, 36, "bfloat16", 32, 14, ROUNDS + 8, 64, dev)
        case("bench pair 3L/36L, 8x128 heads, gamma 14", engine, 32)
        del engine
        torch.cuda.empty_cache()
    for batch in (int(c) for c in cases if c != "bench"):
        engine = serve_engine(batch)
        case("serve pair 3L/36L, 16x64 heads, gamma 8", engine, batch)
        del engine
        torch.cuda.empty_cache()
    print(nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
