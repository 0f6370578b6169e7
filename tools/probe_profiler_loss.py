#!/usr/bin/env python3
"""How often a torch.profiler session of one kernel call loses its kernel records.

    python3 tools/probe_profiler_loss.py [--seconds 150]

``chip_smoke.py`` reads the blocks a wrapper launched from a profiler trace
of one call (``launched_blocks``, through ``kernel_trace``). This script
profiles one call of K3 (``prefill_self``, at chip_smoke.py's D
16/32/128/256 rows) in a new session each time, with ``time_ms`` between
every fifth session as the rows time their kernels, for ``--seconds``.
Sessions alternate between ``kernel_trace``'s idle margin around the call
and none. For each, it counts the sessions that lack a kernel record of
one of their launch calls (``short``; ``empty`` where they hold no kernel
record) and the longest run of consecutive short sessions. It prints the
card's name and power limit, then one JSON line. Run from the repository
root; needs one CUDA card.
"""
import argparse
import collections
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from nano_pearl_tpu_torch.ops.cuda import build  # noqa: E402
from nano_pearl_tpu_torch.ops.cuda import prefill_attention as kpf  # noqa: E402

SHAPES = ((16, 16, 8), (32, 16, 4), (256, 8, 2), (128, 8, 2))  # (d, hq, hkv)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=150.0)
    seconds = ap.parse_args().seconds
    print(cs.nvidia_smi(), flush=True)
    build.build_all()
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    gen = torch.Generator(dev).manual_seed(0)
    args = {d: cs.prefill_inputs(gen, dev, 32, 128, 64, hq, d, hkv) for d, hq, hkv in SHAPES}
    stats = {pad: collections.Counter() for pad in ("margin", "none")}
    streak = collections.Counter()
    t0, i = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        d = SHAPES[i // 2 % len(SHAPES)][0]
        pad = ("margin", "none")[i % 2]
        run = lambda: kpf.prefill_self(*args[d])  # noqa: E731
        if i % 5 == 0:
            cs.time_ms(run, 20, flush)
        events, calls = cs.kernel_trace(run, **({} if pad == "margin" else {"pad_s": 0.0}))
        st = stats[pad]
        st["sessions"] += 1
        short = len(events) < calls or not events
        st["short"] += short
        st["empty"] += not events
        streak[pad] = streak[pad] + 1 if short else 0
        st["longest_short_run"] = max(st["longest_short_run"], streak[pad])
        i += 1
    print(json.dumps({"stats": stats, "seconds": time.perf_counter() - t0}))

if __name__ == "__main__":
    main()
