#!/usr/bin/env python3
"""MAT of the noisy bench paths over several prompt sets, on one card.

    python3 tools/mat_spread.py [--paths throughput,fresh_kernel,qthr] [--prompt-seeds 1,2,3,4]
                                [--tree ROOT]

For each path builds chip_smoke.py's engine once (the bf16 3L/36L
layer-share pair, B=32, gamma=14, prompt 64, draft_noise 0.005 under the
throughput profile: "throughput" is chip_smoke.py's throughput_path,
"fresh_kernel" its fresh_kernel_path, NANO_PEARL_FRESH_MODE=kernel set
around the engine's construction, "qthr" its quant_throughput_path, fp8 KV
cache and fp8 weights), warms it up as chip_smoke.py does, and then runs
the path's PEARL window (145 rounds; 73 for fresh_kernel and qthr) once per
prompt set, the prompts drawn from ``numpy.random.default_rng(seed)``
(chip_smoke.py draws seed 1). Prints one JSON line per path and seed with
bench.py's MAT, ``(n - 1) / rounds`` averaged over the sequences, and one
per path with their least, greatest and mean. The card's name and power
limit come first.

A noisy draft's MAT is fixed by the tree's bits: a kernel that rounds
otherwise moves it, by an amount these prompt sets show the spread of.
``--tree ROOT`` runs another tree of the repository (its package and
chip_smoke.py) under this script, so that a parent tree is measured the
same way in the same call. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch


def _tree() -> Path:
    """The tree whose package and chip_smoke.py run (``--tree ROOT``), else
    this one."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[1])
    return pre.parse_known_args()[0].tree.resolve()


sys.path.insert(0, str(_tree()))

from chip_smoke import OVERRIDE_PATHS, add_requests, nvidia_smi, pair_engine  # noqa: E402

BATCH, GAMMA, PROMPT, NOISE = 32, 14, 64, 0.005
# path -> (PEARL rounds, schedule overrides, (KV cache, weight) quantization)
PATHS = {
    "throughput": (145, None, (None, None)),
    "fresh_kernel": (73, OVERRIDE_PATHS["fresh_kernel_path"][2], (None, None)),
    "qthr": (73, None, ("fp8", "fp8")),
}


def path_mats(dev, path: str, seeds: list[int]) -> list[float]:
    rounds, env, (kv_quant, quant) = PATHS[path]
    engine = pair_engine(3, 36, "bfloat16", BATCH, GAMMA, rounds, PROMPT, dev, "throughput", NOISE,
                         kv_quant=kv_quant, quant=quant, env=env)
    max_tokens = rounds * (GAMMA + 1)
    add_requests(engine, np.random.default_rng(0), BATCH, PROMPT, max_tokens)  # warm-up, as chip_smoke.py's
    engine.bench_generate(num_pearl_steps=2, reserve_steps=rounds)
    mats = []
    for seed in seeds:
        add_requests(engine, np.random.default_rng(seed), BATCH, PROMPT, max_tokens)
        _, num_tokens, _, _ = engine.bench_generate(num_pearl_steps=rounds)
        mats.append(float(np.mean([(n - 1) / rounds for n in num_tokens])))
        print(json.dumps({"path": path, "rounds": rounds, "prompt_seed": seed, "mat": mats[-1]}), flush=True)
    del engine
    torch.cuda.empty_cache()
    return mats


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", default="throughput,fresh_kernel,qthr", help=f"of {', '.join(PATHS)}")
    ap.add_argument("--prompt-seeds", default="1,2,3,4")
    ap.add_argument("--tree", help="measure this other tree of the repository (its package and chip_smoke.py)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mat_spread: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    print(nvidia_smi(), flush=True)
    seeds = [int(s) for s in args.prompt_seeds.split(",")]
    for path in args.paths.split(","):
        mats = path_mats(dev, path, seeds)
        print(json.dumps({"path": path, "tree": str(_tree()), "prompt_seeds": seeds, "mat_min": min(mats),
                          "mat_max": max(mats), "mat_mean": float(np.mean(mats))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
