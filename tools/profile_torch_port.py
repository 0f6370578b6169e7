#!/usr/bin/env python3
"""Where the time goes on the card: the PyTorch port's bench paths under
torch.profiler.

    python3 tools/profile_torch_port.py [--paths main,throughput,split,deferred_db,fresh_kernel,sp,fallback,quant,
                                                 qthr,overlap,moe,moe_thr,fused,tp,prefill]
                                        [--unprofiled] [--pearl-only] [--tree ROOT]

For each path builds the bench's bf16 3L/36L layer-share pair at B=32,
gamma=14 (as chip_smoke.py does) and drives chip_smoke.py's window of
that path: 145 PEARL rounds, then 2174 AR steps, on the same prompts.
"main" is the ceiling profile on the noiseless pair; "throughput" the
throughput profile with draft_noise 0.005 (chip_smoke.py's
throughput_path); "split", "deferred_db" and "fresh_kernel" chip_smoke.py's
split_path (main under NANO_PEARL_SPLIT=1: K8a, K8b), deferred_db_path
(main under NANO_PEARL_DEFERRED_VERIFY=1: K1, K6a) and fresh_kernel_path
(throughput under NANO_PEARL_FRESH_MODE=kernel), the variable set around
the engine's construction only; "sp" chip_smoke.py's sp_path (main with draft_sp =
target_sp = 2, both shards on the one card: K11a/K11c and the merge);
"fallback" the main path's run on the layer-share pair at SmolLM2-360M's
published widths (3L/32L, 15x64 query heads over 5: chip_smoke.py's
checkpoint_path shapes, built in memory, no checkpoint written), whose
Hkv * D = 320 sends decode to K10a and the verify to K10b; "quant"
chip_smoke.py's quant_path (main with an int8 KV cache and int8 weights,
bench.py --kv-quant int8 --quant int8: decode through K9a, the verify
through K9b); "qthr" chip_smoke.py's quant_throughput_path (throughput
with draft_noise 0.005 over an fp8 KV cache and fp8 weights, bench.py
--kv-quant fp8 --quant fp8: the draft's decode and the target's classic
verify through K9c); "overlap" chip_smoke.py's overlap_path (main under
execution_mode="overlap": the per-round loop, the draft's gamma-scan on
one CUDA stream and the target's verify and verdict on another); "moe" chip_smoke.py's moe_path (bench.py
--moe's layer-share pair: the main widths with 8 experts of width 1024,
top-2, whose decode and verify run the dense MoE dispatch), "moe_thr" the
same pair under the throughput profile with draft_noise 0.005 (its packed
verify of 32 x 14 rows takes the sorted dispatch, one host read of its
segment sizes per MoE layer: the ``moe_sorted_dispatch`` stage's calls per
round); "fused" chip_smoke.py's fuse_proj_path (the main path's pair with
fused projections, bench.py --fuse-proj: one qkv and one gate|up product a
layer); "tp" chip_smoke.py's tp_path (main with draft_tp = target_tp = 2 in
union placement, both ranks on the one card: each rank's products and
K1/K2/K3 over one KV head, the ranks' sums on the host: the ``tp_rank_sum``
stage). An
override path and the overlap path run their PEARL rounds only: the
override's AR is the base path's program, and AR runs the fused AR loop
in every mode. Each loop runs twice:

- unprofiled: CUDA events before the first round (step) and after each
  give the loop's time as the device sees it, its prefill left out;
- profiled: every PEARL_SAMPLE-th round (AR_SAMPLE-th step) is recorded
  alone, between two synchronisations, so the samples spread over the
  whole window and see its growing contexts.

For each path and loop it prints one JSON line: loop ms per round, PEARL (AR)
tok/s (committed tokens over the loop's host seconds, as chip_smoke.py
counts them), sampled device
kernel ms per round, the device's idle share (1 - kernel time / loop
time; on the overlap path the kernel time is the union of both streams'
kernel intervals in the window's trace, ``device_busy_ms_per_round``, and
``streams_concurrent_share`` the share of the draft stream's kernel time
a target-stream kernel overlapped), launches per round, the kernels
with the most device time, and, for PEARL rounds, the host's time per
round inside each stage of the round (draft gamma-scan, target verify
and its attention, writeback and LM head, verdict), taken with
perf_counter around those calls in the unprofiled run: the host only
enqueues there, so this is dispatch time. It prints the card's name and
power limit first. Needs one CUDA card. ``--unprofiled`` runs the PEARL
loop's unprofiled pass alone (loop ms, tok/s and host stages, K1's, K2's,
K5's, K9a-c's wrappers among them; no profiler pass, no AR loop), under a minute a path,
for turns of two trees in one call. ``--pearl-only`` leaves every AR loop out
(a fused path's round beside the overlap path's in one short call).
``--tree ROOT`` runs another tree of the
repository (its package and chip_smoke.py) under this script, so that a
parent tree is measured with the same stages.

"prefill" is no bench path: it runs the prefill kernels K3 and K4 alone
at chip_smoke.py's main K3/K4 rows (L2 warm, PREFILL_CALLS calls after
three warm-ups) and prints, for each row, the mean device microseconds
per call of each CUDA kernel a call launches (how a K4 call divides
between its tile kernel and its combine) and the host microseconds the
wrapper takes to enqueue a call.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import json
import os
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, schedule



def _tree() -> Path:
    """The tree whose package and chip_smoke.py run: ``--tree ROOT`` (another
    tree of the repository, so that two trees take the same measurement in
    paired turns, tools/pair_trees.py), else this one."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[1])
    return pre.parse_known_args()[0].tree.resolve()


sys.path.insert(0, str(_tree()))

from chip_smoke import (  # noqa: E402
    FUSED_WIDTHS,
    MOE_WIDTHS,
    OVERRIDE_PATHS,
    PREFIX_ROWS,
    SMOLLM2_360M,
    add_requests,
    busy,
    nvidia_smi,
    overlap_share,
    pair_engine,
    prefill_inputs,
    prefix_inputs,
)

BATCH, GAMMA, ROUNDS, PROMPT = 32, 14, 145, 64
AR_STEPS = ROUNDS * (GAMMA + 1) - 1  # chip_smoke.py's AR window
PEARL_SAMPLE, AR_SAMPLE = 5, 50
# chip_smoke.py's main K3 rows (prefill_inputs' arguments) and K4 rows
PREFILL_ROWS = {
    "prefill_self": ("self", dict(b=32, lq=128, n=64, hq=8, d=128)),
    "prefill_self_serve": ("self", dict(b=8, lq=128, n=64, hq=16, d=64)),
    **{name: ("prefix", PREFIX_ROWS[name])
       for name in ("prefill_prefix", "prefill_prefix_chunked_pass", "prefill_prefix_d128")},
}
PREFILL_CALLS = 20


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
    """on_trace_ready handler: sums the device work of each recorded window;
    with ``streams``, also the union of the kernels' intervals over all
    streams and the draft stream's (the window's earliest kernel's) share
    overlapped by another stream's kernels, from the window's trace."""

    def __init__(self, streams: bool = False):
        self.n, self.us, self.launches = 0, 0.0, 0
        self.us_by_name, self.count_by_name = Counter(), Counter()
        self.streams, self.busy_us, self.shares = streams, 0.0, []

    def _stream_intervals(self, prof) -> None:
        with tempfile.TemporaryDirectory(prefix="profile_torch_port_") as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                kernels = sorted((e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"),
                                 key=lambda e: e["ts"])
        by_stream = {}
        for e in kernels:
            by_stream.setdefault(e["args"]["stream"], []).append([e["ts"], e["ts"] + e["dur"]])
        self.busy_us += sum(hi - lo for lo, hi in busy([iv for ivs in by_stream.values() for iv in ivs]))
        if kernels:
            draft = kernels[0]["args"]["stream"]
            others = [iv for s, ivs in by_stream.items() if s != draft for iv in ivs]
            self.shares.append(overlap_share(by_stream[draft], others))

    def __call__(self, prof) -> None:
        if self.streams:
            self._stream_intervals(prof)
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


# path -> (profile, draft noise, schedule overrides or None, draft_sp = target_sp)
PATHS = {
    "main": ("ceiling", 0.0, None, 1),
    "throughput": ("throughput", 0.005, None, 1),
    "split": OVERRIDE_PATHS["split_path"][:3] + (1,),
    "deferred_db": OVERRIDE_PATHS["deferred_db_path"][:3] + (1,),
    "fresh_kernel": OVERRIDE_PATHS["fresh_kernel_path"][:3] + (1,),
    "sp": ("ceiling", 0.0, None, 2),
    "overlap": ("ceiling", 0.0, None, 1),
    "fallback": ("ceiling", 0.0, None, 1),
    "quant": ("ceiling", 0.0, None, 1),
    "qthr": ("throughput", 0.005, None, 1),
    "moe": ("ceiling", 0.0, None, 1),
    "moe_thr": ("throughput", 0.005, None, 1),
    "fused": ("ceiling", 0.0, None, 1),
    "tp": ("ceiling", 0.0, None, 1),
}
# path -> draft_tp = target_tp (union placement on the one card) where not 1
TP = {"tp": 2}
# path -> (target layers, the pair's widths, their name) where not the bench's pair
PAIRS = {"fallback": (32, SMOLLM2_360M, "SmolLM2-360M"), "moe": (36, MOE_WIDTHS, "bench.py --moe"),
         "moe_thr": (36, MOE_WIDTHS, "bench.py --moe"), "fused": (36, FUSED_WIDTHS, "fused projections")}
# path -> (KV cache quantization, weight quantization) of both models
QUANT = {"quant": ("int8", "int8"), "qthr": ("fp8", "fp8")}
# paths run under execution_mode="overlap" (PEARL rounds only)
OVERLAP = {"overlap"}
# (module, attribute) called once or more per PEARL round: the host time
# spent inside each is summed; a stage the path does not run reads 0
HOST_STAGES = {
    "draft_gamma_scan": ("nano_pearl_tpu_torch.engine.fused", "FusedPearl._draft_gamma"),
    "target_verify": ("nano_pearl_tpu_torch.engine.fused", "FusedPearl._target_packed"),
    "verify_attention_k2": ("nano_pearl_tpu_torch.engine.runner", "paged_attention_grouped"),
    "verify_attention_deferred": ("nano_pearl_tpu_torch.engine.runner", "paged_attention_grouped_fresh"),
    "k1_wrapper": ("nano_pearl_tpu_torch.ops.cuda.paged_attention", "paged_decode"),
    "k2_wrapper": ("nano_pearl_tpu_torch.ops.cuda.paged_attention", "paged_verify"),
    "k9a_wrapper": ("nano_pearl_tpu_torch.ops.cuda.paged_attention", "paged_decode_q8"),
    "k9b_wrapper": ("nano_pearl_tpu_torch.ops.cuda.paged_attention", "paged_verify_q8"),
    "k5_wrapper": ("nano_pearl_tpu_torch.ops.cuda.mono_attention", "mono_attention"),
    "k9c_wrapper": ("nano_pearl_tpu_torch.ops.cuda.mono_attention", "mono_q8"),
    "k7_wrapper": ("nano_pearl_tpu_torch.ops.cuda.mono_attention", "cache_partials"),
    "k6b_wrapper": ("nano_pearl_tpu_torch.ops.cuda.mono_attention", "mono_fresh"),
    "k6a_wrapper": ("nano_pearl_tpu_torch.ops.cuda.paged_attention", "paged_verify_fresh"),
    "k8a_wrapper": ("nano_pearl_tpu_torch.ops.cuda.paged_attention", "paged_decode_split"),
    "k8b_wrapper": ("nano_pearl_tpu_torch.ops.cuda.paged_attention", "paged_verify_fresh_split"),
    "draft_attention_k8a": ("nano_pearl_tpu_torch.engine.runner", "paged_attention_split"),
    "fresh_window_partials": ("nano_pearl_tpu_torch.ops.attention", "fresh_window_partials"),
    "merge_attn_partials": ("nano_pearl_tpu_torch.ops.attention", "merge_attn_partials"),
    "k12_writeback": ("nano_pearl_tpu_torch.engine.runner", "write_fresh"),
    "sp_decode_attention": ("nano_pearl_tpu_torch.engine.runner", "sp_paged_attention"),
    "sp_verify_attention": ("nano_pearl_tpu_torch.engine.runner", "sp_paged_attention_grouped"),
    "sp_merge": ("nano_pearl_tpu_torch.parallel.sp", "merge_partials"),
    "k10a_wrapper": ("nano_pearl_tpu_torch.ops.cuda.paged_attention_fallback", "paged_decode_fallback"),
    "k10b_wrapper": ("nano_pearl_tpu_torch.ops.cuda.paged_attention_fallback", "paged_verify_fallback"),
    "k11a_wrapper": ("nano_pearl_tpu_torch.ops.cuda.paged_attention_partials", "paged_decode_partials"),
    "k11c_wrapper": ("nano_pearl_tpu_torch.ops.cuda.paged_attention_partials", "paged_verify_partials"),
    "sp_write_rows": ("nano_pearl_tpu_torch.parallel.sp", "store_rows"),
    "lm_head": ("nano_pearl_tpu_torch.engine.runner", "compute_logits"),
    "lm_head_tp": ("nano_pearl_tpu_torch.engine.runner", "compute_logits_tp"),
    # the ranks' partial products summed in rank order (wo, wdown, the embedding)
    "tp_rank_sum": ("nano_pearl_tpu_torch.models.transformer", "rank_sum"),
    "moe_block": ("nano_pearl_tpu_torch.models.transformer", "moe_mlp"),
    # one host read of the segment sizes a call
    "moe_sorted_dispatch": ("nano_pearl_tpu_torch.ops.moe", "_moe_mlp_sorted"),
    "verdict": ("nano_pearl_tpu_torch.engine.fused", "verify_verdict"),
    "overlap_verify_forward": ("nano_pearl_tpu_torch.engine.runner", "GroupRunner.verify_forward"),
    "overlap_verdict": ("nano_pearl_tpu_torch.engine.runner", "GroupRunner.verdict"),
    # host reads of the draft tokens and the verdict: these wait on the device
    "overlap_host_reads": ("nano_pearl_tpu_torch.engine.pearl", "PearlOrchestrator._fetch"),
}


class HostStages:
    """Wraps each of HOST_STAGES with a perf_counter timer while active."""

    def __init__(self):
        self.s, self.calls, self.saved = Counter(), Counter(), []

    def __enter__(self):
        for label, (mod, attr) in HOST_STAGES.items():
            owner = importlib.import_module(mod)
            *path, name = attr.split(".")
            for part in path:
                owner = getattr(owner, part)
            orig = getattr(owner, name)

            # wraps: a kernel wrapper counts its launches on its own name
            @functools.wraps(orig)
            def timed(*args, _orig=orig, _label=label, **kwargs):
                t0 = time.perf_counter()
                try:
                    return _orig(*args, **kwargs)
                finally:
                    self.s[_label] += time.perf_counter() - t0
                    self.calls[_label] += 1

            self.saved.append((owner, name, orig))
            setattr(owner, name, timed)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self.saved):
            setattr(owner, name, orig)


def measure(engine, label: str, unit: str, owner, name: str, sample: int, drive, profiled: bool = True,
            streams: bool = False) -> dict:
    add_requests(engine, np.random.default_rng(1), BATCH, PROMPT, ROUNDS * (GAMMA + 1))
    with PerRound(owner, name) as timed, HostStages() as host:
        _, num_tokens, _, elapsed = drive()
    loop_ms = timed.start.elapsed_time(timed.end)
    n = timed.calls
    host_stages = {k: {"host_ms_per_" + unit: host.s[k] * 1e3 / n, "calls_per_" + unit: host.calls[k] / n,
                       "host_us_per_call": host.s[k] * 1e6 / host.calls[k]}
                   for k in HOST_STAGES if host.calls[k]}
    # committed tokens over the loop's host seconds, as chip_smoke.py's tok/s
    # (the stages' timers included)
    tok_s = sum(num_tokens) / elapsed
    if not profiled:
        return {"phase": label, unit + "s": n, "loop_ms_per_" + unit: loop_ms / n, "tok_s": tok_s,
                "host_stages": host_stages}

    windows = Windows(streams)
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
    busy_ms = windows.busy_us / 1e3 / windows.n if streams else kernel_ms
    if not 0 < busy_ms <= loop_ms / n:
        raise RuntimeError(f"{label}: {busy_ms} device ms per {unit} against a loop of {loop_ms / n} ms")
    top = windows.us_by_name.most_common(12)
    return {
        "phase": label,
        unit + "s": n,
        "sampled_" + unit + "s": windows.n,
        "loop_ms_per_" + unit: loop_ms / n,
        "tok_s": tok_s,
        "device_kernel_ms_per_" + unit: kernel_ms,
        **({"device_busy_ms_per_" + unit: busy_ms,
            "streams_concurrent_share": float(np.mean(windows.shares))} if streams else {}),
        "device_idle_share": 1.0 - busy_ms / (loop_ms / n),
        "device_launches_per_" + unit: windows.launches / windows.n,
        "profiled_run_s": profiled_s,
        "host_stages": host_stages,
        "top_kernels": [
            {"name": k, "ms_per_" + unit: us / 1e3 / windows.n,
             "launches_per_" + unit: windows.count_by_name[k] / windows.n}
            for k, us in top
        ],
    }


def profile_path(dev, path: str, profiled: bool = True, pearl_only: bool = False) -> None:
    profile, noise, env, sp = PATHS[path]
    layers, widths, pair = PAIRS.get(path, (36, None, None))
    kv_quant, quant = QUANT.get(path, (None, None))
    mode = "overlap" if path in OVERLAP else "auto"
    engine = pair_engine(3, layers, "bfloat16", BATCH, GAMMA, ROUNDS, PROMPT, dev, profile, noise, kv_quant=kv_quant,
                         quant=quant, env=env, sp=sp, widths=widths, mode=mode, tp=TP.get(path, 1))
    fused = engine.orchestrator.fused
    # warm-up, as chip_smoke.py does, not measured
    add_requests(engine, np.random.default_rng(0), BATCH, PROMPT, ROUNDS * (GAMMA + 1))
    engine.bench_generate(num_pearl_steps=2, reserve_steps=ROUNDS)
    pearl_only = pearl_only or env is not None or path in OVERLAP
    if not pearl_only:
        add_requests(engine, np.random.default_rng(0), BATCH, PROMPT, ROUNDS * (GAMMA + 1))
        engine.AR_bench_generate(num_steps=4, reserve_steps=AR_STEPS)

    head = {"path": path, "profile": profile, "draft_noise": noise, **({"env": env} if env else {}),
            **({"draft_sp": sp, "target_sp": sp} if sp > 1 else {}),
            **({"draft_tp": TP[path], "target_tp": TP[path]} if path in TP else {}),
            **({"target_layers": layers, "widths": pair} if widths else {}),
            **({"kv_quant": kv_quant, "quant": quant} if kv_quant else {}),
            **({"execution_mode": mode} if mode != "auto" else {})}
    owner, name = (engine.orchestrator, "pearl_round") if path in OVERLAP else (fused, "_pearl_round")
    out = measure(engine, "pearl", "round", owner, name, PEARL_SAMPLE,
                  lambda: engine.bench_generate(num_pearl_steps=ROUNDS), profiled, streams=path in OVERLAP)
    print(json.dumps({**head, **out}), flush=True)
    if not pearl_only and profiled:
        out = measure(engine, "ar", "step", fused.target, "decode_step", AR_SAMPLE,
                      lambda: engine.AR_bench_generate(num_steps=AR_STEPS))
        print(json.dumps({**head, **out}), flush=True)
    del engine, fused
    torch.cuda.empty_cache()


def profile_prefill(dev) -> None:
    """Device us per call by CUDA kernel, and the wrapper's host us per
    call, of K3/K4 at each of PREFILL_ROWS."""
    from nano_pearl_tpu_torch.ops.cuda import prefill_attention as kpf

    gen = torch.Generator(dev).manual_seed(0)
    for row, (kind, shape) in PREFILL_ROWS.items():
        if kind == "self":
            args, fn = prefill_inputs(gen, dev, **shape), kpf.prefill_self
        else:
            args, fn = prefix_inputs(gen, dev, **shape), kpf.prefill_prefix
        for _ in range(3):
            fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()  # unprofiled: the host's enqueue time alone
        for _ in range(PREFILL_CALLS):
            fn(*args)
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PREFILL_CALLS):
                fn(*args)
            torch.cuda.synchronize()
        device_us = {e.key: e.self_device_time_total / PREFILL_CALLS for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}
        if not device_us:
            raise RuntimeError(f"{row}: the profiler saw no device time")
        print(json.dumps({"path": "prefill", "row": row, "shape": shape, "calls": PREFILL_CALLS,
                          "host_us_per_call": host_s * 1e6 / PREFILL_CALLS,
                          "device_us_per_call_by_kernel": device_us}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", default="main,throughput",
                    help="comma-separated: " + ", ".join([*PATHS, "prefill"]))
    ap.add_argument("--unprofiled", action="store_true",
                    help="the PEARL loop's unprofiled pass alone: loop ms, tok/s and host stages")
    ap.add_argument("--pearl-only", action="store_true", help="profile the PEARL rounds alone, no AR loop")
    ap.add_argument("--tree", help="profile this other tree of the repository (its package and chip_smoke.py)")
    args = ap.parse_args()
    paths = args.paths.split(",")
    if not set(paths) <= set(PATHS) | {"prefill"}:
        ap.error(f"unknown path in {paths}")
    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"tree": str(_tree())}), flush=True)
    for path in paths:
        if path == "prefill":
            profile_prefill(dev)
        else:
            profile_path(dev, path, not args.unprofiled, args.pearl_only)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
