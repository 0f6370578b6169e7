#!/usr/bin/env python3
"""Drive the PyTorch port (nano_pearl_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root, one H100

Phases, each printing one JSON line (a failed phase raises and the
script exits non-zero without its last line):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: nvcc builds every kernel source under nano_pearl_tpu_torch/csrc
   for sm_90a, one process per source, all at once;
3. kernels: K1 (paged decode), K2 (packed verify) and K3 (causal prefill)
   at the main path's shapes (8x128 heads) and at the serving path's
   (16x64 heads: 128 decode rows, verify chunks of 16 groups x 8 rows,
   8 prompts in a 128-row bucket), K4 (prefill over a cached prefix)
   at the serve pair's prefix hit, a chunked-prefill pass and the bench
   pair's head width, and the throughput path's K5 (mono-schedule
   attention: the B=32 decode, and 14 rows per group), K7 (cache-side
   partials of the deferred verify, 32 groups x 14 rows, pre-round
   contexts of 65-2300 and of 1-50, each against a second launch bit for
   bit) and K12 (its
   writeback, bit for bit over the whole cache), K9a/K9b/K9c (K1, K2 and
   K5 over an int8 or e4m3 cache with bf16 scales: the quantized runs'
   decode, packed verify and mono schedule, each in both 1-byte types),
   against their plain PyTorch versions (bf16, within one
   rounding of the output to bf16: rtol 8e-3, atol 1e-3), K2's rows
   against K1 and K9b's against K9a bit for bit, each K9 row against a
   second launch bit for bit, the kernels of the schedule overrides
   (K8a split-boundary decode at 32 rows, K6a and K8b deferred verify at
   16 groups x 14 rows, K6b at 32 groups x 14 rows, pre-round contexts of
   65-2300 and of 1-50, each against a second launch bit for bit too),
   the fallbacks K10a-d (decode and packed
   verify where Hkv*D % 128 != 0, or over a 1-byte cache of blocks that
   are not a multiple of 32: SmolLM2-360M's 15x64 heads over 5 KV heads
   over bf16 and int8 caches, 4x16 heads, and the bench pair's heads over
   an int8 cache of 16-key blocks; K10b rows == K10a and K10d == K10c bit
   for bit), K1, K2, K5, K9b and K3/K4 at head dims 16, 32 and 256, K2
   and K9b at D 256 with 8 query heads per KV head (bf16 and f32: the
   launchers spread a 14-row group over blocks; K2 rows == K1, K9b ==
   K9a), the per-shard partials kernels of sequence parallelism K11a-d
   (decode and packed verify over a bf16 and an int8 cache split into two
   shards of 260 blocks: each shard's (o, m, l) against the plain version,
   the merged result against K1/K2/K9a/K9b), and
   kernel / plain / library
   (scaled_dot_product_attention or index_copy_, yardsticks the port
   never calls) times from CUDA events with the L2 cache flushed before
   each launch; split_bitwise: K8b's rows against K8a's bit for bit
   (windows inside a 256-key chunk and across one, num_input 1, ctx0 0);
   sp_bitwise: K11c's rows against K11a's, K11d's against K11b's, bit for
   bit per shard and after the merge; prefill_bitwise: K3's rows of the
   main path's prompts in a 128-row and a 256-row bucket, and K4's rows of
   one serve-shape sequence alone and in its batch of 8, bit for bit (the
   K3/K4 rows carry their tiles and split, ``design`` and ``split``, held
   against the launchers' exported choice; the K10/K11, K7 and K6b rows
   their page walk's plan, ``design``, held against the exported
   ``npt_walk_plan``,
   the ``blocks`` they launch, their ``share`` of the bound, and, as the
   K3/K4 rows, ``no_spin``: kernel and SDPA timed without the spin);
4. decode_verify_bitwise: the draft's decode and the target's verify
   chunk re-score one position at the main path's and the serve pair's
   shapes (batches below and above one verify chunk's rows); the first
   op whose outputs differ is printed, and the engine's decode must give
   bitwise-equal logits; then decode_verify_bitwise_overrides (the split
   and deferred-db schedules) and decode_verify_bitwise_throughput, the
   same probe, printed and not asserted;
5. exactness: an f32 layer-share pair (2L/6L, B=4, gamma=4) at full width
   must give PEARL tokens == AR tokens; throughput_exactness: the same
   under the throughput profile with a noisy draft, rejections included;
   quant_exactness: both again, the ceiling one with int8 KV and int8
   weights, the throughput one with fp8 KV and fp8 weights;
   split_exactness, deferred_db_exactness, fresh_kernel_exactness: the
   ceiling check under NANO_PEARL_SPLIT=1 and NANO_PEARL_DEFERRED_VERIFY=1,
   the throughput check under NANO_PEARL_FRESH_MODE=kernel;
   sp_exactness (after sp_exactness_unsharded): the f32 pair with
   draft_sp = target_sp = 2, both shards on the one card, 321-token
   sequences over 9-block pools so that contexts span both shards: PEARL
   == AR and == the unsharded stream, over a bf16 and an int8 cache, with
   only K3 and K11a/K11c (K11b/K11d) launched;
   checkpoint_exactness: tiny llama, tied llama, qwen2 and qwen3 HF
   checkpoint directories (head dim 16) written by this script, loaded
   through PearlConfig(draft_model=dir, target_model=dir): weights equal
   what was written, f32 PEARL == AR through K10a/K10b (K10c/K10d over an
   int8 cache);
6. main path: the bench's bf16 3L/36L layer-share pair (hidden 1024, ffn
   4096, 8x128 query heads, 2 KV heads, vocab 32768), B=32, gamma=14,
   prompt 64, greedy: 145 PEARL rounds, then AR over the first sixth of
   the same window;
   throughput_path: the same run with draft_noise 0.005 under the
   throughput profile (bench.py --draft-noise 0.005); quant_path: the
   main path with bench.py --kv-quant int8 --quant int8 (MAT 14 asserted,
   decode through K9a, verify through K9b, the KV pools' bytes per block
   against the bf16 run's); quant_throughput_path: the throughput path
   with --kv-quant fp8 --quant fp8 (K9c), 73 rounds; each with its AR
   over the first sixth of its window;
   split_path, deferred_db_path (the main path's run under
   NANO_PEARL_SPLIT=1: K8a, K8b; and NANO_PEARL_DEFERRED_VERIFY=1: K1, K6a)
   and fresh_kernel_path (the throughput path's under
   NANO_PEARL_FRESH_MODE=kernel: K5, K6b), 73 rounds each with the
   variable set around the engine's construction only, their speedup
   against the AR of the main or throughput path in the same call;
   checkpoint_path and checkpoint_quant_path: a layer-share pair at
   SmolLM2-360M's published widths (3L draft, 32L target, Hkv*D 320,
   seeded random weights) written as bf16 HF checkpoint directories and
   loaded by the engine, the bench's run over a bf16 and an int8 cache
   (K3, K10a/K10b or K10c/K10d, never K1/K2/K9; MAT 14 asserted), 145
   rounds, AR over the first sixth of the window;
   sp_path: the main path with draft_sp = target_sp = 2 (the shards share
   the one card; K3, K11a, K11c, MAT 14 asserted), 145 rounds, AR over the
   first sixth of the window; sp_quant_path: the same over an int8 cache
   with int8 weights (K11b, K11d), 73 rounds, AR over a sixth (the AR
   windows and the 73-round paths keep the script inside its time limit
   on a slow host);
7. serving_exactness: the f32 2L/6L serve pair served through serve_step
   with prefix hits and chunked passes must equal AR;
8. serving: the bf16 3L/36L serve pair (16x64 query heads) behind the
   port's HTTP server, 65 requests of bench_serve.py's traffic.

Each path (main path, throughput path, the two quantized paths, the
three override paths, the two checkpoint paths, the two sp paths,
serving) sets every launch counter to 0 just before it and reads them
just after. Then one
{"kernels": [...]} line, the nvidia-smi line, and the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
# A kernel and its plain version both accumulate in f32 and round the
# output to bf16 once, so they may differ by one bf16 step: at most 2^-7
# of the value (rtol 8e-3); atol 1e-3 covers values near 0. The measured
# errors are one such step (PERF.md).
TOL = dict(atol=1e-3, rtol=8e-3)
# Every path's AR runs over the first 1 / AR_CUT of its window (bench_run's
# ar_cut): its tok/s settles well before the window's end, and a whole
# third cost minutes of the script's limit on a slow host.
AR_CUT = 6
# scaled_dot_product_attention rounds its probabilities to bf16 before the
# product with V, so the yardstick is held only to 2e-2.
LIB_TOL = dict(atol=2e-2, rtol=2e-2)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, flush: torch.Tensor, spin: bool = True) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each timed with
    CUDA events after writing ``flush`` (larger than the 50 MB L2). With
    ``spin``, ~0.1 ms of spinning on the card between the flush and the
    start event lets the host enqueue ``fn`` first: without it, where a
    wrapper's host work outlasts the flush, the card's wait for it lands
    inside the timing (the K3/K4 rows read both)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        if spin:
            torch.cuda._sleep(200_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def ptxas_by_kernel(log: str) -> dict:
    """Registers and spill bytes of each kernel in nvcc's ``-Xptxas -v``
    report (mangled names, as ptxas prints them)."""
    import re

    out, name = {}, None
    for ln in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", ln):
            name = m.group(1)
            out[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif name and (m := re.search(r"Used (\d+) registers", ln)):
            out[name]["registers"] = int(m.group(1))
    return out


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# ------------------------------------------------------------------ kernels


def paged_inputs(gen, dev, n_tables, rows, ctx0, nl=3, nb=520, bs=256, hq=8, hkv=2, d=128, m=16,
                 dtype=torch.bfloat16):
    """A cache of the draft's shape, distinct pages per sequence as the
    block manager hands them out, garbage-block padding of the tables,
    and per-row contexts (staircase when rows > 1)."""
    cache = torch.randn((nl, 2, nb + 1, bs, hkv * d), generator=gen, device=dev).to(dtype)
    q = torch.randn((n_tables * rows, hq, d), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(nb, generator=gen, device=dev).to(torch.int32)
    bt = torch.full((n_tables, m), nb, dtype=torch.int32, device=dev)
    ctx = torch.empty((n_tables, rows), dtype=torch.int32, device=dev)
    used = 0
    for i, c0 in enumerate(ctx0):
        c_max = int(c0) + rows - 1
        pages = -(-c_max // bs)
        bt[i, :pages] = perm[used : used + pages]
        used += pages
        ctx[i] = torch.arange(int(c0), int(c0) + rows, dtype=torch.int32)
    return q, cache, bt, ctx.reshape(-1), d**-0.5


def gathered(cache, layer, bt, hkv, d):
    """[T, Hkv, S, D] K and V of each block-table row, for the yardstick (a
    quantized cache dequantized to bf16, as the K9 kernels read it)."""
    from nano_pearl_tpu_torch.ops.attention import _gather_kv

    k, v = _gather_kv(cache, layer, bt, d, torch.bfloat16)
    return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()


def lib_yardstick(fn, layout, want, real=None):
    """``fn`` (an SDPA call), put in the kernel's layout by ``layout``,
    checked once against the plain output at LIB_TOL; returns ``fn`` for
    timing (the layout change is not timed)."""
    out = layout(fn())
    if real is not None:
        out, want = out[real], want[real]
    torch.testing.assert_close(out.float(), want.float(), **LIB_TOL)
    return fn


def grouped_sdpa(q, cache, layer, bt, ctx, rows, hq, hkv, d, scale, key_mask=None):
    """One SDPA call over each group's gathered K/V with an explicit mask
    (``rows`` query rows per group; ``key_mask`` [groups, S]: only these
    keys, as one shard's), and the layout back to [N, Hq, D]."""
    import torch.nn.functional as F

    groups = bt.shape[0]
    k, v = gathered(cache, layer, bt, hkv, d)
    k, v = k.repeat_interleave(hq // hkv, 1), v.repeat_interleave(hq // hkv, 1)
    qg = q.reshape(groups, rows, hq, d).transpose(1, 2)
    cr = ctx.reshape(groups, rows)
    mask = (torch.arange(k.shape[2], device=q.device)[None, None, :] < cr[:, :, None])[:, None]
    if key_mask is not None:
        mask = mask & key_mask[:, None, None, :]
    return (lambda: F.scaled_dot_product_attention(qg, k, v, attn_mask=mask, scale=scale),
            lambda o: o.transpose(1, 2).reshape(-1, hq, d))


def decode_row(gen, dev, flush, name, ctx0, hq, d, nb=520, hkv=2, layer=1) -> dict:
    """K1 on one decode row per context in ``ctx0``."""
    from nano_pearl_tpu_torch.ops.cuda import paged_attention as kpa

    q, cache, bt, ctx, scale = paged_inputs(gen, dev, len(ctx0), 1, ctx0, nb=nb, hq=hq, hkv=hkv, d=d)
    args = (q, cache, layer, bt, ctx, scale)
    got, want = kpa.paged_decode(*args), kpa.plain_decode(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    lib = lib_yardstick(*grouped_sdpa(q, cache, layer, bt, ctx, 1, hq, hkv, d, scale), want)
    sum_ctx = float(ctx.sum())
    nbytes = 2 * q.numel() * 2 + bt.numel() * 4 + ctx.numel() * 4 + sum_ctx * 2 * hkv * d * 2
    b_ms, b_by = bound(nbytes, 4 * sum_ctx * hq * d)
    return dict(
        name=name, kernel="paged_decode", route="cuda", source="nano_pearl_tpu_torch/csrc/paged_attention.cu",
        replaces="nano_pearl_tpu/ops/pallas/paged_attention.py:389",
        max_abs_err=err, ms=time_ms(lambda: kpa.paged_decode(*args), 50, flush),
        plain_ms=time_ms(lambda: kpa.plain_decode(*args), 10, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib, 50, flush),
        shape=dict(rows=len(ctx0), hq=hq, hkv=hkv, d=d, block=256, ctx_min=int(ctx.min()),
                   ctx_max=int(ctx.max())),
    )


def verify_row(gen, dev, flush, name, ctx0, rows, hq, d, hkv=2, layer=1, dtype=torch.bfloat16) -> dict:
    """K2 on one verify chunk: a group of ``rows`` staircase rows per
    context in ``ctx0``; its rows must equal K1's bit for bit. Where the
    group's query vectors do not fit one block's shared memory (D 256 at 8
    query heads per KV head) the launcher spreads its rows over blocks."""
    from nano_pearl_tpu_torch.ops.cuda import paged_attention as kpa

    groups = len(ctx0)
    q, cache, bt, ctx, scale = paged_inputs(gen, dev, groups, rows, ctx0, hq=hq, hkv=hkv, d=d, dtype=dtype)
    args = (q, cache, layer, bt, ctx, scale, rows)
    got, want = kpa.paged_verify(*args), kpa.plain_verify(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    single = kpa.paged_decode(q, cache, layer, bt.repeat_interleave(rows, 0).contiguous(), ctx, scale)
    if not torch.equal(single, got):
        raise AssertionError(f"{name}: K2 rows differ from K1 on the same query and context")
    lib = lib_yardstick(*grouped_sdpa(q, cache, layer, bt, ctx, rows, hq, hkv, d, scale), want)
    kv_tokens = float(ctx.reshape(groups, rows).max(dim=1).values.sum())
    es = q.element_size()
    nbytes = 2 * q.numel() * es + bt.numel() * 4 + ctx.numel() * 4 + kv_tokens * 2 * hkv * d * es
    b_ms, b_by = bound(nbytes, 4 * float(ctx.sum()) * hq * d)
    rpb = kpa.rows_per_block(rows, hq // hkv, d, es)
    if rpb != kpa._lib().npt_rows_per_block(rows, hq // hkv, d, int(es == 2), 0, 64):
        raise AssertionError(f"{name}: the launchers' rows per block differ from rows_per_block's {rpb}")
    return dict(
        name=name, kernel="paged_verify", route="cuda", source="nano_pearl_tpu_torch/csrc/paged_attention.cu",
        dtype=str(dtype).removeprefix("torch."), rows_per_block=rpb,
        replaces="nano_pearl_tpu/ops/pallas/paged_attention.py:510",
        max_abs_err=err, ms=time_ms(lambda: kpa.paged_verify(*args), 50, flush),
        plain_ms=time_ms(lambda: kpa.plain_verify(*args), 10, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib, 50, flush),
        k2_row_equals_k1=True,
        shape=dict(groups=groups, rows=rows, hq=hq, hkv=hkv, d=d, ctx_min=int(ctx.min()),
                   ctx_max=int(ctx.max())),
    )


def prefill_inputs(gen, dev, b, lq, n, hq, d, hkv=2) -> tuple:
    """K3's arguments: ``b`` prompts of ``n`` tokens in an ``lq``-row
    bucket, bf16 q/k/v [b * lq, heads, d], pos (-1 on padded rows), scale."""
    q = torch.randn((b * lq, hq, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b * lq, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b * lq, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.full((b, lq), -1, dtype=torch.int32, device=dev)
    pos[:, :n] = torch.arange(n, dtype=torch.int32, device=dev)
    return q, k, v, pos, d**-0.5


def prefill_row(gen, dev, flush, name, b, lq, n, hq, d, hkv=2) -> dict:
    """K3 on ``b`` prompts of ``n`` tokens in an ``lq``-row bucket."""
    import torch.nn.functional as F

    from nano_pearl_tpu_torch.ops.cuda import prefill_attention as kpf

    args = prefill_inputs(gen, dev, b, lq, n, hq, d, hkv)
    q, k, v, pos, _ = args
    got, want = kpf.prefill_self(*args), kpf.plain_prefill(*args)
    torch.cuda.synchronize()
    real = (pos >= 0).reshape(-1)
    err = (got[real].float() - want[real].float()).abs().max().item()
    torch.testing.assert_close(got[real].float(), want[real].float(), **TOL)
    if not bool((got[~real] == 0).all()):
        raise AssertionError(f"{name}: fully masked rows must give 0")
    qs = q.reshape(b, lq, hq, d).transpose(1, 2)
    ks = k.reshape(b, lq, hkv, d).transpose(1, 2).repeat_interleave(hq // hkv, 1)
    vs = v.reshape(b, lq, hkv, d).transpose(1, 2).repeat_interleave(hq // hkv, 1)
    lib = lib_yardstick(
        lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, scale=d**-0.5),
        lambda o: o.transpose(1, 2).reshape(b * lq, hq, d), want, real,
    )
    # q, k and v of the real rows (the padded ones are never read), the
    # whole output, pos
    nbytes = (float(real.sum()) * (hq + 2 * hkv) * d + b * lq * hq * d) * 2 + pos.numel() * 4
    b_ms, b_by = bound(nbytes, 4.0 * hq * d * b * n * (n + 1) / 2)
    design, _ = prefill_design(name, hq // hkv, d, prefix=False)
    run = lambda: kpf.prefill_self(*args)  # noqa: E731
    row = dict(
        name=name, kernel="prefill_self", route="cuda", source="nano_pearl_tpu_torch/csrc/prefill_attention.cu",
        replaces="nano_pearl_tpu/ops/pallas/prefill_attention.py:43",
        max_abs_err=err, ms=time_ms(run, 50, flush),
        plain_ms=time_ms(lambda: kpf.plain_prefill(*args), 10, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib, 50, flush),
        no_spin=no_spin_ms(run, lib, 50, flush), design=design, split=None,
        shape=dict(batch=b, rows=lq, real_rows=n, hq=hq, hkv=hkv, d=d),
    )
    row["blocks"] = launched_blocks(run)  # profiled last, after the row's timings
    return row


def no_spin_ms(run, lib, iters, flush) -> dict:
    """A K3/K4 or K10/K11 row's kernel and SDPA timed without ``time_ms``'s
    spin, as rows were timed before those kernels' redesigns: the wrapper's
    host work then counts wherever it outlasts the L2 flush."""
    return dict(ms=time_ms(run, iters, flush, spin=False), library_ms=time_ms(lib, iters, flush, spin=False))


LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def kernel_trace(run, pad_s: float = 0.005) -> tuple[list, int]:
    """One torch.profiler session of one call of ``run``: its kernel events
    and its launch calls' count. The session idles ``pad_s`` before the call
    and after it, so that the call's kernels lie well inside its window."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        run()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)["traceEvents"]
    events = [e for e in trace if e.get("cat") == "kernel"]
    calls = sum(e.get("cat") == "cuda_runtime" and e.get("name") in LAUNCH_CALLS for e in trace)
    return events, calls


def launched_blocks(run, sessions: int = 8) -> dict:
    """The blocks that one call of ``run`` launched, by CUDA kernel (its
    name without namespace and arguments): each kernel event's grid in a
    torch.profiler trace of that call. Now and then a session holds its
    launch calls without their kernel records (tools/probe_profiler_loss.py
    counts such sessions): a trace with fewer kernel events than launch
    calls is taken again, up to ``sessions`` times."""
    for _ in range(sessions):
        events, calls = kernel_trace(run)
        if events and len(events) >= calls:
            break
    else:
        raise AssertionError(f"the profiler recorded {len(events)} kernels of {calls} launch calls "
                             f"in each of {sessions} sessions")
    blocks = {}
    for e in events:
        grid = e.get("args", {}).get("grid")
        if grid is None:
            raise AssertionError(f"the profiler's event of {e['name']} has no grid")
        name = e["name"].split("(")[0].split("::")[-1]
        blocks[name] = blocks.get(name, 0) + int(np.prod(grid))
    return blocks


def prefill_design(name, g, d, prefix, n_keys=0) -> tuple[str, dict | None]:
    """K3's or K4's (``prefix``) bf16 tiles at ``g`` query heads per KV
    head and head dim ``d`` (``prefill_plan``, checked against the
    launchers' exported ``npt_prefill_plan``) as the row's ``design`` line,
    and K4's split of a launch whose longest key stream has ``n_keys``
    keys."""
    from nano_pearl_tpu_torch.ops.cuda import prefill_attention as kpf

    plan = kpf.prefill_plan(g, d, 2, prefix)
    exported = [kpf._lib().npt_prefill_plan(g, d, 1, int(prefix), w) for w in range(5)]
    if exported != [plan.qt, plan.threads, plan.smem, plan.cell, plan.stages]:
        raise AssertionError(f"{name}: the launchers' tiles {exported} differ from prefill_plan's {plan}")
    design = (f"mma.sync m16n8k16 bf16 (P as hi + lo bf16), K/V via cp.async in {plan.stages} stages of "
              f"{kpf.KEYS} keys; {plan.qt} query rows x {g} heads = {plan.rows} rows a block, "
              f"{plan.threads // 32} warps, {plan.smem} B shared")
    if not prefix:
        return design, None
    cells = len(kpf.key_cells(n_keys, plan.cell))
    return design, dict(cell_keys=plan.cell, cells=cells, combine=cells > 1)


def mono_row(gen, dev, flush, name, ctx0, rows, hq, d, hkv=2, layer=1) -> dict:
    """K5 on one group of ``rows`` staircase rows per context in ``ctx0``
    (rows 1: the throughput profile's decode)."""
    from nano_pearl_tpu_torch.ops.cuda import mono_attention as kmo

    groups = len(ctx0)
    q, cache, bt, ctx, scale = paged_inputs(gen, dev, groups, rows, ctx0, hq=hq, hkv=hkv, d=d)
    args = (q, cache, layer, bt, ctx, scale, rows)
    got, want = kmo.mono_attention(*args), kmo.plain_mono(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    lib = lib_yardstick(*grouped_sdpa(q, cache, layer, bt, ctx, rows, hq, hkv, d, scale), want)
    kv_tokens = float(ctx.reshape(groups, rows).max(dim=1).values.sum())
    nbytes = 2 * q.numel() * 2 + bt.numel() * 4 + ctx.numel() * 4 + kv_tokens * 2 * hkv * d * 2
    b_ms, b_by = bound(nbytes, 4 * float(ctx.sum()) * hq * d)
    return dict(
        name=name, kernel="mono_attention", route="cuda", source="nano_pearl_tpu_torch/csrc/mono_attention.cu",
        replaces="nano_pearl_tpu/ops/pallas/paged_attention.py:612",
        max_abs_err=err, ms=time_ms(lambda: kmo.mono_attention(*args), 50, flush),
        plain_ms=time_ms(lambda: kmo.plain_mono(*args), 10, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib, 50, flush),
        shape=dict(groups=groups, rows=rows, hq=hq, hkv=hkv, d=d, ctx_min=int(ctx.min()),
                   ctx_max=int(ctx.max())),
    )


def cache_partials_row(gen, dev, flush, name="cache_partials", lo=65, hi=2300, hq=8, d=128, hkv=2, layer=1,
                       groups=32, rows=14) -> dict:
    """K7 at the throughput path's verify: 32 groups x 14 rows whose cache
    side is each group's pre-round context ctx0, spread over lo .. hi (its
    rows see ctx0 + 1 .. ctx0 + 14 with the fresh window), one group a
    padding row of the batch bucket with cache context 0. bf16 queries run
    on the tensor-core walk (``design``, ``blocks``, ``plan_blocks`` as the
    K10/K11 rows have them). The yardstick is SDPA over the gathered cache,
    for o only."""
    from nano_pearl_tpu_torch.ops.cuda import mono_attention as kmo
    from nano_pearl_tpu_torch.ops.cuda import paged_attention_partials as kpp

    ctx0 = np.random.default_rng(4).permutation(np.linspace(lo, hi, groups).astype(int))
    q, cache, bt, ctx, scale = paged_inputs(gen, dev, groups, rows, ctx0 + 1, hq=hq, hkv=hkv, d=d)
    c0 = torch.as_tensor(ctx0, dtype=torch.int32, device=dev)
    c0[0] = 0
    ctx_cache = torch.minimum(ctx, c0.repeat_interleave(rows)).contiguous()
    args = (q, cache, layer, bt, ctx_cache, scale, rows)
    got, want = kmo.cache_partials(*args), kmo.plain_partials(*args)
    torch.cuda.synchronize()
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    torch.testing.assert_close(got[0].float(), want[0].float(), **TOL)
    for g, w in zip(got[1:], want[1:]):  # f32 m and l: summation order only
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    if not bool((got[0][:rows] == 0).all() and (got[2][:rows] == 0).all()):
        raise AssertionError("K7: rows with cache context 0 must give o = 0 and l = 0")
    real = ctx_cache > 0
    lib = lib_yardstick(*grouped_sdpa(q, cache, layer, bt, ctx_cache, rows, hq, hkv, d, scale),
                        want[0], real)
    n = q.shape[0]
    nbytes = 2 * q.numel() * 2 + 2 * n * hq * 4 + bt.numel() * 4 + ctx.numel() * 4 \
        + float(c0.sum()) * 2 * hkv * d * 2
    b_ms, b_by = bound(nbytes, 4 * float(ctx_cache.sum()) * hq * d)
    run = lambda: kmo.cache_partials(*args)  # noqa: E731
    if not all(torch.equal(a, b) for a, b in zip(run(), got)):
        raise AssertionError(f"{name}: a second launch gives other bits")
    ms = time_ms(run, 50, flush)
    row = dict(
        name=name, kernel="cache_partials", route="cuda",
        source="nano_pearl_tpu_torch/csrc/paged_attention_partials.cu",
        replaces="nano_pearl_tpu/ops/pallas/paged_attention.py:1799",
        max_abs_err=err, ms=ms, plain_ms=time_ms(lambda: kmo.plain_partials(*args), 10, flush),
        bound_ms=b_ms, bound_by=b_by, share=b_ms / ms, library_ms=time_ms(lib, 50, flush),
        no_spin=no_spin_ms(run, lib, 50, flush),
        library="SDPA over the gathered cache, o only", second_launch_bitwise=True,
        shape=dict(groups=groups, rows=rows, hq=hq, hkv=hkv, d=d, ctx0_min=int(c0[1:].min()),
                   cache_ctx_max=int(ctx_cache.max()), zero_context_rows=int((ctx_cache == 0).sum())),
    )
    row.update(zip(("design", "blocks", "plan_blocks"),  # profiled last, after the row's timings
                   walk_design(name, kpp._lib(), run, ctx_cache, bt, rows, hq, hkv, d, cache.shape[3], False)))
    return row


def write_fresh_row(gen, dev, flush, nl=36, nb=520, bs=256, hkv=2, d=128, groups=32, rows=14) -> dict:
    """K12 at the throughput path's writeback: one round's fresh K/V of 36
    layers x 448 rows into the target's cache, each group's 14 slots from
    its pre-round context through its own pages (crossing a page where the
    window does), the last two groups padding rows of the batch bucket,
    whose slots repeat in the garbage block. Held bit for bit against the
    plain version over the whole cache; the yardstick is the port's
    per-layer store, index_copy_, over the same rows at once."""
    from nano_pearl_tpu_torch.ops.cuda import kv_writeback as kkw

    hd = hkv * d
    cache = torch.randn((nl, 2, nb + 1, bs, hd), generator=gen, device=dev).to(torch.bfloat16)
    fresh = torch.randn((nl, 2, groups * rows, hd), generator=gen, device=dev).to(torch.bfloat16)
    ctx0 = np.random.default_rng(5).permutation(np.linspace(64, 2300, groups).astype(int))
    pages = np.random.default_rng(6).permutation(nb)
    slots = np.empty((groups, rows), np.int64)
    for g, c in enumerate(ctx0):
        pos = c + np.arange(rows)
        slots[g] = pages[g * 10 + pos // bs] * bs + pos % bs
    slots[-2:] = nb * bs + np.arange(rows) % bs  # padding rows: garbage block, repeated
    slots = torch.as_tensor(slots.reshape(-1), dtype=torch.int32, device=dev)
    want = kkw.plain_write_fresh(cache.clone(), fresh, slots)
    got = kkw.write_fresh_kernel(cache.clone(), fresh, slots)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K12 differs from its plain version")
    del got, want
    flat = cache.view(-1, hd)
    planes = torch.arange(2 * nl, device=dev)[:, None] * ((nb + 1) * bs)
    idx = (planes + slots.long()[None, :]).reshape(-1)
    vals = fresh.reshape(-1, hd)
    nbytes = 2 * fresh.numel() * 2 + slots.numel() * 4
    b_ms, b_by = bound(nbytes, 0.0)
    return dict(
        name="write_fresh", kernel="write_fresh", route="cuda", source="nano_pearl_tpu_torch/csrc/kv_writeback.cu",
        replaces="nano_pearl_tpu/ops/pallas/kv_writeback.py:44",
        max_abs_err=0.0, ms=time_ms(lambda: kkw.write_fresh_kernel(cache, fresh, slots), 50, flush),
        plain_ms=time_ms(lambda: kkw.plain_write_fresh(cache, fresh, slots), 10, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lambda: flat.index_copy_(0, idx, vals), 50, flush),
        library="index_copy_ of all 2L x N rows", bitwise_equal=True,
        shape=dict(layers=nl, rows=groups * rows, row_bytes=hd * 2, padding_rows=2 * rows),
    )


def fresh_inputs(gen, dev, ctx0, rows, hq=8, hkv=2, d=128):
    """The deferred verify's arguments at the bench pair's heads: a cache
    holding each group's pre-round context ``ctx0``, the round's fresh K/V
    (row t of a group at position ctx0 + t) and staircase contexts ctx0 +
    1 .. ctx0 + rows."""
    q, cache, bt, ctx, scale = paged_inputs(gen, dev, len(ctx0), rows, np.asarray(ctx0) + 1, hq=hq, hkv=hkv, d=d)
    n = q.shape[0]
    fk = torch.randn((n, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
    fv = torch.randn((n, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
    c0 = torch.as_tensor(np.asarray(ctx0), dtype=torch.int32, device=dev)
    return q, cache, bt, ctx, c0, fk, fv, scale


def fresh_sdpa(q, cache, layer, bt, ctx, c0, fk, fv, rows, hq, hkv, d, scale):
    """One SDPA call over each group's gathered cache with its fresh rows
    appended (cache position p visible iff p < min(ctx_row, ctx0), fresh row
    t iff ctx0 + t < ctx_row), and the layout back to [N, Hq, D]."""
    import torch.nn.functional as F

    groups = bt.shape[0]
    k, v = gathered(cache, layer, bt, hkv, d)
    k = torch.cat([k, fk.reshape(groups, rows, hkv, d).transpose(1, 2)], 2).repeat_interleave(hq // hkv, 1)
    v = torch.cat([v, fv.reshape(groups, rows, hkv, d).transpose(1, 2)], 2).repeat_interleave(hq // hkv, 1)
    s = k.shape[2] - rows
    cr = ctx.reshape(groups, rows)
    vis_c = torch.arange(s, device=q.device)[None, None, :] < torch.minimum(cr, c0[:, None])[:, :, None]
    vis_f = c0[:, None, None] + torch.arange(rows, device=q.device)[None, None, :] < cr[:, :, None]
    mask = torch.cat([vis_c, vis_f], 2)[:, None]
    qg = q.reshape(groups, rows, hq, d).transpose(1, 2)
    return (lambda: F.scaled_dot_product_attention(qg, k, v, attn_mask=mask, scale=scale),
            lambda o: o.transpose(1, 2).reshape(-1, hq, d))


OVERRIDE_KERNELS = {  # the schedule overrides' kernels -> (TPU kernel body replaced, source)
    "paged_decode_split": ("nano_pearl_tpu/ops/pallas/paged_attention.py:436", "paged_attention.cu"),
    "paged_verify_fresh": ("nano_pearl_tpu/ops/pallas/paged_attention.py:1551", "paged_attention.cu"),
    "paged_verify_fresh_split": ("nano_pearl_tpu/ops/pallas/paged_attention.py:1614", "paged_attention.cu"),
    "mono_fresh": ("nano_pearl_tpu/ops/pallas/paged_attention.py:1703", "paged_attention_partials.cu"),
}


def override_kernel_fns() -> dict:
    from nano_pearl_tpu_torch.ops.cuda import mono_attention as kmo
    from nano_pearl_tpu_torch.ops.cuda import paged_attention as kpa

    return {"paged_decode_split": kpa.paged_decode_split, "paged_verify_fresh": kpa.paged_verify_fresh,
            "paged_verify_fresh_split": kpa.paged_verify_fresh_split, "mono_fresh": kmo.mono_fresh}


def fresh_row(gen, dev, flush, name, ctx0, rows=14, hq=8, d=128, hkv=2, layer=1, row_name=None) -> dict:
    """K6a or K8b (at a ceiling verify chunk: 16 groups x 14 rows) or K6b
    (at the throughput path's 32 groups x 14 rows): one group per pre-round
    context in ``ctx0``, held against the plain version at TOL and against
    a second launch bit for bit. The bound counts each group's cache
    context and fresh rows once, q and o; the yardstick is SDPA over the
    gathered cache with the fresh rows appended (o only, the SDPA call
    alone timed). K6b's bf16 queries run on the tensor-core walk: its row
    also carries ``no_spin``, ``share``, ``design``, ``blocks`` and
    ``plan_blocks``, as the K10/K11 rows do."""
    from nano_pearl_tpu_torch.ops.cuda import paged_attention as kpa
    from nano_pearl_tpu_torch.ops.cuda import paged_attention_partials as kpp

    fn = override_kernel_fns()[name]
    q, cache, bt, ctx, c0, fk, fv, scale = fresh_inputs(gen, dev, ctx0, rows, hq, hkv, d)
    args = (q, cache, layer, bt, ctx, c0, fk, fv, scale)
    got, want = fn(*args, rows), kpa.plain_fresh(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    if not torch.equal(fn(*args, rows), got):
        raise AssertionError(f"{name}: a second launch gives other bits")
    lib = lib_yardstick(*fresh_sdpa(q, cache, layer, bt, ctx, c0, fk, fv, rows, hq, hkv, d, scale), want)
    n = q.shape[0]
    nbytes = 2 * q.numel() * 2 + bt.numel() * 4 + ctx.numel() * 4 + c0.numel() * 4 \
        + float(c0.sum()) * 2 * hkv * d * 2 + 2 * n * hkv * d * 2
    b_ms, b_by = bound(nbytes, 4 * float(ctx.sum()) * hq * d)
    replaces, source = OVERRIDE_KERNELS[name]
    run = lambda: fn(*args, rows)  # noqa: E731
    ms = time_ms(run, 50, flush)
    row = dict(
        name=row_name or name, kernel=name, route="cuda", source=f"nano_pearl_tpu_torch/csrc/{source}",
        replaces=replaces, max_abs_err=err, ms=ms, plain_ms=time_ms(lambda: kpa.plain_fresh(*args), 10, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib, 50, flush),
        library="SDPA over the gathered cache with the fresh rows appended, o only",
        second_launch_bitwise=True,
        shape=dict(groups=len(ctx0), rows=rows, hq=hq, hkv=hkv, d=d, ctx0_min=int(c0.min()),
                   ctx0_max=int(c0.max())),
    )
    if name == "mono_fresh":
        row.update(share=b_ms / ms, no_spin=no_spin_ms(run, lib, 50, flush))
        row.update(zip(("design", "blocks", "plan_blocks"),  # profiled last, after the row's timings
                       walk_design(row["name"], kpp._lib(), run, ctx, bt, rows, hq, hkv, d, cache.shape[3], False,
                                   ctx0=c0)))
    return row


def decode_split_row(gen, dev, flush, ctx0, gamma=14, hq=8, d=128, hkv=2, layer=1) -> dict:
    """K8a on the gamma-scan's 32 decode rows, row i cut at b1 = ctx - (i %
    gamma) (the boundary of the step-(i % gamma) decode of a round, steps >=
    1 at the round-start length), held against K1's plain version at TOL and
    a second launch bit for bit; bound and yardstick K1's."""
    from nano_pearl_tpu_torch.ops.cuda import paged_attention as kpa

    q, cache, bt, ctx, scale = paged_inputs(gen, dev, len(ctx0), 1, ctx0, hq=hq, hkv=hkv, d=d)
    b1 = (ctx - torch.arange(len(ctx0), device=dev, dtype=torch.int32) % gamma).contiguous()
    args = (q, cache, layer, bt, ctx, b1, scale)
    got, want = kpa.paged_decode_split(*args), kpa.plain_decode(q, cache, layer, bt, ctx, scale)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    if not torch.equal(kpa.paged_decode_split(*args), got):
        raise AssertionError("paged_decode_split: a second launch gives other bits")
    lib = lib_yardstick(*grouped_sdpa(q, cache, layer, bt, ctx, 1, hq, hkv, d, scale), want)
    sum_ctx = float(ctx.sum())
    nbytes = 2 * q.numel() * 2 + bt.numel() * 4 + 2 * ctx.numel() * 4 + sum_ctx * 2 * hkv * d * 2
    b_ms, b_by = bound(nbytes, 4 * sum_ctx * hq * d)
    replaces, source = OVERRIDE_KERNELS["paged_decode_split"]
    return dict(
        name="paged_decode_split", kernel="paged_decode_split", route="cuda",
        source=f"nano_pearl_tpu_torch/csrc/{source}", replaces=replaces,
        max_abs_err=err, ms=time_ms(lambda: kpa.paged_decode_split(*args), 50, flush),
        plain_ms=time_ms(lambda: kpa.plain_decode(q, cache, layer, bt, ctx, scale), 10, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib, 50, flush), second_launch_bitwise=True,
        shape=dict(rows=len(ctx0), hq=hq, hkv=hkv, d=d, ctx_min=int(ctx.min()), ctx_max=int(ctx.max())),
    )


SPLIT_CASES = {  # pre-round context ctx0 of the group, real rows of its window
    "window_inside_a_chunk": (1000, 14),
    "window_across_a_256_multiple": (1530, 14),
    "num_input_1": (777, 1),
    "ctx0_0": (0, 14),
}


def split_bitwise_phase(dev, rows=14, hq=8, hkv=2, d=128, layer=1) -> dict:
    """K8b's rows against K8a's at b1 = ctx0, bit for bit, K8a reading the
    fresh rows from the draft's cache (its gamma-scan wrote them there):
    one 14-row group per case of SPLIT_CASES, at the bench pair's heads;
    and a second launch of each new kernel against the first, bit for bit,
    on the same groups."""
    from nano_pearl_tpu_torch.ops.cuda import paged_attention as kpa

    gen = torch.Generator(dev).manual_seed(7)
    ctx0 = [c for c, _ in SPLIT_CASES.values()]
    q, cache, bt, ctx, c0, fk, fv, scale = fresh_inputs(gen, dev, ctx0, rows, hq, hkv, d)
    ctx = ctx.reshape(len(ctx0), rows)
    for i, (_, real) in enumerate(SPLIT_CASES.values()):
        ctx[i, real:] = 1  # padding rows of a pre-verify group
    ctx = ctx.reshape(-1).contiguous()
    drafted, bs = cache.clone(), cache.shape[3]
    for i, c in enumerate(ctx0):
        pos = c + torch.arange(rows, device=dev)
        pages = bt[i, pos // bs].long()
        drafted[layer, 0, pages, pos % bs] = fk[i * rows : (i + 1) * rows].reshape(rows, -1)
        drafted[layer, 1, pages, pos % bs] = fv[i * rows : (i + 1) * rows].reshape(rows, -1)
    fresh_args = (q, cache, layer, bt, ctx, c0, fk, fv, scale, rows)
    verify = kpa.paged_verify_fresh_split(*fresh_args)
    b1 = c0.repeat_interleave(rows)
    dec_args = (q, drafted, layer, bt.repeat_interleave(rows, 0).contiguous(), ctx, b1, scale)
    decode = kpa.paged_decode_split(*dec_args)
    torch.cuda.synchronize()
    real = (ctx > b1).reshape(len(ctx0), rows)
    equal = {name: bool(torch.equal(verify.reshape(len(ctx0), rows, -1)[i][real[i]],
                                    decode.reshape(len(ctx0), rows, -1)[i][real[i]]))
             for i, name in enumerate(SPLIT_CASES)}
    fns = override_kernel_fns()
    second = {name: bool(torch.equal(fns[name](*fresh_args), fns[name](*fresh_args)))
              for name in ("paged_verify_fresh", "paged_verify_fresh_split", "mono_fresh")}
    second["paged_decode_split"] = bool(torch.equal(kpa.paged_decode_split(*dec_args), decode))
    out = {"phase": "split_bitwise", "k8b_rows_equal_k8a": equal, "second_launch_bitwise": second,
           "cases": {k: {"ctx0": c, "real_rows": r} for k, (c, r) in SPLIT_CASES.items()},
           "shape": dict(rows=rows, hq=hq, hkv=hkv, d=d)}
    emit(out)
    if not (all(equal.values()) and all(second.values())):
        raise AssertionError(f"K8b rows != K8a rows, or a second launch differs: {out}")
    return out


def kernel_phase(dev, flush) -> list[dict]:
    """Every kernel at the shapes each path gives it, first the row that
    stands for it in the kernels line: K1-K3 at the main path's (bench
    pair, 8x128 heads) and at the serving path's (serve pair, 16x64
    heads), K4 at the serving path's prefix hit, a chunked pass and the
    bench pair's heads, K5, K7 and K12 at the throughput path's."""
    gen = torch.Generator(dev).manual_seed(0)
    spread = lambda n, hi, seed: np.random.default_rng(seed).permutation(  # noqa: E731
        np.linspace(65, hi, n).astype(int))
    # pre-round contexts 1-50: a verify's rows right after a short prompt (contexts 2-64)
    short = lambda n, seed: np.random.default_rng(seed).permutation(np.linspace(1, 50, n).astype(int))  # noqa: E731
    rows = [
        # main path: B=32 decode rows; one verify chunk of 16 groups x 14
        # rows; the prefill of 32 prompts of 64 tokens in the 128-row bucket
        decode_row(gen, dev, flush, "paged_decode", spread(32, 2300, 0), hq=8, d=128),
        verify_row(gen, dev, flush, "paged_verify", spread(16, 2300, 1), 14, hq=8, d=128),
        prefill_row(gen, dev, flush, "prefill_self", 32, 128, 64, hq=8, d=128),
        # serving path: the gamma-scan's 128-row decode calls, a verify
        # chunk of 16 groups x 8 rows, contexts up to the 3,000-token
        # prompt's; 8 fresh prompts of 64 tokens in the 128-row bucket
        decode_row(gen, dev, flush, "paged_decode_serve", spread(128, 3200, 2), hq=16, d=64, nb=1100),
        verify_row(gen, dev, flush, "paged_verify_serve", spread(16, 3200, 3), 8, hq=16, d=64),
        prefill_row(gen, dev, flush, "prefill_self_serve", 8, 128, 64, hq=16, d=64),
        *prefix_kernel_rows(gen, dev, flush),
        # throughput path: the B=32 decode through K5; K5 at a packed
        # verify's 14 rows per group; K7 and K12 at the deferred verify's
        # 32 groups x 14 rows
        mono_row(gen, dev, flush, "mono_attention", spread(32, 2300, 0), 1, hq=8, d=128),
        mono_row(gen, dev, flush, "mono_attention_r14", spread(32, 2300, 1), 14, hq=8, d=128),
        cache_partials_row(gen, dev, flush),
        # K7 right after short prompts: cache contexts of 1-50 (rows 1-64)
        cache_partials_row(gen, dev, flush, "cache_partials_short", 1, 50),
        write_fresh_row(gen, dev, flush),
        # quant_path (int8): K9a at the B=32 decode, K9b at a verify chunk;
        # quant_throughput_path (fp8): K9c at the decode and at 14 rows;
        # each in the other 1-byte type too
        q8_row(gen, dev, flush, "paged_decode_q8", "int8", spread(32, 2300, 0), 1),
        q8_row(gen, dev, flush, "paged_decode_q8_fp8", "fp8", spread(32, 2300, 0), 1),
        q8_row(gen, dev, flush, "paged_verify_q8", "int8", spread(16, 2300, 1), 14),
        q8_row(gen, dev, flush, "paged_verify_q8_fp8", "fp8", spread(16, 2300, 1), 14),
        q8_row(gen, dev, flush, "mono_q8", "fp8", spread(32, 2300, 0), 1),
        q8_row(gen, dev, flush, "mono_q8_int8", "int8", spread(32, 2300, 0), 1),
        q8_row(gen, dev, flush, "mono_q8_r14", "fp8", spread(32, 2300, 1), 14),
        q8_row(gen, dev, flush, "mono_q8_r14_int8", "int8", spread(32, 2300, 1), 14),
        # the schedule overrides: K8a at the split path's 32 gamma-scan rows,
        # K6a / K8b at a verify chunk (16 groups x 14 rows), K6b at the
        # fresh-kernel path's 32 groups x 14 rows
        decode_split_row(gen, dev, flush, spread(32, 2300, 0)),
        fresh_row(gen, dev, flush, "paged_verify_fresh", spread(16, 2300, 1)),
        fresh_row(gen, dev, flush, "paged_verify_fresh_split", spread(16, 2300, 1)),
        fresh_row(gen, dev, flush, "mono_fresh", spread(32, 2300, 1)),
        fresh_row(gen, dev, flush, "mono_fresh", short(32, 1), row_name="mono_fresh_short"),
        # the fallbacks K10a-d: (a) the checkpoint paths' shapes (SmolLM2-360M's
        # 15x64 q heads over 5 KV heads, Hkv*D 320): the 32-row decode and a
        # verify chunk of 16 groups x 14 rows over a bf16 and an int8 cache;
        # (b) small heads (4x16 over 2 KV heads, Hkv*D 32); (c) the bench
        # pair's 8x128 heads over an int8 cache of 16-key blocks
        fallback_row(gen, dev, flush, "paged_decode_fallback", spread(32, 2300, 0), 1, 15, 5, 64, 256),
        fallback_row(gen, dev, flush, "paged_verify_fallback", spread(16, 2300, 1), 14, 15, 5, 64, 256),
        fallback_row(gen, dev, flush, "paged_decode_fallback_q8", spread(32, 2300, 0), 1, 15, 5, 64, 256, "int8"),
        fallback_row(gen, dev, flush, "paged_verify_fallback_q8", spread(16, 2300, 1), 14, 15, 5, 64, 256,
                     "int8"),
        fallback_row(gen, dev, flush, "paged_decode_fallback_d16", spread(32, 2300, 0), 1, 4, 2, 16, 256),
        fallback_row(gen, dev, flush, "paged_verify_fallback_d16", spread(16, 2300, 1), 14, 4, 2, 16, 256),
        fallback_row(gen, dev, flush, "paged_decode_fallback_q8_bs16", spread(32, 2300, 0), 1, 8, 2, 128, 16,
                     "int8"),
        fallback_row(gen, dev, flush, "paged_verify_fallback_q8_bs16", spread(16, 2300, 1), 14, 8, 2, 128, 16,
                     "int8"),
        # every head dim the kernels take: K1, K2, K5 and K9b at D 16, 32 and
        # 256 with an aligned Hkv*D (the fast route); K3 at D 16, 32 and 256
        # (K4's in prefix_kernel_rows)
        # sequence parallelism: K11a-d on two 260-block shards of one cache,
        # at the sp path's B=32 decode and a verify chunk of 16 groups x 14 rows
        partials_row(gen, dev, flush, "paged_decode_partials", spread(32, 2300, 0), 1),
        partials_row(gen, dev, flush, "paged_verify_partials", spread(16, 2300, 1), 14),
        partials_row(gen, dev, flush, "paged_decode_partials_q8", spread(32, 2300, 0), 1, "int8"),
        partials_row(gen, dev, flush, "paged_verify_partials_q8", spread(16, 2300, 1), 14, "int8"),
        # D 256 at 8 query heads per KV head: a 14-row group spread over
        # blocks (7 rows in bf16, 4 in f32), K2 rows == K1 and K9b == K9a
        verify_row(gen, dev, flush, "paged_verify_d256_g8", spread(16, 2300, 1), 14, hq=16, d=256),
        verify_row(gen, dev, flush, "paged_verify_d256_g8_f32", spread(16, 2300, 1), 14, hq=16, d=256,
                   dtype=torch.float32),
        q8_row(gen, dev, flush, "paged_verify_q8_d256_g8", "int8", spread(16, 2300, 1), 14, hq=16, d=256),
        *(r for d, hq, hkv in ((16, 16, 8), (32, 16, 4), (256, 8, 2)) for r in (
            decode_row(gen, dev, flush, f"paged_decode_d{d}", spread(32, 2300, 0), hq=hq, d=d, hkv=hkv),
            verify_row(gen, dev, flush, f"paged_verify_d{d}", spread(16, 2300, 1), 14, hq=hq, d=d, hkv=hkv),
            mono_row(gen, dev, flush, f"mono_attention_r14_d{d}", spread(32, 2300, 1), 14, hq=hq, d=d, hkv=hkv),
            q8_row(gen, dev, flush, f"paged_verify_q8_d{d}", "int8", spread(16, 2300, 1), 14, hq=hq, d=d,
                   hkv=hkv),
            prefill_row(gen, dev, flush, f"prefill_self_d{d}", 32, 128, 64, hq=hq, d=d, hkv=hkv),
        )),
    ]
    for r in rows:
        emit({"phase": "kernel", **r})
    return rows


Q8_KERNELS = {  # K9a-c's wrappers -> the TPU kernel body each replaces
    "paged_decode_q8": "nano_pearl_tpu/ops/pallas/paged_attention.py:866",
    "paged_verify_q8": "nano_pearl_tpu/ops/pallas/paged_attention.py:916",
    "mono_q8": "nano_pearl_tpu/ops/pallas/paged_attention.py:963",
}


def q8_row(gen, dev, flush, name, kind, ctx0, rows, hq=8, d=128, hkv=2, layer=1) -> dict:
    """K9a (``rows`` 1, one row per context), K9b or K9c on a bf16 cache of
    the draft's shape quantized to ``kind`` as ``write_kv`` stores it, held
    against the plain version at TOL and against itself in a second launch
    bit for bit; K9b's rows against K9a's bit for bit. The bound counts the
    1-byte values and the 2 scale bytes per (slot, KV head) of each group's
    context once, q and o; the yardstick is SDPA over the cache gathered and
    dequantized to bf16 (the SDPA call alone is timed)."""
    from nano_pearl_tpu_torch.ops.cuda import mono_attention as kmo
    from nano_pearl_tpu_torch.ops.cuda import paged_attention as kpa
    from nano_pearl_tpu_torch.ops.kv_cache import QuantKVCache, _quantize_rows

    kernel = next(k for k in Q8_KERNELS if name.startswith(k))
    fn, plain = {"paged_decode_q8": (kpa.paged_decode_q8, kpa.plain_decode),
                 "paged_verify_q8": (kpa.paged_verify_q8, kpa.plain_verify),
                 "mono_q8": (kmo.mono_q8, kmo.plain_mono)}[kernel]
    groups = len(ctx0)
    q, cache, bt, ctx, scale = paged_inputs(gen, dev, groups, rows, ctx0, hq=hq, hkv=hkv, d=d)
    qdt = torch.int8 if kind == "int8" else torch.float8_e4m3fn
    values, scales = _quantize_rows(cache.view(-1, hkv, d), qdt)
    qc = QuantKVCache(values.view(cache.shape), scales.view(cache.shape[:-1] + (hkv,)))
    del cache, values, scales
    args = (q, qc, layer, bt, ctx, scale) + (() if kernel == "paged_decode_q8" else (rows,))
    got, want = fn(*args), plain(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    if not torch.equal(fn(*args), got):
        raise AssertionError(f"{name}: a second launch gives other bits")
    if kernel == "paged_verify_q8":
        single = kpa.paged_decode_q8(q, qc, layer, bt.repeat_interleave(rows, 0).contiguous(), ctx, scale)
        if not torch.equal(single, got):
            raise AssertionError(f"{name}: K9b rows differ from K9a on the same query and context")
    lib = lib_yardstick(*grouped_sdpa(q, qc, layer, bt, ctx, rows, hq, hkv, d, scale), want)
    kv_tokens = float(ctx.reshape(groups, rows).max(dim=1).values.sum())
    nbytes = 2 * q.numel() * 2 + bt.numel() * 4 + ctx.numel() * 4 + kv_tokens * 2 * hkv * (d + 2)
    b_ms, b_by = bound(nbytes, 4 * float(ctx.sum()) * hq * d)
    source = "paged_attention.cu" if kernel.startswith("paged") else "mono_attention.cu"
    return dict(
        name=name, kernel=kernel, route="cuda", source=f"nano_pearl_tpu_torch/csrc/{source}",
        replaces=Q8_KERNELS[kernel], cache=kind,
        max_abs_err=err, ms=time_ms(lambda: fn(*args), 50, flush),
        plain_ms=time_ms(lambda: plain(*args), 10, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib, 50, flush),
        library="SDPA over the cache gathered and dequantized to bf16, the SDPA call alone",
        second_launch_bitwise=True, **({"k9b_row_equals_k9a": True} if kernel == "paged_verify_q8" else {}),
        shape=dict(groups=groups, rows=rows, hq=hq, hkv=hkv, d=d, ctx_min=int(ctx.min()),
                   ctx_max=int(ctx.max())),
    )


FALLBACK_KERNELS = {  # K10a-d's wrappers -> the TPU kernel body each replaces
    "paged_decode_fallback": "nano_pearl_tpu/ops/pallas/paged_attention.py:219",
    "paged_verify_fallback": "nano_pearl_tpu/ops/pallas/paged_attention.py:253",
    "paged_decode_fallback_q8": "nano_pearl_tpu/ops/pallas/paged_attention.py:764",
    "paged_verify_fallback_q8": "nano_pearl_tpu/ops/pallas/paged_attention.py:802",
}


def walk_design(name, lib, run, ctx, bt, rows, hq, hkv, d, bs, quant, is_local=None, ctx0=None
                ) -> tuple[str, dict, dict]:
    """The bf16 page walk's plan for a K10/K11, K7 or K6b row
    (``paged_walk.walk_plan``, checked against the launchers' exported
    ``npt_walk_plan``) as the row's ``design`` line; the blocks one call of
    ``run`` launched, by kernel (``launched_blocks``), checked against the
    plan's grid (and its combine's, none where the table is one cell); and
    what the plan says of them, computed here on the host from the row's
    tables and contexts, not measured: keys a cell, cells a table, and the
    blocks that do work (a cell below its row slice's longest context that
    holds a local page). With ``ctx0`` (K6b) the cache cells end at each
    group's pre-round context and one fresh cell follows, working where a
    row of the slice sees a fresh key."""
    from nano_pearl_tpu_torch.ops.cuda import paged_walk as kpw

    plan = kpw.walk_plan(rows, hq // hkv, hkv, d, bs, 2, quant)
    exported = [lib.npt_walk_plan(rows, hq // hkv, hkv, d, bs, 1, int(quant), w) for w in range(6)]
    want = [plan.cell, plan.warp_rows, plan.rpb, plan.threads, plan.stages, plan.smem]
    if exported != want:
        raise AssertionError(f"{name}: the launchers' plan {exported} differs from walk_plan's {plan}")
    groups, m = bt.shape
    cells = len(kpw.key_cells(m * bs, plan.cell)) + (ctx0 is not None)
    slices = -(-rows // plan.rpb)
    ctx_all = ctx.reshape(groups, rows).cpu()
    ctx_g = ctx_all.clamp(max=m * bs)
    if ctx0 is not None:
        c0 = ctx0.cpu()
        ctx_g = torch.minimum(ctx_g, c0[:, None])
    local = (is_local if is_local is not None else torch.ones_like(bt)).bool().cpu()
    working = 0
    for grp in range(groups):
        for sl in range(slices):
            rs = slice(sl * plan.rpb, (sl + 1) * plan.rpb)
            top = int(ctx_g[grp, rs].max())
            for lo in range(0, top, plan.cell):
                hi = min(lo + plan.cell, top)
                working += bool(local[grp, lo // bs : (hi - 1) // bs + 1].any())
            if ctx0 is not None:
                working += int(ctx_all[grp, rs].max()) > int(c0[grp])
    design = (f"mma.sync m16n8k16 bf16 (P as hi + lo bf16), K/V via cp.async in {plan.stages} stages of "
              f"{kpw.KEYS} keys; {plan.cell}-key cells{'' if ctx0 is None else ', the fresh rows one more'}; "
              f"{plan.rpb} rows x {hq // hkv} heads a block, {plan.threads // 32} warps, {plan.smem} B shared")
    blocks = launched_blocks(run)
    walk = sum(n for k, n in blocks.items() if k.startswith("walk_mma_kernel"))
    combine = blocks.get("walk_combine_kernel", 0)
    want = (cells * slices * hkv * groups, groups * rows * -(-hq * d // kpw.THREADS) if cells > 1 else 0)
    if (walk, combine) != want or walk + combine != sum(blocks.values()):
        raise AssertionError(f"{name}: one call launched {blocks}, the plan's grids are (walk, combine) {want}")
    return design, blocks, dict(cell_keys=plan.cell, cells=cells, working_blocks=working * hkv)


def fallback_row(gen, dev, flush, name, ctx0, rows, hq, hkv, d, bs, kind=None, layer=1) -> dict:
    """K10a (``rows`` 1, one row per context) or K10b, or over a ``kind``
    ("int8") cache K10c / K10d, on a cache of ``bs``-key pages, held against
    the plain version at TOL; K10b's (K10d's) rows against K10a's (K10c's)
    bit for bit. The bound counts each group's context once (1-byte values
    and 2 scale bytes per slot and KV head over a quantized cache), q and o;
    the yardstick is SDPA over the gathered (dequantized) cache, the SDPA
    call alone timed."""
    from nano_pearl_tpu_torch.ops.cuda import paged_attention_fallback as kfb
    from nano_pearl_tpu_torch.ops.kv_cache import QuantKVCache, _quantize_rows

    q8 = "_q8" if kind else ""
    kernel = ("paged_verify_fallback" if rows > 1 else "paged_decode_fallback") + q8
    fn, decode = getattr(kfb, kernel), getattr(kfb, "paged_decode_fallback" + q8)
    plain = kfb.plain_verify if rows > 1 else kfb.plain_decode
    groups = len(ctx0)
    m = -(-(int(max(ctx0)) + rows) // bs)
    q, cache, bt, ctx, scale = paged_inputs(gen, dev, groups, rows, ctx0, nb=groups * m + 8, bs=bs, hq=hq,
                                            hkv=hkv, d=d, m=m)
    if kind:
        values, scales = _quantize_rows(cache.view(-1, hkv, d), torch.int8)
        cache = QuantKVCache(values.view(cache.shape), scales.view(cache.shape[:-1] + (hkv,)))
        del values, scales
    args = (q, cache, layer, bt, ctx, scale) + ((rows,) if rows > 1 else ())
    got, want = fn(*args), plain(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    if rows > 1:
        single = decode(q, cache, layer, bt.repeat_interleave(rows, 0).contiguous(), ctx, scale)
        if not torch.equal(single, got):
            raise AssertionError(f"{name}: K10b/K10d rows differ from K10a/K10c on the same query and context")
    lib = lib_yardstick(*grouped_sdpa(q, cache, layer, bt, ctx, rows, hq, hkv, d, scale), want)
    kv_tokens = float(ctx.reshape(groups, rows).max(dim=1).values.sum())
    per_token = 2 * hkv * (d + 2) if kind else 2 * hkv * d * 2
    nbytes = 2 * q.numel() * 2 + bt.numel() * 4 + ctx.numel() * 4 + kv_tokens * per_token
    b_ms, b_by = bound(nbytes, 4 * float(ctx.sum()) * hq * d)
    run = lambda: fn(*args)  # noqa: E731
    ms = time_ms(run, 50, flush)
    row = dict(
        name=name, kernel=kernel, route="cuda", source="nano_pearl_tpu_torch/csrc/paged_attention_fallback.cu",
        replaces=FALLBACK_KERNELS[kernel], cache=kind or "bf16",
        max_abs_err=err, ms=ms, plain_ms=time_ms(lambda: plain(*args), 10, flush),
        bound_ms=b_ms, bound_by=b_by, share=b_ms / ms, library_ms=time_ms(lib, 50, flush),
        no_spin=no_spin_ms(run, lib, 50, flush),
        library="SDPA over the cache gathered (and dequantized) to bf16, the SDPA call alone",
        **({"verify_rows_equal_decode": True} if rows > 1 else {}),
        shape=dict(groups=groups, rows=rows, hq=hq, hkv=hkv, d=d, block=bs, ctx_min=int(ctx.min()),
                   ctx_max=int(ctx.max())),
    )
    # profiled last, after the row's timings
    row.update(zip(("design", "blocks", "plan_blocks"),
                   walk_design(name, kfb._lib(), run, ctx, bt, rows, hq, hkv, d, bs, bool(kind))))
    return row


PARTIALS_KERNELS = {  # K11a-d's wrappers -> the TPU kernel body each replaces
    "paged_decode_partials": "nano_pearl_tpu/ops/pallas/paged_attention.py:1251",
    "paged_decode_partials_q8": "nano_pearl_tpu/ops/pallas/paged_attention.py:1282",
    "paged_verify_partials": "nano_pearl_tpu/ops/pallas/paged_attention.py:1314",
    "paged_verify_partials_q8": "nano_pearl_tpu/ops/pallas/paged_attention.py:1348",
}


def sp_inputs(gen, dev, groups, rows, ctx0, kind=None):
    """``paged_inputs`` over one cache of 520 blocks (519 and the garbage
    block; ``kind`` "int8": quantized as ``write_kv`` stores it) and the
    same cache split into two shards of 260 blocks; the tables draw pages
    from both shards. Returns (q, whole cache, ShardedKVCache, tables,
    contexts, scale)."""
    from nano_pearl_tpu_torch.ops.kv_cache import QuantKVCache, ShardedKVCache, _quantize_rows

    q, cache, bt, ctx, scale = paged_inputs(gen, dev, groups, rows, ctx0, nb=519)
    if kind:
        hkv, d = cache.shape[-1] // q.shape[-1], q.shape[-1]
        values, scales = _quantize_rows(cache.view(-1, hkv, d), torch.int8)
        cache = QuantKVCache(values.view(cache.shape), scales.view(cache.shape[:-1] + (hkv,)))
        shards = tuple(QuantKVCache(cache.q[:, :, i * 260 : (i + 1) * 260].contiguous(),
                                    cache.s[:, :, i * 260 : (i + 1) * 260].contiguous()) for i in range(2))
    else:
        shards = tuple(cache[:, :, i * 260 : (i + 1) * 260].contiguous() for i in range(2))
    return q, cache, ShardedKVCache(shards, ()), bt, ctx, scale


def partials_row(gen, dev, flush, name, ctx0, rows, kind=None, layer=1, hq=8, hkv=2, d=128) -> dict:
    """K11a (``rows`` 1, one row per context) or K11c, or over an int8
    cache K11b / K11d, on each of two 260-block shards of one cache: (o, m,
    l) of every shard against the plain version (o at TOL, m and l at
    1e-4); the shards' partials merged (``parallel/sp.merge_partials``)
    against K1 / K2 (K9a / K9b) over the whole cache at TOL. Times, the
    bound and the yardstick are shard 0's: the bound counts the shard's
    local K/V of each group's context once (1-byte values and 2 scale bytes
    per slot and KV head over int8), q, o, m and l; the yardstick is SDPA
    over the shard's gathered rows masked to its local visible keys, o
    only (rows with no such key left out)."""
    from nano_pearl_tpu_torch.ops.cuda import paged_attention as kpa
    from nano_pearl_tpu_torch.ops.cuda import paged_attention_partials as kpp
    from nano_pearl_tpu_torch.parallel import sp as tsp

    q8 = "_q8" if kind else ""
    kind_name = "verify" if rows > 1 else "decode"
    kernel = f"paged_{kind_name}_partials{q8}"
    fn, plain = getattr(kpp, kernel), (kpp.plain_verify if rows > 1 else kpp.plain_decode)
    whole = getattr(kpa, f"paged_{kind_name}{q8}")
    extra = (rows,) if rows > 1 else ()
    groups = len(ctx0)
    q, cache, sharded, bt, ctx, scale = sp_inputs(gen, dev, groups, rows, ctx0, kind)
    tables = tsp.shard_tables(bt, sharded)
    parts, errs, plains = [], [], []
    for shard, (local, is_local) in zip(sharded.shards, tables):
        args = (q, shard, layer, local, ctx, is_local, scale) + extra
        got, want = fn(*args), plain(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[0].float(), want[0].float(), **TOL)
        for a, b in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        errs.append((got[0].float() - want[0].float()).abs().max().item())
        parts.append(got)
        plains.append(want)
    merged = tsp.merge_partials(parts, q.dtype)
    ref = whole(q, cache, layer, bt, ctx, scale, *extra)
    torch.testing.assert_close(merged.float(), ref.float(), **TOL)
    shard0, (local0, is_local0) = sharded.shards[0], tables[0]
    args0 = (q, shard0, layer, local0, ctx, is_local0, scale) + extra
    bs, m = 256, bt.shape[1]
    key_mask = is_local0.bool().repeat_interleave(bs, dim=1)
    real = (plains[0][2] > 0).all(dim=1)
    lib = lib_yardstick(*grouped_sdpa(q, shard0, layer, local0, ctx, rows, hq, hkv, d, scale, key_mask),
                        plains[0][0], real)
    starts = torch.arange(m, device=dev) * bs
    ctx_g = ctx.reshape(groups, rows)
    kv_tokens = float(((ctx_g.max(dim=1).values[:, None] - starts).clamp(0, bs) * is_local0).sum())
    seen = float(((ctx_g[:, :, None] - starts).clamp(0, bs) * is_local0[:, None, :]).sum())
    per_token = 2 * hkv * (d + 2) if kind else 2 * hkv * d * 2
    nbytes = 2 * q.numel() * 2 + 2 * q.shape[0] * hq * 4 + 2 * bt.numel() * 4 + ctx.numel() * 4 \
        + kv_tokens * per_token
    b_ms, b_by = bound(nbytes, 4 * seen * hq * d)
    run = lambda: fn(*args0)  # noqa: E731
    ms = time_ms(run, 50, flush)
    row = dict(
        name=name, kernel=kernel, route="cuda", source="nano_pearl_tpu_torch/csrc/paged_attention_partials.cu",
        replaces=PARTIALS_KERNELS[kernel], cache=kind or "bf16",
        max_abs_err=max(errs), merged_max_abs_err=(merged.float() - ref.float()).abs().max().item(),
        merged_against=whole.__name__,
        ms=ms, plain_ms=time_ms(lambda: plain(*args0), 10, flush),
        bound_ms=b_ms, bound_by=b_by, share=b_ms / ms, library_ms=time_ms(lib, 50, flush),
        no_spin=no_spin_ms(run, lib, 50, flush),
        library="SDPA over shard 0's gathered (dequantized) rows, masked to its local visible keys, o only",
        timed="shard 0 of 2 (260 of 520 blocks)", shard0_local_kv_tokens=kv_tokens,
        shape=dict(groups=groups, rows=rows, hq=hq, hkv=hkv, d=d, block=bs, ctx_min=int(ctx.min()),
                   ctx_max=int(ctx.max())),
    )
    row.update(zip(("design", "blocks", "plan_blocks"),  # profiled last, after the row's timings
                   walk_design(name, kpp._lib(), run, ctx, local0, rows, hq, hkv, d, bs, bool(kind), is_local0)))
    return row


def sp_bitwise_phase(dev, rows=14, layer=1) -> None:
    """After the merge, K11c rows equal K11a rows (K11d's K11b's) bit for
    bit: a verify chunk of 16 groups x 14 rows over two shards against the
    decode of each row with its group's table, bf16, for the bf16 and the
    int8 cache; each shard's (o, m, l) equal too."""
    from nano_pearl_tpu_torch.parallel import sp as tsp

    gen = torch.Generator(dev).manual_seed(7)
    ctx0 = np.random.default_rng(8).permutation(np.linspace(65, 2300, 16).astype(int))
    for kind in (None, "int8"):
        q, _, sharded, bt, ctx, scale = sp_inputs(gen, dev, 16, rows, ctx0, kind)
        bt_rows = bt.repeat_interleave(rows, 0).contiguous()
        tables, tables_rows = tsp.shard_tables(bt, sharded), tsp.shard_tables(bt_rows, sharded)
        for shard, (lg, ig), (lr, ir) in zip(sharded.shards, tables, tables_rows):
            grouped = tsp.partials_kernel("verify", shard)(q, shard, layer, lg, ctx, ig, scale, rows)
            single = tsp.partials_kernel("decode", shard)(q, shard, layer, lr, ctx, ir, scale)
            if not all(torch.equal(a, b) for a, b in zip(grouped, single)):
                raise AssertionError(f"sp_bitwise ({kind or 'bf16'}): a shard's verify partials differ from decode's")
        grouped = tsp.sp_paged_attention_grouped(q, sharded, layer, bt, ctx, scale, rows)
        single = tsp.sp_paged_attention(q, sharded, layer, bt_rows, ctx, scale)
        if not torch.equal(grouped, single):
            raise AssertionError(f"sp_bitwise ({kind or 'bf16'}): merged verify rows differ from merged decode")
    emit({"phase": "sp_bitwise", "k11c_rows_equal_k11a": True, "k11d_rows_equal_k11b": True,
          "shape": "16 groups x 14 rows, 8x128 q heads over 2 KV heads, 2 shards of 260 blocks of 256, bf16 q"})


def prefix_inputs(gen, dev, b, n_cached, lq, n_new, hq, hkv, d, nl=3, nb=64, bs=256):
    """K4's arguments: a random bf16 cache, each sequence's prefix on its
    own pages (the table padded with the garbage block to a power of two,
    as the runner pads it), and q/k/v of ``lq`` bucket rows of which the
    first ``n_new`` are real."""
    cache = torch.randn((nl, 2, nb + 1, bs, hkv * d), generator=gen, device=dev).to(torch.bfloat16)
    pages = -(-n_cached // bs)
    mpre = 1 << max(0, (pages - 1).bit_length())
    perm = torch.randperm(nb, generator=gen, device=dev).to(torch.int32)
    bt = torch.full((b, mpre), nb, dtype=torch.int32, device=dev)
    for i in range(b):
        bt[i, :pages] = perm[i * pages : (i + 1) * pages]
    q = torch.randn((b * lq, hq, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b * lq, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b * lq, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
    nc = torch.full((b,), n_cached, dtype=torch.int32, device=dev)
    nn = torch.full((b,), n_new, dtype=torch.int32, device=dev)
    return q, k, v, cache, nl - 1, bt, nc, nn, d**-0.5


def prefill_bitwise_phase(dev) -> dict:
    """Row independence of the bf16 prefill kernels on the card, bit for
    bit: K3's rows of the main path's prompts (32 x 64 tokens, 8x128 heads
    over 2) in a 128-row and in a 256-row bucket; K4's rows of one sequence
    of the serve shape (512 cached + 64 new rows in the 128-row bucket,
    16x64 heads over 2) run alone and inside the batch of 8."""
    from nano_pearl_tpu_torch.ops.cuda import prefill_attention as kpf

    gen = torch.Generator(dev).manual_seed(8)
    b, n, hq, hkv, d = 32, 64, 8, 2, 128
    fresh = [torch.randn((b, n, h, d), generator=gen, device=dev).to(torch.bfloat16) for h in (hq, hkv, hkv)]
    outs = {}
    for lq in (128, 256):
        pos = torch.full((b, lq), -1, dtype=torch.int32, device=dev)
        pos[:, :n] = torch.arange(n, dtype=torch.int32, device=dev)
        padded = [torch.cat([x, torch.zeros((b, lq - n) + x.shape[2:], dtype=x.dtype, device=dev)], 1)
                  .reshape(b * lq, -1, d) for x in fresh]
        outs[lq] = kpf.prefill_self(*padded, pos, d**-0.5).reshape(b, lq, hq, d)[:, :n]
    k3_equal = bool(torch.equal(outs[128], outs[256]))
    args = prefix_inputs(gen, dev, b=8, n_cached=512, lq=128, n_new=64, hq=16, hkv=2, d=64)
    q, k, v, cache, layer, bt, nc, nn, scale = args
    batch = kpf.prefill_prefix(*args)
    k4_equal = {}
    for i in (0, 5):
        rows = slice(i * 128, (i + 1) * 128)
        alone = kpf.prefill_prefix(q[rows], k[rows], v[rows], cache, layer, bt[i : i + 1].contiguous(),
                                   nc[i : i + 1], nn[i : i + 1], scale)
        k4_equal[f"sequence_{i}"] = bool(torch.equal(alone, batch[rows]))
    torch.cuda.synchronize()
    out = {"phase": "prefill_bitwise", "k3_rows_equal_across_buckets_128_256": k3_equal,
           "k4_rows_alone_equal_in_batch": k4_equal,
           "shape": {"k3": "32 prompts x 64 tokens, 8x128 q heads over 2, bf16",
                     "k4": "8 x (512 cached + 64 new) in a 128-row bucket, 16x64 q heads over 2, bf16"}}
    emit(out)
    if not (k3_equal and all(k4_equal.values())):
        raise AssertionError(f"prefill rows depend on the bucket or the batch: {out}")
    return out


# K4's rows (prefix_inputs' arguments): the serve pair's prefix hit (8 x
# 512 cached + 64 new rows in the 128-row bucket, 16x64 heads), a
# chunked-prefill pass (1 x 2048 cached + 1024 new), the bench pair's 8x128
# heads, and head dims 16, 32 and 256
PREFIX_ROWS = {
    "prefill_prefix": dict(b=8, n_cached=512, lq=128, n_new=64, hq=16, hkv=2, d=64),
    "prefill_prefix_chunked_pass": dict(b=1, n_cached=2048, lq=1024, n_new=1024, hq=16, hkv=2, d=64),
    "prefill_prefix_d128": dict(b=8, n_cached=512, lq=128, n_new=64, hq=8, hkv=2, d=128),
    "prefill_prefix_d16": dict(b=8, n_cached=512, lq=128, n_new=64, hq=4, hkv=2, d=16),
    "prefill_prefix_d32": dict(b=8, n_cached=512, lq=128, n_new=64, hq=16, hkv=4, d=32),
    "prefill_prefix_d256": dict(b=8, n_cached=512, lq=128, n_new=64, hq=8, hkv=2, d=256),
}


def prefix_kernel_rows(gen, dev, flush) -> list[dict]:
    """K4 at each of PREFIX_ROWS."""
    import torch.nn.functional as F

    from nano_pearl_tpu_torch.ops.attention import _gather_kv
    from nano_pearl_tpu_torch.ops.cuda import prefill_attention as kpf

    rows = []
    for name, c in PREFIX_ROWS.items():
        args = prefix_inputs(gen, dev, **c)
        q, k, v, cache, layer, bt, nc, nn, scale = args
        got, want = kpf.prefill_prefix(*args), kpf.plain_prefix(*args)
        torch.cuda.synchronize()
        b, lq, hq, hkv, d = c["b"], c["lq"], c["hq"], c["hkv"], c["d"]
        real = (torch.arange(lq, device=dev)[None, :] < nn[:, None]).reshape(-1)
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), **TOL)
        if not bool((got[~real] == 0).all()):
            raise AssertionError(f"K4 {name}: padded rows must give 0")
        # yardstick: SDPA over the gathered prefix + fresh K/V, explicit mask
        pk, pv = _gather_kv(cache, layer, bt, d)  # [B, S_pre, Hkv, D]
        keys = torch.cat([pk, k.reshape(b, lq, hkv, d)], 1).transpose(1, 2).repeat_interleave(hq // hkv, 1)
        vals = torch.cat([pv, v.reshape(b, lq, hkv, d)], 1).transpose(1, 2).repeat_interleave(hq // hkv, 1)
        i = torch.arange(lq, device=dev)
        s = torch.arange(pk.shape[1], device=dev)
        rr = i[None, :, None] < nn[:, None, None]
        mask = torch.cat([rr & (s[None, None, :] < nc[:, None, None]),
                          rr & (i[None, None, :] <= i[None, :, None])], dim=2)[:, None]
        qs = q.reshape(b, lq, hq, d).transpose(1, 2)
        lib = lib_yardstick(
            lambda: F.scaled_dot_product_attention(qs, keys, vals, attn_mask=mask, scale=scale),  # noqa: B023
            lambda o: o.transpose(1, 2).reshape(b * lq, hq, d), want, real,  # noqa: B023
        )
        n_real, n_c = float(nn.sum()), float(nc.sum())
        nbytes = (n_real * (hq + 2 * hkv) * d + n_c * 2 * hkv * d + b * lq * hq * d) * 2 \
            + bt.numel() * 4 + 2 * b * 4
        flops = 4.0 * hq * d * float((nn * nc + nn * (nn + 1) // 2).sum())
        b_ms, b_by = bound(nbytes, flops)
        design, split = prefill_design(name, hq // hkv, d, True, bt.shape[1] * cache.shape[3] + lq)
        run = lambda: kpf.prefill_prefix(*args)  # noqa: B023, E731
        rows.append(dict(
            name=name, kernel="prefill_prefix", route="cuda", source="nano_pearl_tpu_torch/csrc/prefill_attention.cu",
            replaces="nano_pearl_tpu/ops/pallas/prefill_attention.py:259",
            max_abs_err=err, ms=time_ms(run, 20, flush),
            plain_ms=time_ms(lambda: kpf.plain_prefix(*args), 5, flush),  # noqa: B023
            bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib, 20, flush),
            no_spin=no_spin_ms(run, lib, 20, flush), design=design, split=split, shape=c,
        ))
        rows[-1]["blocks"] = blocks = launched_blocks(run)  # profiled last, after the row's timings
        if ("prefill_combine_kernel" in blocks) != split["combine"]:
            raise AssertionError(f"{name}: one call launched {blocks}, the plan's split is {split}")
    return rows


# ------------------------------------------------------------- engine runs


def model_config(layers: int, dtype: str):
    from nano_pearl_tpu_torch import ModelConfig

    return ModelConfig(
        architecture="LlamaForCausalLM", hidden_size=1024, intermediate_size=4096,
        num_hidden_layers=layers, num_attention_heads=8, num_key_value_heads=2,
        vocab_size=32768, eos_token_id=1, dtype=dtype, max_position_embeddings=2048,
    )


@contextlib.contextmanager
def overrides(env: dict | None):
    """The kernel-schedule variables ``env`` (NANO_PEARL_*) set in
    os.environ for the block only, as they were before afterwards: a runner
    reads them once when it is built."""
    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def pair_engine(ld, lt, dtype, batch, gamma, steps, prompt_len, dev, profile="ceiling", draft_noise=0.0,
                kv_quant=None, quant=None, env=None, dirs=None, sp=1, num_blocks=None, widths=None):
    """The bench's engine set-up (bench.py run()) on the port; ``kv_quant``
    and ``quant`` as bench.py's ``--kv-quant`` and ``--quant`` (both
    models); ``env``: schedule overrides set around the construction;
    ``dirs``: (draft, target) HF checkpoint directories the engine loads,
    in place of the bench's layer-share pair; ``sp``: draft_sp = target_sp
    (sequence parallelism, the shards sharing the one card); ``num_blocks``:
    the pools' blocks, in place of the bench's count; ``widths``: the
    layer-share pair's ModelConfig fields (as SMOLLM2_360M), in place of
    the bench's widths."""
    from nano_pearl_tpu_torch import ModelConfig, PearlConfig, PearlEngine
    from nano_pearl_tpu_torch.utils.layer_share import build_layer_share_pair

    if dirs:
        (md, mt), dp, tp = dirs, None, None
    else:
        md, mt = ((model_config(ld, dtype), model_config(lt, dtype)) if widths is None else
                  (ModelConfig(num_hidden_layers=ld, **widths), ModelConfig(num_hidden_layers=lt, **widths)))
        dp, tp = build_layer_share_pair(md, mt, seed=0, draft_noise=draft_noise)
    max_len = max(256, 1 << (prompt_len + steps * (gamma + 1) + 64).bit_length())
    cfg = PearlConfig(
        draft_model=md, target_model=mt, max_model_len=max_len,
        max_num_batched_tokens=max(16384, batch * prompt_len), kvcache_block_size=256,
        num_kvcache_blocks=num_blocks or batch * (max_len // 256) + 8, gamma=gamma,
        max_num_seqs=max(batch, 8), seed=0, dtype=dtype, perf_profile=profile,
        draft_kv_quant=kv_quant, target_kv_quant=kv_quant, draft_quant=quant, target_quant=quant,
        draft_sp=sp, target_sp=sp,
    )
    with overrides(env):
        return PearlEngine(cfg, dp, tp, device=dev)


def add_requests(engine, rng, batch, prompt_len, max_tokens, vocab=32768):
    from nano_pearl_tpu_torch import SamplingParams

    for _ in range(batch):
        prompt = rng.integers(2, vocab - 1, prompt_len).tolist()
        engine.add_request(prompt, SamplingParams(temperature=0.0, max_tokens=max_tokens, ignore_eos=True))


def traced_forward(runner, tokens, positions, slots, attn_fn, attn_args, trace_layers: int,
                   store: bool = True):
    """``models.transformer.forward`` + ``compute_logits`` op by op, keeping
    the output of every op of the first ``trace_layers`` layers, the final
    norm and the logits as (name, tensor). ``attn_fn`` is called as
    ``run_layers`` calls it; ``store`` False leaves the cache alone, as
    the deferred verify's layers do. The caller checks that it reproduces
    the real forward bit for bit."""
    import torch.nn.functional as F

    from nano_pearl_tpu_torch.models.transformer import compute_logits, rms_norm
    from nano_pearl_tpu_torch.ops.kv_cache import write_kv
    from nano_pearl_tpu_torch.ops.quant import layer_weight, mm
    from nano_pearl_tpu_torch.ops.rope import apply_rope

    cfg, p, lay = runner.cfg, runner.params, runner.params["layers"]
    d, hq, hkv, eps = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads, cfg.rms_norm_eps
    ops = []
    x = p["embed"][tokens.long()]
    rope_rows = runner.rope_table[torch.clamp(positions.long(), max=runner.rope_table.shape[0] - 1)]
    res = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for li in range(lay["input_ln"].shape[0]):
        rec = (lambda name, t: ops.append((f"layer{li}.{name}", t))) if li < trace_layers \
            else (lambda name, t: None)
        lp = {key: layer_weight(val, li) for key, val in lay.items()}
        res2 = x.float() + res
        rec("residual_add", res2)
        h1 = rms_norm(res2, lp["input_ln"], eps, out_dtype=x.dtype)
        rec("input_rms_norm", h1)
        q, k, v = mm(h1, lp["wq"]), mm(h1, lp["wk"]), mm(h1, lp["wv"])
        rec("q_gemm", q), rec("k_gemm", k), rec("v_gemm", v)
        q = apply_rope(q.reshape(-1, hq, d), rope_rows)
        k = apply_rope(k.reshape(-1, hkv, d), rope_rows)
        rec("q_rope", q), rec("k_rope", k)
        v = v.reshape(-1, hkv, d)
        if store:
            write_kv(runner.kv, k, v, slots, li)
        if getattr(attn_fn, "wants_fresh_and_cache", False):
            o = attn_fn(q, k, v, runner.kv, li, *attn_args)
        else:
            o = attn_fn(q, runner.kv, li, *attn_args)
        rec("attention", o)
        attn_out = mm(o.reshape(-1, hq * d), lp["wo"])
        rec("o_gemm", attn_out)
        res3 = attn_out.float() + res2
        rec("attn_residual_add", res3)
        h2 = rms_norm(res3, lp["post_ln"], eps, out_dtype=x.dtype)
        rec("post_rms_norm", h2)
        gate, up = mm(h2, lp["wgate"]), mm(h2, lp["wup"])
        rec("gate_gemm", gate), rec("up_gemm", up)
        act = F.silu(gate.float()).to(x.dtype) * up
        rec("silu_mul", act)
        x = mm(act, lp["wdown"])
        rec("down_gemm", x)
        res = res3
    hidden = rms_norm(x.float() + res, p["final_ln"], eps, out_dtype=x.dtype)
    ops.append(("final_rms_norm", hidden))
    logits = compute_logits(cfg, p, hidden)
    ops.append(("lm_head", logits))
    return ops


def probe_decode_verify(engine, batch: int, gamma: int, system_len: int = 0) -> dict:
    """One PEARL round re-scored op by op: the draft's gamma decode steps
    from each sequence's last committed token, then the target's packed
    verify of the same window (its tokens teacher-forced from the draft's
    picks). Decode step j of sequence g and verify row g * gamma + j see
    the same token, position and context, so every op of the first 3
    layers and the logits should agree bit for bit. Probes the decode
    unpadded (one call over the batch's rows) and as engine/fused.py runs
    it (``decode_chunking``: calls of one verify chunk's rows); returns,
    per variant, the first op whose outputs differ and the (sequence,
    step) pairs whose logits differ. With ``system_len`` every prompt
    starts with one shared prefix of that many tokens, which all but the
    first request read from the prefix cache (kernel K4), and contexts
    span several key chunks of K1/K2. Under the throughput profile the
    decode is K5's and the verify the deferred one (K7 + fresh window);
    under the split schedule the decode is K8a's, every step cut at the
    verify's window start (b1 = length - 1, the probe's ctx0), and the
    verify K8b's; under a deferred verify on the db schedule, K1 and K6a."""
    from nano_pearl_tpu_torch.engine.fused import _row_slots
    from nano_pearl_tpu_torch.engine.runner import _deferred_attn, _split_decode
    from nano_pearl_tpu_torch.ops.attention import (
        paged_attention,
        paged_attention_grouped,
        paged_attention_mono,
    )
    from nano_pearl_tpu_torch.ops.sampling import greedy

    from nano_pearl_tpu_torch import SamplingParams

    rng = np.random.default_rng(batch + gamma + system_len)
    system = rng.integers(2, 32767, system_len).tolist()
    for _ in range(batch):
        engine.add_request(system + rng.integers(2, 32767, 64).tolist(),
                           SamplingParams(temperature=0.0, max_tokens=8, ignore_eos=True))
    orch = engine.orchestrator
    orch.prefill_all()
    seqs = engine.scheduler.schedule_decode(lookahead=2 * gamma + 2)
    state = orch._build_fused_state(seqs)
    dr, tr = engine.draft, engine.target
    bs = tr.block_size
    length, tokens, b_pad = state["length"], state["tokens"], state["length"].shape[0]
    last = torch.gather(tokens, 1, (length - 1)[:, None].long())[:, 0]
    dev = length.device
    n_draft = dr.cfg.num_hidden_layers  # the target's first layers are the draft's
    decode_attn = paged_attention_mono if dr.use_mono else paged_attention

    def traced_verify(t, p, sl, bt, c):
        if not tr.deferred_verify:  # classic; the throughput profile's over a quantized cache is K9c's
            attn = paged_attention_mono if tr.use_mono else paged_attention_grouped
            return traced_forward(tr, t, p, sl, attn, (bt, c, tr.scale, gamma), n_draft)
        ctx0 = c.reshape(-1, gamma)[:, 0] - 1
        return traced_forward(tr, t, p, sl, _deferred_attn,
                              (bt, c, ctx0, tr.scale, gamma, tr.fresh_schedule), n_draft, store=False)

    def gamma_scan(calls, rows):
        """Traced decode steps in ``calls`` calls of ``rows`` rows (padding
        as _draft_gamma)."""
        pad = calls * rows - b_pad
        z = torch.zeros(pad, dtype=torch.int32, device=dev)
        bt = torch.cat([state["bt_d"], torch.full((pad, state["bt_d"].shape[1]), dr.garbage_block,
                                                  dtype=torch.int32, device=dev)])
        tok, pos, ctx = torch.cat([last, z]), torch.cat([length - 1, z]), torch.cat([length, z + 1])
        b1 = torch.cat([length - 1, z])  # the verify's window start, padded rows 0
        steps, picks = [], []
        for _ in range(gamma):
            sl = _row_slots(bt, pos[:, None], bs)[:, 0]
            per_call, logits = [], []
            for c in range(calls):
                t, p, s_, b_, c_, b1_ = (x[c * rows : (c + 1) * rows] for x in (tok, pos, sl, bt, ctx, b1))
                if dr.split:
                    logits.append(dr.decode_step(t, p, s_, b_, c_, b1_))
                    attn, args = _split_decode, (b_, c_, b1_, dr.scale)
                else:
                    logits.append(dr.decode_step(t, p, s_, b_, c_))
                    attn, args = decode_attn, (b_, c_, dr.scale)
                per_call.append(traced_forward(dr, t, p, s_, attn, args, n_draft))
                if not torch.equal(per_call[-1][-1][1], logits[-1]):
                    raise AssertionError("the traced decode does not reproduce the real one")
            steps.append([(name, torch.cat([ops[i][1] for ops in per_call]))
                          for i, (name, _) in enumerate(per_call[0])])
            tok = greedy(torch.cat(logits))
            picks.append(tok[:b_pad])
            pos, ctx = pos + 1, ctx + 1
        return steps, torch.stack(picks, 1)

    engine_chunking = orch.fused.decode_chunking(b_pad, gamma)
    variants = {}
    for variant, (calls, rows) in (("unpadded", (1, b_pad)), ("engine", engine_chunking)):
        if variant == "engine" and (calls, rows) == (1, b_pad):
            variants[variant] = variants["unpadded"]
            continue
        steps, picks = gamma_scan(calls, rows)
        # the target's verify of this window, the draft's picks as its tokens
        j = torch.arange(gamma, dtype=torch.int32, device=dev)[None, :]
        vt = torch.cat([last[:, None], picks[:, :-1]], 1)
        vp = length[:, None] - 1 + j
        vs = _row_slots(state["bt_t"], vp, bs)
        flat = [x.reshape(-1).contiguous() for x in (vt, vp, vs, vp + 1)]
        want = tr.packed_verify_forward(flat[0], flat[1], flat[2], state["bt_t"], flat[3], gamma)
        per_chunk = [
            traced_verify(*chunk)
            for chunk in tr.verify_chunks(*flat[:3], state["bt_t"], flat[3], gamma)
        ]
        v_ops = [(name, torch.cat([ch[i][1] for ch in per_chunk])[: b_pad * gamma])
                 for i, (name, _) in enumerate(per_chunk[0])]
        if not torch.equal(v_ops[-1][1], want):
            raise AssertionError("the traced verify does not reproduce the real one")
        first, diff_there = None, 0.0
        for i, (name, v) in enumerate(v_ops):
            a = torch.stack([st[i][1][:batch] for st in steps], 1)  # [B, gamma, ...]
            b = v.reshape(b_pad, gamma, *v.shape[1:])[:batch]
            if first is None and not torch.equal(a, b):
                first, diff_there = name, (a.float() - b.float()).abs().max().item()
        a = torch.stack([st[-1][1][:batch] for st in steps], 1)
        b = v_ops[-1][1].reshape(b_pad, gamma, -1)[:batch]
        variants[variant] = {
            "decode_calls": calls, "decode_rows_per_call": rows,
            "first_differing_op": first, "max_abs_diff_there": diff_there,
            "logits_bitwise_equal": first is None,
            "logit_rows_differing": int((a != b).any(-1).sum()),
            "argmax_differing": int((a.argmax(-1) != b.argmax(-1)).sum()),
        }
    engine.scheduler.clear()
    return {"batch": batch, "batch_bucket": b_pad, "gamma": gamma, "system_prefix": system_len,
            "verify_chunk_rows": tr.verify_chunk_rows(b_pad, gamma), "variants": variants}


def decode_verify_bitwise_phase(dev) -> None:
    """Guard of the layer-share pair's acceptance ceiling: at the main
    path's shapes (bf16 3L/36L bench pair, B=32, gamma=14) and at the
    serve pair's (16x64 heads, gamma=8, B = 8, 16, 32, 16 behind one
    512-token cached prefix, and 136 in the 256-row bucket, past one
    128-row verify chunk), the engine's decode must give logits bitwise
    equal to the verify's."""
    from nano_pearl_tpu_torch import PearlConfig, PearlEngine, serve
    from nano_pearl_tpu_torch.utils.layer_share import build_layer_share_pair

    probes = []
    engine = pair_engine(3, 36, "bfloat16", 32, 14, 4, 64, dev)
    probes.append({"pair": "bench 3L/36L, 8x128 q heads", **probe_decode_verify(engine, 32, 14)})
    del engine
    args = serve_args()
    md, mt = serve.layer_share_models(args)
    dp, tp = build_layer_share_pair(md, mt, args.seed)
    cfg = PearlConfig(draft_model=md, target_model=mt, max_model_len=args.max_model_len,
                      gamma=args.gamma, num_kvcache_blocks=200, dtype=md.dtype)
    engine = PearlEngine(cfg, dp, tp, device=dev)
    for batch, system_len in ((8, 0), (16, 0), (32, 0), (16, 512), (136, 0)):
        probes.append({"pair": "serve 3L/36L, 16x64 q heads",
                       **probe_decode_verify(engine, batch, args.gamma, system_len)})
    del engine, dp, tp
    torch.cuda.empty_cache()
    emit({"phase": "decode_verify_bitwise", "dtype": "bfloat16", "probes": probes})
    bad = [p for p in probes if not p["variants"]["engine"]["logits_bitwise_equal"]]
    if bad:
        raise AssertionError(f"decode and verify logits differ at the engine's shapes: {bad}")


def decode_verify_overrides_phase(dev) -> None:
    """The probe on the bench pair (B=32, gamma=14) under the split schedule
    (K8a decode, K8b verify) and under the deferred verify on the db
    schedule (K1 decode, K6a verify): the first op whose outputs differ is
    printed, not asserted."""
    probes = []
    for name, env in (("split", {"NANO_PEARL_SPLIT": "1"}), ("deferred_db", {"NANO_PEARL_DEFERRED_VERIFY": "1"})):
        engine = pair_engine(3, 36, "bfloat16", 32, 14, 4, 64, dev, env=env)
        probes.append({"schedule": name, "env": env, **probe_decode_verify(engine, 32, 14)})
        del engine
        torch.cuda.empty_cache()
    emit({"phase": "decode_verify_bitwise_overrides", "dtype": "bfloat16",
          "pair": "bench 3L/36L, 8x128 q heads", "probes": probes})


def decode_verify_throughput_phase(dev) -> None:
    """The same probe under the throughput profile (K5 decode at the batch
    bucket's rows, deferred verify through K7 and the fresh window) on the
    noiseless bench pair, B=32, gamma=14, and the MAT of 10 PEARL rounds
    there: where the two streams first round apart, before the profile's
    MAT is trusted. Nothing is asserted: the profile does not promise
    bitwise agreement."""
    batch, gamma, prompt_len, rounds = 32, 14, 64, 10
    engine = pair_engine(3, 36, "bfloat16", batch, gamma, rounds, prompt_len, dev, profile="throughput")
    probe = probe_decode_verify(engine, batch, gamma)
    add_requests(engine, np.random.default_rng(1), batch, prompt_len, rounds * (gamma + 1))
    _, num_tokens, _, _ = engine.bench_generate(num_pearl_steps=rounds)
    mat = float(np.mean([(n - 1) / rounds for n in num_tokens]))
    emit({"phase": "decode_verify_bitwise_throughput", "dtype": "bfloat16",
          "pair": "bench 3L/36L, 8x128 q heads, noiseless", **probe, "mat_10_rounds": mat})
    del engine
    torch.cuda.empty_cache()


def quant_launch_check(engine, phase, quant, kv_quant, before, counters) -> dict:
    """Under quantization the engine must hold quantized weights and cache
    and have run the K9 kernels on them; returns their launches."""
    from nano_pearl_tpu_torch.ops.kv_cache import cache_is_quantized
    from nano_pearl_tpu_torch.ops.quant import is_quantized

    launches = {k: counters[k].launches - before[k] for k in Q8_KERNELS}
    if kv_quant and not (cache_is_quantized(engine.target.kv) and any(launches.values())):
        raise AssertionError(f"{phase}: the KV cache is not quantized or no K9 kernel ran: {launches}")
    if quant and not is_quantized(engine.target.params["layers"]["wq"]):
        raise AssertionError(f"{phase}: the weights are not quantized")
    return launches


def quant_label(kv_quant, quant) -> str:
    return "".join([f", {kv_quant} KV" if kv_quant else "", f", {quant} weights" if quant else ""])


def override_launch_check(phase, env, counters, before, ran) -> dict:
    """Under schedule overrides the phase must have launched ``ran``;
    returns their launches."""
    launches = {k: counters[k].launches - before[k] for k in ran}
    if env and not all(launches.values()):
        raise AssertionError(f"{phase}: a kernel of the override {env} never ran: {launches}")
    return launches


def exactness_phase(dev, kv_quant=None, quant=None, phase="exactness", env=None, ran=(), sp=1,
                    unsharded=None, windows: int = 16, num_blocks=None) -> list:
    """f32 layer-share pair: the PEARL stream must equal the AR stream
    (``kv_quant`` / ``quant``: over a quantized cache / weights; ``env``:
    under schedule overrides, whose kernels ``ran`` must have launched;
    ``windows`` accepted windows per request; ``num_blocks``: the pools'
    blocks). With ``sp`` > 1 (draft_sp = target_sp, the shards on the one
    card) the stream must also equal ``unsharded``, the same run's stream
    without sp, and exactly the sp kernels (``sp_kernels``) must have
    launched. Returns the PEARL stream."""
    batch, gamma, prompt_len = 4, 4, 64
    max_tokens = 1 + windows * gamma  # a whole number of accepted windows
    engine = pair_engine(2, 6, "float32", batch, gamma, windows, prompt_len, dev, kv_quant=kv_quant,
                         quant=quant, env=env, sp=sp, num_blocks=num_blocks)
    counters = kernel_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    add_requests(engine, np.random.default_rng(1), batch, prompt_len, max_tokens)
    pearl, n_pearl, acc, _ = engine.generate_token_ids()
    add_requests(engine, np.random.default_rng(1), batch, prompt_len, max_tokens)
    ar, n_ar, _, _ = engine.AR_generate_token_ids()
    if pearl != ar:
        first = next(
            (i, j) for i, (p, a) in enumerate(zip(pearl, ar))
            for j in range(min(len(p), len(a)) + 1) if p[:j + 1] != a[:j + 1]
        )
        raise AssertionError(f"{phase}: f32 PEARL != AR: first divergence (request, token) {first}")
    extra = {}
    if sp > 1:
        if pearl != unsharded:
            raise AssertionError(f"{phase}: the sp stream differs from the unsharded stream")
        launches = {k: fn.launches - before[k] for k, fn in counters.items()}
        check_launches(phase, launches, *sp_kernels(kv_quant))
        extra = {"equals_unsharded_stream": True, "launches": {k: n for k, n in launches.items() if n},
                 "kv_shards": sp}
    else:
        q8 = quant_launch_check(engine, phase, quant, kv_quant, before, counters)
        extra = {"k9_launches": q8} if kv_quant else {}
    ov = override_launch_check(phase, env, counters, before, ran)
    emit({"phase": phase, "pearl_equals_ar": True, "tokens": n_pearl,
          "accepted_tokens": [sum(a) for a in acc], **extra,
          **({"env": env, "launches": ov} if env else {}),
          "config": "f32 layer-share 2L/6L full width, B=4, gamma=4" + quant_label(kv_quant, quant)
                    + (f", draft_sp = target_sp = {sp} on one card" if sp > 1 else "")})
    del engine
    torch.cuda.empty_cache()
    return pearl


def sp_exactness_phase(dev, kv_quant=None, quant=None) -> None:
    """f32 PEARL == AR under draft_sp = target_sp = 2, and the stream equal
    to the same run's without sp. 321-token sequences (2 blocks of 256)
    over pools of 9 blocks (5 per shard with the garbage block): each
    sequence's page 0 lies in shard 0 and its page 1 in shard 1 (the block
    manager stripes pages over the shards), so every context spans both."""
    kw = dict(kv_quant=kv_quant, quant=quant, windows=64, num_blocks=9)
    unsharded = exactness_phase(dev, phase="sp_exactness_unsharded", **kw)
    exactness_phase(dev, phase="sp_exactness", sp=2, unsharded=unsharded, **kw)


def sp_kernels(kv_quant=None) -> tuple[tuple, tuple]:
    """(kernels an sp run launches, kernels it must not): prefill K3, decode
    K11a and verify K11c (K11b / K11d over a 1-byte cache); nothing else."""
    q8 = "_q8" if kv_quant else ""
    ran = ("prefill_self", f"paged_decode_partials{q8}", f"paged_verify_partials{q8}")
    return ran, tuple(k for k in kernel_counters() if k not in ran)


def throughput_exactness_phase(dev, draft_noise: float = 0.005, kv_quant=None, quant=None,
                               phase="throughput_exactness", env=None, ran=()) -> None:
    """The throughput profile on the f32 2L/6L pair at full width with a
    noisy draft (B=4, gamma=4): rounds reject and roll back over deferred
    writes, and every PEARL token the target verified must equal AR's at
    its position. A request that finishes on an accepted round ends with
    its last draft window unverified (the finish rule of the JAX package
    and the reference), so those gamma tokens are left out; AR runs
    2 * gamma tokens further so that it covers every PEARL stream. Over a
    quantized cache the verify is the classic write-then-read one (K9c)."""
    batch, gamma, prompt_len = 4, 4, 64
    max_tokens = 1 + 16 * gamma
    engine = pair_engine(2, 6, "float32", batch, gamma, 16, prompt_len, dev, profile="throughput",
                         draft_noise=draft_noise, kv_quant=kv_quant, quant=quant, env=env)
    counters = kernel_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    add_requests(engine, np.random.default_rng(1), batch, prompt_len, max_tokens)
    pearl, n_pearl, acc, _ = engine.generate_token_ids()
    add_requests(engine, np.random.default_rng(1), batch, prompt_len, max_tokens + 2 * gamma)
    ar, _, _, _ = engine.AR_generate_token_ids()
    verified = [len(p) - gamma for p in pearl]
    bad = [i for i, (p, a, n) in enumerate(zip(pearl, ar, verified)) if n <= 0 or p[:n] != a[:n]]
    if bad:
        raise AssertionError(f"{phase}: f32 throughput PEARL != AR for requests {bad}")
    q8 = quant_launch_check(engine, phase, quant, kv_quant, before, counters)
    ov = override_launch_check(phase, env, counters, before, ran)
    # a request whose every round accepted has one accepted-token emit
    rejections = sum(len(a) - 1 for a in acc)
    emit({"phase": phase, "pearl_equals_ar": True, "tokens": n_pearl,
          "verified_tokens_compared": verified, "rounds_with_a_rejection": rejections,
          "accepted_tokens": [sum(a) for a in acc],
          **({"k9_launches": q8} if kv_quant else {}), **({"env": env, "launches": ov} if env else {}),
          "config": f"f32 layer-share 2L/6L full width, draft_noise {draft_noise}, B=4, gamma=4, "
                    "throughput profile" + quant_label(kv_quant, quant)})
    if rejections < 1:
        raise AssertionError("no round rejected: the noisy draft did not exercise rollback")
    del engine
    torch.cuda.empty_cache()


def bench_run(dev, steps: int, profile: str, draft_noise: float, kv_quant=None, quant=None, env=None,
              ar_of: tuple[str, float] | None = None, ar_cut: int = 1, dirs=None, vocab: int = 32768,
              label: str | None = None, sp: int = 1) -> tuple[dict, dict]:
    """bench.py's run on the port: the bf16 3L/36L layer-share pair, B=32,
    gamma=14, prompt 64, greedy, ``steps`` PEARL rounds, then AR over the
    same window on the same prompts (``kv_quant``, ``quant``: bench.py's
    ``--kv-quant``, ``--quant``; ``env``: schedule overrides around the
    engine's construction). With ``ar_of`` = (path, AR tok/s) the AR run
    is left out and the speedup taken against that path's AR of this call:
    the overrides change no kernel of AR but the schedule of its decode, as
    in the JAX package. ``ar_cut`` > 1 runs the first 1 / ar_cut of the AR
    window only (AR_CUT on every path, to keep the script inside its time
    limit). ``dirs``: the (draft, target) checkpoint directories to load in
    place of the layer-share pair (``label`` its description, ``vocab`` its
    vocabulary). ``sp``: draft_sp = target_sp. The launch counters are set
    to 0 just before the measured runs. Returns (the phase's line without
    its name, launches)."""
    from nano_pearl_tpu_torch.ops.kv_cache import cache_nbytes

    counters = kernel_counters()
    batch, gamma, prompt_len = 32, 14, 64
    ar_max_tokens = steps * (gamma + 1)
    ar_steps = (ar_max_tokens - 1) // ar_cut  # prefill commits one token per sequence
    t0 = time.perf_counter()
    engine = pair_engine(3, 36, "bfloat16", batch, gamma, steps, prompt_len, dev, profile, draft_noise,
                         kv_quant, quant, env, dirs, sp)
    build_s = time.perf_counter() - t0
    # bytes of both KV pools per block, from the allocated tensors
    kv_bytes = (cache_nbytes(engine.draft.kv) + cache_nbytes(engine.target.kv)) / (engine.target.num_blocks + 1)
    shards = {}
    if sp > 1:  # each pool's shards: their blocks and bytes (sink rows included)
        shards = {"kv_shards": sp, "kv_blocks_per_shard": engine.target.kv.nb1_local,
                  "kv_pool_bytes_per_shard": {r.name: [cache_nbytes(f) for f in r.kv.flats]
                                              for r in (engine.draft, engine.target)}}
    # warm-up, as bench.py does (cuBLAS handles, allocator), not measured
    add_requests(engine, np.random.default_rng(0), batch, prompt_len, ar_max_tokens, vocab)
    engine.bench_generate(num_pearl_steps=2, reserve_steps=steps)
    if ar_of is None:
        add_requests(engine, np.random.default_rng(0), batch, prompt_len, ar_max_tokens, vocab)
        engine.AR_bench_generate(num_steps=4, reserve_steps=ar_steps)

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    # both runs decode the same prompts, so their streams can be compared
    add_requests(engine, np.random.default_rng(1), batch, prompt_len, ar_max_tokens, vocab)
    pearl_toks, num_tokens, _, pearl_t = engine.bench_generate(num_pearl_steps=steps)
    pearl_launches = {k: fn.launches for k, fn in counters.items()}
    ar_toks = []
    if ar_of is None:
        add_requests(engine, np.random.default_rng(1), batch, prompt_len, ar_max_tokens, vocab)
        ar_toks, ar_tokens, _, ar_t = engine.AR_bench_generate(num_steps=ar_steps)
    launches = {k: fn.launches for k, fn in counters.items()}
    ar_launches = {k: launches[k] - pearl_launches[k] for k in counters}
    peak = torch.cuda.max_memory_allocated(dev)
    schedule = {k: getattr(engine.target, k) for k in ("use_mono", "deferred_verify", "split", "fresh_mode")}
    del engine
    torch.cuda.empty_cache()

    pearl_tps = sum(num_tokens) / pearl_t
    mat = float(np.mean([(n - 1) / steps for n in num_tokens]))  # bench.py's MAT
    if any(n < 1 + steps for n in num_tokens):
        raise AssertionError(f"a PEARL round committed no token: {num_tokens}")
    if ar_of is None and any(n != 1 + ar_steps for n in ar_tokens):
        raise AssertionError(f"AR produced {set(ar_tokens)} tokens, expected {1 + ar_steps}")
    for toks in pearl_toks + ar_toks:
        if not all(0 <= t < vocab for t in toks):
            raise AssertionError("token id outside the vocabulary")
    pair = label or "bf16 layer-share 3L/36L, hidden 1024, ffn 4096, 8x128 q heads, 2 kv heads, vocab 32768"
    out = {
        "config": f"{pair}, B=32, gamma=14, prompt 64, greedy, {profile} profile"
                  + (f", draft_noise {draft_noise}" if draft_noise else "") + quant_label(kv_quant, quant)
                  + (f", draft_sp = target_sp = {sp} on one card" if sp > 1 else ""),
        **({"env": env, "schedule": schedule} if env else {}),
        "pearl_rounds": steps, "pearl_tok_s": pearl_tps, "mat": mat, "pearl_s": pearl_t,
        "round_ms": pearl_t / steps * 1e3, "engine_build_s": build_s,
        "launches": launches, "launches_pearl_run": pearl_launches,
        "launches_per_pearl_round": {k: n / steps for k, n in pearl_launches.items() if n},
        "cuda_peak_memory_gib": peak / 2**30, "kv_pool_bytes_per_block": kv_bytes, **shards,
    }
    if ar_of is not None:
        out.update(ar_of=ar_of[0], ar_tok_s=ar_of[1], speedup=pearl_tps / ar_of[1])
        return out, launches
    ar_tps = sum(ar_tokens) / ar_t
    agree = [
        next((j for j, (x, y) in enumerate(zip(p, a)) if x != y), min(len(p), len(a)))
        for p, a in zip(pearl_toks, ar_toks)
    ]
    out.update({
        "ar_steps": ar_steps, "ar_tok_s": ar_tps, "speedup": pearl_tps / ar_tps, "ar_s": ar_t,
        "launches_ar_run": ar_launches,
        "launches_per_ar_step": {k: n / ar_steps for k, n in ar_launches.items() if n},
        "pearl_vs_ar_first_divergence_mean": float(np.mean(agree)),
        "pearl_vs_ar_identical_streams": sum(p == a for p, a in zip(pearl_toks, ar_toks)),
    })
    return out, launches


def main_path_phase(dev, steps: int = 145) -> tuple[dict, dict]:
    """The bench's default run (ceiling profile, noiseless pair) on the port,
    AR over the first sixth of the window. Its aligned heads (Hkv*D 256)
    take K1/K2, never the fallbacks. Returns its launches and its line."""
    gamma = 14
    out, launches = bench_run(dev, steps, "ceiling", 0.0, ar_cut=AR_CUT)
    emit({"phase": "main_path", **out})
    check_launches("main_path", launches, ("paged_decode", "paged_verify", "prefill_self"), tuple(FALLBACK_KERNELS))
    if out["mat"] != gamma:  # the layer-share ceiling: decode and verify round alike
        raise AssertionError(f"MAT {out['mat']} below the layer-share ceiling {gamma}")
    return launches, out


def check_launches(phase: str, launches: dict, ran: tuple, not_ran: tuple) -> None:
    if not all(launches[k] > 0 for k in ran) or any(launches[k] for k in not_ran):
        raise AssertionError(f"{phase} must launch {ran} and none of {not_ran}: {launches}")


def quant_path_phase(dev, bf16_block_bytes: float, steps: int = 145) -> dict:
    """``bench.py --kv-quant int8 --quant int8`` on the port: the main path's
    run over an int8 cache with int8 weights, decode through K9a and the
    packed verify through K9b; MAT must stay at the ceiling (the 1-byte
    rows are written and read alike by decode and verify). Prints the KV
    pools' bytes per block against the bf16 main path's. AR over the first
    sixth of the window (bench_run's ``ar_cut``)."""
    gamma = 14
    out, launches = bench_run(dev, steps, "ceiling", 0.0, kv_quant="int8", quant="int8", ar_cut=AR_CUT)
    out["kv_pool_bytes_per_block_vs_bf16"] = out["kv_pool_bytes_per_block"] / bf16_block_bytes
    emit({"phase": "quant_path", **out})
    check_launches("quant_path", launches, ("prefill_self", "paged_decode_q8", "paged_verify_q8"),
                   ("paged_decode", "paged_verify", "prefill_prefix", "mono_attention", "cache_partials",
                    "write_fresh", "mono_q8"))
    if out["mat"] != gamma:
        raise AssertionError(f"quant_path MAT {out['mat']} below the layer-share ceiling {gamma}")
    if out["kv_pool_bytes_per_block_vs_bf16"] > 0.55:
        raise AssertionError("the quantized KV pool does not take about half the bf16 pool's bytes")
    return launches


def quant_throughput_path_phase(dev, steps: int = 73, draft_noise: float = 0.005) -> dict:
    """``bench.py --draft-noise 0.005 --kv-quant fp8 --quant fp8`` on the
    port: the throughput profile over an fp8 cache with fp8 weights, decode
    and the classic write-then-read verify through K9c (the deferred verify
    is off over a quantized cache). MAT is printed, not asserted. AR over
    the first sixth of the window."""
    out, launches = bench_run(dev, steps, "throughput", draft_noise, kv_quant="fp8", quant="fp8",
                              ar_cut=AR_CUT)
    emit({"phase": "quant_throughput_path", **out})
    check_launches("quant_throughput_path", launches, ("prefill_self", "mono_q8"),
                   ("paged_decode", "paged_verify", "mono_attention", "cache_partials", "write_fresh",
                    "paged_decode_q8", "paged_verify_q8"))
    return launches


def throughput_path_phase(dev, steps: int = 145, draft_noise: float = 0.005) -> tuple[dict, dict]:
    """``bench.py --draft-noise 0.005`` on the port: the throughput profile
    (bench.py picks it for noisy drafts), decode through K5, the deferred
    verify through K7 and one K12 writeback per round, prefill through
    K3. Streams are not compared in bf16 (near-tied random logits fork).
    AR over the first sixth of the window. Returns its launches and its
    line."""
    out, launches = bench_run(dev, steps, "throughput", draft_noise, ar_cut=AR_CUT)
    emit({"phase": "throughput_path", **out})
    wanted = ("prefill_self", "mono_attention", "cache_partials", "write_fresh")
    if not all(launches[k] > 0 for k in wanted) or launches["paged_decode"] or launches["paged_verify"]:
        raise AssertionError(f"the throughput path must run K3, K5, K7 and K12 and not K1/K2: {launches}")
    return launches, out


OVERRIDE_PATHS = {
    # path: (profile, draft noise, variables, kernels that must run, kernels that must not)
    "split_path": ("ceiling", 0.0, {"NANO_PEARL_SPLIT": "1"},
                   ("prefill_self", "paged_decode_split", "paged_verify_fresh_split", "write_fresh"),
                   ("paged_verify", "paged_decode", "paged_verify_fresh", "cache_partials", "mono_fresh")),
    "deferred_db_path": ("ceiling", 0.0, {"NANO_PEARL_DEFERRED_VERIFY": "1"},
                         ("prefill_self", "paged_decode", "paged_verify_fresh", "write_fresh"),
                         ("paged_verify", "paged_decode_split", "paged_verify_fresh_split", "cache_partials")),
    "fresh_kernel_path": ("throughput", 0.005, {"NANO_PEARL_FRESH_MODE": "kernel"},
                          ("prefill_self", "mono_attention", "mono_fresh", "write_fresh"),
                          ("cache_partials", "paged_verify", "paged_decode", "paged_verify_fresh")),
}


def override_path_phase(dev, path: str, ar_of: tuple[str, float], steps: int = 73) -> dict:
    """The bench run of ``path`` (OVERRIDE_PATHS): the main path's pair and
    traffic with a schedule override set around the engine's construction
    only, 73 PEARL rounds, speedup against the AR of ``ar_of`` measured in
    this call (the split and deferred-db paths: the main path's, K1; the
    fresh-kernel path: the throughput path's, K5). Asserts which kernels ran
    and which did not, and on the split path MAT at the layer-share ceiling
    (K8b's rows equal K8a's, the decode padded as the main path's)."""
    profile, noise, env, ran, not_ran = OVERRIDE_PATHS[path]
    out, launches = bench_run(dev, steps, profile, noise, env=env, ar_of=ar_of)
    emit({"phase": path, **out})
    check_launches(path, launches, ran, not_ran)
    if path == "split_path" and out["mat"] != 14:
        raise AssertionError(f"split_path MAT {out['mat']} below the layer-share ceiling 14")
    return launches


def sp_path_phase(dev, kv_quant=None, quant=None, steps: int = 145) -> dict:
    """The main path's run with draft_sp = target_sp = 2 (PearlConfig; the
    two shards of each pool share the one card): decode through K11a, the
    classic packed verify through K11c, both merged over the shards,
    prefill K3 (K11b / K11d over ``kv_quant``, with ``quant`` weights:
    ``sp_quant_path``); MAT at the layer-share ceiling (K11c rows equal
    K11a's after the merge); AR over the first sixth of the window.
    Prints PEARL and AR tok/s, the pools' bytes per shard and the
    launches."""
    phase = "sp_quant_path" if kv_quant else "sp_path"
    out, launches = bench_run(dev, steps, "ceiling", 0.0, kv_quant=kv_quant, quant=quant, ar_cut=AR_CUT, sp=2)
    emit({"phase": phase, **out})
    check_launches(phase, launches, *sp_kernels(kv_quant))
    if out["mat"] != 14:
        raise AssertionError(f"{phase} MAT {out['mat']} below the layer-share ceiling 14")
    return launches


# ------------------------------------------------------------ checkpoints

HF_LAYER_NAMES = {  # pytree key -> (HF tensor name under model.layers.{i}, stored [out, in])
    "input_ln": ("input_layernorm.weight", False), "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True), "wv": ("self_attn.v_proj.weight", True),
    "bq": ("self_attn.q_proj.bias", False), "bk": ("self_attn.k_proj.bias", False),
    "bv": ("self_attn.v_proj.bias", False), "wo": ("self_attn.o_proj.weight", True),
    "q_norm": ("self_attn.q_norm.weight", False), "k_norm": ("self_attn.k_norm.weight", False),
    "post_ln": ("post_attention_layernorm.weight", False), "wgate": ("mlp.gate_proj.weight", True),
    "wup": ("mlp.up_proj.weight", True), "wdown": ("mlp.down_proj.weight", True),
}
ST_DTYPES = {torch.float32: "F32", torch.bfloat16: "BF16"}


def write_safetensors(path: str, tensors: dict) -> None:
    """``tensors`` (name -> f32 or bf16 CPU tensor) as one safetensors file:
    an 8-byte little-endian header length, the JSON header (dtype, shape,
    byte offsets per tensor; padded with spaces to 8 bytes), then the raw
    little-endian bytes. Written here: the card's host has no safetensors
    package."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": ST_DTYPES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for t in tensors.values():
            t = t.contiguous()
            f.write((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes())


def write_checkpoint(directory: str, cfg, tree: dict, dtype: torch.dtype) -> None:
    """An HF checkpoint directory of ``cfg``'s architecture: ``config.json``
    and ``model.safetensors`` holding ``tree`` (the JAX package's pytree of
    f32 numpy arrays, unpadded) under HF's tensor names and [out, in]
    layout, in ``dtype``; no lm_head where the embeddings are tied."""
    os.makedirs(directory, exist_ok=True)

    def conv(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)

    tensors = {"model.embed_tokens.weight": conv(tree["embed"]), "model.norm.weight": conv(tree["final_ln"])}
    if not cfg.tie_word_embeddings:
        tensors["lm_head.weight"] = conv(tree["lm_head"])
    for key, stacked in tree["layers"].items():
        name, transpose = HF_LAYER_NAMES[key]
        for i, a in enumerate(stacked):
            tensors[f"model.layers.{i}.{name}"] = conv(a.T if transpose else a)
    write_safetensors(os.path.join(directory, "model.safetensors"), tensors)
    config = {
        "architectures": [cfg.architecture], "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": cfg.num_attention_heads, "num_key_value_heads": cfg.num_key_value_heads,
        "head_dim": cfg.head_dim, "vocab_size": cfg.vocab_size, "rms_norm_eps": cfg.rms_norm_eps,
        "rope_theta": cfg.rope_theta, "max_position_embeddings": cfg.max_position_embeddings,
        "tie_word_embeddings": cfg.tie_word_embeddings, "eos_token_id": cfg.eos_token_id,
        "torch_dtype": str(dtype).removeprefix("torch."),
    }
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(config, f, indent=1)


TINY_ARCHS = {  # tests/test_model_parity.py's tiny HF models: hidden 64, 4 heads of 16, 2 KV heads
    "llama": dict(architecture="LlamaForCausalLM"),
    "llama_tied": dict(architecture="LlamaForCausalLM", tie_word_embeddings=True),
    "qwen2": dict(architecture="Qwen2ForCausalLM", qkv_bias=True),
    "qwen3": dict(architecture="Qwen3ForCausalLM", qk_norm=True),
}


def checkpoint_exactness_phase(dev, root: str) -> None:
    """The four tiny architectures of tests/test_model_parity.py (3 layers,
    hidden 64, 4 query heads of 16 over 2 KV heads: Hkv*D 32, vocab 211,
    f32) written as HF checkpoint directories with seeded random weights and
    loaded through ``PearlConfig(draft_model=dir, target_model=dir)``: the
    engine's weights must equal what was written, f32 PEARL == AR (B=4,
    gamma=4, 16-key blocks), and decode and verify must have run K10a and
    K10b and not K1/K2 (Hkv*D % 128 != 0); the llama once more over an int8
    cache, through K10c and K10d."""
    from nano_pearl_tpu_torch import ModelConfig, PearlConfig, PearlEngine
    from nano_pearl_tpu_torch.models.transformer import init_params_numpy

    counters = kernel_counters()
    batch, gamma, prompt_len, vocab = 4, 4, 64, 211
    max_tokens = 1 + 16 * gamma
    results = {}
    for case in (*TINY_ARCHS, "llama, int8 KV"):
        arch, kv_quant = case.split(",")[0], "int8" if "int8" in case else None
        mc = ModelConfig(hidden_size=64, intermediate_size=112, num_hidden_layers=3, num_attention_heads=4,
                         num_key_value_heads=2, head_dim=16, vocab_size=vocab, max_position_embeddings=512,
                         eos_token_id=2, dtype="float32", **TINY_ARCHS[arch])
        tree = init_params_numpy(mc, np.random.default_rng(3), scale=0.2)
        path = os.path.join(root, arch)
        if not os.path.isdir(path):
            write_checkpoint(path, mc, tree, torch.float32)
        cfg = PearlConfig(draft_model=path, target_model=path, max_model_len=256, kvcache_block_size=16,
                          num_kvcache_blocks=72, gamma=gamma, max_num_seqs=8, dtype="float32",
                          draft_kv_quant=kv_quant, target_kv_quant=kv_quant)
        engine = PearlEngine(cfg, device=dev)
        for runner in (engine.draft, engine.target):
            got = {k: v for k, v in runner.params.items() if k != "layers"} | runner.params["layers"]
            for k, want in ({k: v for k, v in tree.items() if k != "layers"} | tree["layers"]).items():
                if not torch.equal(got[k][tuple(slice(0, n) for n in want.shape)].cpu(), torch.from_numpy(want)):
                    raise AssertionError(f"checkpoint_exactness {case}: loaded {k} differs from what was written")
        before = {k: fn.launches for k, fn in counters.items()}
        add_requests(engine, np.random.default_rng(1), batch, prompt_len, max_tokens, vocab)
        pearl, n_pearl, acc, _ = engine.generate_token_ids()
        add_requests(engine, np.random.default_rng(1), batch, prompt_len, max_tokens, vocab)
        ar, _, _, _ = engine.AR_generate_token_ids()
        launches = {k: fn.launches - before[k] for k, fn in counters.items() if fn.launches - before[k]}
        if pearl != ar:
            raise AssertionError(f"checkpoint_exactness {case}: f32 PEARL != AR")
        q8 = "_q8" if kv_quant else ""
        check_launches(f"checkpoint_exactness {case}", {**dict.fromkeys(counters, 0), **launches},
                       ("prefill_self", f"paged_decode_fallback{q8}", f"paged_verify_fallback{q8}"),
                       ("paged_decode", "paged_verify", "paged_decode_q8", "paged_verify_q8", "mono_attention",
                        "mono_q8"))
        results[case] = {"pearl_equals_ar": True, "tokens": n_pearl, "accepted_tokens": [sum(a) for a in acc],
                         "launches": launches}
        del engine
    torch.cuda.empty_cache()
    emit({"phase": "checkpoint_exactness", "cases": results, "weights_equal_written": True,
          "config": "tiny HF-layout checkpoints (3L, hidden 64, ffn 112, 4x16 q heads, 2 kv heads, vocab 211, "
                    "f32, seeded random weights), draft = target directory, B=4, gamma=4, prompt 64, block 16"})


SMOLLM2_360M = dict(  # HuggingFaceTB/SmolLM2-360M config.json (public): llama architecture
    architecture="LlamaForCausalLM", hidden_size=960, intermediate_size=2560, num_attention_heads=15,
    num_key_value_heads=5, head_dim=64, vocab_size=49152, tie_word_embeddings=True, rope_theta=100000.0,
    rms_norm_eps=1e-5, max_position_embeddings=8192, eos_token_id=0, dtype="bfloat16",
)


def write_smollm2_pair(root: str) -> tuple[tuple[str, str], float]:
    """The layer-share pair at SmolLM2-360M's published widths (3-layer
    draft; 32-layer target, the published depth, whose 29 extra layers pass
    the residual through), seeded random weights, written as bf16 HF
    checkpoint directories; returns the directories and the seconds taken."""
    from nano_pearl_tpu_torch import ModelConfig
    from nano_pearl_tpu_torch.utils.layer_share import build_layer_share_pair

    t0 = time.perf_counter()
    md, mt = ModelConfig(num_hidden_layers=3, **SMOLLM2_360M), ModelConfig(num_hidden_layers=32, **SMOLLM2_360M)
    dp, tp = build_layer_share_pair(md, mt, seed=0)
    dirs = (os.path.join(root, "smollm2_draft_3l"), os.path.join(root, "smollm2_target_32l"))
    write_checkpoint(dirs[0], md, dp, torch.bfloat16)
    write_checkpoint(dirs[1], mt, tp, torch.bfloat16)
    return dirs, time.perf_counter() - t0


def checkpoint_path_phase(dev, dirs, write_s: float, kv_quant=None, steps: int = 145) -> dict:
    """The bench's run (B=32, gamma=14, prompt 64, greedy, ceiling) on the
    SmolLM2-360M-width checkpoint pair loaded from ``dirs`` through the
    engine's normal entry: Hkv*D = 320 sends decode to K10a and the verify
    to K10b (over an int8 cache, ``checkpoint_quant_path``: K10c / K10d),
    prefill to K3; K1/K2 (K9a/K9b) must not run. MAT must stay at the
    layer-share ceiling (K10b rows == K10a's). 145 rounds, AR over the first
    sixth of the window."""
    phase = "checkpoint_quant_path" if kv_quant else "checkpoint_path"
    label = ("bf16 SmolLM2-360M-width layer-share pair from HF checkpoint directories (3L/32L, hidden 960, "
             "ffn 2560, 15x64 q heads, 5 kv heads, vocab 49152, tied, seeded random weights)")
    out, launches = bench_run(dev, steps, "ceiling", 0.0, kv_quant=kv_quant, ar_cut=AR_CUT, dirs=dirs,
                              vocab=SMOLLM2_360M["vocab_size"],
                              label=label)
    emit({"phase": phase, "checkpoint_write_s": write_s, **out})
    q8 = "_q8" if kv_quant else ""
    other = "" if kv_quant else "_q8"
    check_launches(phase, launches, ("prefill_self", f"paged_decode_fallback{q8}", f"paged_verify_fallback{q8}"),
                   ("paged_decode", "paged_verify", "paged_decode_q8", "paged_verify_q8", "mono_attention",
                    "mono_q8", f"paged_decode_fallback{other}", f"paged_verify_fallback{other}"))
    if out["mat"] != 14:
        raise AssertionError(f"{phase} MAT {out['mat']} below the layer-share ceiling 14")
    return launches


def kernel_counters() -> dict:
    from nano_pearl_tpu_torch.ops.cuda import kv_writeback as kkw
    from nano_pearl_tpu_torch.ops.cuda import mono_attention as kmo
    from nano_pearl_tpu_torch.ops.cuda import paged_attention as kpa
    from nano_pearl_tpu_torch.ops.cuda import paged_attention_fallback as kfb
    from nano_pearl_tpu_torch.ops.cuda import paged_attention_partials as kpp
    from nano_pearl_tpu_torch.ops.cuda import prefill_attention as kpf

    return {"paged_decode": kpa.paged_decode, "paged_verify": kpa.paged_verify,
            "prefill_self": kpf.prefill_self, "prefill_prefix": kpf.prefill_prefix,
            "mono_attention": kmo.mono_attention, "cache_partials": kmo.cache_partials,
            "write_fresh": kkw.write_fresh_kernel, "paged_decode_q8": kpa.paged_decode_q8,
            "paged_verify_q8": kpa.paged_verify_q8, "mono_q8": kmo.mono_q8, **override_kernel_fns(),
            **{name: getattr(kfb, name) for name in FALLBACK_KERNELS},
            **{name: getattr(kpp, name) for name in PARTIALS_KERNELS}}


def serve_args(*extra: str):
    """The port's server's arguments for the layer-share serve pair."""
    from nano_pearl_tpu_torch import serve

    return serve.parse_args(["--layer-share", "--gamma", "8", "--fused-rounds", "4", *extra])


def serving_exactness_phase(dev) -> None:
    """f32 cut of the serve pair (2L/6L, 16x64 heads, full width) served
    through serve_step: 8 requests in two waves, half behind one shared
    512-token prefix, and one 1,500-token prompt under a 512-token prefill
    budget (chunked passes). Every served completion must equal the AR
    output of the same prompt; K4 must have run and the prefix cache hit."""
    import dataclasses

    from nano_pearl_tpu_torch import PearlConfig, PearlEngine, SamplingParams, serve
    from nano_pearl_tpu_torch.utils.layer_share import build_layer_share_pair

    args = serve_args("--draft-layers", "2", "--target-layers", "6")
    md, mt = (dataclasses.replace(m, dtype="float32") for m in serve.layer_share_models(args))
    dp, tp = build_layer_share_pair(md, mt, seed=0)
    cfg = PearlConfig(
        draft_model=md, target_model=mt, max_model_len=args.max_model_len, gamma=args.gamma,
        max_num_batched_tokens=512, num_kvcache_blocks=96, max_num_seqs=32, dtype="float32",
    )
    engine = PearlEngine(cfg, dp, tp, device=dev)
    rng = np.random.default_rng(5)
    system = rng.integers(2, 32767, 512).tolist()
    prompts = [(system if i % 2 == 0 else []) + rng.integers(2, 32767, 64).tolist() for i in range(8)]
    prompts.append(rng.integers(2, 32767, 1500).tolist())
    params = SamplingParams(temperature=0.0, max_tokens=32, ignore_eos=True)
    k4 = kernel_counters()["prefill_prefix"]
    k4_before = k4.launches
    ids, served = [], {}
    for wave in (prompts[:4], prompts[4:]):
        ids += [engine.submit(p, params) for p in wave]
        for _ in range(2):  # the second wave joins a running batch
            served.update({sid: toks for sid, toks, _ in engine.serve_step(4)})
    while engine.has_work:
        served.update({sid: toks for sid, toks, _ in engine.serve_step(4)})
    stats = engine.stats()
    k4_launches = k4.launches - k4_before
    for p in prompts:
        engine.add_request(p, params)
    ar, _, _, _ = engine.AR_generate_token_ids()
    # PEARL commits whole windows, so its last one may run up to gamma - 1
    # tokens past max_tokens (as in the JAX package); AR stops at max_tokens
    bad = [i for i, sid in enumerate(ids)
           if len(ar[i]) != params.max_tokens or served[sid][: len(ar[i])] != ar[i]]
    if bad:
        raise AssertionError(f"served != AR for requests {bad}")
    if not (k4_launches > 0 and stats["prefix_hit_tokens"] > 0 and stats["chunked_prefill_passes"] > 0):
        raise AssertionError(f"K4 {k4_launches}, stats {stats}: no prefix hit or chunked pass")
    emit({"phase": "serving_exactness", "served_equals_ar": True, "requests": len(ids),
          "tokens_each": 32, "prefill_prefix_launches": k4_launches,
          "prefix_hit_tokens": stats["prefix_hit_tokens"],
          "chunked_prefill_passes": stats["chunked_prefill_passes"],
          "config": "f32 serve pair 2L/6L, 16x64 q heads, 2 kv heads, gamma=8, "
                    "max_num_batched_tokens=512, two waves through serve_step"})
    del engine
    torch.cuda.empty_cache()


def _post(port: int, path: str, payload: dict, timeout: float = 600):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    return urllib.request.urlopen(req, timeout=timeout)


def serving_phase(dev) -> dict:
    """The bf16 3L/36L serve pair behind the port's HTTP server on
    127.0.0.1, in this process, with bench_serve.py's traffic: 64 requests
    of 64 own tokens arriving as a seeded Poisson process at 8 req/s, half
    behind one shared 512-token system prefix, max_tokens 128, gamma 8, 4
    fused rounds, max_num_seqs 32; 4 of them stream; one more request is
    cancelled mid-flight and one 3,000-token prompt runs as chunked passes
    under max_num_batched_tokens=2048. Both KV pools are sized from the
    card's free memory (num_kvcache_blocks=-1). Returns the launch counts."""
    import gc
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from nano_pearl_tpu_torch import serve

    gc.collect()
    torch.cuda.empty_cache()
    args = serve_args()
    t0 = time.perf_counter()
    engine = serve.build_engine(args, max_num_seqs=32, max_num_batched_tokens=2048)
    engine.warmup(batches=(1, 8, 32))
    build_s = time.perf_counter() - t0
    if engine.draft.num_blocks != engine.target.num_blocks:
        raise AssertionError("the two KV pools of a shared card must hold equal block counts")
    free0 = (engine.scheduler.draft_bm.num_free_blocks, engine.scheduler.target_bm.num_free_blocks)
    server = serve.PearlServer(engine, fused_rounds=args.fused_rounds)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(server))
    port = httpd.server_address[1]
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()

    rng = np.random.default_rng(0)
    system = rng.integers(2, 32767, 512).tolist()
    n_req = 64
    prompts = [(system if i % 2 else []) + rng.integers(2, 32767, 64).tolist() for i in range(n_req)]
    arrivals = np.cumsum(rng.exponential(1.0 / 8.0, n_req))
    streaming = {3, 17, 31, 45}
    long_prompt = rng.integers(2, 32767, 3000).tolist()
    results, streams, errors = {}, {}, []

    def request(i, prompt, start):
        time.sleep(max(0.0, start - (time.perf_counter() - t_traffic)))
        body = {"prompt": prompt, "max_tokens": 128, "temperature": 0.0, "ignore_eos": True}
        try:
            if i in streaming:
                chunks, final = [], None
                with _post(port, "/generate", {**body, "stream": True}) as r:
                    for raw in r:
                        rec = json.loads(raw)
                        if rec.get("done"):
                            final = rec
                        elif "token_ids" in rec:
                            chunks += rec["token_ids"]
                streams[i] = chunks
                results[i] = final
            else:
                with _post(port, "/generate", body) as r:
                    results[i] = json.loads(r.read())
        except Exception as e:  # reported by the assertion below
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t_traffic = time.perf_counter()
    threads = [threading.Thread(target=request, args=(i, p, a)) for i, (p, a) in
               enumerate(zip(prompts, arrivals))]
    threads.append(threading.Thread(target=request, args=("long", long_prompt, 1.0)))
    for t in threads:
        t.start()
    # one request cancelled mid-flight
    with _post(port, "/generate", {"prompt": prompts[0][:32], "max_tokens": 2048, "temperature": 0.0,
                                    "ignore_eos": True, "blocking": False}) as r:
        rid = json.loads(r.read())["request_id"]
    time.sleep(2.0)
    with _post(port, "/cancel", {"request_id": rid}) as r:
        cancelled = json.loads(r.read())["cancelled"]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/result?request_id={rid}", timeout=60) as r:
        cancel_result = json.loads(r.read())
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t_traffic
    launches = {k: fn.launches for k, fn in counters.items()}
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=60) as r:
        health = json.loads(r.read())
    httpd.shutdown()
    httpd.server_close()
    server.stop()
    http_thread.join(timeout=30)

    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"requests failed or hung: {errors[:5]}")
    if not (cancelled and cancel_result.get("cancelled")):
        raise AssertionError(f"the mid-flight cancel failed: {cancelled}, {cancel_result}")
    # PEARL's finish test counts the window not verified yet: its last
    # window may commit up to gamma - 1 tokens past max_tokens, or, after a
    # late rejection, stop up to gamma - 1 short of it (as the JAX package)
    g = args.gamma
    answered = [r for r in results.values() if r and 128 - g < r.get("num_tokens", 0) < 128 + g]
    if len(answered) != n_req + 1:
        got = sorted(r.get("num_tokens") if r else None for r in results.values())
        raise AssertionError(f"{len(answered)} of {n_req + 1} requests answered in full: {got}")
    for i, chunks in streams.items():
        if chunks != results[i]["token_ids"]:
            raise AssertionError(f"stream {i}: chunks do not concatenate to the final tokens")
    free1 = (health["draft_free_blocks"], health["target_free_blocks"])
    if free1 != free0:
        raise AssertionError(f"free KV blocks {free1} after serving, {free0} before")
    if not (launches["prefill_prefix"] > 0 and health["chunked_prefill_passes"] > 0):
        raise AssertionError(f"no K4 launch or no chunked pass: {launches}, {health}")
    tokens = sum(r["num_tokens"] for r in answered)
    out = {
        "phase": "serving",
        "config": "bf16 serve pair 3L/36L, hidden 1024, ffn 4096, 16x64 q heads, 2 kv heads, "
                  "vocab 32768, gamma 8, 4 fused rounds, ceiling profile, greedy; settings beside "
                  "serve.py's defaults: max_num_seqs 32, max_num_batched_tokens 2048",
        "traffic": "64 requests x (64 own tokens, half behind one 512-token prefix), Poisson 8 req/s "
                   "(seed 0), max_tokens 128, 4 streaming, 1 cancelled, 1 x 3000-token prompt",
        "completed_requests": len(answered), "committed_tokens": tokens, "wall_s": wall,
        # a request whose every round accepted has one accepted-token emit
        # (mat ~ its length); a rejection splits it into several
        "requests_with_a_rejection": sorted(
            (str(i) for i, r in results.items() if r and r["mat"] < 64),
        ),
        "committed_tok_s": tokens / wall,
        **{k: health.get(k) for k in ("mat", "ttft_p50_s", "ttft_p95_s", "tpot_p50_s", "tpot_p95_s",
                                      "e2e_p50_s", "e2e_p95_s", "prefix_hit_tokens",
                                      "chunked_prefill_passes")},
        "prefill_prefix_launches": launches["prefill_prefix"], "launches": launches,
        "kv_blocks_each_pool": engine.target.num_blocks, "engine_build_and_warmup_s": build_s,
        "cancelled_mid_flight": True, "streams_concatenate": True, "free_blocks_restored": True,
    }
    emit(out)
    if health["mat"] != args.gamma:  # after the line above, which names the requests
        raise AssertionError(f"serving MAT {health['mat']} below the layer-share ceiling {args.gamma}")
    del server, engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from nano_pearl_tpu_torch.ops.cuda import build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 GEMMs in full f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0)})

    t0 = time.perf_counter()
    logs = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {src: ptxas_by_kernel(log) for src, log in logs.items()}})

    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB > L2
    kernels = kernel_phase(dev, flush)
    del flush
    prefill_bitwise_phase(dev)
    split_bitwise_phase(dev)
    decode_verify_bitwise_phase(dev)
    decode_verify_overrides_phase(dev)
    decode_verify_throughput_phase(dev)
    exactness_phase(dev)
    throughput_exactness_phase(dev)
    exactness_phase(dev, kv_quant="int8", quant="int8", phase="quant_exactness")
    sp_bitwise_phase(dev)
    sp_exactness_phase(dev)
    sp_exactness_phase(dev, kv_quant="int8", quant="int8")
    throughput_exactness_phase(dev, kv_quant="fp8", quant="fp8", phase="quant_exactness")
    exactness_phase(dev, phase="split_exactness", env=OVERRIDE_PATHS["split_path"][2],
                    ran=("paged_decode_split", "paged_verify_fresh_split"))
    exactness_phase(dev, phase="deferred_db_exactness", env=OVERRIDE_PATHS["deferred_db_path"][2],
                    ran=("paged_verify_fresh",))
    throughput_exactness_phase(dev, phase="fresh_kernel_exactness", env=OVERRIDE_PATHS["fresh_kernel_path"][2],
                               ran=("mono_fresh",))
    checkpoints = tempfile.TemporaryDirectory(prefix="chip_smoke_checkpoints_")
    checkpoint_exactness_phase(dev, checkpoints.name)
    by_path = {}
    by_path["main_path"], main = main_path_phase(dev)
    by_path["throughput_path"], thr = throughput_path_phase(dev)
    by_path["quant_path"] = quant_path_phase(dev, main["kv_pool_bytes_per_block"])
    by_path["quant_throughput_path"] = quant_throughput_path_phase(dev)
    for path, ar_of in (("split_path", ("main_path", main)), ("deferred_db_path", ("main_path", main)),
                        ("fresh_kernel_path", ("throughput_path", thr))):
        by_path[path] = override_path_phase(dev, path, (ar_of[0], ar_of[1]["ar_tok_s"]))
    dirs, write_s = write_smollm2_pair(checkpoints.name)
    by_path["checkpoint_path"] = checkpoint_path_phase(dev, dirs, write_s)
    by_path["checkpoint_quant_path"] = checkpoint_path_phase(dev, dirs, write_s, kv_quant="int8")
    checkpoints.cleanup()
    by_path["sp_path"] = sp_path_phase(dev)
    by_path["sp_quant_path"] = sp_path_phase(dev, kv_quant="int8", quant="int8", steps=73)
    serving_exactness_phase(dev)
    by_path["serving"] = serving_phase(dev)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    shape_keys = ("name", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "no_spin",
                  "share", "blocks")
    line = []
    for name in kernel_counters():  # one row per kernel; its other shapes beside it
        first, *others = [r for r in kernels if r["kernel"] == name]
        first["launches_by_path"] = {path: n[name] for path, n in by_path.items()}
        first["launches"] = sum(first["launches_by_path"].values())
        line.append({**{k: first[k] for k in keys},
                     **{k: first[k] for k in ("no_spin", "share", "design", "blocks") if k in first},
                     "other_shapes": [{k: r[k] for k in shape_keys if k in r} for r in others]})
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
