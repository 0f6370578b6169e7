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
   at the main path's shapes against their plain PyTorch versions (bf16,
   within one rounding of the output to bf16: rtol 8e-3, atol 1e-3),
   K2's rows against K1 bit for bit, and kernel / plain / library
   (scaled_dot_product_attention, a yardstick the port never calls)
   times from CUDA events with the L2 cache flushed before each launch;
4. exactness: an f32 layer-share pair (2L/6L, B=4, gamma=4) at full width
   must give PEARL tokens == AR tokens;
5. main path: the bench's bf16 3L/36L layer-share pair (hidden 1024, ffn
   4096, 8x128 query heads, 2 KV heads, vocab 32768), B=32, gamma=14,
   prompt 64, greedy: 145 PEARL rounds, then AR over the same window,
   with every launch counter set to 0 just before and read just after.

Then one {"kernels": [...]} line, the nvidia-smi line, and the last
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
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


def time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each timed with
    CUDA events after writing ``flush`` (larger than the 50 MB L2)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# ------------------------------------------------------------------ kernels


def paged_inputs(gen, dev, n_tables, rows, ctx0, nl=3, nb=520, bs=256, hq=8, hkv=2, d=128, m=16):
    """A cache of the draft's shape, distinct pages per sequence as the
    block manager hands them out, garbage-block padding of the tables,
    and per-row contexts (staircase when rows > 1)."""
    cache = torch.randn((nl, 2, nb + 1, bs, hkv * d), generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((n_tables * rows, hq, d), generator=gen, device=dev).to(torch.bfloat16)
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
    """[T, Hkv, S, D] K and V of each block-table row, for the yardstick."""
    from nano_pearl_tpu_torch.ops.attention import _gather_kv

    k, v = _gather_kv(cache, layer, bt, d)
    return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()


def kernel_phase(dev, flush) -> dict:
    import torch.nn.functional as F

    from nano_pearl_tpu_torch.ops.cuda import paged_attention as kpa
    from nano_pearl_tpu_torch.ops.cuda import prefill_attention as kpf

    gen = torch.Generator(dev).manual_seed(0)
    hq, hkv, d, layer = 8, 2, 128, 1
    results = {}

    # K1: B=32 decode rows, contexts spread over 65..2300
    ctx0 = np.random.default_rng(0).permutation(np.linspace(65, 2300, 32).astype(int))
    q, cache, bt, ctx, scale = paged_inputs(gen, dev, 32, 1, ctx0)
    args = (q, cache, layer, bt, ctx, scale)
    got, want = kpa.paged_decode(*args), kpa.plain_decode(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    k, v = gathered(cache, layer, bt, hkv, d)
    k, v = k.repeat_interleave(hq // hkv, 1), v.repeat_interleave(hq // hkv, 1)
    mask = (torch.arange(k.shape[2], device=dev)[None, :] < ctx[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask, scale=scale)  # noqa: E731
    torch.testing.assert_close(lib()[:, :, 0].float(), want.float(), **LIB_TOL)
    sum_ctx = float(ctx.sum())
    nbytes = 2 * q.numel() * 2 + bt.numel() * 4 + ctx.numel() * 4 + sum_ctx * 2 * hkv * d * 2
    b_ms, b_by = bound(nbytes, 4 * sum_ctx * hq * d)
    results["paged_decode"] = dict(
        name="paged_decode", route="cuda", source="nano_pearl_tpu_torch/csrc/paged_attention.cu",
        replaces="nano_pearl_tpu/ops/pallas/paged_attention.py:389",
        max_abs_err=err, ms=time_ms(lambda: kpa.paged_decode(*args), 50, flush),
        plain_ms=time_ms(lambda: kpa.plain_decode(*args), 10, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib, 50, flush),
        shape=dict(rows=32, hq=hq, hkv=hkv, d=d, block=256, ctx_min=int(ctx.min()), ctx_max=int(ctx.max())),
    )

    # K2: one verify chunk, 16 groups x 14 staircase rows
    rows = 14
    ctx0 = np.random.default_rng(1).permutation(np.linspace(65, 2300, 16).astype(int))
    q, cache, bt, ctx, scale = paged_inputs(gen, dev, 16, rows, ctx0)
    args = (q, cache, layer, bt, ctx, scale, rows)
    got, want = kpa.paged_verify(*args), kpa.plain_verify(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    single = kpa.paged_decode(q, cache, layer, bt.repeat_interleave(rows, 0).contiguous(), ctx, scale)
    if not torch.equal(single, got):
        raise AssertionError("K2 rows differ from K1 on the same query and context")
    k, v = gathered(cache, layer, bt, hkv, d)
    k, v = k.repeat_interleave(hq // hkv, 1), v.repeat_interleave(hq // hkv, 1)
    qg = q.reshape(16, rows, hq, d).transpose(1, 2)
    cr = ctx.reshape(16, rows)
    mask = (torch.arange(k.shape[2], device=dev)[None, None, :] < cr[:, :, None])[:, None]
    lib = lambda: F.scaled_dot_product_attention(qg, k, v, attn_mask=mask, scale=scale)  # noqa: E731
    torch.testing.assert_close(lib().transpose(1, 2).reshape(-1, hq, d).float(), want.float(), **LIB_TOL)
    kv_tokens = float(cr.max(dim=1).values.sum())
    nbytes = 2 * q.numel() * 2 + bt.numel() * 4 + ctx.numel() * 4 + kv_tokens * 2 * hkv * d * 2
    b_ms, b_by = bound(nbytes, 4 * float(ctx.sum()) * hq * d)
    results["paged_verify"] = dict(
        name="paged_verify", route="cuda", source="nano_pearl_tpu_torch/csrc/paged_attention.cu",
        replaces="nano_pearl_tpu/ops/pallas/paged_attention.py:510",
        max_abs_err=err, ms=time_ms(lambda: kpa.paged_verify(*args), 50, flush),
        plain_ms=time_ms(lambda: kpa.plain_verify(*args), 10, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib, 50, flush),
        k2_row_equals_k1=True,
        shape=dict(groups=16, rows=rows, hq=hq, hkv=hkv, d=d, ctx_min=int(ctx.min()), ctx_max=int(ctx.max())),
    )

    # K3: the prefill of B=32 prompts of 64 tokens in the 128-row bucket
    b, lq, n = 32, 128, 64
    q = torch.randn((b * lq, hq, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b * lq, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b * lq, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.full((b, lq), -1, dtype=torch.int32, device=dev)
    pos[:, :n] = torch.arange(n, dtype=torch.int32, device=dev)
    args = (q, k, v, pos, d**-0.5)
    got, want = kpf.prefill_self(*args), kpf.plain_prefill(*args)
    torch.cuda.synchronize()
    real = (pos >= 0).reshape(-1)
    err = (got[real].float() - want[real].float()).abs().max().item()
    torch.testing.assert_close(got[real].float(), want[real].float(), **TOL)
    if not bool((got[~real] == 0).all()):
        raise AssertionError("K3: fully masked rows must give 0")
    qs = q.reshape(b, lq, hq, d).transpose(1, 2)
    ks = k.reshape(b, lq, hkv, d).transpose(1, 2).repeat_interleave(hq // hkv, 1)
    vs = v.reshape(b, lq, hkv, d).transpose(1, 2).repeat_interleave(hq // hkv, 1)
    lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, scale=d**-0.5)  # noqa: E731
    lib_out = lib().transpose(1, 2).reshape(b * lq, hq, d)
    torch.testing.assert_close(lib_out[real].float(), want[real].float(), **LIB_TOL)
    nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2 + pos.numel() * 4
    b_ms, b_by = bound(nbytes, 4.0 * hq * d * b * n * (n + 1) / 2)
    results["prefill_self"] = dict(
        name="prefill_self", route="cuda", source="nano_pearl_tpu_torch/csrc/prefill_attention.cu",
        replaces="nano_pearl_tpu/ops/pallas/prefill_attention.py:43",
        max_abs_err=err, ms=time_ms(lambda: kpf.prefill_self(*args), 50, flush),
        plain_ms=time_ms(lambda: kpf.plain_prefill(*args), 10, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib, 50, flush),
        shape=dict(batch=b, rows=lq, real_rows=n, hq=hq, hkv=hkv, d=d),
    )
    for r in results.values():
        emit({"phase": "kernel", **r})
    return results


# ------------------------------------------------------------- engine runs


def model_config(layers: int, dtype: str):
    from nano_pearl_tpu_torch import ModelConfig

    return ModelConfig(
        architecture="LlamaForCausalLM", hidden_size=1024, intermediate_size=4096,
        num_hidden_layers=layers, num_attention_heads=8, num_key_value_heads=2,
        vocab_size=32768, eos_token_id=1, dtype=dtype, max_position_embeddings=2048,
    )


def pair_engine(ld, lt, dtype, batch, gamma, steps, prompt_len, dev):
    """The bench's engine set-up (bench.py run()) on the port."""
    from nano_pearl_tpu_torch import PearlConfig, PearlEngine
    from nano_pearl_tpu_torch.utils.layer_share import build_layer_share_pair

    md, mt = model_config(ld, dtype), model_config(lt, dtype)
    dp, tp = build_layer_share_pair(md, mt, seed=0)
    max_len = max(256, 1 << (prompt_len + steps * (gamma + 1) + 64).bit_length())
    cfg = PearlConfig(
        draft_model=md, target_model=mt, max_model_len=max_len,
        max_num_batched_tokens=max(16384, batch * prompt_len), kvcache_block_size=256,
        num_kvcache_blocks=batch * (max_len // 256) + 8, gamma=gamma,
        max_num_seqs=max(batch, 8), seed=0, dtype=dtype,
    )
    return PearlEngine(cfg, dp, tp, device=dev)


def add_requests(engine, rng, batch, prompt_len, max_tokens):
    from nano_pearl_tpu_torch import SamplingParams

    for _ in range(batch):
        prompt = rng.integers(2, 32768 - 1, prompt_len).tolist()
        engine.add_request(prompt, SamplingParams(temperature=0.0, max_tokens=max_tokens, ignore_eos=True))


def exactness_phase(dev) -> None:
    """f32 layer-share pair: the PEARL stream must equal the AR stream."""
    batch, gamma, prompt_len = 4, 4, 64
    max_tokens = 1 + 16 * gamma  # a whole number of accepted windows
    engine = pair_engine(2, 6, "float32", batch, gamma, 16, prompt_len, dev)
    add_requests(engine, np.random.default_rng(1), batch, prompt_len, max_tokens)
    pearl, n_pearl, acc, _ = engine.generate_token_ids()
    add_requests(engine, np.random.default_rng(1), batch, prompt_len, max_tokens)
    ar, n_ar, _, _ = engine.AR_generate_token_ids()
    if pearl != ar:
        first = next(
            (i, j) for i, (p, a) in enumerate(zip(pearl, ar))
            for j in range(min(len(p), len(a)) + 1) if p[:j + 1] != a[:j + 1]
        )
        raise AssertionError(f"f32 PEARL != AR: first divergence (request, token) {first}")
    emit({"phase": "exactness", "pearl_equals_ar": True, "tokens": n_pearl,
          "accepted_tokens": [sum(a) for a in acc],
          "config": "f32 layer-share 2L/6L full width, B=4, gamma=4"})
    del engine
    torch.cuda.empty_cache()


def main_path_phase(dev, steps: int = 145) -> dict:
    from nano_pearl_tpu_torch.ops.cuda import paged_attention as kpa
    from nano_pearl_tpu_torch.ops.cuda import prefill_attention as kpf

    counters = {"paged_decode": kpa.paged_decode, "paged_verify": kpa.paged_verify,
                "prefill_self": kpf.prefill_self}
    batch, gamma, prompt_len = 32, 14, 64
    ar_max_tokens = steps * (gamma + 1)
    ar_steps = ar_max_tokens - 1  # prefill commits one token per sequence
    t0 = time.perf_counter()
    engine = pair_engine(3, 36, "bfloat16", batch, gamma, steps, prompt_len, dev)
    build_s = time.perf_counter() - t0
    # warm-up, as bench.py does (cuBLAS handles, allocator), not measured
    add_requests(engine, np.random.default_rng(0), batch, prompt_len, ar_max_tokens)
    engine.bench_generate(num_pearl_steps=2, reserve_steps=steps)
    add_requests(engine, np.random.default_rng(0), batch, prompt_len, ar_max_tokens)
    engine.AR_bench_generate(num_steps=4, reserve_steps=ar_steps)

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    # both runs decode the same prompts, so their streams can be compared
    add_requests(engine, np.random.default_rng(1), batch, prompt_len, ar_max_tokens)
    pearl_toks, num_tokens, _, pearl_t = engine.bench_generate(num_pearl_steps=steps)
    pearl_launches = {k: fn.launches for k, fn in counters.items()}
    add_requests(engine, np.random.default_rng(1), batch, prompt_len, ar_max_tokens)
    ar_toks, ar_tokens, _, ar_t = engine.AR_bench_generate(num_steps=ar_steps)
    launches = {k: fn.launches for k, fn in counters.items()}
    ar_launches = {k: launches[k] - pearl_launches[k] for k in counters}
    peak = torch.cuda.max_memory_allocated(dev)

    pearl_tps = sum(num_tokens) / pearl_t
    ar_tps = sum(ar_tokens) / ar_t
    mat = float(np.mean([(n - 1) / steps for n in num_tokens]))  # bench.py's MAT
    if any(n < 1 + steps for n in num_tokens):
        raise AssertionError(f"a PEARL round committed no token: {num_tokens}")
    if any(n != ar_max_tokens for n in ar_tokens):
        raise AssertionError(f"AR produced {set(ar_tokens)} tokens, expected {ar_max_tokens}")
    for toks in pearl_toks + ar_toks:
        if not all(0 <= t < 32768 for t in toks):
            raise AssertionError("token id outside the vocabulary")
    agree = [
        next((j for j, (x, y) in enumerate(zip(p, a)) if x != y), min(len(p), len(a)))
        for p, a in zip(pearl_toks, ar_toks)
    ]
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the main path was never launched: {launches}")
    if not mat > 1:
        raise AssertionError(f"MAT {mat} <= 1")
    out = {
        "phase": "main_path",
        "config": "bf16 layer-share 3L/36L, hidden 1024, ffn 4096, 8x128 q heads, 2 kv heads, "
                  "vocab 32768, B=32, gamma=14, prompt 64, greedy, ceiling profile",
        "pearl_rounds": steps, "ar_steps": ar_steps,
        "pearl_tok_s": pearl_tps, "ar_tok_s": ar_tps, "speedup": pearl_tps / ar_tps, "mat": mat,
        "pearl_s": pearl_t, "ar_s": ar_t, "engine_build_s": build_s,
        "launches": launches, "launches_pearl_run": pearl_launches, "launches_ar_run": ar_launches,
        "paged_decode_per_pearl_round": pearl_launches["paged_decode"] / steps,
        "paged_verify_per_pearl_round": pearl_launches["paged_verify"] / steps,
        "paged_decode_per_ar_step": ar_launches["paged_decode"] / ar_steps,
        "pearl_vs_ar_first_divergence_mean": float(np.mean(agree)),
        "pearl_vs_ar_identical_streams": sum(p == a for p, a in zip(pearl_toks, ar_toks)),
        "cuda_peak_memory_gib": peak / 2**30,
    }
    emit(out)
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
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines() if "registers" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})

    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB > L2
    kernels = kernel_phase(dev, flush)
    del flush
    exactness_phase(dev)
    launches = main_path_phase(dev)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    for name, r in kernels.items():
        r["launches"] = launches[name]
    emit({"kernels": [{k: r[k] for k in keys} for r in kernels.values()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
