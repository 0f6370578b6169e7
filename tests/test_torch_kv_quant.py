"""The port's int8/fp8 KV cache against the JAX package's on the CPU:
``write_kv`` bit for bit (values, and scales against JAX's strided scale
columns ``h * stride``), the plain versions of kernels K9a (decode), K9b
(packed verify) and K9c (mono schedule) and the quantized prefix prefill
against JAX's jnp path, and engine runs: PEARL == AR under both profiles
(the token streams against the JAX engine's: test_torch_kv_quant_streams.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nano_pearl_tpu.ops import attention as jatt
from nano_pearl_tpu.ops import kv_cache as jkv
from nano_pearl_tpu_torch import ModelConfig, PearlConfig, PearlEngine, SamplingParams
from nano_pearl_tpu_torch.ops import attention as tatt
from nano_pearl_tpu_torch.ops import kv_cache as tkv
from nano_pearl_tpu_torch.ops.cuda import mono_attention as kmo
from nano_pearl_tpu_torch.ops.cuda import paged_attention as kpa
from nano_pearl_tpu_torch.utils.layer_share import build_layer_share_pair

NL, NB, BS, HKV, D = 2, 6, 16, 2, 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these tiny ops: under the suite's parallel
    workers torch's spinning thread pool oversubscribes the host and an
    engine run takes minutes instead of seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_np(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def _to_port(jc) -> tkv.QuantKVCache:
    """JAX's quantized cache as the port's: the 1-byte values as they are,
    the strided scales ``s[..., ::stride]`` (one column per KV head)."""
    q = np.asarray(jc["q"])
    qt = torch.from_numpy(q.view(np.uint8).copy()).view(
        torch.int8 if q.dtype == np.int8 else torch.float8_e4m3fn
    )
    stride = jc["s"].shape[-1] // HKV
    s = np.asarray(jc["s"])[..., ::stride]
    return tkv.QuantKVCache(qt, torch.from_numpy(s.view(np.int16).copy()).view(torch.bfloat16))


def _rows(rng, n, dtype=np.float32):
    """K/V rows of mixed scale, one all zero (scale max(0, 1e-8) / qmax)."""
    k = rng.standard_normal((n, HKV, D)).astype(np.float32) * rng.uniform(0.1, 4, (n, HKV, 1))
    v = rng.standard_normal((n, HKV, D)).astype(np.float32)
    k[1] = 0.0
    return k.astype(dtype), v.astype(dtype)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_write_kv_matches_jax_bitwise(kind, dtype):
    """Rows of both layers, real slots and distinct garbage-block slots:
    the 1-byte values and the bf16 scales equal JAX's bit for bit (the
    scale is rounded to bf16 before the values are quantized with it)."""
    rng = np.random.default_rng(0)
    jc = jkv.make_kv_cache(NL, NB, BS, HKV, D, quant=kind)
    tc = tkv.make_kv_cache(NL, NB, BS, HKV, D, quant=kind)
    assert tc.s.shape == (NL, 2, NB + 1, BS, HKV) and tc.s.dtype == torch.bfloat16
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    for li in range(NL):
        k, v = _rows(rng, 12)
        slots = np.concatenate([rng.permutation(NB * BS)[:10], NB * BS + np.arange(2)]).astype(np.int32)
        jc = jkv.write_kv(jc, jnp.asarray(k, jdt), jnp.asarray(v, jdt), jnp.asarray(slots), li)
        out = tkv.write_kv(tc, torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt),
                           torch.from_numpy(slots), li)
        assert out is tc
    want = _to_port(jc)
    np.testing.assert_array_equal(tc.q.view(torch.uint8).numpy(), want.q.view(torch.uint8).numpy())
    np.testing.assert_array_equal(_bf16_np(tc.s), _bf16_np(want.s))
    # and the dequantized rows agree with JAX's dequant_rows
    np.testing.assert_array_equal(
        tkv.dequant_rows(tc.q, tc.s, D).numpy(),
        np.asarray(jkv.dequant_rows(jc["q"], jc["s"], D)),
    )


def _filled(kind, seed):
    """A JAX quantized cache with every block of both layers written, and
    the same cache in the port's layout."""
    rng = np.random.default_rng(seed)
    jc = jkv.make_kv_cache(NL, NB, BS, HKV, D, quant=kind)
    n = (NB + 1) * BS
    for li in range(NL):
        k, v = _rows(rng, n)
        jc = jkv.write_kv(jc, jnp.asarray(k), jnp.asarray(v), jnp.arange(n, dtype=jnp.int32), li)
    return jc, _to_port(jc)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_plain_k9_matches_jax_jnp(kind):
    """K9a/K9b/K9c's plain versions (through their wrappers, which take them
    for CPU tensors) and the quantized prefix prefill against JAX's jnp
    path over the same cache. f32 queries: the same arithmetic, the sums in
    another order (1e-5). bf16 queries: the plain versions round the
    dequantized K/V to bf16, as the kernels and the Pallas kernels do,
    while the jnp path keeps them in f32; a score then moves by about
    2^-9 of |q||k| and a probability by as much, so outputs agree to
    2e-2 (the outputs are bf16 in both)."""
    jc, tc = _filled(kind, 1)
    rng = np.random.default_rng(2)
    b, r, hq = 3, 4, 8
    bt = rng.permutation(NB)[: b * 2].reshape(b, 2).astype(np.int32)
    ctx = np.array([[5, 6, 7, 8], [17, 18, 19, 20], [29, 30, 31, 32]], np.int32)
    scale = D**-0.5
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-5), (jnp.bfloat16, torch.bfloat16, 2e-2)):
        q = rng.standard_normal((b * r, hq, D)).astype(np.float32)
        tq_ = torch.from_numpy(q).to(tdt)
        bt_rows, ctx_rows = np.repeat(bt, r, 0), ctx.reshape(-1)
        want = np.asarray(jatt.paged_attention_jnp(
            jnp.asarray(q, jdt), jc, 1, jnp.asarray(bt_rows), jnp.asarray(ctx_rows), scale), np.float32)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
        got = {
            "K9a": kpa.paged_decode_q8(tq_, tc, 1, t(bt_rows), t(ctx_rows), scale),
            "K9b": kpa.paged_verify_q8(tq_, tc, 1, t(bt), t(ctx_rows), scale, r),
            "K9c decode": kmo.mono_q8(tq_, tc, 1, t(bt_rows), t(ctx_rows), scale, 1),
            "K9c verify": kmo.mono_q8(tq_, tc, 1, t(bt), t(ctx_rows), scale, r),
        }
        for name, out in got.items():
            assert out.dtype == tdt, name
            np.testing.assert_allclose(out.float().numpy(), want, rtol=tol, atol=tol, err_msg=name)

    # the prefix prefill over the quantized cache: f32 dequant, torch ops
    lq = 8
    q, k, v = (rng.standard_normal((b * lq, h, D)).astype(np.float32) for h in (hq, HKV, HKV))
    nc, nn = np.array([20, 0, 9], np.int32), np.array([8, 5, 0], np.int32)
    qpos = np.full((b, lq), -1, np.int32)
    for i in range(b):
        qpos[i, : nn[i]] = nc[i] + np.arange(nn[i])
    pk, pv = jatt.gather_prefix_kv(jc, jnp.asarray(bt), D)
    want = np.asarray(jatt.prefill_prefix_attention_jnp(
        *map(jnp.asarray, (q, k, v)), 1, pk, pv, jnp.asarray(nc), jnp.asarray(qpos), scale))
    got = tatt.prefill_prefix_attention(
        *map(torch.from_numpy, (q, k, v)), tc, 1, *map(torch.from_numpy, (bt, nc, nn)), scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


MODEL = dict(
    hidden_size=256, intermediate_size=384, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=64, vocab_size=256, eos_token_id=0, dtype="float32",
    max_position_embeddings=512,
)
ENGINE = dict(
    max_model_len=256, max_num_batched_tokens=512, kvcache_block_size=16,
    num_kvcache_blocks=64, max_num_seqs=4, prefill_token_buckets=(32, 64), dtype="float32",
)
PROMPTS = [[3, 4, 5, 6, 7], [9, 8, 7], [100, 101, 102, 103, 104, 105, 106]]
GAMMA = 4


def _add(eng, max_tokens):
    for p in PROMPTS:
        eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=max_tokens, ignore_eos=True))


@pytest.mark.parametrize("case", ["ceiling, int8 KV", "throughput, fp8 KV + fp8 weights, noisy draft"])
def test_engine_pearl_equals_ar(case):
    """A 2L/3L f32 layer-share pair. Ceiling with an int8 cache: PEARL ==
    AR, every round accepting its whole window. Throughput with an fp8
    cache and fp8 weights and a noisy draft (the classic write-then-read
    verify: the deferred one is off over a quantized cache): every token
    the target verified equals AR's (a request that ends on an accepted
    round leaves its last window unverified), and some round rejects."""
    throughput = case.startswith("throughput")
    kind = "fp8" if throughput else "int8"
    d, t = ModelConfig(**MODEL), ModelConfig(**{**MODEL, "num_hidden_layers": 3})
    dp, tp = build_layer_share_pair(d, t, seed=3, draft_noise=0.05 if throughput else 0.0)
    quant = dict(draft_quant=kind, target_quant=kind) if throughput else {}
    cfg = PearlConfig(
        draft_model=d, target_model=t, gamma=GAMMA, draft_kv_quant=kind, target_kv_quant=kind,
        perf_profile="throughput" if throughput else "ceiling", **quant, **ENGINE,
    )
    eng = PearlEngine(cfg, dp, tp, device="cpu")
    assert tkv.cache_is_quantized(eng.target.kv) and not eng.target.deferred_verify
    max_tokens = 1 + 4 * GAMMA
    _add(eng, max_tokens)
    pearl, n, acc, _ = eng.generate_token_ids()
    _add(eng, max_tokens + 2 * GAMMA)
    ar, _, _, _ = eng.AR_generate_token_ids()
    if throughput:
        verified = [len(p) - GAMMA for p in pearl]
        assert all(v > 0 and p[:v] == a[:v] for p, a, v in zip(pearl, ar, verified))
        assert sum(len(a) - 1 for a in acc) >= 1  # a round rejected
    else:
        assert pearl == [a[:max_tokens] for a in ar]
        assert n == [max_tokens] * len(PROMPTS)
        assert [sum(a) for a in acc] == [max_tokens - GAMMA] * len(PROMPTS)
