"""The JAX package's kernel-schedule overrides on the port (the
``NANO_PEARL_*`` variables, engine/runner.py): the plain versions behind
kernels K6a (deferred verify, db schedule), K6b (the same on the mono
schedule, fresh window in the kernel), K8a (split-boundary decode) and
K8b (split-boundary deferred verify) against the JAX package's jnp paths,
the runner's resolution of the overrides, and the port's engine under
each override against its own AR and the JAX engine. The hand-written
CUDA kernels are held against these plain versions in
tests/test_torch_kernels.py.

Tolerances: f32 1e-5 (the same math summed in another order); bf16 2e-2
(both round the same bf16 inputs and accumulate in f32, then round the
output to bf16 once: one bf16 step apart at most, 2^-8 of the value,
and the jnp path multiplies its bf16 probabilities in another order).
No Pallas kernel runs in interpret mode here: the jnp paths are the
reference, as in tests/test_split_schedule.py's tolerance checks.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nano_pearl_tpu
from nano_pearl_tpu import config as jcfg
from nano_pearl_tpu.ops import attention as jatt
from nano_pearl_tpu_torch import PearlEngine, SamplingParams
from nano_pearl_tpu_torch import config as tcfg
from nano_pearl_tpu_torch.engine.runner import GroupRunner
from nano_pearl_tpu_torch.ops import attention as tatt
from nano_pearl_tpu_torch.ops.cuda import mono_attention as kmo
from nano_pearl_tpu_torch.utils.layer_share import build_layer_share_pair

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
L, NB, BS, HKV, D, HQ = 2, 16, 16, 2, 64, 8
OVERRIDES = ("NANO_PEARL_MONO", "NANO_PEARL_DEFERRED_VERIFY", "NANO_PEARL_VERIFY_GROUP_CAP",
             "NANO_PEARL_SPLIT", "NANO_PEARL_VERIFY_ROWWISE", "NANO_PEARL_FRESH_MODE")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these tiny ops: under the suite's parallel
    workers torch's spinning thread pool oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_overrides(monkeypatch):
    """Every test starts with none of the overrides set."""
    for name in OVERRIDES:
        monkeypatch.delenv(name, raising=False)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


# case -> (pre-round context ctx0 of each group, whether the last group is
# pre-verify: one real row, then padding rows at context 1)
CASES = {
    "inside_a_block": ((20, 9, 40), True),
    "across_a_block": ((14, 30, 62), False),  # windows cross the 16-slot pages
    "no_cache": ((0, 25, 7), True),  # ctx0 = 0: the first group reads the window only
}


def _fresh_case(name, dtype, r=5, seed=0):
    """One layer's cache, queries and fresh K/V (rounded to ``dtype``), the
    groups' disjoint block tables and the deferred verify's contexts, as
    numpy arrays of f32 values and int32."""
    ctx0, pre_last = CASES[name]
    b = len(ctx0)
    rng = np.random.default_rng(seed)
    rnd = lambda *shape: np.asarray(  # noqa: E731
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(getattr(torch, dtype)).float())
    cache, q = rnd(L, 2, NB + 1, BS, HKV * D), rnd(b * r, HQ, D)
    fk, fv = rnd(b * r, HKV, D), rnd(b * r, HKV, D)
    bt = (np.arange(b)[:, None] * 5 + np.arange(5)[None, :]).astype(np.int32)
    ctx = np.asarray([c + 1 + np.arange(r) for c in ctx0], np.int32)
    if pre_last:
        ctx[-1] = 1
        ctx[-1, 0] = ctx0[-1] + 1
    return dict(q=q, cache=cache, bt=bt, ctx=ctx.reshape(-1), ctx0=np.asarray(ctx0, np.int32), fk=fk, fv=fv)


def _tensors(case, dtype, lib):
    """The case as torch (lib "torch") or jnp arrays, floats in ``dtype``."""
    out = {}
    for k, v in case.items():
        if lib == "torch":
            t = torch.from_numpy(v)
            out[k] = t.to(getattr(torch, dtype)) if v.dtype == np.float32 else t
        else:
            out[k] = jnp.asarray(v, getattr(jnp, dtype)) if v.dtype == np.float32 else jnp.asarray(v)
    return out


# the deferred verify's kernels by their dispatch arguments: K6a (db), K6b
# (mono, fresh mode "kernel"), K8b (split), and the default merge (K7 +
# fresh window + merge)
SCHEDULES = {
    "K6a": dict(mono=False),
    "K6b": dict(mono=True, fresh_mode="kernel"),
    "K8b": dict(mono=False, split=True),
    "merge": dict(mono=True, fresh_mode="merge"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_fresh_dispatch_matches_jax_jnp(schedule, case, dtype):
    """The deferred verify's attention on the CPU under each schedule (the
    plain version behind K6a, K6b and K8b, and the merge) against
    ``paged_attention_grouped_fresh_jnp``, a pre-verify group, ctx0 = 0 and
    windows across a page included."""
    c, r = _fresh_case(case, dtype), 5
    t, j = _tensors(c, dtype, "torch"), _tensors(c, dtype, "jnp")
    scale = D**-0.5
    got = tatt.paged_attention_grouped_fresh(
        t["q"], t["cache"], 1, t["bt"], t["ctx"], t["ctx0"], t["fk"], t["fv"], scale, r,
        **SCHEDULES[schedule],
    )
    want = jatt.paged_attention_grouped_fresh_jnp(
        j["q"], j["cache"], 1, j["bt"], j["ctx"], j["ctx0"], j["fk"], j["fv"], scale
    )
    assert got.dtype == t["q"].dtype
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_split_decode_matches_jax_jnp(case, dtype):
    """K8a's plain version (``paged_attention_split`` on the CPU) against the
    JAX package's ``paged_attention_split`` on its jnp path and
    ``paged_attention_jnp``, with the fresh rows written into the cache
    (the draft's view) and b1 = ctx0 of each row's group, pre-verify rows
    and ctx0 = 0 included; the rows of the deferred verify over the same
    keys agree."""
    c, r = _fresh_case(case, dtype), 5
    b = len(c["ctx0"])
    cache = c["cache"].copy()
    for g in range(b):  # the fresh rows into the cache: one page per 16 positions
        for i in range(r):
            pos = c["ctx0"][g] + i
            page = c["bt"][g, pos // BS]
            cache[1, 0, page, pos % BS] = c["fk"][g * r + i].reshape(-1)
            cache[1, 1, page, pos % BS] = c["fv"][g * r + i].reshape(-1)
    decode = dict(c, cache=cache, bt=np.repeat(c["bt"], r, 0), b1=np.repeat(c["ctx0"], r))
    t, j = _tensors(decode, dtype, "torch"), _tensors(decode, dtype, "jnp")
    scale = D**-0.5
    got = tatt.paged_attention_split(t["q"], t["cache"], 1, t["bt"], t["ctx"], t["b1"], scale)
    want = jatt.paged_attention_split(
        j["q"], j["cache"], 1, j["bt"], j["ctx"], j["b1"], scale, use_pallas=False
    )
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    np.testing.assert_allclose(
        _np(want), _np(jatt.paged_attention_jnp(j["q"], j["cache"], 1, j["bt"], j["ctx"], scale)), **TOL[dtype])
    tv = _tensors(c, dtype, "torch")
    verify = tatt.paged_attention_grouped_fresh(
        tv["q"], tv["cache"], 1, tv["bt"], tv["ctx"], tv["ctx0"], tv["fk"], tv["fv"], scale, r, split=True,
    )
    real = c["ctx"] > np.repeat(c["ctx0"], r)  # rows that see their group's window
    np.testing.assert_allclose(_np(got)[real], _np(verify)[real], **TOL[dtype])


def test_fresh_mode_read_from_the_environment_without_an_argument(monkeypatch):
    """With no ``fresh_mode`` the dispatch reads NANO_PEARL_FRESH_MODE at the
    call, as the JAX package's: "kernel" goes to K6b's wrapper, unset to
    the merge (K7's wrapper)."""
    c = _fresh_case("inside_a_block", "float32")
    t = _tensors(c, "float32", "torch")
    calls = []
    for module, name in ((kmo, "mono_fresh"), (kmo, "cache_partials")):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, fn=fn, name=name: calls.append(name) or fn(*a))
    args = (t["q"], t["cache"], 1, t["bt"], t["ctx"], t["ctx0"], t["fk"], t["fv"], D**-0.5, 5)
    tatt.paged_attention_grouped_fresh(*args)
    monkeypatch.setenv("NANO_PEARL_FRESH_MODE", "kernel")
    tatt.paged_attention_grouped_fresh(*args)
    tatt.paged_attention_grouped_fresh(*args, fresh_mode="merge")
    assert calls == ["cache_partials", "mono_fresh", "cache_partials"]


# ---------------------------------------------------------- the overrides

MODEL = dict(
    hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=64, vocab_size=256, eos_token_id=0,
    dtype="float32", max_position_embeddings=512,
)


def _runner(profile="ceiling", kv_quant=None, **model):
    mcfg = tcfg.ModelConfig(**{**MODEL, **model, "kv_quant": kv_quant})
    pcfg = tcfg.PearlConfig(
        draft_model=mcfg, target_model=mcfg, max_model_len=256, kvcache_block_size=16,
        num_kvcache_blocks=8, max_num_seqs=4, gamma=4, dtype="float32", perf_profile=profile,
        draft_kv_quant=kv_quant, target_kv_quant=kv_quant,
    )
    return GroupRunner(pcfg, mcfg, torch.device("cpu"), name="t")


def _schedule(r):
    return dict(mono=r.use_mono, deferred=r.deferred_verify, split=r.split, cap=r.verify_group_cap,
                rowwise=r.verify_rowwise, fresh_mode=r.fresh_mode)


CEILING = dict(mono=False, deferred=False, split=False, cap=16, rowwise=False, fresh_mode="merge")
THROUGHPUT = dict(mono=True, deferred=True, split=False, cap=0, rowwise=False, fresh_mode="merge")


@pytest.mark.parametrize("profile,env,want", [
    ("ceiling", {}, CEILING),
    ("throughput", {}, THROUGHPUT),
    ("ceiling", {"NANO_PEARL_MONO": "1"}, {**CEILING, "mono": True}),
    ("throughput", {"NANO_PEARL_MONO": "0"}, {**THROUGHPUT, "mono": False}),
    ("ceiling", {"NANO_PEARL_DEFERRED_VERIFY": "1"}, {**CEILING, "deferred": True}),
    ("throughput", {"NANO_PEARL_DEFERRED_VERIFY": "0"}, {**THROUGHPUT, "deferred": False}),
    ("ceiling", {"NANO_PEARL_VERIFY_GROUP_CAP": "2"}, {**CEILING, "cap": 2}),
    ("ceiling", {"NANO_PEARL_SPLIT": "1"}, {**CEILING, "split": True, "deferred": True}),
    ("ceiling", {"NANO_PEARL_SPLIT": "0"}, CEILING),
    ("throughput", {"NANO_PEARL_SPLIT": "1"}, THROUGHPUT),  # gated off under mono
    ("throughput", {"NANO_PEARL_SPLIT": "1", "NANO_PEARL_MONO": "0"},
     {**THROUGHPUT, "mono": False, "split": True}),
    ("throughput", {"NANO_PEARL_VERIFY_ROWWISE": "1"}, {**THROUGHPUT, "deferred": False, "rowwise": True}),
    ("ceiling", {"NANO_PEARL_SPLIT": "1", "NANO_PEARL_VERIFY_ROWWISE": "1"},
     {**CEILING, "split": True, "rowwise": True}),
    ("throughput", {"NANO_PEARL_FRESH_MODE": "kernel"}, {**THROUGHPUT, "fresh_mode": "kernel"}),
])
def test_overrides_resolve_as_the_jax_runner(monkeypatch, profile, env, want):
    """Each variable takes effect as in the JAX package's runner.py:81-140,
    475-509, unset ones leave the profile's choice, and constructing the
    runner writes nothing into os.environ."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    before = dict(os.environ)
    r = _runner(profile)
    assert dict(os.environ) == before
    assert _schedule(r) == want


@pytest.mark.parametrize("kv_quant,model", [("int8", {}), (None, {"num_key_value_heads": 1})])
def test_split_and_deferred_gated_off(monkeypatch, kv_quant, model):
    """A quantized cache or a folded head axis Hkv * D that is not a
    multiple of 128 turns the split schedule and the deferred verify off,
    as in the JAX package, and the runner says so in its log."""
    monkeypatch.setenv("NANO_PEARL_SPLIT", "1")
    monkeypatch.setenv("NANO_PEARL_DEFERRED_VERIFY", "1")
    logged = []
    import nano_pearl_tpu_torch.engine.runner as runner_mod

    monkeypatch.setattr(runner_mod.logger, "info", lambda msg, **kw: logged.append(msg))
    r = _runner("ceiling", kv_quant, **{**model, "num_attention_heads": 4})
    assert not r.split and not r.deferred_verify and not r.use_mono
    assert any("NANO_PEARL_SPLIT, NANO_PEARL_DEFERRED_VERIFY off" in m for m in logged)


# ------------------------------------------------------------- the engine

ENGINE = dict(
    max_model_len=256, max_num_batched_tokens=512, kvcache_block_size=16, num_kvcache_blocks=96,
    max_num_seqs=8, prefill_token_buckets=(32, 64, 128, 256), dtype="float32",
)
PROMPTS = [[3, 4, 5, 6, 7], [9, 8, 7], [100, 101, 102, 103, 104, 105, 106], [42]]
ENGINE_OVERRIDES = {
    # name: (profile, draft noise, variables, the target's resolved schedule)
    "split": ("ceiling", 0.0, {"NANO_PEARL_SPLIT": "1"}, {**CEILING, "split": True, "deferred": True}),
    "deferred_db": ("ceiling", 0.0, {"NANO_PEARL_DEFERRED_VERIFY": "1"}, {**CEILING, "deferred": True}),
    "fresh_kernel": ("throughput", 0.05, {"NANO_PEARL_FRESH_MODE": "kernel"},
                     {**THROUGHPUT, "fresh_mode": "kernel"}),
    "rowwise": ("throughput", 0.05, {"NANO_PEARL_VERIFY_ROWWISE": "1", "NANO_PEARL_VERIFY_GROUP_CAP": "2"},
                {**THROUGHPUT, "deferred": False, "rowwise": True, "cap": 2}),
}


def _pair_configs(module, profile, gamma):
    d = module.ModelConfig(**{**MODEL, "hidden_size": 256, "intermediate_size": 384})
    t = module.ModelConfig(**{**MODEL, "hidden_size": 256, "intermediate_size": 384, "num_hidden_layers": 6})
    return d, t, module.PearlConfig(draft_model=d, target_model=t, gamma=gamma, perf_profile=profile, **ENGINE)


def _run(eng, max_tokens):
    for p in PROMPTS:
        eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=max_tokens, ignore_eos=True))
    pearl, n, acc, _ = eng.generate_token_ids()
    for p in PROMPTS:
        eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=max_tokens + 8, ignore_eos=True))
    ar, _, _, _ = eng.AR_generate_token_ids()
    return pearl, n, [round(sum(a), 5) for a in acc], ar


@pytest.mark.parametrize("override", list(ENGINE_OVERRIDES))
def test_engine_under_override(monkeypatch, override):
    """2L/6L layer-share pair in f32, B=4, gamma=4, under each override set:
    the port's PEARL stream equals its AR stream wherever the target
    verified it (a request that finishes on an accepted round ends with an
    unverified window), and the port's streams and acceptance equal the
    JAX engine's on the same weights and variables (the JAX package on the
    CPU runs its jnp paths and has no split schedule there)."""
    profile, noise, env, schedule = ENGINE_OVERRIDES[override]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    gamma = 4
    d, t, cfg = _pair_configs(tcfg, profile, gamma)
    dp, tp = build_layer_share_pair(d, t, seed=3, draft_noise=noise)
    port = PearlEngine(cfg, dp, tp, device="cpu")
    assert _schedule(port.target) == schedule
    got = _run(port, 24)
    pearl, _, _, ar = got
    assert all(len(p) > gamma and p[: len(p) - gamma] == a[: len(p) - gamma] for p, a in zip(pearl, ar))
    jeng = nano_pearl_tpu.PearlEngine(_pair_configs(jcfg, profile, gamma)[2], draft_params=dp, target_params=tp)
    assert _run(jeng, 24) == got
