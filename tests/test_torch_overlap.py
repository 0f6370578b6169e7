"""The port's overlap execution mode on the CPU, in f32: the per-round
loop (engine/pearl.py pearl_round) against the fused loop token for
token and in accepted-token totals, under the ceiling and throughput
profiles and the split override; against the JAX engine's overlap mode;
its AR, fixed-step bench, limits, serving and stop tokens; and a mixed
greedy/sampled batch, whose verdict equals the JAX runner's on the same
noise. On a CUDA device the draft and target run on two streams
(chip_smoke.py's overlap phases); on the CPU the same calls run on none."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nano_pearl_tpu
from nano_pearl_tpu import config as jcfg
from nano_pearl_tpu_torch import ModelConfig, PearlEngine, SamplingParams
from nano_pearl_tpu_torch import config as tcfg
from nano_pearl_tpu_torch.models.transformer import init_params_numpy

PROMPTS = [[3, 4, 5, 6, 7], [9, 8, 7], [100, 101, 102, 103, 104, 105, 106], [42]]
MODEL = dict(
    hidden_size=256, intermediate_size=384, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=64, vocab_size=256, eos_token_id=0,
    dtype="float32", max_position_embeddings=512,
)
ENGINE = dict(
    max_model_len=256, max_num_batched_tokens=512, kvcache_block_size=16,
    num_kvcache_blocks=96, max_num_seqs=8, prefill_token_buckets=(32, 64, 128, 256),
    dtype="float32",
)
OVERRIDES = ("NANO_PEARL_SPLIT", "NANO_PEARL_MONO", "NANO_PEARL_DEFERRED_VERIFY", "NANO_PEARL_FRESH_MODE",
             "NANO_PEARL_VERIFY_ROWWISE", "NANO_PEARL_VERIFY_GROUP_CAP")


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
    for name in OVERRIDES:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def weights():
    """Independent random draft and target (partial acceptance)."""
    m = ModelConfig(**MODEL)
    return (init_params_numpy(m, np.random.default_rng(10)),
            init_params_numpy(m, np.random.default_rng(11)))


def _config(module, gamma=3, **over):
    m = module.ModelConfig(**MODEL)
    return module.PearlConfig(draft_model=m, target_model=m, gamma=gamma, **{**ENGINE, **over})


def _engine(weights, mode, gamma=3, **over):
    eng = PearlEngine(_config(tcfg, gamma, execution_mode=mode, **over), *weights, device="cpu")
    assert (eng.orchestrator.fused is None) == (mode == "overlap")
    assert eng.orchestrator.streams is None  # no streams on the CPU
    return eng


def _add(eng, max_tokens=20, ignore_eos=False, **kw):
    for p in PROMPTS:
        eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=max_tokens, ignore_eos=ignore_eos, **kw))


def _run(eng, **kw):
    _add(eng, **kw)
    p, n, acc, _ = eng.generate_token_ids()
    return p, n, [round(sum(a), 5) for a in acc]


@pytest.mark.parametrize("gamma", [1, 3])
@pytest.mark.parametrize("profile,env,over", [
    ("ceiling", {}, {}), ("throughput", {}, {}), ("ceiling", {"NANO_PEARL_SPLIT": "1"}, {}),
    ("ceiling", {}, {"draft_kv_quant": "int8", "target_kv_quant": "int8"}),
    ("ceiling", {}, {"draft_sp": 2, "target_sp": 2}),
], ids=["ceiling", "throughput", "split", "int8_kv", "sp"])
def test_overlap_matches_fused(weights, monkeypatch, profile, env, over, gamma):
    """Overlap == fused token for token and in accepted-token totals (the
    JAX package's tests/test_fused.py), and both == AR: under both
    profiles, the split override, a 1-byte cache and sequence parallelism."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    fused = _engine(weights, "fused", gamma, perf_profile=profile, **over)
    overlap = _engine(weights, "overlap", gamma, perf_profile=profile, **over)
    if env:
        assert overlap.draft.split and fused.target.split
    want = _run(fused)
    assert _run(overlap) == want
    _add(overlap)
    ar, _, _, _ = overlap.AR_generate_token_ids()
    assert want[0] == ar


def test_overlap_matches_jax_engine(weights):
    """Same weights, same requests: the port's overlap PEARL and AR streams
    and accepted-token totals equal the JAX engine's in overlap mode."""
    dp, tp = weights
    jeng = nano_pearl_tpu.PearlEngine(_config(jcfg, execution_mode="overlap"), draft_params=dp, target_params=tp)
    assert jeng.orchestrator.fused is None
    teng = _engine(weights, "overlap")
    outs = []
    for eng in (jeng, teng):
        p, n, acc = _run(eng)
        _add(eng)
        a, _, _, _ = eng.AR_generate_token_ids()
        outs.append((p, n, acc, a))
    assert outs[0] == outs[1]


def test_overlap_ar_equals_fused_ar(weights):
    """AR in the overlap mode runs the fused AR loop: its streams equal
    the fused mode's, to completion and at a fixed step count."""
    engines = [_engine(weights, mode) for mode in ("fused", "overlap")]
    outs = []
    for eng in engines:
        _add(eng)
        ar, n, _, _ = eng.AR_generate_token_ids()
        _add(eng, max_tokens=4)
        bench, n_bench, _, _ = eng.AR_bench_generate(num_steps=9)
        outs.append((ar, n, bench, n_bench))
    assert outs[0] == outs[1]
    assert outs[1][3] == [10] * len(PROMPTS)


def test_overlap_bench_fixed_steps(weights):
    """Fixed-step bench in overlap (tests/test_fused.py's): limits are
    lifted, nobody finishes early, and the rounds equal the fused run's."""
    outs = []
    for mode in ("fused", "overlap"):
        eng = _engine(weights, mode)
        _add(eng, max_tokens=4)  # the bench lifts the limits
        out, n, acc, _ = eng.bench_generate(num_pearl_steps=7)
        assert len(out) == len(PROMPTS) and all(v >= 7 for v in n) and all(len(a) >= 1 for a in acc)
        outs.append((out, [round(sum(a), 5) for a in acc]))
    assert outs[0] == outs[1]


def test_overlap_eos_and_max_tokens(weights):
    """max_tokens is honoured up to the accept window's slack, and no
    stream runs past a committed EOS by more than its last unverified
    window (tests/test_fused.py's)."""
    eng = _engine(weights, "overlap")
    gamma = eng.config.gamma
    eng.add_request([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=5))
    eng.add_request([4, 5, 6], SamplingParams(temperature=0.0, max_tokens=30))
    out, n, _, _ = eng.generate_token_ids()
    assert n[0] <= 5 + gamma
    for toks, lim in zip(out, (5, 30)):
        hits = [i for i, t in enumerate(toks) if t in eng.config.eos]
        if hits and hits[0] < lim - 1:
            assert len(toks) - hits[0] <= gamma + 1


@pytest.mark.parametrize("mode", ["overlap", "fused"])
def test_mid_flight_admission_matches_batch_outputs(weights, mode):
    """A request submitted between serve steps joins the running batch in
    pre-verify state and gives the stream of the static batch
    (tests/test_continuous.py's)."""
    eng = _engine(weights, mode)
    sp = lambda n: SamplingParams(temperature=0.0, max_tokens=n)  # noqa: E731
    eng.add_request([1, 2, 3, 4], sp(20))
    eng.add_request([9, 8, 7], sp(20))
    base, _, _, _ = eng.generate_token_ids()
    id_a = eng.submit([1, 2, 3, 4], sp(20))
    outputs, steps, id_b = {}, 0, None
    while eng.has_work and steps < 200:
        for sid, toks, _ in eng.serve_step(fused_rounds=2):
            outputs[sid] = toks
        steps += 1
        if steps == 2:
            id_b = eng.submit([9, 8, 7], sp(20))
    assert id_b is not None and set(outputs) == {id_a, id_b}
    assert outputs[id_a] == base[0] and outputs[id_b] == base[1]


def test_overlap_serve_drains_and_idles(weights):
    eng = _engine(weights, "overlap")
    assert eng.serve_step() == []  # no work: a no-op
    eng.submit([5, 6], SamplingParams(temperature=0.0, max_tokens=6))
    got = []
    while eng.has_work:
        got += eng.serve_step()
    assert len(got) == 1 and len(got[0][1]) == 6


def _jax_engine(weights, mode):
    """The JAX engine in ``mode``: fused needs one device set."""
    dp, tp = weights
    over = {"devices": [jax.devices()[0]]} if mode == "fused" else {"execution_mode": "overlap"}
    return nano_pearl_tpu.PearlEngine(_config(jcfg, **over), draft_params=dp, target_params=tp)


@pytest.mark.parametrize("mode", ["overlap", "fused"])
def test_stop_tokens_match_jax_engine(weights, mode):
    """Per-request stop tokens (tests/test_stop_tokens.py): a request stops
    at its stop's first hit, inclusive, where AR stops; its batchmate with
    ignore_eos runs to max_tokens; both streams equal the JAX engine's in
    the same mode, and ignore_eos turns the stops off."""
    teng, jeng = _engine(weights, mode), _jax_engine(weights, mode)
    _add(teng, max_tokens=24, ignore_eos=True)
    base, _, _, _ = teng.generate_token_ids()
    stop = base[0][len(base[0]) // 2]
    first = base[0].index(stop)
    outs = []
    for eng in (teng, jeng):
        eng.add_request(PROMPTS[0], SamplingParams(temperature=0.0, max_tokens=24, stop_token_ids=(stop,)))
        eng.add_request(PROMPTS[1], SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True,
                                                   stop_token_ids=(stop,)))
        pearl, _, _, _ = eng.generate_token_ids()
        eng.add_request(PROMPTS[0], SamplingParams(temperature=0.0, max_tokens=24, stop_token_ids=(stop,)))
        ar, _, _, _ = eng.AR_generate_token_ids()
        outs.append((pearl, ar))
    assert outs[0] == outs[1]
    (pearl, ar), _ = outs
    assert pearl[0] == ar[0] == base[0][: first + 1]
    assert pearl[1] == base[1]


@pytest.mark.parametrize("mode", ["overlap", "fused"])
def test_mixed_batch_greedy_rows_keep_their_streams(weights, mode):
    """Greedy rows batched with sampled ones (T 0.8, top-k 20, top-p 0.9)
    give their all-greedy streams: the verdict's sampled branch is exact
    on a T=0 row, and a disabled filter leaves its logits alone."""
    eng = _engine(weights, mode)
    _add(eng)
    greedy_streams, _, _, _ = eng.generate_token_ids()
    _add(eng)
    for p in ([7, 7, 7], [8, 9]):
        eng.add_request(p, SamplingParams(temperature=0.8, max_tokens=20, top_k=20, top_p=0.9))
    mixed, _, _, _ = eng.generate_token_ids()
    assert mixed[: len(PROMPTS)] == greedy_streams
    assert all(0 < len(t) <= 20 + eng.config.gamma for t in mixed[len(PROMPTS):])


def test_verdict_matches_jax_runner(weights):
    """The port's runner.verdict over a mixed greedy/sampled batch with
    top-k/top-p rows and a per-request stop matrix equals the JAX runner's
    verdict, the port taking the uniforms and Gumbel noise JAX draws from
    its seed."""
    gamma, b, v, seed = 3, 8, MODEL["vocab_size"], 1234
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((b, gamma, v)).astype(np.float32) * 3
    tbv = np.where(rng.random((b, gamma)) < 0.5, logits.argmax(-1), rng.integers(1, v, (b, gamma))).astype(np.int32)
    is_pre = rng.random(b) < 0.3
    temps = np.array([0.0, 0.8, 0.0, 1.2, 0.7, 0.0, 1.0, 0.5], np.float32)
    num_completion = rng.integers(0, 20, b).astype(np.int32)
    num_completion[[2, 5]] = 21  # at the max_tokens margin
    max_tokens = np.full(b, 22, np.int32)
    ignore_eos = rng.random(b) < 0.2
    tk = np.array([0, 20, 0, 5, 0, 0, 40, 0], np.int32)
    tp = np.array([1.0, 0.9, 1.0, 1.0, 0.8, 1.0, 0.95, 1.0], np.float32)
    stops = np.full((b, 3), -1, np.int32)
    stops[:, 0] = 0
    stops[1, 1:] = tbv[1, :2]
    stops[6, 1] = tbv[6, 0]
    jeng = nano_pearl_tpu.PearlEngine(_config(jcfg, execution_mode="overlap"), draft_params=weights[0],
                                      target_params=weights[1])
    teng = _engine(weights, "overlap")
    want = jeng.target.verdict(logits, tbv, is_pre, temps, num_completion, max_tokens, ignore_eos, seed, gamma,
                               top_ks=tk, top_ps=tp, stops=stops)
    kr, ks = jax.random.split(jax.random.key(seed))
    r = np.array(jax.random.uniform(kr, (b, gamma), dtype=jnp.float32))
    u = jax.random.uniform(ks, (b, gamma, v), dtype=jnp.float32, minval=1e-10, maxval=1.0)
    gumbel = np.array(-jnp.log(-jnp.log(u)))
    got = teng.target.verdict(torch.from_numpy(logits), tbv, is_pre, temps, num_completion, max_tokens, ignore_eos,
                              gamma, None, top_ks=tk, top_ps=tp, stops=stops, r=torch.from_numpy(r),
                              gumbel=torch.from_numpy(gumbel))
    for f in ("acc", "rollout", "revise", "finish", "n_acc"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    assert not bool(got.acc.all()) and bool(got.finish.any())
