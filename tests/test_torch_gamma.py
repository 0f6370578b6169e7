"""Acceptance-adaptive gamma in the port (``PearlConfig.gamma == -1``): the
host logic of engine/pearl.py against the JAX package's own
``PearlOrchestrator`` methods on a grid of acceptance, speeds and
observations; PEARL == AR across gamma switches in both execution modes,
also where a switch finds requests whose last round accepted (their
window's unverified tail is dropped, as it is on preemption); the bench
protocol; and the repairs gamma = -1 needed (the token stream's
frontier, the fused token buffer, the warm-up's window, the refusal of
other gammas)."""

import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from nano_pearl_tpu import config as jcfg
from nano_pearl_tpu.engine.pearl import PearlOrchestrator as JaxOrchestrator
from nano_pearl_tpu_torch import ModelConfig, PearlEngine, SamplingParams
from nano_pearl_tpu_torch import config as tcfg
from nano_pearl_tpu_torch.engine.pearl import PearlOrchestrator
from nano_pearl_tpu_torch.models.transformer import init_params_numpy
from nano_pearl_tpu_torch.utils.layer_share import build_layer_share_pair

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
LADDER = (1, 2, 3, 4, 6, 8, 10, 12, 14, 16)
PS = (0.02, 0.3, 0.6, 0.85, 0.97, 0.99995)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these tiny ops: under the suite's parallel
    workers torch's spinning thread pool oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(module, **over):
    m = module.ModelConfig(**MODEL)
    return module.PearlConfig(draft_model=m, target_model=m, **{**ENGINE, "gamma": -1, **over})


def _stub(cls, module, running: int, fused: bool, state: dict):
    """An orchestrator of ``cls`` with only the attributes the gamma
    control reads (no engine behind it)."""
    o = object.__new__(cls)
    o.pcfg = _config(module)
    o.scheduler = SimpleNamespace(running=[None] * running)
    o.fused = object() if fused else None
    o.force_gamma = None
    o.gamma_list = state.get("gamma_list")
    o._gamma_ladder = LADDER
    o._speeds = dict(state.get("speeds", {}))
    o._round_best = dict(state.get("round_best", {}))
    o._round_seen = set(o._round_best)
    o._commit_obs = dict(state.get("commit_obs", {}))
    o._commit_age = dict(state.get("commit_age", {}))
    o._commit_tick = state.get("tick", 0)
    o._p_ewma = state.get("p")
    return o


def _pair(running: int, fused: bool, state: dict):
    return _stub(JaxOrchestrator, jcfg, running, fused, state), _stub(PearlOrchestrator, tcfg, running, fused, state)


STATES = {
    "no_profile": {},
    "speeds": {"speeds": {1: (900.0, 110.0), 8: (600.0, 150.0), 32: (300.0, 120.0)},
               "gamma_list": {1: 8, 8: 4, 32: 2}},
    "one_measured": {"speeds": {8: (400.0, 100.0)}, "round_best": {(6, 8): 0.021}, "gamma_list": {8: 6}},
    "measured": {"speeds": {8: (400.0, 100.0)},
                 "round_best": {(2, 8): 0.0112, (4, 8): 0.0151, (8, 8): 0.0239, (4, 32): 0.03},
                 "commit_obs": {4: 3.1, 8: 4.4}, "commit_age": {4: 90, 8: 10}, "tick": 100,
                 "gamma_list": {8: 4, 32: 8}},
}


def test_expected_commit_and_estimate_p_match_jax():
    """The geometric commit model and its inverse, on a grid of windows and
    probabilities (and their round trip, tests/test_adaptive_gamma.py's)."""
    j, t = _pair(1, True, {})
    for g in LADDER:
        for p in (0.0, *PS, 1.0):
            assert PearlOrchestrator._expected_commit(g, p) == JaxOrchestrator._expected_commit(g, p)
        for m in np.linspace(0.0, g + 0.5, 23):
            assert t._estimate_p(float(m), g) == j._estimate_p(float(m), g)
        for p in PS[:-1]:
            assert abs(t._estimate_p(t._expected_commit(g, p), g) - p) < 1e-3 or g == 1


def test_notes_match_jax():
    """The same observations folded into both: the p EWMA, the per-gamma
    commit table and its ages, and the round-time table (first sample of a
    key dropped, then the least kept)."""
    j, t = _pair(8, True, {})
    rng = np.random.default_rng(3)
    for _ in range(60):
        g = int(rng.choice(LADDER))
        rounds = int(rng.integers(0, 20))
        obs = float(rng.uniform(0.0, g))
        b = int(rng.integers(1, 40))
        sec = float(rng.uniform(0.005, 0.05))
        for o in (j, t):
            o._note_commit_rate(obs, g, rounds)
            o._note_round_time(g, b, sec)
    for k in ("_p_ewma", "_commit_obs", "_commit_age", "_commit_tick", "_round_best", "_round_seen"):
        assert getattr(t, k) == getattr(j, k), k


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "overlap"])
@pytest.mark.parametrize("state", list(STATES))
def test_round_time_model_and_adapt_gamma_match_jax(state, fused):
    """T(gamma) and the picked gamma equal JAX's at every batch size,
    acceptance estimate and seed gamma of the grid."""
    for running in (1, 6, 8, 32):
        for p in (None, *PS):
            j, t = _pair(running, fused, {**STATES[state], "p": p})
            tj, tt = j._round_time_model(running), t._round_time_model(running)
            assert (tj is None) == (tt is None)
            if tj is not None:
                assert [tt(g) for g in LADDER] == [tj(g) for g in LADDER]
            for base in (1, 4, 10, 16):
                assert t._adapt_gamma(base) == j._adapt_gamma(base), (running, p, base)
            if STATES[state].get("gamma_list"):
                assert t._pick_gamma() == j._pick_gamma()


@pytest.fixture(scope="module")
def pair_weights():
    """A 2-layer draft and an independently drawn 3-layer target (partial
    acceptance, as tests/test_adaptive_gamma.py's)."""
    return (init_params_numpy(ModelConfig(**MODEL), np.random.default_rng(20)),
            init_params_numpy(ModelConfig(**{**MODEL, "num_hidden_layers": 3}), np.random.default_rng(21)))


def _gamma_engine(pair_weights, mode, **over):
    d, t = ModelConfig(**MODEL), ModelConfig(**{**MODEL, "num_hidden_layers": 3})
    cfg = tcfg.PearlConfig(draft_model=d, target_model=t, execution_mode=mode, gamma_profile_batches=(2,),
                           **{**ENGINE, "gamma": -1, **over})
    return PearlEngine(cfg, *pair_weights, device="cpu")


def test_adapt_gamma_prefers_small_window_at_low_acceptance(pair_weights):
    """Fused: at low acceptance gamma shrinks, at p ~ 1 it stays at least
    the seed (tests/test_adaptive_gamma.py's)."""
    orch = _gamma_engine(pair_weights, "fused").orchestrator
    assert orch.gamma_list and orch._speeds  # auto_set_gamma profiled both models
    orch._speeds = {1: (1000.0, 100.0)}
    orch._round_best.clear()
    orch._p_ewma = 0.2
    assert orch._adapt_gamma(10) <= 4
    orch._p_ewma = 0.999
    assert orch._adapt_gamma(10) >= 10


@pytest.mark.parametrize("mode", ["fused", "overlap"])
def test_gamma_auto_lossless_across_switches(pair_weights, mode):
    """gamma=-1 at partial acceptance: the PEARL stream equals the target's
    AR stream at T=0 while gamma switches mid-run (short fused chunks;
    overlap re-picks every round)."""
    eng = _gamma_engine(pair_weights, mode, max_dispatch_rounds=3)
    orch = eng.orchestrator
    orch._speeds = {2: (100.0, 100.0)}  # a slow draft: small windows pay
    orch.gamma_list = {2: 8}
    used = []
    if mode == "fused":
        run = orch.fused.run_pearl
        orch.fused.run_pearl = lambda state, gamma, *a: used.append(gamma) or run(state, gamma, *a)
    else:
        rnd = orch.pearl_round
        orch.pearl_round = lambda gamma: used.append(gamma) or rnd(gamma)
    for i in range(2):
        eng.add_request([1 + i, 2, 3, 4, 5], SamplingParams(temperature=0.0, max_tokens=40, ignore_eos=True))
    pearl, _, _, _ = eng.generate_token_ids()
    for i in range(2):
        eng.add_request([1 + i, 2, 3, 4, 5], SamplingParams(temperature=0.0, max_tokens=40, ignore_eos=True))
    ar, _, _, _ = eng.AR_generate_token_ids()
    assert pearl == ar
    assert used[0] == 8 and len(set(used)) > 1 and orch._p_ewma is not None


@pytest.mark.parametrize("mode", ["fused", "overlap"])
def test_gamma_auto_bench_protocol(pair_weights, mode):
    """Fixed-step bench under gamma=-1 completes, commits a token a round,
    and records the gamma of its last round."""
    eng = _gamma_engine(pair_weights, mode)
    for i in range(2):
        eng.add_request([1 + i, 2, 3], SamplingParams(temperature=0.0, max_tokens=64))
    _, num_tokens, _, _ = eng.bench_generate(num_pearl_steps=8)
    assert all(n >= 1 + 8 for n in num_tokens)
    assert eng.orchestrator.last_gamma in LADDER


@pytest.mark.parametrize("mode", ["fused", "overlap"])
def test_gamma_auto_streamed_tokens_are_never_taken_back(pair_weights, mode):
    """serve_step(with_deltas=True) at gamma=-1 streams only the verified
    prefix: the frontier takes the gamma of the last round (0 before
    any), so every delta is a prefix of the final completion."""
    eng = _gamma_engine(pair_weights, mode)
    assert eng.orchestrator.last_gamma == 0
    ids = [eng.submit([1 + i, 2, 3, 4, 5], SamplingParams(temperature=0.0, max_tokens=30)) for i in range(2)]
    streamed = {i: [] for i in ids}
    final = {}
    while eng.has_work:
        done, deltas = eng.serve_step(fused_rounds=2, with_deltas=True)
        for sid, new, _ in deltas:
            streamed[sid] += new
            assert final.get(sid) is None
        for sid, toks, _ in done:
            final[sid] = toks
        assert eng.orchestrator.last_gamma in LADDER
    assert streamed == final


@pytest.fixture(scope="module")
def noisy_pair():
    """A 2-layer draft and its 3-layer layer-share target, the draft's
    layers perturbed (draft_noise 0.05): rounds accept and reject, so
    requests sit after an accept with an unverified tail."""
    d, t = ModelConfig(**MODEL), ModelConfig(**{**MODEL, "num_hidden_layers": 3})
    return build_layer_share_pair(d, t, seed=5, draft_noise=0.05)


def _noisy_engine(noisy_pair, mode, **over):
    d, t = ModelConfig(**MODEL), ModelConfig(**{**MODEL, "num_hidden_layers": 3})
    cfg = tcfg.PearlConfig(draft_model=d, target_model=t, execution_mode=mode,
                           **{**ENGINE, "gamma": 4, "gamma_profile_batches": (2,), **over})
    return PearlEngine(cfg, *noisy_pair, device="cpu")


def _tails_dropped(eng) -> list:
    """Counts, on the engine's scheduler, the requests that drop an
    unverified tail (a call on a request whose last round accepted)."""
    sch, hits = eng.scheduler, []
    drop = sch.drop_unverified
    sch.drop_unverified = lambda s: hits.append(not s.pre_verify) or drop(s)
    return hits


def _ar_streams(eng, prompts, max_tokens):
    for p in prompts:
        eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=max_tokens, ignore_eos=True))
    return eng.AR_generate_token_ids()[0]


@pytest.mark.parametrize("serve", [False, True], ids=["generate", "serve"])
@pytest.mark.parametrize("mode", ["fused", "overlap"])
def test_gamma_switch_after_an_accept_stays_lossless(noisy_pair, mode, serve):
    """Forced gamma switches (up and down, every overlap round or fused
    chunk) while requests sit after an accept: each PEARL stream starts
    with the target's AR stream at T=0 (an accept-finish may run past
    max_tokens), and streamed deltas are never taken back."""
    eng = _noisy_engine(noisy_pair, mode, gamma=-1, max_dispatch_rounds=2)
    orch = eng.orchestrator
    windows = itertools.cycle((6, 2, 8, 3, 5, 1, 4))
    orch._adapt_gamma = lambda base: next(windows)
    orch._p_ewma = 0.5
    hits = _tails_dropped(eng)
    prompts = [[1 + i, 2, 3, 4, 5] for i in range(3)]
    sp = SamplingParams(temperature=0.0, max_tokens=40, ignore_eos=True)
    if serve:
        ids = [eng.submit(p, sp) for p in prompts]
        streamed, final = {i: [] for i in ids}, {}
        while eng.has_work:
            done, deltas = eng.serve_step(fused_rounds=3, with_deltas=True)
            for sid, new, _ in deltas:
                streamed[sid] += new
            final.update((sid, toks) for sid, toks, _ in done)
        assert streamed == final
        pearl = [final[i] for i in ids]
    else:
        for p in prompts:
            eng.add_request(p, sp)
        pearl = eng.generate_token_ids()[0]
    ar = _ar_streams(eng, prompts, 40)
    assert [x[: len(y)] for x, y in zip(pearl, ar)] == ar
    assert any(hits)  # a switch found a request after an accept


@pytest.mark.parametrize("mode,blocks", [("fused", 14), ("fused", 15), ("overlap", 15)])
def test_preempted_request_drops_its_unverified_tail(noisy_pair, mode, blocks):
    """Under KV pressure a request preempted after an accept re-prefills
    its verified stream only, so PEARL still starts with AR's stream at
    T=0; a fused chunk's growth is reserved for all its rows together."""
    eng = _noisy_engine(noisy_pair, mode, num_kvcache_blocks=blocks)
    hits = _tails_dropped(eng)
    prompts = [[1 + i, 2, 3, 4, 5] for i in range(4)]
    for p in prompts:
        eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=60, ignore_eos=True))
    pearl = eng.generate_token_ids()[0]
    ar = _ar_streams(eng, prompts, 60)
    assert [x[: len(y)] for x, y in zip(pearl, ar)] == ar
    assert any(hits)  # a request was preempted after an accept


@pytest.mark.parametrize("gamma", [0, -2])
def test_gamma_other_than_a_window_or_adaptive_is_refused(pair_weights, gamma):
    with pytest.raises(ValueError, match="gamma must be"):
        _gamma_engine(pair_weights, "fused", gamma=gamma)


@pytest.mark.parametrize("gamma", [-1, 5])
def test_fused_state_buffer_holds_the_window(pair_weights, gamma):
    """The fused token buffer holds max_model_len plus eight windows: of
    the configured gamma, or of 8 at gamma=-1 (the JAX package's rule)."""
    eng = _gamma_engine(pair_weights, "fused", gamma=gamma)
    eng.add_request([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=8))
    eng.orchestrator.prefill_all()
    seqs = eng.scheduler.schedule_decode(lookahead=1)
    state = eng.orchestrator._build_fused_state(seqs)
    assert state["tokens"].shape[1] == ENGINE["max_model_len"] + 8 * (gamma if gamma > 0 else 8) + 64


def test_warmup_sizes_from_the_ladder_top(pair_weights, monkeypatch):
    """At gamma=-1 the warm-up requests run windows of the ladder's top
    (the throughput profile: no verify cap pads a 16-token window's decode
    to 256 rows on the CPU)."""
    eng = _gamma_engine(pair_weights, "fused", perf_profile="throughput")
    seen = []
    add = eng.add_request
    monkeypatch.setattr(eng, "add_request", lambda p, sp: seen.append(sp.max_tokens) or add(p, sp))
    eng.warmup(batches=(2,), rounds=1)
    assert seen == [max(LADDER) + 2] * 2 and not eng.has_work


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_one_row_verify_groups_take_the_decode_kernel(monkeypatch, kv_quant):
    """gamma 1 (on the ladder) verifies one row a group: the dispatch sends
    it to the decode kernel (K1, K9a over a 1-byte cache), since K2 and K9b
    take two rows a group or more; on the CPU its plain version gives the
    one-row verify's rows."""
    from nano_pearl_tpu_torch.ops import attention as attn
    from nano_pearl_tpu_torch.ops.cuda import paged_attention as kpa
    from nano_pearl_tpu_torch.ops.kv_cache import make_kv_cache, write_kv

    called = []
    for name in ("paged_decode", "paged_verify", "paged_decode_q8", "paged_verify_q8"):
        fn = getattr(kpa, name)
        monkeypatch.setattr(kpa, name, lambda *a, _fn=fn, _name=name: called.append(_name) or _fn(*a))
    g = torch.Generator().manual_seed(3)
    hkv, d, bs, groups = 2, 64, 32, 5  # blocks of 32: the 1-byte fast gate
    cache = make_kv_cache(2, 12, bs, hkv, d, torch.float32, "cpu", quant=kv_quant)
    n = 12 * bs
    k, v = torch.randn(n, hkv, d, generator=g), torch.randn(n, hkv, d, generator=g)
    cache = write_kv(cache, k, v, torch.arange(n, dtype=torch.int32), 1)
    q = torch.randn(groups, 2 * hkv, d, generator=g)
    tables = torch.randperm(12, generator=g)[: groups * 2].reshape(groups, 2).to(torch.int32)
    ctx = torch.tensor([1, 7, 16, 25, 32], dtype=torch.int32)
    got = attn.paged_attention_grouped(q, cache, 1, tables, ctx, d**-0.5, 1)
    assert called == ["paged_decode_q8" if kv_quant else "paged_decode"]
    want = attn.paged_attention_grouped_ref(q, cache, 1, tables, ctx, d**-0.5, 1)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
