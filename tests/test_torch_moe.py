"""The port's Mixture-of-Experts block (nano_pearl_tpu_torch/ops/moe.py) and
the MoE models it runs, against the JAX package on the CPU, in f32:

(a) ``route`` (with and without renormalisation, padded experts masked),
    the dense ``moe_mlp``, the sorted dispatch and int8 experts against
    JAX's ``ops/moe.py`` at rtol/atol 1e-5 (the same f32 products, summed
    in another order), the dense block also against a per-token loop and
    the sorted one against the port's dense one;
(b) the forward's prefill (sorted, 128 rows), decode and packed verify
    logits and KV cache against JAX's ``forward`` on a tiny MoE config at
    1e-4, the bound of tests/test_torch_model.py;
(c) the loader on tiny Qwen3-MoE and Mixtral checkpoints: arrays equal to
    JAX's ``load_params``, logits equal to HF's at 2e-4 (a paged decode, a
    prefill, and a 140-token prefill through the sorted dispatch);
(d) the engine: f32 PEARL == AR with an MoE target, MoE in both groups and
    int8 MoE weights, each stream equal to the JAX engine's; under the
    throughput profile a 128-row verify takes the sorted dispatch and every
    verified token equals AR's and the JAX engine's; the MoE layer-share
    pair accepts every token under the ceiling profile, whose prefill lets
    the sorted dispatch run and whose decode and verify never do.

Expert parallelism (JAX's ``moe_mlp_ep``) is not ported. Engine cases run
torch on one thread (see test_torch_kv_quant.py).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nano_pearl_tpu
from nano_pearl_tpu import config as jcfg
from nano_pearl_tpu.models import transformer as jtr
from nano_pearl_tpu.ops import attention as jatt
from nano_pearl_tpu.ops import moe as jmoe
from nano_pearl_tpu.ops import quant as jquant
from nano_pearl_tpu.ops.kv_cache import make_kv_cache as jmake_kv_cache
from nano_pearl_tpu.utils import loader as jloader
from nano_pearl_tpu_torch import PearlConfig, PearlEngine, SamplingParams
from nano_pearl_tpu_torch import config as tcfg
from nano_pearl_tpu_torch.engine.runner import GroupRunner
from nano_pearl_tpu_torch.models import transformer as ttr
from nano_pearl_tpu_torch.ops import moe
from nano_pearl_tpu_torch.ops.quant import quantize_weight
from nano_pearl_tpu_torch.utils import loader
from nano_pearl_tpu_torch.utils.layer_share import build_layer_share_pair
from test_torch_kv_quant import one_torch_thread  # noqa: F401 (autouse fixture)
import test_torch_loader
from test_torch_loader import port_logits
from test_torch_model import _jforward, _views

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_FWD = dict(rtol=1e-4, atol=1e-4)
TOL_HF = dict(rtol=2e-4, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _experts(rng, n, h, e, f, scale=0.2):
    """x [n, h], router [h, e], wgate / wup [e, h, f], wdown [e, f, h]."""
    x = rng.standard_normal((n, h), dtype=np.float32)
    router = rng.standard_normal((h, e), dtype=np.float32)
    w = [rng.standard_normal(s, dtype=np.float32) * np.float32(scale) for s in ((e, h, f), (e, h, f), (e, f, h))]
    return x, router, *w


@pytest.fixture
def sorted_calls(monkeypatch):
    """Rows of each call of the sorted dispatch."""
    rows, orig = [], moe._moe_mlp_sorted

    def counted(x, *args):
        rows.append(x.shape[0])
        return orig(x, *args)

    monkeypatch.setattr(moe, "_moe_mlp_sorted", counted)
    return rows


# ------------------------------------------------------------------ (a)


@pytest.mark.parametrize("norm", [True, False])
def test_route_matches_jax(norm):
    logits = np.random.default_rng(0).standard_normal((33, 6), dtype=np.float32)
    got = moe.route(_t(logits), 2, norm).numpy()
    np.testing.assert_allclose(got, np.asarray(jmoe.route(jnp.asarray(logits), 2, norm)), **TOL)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    for n in range(33):  # HF's scheme, token by token
        idx = np.argsort(probs[n])[::-1][:2]
        want = np.zeros(6, np.float32)
        want[idx] = probs[n][idx] / (probs[n][idx].sum() if norm else 1.0)
        np.testing.assert_allclose(got[n], want, rtol=1e-6, atol=1e-7)


def test_route_masks_padded_experts():
    logits = np.ones((3, 6), np.float32) * np.arange(6, dtype=np.float32)  # expert 5 best
    got = moe.route(_t(logits), 2, True, valid_num_experts=4).numpy()
    assert (got[:, 4:] == 0).all() and (got[:, :4] > 0).sum() == 6
    np.testing.assert_allclose(got, np.asarray(jmoe.route(jnp.asarray(logits), 2, True, 4)), **TOL)


def test_dense_moe_mlp_matches_jax_and_a_token_loop():
    n, h, e, f, k = 5, 8, 4, 12, 2
    x, router, wg, wu, wd = _experts(np.random.default_rng(1), n, h, e, f)
    got = moe.moe_mlp(*map(_t, (x, router, wg, wu, wd)), k, True).numpy()
    want = np.asarray(jmoe.moe_mlp(*map(jnp.asarray, (x, router, wg, wu, wd)), k, True))
    np.testing.assert_allclose(got, want, **TOL)
    gates = moe.route(_t(x @ router), k, True).numpy()
    loop = np.zeros((n, h), np.float32)
    for i in range(n):
        for j in np.flatnonzero(gates[i]):
            g = x[i] @ wg[j]
            loop[i] += gates[i, j] * ((g / (1 + np.exp(-g)) * (x[i] @ wu[j])) @ wd[j])
    np.testing.assert_allclose(got, loop, **TOL)


@pytest.mark.parametrize("norm", [True, False])
def test_sorted_moe_mlp_matches_jax_and_dense(norm, sorted_calls):
    """192 rows (past _RAGGED_MIN_ROWS), one padded expert never routed."""
    n, h, e, f, k = 192, 16, 6, 24, 2
    x, router, wg, wu, wd = _experts(np.random.default_rng(2), n, h, e, f)
    args = (*map(_t, (x, router, wg, wu, wd)), k, norm, e - 1)
    got = moe.moe_mlp(*args, allow_ragged=True).numpy()
    assert sorted_calls == [n]
    dense = moe.moe_mlp(*args).numpy()
    assert sorted_calls == [n]
    want = np.asarray(jax.jit(lambda *a: jmoe.moe_mlp(*a, k, norm, e - 1, allow_ragged=True))(
        *map(jnp.asarray, (x, router, wg, wu, wd))))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, dense, **TOL)


def test_sorted_moe_mlp_sums_in_expert_order():
    """top-4 of 6: each token's four terms are summed in ascending expert
    order (the sorted order), whatever order top-k lists them in."""
    n, h, e, f, k = 128, 8, 6, 16, 4
    x, router, wg, wu, wd = _experts(np.random.default_rng(3), n, h, e, f)
    tx = list(map(_t, (x, router, wg, wu, wd)))
    got = moe.moe_mlp(*tx, k, True, allow_ragged=True)
    gates = moe.route(tx[0] @ tx[1], k, True)
    want = torch.zeros(n, h)
    for j in range(e):  # expert by expert, ascending
        a = torch.nn.functional.silu(tx[0] @ tx[2][j]) * (tx[0] @ tx[3][j])
        want = want + torch.where(gates[:, j:j + 1] > 0, gates[:, j:j + 1] * (a @ tx[4][j]), 0.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("allow_ragged", [False, True])
def test_int8_experts_match_jax(allow_ragged, sorted_calls):
    """Expert stacks quantized per output channel (scale [E, 1, F]) equal
    JAX's, and the block on them matches JAX's; quantized experts stay on
    the dense dispatch even where the sorted one is allowed."""
    n, h, e, f, k = 130, 16, 4, 24, 2
    x, router, *ws = _experts(np.random.default_rng(4), n, h, e, f)
    tq = [quantize_weight(_t(w), "int8") for w in ws]
    jq = [jquant.quantize_weight(jnp.asarray(w), "int8") for w in ws]
    for a, b in zip(tq, jq):
        assert a["s"].shape == (e, 1, a["q"].shape[-1])
        np.testing.assert_array_equal(a["q"].numpy(), np.asarray(b["q"]))
        np.testing.assert_array_equal(a["s"].numpy(), np.asarray(b["s"]))
    got = moe.moe_mlp(_t(x), _t(router), *tq, k, True, allow_ragged=allow_ragged).numpy()
    want = np.asarray(jmoe.moe_mlp(jnp.asarray(x), jnp.asarray(router), *jq, k, True, allow_ragged=allow_ragged))
    np.testing.assert_allclose(got, want, **TOL)
    assert sorted_calls == []


def test_quantize_params_scales_expert_stacks_per_layer():
    """quantize_params gives 4-D expert stacks the scale [L, E, 1, Fm] of
    JAX's quantize_weight, layer_weight slices them, the router stays
    plain."""
    from nano_pearl_tpu_torch.ops.quant import layer_weight

    cfg = tcfg.ModelConfig(**MOE_MODEL, quant="int8")
    tree = ttr.init_params_numpy(cfg, np.random.default_rng(5))
    p = ttr.params_from_numpy(tree, cfg, "cpu")
    lay = p["layers"]
    assert lay["wgate"]["s"].shape == (2, 4, 1, 128) and lay["wdown"]["s"].shape == (2, 4, 1, 256)
    assert not isinstance(lay["router"], dict)
    want = jquant.quantize_weight(jnp.asarray(tree["layers"]["wup"]), "int8")
    np.testing.assert_array_equal(lay["wup"]["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(lay["wup"]["s"].numpy(), np.asarray(want["s"]))
    one = layer_weight(lay["wup"], 1)
    assert one["q"].shape == (4, 256, 128) and one["s"].shape == (4, 1, 128)


# ------------------------------------------------------------------ (b)

MOE_MODEL = dict(
    architecture="Qwen3MoeForCausalLM", hidden_size=256, intermediate_size=384, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=64, vocab_size=300, eos_token_id=1,
    dtype="float32", max_position_embeddings=256, num_experts=4, num_experts_per_tok=2,
    moe_intermediate_size=128,
)
BS, NB, GAMMA = 16, 24, 3


def test_prefill_decode_verify_match_jax(sorted_calls):
    """test_torch_model.py's three phases on a tiny MoE config: the 4 x 32
    prefill (128 rows, the sorted dispatch on both sides), a 4-row decode
    and the verify in two chunks of 6 rows (dense)."""
    jm, tm = jcfg.ModelConfig(**MOE_MODEL), tcfg.ModelConfig(**MOE_MODEL)
    tree = ttr.init_params_numpy(tm, np.random.default_rng(0))
    pcfg = tcfg.PearlConfig(
        draft_model=tm, target_model=tm, max_model_len=256, kvcache_block_size=BS, num_kvcache_blocks=NB,
        gamma=GAMMA, verify_group_cap=2, prefill_token_buckets=(32, 64), dtype="float32",
    )
    runner = GroupRunner(pcfg, pcfg.target_config, torch.device("cpu"), name="t", params=tree)
    jparams = {k: jnp.asarray(v) for k, v in tree.items() if k != "layers"}
    jparams["layers"] = {k: jnp.asarray(v) for k, v in tree["layers"].items()}
    assert jparams["layers"]["wgate"].shape == (2, 4, 256, 128)
    jrope = jtr.make_rope_table(jm)
    jkv = jmake_kv_cache(jm.num_hidden_layers, NB, BS, jm.num_key_value_heads, jm.head_dim, jnp.float32)
    scale = jm.head_dim**-0.5
    rng = np.random.default_rng(1)
    views = _views(rng)
    b, lq = len(views), 32

    got = runner.prefill(views, lq, b).numpy()
    assert sorted_calls == [b * lq] * 2  # one call a layer
    tokens = np.zeros((b, lq), np.int32)
    positions = np.zeros((b, lq), np.int32)
    qpos = np.full((b, lq), -1, np.int32)
    slots = np.full((b, lq), NB * BS, np.int32)
    for i, v in enumerate(views):
        n = len(v)
        tokens[i, :n], positions[i, :n], qpos[i, :n] = v.token_ids, np.arange(n), np.arange(n)
        slots[i, :n] = [v.token_to_slot(t) for t in range(n)]
    attn = partial(jatt.prefill_self_attention_jnp, scale=scale)
    attn.wants_fresh_kv = True
    hidden, jkv = jtr.forward(jm, jparams, jkv, *map(jnp.asarray, (tokens.reshape(-1), positions.reshape(-1),
                              slots.reshape(-1))), jrope, attn, (None, jnp.asarray(qpos)), moe_ragged=True)
    want = np.asarray(jtr.compute_logits(jm, jparams, hidden))
    np.testing.assert_allclose(got, want[[i * lq + len(v) - 1 for i, v in enumerate(views)]], **TOL_FWD)

    for v, t in zip(views, got.argmax(-1)):
        v.append(int(t))
    toks = np.array([v.last_token for v in views], np.int32)
    pos = np.array([len(v) - 1 for v in views], np.int32)
    dslots = np.array([v.token_to_slot(len(v) - 1) for v in views], np.int32)
    bt = np.array([v.block_table for v in views], np.int32)
    got = runner.decode_step(*map(torch.from_numpy, (toks, pos, dslots, bt, pos + 1)))
    jkv, want = _jforward(jm, jparams, jkv, jrope, toks, pos, dslots,
                          partial(jatt.paged_attention_jnp, scale=scale), (jnp.asarray(bt), jnp.asarray(pos + 1)))
    np.testing.assert_allclose(got.numpy(), want, **TOL_FWD)

    vt = rng.integers(2, 300, (b, GAMMA)).astype(np.int32)
    vp = np.array([np.arange(len(v), len(v) + GAMMA) for v in views], np.int32)
    vs = np.array([[v.block_table[x // BS] * BS + x % BS for x in p] for v, p in zip(views, vp)], np.int32)
    flat = [x.reshape(-1) for x in (vt, vp, vs)]
    got = runner.packed_verify_forward(*map(torch.from_numpy, flat), torch.from_numpy(bt),
                                       torch.from_numpy((vp + 1).reshape(-1)), GAMMA)
    attn = partial(jatt.paged_attention_grouped, scale=scale, rows_per_group=GAMMA, use_pallas=False)
    jkv, want = _jforward(jm, jparams, jkv, jrope, *flat, attn, (jnp.asarray(bt), jnp.asarray((vp + 1).reshape(-1))))
    np.testing.assert_allclose(got.numpy(), want, **TOL_FWD)
    assert sorted_calls == [b * lq] * 2  # decode and the ceiling's verify stay dense
    np.testing.assert_allclose(runner.kv[:, :, :NB].numpy(), np.asarray(jkv)[:, :, :NB], **TOL_FWD)


# ------------------------------------------------------------------ (c)

transformers = pytest.importorskip("transformers")
ARCHS = ("qwen3moe", "mixtral")


def save_tiny_hf_moe(path, arch):
    """tests/test_moe.py's tiny HF MoE models: hidden 64, 4 heads of 16, 2
    KV heads, 4 experts, top-2, 3 layers, vocab 211, f32, seeded."""
    torch.manual_seed(0)
    common = dict(
        hidden_size=64, intermediate_size=112, num_hidden_layers=3, num_attention_heads=4,
        num_key_value_heads=2, vocab_size=211, max_position_embeddings=256, rope_theta=10000.0,
        torch_dtype="float32", tie_word_embeddings=False, num_experts_per_tok=2, eos_token_id=2,
    )
    if arch == "qwen3moe":
        cfg = transformers.Qwen3MoeConfig(**common, head_dim=16, num_experts=4, moe_intermediate_size=96,
                                          norm_topk_prob=True, decoder_sparse_step=1, mlp_only_layers=[])
    else:
        cfg = transformers.MixtralConfig(**common, num_local_experts=4)
    model = transformers.AutoModelForCausalLM.from_config(cfg).eval().float()
    model.save_pretrained(path, safe_serialization=True)
    return model


@pytest.fixture(scope="module")
def moe_checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf_moe")
    return {arch: (save_tiny_hf_moe(str(root / arch), arch), str(root / arch)) for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_load_params_equals_jax(moe_checkpoints, arch):
    path = moe_checkpoints[arch][1]
    tm = tcfg.ModelConfig.from_json(path).pad_for_tp(1)
    assert tm.is_moe and tm.num_experts == 4 and tm.moe_intermediate_size == 128
    want = jloader.load_params(jcfg.ModelConfig.from_json(path).pad_for_tp(1), path, shardings=None,
                               dtype=jnp.float32)
    got = loader.load_params(tm, path)
    assert sorted(got["layers"]) == sorted(want["layers"]) and "router" in got["layers"]
    for k in want["layers"]:
        np.testing.assert_array_equal(got["layers"][k], np.asarray(want["layers"][k]), err_msg=k)
    for k in ("embed", "final_ln", "lm_head"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("path_kind", ["paged", "prefill", "prefill_sorted"])
def test_logits_match_hf(moe_checkpoints, arch, path_kind, sorted_calls, monkeypatch):
    """HF's logits at 2e-4; ``prefill_sorted`` is a 140-token prefill
    forward with the sorted dispatch allowed, which takes it."""
    model, path = moe_checkpoints[arch]
    ids = [1, 5, 9, 42, 7, 100, 3, 77, 8, 15, 2, 4, 6, 11, 13, 17, 19, 23]
    if path_kind == "prefill_sorted":
        ids = np.random.default_rng(6).integers(1, 211, 140).tolist()
        monkeypatch.setattr(test_torch_loader, "forward", partial(ttr.forward, moe_ragged=True))
    with torch.no_grad():
        want = model(torch.tensor([ids])).logits[0].numpy()
    np.testing.assert_allclose(port_logits(path, ids, path_kind != "paged"), want, **TOL_HF)
    assert sorted_calls == ([140] * 3 if path_kind == "prefill_sorted" else [])


# ------------------------------------------------------------------ (d)

TINY = dict(
    hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    vocab_size=256, eos_token_id=0, dtype="float32", max_position_embeddings=512,
)
TINY_MOE = dict(TINY, architecture="Qwen3MoeForCausalLM", num_experts=4, num_experts_per_tok=2,
                moe_intermediate_size=96)
ENGINE = dict(
    max_model_len=256, max_num_batched_tokens=512, kvcache_block_size=16, num_kvcache_blocks=96, gamma=3,
    max_num_seqs=8, prefill_token_buckets=(32, 64, 128, 256, 512), dtype="float32",
)
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [11, 12, 13, 14, 15, 16, 17]]
CASES = {  # case -> (draft fields, target fields, weight quantization of the target)
    "moe_target": (TINY, dict(TINY_MOE), None),
    "moe_both": (TINY_MOE, dict(TINY_MOE, num_hidden_layers=3), None),
    "moe_target_int8": (TINY, dict(TINY_MOE), "int8"),
}


def _streams(eng, prompts, max_tokens):
    outs = []
    for gen in (eng.generate_token_ids, eng.AR_generate_token_ids):
        for p in prompts:
            eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=max_tokens, ignore_eos=True))
        toks, n, acc, _ = gen()
        # accepted tokens, and accepted runs (one a request that never rejected)
        outs.append((toks, n, acc and [(round(sum(a), 5), len(a)) for a in acc]))
    return outs


@pytest.mark.parametrize("case", list(CASES))
def test_pearl_equals_ar_and_the_jax_engine(case):
    """Independent random draft and target weights (partial acceptance):
    PEARL == AR, and both streams and the accepted-token totals equal the
    JAX engine's on the same weights."""
    d, t, quant = CASES[case]
    dp = ttr.init_params_numpy(tcfg.ModelConfig(**d), np.random.default_rng(10))
    tp = ttr.init_params_numpy(tcfg.ModelConfig(**t), np.random.default_rng(11))
    kw = dict(ENGINE, target_quant=quant)
    teng = PearlEngine(PearlConfig(draft_model=tcfg.ModelConfig(**d), target_model=tcfg.ModelConfig(**t), **kw),
                       dp, tp, device="cpu")
    assert teng.target.cfg.is_moe and teng.target.params["layers"]["router"].shape[-1] == 4
    jeng = nano_pearl_tpu.PearlEngine(
        jcfg.PearlConfig(draft_model=jcfg.ModelConfig(**d), target_model=jcfg.ModelConfig(**t), **kw),
        draft_params=dp, target_params=tp)
    (pearl, n, _), (ar, _, _) = got = _streams(teng, PROMPTS, 16)
    assert pearl == ar and n == [16] * len(PROMPTS)
    assert _streams(jeng, PROMPTS, 16) == got


def _phases(monkeypatch, runner_cls=GroupRunner):
    """(phase, rows, allow_ragged) of every MoE block call, by the runner
    method it ran under."""
    calls, phase = [], [None]
    orig = ttr.moe_mlp

    def spy(x, *args, allow_ragged=False):
        calls.append((phase[0], x.shape[0], allow_ragged))
        return orig(x, *args, allow_ragged=allow_ragged)

    monkeypatch.setattr(ttr, "moe_mlp", spy)
    for name in ("prefill", "decode_step", "packed_verify_forward"):
        method = getattr(runner_cls, name)

        def tagged(self, *args, _m=method, _n=name, **kwargs):
            phase[0] = _n
            try:
                return _m(self, *args, **kwargs)
            finally:
                phase[0] = None

        monkeypatch.setattr(runner_cls, name, tagged)
    return calls


def test_throughput_verify_takes_the_sorted_dispatch(monkeypatch, sorted_calls):
    """The throughput profile on a noisy MoE layer-share pair, 8 requests
    at gamma 16: the packed verify of 8 x 16 = 128 rows takes the sorted
    dispatch, decode never does; every verified PEARL token equals AR's,
    and the streams equal the JAX engine's under the same profile."""
    gamma = 16
    mods = {m: (m.ModelConfig(**TINY_MOE), m.ModelConfig(**dict(TINY_MOE, num_hidden_layers=4))) for m in (tcfg, jcfg)}
    dp, tp = build_layer_share_pair(*mods[tcfg], seed=3, draft_noise=0.05)
    kw = dict(ENGINE, gamma=gamma, perf_profile="throughput")
    prompts = [np.random.default_rng(i).integers(2, 250, 3 + i).tolist() for i in range(8)]
    teng = PearlEngine(PearlConfig(*mods[tcfg], **kw), dp, tp, device="cpu")
    calls = _phases(monkeypatch)
    (pearl, n, acc), (ar, _, _) = got = _streams(teng, prompts, 2 * gamma + 1)
    verify = {(rows, ragged) for ph, rows, ragged in calls if ph == "packed_verify_forward"}
    assert verify == {(128, True)} and 128 in sorted_calls
    assert all(not ragged for ph, _, ragged in calls if ph == "decode_step")
    assert any(runs > 1 for _, runs in acc), "no round rejected"
    for p, a in zip(pearl, ar):
        assert p[: len(p) - gamma] == a[: len(p) - gamma]
    monkeypatch.undo()
    jeng = nano_pearl_tpu.PearlEngine(jcfg.PearlConfig(*mods[jcfg], **kw), draft_params=dp, target_params=tp)
    assert _streams(jeng, prompts, 2 * gamma + 1) == got


def test_layer_share_pair_at_the_ceiling(monkeypatch):
    """The MoE layer-share pair (its target's extra layers have zero expert
    wdown) under the ceiling profile: MAT == gamma (bench.py's (n - 1) /
    steps), every prefill call allows the sorted dispatch (4 x 64 rows take
    it) and every decode and verify call runs the dense one."""
    gamma, steps = 4, 6
    md, mt = tcfg.ModelConfig(**TINY_MOE), tcfg.ModelConfig(**dict(TINY_MOE, num_hidden_layers=5))
    dp, tp = build_layer_share_pair(md, mt, seed=0)
    assert tp["layers"]["wdown"].ndim == 4 and not tp["layers"]["wdown"][2:].any()
    eng = PearlEngine(PearlConfig(md, mt, **dict(ENGINE, gamma=gamma)), dp, tp, device="cpu")
    calls = _phases(monkeypatch)
    for i in range(4):
        prompt = np.random.default_rng(i).integers(2, 250, 40 + i).tolist()
        eng.add_request(prompt, SamplingParams(temperature=0.0, max_tokens=200, ignore_eos=True))
    _, n, acc, _ = eng.bench_generate(num_pearl_steps=steps)
    assert n == [1 + steps * gamma] * 4
    assert [sum(a) for a in acc] == [1 + (steps - 1) * gamma] * 4
    by_phase = {}
    for ph, rows, ragged in calls:
        by_phase.setdefault(ph, set()).add(ragged)
    assert by_phase == {"prefill": {True}, "decode_step": {False}, "packed_verify_forward": {False}}
    assert max(rows for ph, rows, _ in calls if ph == "prefill") >= moe._RAGGED_MIN_ROWS
