"""The port's engine under the "throughput" profile on the CPU, in f32,
with a layer-share pair whose draft carries noise (so rounds reject and
roll back over deferred writes): PEARL == AR at T=0, token streams equal
to the JAX engine's under the same profile on the same weights, the
gamma-scan decoding at the batch bucket's rows, and the noisy pair's
construction."""

import numpy as np
import pytest

import nano_pearl_tpu
from nano_pearl_tpu import config as jcfg
from nano_pearl_tpu_torch import PearlEngine, SamplingParams
from nano_pearl_tpu_torch import config as tcfg
from nano_pearl_tpu_torch.utils.layer_share import build_layer_share_pair

PROMPTS = [[3, 4, 5, 6, 7], [9, 8, 7], [100, 101, 102, 103, 104, 105, 106], [42]]
MODEL = dict(
    hidden_size=256, intermediate_size=384, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=64, vocab_size=256, eos_token_id=0,
    dtype="float32", max_position_embeddings=512,
)
ENGINE = dict(
    max_model_len=256, max_num_batched_tokens=512, kvcache_block_size=16,
    num_kvcache_blocks=96, max_num_seqs=8, prefill_token_buckets=(32, 64, 128, 256),
    dtype="float32", perf_profile="throughput",
)
NOISE = 0.05  # at these widths: 5-9 rejections in 40 tokens per request


def _verified_equal(p, a, gamma):
    """PEARL's stream equals AR's wherever the target verified it: a
    request that finishes on an accepted round ends with its last draft
    window unverified (the finish rule of the JAX package and the
    reference), so its last gamma tokens are left out."""
    n = len(p) - gamma
    return n > 0 and p[:n] == a[:n]


def _models(module, target_layers=4):
    return module.ModelConfig(**MODEL), module.ModelConfig(**{**MODEL, "num_hidden_layers": target_layers})


def _config(module, gamma, **over):
    d, t = _models(module)
    return module.PearlConfig(draft_model=d, target_model=t, gamma=gamma, **{**ENGINE, **over})


def _add(eng, max_tokens, prompts=PROMPTS):
    for p in prompts:
        eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=max_tokens, ignore_eos=True))


@pytest.fixture(scope="module")
def noisy_pair():
    return build_layer_share_pair(*_models(tcfg), seed=3, draft_noise=NOISE)


@pytest.mark.parametrize("gamma", [3, 5])
def test_pearl_equals_ar_with_rejections(noisy_pair, gamma):
    """Every verified PEARL token equals AR's at its position (PEARL
    commits whole windows, so its stream may end past max_tokens; AR runs
    2 * gamma further so it covers PEARL's), and rounds did reject."""
    eng = PearlEngine(_config(tcfg, gamma), *noisy_pair, device="cpu")
    assert eng.target.deferred_verify and eng.draft.use_mono
    _add(eng, 40)
    pearl, n, acc, _ = eng.generate_token_ids()
    _add(eng, 40 + 2 * gamma)
    ar, *_ = eng.AR_generate_token_ids()
    assert all(_verified_equal(p, a, gamma) for p, a in zip(pearl, ar))
    # a request whose every round accepted has one accepted-token emit
    assert sum(len(a) for a in acc) > 2 * len(PROMPTS)


def test_generate_matches_jax_engine(noisy_pair):
    """Same weights, same requests, both engines under the throughput
    profile: equal PEARL and AR streams and accepted-token totals."""
    gamma = 4
    dp, tp = noisy_pair
    jeng = nano_pearl_tpu.PearlEngine(_config(jcfg, gamma), draft_params=dp, target_params=tp)
    teng = PearlEngine(_config(tcfg, gamma), dp, tp, device="cpu")
    outs = []
    for eng in (jeng, teng):
        _add(eng, 24)
        p, n, acc, _ = eng.generate_token_ids()
        _add(eng, 24)
        a, _, _, _ = eng.AR_generate_token_ids()
        outs.append((p, n, [round(sum(x), 5) for x in acc], a))
    assert outs[0] == outs[1]


def test_decode_calls_have_the_bucket_rows(noisy_pair):
    """With no verify cap (the profile's default) the gamma-scan decodes
    each step in one call of the batch bucket's rows: 3 requests in the
    4-row bucket, never padded to b x gamma."""
    gamma = 4
    eng = PearlEngine(_config(tcfg, gamma), *noisy_pair, device="cpu")
    assert eng.config.verify_group_cap == 0
    rows, decode = [], eng.draft.decode_step

    def spy(tokens, *args):
        rows.append(tokens.shape[0])
        return decode(tokens, *args)

    eng.draft.decode_step = spy
    _add(eng, 12, PROMPTS[:3])
    pearl, *_ = eng.generate_token_ids()
    assert rows and set(rows) == {4}
    assert eng.orchestrator.fused.decode_chunking(32, gamma) == (1, 32)
    _add(eng, 12 + 2 * gamma, PROMPTS[:3])
    ar, *_ = eng.AR_generate_token_ids()
    assert all(_verified_equal(p, a, gamma) for p, a in zip(pearl, ar))


def test_draft_noise_perturbs_the_draft_only():
    d, t = _models(tcfg)
    clean_d, clean_t = build_layer_share_pair(d, t, seed=3)
    noisy_d, noisy_t = build_layer_share_pair(d, t, seed=3, draft_noise=NOISE)
    for k in clean_t["layers"]:
        np.testing.assert_array_equal(noisy_t["layers"][k], clean_t["layers"][k])
    for k in ("embed", "final_ln", "lm_head"):
        np.testing.assert_array_equal(noisy_t[k], clean_t[k])
        np.testing.assert_array_equal(noisy_d[k], clean_d[k])
    for k, w in clean_d["layers"].items():
        if w.std() > 0:  # every weight matrix
            assert (noisy_d["layers"][k] != w).mean() > 0.99, k
        else:  # norm weights of ones: noise scale std(w) = 0
            np.testing.assert_array_equal(noisy_d["layers"][k], w)
    assert any(clean_d["layers"][k].std() > 0 for k in clean_d["layers"])
