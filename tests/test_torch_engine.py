"""The port's engine end to end on the CPU, in f32: PEARL == AR at T=0,
token for token equal to the JAX engine on the same weights, the
layer-share pair at its acceptance ceiling, and the device rule (CUDA
unless the caller asks for the CPU)."""

import numpy as np
import pytest
import torch

import nano_pearl_tpu
from nano_pearl_tpu import config as jcfg
from nano_pearl_tpu_torch import ModelConfig, PearlConfig, PearlEngine, SamplingParams
from nano_pearl_tpu_torch import config as tcfg
from nano_pearl_tpu_torch.models.transformer import init_params_numpy
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
    dtype="float32",
)


def _weights():
    """Independent random draft and target (partial acceptance)."""
    m = ModelConfig(**MODEL)
    return (init_params_numpy(m, np.random.default_rng(10)),
            init_params_numpy(m, np.random.default_rng(11)))


def _config(module, gamma, **over):
    m = module.ModelConfig(**MODEL)
    return module.PearlConfig(draft_model=m, target_model=m, gamma=gamma, **{**ENGINE, **over})


def _add(eng, max_tokens=16, ignore_eos=False):
    for p in PROMPTS:
        eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=max_tokens, ignore_eos=ignore_eos))


@pytest.fixture(scope="module")
def weights():
    return _weights()


@pytest.mark.parametrize("gamma", [1, 3])
def test_pearl_equals_ar_greedy(weights, gamma):
    eng = PearlEngine(_config(tcfg, gamma), *weights, device="cpu")
    _add(eng)
    pearl, n_pearl, acc, _ = eng.generate_token_ids()
    _add(eng)
    ar, n_ar, _, _ = eng.AR_generate_token_ids()
    assert pearl == ar
    assert n_pearl == [16] * len(PROMPTS)
    assert all(len(a) >= 1 for a in acc)


def test_generate_matches_jax_engine(weights):
    """Same weights, same requests: the port's PEARL and AR streams equal
    the JAX engine's, and so do the accepted-token totals."""
    gamma = 3
    dp, tp = weights
    jeng = nano_pearl_tpu.PearlEngine(_config(jcfg, gamma), draft_params=dp, target_params=tp)
    teng = PearlEngine(_config(tcfg, gamma), dp, tp, device="cpu")
    outs = []
    for eng in (jeng, teng):
        _add(eng, max_tokens=20)
        p, n, acc, _ = eng.generate_token_ids()
        _add(eng, max_tokens=20)
        a, _, _, _ = eng.AR_generate_token_ids()
        outs.append((p, n, [round(sum(x), 5) for x in acc], a))
    assert outs[0] == outs[1]


def test_layer_share_pair_accepts_everything():
    """The target repeats the draft and passes the residual through its
    extra layers: at T=0 every round accepts the whole window."""
    d, t = ModelConfig(**MODEL), ModelConfig(**{**MODEL, "num_hidden_layers": 5})
    dp, tp = build_layer_share_pair(d, t, seed=3)
    np.testing.assert_array_equal(tp["layers"]["wq"][:2], dp["layers"]["wq"])
    assert not tp["layers"]["wo"][2:].any() and not tp["layers"]["wdown"][2:].any()
    gamma, steps = 4, 6
    cfg = PearlConfig(draft_model=d, target_model=t, gamma=gamma, **ENGINE)
    eng = PearlEngine(cfg, dp, tp, device="cpu")
    _add(eng, ignore_eos=True)
    _, n, acc, _ = eng.bench_generate(num_pearl_steps=steps)
    # every round commits the whole window: MAT == gamma (bench.py's
    # (n - 1) / steps); the pre-verify round verifies one token of it
    assert n == [1 + steps * gamma] * len(PROMPTS)
    assert [sum(a) for a in acc] == [1 + (steps - 1) * gamma] * len(PROMPTS)
    _add(eng)
    _, n_ar, _, _ = eng.AR_bench_generate(num_steps=5)
    assert n_ar == [6] * len(PROMPTS)


@pytest.mark.parametrize("cap", [2, 16])
def test_decode_calls_have_the_verify_chunks_rows(weights, cap):
    """The draft's gamma-scan decodes in calls of exactly one verify
    chunk's rows (cap x gamma): 12 requests in the 16-row batch bucket run
    as two calls of 8 rows at cap 2 and as one call padded to 64 rows at
    cap 16; PEARL stays == AR."""
    gamma = 4
    eng = PearlEngine(_config(tcfg, gamma, max_num_seqs=16, verify_group_cap=cap), *weights, device="cpu")
    rows, decode = [], eng.draft.decode_step

    def spy(tokens, *args):
        rows.append(tokens.shape[0])
        return decode(tokens, *args)

    eng.draft.decode_step = spy
    for _ in range(3):
        _add(eng)
    pearl, *_ = eng.generate_token_ids()
    for _ in range(3):
        _add(eng)
    ar, *_ = eng.AR_generate_token_ids()
    assert pearl == ar
    assert set(rows) == {cap * gamma}
    assert eng.orchestrator.fused.decode_chunking(16, gamma) == (-(-16 // (cap * gamma)), cap * gamma)


def test_device_rule(weights):
    cfg = _config(tcfg, 2)
    if torch.cuda.is_available():
        assert PearlEngine(cfg, *weights).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PearlEngine(cfg, *weights)
    eng = PearlEngine(cfg, *weights, device="cpu")
    assert eng.target.kv.device.type == "cpu"
    _add(eng, max_tokens=4)
    _, n, _, _ = eng.generate_token_ids()
    assert n == [4] * len(PROMPTS)
