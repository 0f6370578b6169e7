"""Fused projections (``ModelConfig.fuse_proj``) in the port, on the CPU, in
f32: the three cases of tests/test_fuse_proj.py on the port's engine (the
fused engine's streams equal the unfused engine's on the same weights, and
its PEARL equals its AR; with qkv bias and q/k norms; with int8 weights,
whose fused leaves stay quantized), the fused weights equal to the JAX
package's ``fuse_projections`` array for array, and the fused forward's
prefill and decode logits equal to JAX's fused forward at rtol/atol 1e-4
(the bound of tests/test_torch_model.py). An MoE model is left unfused, as
in the JAX package. Engine cases run torch on one thread (see
test_torch_kv_quant.py).
"""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nano_pearl_tpu import config as jcfg
from nano_pearl_tpu.models import transformer as jtr
from nano_pearl_tpu.ops import attention as jatt
from nano_pearl_tpu.ops import quant as jquant
from nano_pearl_tpu.ops.kv_cache import make_kv_cache as jmake_kv_cache
from nano_pearl_tpu_torch import ModelConfig, PearlConfig, PearlEngine, SamplingParams
from nano_pearl_tpu_torch.engine.runner import GroupRunner
from nano_pearl_tpu_torch.models import transformer as ttr
from test_torch_kv_quant import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_model import _jforward, _views

TINY = dict(  # tests/helpers.py's tiny_model_config
    architecture="LlamaForCausalLM", hidden_size=64, intermediate_size=128, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, vocab_size=256, eos_token_id=0, dtype="float32",
    max_position_embeddings=512,
)
ENGINE = dict(  # tests/helpers.py's tiny_pearl_config
    max_model_len=256, max_num_batched_tokens=512, kvcache_block_size=16, num_kvcache_blocks=96, gamma=3,
    max_num_seqs=8, prefill_token_buckets=(32, 64, 128, 256, 512), dtype="float32",
)


def _engine(**fields):
    m = ModelConfig(**{**TINY, **fields})
    return PearlEngine(PearlConfig(draft_model=m, target_model=m, **ENGINE), device="cpu")


def _gen(engine, prompts, max_tokens=24, ar=False):
    for prompt in prompts:
        engine.add_request(prompt, SamplingParams(temperature=0.0, max_tokens=max_tokens))
    out, *_ = (engine.AR_generate_token_ids if ar else engine.generate_token_ids)()
    return out


def _prompts(seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 250, rng.integers(4, 12)).tolist() for _ in range(n)]


def test_fuse_proj_matches_separate():
    prompts = _prompts()
    want = _gen(_engine(), prompts)
    eng = _engine(fuse_proj=True)
    layers = eng.target.params["layers"]
    assert {"wqkv", "wgu"} <= set(layers) and not {"wq", "wk", "wv", "wgate", "wup"} & set(layers)
    got = _gen(eng, prompts)
    assert got == want
    assert _gen(eng, prompts, ar=True) == got  # PEARL == AR inside the fused engine


def test_fuse_proj_qkv_bias_qk_norm():
    fields = dict(architecture="Qwen3ForCausalLM", qkv_bias=True, qk_norm=True)
    prompts = _prompts(seed=1)
    want = _gen(_engine(**fields), prompts)
    eng = _engine(**fields, fuse_proj=True)
    assert "bqkv" in eng.target.params["layers"] and "bq" not in eng.target.params["layers"]
    assert _gen(eng, prompts) == want


def test_fuse_proj_quantized():
    prompts = _prompts(seed=2)
    want = _gen(_engine(quant="int8"), prompts)
    eng = _engine(quant="int8", fuse_proj=True)
    layers = eng.target.params["layers"]
    assert set(layers["wqkv"]) == {"q", "s"} and layers["wqkv"]["q"].dtype == torch.int8
    assert _gen(eng, prompts) == want


def test_moe_model_stays_unfused():
    eng = _engine(architecture="Qwen3MoeForCausalLM", num_experts=4, num_experts_per_tok=2,
                  moe_intermediate_size=96, fuse_proj=True)
    assert "wq" in eng.target.params["layers"] and "wgu" not in eng.target.params["layers"]


@pytest.mark.parametrize("quant", [None, "int8"])
def test_fuse_projections_equal_jax(quant):
    cfg = ModelConfig(**{**TINY, "qkv_bias": True})
    tree = ttr.init_params_numpy(cfg, np.random.default_rng(0))
    layers = {k: torch.from_numpy(v) for k, v in tree["layers"].items()}
    jlayers = {k: jnp.asarray(v) for k, v in tree["layers"].items()}
    if quant:
        from nano_pearl_tpu_torch.ops.quant import QUANTIZED_LAYER_KEYS, quantize_weight

        for k in QUANTIZED_LAYER_KEYS:
            layers[k] = quantize_weight(layers[k], quant)
            jlayers[k] = jquant.quantize_weight(jlayers[k], quant)
    got, want = ttr.fuse_projections(layers), jtr.fuse_projections(jlayers)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        parts = w.items() if isinstance(w, dict) else [(None, w)]
        for part, a in parts:
            np.testing.assert_array_equal((got[k][part] if part else got[k]).numpy(), np.asarray(a), err_msg=k)


@pytest.mark.parametrize("arch", ["llama", "qwen3_bias"])
def test_fused_forward_matches_jax(arch):
    """Prefill (fresh KV) and one decode step of the fused port against
    JAX's forward over its own fused layers, the weights of
    tests/test_torch_model.py's configs."""
    bs, nb = 16, 24
    kw = dict(hidden_size=256, intermediate_size=384, num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, head_dim=64, vocab_size=300, eos_token_id=1, dtype="float32",
              max_position_embeddings=256, fuse_proj=True)
    if arch == "qwen3_bias":
        kw.update(architecture="Qwen3ForCausalLM", qk_norm=True, qkv_bias=True)
    jm, tm = jcfg.ModelConfig(**kw), ModelConfig(**kw)
    tree = ttr.init_params_numpy(tm, np.random.default_rng(0))
    pcfg = PearlConfig(draft_model=tm, target_model=tm, max_model_len=256, kvcache_block_size=bs,
                       num_kvcache_blocks=nb, gamma=3, prefill_token_buckets=(32, 64), dtype="float32")
    runner = GroupRunner(pcfg, pcfg.target_config, torch.device("cpu"), name="t", params=tree)
    assert "wqkv" in runner.params["layers"]
    jparams = {k: jnp.asarray(v) for k, v in tree.items() if k != "layers"}
    jparams["layers"] = jtr.fuse_projections({k: jnp.asarray(v) for k, v in tree["layers"].items()})
    jrope = jtr.make_rope_table(jm)
    jkv = jmake_kv_cache(jm.num_hidden_layers, nb, bs, jm.num_key_value_heads, jm.head_dim, jnp.float32)
    scale = jm.head_dim**-0.5
    views = _views(np.random.default_rng(1))
    b, lq = len(views), 32

    got = runner.prefill(views, lq, b).numpy()
    tokens = np.zeros((b, lq), np.int32)
    positions = np.zeros((b, lq), np.int32)
    qpos = np.full((b, lq), -1, np.int32)
    slots = np.full((b, lq), nb * bs, np.int32)
    for i, v in enumerate(views):
        n = len(v)
        tokens[i, :n], positions[i, :n], qpos[i, :n] = v.token_ids, np.arange(n), np.arange(n)
        slots[i, :n] = [v.token_to_slot(t) for t in range(n)]
    attn = partial(jatt.prefill_self_attention_jnp, scale=scale)
    attn.wants_fresh_kv = True
    jkv, want = _jforward(jm, jparams, jkv, jrope, tokens.reshape(-1), positions.reshape(-1), slots.reshape(-1),
                          attn, (None, jnp.asarray(qpos)))
    np.testing.assert_allclose(got, want[[i * lq + len(v) - 1 for i, v in enumerate(views)]], rtol=1e-4, atol=1e-4)

    for v, t in zip(views, got.argmax(-1)):
        v.append(int(t))
    toks = np.array([v.last_token for v in views], np.int32)
    pos = np.array([len(v) - 1 for v in views], np.int32)
    dslots = np.array([v.token_to_slot(len(v) - 1) for v in views], np.int32)
    bt = np.array([v.block_table for v in views], np.int32)
    got = runner.decode_step(*map(torch.from_numpy, (toks, pos, dslots, bt, pos + 1)))
    jkv, want = _jforward(jm, jparams, jkv, jrope, toks, pos, dslots,
                          partial(jatt.paged_attention_jnp, scale=scale), (jnp.asarray(bt), jnp.asarray(pos + 1)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(runner.kv[:, :, :nb].numpy(), np.asarray(jkv)[:, :, :nb], rtol=1e-4, atol=1e-4)
