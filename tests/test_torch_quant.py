"""Weight-only int8/fp8 quantization of the port (ops/quant.py) against
the JAX package's ops/quant.py on the same numpy weights, on the CPU:
the quantized values and scales bit for bit, the products ``mm`` /
``mm_t``, and a 2-layer quantized model's logits against the JAX
forward."""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nano_pearl_tpu import config as jcfg
from nano_pearl_tpu.models import transformer as jtr
from nano_pearl_tpu.ops import attention as jatt
from nano_pearl_tpu.ops import quant as jq
from nano_pearl_tpu.ops.kv_cache import make_kv_cache
from nano_pearl_tpu_torch import config as tcfg
from nano_pearl_tpu_torch.engine.runner import GroupRunner
from nano_pearl_tpu_torch.engine.sequence import SeqView
from nano_pearl_tpu_torch.models.transformer import init_params_numpy
from nano_pearl_tpu_torch.ops import quant as tq

BF16_STEP = 2.0**-7  # one bf16 rounding: at most 2^-8 of the value, 2^-7 between two


def _bytes(x) -> np.ndarray:
    """The stored bytes of a 1-byte JAX array or torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _weight(layout: str) -> tuple[np.ndarray, int]:
    """A stacked [L, in, out] weight (one layer all zero, as the
    layer-share target's pass-through wo/wdown, and one zero output
    channel), or an [out, in] LM head; and its contraction axis."""
    rng = np.random.default_rng(0)
    if layout == "stacked":
        w = rng.standard_normal((3, 256, 384), dtype=np.float32) * np.float32(0.02)
        w[2] = 0.0
        w[0, :, 7] = 0.0
        return w, -2
    return rng.standard_normal((300, 256), dtype=np.float32) * np.float32(0.02), -1


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("layout", ["stacked", "lm_head"])
def test_quantize_matches_jax_bitwise(kind, layout):
    w, axis = _weight(layout)
    want = jq.quantize_weight(jnp.asarray(w), kind, contract_axis=axis)
    got = tq.quantize_weight(torch.from_numpy(w), kind, contract_axis=axis)
    assert got["q"].dtype == tq.quant_storage_dtype(kind)
    np.testing.assert_array_equal(_bytes(got["q"]), _bytes(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    np.testing.assert_array_equal(
        tq.dequantize(got, torch.float32).numpy(), np.asarray(jq.dequantize(want, jnp.float32))
    )


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_mm_matches_jax(kind):
    """bf16 activations against the same quantized weights: both round the
    1-byte product to bf16, then its product with the scale, so the two
    may differ by one bf16 step of the value (rtol 2^-7); atol 2^-7 of the
    largest output covers values near 0, whose roundings follow the f32
    sums' order. f32 activations agree to the f32 sums' order (1e-5). A
    weight of zeros gives exactly 0 (the layer-share pass-through)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, 256), dtype=np.float32)
    for layout, jfn, tfn in (("stacked", jq.mm, tq.mm), ("lm_head", jq.mm_t, tq.mm_t)):
        w, axis = _weight(layout)
        jw = jq.quantize_weight(jnp.asarray(w), kind, contract_axis=axis)
        tw = tq.quantize_weight(torch.from_numpy(w), kind, contract_axis=axis)
        if layout == "stacked":
            jw = {"q": jw["q"][0], "s": jw["s"][0]}
            tw = tq.layer_weight(tw, 0)
        for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            want = np.asarray(jfn(jnp.asarray(x, jdt), jw), np.float32)
            got = tfn(torch.from_numpy(x).to(tdt), tw)
            assert got.dtype == tdt
            if tdt == torch.float32:
                tol = dict(rtol=1e-5, atol=1e-5)
            else:
                tol = dict(rtol=BF16_STEP, atol=BF16_STEP * float(np.abs(want).max()))
            np.testing.assert_allclose(got.float().numpy(), want, **tol)
    tz = tq.layer_weight(tq.quantize_weight(torch.from_numpy(_weight("stacked")[0]), kind), 2)
    assert not tq.mm(torch.from_numpy(x), tz).any()


def _model_kwargs(quant):
    return dict(
        hidden_size=256, intermediate_size=384, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=64, vocab_size=300, eos_token_id=1, dtype="float32",
        max_position_embeddings=256, tie_word_embeddings=False, quant=quant,
    )


@pytest.mark.parametrize("carry", ["int8, quantized at load", "fp8, quantized by JAX"])
def test_quantized_model_matches_jax_forward(carry):
    """A 2-layer f32 model with quantized projections and LM head: the
    port's prefill and decode logits equal the JAX forward's on the same
    numpy weights, which the port either quantizes at load itself (from
    numpy arrays or torch tensors) or is handed already quantized by JAX
    (fp8 bytes carried across). Tolerance
    1e-4: f32 throughout, the quantized weights equal bit for bit, sums in
    another order than XLA's."""
    kind = carry.split(",")[0]
    bs, nb = 16, 24
    jm = jcfg.ModelConfig(**_model_kwargs(kind))
    tm = tcfg.ModelConfig(**_model_kwargs(kind))
    tree = init_params_numpy(tm, np.random.default_rng(0))
    jparams = {k: jnp.asarray(v) for k, v in tree.items() if k != "layers"}
    jparams["layers"] = {k: jnp.asarray(v) for k, v in tree["layers"].items()}
    jparams = _jquant(jparams, kind)
    handed = tree
    if carry.endswith("JAX"):
        handed = {k: (v if k != "lm_head" else _to_numpy(jparams["lm_head"])) for k, v in tree.items()}
        handed["layers"] = {k: _to_numpy(v) for k, v in jparams["layers"].items()}
    pcfg = tcfg.PearlConfig(
        draft_model=tm, target_model=tm, max_model_len=256, kvcache_block_size=bs,
        num_kvcache_blocks=nb, gamma=3, prefill_token_buckets=(32,), dtype="float32",
    )
    runner = GroupRunner(pcfg, pcfg.target_config, torch.device("cpu"), name="t", params=handed)
    for k in tq.QUANTIZED_LAYER_KEYS:
        np.testing.assert_array_equal(_bytes(runner.params["layers"][k]["q"]), _bytes(jparams["layers"][k]["q"]))
    if not carry.endswith("JAX"):  # plain torch tensors handed in are quantized at load too
        as_torch = {k: torch.from_numpy(v) for k, v in tree.items() if k != "layers"}
        as_torch["layers"] = {k: torch.from_numpy(v) for k, v in tree["layers"].items()}
        other = GroupRunner(pcfg, pcfg.target_config, torch.device("cpu"), name="t2", params=as_torch)
        np.testing.assert_array_equal(_bytes(other.params["lm_head"]["q"]), _bytes(jparams["lm_head"]["q"]))
    jrope = jtr.make_rope_table(jm)
    jkv = make_kv_cache(2, nb, bs, 2, 64, jnp.float32)
    rng = np.random.default_rng(1)
    views = []
    for i, n in enumerate((5, 12, 3)):
        v = SeqView(rng.integers(2, 300, n).tolist(), bs)
        v.block_table = [i * 2, i * 2 + 1]
        views.append(v)
    b, lq = len(views), 32
    got = runner.prefill(views, lq, b).numpy()
    tokens = np.zeros((b, lq), np.int32)
    pos = np.zeros((b, lq), np.int32)
    qpos = np.full((b, lq), -1, np.int32)
    slots = np.full((b, lq), nb * bs, np.int32)
    for i, v in enumerate(views):
        n = len(v)
        tokens[i, :n], pos[i, :n], qpos[i, :n] = v.token_ids, np.arange(n), np.arange(n)
        slots[i, :n] = [v.token_to_slot(t) for t in range(n)]
    attn = partial(jatt.prefill_self_attention_jnp, scale=0.125)
    attn.wants_fresh_kv = True
    hidden, jkv = jtr.forward(jm, jparams, jkv, *map(jnp.asarray, (tokens.reshape(-1), pos.reshape(-1),
                              slots.reshape(-1))), jrope, attn, (None, jnp.asarray(qpos)))
    want = np.asarray(jtr.compute_logits(jm, jparams, hidden))
    np.testing.assert_allclose(got, want[[i * lq + len(v) - 1 for i, v in enumerate(views)]], rtol=1e-4, atol=1e-4)

    for v, t in zip(views, got.argmax(-1)):
        v.append(int(t))
    toks = np.array([v.last_token for v in views], np.int32)
    p = np.array([len(v) - 1 for v in views], np.int32)
    ds = np.array([v.token_to_slot(len(v) - 1) for v in views], np.int32)
    bt = np.array([v.block_table for v in views], np.int32)
    got = runner.decode_step(*map(torch.from_numpy, (toks, p, ds, bt, p + 1)))
    hidden, jkv = jtr.forward(jm, jparams, jkv, *map(jnp.asarray, (toks, p, ds)), jrope,
                              partial(jatt.paged_attention_jnp, scale=0.125), (jnp.asarray(bt), jnp.asarray(p + 1)))
    want = np.asarray(jtr.compute_logits(jm, jparams, hidden))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _jquant(params, kind):
    """The JAX runner's load-time quantization (runner.py's _quantize)."""
    layers = dict(params["layers"])
    for k in jq.QUANTIZED_LAYER_KEYS:
        layers[k] = jq.quantize_weight(layers[k], kind)
    return dict(params, layers=layers, lm_head=jq.quantize_weight(params["lm_head"], kind, contract_axis=-1))


def _to_numpy(x):
    if isinstance(x, dict):
        return {k: np.asarray(v) for k, v in x.items()}
    return np.asarray(x)
