"""The port's model forward against the JAX package's
``models.transformer.forward`` on the same weights (carried across by
``params_from_numpy``), in f32 on the CPU: logits and KV cache after a
fresh-KV prefill, a decode step, and the packed verify cut into two
sequence chunks (verify_group_cap) with a pre-verify group among them.

Tolerance 1e-4 on logits: f32 throughout, but two layers of GEMMs and
softmaxes summed in another order than XLA's.
"""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nano_pearl_tpu import config as jcfg
from nano_pearl_tpu.models import transformer as jtr
from nano_pearl_tpu.ops import attention as jatt
from nano_pearl_tpu.ops.kv_cache import make_kv_cache
from nano_pearl_tpu_torch import config as tcfg
from nano_pearl_tpu_torch.engine.runner import GroupRunner
from nano_pearl_tpu_torch.engine.sequence import SeqView
from nano_pearl_tpu_torch.models.transformer import init_params_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
BS, NB, GAMMA = 16, 24, 3
PROMPT_LENS = (5, 9, 17, 3)

ARCHS = {
    "llama": dict(architecture="LlamaForCausalLM"),
    "qwen3_bias": dict(architecture="Qwen3ForCausalLM", qk_norm=True, qkv_bias=True),
}


def _model_kwargs(arch):
    return dict(
        hidden_size=256, intermediate_size=384, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=64, vocab_size=300,
        eos_token_id=1, dtype="float32", max_position_embeddings=256, **ARCHS[arch],
    )


def _views(rng):
    views = []
    for i, n in enumerate(PROMPT_LENS):
        v = SeqView(rng.integers(2, 300, n).tolist(), BS)
        v.block_table = list(range(i * 5, i * 5 + 5))
        views.append(v)
    return views


def _jforward(cfg, params, kv, rope, tokens, positions, slots, attn, args):
    hidden, kv = jtr.forward(
        cfg, params, kv, jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(slots),
        rope, attn, args,
    )
    return kv, np.asarray(jtr.compute_logits(cfg, params, hidden))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_decode_verify_match_jax(arch):
    kw = _model_kwargs(arch)
    jm, tm = jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)
    tree = init_params_numpy(tm, np.random.default_rng(0))
    pcfg = tcfg.PearlConfig(
        draft_model=tm, target_model=tm, max_model_len=256, kvcache_block_size=BS,
        num_kvcache_blocks=NB, gamma=GAMMA, verify_group_cap=2,
        prefill_token_buckets=(32, 64), dtype="float32",
    )
    runner = GroupRunner(pcfg, pcfg.target_config, torch.device("cpu"), name="t", params=tree)
    jparams = {k: jnp.asarray(v) for k, v in tree.items() if k != "layers"}
    jparams["layers"] = {k: jnp.asarray(v) for k, v in tree["layers"].items()}
    jrope = jtr.make_rope_table(jm)
    jkv = make_kv_cache(jm.num_hidden_layers, NB, BS, jm.num_key_value_heads, jm.head_dim, jnp.float32)
    scale = jm.head_dim**-0.5
    rng = np.random.default_rng(1)
    views = _views(rng)
    b, lq = len(views), 32

    # --- fresh-KV prefill
    got = runner.prefill(views, lq, b).numpy()
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
    jkv, want = _jforward(
        jm, jparams, jkv, jrope, tokens.reshape(-1), positions.reshape(-1), slots.reshape(-1),
        attn, (None, jnp.asarray(qpos)),
    )
    sel = [i * lq + len(v) - 1 for i, v in enumerate(views)]
    np.testing.assert_allclose(got, want[sel], **TOL)

    # --- one decode step
    for v, t in zip(views, got.argmax(-1)):
        v.append(int(t))
    toks = np.array([v.last_token for v in views], np.int32)
    pos = np.array([len(v) - 1 for v in views], np.int32)
    ctx = pos + 1
    dslots = np.array([v.token_to_slot(len(v) - 1) for v in views], np.int32)
    bt = np.array([v.block_table for v in views], np.int32)
    got = runner.decode_step(*map(torch.from_numpy, (toks, pos, dslots, bt, ctx)))
    jkv, want = _jforward(
        jm, jparams, jkv, jrope, toks, pos, dslots,
        partial(jatt.paged_attention_jnp, scale=scale), (jnp.asarray(bt), jnp.asarray(ctx)),
    )
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    # --- packed verify, two chunks of two groups; group 1 is pre-verify
    vt = np.zeros((b, GAMMA), np.int32)
    vp = np.zeros((b, GAMMA), np.int32)
    vc = np.ones((b, GAMMA), np.int32)
    vs = NB * BS + np.tile(np.arange(GAMMA, dtype=np.int32), (b, 1))
    for i, v in enumerate(views):
        n_in = 1 if i == 1 else GAMMA
        p = np.arange(len(v), len(v) + n_in)
        vt[i, :n_in] = rng.integers(2, 300, n_in)
        vp[i, :n_in], vc[i, :n_in] = p, p + 1
        vs[i, :n_in] = [v.block_table[x // BS] * BS + x % BS for x in p]
    flat = [x.reshape(-1) for x in (vt, vp, vs)]
    got = runner.packed_verify_forward(
        *map(torch.from_numpy, flat), torch.from_numpy(bt), torch.from_numpy(vc.reshape(-1)), GAMMA
    )
    attn = partial(jatt.paged_attention_grouped, scale=scale, rows_per_group=GAMMA, use_pallas=False)
    jkv, want = _jforward(jm, jparams, jkv, jrope, *flat, attn, (jnp.asarray(bt), jnp.asarray(vc.reshape(-1))))
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    # the caches agree outside the garbage block
    np.testing.assert_allclose(runner.kv[:, :, :NB].numpy(), np.asarray(jkv)[:, :, :NB], **TOL)
