"""Port ops vs the JAX package's ops on the same numpy inputs (CPU):
rope (with llama3 and linear scaling), rms_norm, write_kv with garbage
rows, greedy argmax, and verify_verdict (greedy exactly; T>0 with the
uniforms and Gumbel noise reproduced from JAX's key splits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nano_pearl_tpu.models import transformer as jtr
from nano_pearl_tpu.ops import kv_cache as jkv
from nano_pearl_tpu.ops import rope as jrope
from nano_pearl_tpu.ops import sampling as jsamp
from nano_pearl_tpu.ops import verify as jver
from nano_pearl_tpu_torch.models import transformer as ttr
from nano_pearl_tpu_torch.ops import kv_cache as tkv
from nano_pearl_tpu_torch.ops import rope as trope
from nano_pearl_tpu_torch.ops import sampling as tsamp
from nano_pearl_tpu_torch.ops import verify as tver

F32_TOL = dict(rtol=3e-5, atol=3e-5)  # f32: same math, other summation order

LLAMA3 = {
    "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
    "high_freq_factor": 4.0, "original_max_position_embeddings": 64,
}


@pytest.mark.parametrize("scaling", [None, LLAMA3, {"type": "linear", "factor": 4.0}])
def test_rope_table_and_apply(scaling):
    d, max_pos = 64, 512
    want = np.array(jrope.build_rope_table(d, max_pos, 10000.0, scaling))
    got = trope.build_rope_table(d, max_pos, 10000.0, scaling)
    # cos/sin of f32 angles up to max_pos: a few f32 ulps of the angle
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)

    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 4, d)).astype(np.float32)
    pos = rng.integers(0, max_pos, 7)
    jy = jrope.apply_rope(jnp.asarray(x), jnp.asarray(want)[pos])
    ty = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(want)[pos])
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 96)).astype(np.float32) * 3
    w = (1 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jtr.rms_norm(jnp.asarray(x), jnp.asarray(w, jd), 1e-6, out_dtype=jd)
    got = ttr.rms_norm(torch.from_numpy(x), torch.from_numpy(w).to(td), 1e-6, out_dtype=td)
    # bf16: one rounding of the normalised value and one of the product
    tol = F32_TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_write_kv_with_garbage_rows():
    """Real rows land at their slots of the right layer; padded rows all go
    to the garbage block; every other slot is untouched. Exact."""
    rng = np.random.default_rng(2)
    nl, nb, bs, hkv, d = 3, 5, 8, 2, 16
    base = rng.standard_normal((nl, 2, nb + 1, bs, hkv * d)).astype(np.float32)
    n = 6
    k = rng.standard_normal((n, hkv, d)).astype(np.float32)
    v = rng.standard_normal((n, hkv, d)).astype(np.float32)
    slots = np.array([3, 17, 9, 33, nb * bs, nb * bs + 1], np.int32)  # 2 padded rows
    for li in range(nl):
        want = jkv.write_kv(jnp.asarray(base), jnp.asarray(k), jnp.asarray(v), jnp.asarray(slots), li)
        got = tkv.write_kv(
            torch.from_numpy(base.copy()), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(slots), li,
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    gs = tkv.garbage_slots(nb, bs, 10)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(jkv.garbage_slots(nb, bs, 10)))


def test_greedy_first_index_ties_and_mask():
    logits = np.array([[0.0, 3.0, 3.0, 1.0], [5.0, 5.0, 5.0, 5.0], [-1.0, 2.0, 9.0, 9.0]], np.float32)
    want = jsamp.greedy(jsamp.mask_invalid_logits(jnp.asarray(logits), 3))
    got = tsamp.greedy(tsamp.mask_invalid_logits(torch.from_numpy(logits), 3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


def _verdict_inputs(seed, b, g, v):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, g, v)).astype(np.float32) * 3
    argmax = logits.argmax(-1)
    # draft tokens: mostly the argmax, with a first rejection per row at a
    # seeded position (or none)
    tbv = argmax.copy()
    for i in range(b):
        cut = rng.integers(0, g + 1)
        if cut < g:
            tbv[i, cut] = (argmax[i, cut] + 1 + rng.integers(0, v - 1)) % v
    tbv[1, 0] = 1  # an EOS among the window of row 1
    tbv = tbv.astype(np.int32)
    is_pre = rng.random(b) < 0.4
    temps = np.zeros(b, np.float32)
    num_completion = rng.integers(0, 20, b).astype(np.int32)
    max_tokens = np.full(b, 24, np.int32)
    ignore_eos = rng.random(b) < 0.3
    eos = np.array([1, 2], np.int32)
    return logits, tbv, is_pre, temps, num_completion, max_tokens, ignore_eos, eos


def _compare(jres, tres):
    for f in ("acc", "rollout", "revise", "finish", "n_acc"):
        np.testing.assert_array_equal(getattr(tres, f).numpy(), np.asarray(getattr(jres, f)), err_msg=f)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_verify_verdict_greedy_exact(seed):
    """Pre- and post-verify rows, EOS in the window, the max_tokens margin."""
    b, g, v = 9, 5, 50
    args = _verdict_inputs(seed, b, g, v)
    jres = jver.verify_verdict(*map(jnp.asarray, args), jax.random.key(0), g, greedy=True)
    tres = tver.verify_verdict(*map(torch.from_numpy, args), g, greedy=True)
    _compare(jres, tres)
    # the general branch at T=0 (noise gated off) matches too
    jres2 = jver.verify_verdict(*map(jnp.asarray, args), jax.random.key(0), g, greedy=False)
    tres2 = tver.verify_verdict(
        *map(torch.from_numpy, args), g, generator=torch.Generator().manual_seed(0)
    )
    _compare(jres2, tres2)


@pytest.mark.parametrize("seed", [3, 4])
def test_verify_verdict_sampled_with_jax_noise(seed):
    """T>0: the port gets the uniforms and Gumbel noise JAX draws from its
    key splits, and must give the same verdict."""
    b, g, v = 8, 4, 40
    logits, tbv, is_pre, _, num_c, max_t, ign, eos = _verdict_inputs(seed, b, g, v)
    temps = np.array([0.0, 0.7, 1.0, 1.3, 0.0, 0.5, 2.0, 1.0], np.float32)
    key = jax.random.key(seed)
    jres = jver.verify_verdict(
        jnp.asarray(logits), jnp.asarray(tbv), jnp.asarray(is_pre), jnp.asarray(temps),
        jnp.asarray(num_c), jnp.asarray(max_t), jnp.asarray(ign), jnp.asarray(eos), key, g,
    )
    kr, ks = jax.random.split(key)
    r = np.array(jax.random.uniform(kr, (b, g), dtype=jnp.float32))
    u = jax.random.uniform(ks, (b, g, v), dtype=jnp.float32, minval=1e-10, maxval=1.0)
    gumbel = np.array(-jnp.log(-jnp.log(u)))
    tres = tver.verify_verdict(
        *map(torch.from_numpy, (logits, tbv, is_pre, temps, num_c, max_t, ign, eos)), g,
        r=torch.from_numpy(r), gumbel=torch.from_numpy(gumbel),
    )
    _compare(jres, tres)


def test_sample_with_jax_noise():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((6, 30)).astype(np.float32)
    logits[:, 25:] = jsamp.NEG_INF  # masked tail stays unsamplable
    temps = np.array([0.0, 0.5, 1.0, 1.0, 2.0, 0.0], np.float32)
    key = jax.random.key(7)
    want = jsamp.sample(jnp.asarray(logits), jnp.asarray(temps), key)
    u = jax.random.uniform(key, logits.shape, dtype=jnp.float32, minval=1e-10, maxval=1.0)
    gumbel = torch.from_numpy(np.array(-jnp.log(-jnp.log(u))))
    got = tsamp.sample(torch.from_numpy(logits), torch.from_numpy(temps), gumbel=gumbel)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a seeded generator gives a reproducible draw of valid ids
    g1 = tsamp.sample(torch.from_numpy(logits), torch.from_numpy(temps), torch.Generator().manual_seed(1))
    g2 = tsamp.sample(torch.from_numpy(logits), torch.from_numpy(temps), torch.Generator().manual_seed(1))
    assert torch.equal(g1, g2) and bool((g1 < 25).all())
