"""The "throughput" profile's ops: the port's plain versions of kernels K5
(mono-schedule attention), K7 (cache-side partials of the deferred
verify) and K12 (the deferred verify's writeback), and the fresh-window
partials and their merge, against the JAX package's jnp functions and
its Pallas kernels in interpret mode. The hand-written CUDA kernels are
held against these plain versions in tests/test_torch_kernels.py.

Tolerances: f32 1e-5 (same math, other summation order); the writeback
is compared bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nano_pearl_tpu.ops import attention as jatt
from nano_pearl_tpu.ops.kv_cache import write_fresh_jnp, write_fresh_windows
from nano_pearl_tpu.ops.pallas.kv_writeback import write_fresh_pallas
from nano_pearl_tpu.ops.pallas.paged_attention import (
    paged_attention_pallas,
    paged_attention_pallas_grouped_cache_partials,
)
from nano_pearl_tpu_torch.ops import attention as tatt
from nano_pearl_tpu_torch.ops import kv_cache as tkv

F32 = dict(rtol=1e-5, atol=1e-5)
L, NB, BS, HKV, D, HQ = 2, 10, 16, 2, 64, 8


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def _deferred_case(seed, b=3, r=4, ctx0_vals=(20, 9, 33)):
    """Cache, queries, fresh K/V of one layer, disjoint block tables and the
    deferred verify's contexts: staircase groups and, last, a pre-verify
    group (one real row, then padding rows at context 1)."""
    rng = np.random.default_rng(seed)
    cache = rng.standard_normal((L, 2, NB + 1, BS, HKV * D)).astype(np.float32)
    q = rng.standard_normal((b * r, HQ, D)).astype(np.float32)
    fk = rng.standard_normal((b * r, HKV, D)).astype(np.float32)
    fv = rng.standard_normal((b * r, HKV, D)).astype(np.float32)
    bt = (np.arange(b)[:, None] * 3 + np.arange(3)[None, :]).astype(np.int32)
    ctx = np.zeros((b, r), np.int32)
    for i, c0 in enumerate(ctx0_vals):
        ctx[i] = c0 + 1 + np.arange(r)
    ctx[-1] = 1
    ctx[-1, 0] = ctx0_vals[-1] + 1
    return cache, q, fk, fv, bt, ctx.reshape(-1), np.asarray(ctx0_vals, np.int32), D**-0.5


def test_mono_plain_matches_pallas_interpret():
    """K5's plain version (K1's) against the mono kernel with one row per
    group, in interpret mode."""
    rng = np.random.default_rng(0)
    cache = rng.standard_normal((L, 2, NB + 1, BS, HKV * D)).astype(np.float32)
    q = rng.standard_normal((3, HQ, D)).astype(np.float32)
    bt = rng.integers(0, NB, (3, 2)).astype(np.int32)
    ctx = np.array([5, 32, 17], np.int32)
    got = tatt.paged_attention_mono(
        torch.from_numpy(q), torch.from_numpy(cache), 1, torch.from_numpy(bt), torch.from_numpy(ctx), D**-0.5
    )
    kern = paged_attention_pallas(
        *map(jnp.asarray, (q, cache)), 1, jnp.asarray(bt), jnp.asarray(ctx), D**-0.5,
        interpret=True, mono=True,
    )
    np.testing.assert_allclose(_np(got), _np(kern), **F32)


def test_cache_partials_plain_matches_pallas_interpret():
    """K7's plain version against the Pallas kernel in interpret mode:
    o, m and l on live rows, and the floor values (0, -1e29, 0) on a row
    with cache context 0."""
    cache, q, _, _, bt, ctx, ctx0, scale = _deferred_case(1, b=2, r=3, ctx0_vals=(20, 9))
    ctx_cache = np.minimum(ctx, np.repeat(ctx0, 3))
    ctx_cache[1] = 0  # a row with no cache context
    got = tatt.paged_attention_grouped_cache_partials_ref(
        torch.from_numpy(q), torch.from_numpy(cache), 1, torch.from_numpy(bt),
        torch.from_numpy(ctx_cache), scale, 3,
    )
    kern = paged_attention_pallas_grouped_cache_partials(
        jnp.asarray(q), jnp.asarray(cache), 1, jnp.asarray(bt), jnp.asarray(ctx_cache), scale, 3,
        interpret=True,
    )
    live = ctx_cache > 0
    for g, k in zip(got, kern):
        np.testing.assert_allclose(_np(g)[live], _np(k)[live], **F32)
    o, m, l = (_np(x) for x in got)
    assert (o[1] == 0).all() and (m[1] == tatt.M_FLOOR).all() and (l[1] == 0).all()


@pytest.mark.parametrize("seed", [2, 3])
def test_fresh_window_partials_and_merge_match_jax(seed):
    """fresh_window_partials, merge_attn_partials and the merged deferred
    attention against the JAX functions and the one-softmax jnp reference,
    a pre-verify group included."""
    cache, q, fk, fv, bt, ctx, ctx0, scale = _deferred_case(seed)
    r = 4
    t = {k: torch.from_numpy(v) for k, v in dict(cache=cache, q=q, fk=fk, fv=fv, bt=bt, ctx=ctx, ctx0=ctx0).items()}
    j = {k: jnp.asarray(v) for k, v in dict(cache=cache, q=q, fk=fk, fv=fv, bt=bt, ctx=ctx, ctx0=ctx0).items()}
    got_f = tatt.fresh_window_partials(t["q"], t["fk"], t["fv"], t["ctx"], t["ctx0"], scale, r)
    want_f = jatt.fresh_window_partials(j["q"], j["fk"], j["fv"], j["ctx"], j["ctx0"], scale, r)
    for g, w in zip(got_f, want_f):
        np.testing.assert_allclose(_np(g), _np(w), **F32)
    ctx_cache = np.minimum(ctx, np.repeat(ctx0, r))
    got_c = tatt.paged_attention_grouped_cache_partials_ref(
        t["q"], t["cache"], 0, t["bt"], torch.from_numpy(ctx_cache), scale, r
    )
    got_m = tatt.merge_attn_partials(*got_c, *got_f, torch.float32)
    want_m = jatt.merge_attn_partials(
        *(jnp.asarray(_np(x)) for x in got_c), *want_f, jnp.float32
    )
    np.testing.assert_allclose(_np(got_m), _np(want_m), **F32)
    ref = jatt.paged_attention_grouped_fresh_jnp(
        j["q"], j["cache"], 0, j["bt"], j["ctx"], j["ctx0"], j["fk"], j["fv"], scale
    )
    merged = tatt.paged_attention_grouped_fresh(
        t["q"], t["cache"], 0, t["bt"], t["ctx"], t["ctx0"], t["fk"], t["fv"], scale, r
    )
    one_softmax = tatt.paged_attention_grouped_fresh_ref(
        t["q"], t["cache"], 0, t["bt"], t["ctx"], t["ctx0"], t["fk"], t["fv"], scale
    )
    np.testing.assert_allclose(_np(merged), _np(ref), **F32)
    np.testing.assert_allclose(_np(one_softmax), _np(ref), **F32)


def _writeback_case(seed, b=3, r=6):
    """A cache, one round's fresh K/V and the verify's slots: a group whose
    rows cross a page boundary, one inside a page, and a pre-verify group
    whose padding rows share slots of the garbage block with each other."""
    rng = np.random.default_rng(seed)
    hd = HKV * D
    cache = rng.standard_normal((L, 2, NB + 1, BS, hd)).astype(np.float32)
    fresh = rng.standard_normal((L, 2, b * r, hd)).astype(np.float32)
    garbage = NB * BS
    slots = np.concatenate([
        [4 * BS + BS - 2 + i if i < 2 else 7 * BS + i - 2 for i in range(r)],  # crosses 4 -> 7
        2 * BS + 5 + np.arange(r),
        [1 * BS + 9] + [garbage + (i % 2) for i in range(1, r)],  # pads repeat slots
    ]).astype(np.int32)
    real = np.concatenate([np.ones(2 * r, bool), [True], np.zeros(r - 1, bool)])
    return cache, fresh, slots, real


def test_write_fresh_plain_matches_jax():
    """The whole cache bit for bit against write_fresh_jnp (duplicate
    garbage slots included: the last row wins in both); every real slot
    bit for bit against the Pallas writeback in interpret mode and the
    windowed writeback the JAX package runs."""
    cache, fresh, slots, real = _writeback_case(4)
    got = tkv.write_fresh(torch.from_numpy(cache.copy()), torch.from_numpy(fresh), torch.from_numpy(slots))
    jargs = (jnp.asarray(cache), jnp.asarray(fresh), jnp.asarray(slots))
    np.testing.assert_array_equal(got.numpy(), np.asarray(write_fresh_jnp(*jargs)))
    flat = got.numpy().reshape(L, 2, -1, HKV * D)
    for other in (write_fresh_pallas(*jargs, 6, interpret=True), write_fresh_windows(*jargs, 6)):
        o = np.asarray(other).reshape(L, 2, -1, HKV * D)
        np.testing.assert_array_equal(flat[:, :, slots[real]], o[:, :, slots[real]])


def test_write_fresh_equals_per_layer_write_kv():
    """One writeback of the round equals L per-layer write_kv stores of the
    same rows (distinct slots), in place."""
    cache, fresh, slots, real = _writeback_case(5)
    slots, fresh = slots[real], fresh[:, :, real]
    want = torch.from_numpy(cache.copy())
    for li in range(L):
        k = torch.from_numpy(fresh[li, 0]).reshape(-1, HKV, D)
        v = torch.from_numpy(fresh[li, 1]).reshape(-1, HKV, D)
        tkv.write_kv(want, k, v, torch.from_numpy(slots), li)
    got = torch.from_numpy(cache.copy())
    out = tkv.write_fresh_ref(got, torch.from_numpy(fresh), torch.from_numpy(slots))
    assert out is got
    assert torch.equal(got, want)
