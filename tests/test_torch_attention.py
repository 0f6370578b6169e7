"""Attention: the port's plain versions against the JAX package's jnp
paths and its Pallas kernels run in interpret mode (as
tests/test_pallas_kernels.py runs them). The hand-written CUDA kernels
are held against these plain versions in tests/test_torch_kernels.py.

Tolerances: f32 3e-5 (same math, other summation order); bf16 2e-2 (the
output is rounded to bf16 once, ~3 significant digits). Shapes keep
Hkv * D = 128, the folded width the Pallas db kernels take.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nano_pearl_tpu.ops import attention as jatt
from nano_pearl_tpu.ops.pallas.paged_attention import (
    paged_attention_pallas,
    paged_attention_pallas_grouped,
)
from nano_pearl_tpu.ops.pallas.prefill_attention import prefill_self_attention_pallas
from nano_pearl_tpu_torch.ops import attention as tatt

TOL = {
    "float32": dict(rtol=3e-5, atol=3e-5),
    "bfloat16": dict(rtol=2e-2, atol=2e-2),
}


def _t(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))


def _j(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32), jnp.dtype(dtype))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def _paged_case(seed, n_tables, rows, nl=2, nb=10, bs=16, hq=8, hkv=2, d=64, m=4):
    """Cache, queries, block tables and staircase contexts; pre-verify
    style groups (one real row, padding rows at ctx 1) included."""
    rng = np.random.default_rng(seed)
    cache = rng.standard_normal((nl, 2, nb + 1, bs, hkv * d)).astype(np.float32)
    q = rng.standard_normal((n_tables * rows, hq, d)).astype(np.float32)
    bt = rng.integers(0, nb, (n_tables, m)).astype(np.int32)
    ctx = np.ones((n_tables, rows), np.int32)
    for i in range(n_tables):
        c0 = rng.integers(1, m * bs - rows + 1)
        if rows > 1 and i % 3 == 1:
            ctx[i, 0] = c0  # pre-verify group: the rest is padding
        else:
            ctx[i] = np.arange(c0, c0 + rows)
    return cache, q, bt, ctx.reshape(-1), d**-0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", [0, 1])
def test_paged_decode_plain_vs_jnp(dtype, layer):
    cache, q, bt, ctx, scale = _paged_case(layer, 5, 1)
    got = tatt.paged_attention(_t(q, dtype), _t(cache, dtype), layer, torch.from_numpy(bt), torch.from_numpy(ctx), scale)
    jargs = (_j(q, dtype), _j(cache, dtype), layer, jnp.asarray(bt), jnp.asarray(ctx), scale)
    np.testing.assert_allclose(_f32(got), _f32(jatt.paged_attention_jnp(*jargs)), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [2, 5])
def test_paged_verify_plain_vs_jnp(dtype, rows):
    cache, q, bt, ctx, scale = _paged_case(10 + rows, 4, rows)
    got = tatt.paged_attention_grouped(
        _t(q, dtype), _t(cache, dtype), 1, torch.from_numpy(bt), torch.from_numpy(ctx), scale, rows
    )
    jargs = (_j(q, dtype), _j(cache, dtype), 1, jnp.asarray(bt), jnp.asarray(ctx), scale, rows)
    want = jatt.paged_attention_grouped(*jargs, use_pallas=False)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


def _prefill_case(seed, b=3, lq=24, hq=4, hkv=2, d=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b * lq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b * lq, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b * lq, hkv, d)).astype(np.float32)
    qpos = np.full((b, lq), -1, np.int32)
    for i, n in enumerate(rng.integers(1, lq + 1, b)):
        qpos[i, :n] = np.arange(n)
    qpos[-1] = -1  # a fully padded sequence
    return q, k, v, qpos, d**-0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_self_plain_vs_jnp(dtype):
    q, k, v, qpos, scale = _prefill_case(20)
    got = tatt.prefill_self_attention(
        _t(q, dtype), _t(k, dtype), _t(v, dtype), torch.from_numpy(qpos), scale
    )
    want = jatt.prefill_self_attention_jnp(
        _j(q, dtype), _j(k, dtype), _j(v, dtype), 0, None, jnp.asarray(qpos), scale
    )
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("kernel", ["decode", "verify", "prefill"])
def test_plain_matches_pallas_interpret(kernel):
    """One small f32 case per TPU kernel, run in interpret mode (slow on
    the CPU, hence few grid steps)."""
    f32 = TOL["float32"]
    if kernel == "prefill":
        q, k, v, qpos, scale = _prefill_case(21)
        got = tatt.prefill_self_attention(*map(torch.from_numpy, (q, k, v, qpos)), scale)
        kern = prefill_self_attention_pallas(
            *map(jnp.asarray, (q, k, v)), 0, None, jnp.asarray(qpos), scale, interpret=True
        )
        # the Pallas kernel masks by row index, the plain version by
        # position: they agree on real query rows (padded rows are never read)
        real = qpos.reshape(-1) >= 0
        np.testing.assert_allclose(_f32(got)[real], _f32(kern)[real], **f32)
        return
    rows = 1 if kernel == "decode" else 3
    cache, q, bt, ctx, scale = _paged_case(22, 2, rows, m=2)
    targs = (torch.from_numpy(q), torch.from_numpy(cache), 1, torch.from_numpy(bt), torch.from_numpy(ctx), scale)
    jargs = (jnp.asarray(q), jnp.asarray(cache), 1, jnp.asarray(bt), jnp.asarray(ctx), scale)
    if kernel == "decode":
        got, kern = tatt.paged_attention(*targs), paged_attention_pallas(*jargs, interpret=True)
    else:
        got = tatt.paged_attention_grouped(*targs, rows)
        kern = paged_attention_pallas_grouped(*jargs, rows, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(kern), **f32)
