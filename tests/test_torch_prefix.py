"""Prefix-cache hits and chunked prefill in the port, held against the
JAX package on the CPU: the plain version of kernel K4 against
``prefill_prefix_attention_jnp`` and the Pallas kernel in interpret mode,
the runner's prefix prefill against the JAX runner's (a within-batch
shared block included), chunked prefill against unchunked and against
the JAX engine, and the KV split of a shared card.

Tolerances: f32 3e-5 for attention (same math, another summation order)
and 1e-4 for logits after a 2-layer forward; token streams exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nano_pearl_tpu
from nano_pearl_tpu import config as jcfg
from nano_pearl_tpu.engine.sequence import SeqView as JSeqView
from nano_pearl_tpu.ops import attention as jatt
from nano_pearl_tpu.ops.pallas.prefill_attention import prefill_prefix_attention_pallas
from nano_pearl_tpu_torch import PearlEngine, SamplingParams
from nano_pearl_tpu_torch import config as tcfg
from nano_pearl_tpu_torch.engine import runner as trunner
from nano_pearl_tpu_torch.engine.sequence import SeqView
from nano_pearl_tpu_torch.models.transformer import init_params_numpy
from nano_pearl_tpu_torch.ops import attention as tatt

ATOL = dict(rtol=3e-5, atol=3e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
BS = 16
MODEL = dict(
    hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=8,
    num_key_value_heads=2, head_dim=64, vocab_size=256, eos_token_id=0, dtype="float32",
    max_position_embeddings=512,
)


def _config(module, budget=512, **over):
    m = module.ModelConfig(**MODEL)
    base = dict(
        max_model_len=256, max_num_batched_tokens=budget, kvcache_block_size=BS,
        num_kvcache_blocks=96, gamma=3, max_num_seqs=8,
        prefill_token_buckets=(32, 64, 128, 256), dtype="float32",
    )
    return module.PearlConfig(draft_model=m, target_model=m, **{**base, **over})


@pytest.fixture(scope="module")
def weights():
    m = tcfg.ModelConfig(**MODEL)
    return (init_params_numpy(m, np.random.default_rng(30)),
            init_params_numpy(m, np.random.default_rng(31)))


def _prefix_case(seed, b=3, lq=20, hq=8, hkv=2, d=64, nl=2, nb=8):
    """The JAX package's own kernel case (tests/test_pallas_kernels.py):
    a filled cache, three sequences with 40 / 0 / 33 cached tokens and
    20 / 12 / 0 new rows."""
    rng = np.random.default_rng(seed)
    cache = np.zeros((nl, 2, nb + 1, BS, hkv * d), np.float32)
    cache[:, :, :6] = rng.standard_normal((nl, 2, 6, BS, hkv * d)).astype(np.float32)
    bt = (rng.permutation(9) % 6).reshape(b, 3).astype(np.int32)
    nc = np.array([40, 0, 33], np.int32)
    nn = np.array([20, 12, 0], np.int32)
    q = rng.standard_normal((b * lq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b * lq, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b * lq, hkv, d)).astype(np.float32)
    qpos = np.full((b, lq), -1, np.int32)
    for i in range(b):
        qpos[i, : nn[i]] = nc[i] + np.arange(nn[i])
    return q, k, v, cache, bt, nc, nn, qpos, d**-0.5


def _port_prefix(case, layer):
    q, k, v, cache, bt, nc, nn, _, scale = case
    return tatt.prefill_prefix_attention(
        *map(torch.from_numpy, (q, k, v, cache)), layer, *map(torch.from_numpy, (bt, nc, nn)), scale
    ).numpy()


@pytest.mark.parametrize("layer", [0, 1])
def test_prefix_plain_vs_jnp(layer):
    case = _prefix_case(40)
    q, k, v, cache, bt, nc, nn, qpos, scale = case
    pk, pv = jatt.gather_prefix_kv(jnp.asarray(cache), jnp.asarray(bt), q.shape[-1])
    want = np.asarray(jatt.prefill_prefix_attention_jnp(
        *map(jnp.asarray, (q, k, v)), layer, pk, pv, jnp.asarray(nc), jnp.asarray(qpos), scale
    ))
    got = _port_prefix(case, layer)
    np.testing.assert_allclose(got, want, **ATOL)  # padded rows: 0 in both


def test_prefix_plain_vs_pallas_interpret():
    case = _prefix_case(41)
    q, k, v, cache, bt, nc, nn, qpos, scale = case
    kern = np.asarray(prefill_prefix_attention_pallas(
        *map(jnp.asarray, (q, k, v, cache)), 1, *map(jnp.asarray, (bt, nc, nn, qpos)), scale,
        interpret=True,
    ))
    real = qpos.reshape(-1) >= 0  # the Pallas kernel gives padded rows the prefix
    np.testing.assert_allclose(_port_prefix(case, 1)[real], kern[real], **ATOL)


def _views(module, specs):
    """SeqViews of the given (tokens, block table, cached tokens)."""
    out = []
    for toks, table, cached in specs:
        v = module(list(toks), BS)
        v.block_table, v.num_cached_tokens = list(table), cached
        out.append(v)
    return out


def test_runner_prefix_prefill_matches_jax(weights):
    """A fresh prefill, then a batch with a prefix-cache hit next to a fresh
    sequence (the JAX runner's pre-gathered prefix path), then a batch
    whose cached block is written by another sequence of the same batch
    (its cache-reading path; the port runs K4 for both)."""
    rng = np.random.default_rng(42)
    a = rng.integers(2, 250, 40).tolist()
    e = rng.integers(2, 250, 30).tolist()
    d = rng.integers(2, 250, 36).tolist()
    batches = [
        [(a, [0, 1, 2], 0)],
        [(a[:32] + rng.integers(2, 250, 10).tolist(), [0, 1, 3], 32), (e, [8, 9], 0)],
        [(d, [4, 5, 6], 0), (d[:16] + rng.integers(2, 250, 5).tolist(), [4, 7], 16)],
    ]
    jeng = nano_pearl_tpu.PearlEngine(_config(jcfg), draft_params=weights[0], target_params=weights[1])
    trun = trunner.GroupRunner(
        _config(tcfg), _config(tcfg).target_config, torch.device("cpu"), name="t",
        params=weights[1],
    )
    for specs in batches:
        jv, tv = _views(JSeqView, specs), _views(SeqView, specs)
        fresh = all(s[2] == 0 for s in specs)
        want = np.asarray(jeng.target.prefill(jv, 64, 4, 4, fresh_only=fresh))
        got = trun.prefill(tv, 64, 4).numpy()
        np.testing.assert_allclose(got[: len(specs)], want[: len(specs)], **LOGITS)
    np.testing.assert_allclose(
        trun.kv[:, :, :10].numpy(), np.asarray(jeng.target.kv)[:, :, :10], **LOGITS
    )


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, 250, n).tolist()


def _run(eng, prompts, max_tokens, ar=False):
    for p in prompts:
        eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=max_tokens))
    out, *_ = eng.AR_generate_token_ids() if ar else eng.generate_token_ids()
    return out


@pytest.mark.parametrize("case", ["single", "mixed", "non_multiple_budget"])
def test_chunked_prefill_matches_unchunked(weights, case):
    """Budget 48 (3-block chunks; 50 for the non-multiple case): a 150-token
    prompt prefills as 48/48/48 + 6; outputs equal an unconstrained
    engine's, and PEARL equals AR."""
    prompts, budget = {
        "single": ([_prompt(150, 7)], 48),
        "mixed": ([_prompt(150, 1), _prompt(20, 2), _prompt(9, 3)], 48),
        "non_multiple_budget": ([_prompt(49, 11), _prompt(1, 12), _prompt(150, 13)], 50),
    }[case]
    outs = {}
    for b in (512, budget):
        eng = PearlEngine(_config(tcfg, b), *weights, device="cpu")
        outs[b] = _run(eng, prompts, 16)
        assert outs[b] == _run(eng, prompts, 16, ar=True)
        if b == budget:
            assert eng.orchestrator.chunked_passes > 0
    assert outs[budget] == outs[512]


def test_chunked_prefill_with_prefix_cache(weights):
    """A request sharing the chunked prompt's first 64 tokens hits the
    prefix cache and decodes as it would alone."""
    base = _prompt(150, 5)
    follow = base[:64] + _prompt(10, 6)
    eng = PearlEngine(_config(tcfg, 48), *weights, device="cpu")
    eng.submit(base, SamplingParams(temperature=0.0, max_tokens=8))
    while eng.has_work:
        eng.serve_step(2)
    sid = eng.submit(follow, SamplingParams(temperature=0.0, max_tokens=8))
    got = {}
    while eng.has_work:
        got.update({s: t for s, t, _ in eng.serve_step(2)})
    assert eng.stats()["prefix_hit_tokens"] == 64
    alone = PearlEngine(_config(tcfg, 512), *weights, device="cpu")
    assert [got[sid]] == _run(alone, [follow], 8)


def test_chunked_prefill_matches_jax_engine(weights):
    prompts = [_prompt(150, 21), _prompt(20, 22)]
    jeng = nano_pearl_tpu.PearlEngine(_config(jcfg, 48), draft_params=weights[0], target_params=weights[1])
    teng = PearlEngine(_config(tcfg, 48), *weights, device="cpu")
    assert _run(teng, prompts, 12) == _run(jeng, prompts, 12)


def test_kv_pools_split_one_budget(weights, monkeypatch):
    """num_kvcache_blocks=-1 on a shared card: both pools get
    budget // (draft block bytes + target block bytes) blocks."""
    assert trunner.kv_num_blocks(_config(tcfg), [1, 2], None) == 96  # a fixed pool
    cfg = _config(tcfg, num_kvcache_blocks=-1)
    assert trunner.kv_num_blocks(cfg, [100, 300], None) == trunner._DEFAULT_CPU_BLOCKS
    assert trunner.kv_num_blocks(cfg, [100, 300], 10_000) == 25
    with pytest.raises(RuntimeError, match="not enough device memory"):
        trunner.kv_num_blocks(cfg, [100, 300], 399)
    target = tcfg.ModelConfig(**{**MODEL, "num_hidden_layers": 5})
    cfg = tcfg.PearlConfig(
        draft_model=tcfg.ModelConfig(**MODEL), target_model=target, gamma=3,
        max_model_len=256, kvcache_block_size=BS, num_kvcache_blocks=-1, dtype="float32",
    )
    budget = 3_000_000
    monkeypatch.setattr(trunner, "device_kv_budget", lambda device, util: budget)
    eng = PearlEngine(cfg, device="cpu")
    per_block = eng.draft.block_bytes + eng.target.block_bytes
    assert per_block == (2 + 5) * 2 * BS * 2 * 64 * 4
    assert eng.draft.num_blocks == eng.target.num_blocks == budget // per_block
    assert eng.scheduler.target_bm.num_blocks == budget // per_block
