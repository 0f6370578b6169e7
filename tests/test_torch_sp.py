"""Sequence parallelism in the port against the JAX package on the CPU.

The JAX package's sp functions run on a ``(sp=2, tp=1)`` mesh of the
suite's virtual CPU devices (tests/conftest.py), at tests/test_sp.py's
small shapes; the port's run their CPU paths: the plain versions of the
per-shard partials kernels K11a-d plus the cross-shard merge. The JAX
side's jnp path is its own reference here (no interpret-mode Pallas).

- ``sp_write_kv``: bit for bit over an f32 and an int8 cache (values and
  the scales against JAX's strided scale columns), slots in both shards
  and in the garbage block;
- decode and packed-verify attention merged over both shards against
  JAX's ``sp_paged_attention`` / ``sp_paged_attention_grouped``: 1e-5 in
  f32, 3e-3 over int8 (tests/test_sp.py's tolerances), with rows whose
  context lies in one shard only and a row of context 1;
- the K11 plain versions' per-shard (o, m, l) against a direct softmax over
  the shard's visible keys; rows with no visible key give (0, -1e29, 0)
  exactly;
- ``sp_prefill_attention`` against JAX's, a cached prefix spanning both
  shards;
- the engine in f32: the port's greedy streams under ``draft_sp =
  target_sp = 2`` equal its unsharded streams and the JAX engine's sp
  streams, also behind prefix-cache hits; PEARL == AR under sp, also over
  an int8 cache; the block-count
  rounding; the KV budget shared by the shards of one device; the
  throughput profile's gates under sp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import nano_pearl_tpu
from nano_pearl_tpu import config as jcfg
from nano_pearl_tpu.ops import kv_cache as jkv
from nano_pearl_tpu.parallel import sp as jsp
from nano_pearl_tpu_torch import config as tcfg
from nano_pearl_tpu_torch import PearlEngine, SamplingParams
from nano_pearl_tpu_torch.engine import runner as runner_mod
from nano_pearl_tpu_torch.models.transformer import init_params_numpy
from nano_pearl_tpu_torch.ops import attention as tatt
from nano_pearl_tpu_torch.ops import kv_cache as tkv
from nano_pearl_tpu_torch.parallel import sp as tsp

L, NB, BS, HKV, HQ, D = 2, 7, 4, 2, 4, 16  # NB + 1 = 8 divides over sp = 2
NB1 = (NB + 1) // 2
SCALE = D**-0.5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: under the suite's parallel workers torch's
    spinning thread pool oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh():
    return Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("sp", "tp"))


def _spec(quant):
    s = P(None, None, "sp", None, "tp")
    return {"q": s, "s": s} if quant else s


def _shard(mesh, cache, quant):
    spec = _spec(quant)
    return jax.device_put(cache, jax.tree.map(lambda s: NamedSharding(mesh, s), spec,
                                              is_leaf=lambda x: isinstance(x, P)))


def _to_port(jc, quant) -> tkv.ShardedKVCache:
    """A JAX global cache (f32, or int8 with strided scales) as the port's
    two-shard cache with the same content."""
    cache = tkv.make_sharded_kv_cache(L, NB, BS, HKV, D, 2, dtype=torch.float32, quant=quant)
    if quant:
        q = torch.from_numpy(np.asarray(jc["q"]).copy())
        stride = jc["s"].shape[-1] // HKV
        s = torch.from_numpy(np.asarray(jc["s"])[..., ::stride].view(np.int16).copy()).view(torch.bfloat16)
        for i, shard in enumerate(cache.shards):
            shard.q.copy_(q[:, :, i * NB1 : (i + 1) * NB1])
            shard.s.copy_(s[:, :, i * NB1 : (i + 1) * NB1])
    else:
        full = torch.from_numpy(np.asarray(jc).copy())
        for i, shard in enumerate(cache.shards):
            shard.copy_(full[:, :, i * NB1 : (i + 1) * NB1])
    return cache


def _filled(quant, seed=0):
    """A JAX cache with every slot of both layers written (f32 rows, or int8
    through write_kv), and the port's two-shard copy."""
    rng = np.random.default_rng(seed)
    jc = jkv.make_kv_cache(L, NB, BS, HKV, D, quant=quant, dtype=jnp.float32)
    n = (NB + 1) * BS
    write = jax.jit(jkv.write_kv)
    for li in range(L):
        k = rng.standard_normal((n, HKV, D)).astype(np.float32) * rng.uniform(0.2, 3, (n, HKV, 1))
        v = rng.standard_normal((n, HKV, D)).astype(np.float32)
        jc = write(jc, jnp.asarray(k), jnp.asarray(v), jnp.arange(n, dtype=jnp.int32), jnp.int32(li))
    return jc, _to_port(jc, quant)


def _shards_equal(cache: tkv.ShardedKVCache, jc, quant) -> None:
    want = _to_port(jc, quant)
    for got, ref in zip(cache.shards, want.shards):
        if quant:
            np.testing.assert_array_equal(got.q.numpy(), ref.q.numpy())
            np.testing.assert_array_equal(got.s.view(torch.int16).numpy(), ref.s.view(torch.int16).numpy())
        else:
            np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize("quant", [None, "int8"])
def test_sp_write_kv_matches_jax(quant):
    """Rows whose slots fall in shard 0, in shard 1 and in the garbage
    block (global block NB, the last shard's last block): the shards equal
    JAX's sharded cache bit for bit after writes to both layers, and the
    sink rows never reach a shard."""
    mesh = _mesh()
    rng = np.random.default_rng(3)
    jc = jkv.make_kv_cache(L, NB, BS, HKV, D, quant=quant, dtype=jnp.float32)
    jsh = _shard(mesh, jc, quant)
    tc = tkv.make_sharded_kv_cache(L, NB, BS, HKV, D, 2, dtype=torch.float32, quant=quant)
    slots = np.array([0, 5, 13, 17, 25, NB * BS + 1, NB * BS + 3, 30], np.int32)
    write = jax.jit(lambda c, k, v, s, li: jsp.sp_write_kv(mesh, c, k, v, s, li))  # one compile, both layers
    for li in range(L):
        k = rng.standard_normal((len(slots), HKV, D)).astype(np.float32)
        v = rng.standard_normal((len(slots), HKV, D)).astype(np.float32)
        jsh = write(jsh, jnp.asarray(k), jnp.asarray(v), jnp.asarray(slots), jnp.int32(li))
        out = tsp.sp_write_kv(tc, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(slots), li)
        assert out is tc
    _shards_equal(tc, jax.device_get(jsh), quant)


def _cases(rng):
    """Decode rows (tables of global ids, contexts): a row whose context
    lies in shard 0 only, one in shard 1 only, rows across both, a ctx-1
    row."""
    bt = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [1, 6, 0, 5], [7, 2, 4, 3], [5, 0, 6, 1]], np.int32)
    ctx = np.array([13, 9, 16, 14, 1], np.int32)
    q = rng.standard_normal((len(ctx), HQ, D)).astype(np.float32)
    return q, bt, ctx


@pytest.mark.parametrize("quant", [None, "int8"])
def test_sp_decode_attention_matches_jax(quant):
    jc, tc = _filled(quant)
    mesh = _mesh()
    q, bt, ctx = _cases(np.random.default_rng(4))
    want = jsp.sp_paged_attention(mesh, jnp.asarray(q), _shard(mesh, jc, quant), jnp.int32(1),
                                  jnp.asarray(bt), jnp.asarray(ctx), SCALE)
    got = tsp.sp_paged_attention(torch.from_numpy(q), tc, 1, torch.from_numpy(bt), torch.from_numpy(ctx),
                                 SCALE)
    tol = 1e-5 if quant is None else 3e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_sp_grouped_attention_matches_jax(quant):
    """Three groups of three staircase rows: one whose context is in shard
    0 only, one across both shards, one in shard 1 only starting at ctx 1."""
    jc, tc = _filled(quant)
    mesh = _mesh()
    rng = np.random.default_rng(5)
    r = 3
    gt = np.array([[0, 1, 2, 3], [1, 6, 0, 5], [7, 4, 5, 6]], np.int32)
    ctx = np.array([4, 5, 6, 9, 10, 11, 1, 2, 3], np.int32)
    q = rng.standard_normal((len(ctx), HQ, D)).astype(np.float32)
    want = jsp.sp_paged_attention_grouped(mesh, jnp.asarray(q), _shard(mesh, jc, quant), jnp.int32(1),
                                          jnp.asarray(gt), jnp.asarray(ctx), SCALE, rows_per_group=r)
    got = tsp.sp_paged_attention_grouped(torch.from_numpy(q), tc, 1, torch.from_numpy(gt),
                                         torch.from_numpy(ctx), SCALE, r)
    tol = 1e-5 if quant is None else 3e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    # the verify's rows equal the decode of each row with its group's table
    rows = tsp.sp_paged_attention(torch.from_numpy(q), tc, 1, torch.from_numpy(np.repeat(gt, r, 0)),
                                  torch.from_numpy(ctx), SCALE)
    assert torch.equal(rows, got)


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("rows", [1, 3])
def test_k11_plain_partials_match_a_direct_softmax(quant, rows):
    """Per shard, (o, m, l) of the K11 plain versions against a softmax over
    exactly the shard's visible keys, computed key by key; a row with no
    visible key in the shard gives o = 0, m = -1e29, l = 0 exactly."""
    _, tc = _filled(quant, seed=6)
    rng = np.random.default_rng(7)
    gt = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7], [1, 6, 0, 5]], dtype=torch.int32)
    ctx = torch.tensor([[13, 9, 16][g] - (rows - 1 - i) for g in range(3) for i in range(rows)], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((3 * rows, HQ, D)).astype(np.float32))
    for s, ((local, is_local), shard) in enumerate(zip(tsp.shard_tables(gt, tc), tc.shards)):
        if rows == 1:
            o, m, l = tatt.paged_attention_partials_ref(q, shard, 1, local, ctx, is_local, SCALE)  # noqa: E741
        else:
            o, m, l = tatt.paged_attention_grouped_partials_ref(  # noqa: E741
                q, shard, 1, local, ctx, is_local, SCALE, rows)
        k, v = tatt._gather_kv(shard, 1, local, D, q.dtype)  # [B, S, Hkv, D]
        for row in range(3 * rows):
            grp = row // rows
            keys = [p for p in range(int(ctx[row])) if is_local[grp, p // BS]]
            for h in range(HQ):
                kh = h // (HQ // HKV)
                if not keys:
                    assert m[row, h] == tatt.M_FLOOR and l[row, h] == 0  # M_FLOOR in f32
                    assert not o[row, h].any()
                    continue
                sc = torch.stack([q[row, h] @ k[grp, p, kh] for p in keys]) * SCALE
                p = torch.exp(sc - sc.max())
                want_o = (p[:, None] * v[grp, keys, kh]).sum(0) / p.sum()
                torch.testing.assert_close(m[row, h], sc.max(), rtol=1e-6, atol=1e-6)
                torch.testing.assert_close(l[row, h], p.sum(), rtol=1e-5, atol=1e-5)
                torch.testing.assert_close(o[row, h], want_o, rtol=1e-5, atol=1e-5)
        if s == 1:  # shard 1 holds none of group 0's blocks
            assert (m[:rows] == tatt.M_FLOOR).all() and not l[:rows].any()


def test_sp_prefill_attention_matches_jax():
    """Two sequences: one whose cached prefix spans both shards' blocks with
    new rows after it, one fresh and ragged (padded rows at -1)."""
    jc, tc = _filled(None, seed=8)
    mesh = _mesh()
    rng = np.random.default_rng(9)
    b, lq = 2, 4
    bt = np.array([[1, 6, 2, 5], [4, 0, 7, 3]], np.int32)
    q_pos = np.array([[10, 11, 12, 13], [0, 1, -1, -1]], np.int32)
    q = rng.standard_normal((b * lq, HQ, D)).astype(np.float32)
    want = jsp.sp_prefill_attention(mesh, jnp.asarray(q), _shard(mesh, jc, None), jnp.int32(0),
                                    jnp.asarray(bt), jnp.asarray(q_pos), SCALE)
    got = tsp.sp_prefill_attention(torch.from_numpy(q), tc, 0, torch.from_numpy(bt), torch.from_numpy(q_pos),
                                   SCALE)
    valid = q_pos.reshape(-1) >= 0
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], rtol=1e-5, atol=1e-5)
    assert not got[torch.from_numpy(~valid)].any()


# ---------------------------------------------------------------- engine

MODEL = dict(
    architecture="LlamaForCausalLM", hidden_size=64, intermediate_size=128, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, vocab_size=256, eos_token_id=0, dtype="float32",
    max_position_embeddings=512,
)
# 8-token blocks and 23 blocks (12 per shard): the four requests' blocks
# reach into the second shard
ENGINE = dict(
    max_model_len=128, max_num_batched_tokens=512, kvcache_block_size=8, num_kvcache_blocks=23,
    gamma=3, max_num_seqs=8, prefill_token_buckets=(32, 64, 128), dtype="float32",
)
PROMPTS = [[3, 4, 5, 6, 7], [9, 8, 7], [100, 101, 102, 103, 104, 105, 106], [42]]
SP = dict(draft_sp=2, target_sp=2)


def _config(module, **over):
    m = module.ModelConfig(**MODEL)
    return module.PearlConfig(draft_model=m, target_model=m, **{**ENGINE, **over})


def _run(eng, ar=False, max_tokens=20):
    for p in PROMPTS:
        eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=max_tokens))
    out, n, acc, _ = eng.AR_generate_token_ids() if ar else eng.generate_token_ids()
    return out, n, None if acc is None else [round(sum(a), 5) for a in acc]


@pytest.fixture(scope="module")
def weights():
    m = tcfg.ModelConfig(**MODEL)
    return init_params_numpy(m, np.random.default_rng(20)), init_params_numpy(m, np.random.default_rng(21))


@pytest.fixture(scope="module")
def jax_sp_streams(weights):
    """The JAX engine's PEARL and AR streams under draft_sp = target_sp = 2,
    shared by the tests below."""
    eng = nano_pearl_tpu.PearlEngine(_config(jcfg, **SP), draft_params=weights[0], target_params=weights[1])
    return _run(eng), _run(eng, ar=True)


def test_sp_engine_matches_unsharded_and_jax(weights, jax_sp_streams):
    """Independent draft and target (rounds reject and roll back): the
    port's sp streams == its unsharded streams == the JAX engine's sp
    streams, PEARL == AR; the cache is sharded and both shards were
    written."""
    eng = PearlEngine(_config(tcfg, **SP), *weights, device="cpu")
    assert isinstance(eng.target.kv, tkv.ShardedKVCache) and eng.target.kv.sp_size == 2
    sp_pearl, sp_ar = _run(eng), _run(eng, ar=True)
    for shard in eng.target.kv.shards:
        assert shard.abs().sum() > 0
    base = PearlEngine(_config(tcfg), *weights, device="cpu")
    assert (sp_pearl, sp_ar) == (_run(base), _run(base, ar=True))
    assert (sp_pearl, sp_ar) == jax_sp_streams
    assert sp_pearl[0] == sp_ar[0]


def test_sp_engine_prefix_hits_match_unsharded(weights):
    """Requests behind a cached 20-token prefix (two full 8-token blocks
    per request hit): under sp their prefill reads the prefix out of the
    sharded cache (``sp_prefill_attention``), and the streams equal the
    unsharded engine's."""
    prefix = list(range(10, 30))

    def run(**over):
        eng = PearlEngine(_config(tcfg, **over), *weights, device="cpu")
        eng.add_request(prefix + [5], SamplingParams(temperature=0.0, max_tokens=8))
        first = eng.generate_token_ids()[0]
        for t in (6, 7, 8):
            eng.add_request(prefix + [t], SamplingParams(temperature=0.0, max_tokens=12))
        return first, eng.generate_token_ids()[0], eng.orchestrator.prefix_hit_tokens

    sharded = run(**SP)
    assert sharded[2] > 0
    assert sharded == run()


def test_sp_pools_place_each_page_in_the_same_shard(weights):
    """After an AR run (it takes target blocks only, so the pools' free
    lists part ways) a PEARL run still puts every page of a sequence in the
    same shard of both pools, page i in shard i % 2 while it has room: the
    split of each row's keys over the shards, and so the merge's rounding,
    is the same for the draft's decode and the target's verify."""
    eng = PearlEngine(_config(tcfg, **SP), *weights, device="cpu")
    _run(eng, ar=True)
    tables, clear = [], eng.scheduler.clear

    def snapshot():
        tables.extend((list(s.draft.block_table), list(s.target.block_table)) for s in eng.scheduler.running)
        clear()

    eng.scheduler.clear = snapshot
    for p in PROMPTS:
        eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=20))
    eng.bench_generate(num_pearl_steps=5)
    nb1 = eng.target.kv.nb1_local
    assert tables and any(d != t for d, t in tables)  # other block ids ...
    for d, t in tables:  # ... in the same shards, striped
        assert [b // nb1 for b in d] == [b // nb1 for b in t] == [i % 2 for i in range(len(t))]


def test_sp_engine_pearl_equals_ar_over_int8(weights):
    """PEARL == AR under sp over an int8 KV cache (both models)."""
    eng = PearlEngine(_config(tcfg, **SP, draft_kv_quant="int8", target_kv_quant="int8"), *weights, device="cpu")
    assert tkv.cache_is_quantized(eng.target.kv) and isinstance(eng.target.kv, tkv.ShardedKVCache)
    assert _run(eng)[0] == _run(eng, ar=True)[0]


def test_group_placements_follow_jax():
    """``build_group_placements`` places as the JAX package's
    ``build_group_meshes``: disjoint groups when the devices suffice, else
    round-robin (draft from device 0, target after it)."""
    from nano_pearl_tpu.parallel.mesh import build_group_meshes
    from nano_pearl_tpu_torch.parallel.mesh import build_group_placements

    devs = [torch.device("cpu", i) for i in range(3)]
    for d_sp, t_sp in ((2, 1), (2, 2), (1, 1)):
        draft, target = build_group_placements(devs, draft_sp=d_sp, target_sp=t_sp)
        jd, jt = build_group_meshes(1, 1, jax.devices()[:3], draft_sp=d_sp, target_sp=t_sp)
        assert [d.index for d in draft.devices] == [d.id for d in jd.mesh.devices.flat]
        assert [d.index for d in target.devices] == [d.id for d in jt.mesh.devices.flat]
        assert (draft.sp_size, target.sp_size) == (d_sp, t_sp)
    draft, target = build_group_placements(devs[:1], draft_sp=2, target_sp=2)
    assert draft.distinct_devices == target.distinct_devices == (devs[0],)


def test_sp_block_count_rounding():
    """The blocks plus the garbage block divide over sp, rounded down as
    the JAX package's runner rounds them."""
    assert [runner_mod.sp_num_blocks(n, 2) for n in (95, 96, 23, 1)] == [95, 95, 23, 1]
    assert [runner_mod.sp_num_blocks(n, 4) for n in (95, 96, 98, 2)] == [95, 95, 95, 3]
    assert runner_mod.sp_num_blocks(96, 1) == 96
    eng = PearlEngine(_config(tcfg, **SP, num_kvcache_blocks=24), device="cpu")
    assert eng.draft.num_blocks == eng.target.num_blocks == 23
    assert eng.target.kv.nb1_local == 12 and eng.target.kv.shape[2] == 24


def test_sp_shards_share_one_devices_budget(monkeypatch, weights):
    """Shards on one device share its budget: the sharded pools hold the
    unsharded pools' blocks (rounded for sp), not sp times as many, and
    their bytes stay within the budget plus the garbage block and the
    sinks."""
    budget = 2 * 2**20
    monkeypatch.setattr(runner_mod, "device_kv_budget", lambda dev, util: budget)
    base = PearlEngine(_config(tcfg, num_kvcache_blocks=-1), *weights, device="cpu")
    sharded = PearlEngine(_config(tcfg, **SP, num_kvcache_blocks=-1), *weights, device="cpu")
    assert sharded.target.num_blocks == runner_mod.sp_num_blocks(base.target.num_blocks, 2)
    per_block = base.draft.block_bytes + base.target.block_bytes
    total = tkv.cache_nbytes(sharded.draft.kv) + tkv.cache_nbytes(sharded.target.kv)
    assert budget // 2 < total <= budget + per_block + 4 * 2 * 64 * 4  # 4 sink rows of Hkv*D f32


def test_sp_gates_the_throughput_profile(weights):
    """Under sp the throughput profile verifies with the classic verify:
    no deferred verify, no mono schedule, no split (logged), so no K5, K7,
    K12 or K6; PEARL == AR still."""
    eng = PearlEngine(_config(tcfg, **SP, perf_profile="throughput"), *weights, device="cpu")
    for r in (eng.draft, eng.target):
        assert (r.deferred_verify, r.use_mono, r.split) == (False, False, False)
    assert _run(eng)[0] == _run(eng, ar=True)[0]
