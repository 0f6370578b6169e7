"""Tensor parallelism in the port against the JAX package on the CPU.

The JAX package's ``tp_*`` attention wrappers run their Pallas kernels in
interpret mode on a ``tp`` mesh of the suite's virtual CPU devices
(tests/conftest.py), at tests/test_tp_attn.py's shapes; the port's run
each rank's plain version (``parallel/tp_attn.py`` over a head-split
``TPKVCache``):

- decode, packed verify, the fresh-KV prefill and decode over an int8
  cache, against JAX's ``tp_paged_attention``, ``_grouped`` and
  ``tp_prefill_self_attention`` (its tolerances: 3e-5, 3e-3 over int8);
- ``shard_params``: the ranks joined back (``gather_params``) equal the
  padded tree, plain, int8 and with fused projections, each rank holding
  its own q, k and v heads of a fused ``wqkv``;
- the engine in f32 with sharpened heads (the LM head times 8, as
  tests/test_engine.py's TP test: tp changes the order of a sum, which
  flips near-tied argmaxes of random tiny models): the port's streams at
  ``(draft_tp, target_tp)`` = (1, 1) and (2, 3) (3 pads the heads, ffn
  and vocab) equal each other and the JAX engine's at (2, 3), PEARL == AR;
  under the throughput profile and at ``target_tp=3`` with int8 weights
  and an int8 KV cache (tests/test_quant.py's case);
- the placements against JAX's ``build_group_meshes`` and the layouts the
  engine still refuses, each by name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import nano_pearl_tpu
from nano_pearl_tpu import config as jcfg
from nano_pearl_tpu.parallel import tp_attn as jtp
from nano_pearl_tpu.parallel.mesh import TP_AXIS, build_group_meshes
from nano_pearl_tpu_torch import config as tcfg
from nano_pearl_tpu_torch import PearlEngine, SamplingParams
from nano_pearl_tpu_torch.models.transformer import fuse_projections, init_params_numpy, params_from_numpy
from nano_pearl_tpu_torch.ops import kv_cache as tkv
from nano_pearl_tpu_torch.parallel import tp_attn as ttp
from nano_pearl_tpu_torch.parallel.mesh import build_group_placements
from nano_pearl_tpu_torch.parallel.sharding import COLUMN_KEYS, ROW_KEYS, VOCAB_KEYS, _fused_parts, shard_params
from nano_pearl_tpu_torch.utils.loader import pad_params

TP = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: under the suite's parallel workers torch's
    spinning thread pool oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:TP]), (TP_AXIS,))


def _cache(rng, l, nb, bs, hkv, d):
    return rng.standard_normal((l, 2, nb + 1, bs, hkv * d)).astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).copy())


def test_tp_decode_attention_matches_jax(mesh):
    rng = np.random.default_rng(0)
    l, nb, bs, hkv, hq, d, n, m = 2, 8, 16, 4, 8, 64, 5, 4
    cache = _cache(rng, l, nb, bs, hkv, d)
    q = rng.standard_normal((n, hq, d)).astype(np.float32)
    bt = rng.integers(0, nb, (n, m)).astype(np.int32)
    ctx = rng.integers(1, m * bs + 1, (n,)).astype(np.int32)
    want = jtp.tp_paged_attention(mesh, jnp.asarray(q), jnp.asarray(cache), jnp.int32(1), jnp.asarray(bt),
                                  jnp.asarray(ctx), d**-0.5, interpret=True)
    got = ttp.tp_paged_attention(_t(q), tkv.split_kv_heads(_t(cache), TP), 1, _t(bt), _t(ctx), d**-0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5, atol=3e-5)


def test_tp_grouped_attention_matches_jax(mesh):
    rng = np.random.default_rng(1)
    l, nb, bs, hkv, hq, d, rows, b, m = 2, 8, 16, 4, 8, 64, 3, 3, 4
    cache = _cache(rng, l, nb, bs, hkv, d)
    q = rng.standard_normal((b * rows, hq, d)).astype(np.float32)
    bt = rng.integers(0, nb, (b, m)).astype(np.int32)
    ctx = rng.integers(1, m * bs + 1, (b * rows,)).astype(np.int32)
    want = jtp.tp_paged_attention_grouped(mesh, jnp.asarray(q), jnp.asarray(cache), jnp.int32(0), jnp.asarray(bt),
                                          jnp.asarray(ctx), d**-0.5, rows, interpret=True)
    got = ttp.tp_paged_attention_grouped(_t(q), tkv.split_kv_heads(_t(cache), TP), 0, _t(bt), _t(ctx), d**-0.5,
                                         rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5, atol=3e-5)


def test_tp_prefill_self_attention_matches_jax(mesh):
    rng = np.random.default_rng(2)
    b, lq, hkv, hq, d = 2, 12, 4, 8, 64
    q, k, v = (rng.standard_normal((b * lq, h, d)).astype(np.float32) for h in (hq, hkv, hkv))
    qpos = np.full((b, lq), -1, np.int32)
    qpos[0] = np.arange(lq)
    qpos[1, :7] = np.arange(3, 10)
    bt = jnp.zeros((b, 2), jnp.int32)  # unused by the fresh-KV flavour
    want = jtp.tp_prefill_self_attention(mesh, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(0), bt,
                                         jnp.asarray(qpos), d**-0.5, interpret=True)
    got = ttp.tp_prefill_self_attention(_t(q), _t(k), _t(v), _t(qpos), d**-0.5, [torch.device("cpu")] * TP)
    real = qpos.reshape(-1) >= 0
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real], rtol=3e-5, atol=3e-5)


def test_tp_decode_attention_int8_cache_matches_jax(mesh):
    """Over an int8 cache filled by JAX's ``write_kv``: the port's ranks
    read its values and, per head, its strided scales' columns."""
    from nano_pearl_tpu.ops.kv_cache import make_kv_cache, write_kv

    rng = np.random.default_rng(3)
    l, nb, bs, hkv, hq, d, n, m = 2, 8, 16, 4, 8, 64, 4, 3
    jc = make_kv_cache(l, nb, bs, hkv, d, dtype=jnp.float32, quant="int8")
    rows = nb * bs
    for li in range(l):
        k, v = (jnp.asarray(rng.standard_normal((rows, hkv, d)).astype(np.float32)) for _ in range(2))
        jc = write_kv(jc, k, v, jnp.arange(rows, dtype=jnp.int32), li)
    q = rng.standard_normal((n, hq, d)).astype(np.float32)
    bt = rng.integers(0, nb, (n, m)).astype(np.int32)
    ctx = rng.integers(1, m * bs + 1, (n,)).astype(np.int32)
    want = jtp.tp_paged_attention(mesh, jnp.asarray(q), jc, jnp.int32(0), jnp.asarray(bt), jnp.asarray(ctx),
                                  d**-0.5, interpret=True)
    stride = jc["s"].shape[-1] // hkv
    s = np.asarray(jc["s"])[..., ::stride]
    tc = tkv.QuantKVCache(_t(jc["q"]), torch.from_numpy(s.view(np.int16).copy()).view(torch.bfloat16))
    got = ttp.tp_paged_attention(_t(q), tkv.split_kv_heads(tc, TP), 0, _t(bt), _t(ctx), d**-0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-3, atol=3e-3)


# ------------------------------------------------------------ weights

MODEL = dict(
    architecture="LlamaForCausalLM", hidden_size=64, intermediate_size=128, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, vocab_size=256, eos_token_id=0, dtype="float32",
    max_position_embeddings=512,
)


def gather_params(ranks: list[dict], cfg) -> dict:
    """The full tree the rank dicts were cut from (``shard_params``'s
    inverse, on the first rank's device): shards joined on their split
    axis, fused leaves part by part, replicated leaves taken from rank 0."""
    tp = len(ranks)
    dev = next(iter(ranks[0]["layers"].values()))
    dev = (dev["q"] if isinstance(dev, dict) else dev).device

    def join(key, vals):
        if isinstance(vals[0], dict):
            if key in ROW_KEYS:
                return {"q": join(key, [v["q"] for v in vals]), "s": vals[0]["s"]}
            return {part: join(key, [v[part] for v in vals]) for part in ("q", "s")}
        vals = [v.to(dev) for v in vals]
        if key in ("wqkv", "bqkv", "wgu"):
            parts = [p // tp for p in _fused_parts(cfg, key)]
            split = [torch.split(v, parts, dim=-1) for v in vals]
            return torch.cat([torch.cat([s[i] for s in split], dim=-1) for i in range(len(parts))], dim=-1)
        if key in COLUMN_KEYS:
            return torch.cat(vals, dim=-1)
        if key in ROW_KEYS:
            return torch.cat(vals, dim=-2)
        if key in VOCAB_KEYS:
            return torch.cat(vals, dim=0)
        return vals[0]

    out = {key: join(key, [r[key] for r in ranks]) for key in ranks[0] if key != "layers"}
    out["layers"] = {key: join(key, [r["layers"][key] for r in ranks]) for key in ranks[0]["layers"]}
    return out


@pytest.mark.parametrize("kind", ["plain", "int8", "fused"])
def test_shard_params_round_trip(kind):
    """tp 3 pads 2 KV heads to 3 (6 query heads), ffn 128 to 384 and the
    vocab to 384: each rank holds a third of every split axis, and the
    ranks joined back equal the padded tree (quantized: the q values split,
    a row weight's scale replicated; fused: rank r's wqkv holds its q, k
    and v heads)."""
    m = tcfg.ModelConfig(**MODEL, qkv_bias=True, quant="int8" if kind == "int8" else None).pad_for_tp(3)
    assert (m.num_key_value_heads, m.num_attention_heads, m.intermediate_size, m.vocab_size) == (3, 6, 384, 384)
    tree = pad_params(init_params_numpy(tcfg.ModelConfig(**MODEL, qkv_bias=True), np.random.default_rng(4)), m)
    params = params_from_numpy(tree, m)
    if kind == "fused":
        params = dict(params, layers=fuse_projections(params["layers"]))
    ranks = shard_params(params, m, 3)
    d = m.head_dim
    for r, rank in enumerate(ranks):
        lay = rank["layers"]
        if kind == "fused":
            want_q = params["layers"]["wqkv"][..., 2 * r * d:(2 * r + 2) * d]
            want_k = params["layers"]["wqkv"][..., (6 + r) * d:(7 + r) * d]
            assert torch.equal(lay["wqkv"][..., :2 * d], want_q) and torch.equal(lay["wqkv"][..., 2 * d:3 * d], want_k)
        wq = lay["wqkv" if kind == "fused" else "wq"]
        wq = wq["q"] if isinstance(wq, dict) else wq
        assert wq.shape[-1] == (4 if kind == "fused" else 2) * d
        head = rank["lm_head"]["q"] if kind == "int8" else rank["lm_head"]
        assert rank["embed"].shape[0] == 128 and head.shape[0] == 128
        assert torch.equal(lay["input_ln"], params["layers"]["input_ln"])
    back = gather_params(ranks, m)

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
        return torch.equal(a, b)

    assert back.keys() == params.keys() and back["layers"].keys() == params["layers"].keys()
    assert all(same(back[k], params[k]) for k in params if k != "layers")
    assert all(same(back["layers"][k], params["layers"][k]) for k in params["layers"])


# ------------------------------------------------------------- engine

ENGINE = dict(
    max_model_len=128, max_num_batched_tokens=512, kvcache_block_size=8, num_kvcache_blocks=23, gamma=3,
    max_num_seqs=8, prefill_token_buckets=(32, 64, 128), dtype="float32",
)
PROMPTS = [[3, 4, 5, 6, 7], [9, 8, 7], [100, 101, 102, 103, 104, 105, 106], [42]]
TP23 = dict(draft_tp=2, target_tp=3)


def _config(module, **over):
    m = module.ModelConfig(**MODEL)
    return module.PearlConfig(draft_model=m, target_model=m, **{**ENGINE, **over})


def _run(eng, ar=False, max_tokens=20):
    for p in PROMPTS:
        eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=max_tokens))
    return (eng.AR_generate_token_ids() if ar else eng.generate_token_ids())[0]


@pytest.fixture(scope="module")
def weights():
    """Unpadded f32 weights with the LM heads sharpened (times 8)."""
    m = tcfg.ModelConfig(**MODEL)
    out = []
    for seed in (30, 31):
        p = init_params_numpy(m, np.random.default_rng(seed))
        p["lm_head"] = p["lm_head"] * np.float32(8)
        out.append(p)
    return out


@pytest.fixture(scope="module")
def unsharded(weights):
    eng = PearlEngine(_config(tcfg), *weights, device="cpu")
    return _run(eng), _run(eng, ar=True)


def test_tp_engine_matches_unsharded_and_jax(weights, unsharded):
    """(2, 3): the port's PEARL and AR streams equal its unsharded ones and
    the JAX engine's at (2, 3) (its weights padded to its configs), PEARL ==
    AR; each rank holds its third of the target's KV heads."""
    eng = PearlEngine(_config(tcfg, **TP23), *weights, device="cpu")
    assert eng.target.tp_size == 3 and len(eng.target.kv.ranks) == 3
    assert eng.target.kv.ranks[0].shape[-1] == 16 and eng.draft.kv.ranks[0].shape[-1] == 16
    got = (_run(eng), _run(eng, ar=True))
    assert got == unsharded
    assert got[0] == got[1]
    jc = _config(jcfg, **TP23)
    jeng = nano_pearl_tpu.PearlEngine(jc, draft_params=pad_params(weights[0], jc.draft_config),
                                      target_params=pad_params(weights[1], jc.target_config))
    assert _run(jeng) == got[0]


def test_tp_throughput_profile_matches_unsharded():
    """tp 2 under the throughput profile at head dim 128 (a rank's folded
    head axis 1 x 128 passes the deferred verify's gate): mono decode and
    the deferred verify with per-rank fresh buffers and writebacks give the
    unsharded streams, PEARL == AR."""
    m = tcfg.ModelConfig(**dict(MODEL, head_dim=128))
    weights = []
    for seed in (32, 33):
        p = init_params_numpy(m, np.random.default_rng(seed))
        p["lm_head"] = p["lm_head"] * np.float32(8)
        weights.append(p)

    def run(**over):
        cfg = tcfg.PearlConfig(draft_model=m, target_model=m, perf_profile="throughput", **{**ENGINE, **over})
        eng = PearlEngine(cfg, *weights, device="cpu")
        return eng, _run(eng), _run(eng, ar=True)

    eng, pearl, ar = run(draft_tp=2, target_tp=2)
    assert eng.target.deferred_verify and eng.target.use_mono and eng.target.kv.ranks[0].shape[-1] == 128
    assert pearl == ar
    assert (pearl, ar) == run()[1:]


def test_tp_prefix_hits_and_chunked_prefill_match_unsharded(weights):
    """Requests behind a cached 20-token prefix (each rank's prefill reads
    its heads of the cached pages, K4's plain version) and a prompt
    prefilled in chunked passes: the (2, 3) streams equal the unsharded
    engine's."""
    prefix = list(range(10, 30))

    def run(**over):
        eng = PearlEngine(_config(tcfg, max_num_batched_tokens=16, **over), *weights, device="cpu")
        eng.add_request(prefix + [5], SamplingParams(temperature=0.0, max_tokens=8))
        first = eng.generate_token_ids()[0]
        for t in (6, 7):
            eng.add_request(prefix + [t], SamplingParams(temperature=0.0, max_tokens=12))
        orch = eng.orchestrator
        return first, eng.generate_token_ids()[0], orch.prefix_hit_tokens, orch.chunked_passes

    sharded = run(**TP23)
    assert sharded[2] > 0 and sharded[3] > 0
    assert sharded == run()


def test_tp3_int8_weights_and_cache(weights):
    """tests/test_quant.py's case: target_tp=3 with int8 weights (a row
    weight's scale replicated over the ranks) and an int8 KV cache (scales
    split by head); PEARL == AR and every request runs to its length."""
    eng = PearlEngine(_config(tcfg, target_tp=3, target_quant="int8", target_kv_quant="int8"), *weights,
                      device="cpu")
    assert tkv.cache_is_quantized(eng.target.kv) and eng.target.kv.ranks[0].s.shape[-1] == 1
    pearl = _run(eng, max_tokens=8)
    assert [len(t) for t in pearl] == [8] * len(PROMPTS)
    assert pearl == _run(eng, ar=True, max_tokens=8)


def test_tp_ranks_share_one_devices_kv_budget(monkeypatch, weights):
    """The block budget counts every rank's bytes: tp ranks on one device
    hold the unsharded pools' blocks between them, not tp times as many."""
    from nano_pearl_tpu_torch.engine import runner as runner_mod

    budget = 2 * 2**20
    monkeypatch.setattr(runner_mod, "device_kv_budget", lambda dev, util: budget)
    base = PearlEngine(_config(tcfg, num_kvcache_blocks=-1), *weights, device="cpu")
    tp = PearlEngine(_config(tcfg, draft_tp=2, target_tp=2, num_kvcache_blocks=-1), *weights, device="cpu")
    assert tp.target.num_blocks == base.target.num_blocks
    total = tkv.cache_nbytes(tp.draft.kv) + tkv.cache_nbytes(tp.target.kv)
    assert total == tkv.cache_nbytes(base.draft.kv) + tkv.cache_nbytes(base.target.kv) <= budget + 2 * 2**16


def test_placements_follow_jax():
    """``build_group_placements`` with tp places as ``build_group_meshes``:
    disjoint slices, round-robin when short, and union over every device."""
    devs = [torch.device("cpu", i) for i in range(5)]
    for d_tp, t_tp, n, placement in ((2, 3, 5, "disjoint"), (2, 2, 3, "disjoint"), (2, 2, 2, "union")):
        draft, target = build_group_placements(devs[:n], d_tp, t_tp, placement)
        jd, jt = build_group_meshes(d_tp, t_tp, jax.devices()[:n], placement=placement)
        assert [d.index for d in draft.devices] == [d.id for d in jd.mesh.devices.flat]
        assert [d.index for d in target.devices] == [d.id for d in jt.mesh.devices.flat]
        assert (draft.tp_size, target.tp_size, draft.sp_size) == (d_tp, t_tp, 1)
    with pytest.raises(ValueError, match="union"):
        build_group_placements(devs[:3], 2, 2, "union")
    with pytest.raises(ValueError, match="union"):
        build_group_placements(devs[:2], 2, 3, "union")
    # one device for union groups of 2 (the card's layout): the ranks share it
    draft, target = build_group_placements(devs[:1], 2, 2, "union")
    assert draft.devices == target.devices == (devs[0], devs[0])


@pytest.mark.parametrize("over, moe, name", [
    (dict(target_pp=2), False, "pipeline parallelism"),
    (dict(draft_ep=2, target_ep=2), True, "expert parallelism"),
    (dict(target_tp=2, target_sp=2), False, "tensor parallelism with sequence parallelism"),
    (dict(target_tp=2), True, "tensor parallelism over an MoE model"),
    (dict(target_tp=2, execution_mode="overlap"), False, 'tensor parallelism under execution_mode="overlap"'),
])
def test_refused_layouts_raise_by_name(over, moe, name):
    m = tcfg.ModelConfig(**dict(MODEL, **(dict(num_experts=4, num_experts_per_tok=2) if moe else {})))
    cfg = tcfg.PearlConfig(draft_model=m, target_model=m, **{**ENGINE, **over})
    with pytest.raises(NotImplementedError, match=name):
        PearlEngine(cfg, device="cpu")


def test_engine_takes_a_device_list():
    """``config.devices`` as strings: the engine's device is the first,
    and both groups share it round-robin (tp 2 each)."""
    eng = PearlEngine(_config(tcfg, draft_tp=2, target_tp=2, devices=["cpu"], num_kvcache_blocks=7))
    assert eng.device == torch.device("cpu")
    assert eng.draft.placement.devices == eng.target.placement.devices == (torch.device("cpu"),) * 2
