"""The port's checkpoint loader and the shapes it opens up, against the JAX
package and HuggingFace transformers on the CPU:

(a) the port's safetensors reader returns what ``safetensors.safe_open``
    returns, bit for bit, on files ``save_pretrained`` wrote (f32, bf16);
(b) the port's ``load_params`` equals the JAX package's array for array
    (llama, tied llama, qwen2, qwen3, and under ``pad_for_tp(3)``);
(c) the port's logits on the loaded weights match HF's at rtol/atol 2e-4
    on the paged-decode and the prefill path (the bound of
    tests/test_model_parity.py: f32 throughout, two frameworks' GEMM and
    softmax summation orders), also under llama3 / linear rope scaling;
(d) ``PearlEngine`` built from checkpoint directories loads them (no
    random init); its f32 PEARL stream equals its AR stream and both equal
    the JAX engine's on the same directories, also over an int8 cache at
    block size 16 (the K10c/K10d route);
(e) ``attention_kernel`` picks the fallbacks K10a-d exactly where the JAX
    package's gates send a call to its BlockSpec fallbacks;
(f) ``check_supported`` refuses at engine build, on a CUDA device, a head
    dim the kernels do not take.

No Pallas interpret mode: the JAX side runs its jnp paths. Engine cases
run torch on one thread (see test_torch_kv_quant.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nano_pearl_tpu
from nano_pearl_tpu import config as jcfg
from nano_pearl_tpu.ops import kv_cache as jkv
from nano_pearl_tpu.ops.pallas import paged_attention as jpa
from nano_pearl_tpu.utils import loader as jloader
from nano_pearl_tpu_torch import PearlConfig, PearlEngine, SamplingParams
from nano_pearl_tpu_torch import config as tcfg
from nano_pearl_tpu_torch.models.transformer import (
    check_supported,
    compute_logits,
    forward,
    make_rope_table,
    params_from_numpy,
)
from nano_pearl_tpu_torch.ops import attention as tatt
from nano_pearl_tpu_torch.ops.kv_cache import make_kv_cache
from nano_pearl_tpu_torch.utils import loader
from test_torch_kv_quant import one_torch_thread  # noqa: F401 (autouse fixture)

transformers = pytest.importorskip("transformers")
safetensors = pytest.importorskip("safetensors")

TOL_HF = dict(rtol=2e-4, atol=2e-4)
BS = 16
ARCHS = ("llama", "llama_tied", "qwen2", "qwen3")


def tiny_hf(arch: str, layers: int = 3, init: float = 0.02, **extra):
    """The tiny HF model of tests/test_model_parity.py (hidden 64, 4 heads
    of 16, 2 KV heads), seeded; ``init`` its initializer range."""
    torch.manual_seed(0)
    common = dict(
        hidden_size=64, intermediate_size=112, num_hidden_layers=layers, num_attention_heads=4,
        num_key_value_heads=2, vocab_size=211, max_position_embeddings=256, rope_theta=10000.0,
        torch_dtype="float32", tie_word_embeddings=arch == "llama_tied", initializer_range=init,
        **extra,
    )
    cls = {"qwen2": transformers.Qwen2Config, "qwen3": transformers.Qwen3Config}.get(
        arch, transformers.LlamaConfig)
    if arch == "qwen3":
        common["head_dim"] = 16
    return transformers.AutoModelForCausalLM.from_config(cls(**common)).eval().float()


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """arch -> (HF model, directory it was saved to)."""
    root = tmp_path_factory.mktemp("hf")
    out = {}
    for arch in ARCHS:
        model = tiny_hf(arch)
        model.save_pretrained(str(root / arch), safe_serialization=True)
        out[arch] = (model, str(root / arch))
    return out


# ------------------------------------------------------------------ (a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reader_equals_safe_open(tmp_path, dtype):
    path = tmp_path / "m"
    tiny_hf("qwen3").to(dtype).save_pretrained(str(path), safe_serialization=True)
    (file,) = path.glob("*.safetensors")
    mine = loader.read_safetensors(str(file))
    with safetensors.safe_open(str(file), framework="pt") as f:
        assert sorted(mine) == sorted(f.keys())
        for name in f.keys():
            want, got = f.get_tensor(name), loader.as_torch(mine[name])
            assert got.dtype == want.dtype == dtype and got.shape == want.shape
            assert torch.equal(got, want), name


# ------------------------------------------------------------------ (b)


@pytest.mark.parametrize("case", [*ARCHS, "llama, pad_for_tp(3)"])
def test_load_params_equals_jax(checkpoints, case):
    arch = case.split(",")[0]
    path = checkpoints[arch][1]
    tp = 3 if "pad_for_tp" in case else 1
    jm = jcfg.ModelConfig.from_json(path).pad_for_tp(tp)
    tm = tcfg.ModelConfig.from_json(path).pad_for_tp(tp)
    want = jloader.load_params(jm, path, shardings=None, dtype=jnp.float32)
    got = loader.load_params(tm, path)
    assert sorted(got) == sorted(want) and sorted(got["layers"]) == sorted(want["layers"])
    pairs = [(got[k], want[k], k) for k in want if k != "layers"]
    pairs += [(got["layers"][k], want["layers"][k], k) for k in want["layers"]]
    for g, w, k in pairs:
        assert g.dtype == np.float32 and g.shape == w.shape, k
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)


# ------------------------------------------------------------------ (c)


def _fresh_prefill(q, k, v, q_positions, scale):
    return tatt.prefill_self_attention(q, k, v, q_positions, scale)


_fresh_prefill.wants_fresh_kv = True


def port_logits(path: str, ids: list[int], prefill: bool) -> np.ndarray:
    """The port's logits of ``ids`` on the checkpoint at ``path``: every
    token a decode row over the paged cache (context i + 1), or one causal
    prefill."""
    cfg = tcfg.ModelConfig.from_json(path).pad_for_tp(1)
    params = params_from_numpy(loader.load_params(cfg, path), cfg, "cpu")
    n, nb = len(ids), -(-len(ids) // BS)
    cache = make_kv_cache(cfg.num_hidden_layers, nb, BS, cfg.num_key_value_heads, cfg.head_dim,
                          dtype=torch.float32)
    pos = torch.arange(n, dtype=torch.int32)
    scale = cfg.head_dim**-0.5
    if prefill:
        attn, args = _fresh_prefill, (pos[None, :], scale)
    else:
        bt = torch.arange(nb, dtype=torch.int32)[None, :].repeat(n, 1)
        attn, args = tatt.paged_attention, (bt, pos + 1, scale)
    hidden = forward(cfg, params, cache, torch.tensor(ids, dtype=torch.int32), pos, pos,
                     make_rope_table(cfg), attn, args)
    return compute_logits(cfg, params, hidden).numpy()[:, : cfg.valid_vocab_size]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("path_kind", ["paged", "prefill"])
def test_logits_match_hf(checkpoints, arch, path_kind):
    model, path = checkpoints[arch]
    ids = [1, 5, 9, 42, 7, 100, 3, 77, 8, 15, 2, 4, 6, 11, 13, 17, 19, 23]
    with torch.no_grad():
        want = model(torch.tensor([ids])).logits[0].numpy()
    np.testing.assert_allclose(port_logits(path, ids, path_kind == "prefill"), want, **TOL_HF)


@pytest.mark.parametrize("kind", ["llama3", "linear"])
def test_rope_scaling_matches_hf(tmp_path, kind):
    """As test_model_parity.py: positions past original_max_position_embeddings
    exercise llama3's scaled low-frequency band."""
    if kind == "llama3":
        scaling = dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
                       original_max_position_embeddings=64)
    else:
        scaling = dict(rope_type="linear", factor=4.0)
    model = tiny_hf("llama", layers=2, rope_scaling=scaling)
    model.save_pretrained(str(tmp_path / kind), safe_serialization=True)
    ids = list(range(1, 101))
    with torch.no_grad():
        want = model(torch.tensor([ids])).logits[0].numpy()
    np.testing.assert_allclose(port_logits(str(tmp_path / kind), ids, False), want, **TOL_HF)


# ------------------------------------------------------------------ (d)

ENGINE = dict(
    max_model_len=256, max_num_batched_tokens=256, kvcache_block_size=BS, num_kvcache_blocks=48,
    max_num_seqs=4, prefill_token_buckets=(32, 64), gamma=3, dtype="float32",
)
PROMPTS = [[3, 4, 5, 6, 7], [9, 8, 7], [100, 101, 102, 103, 104, 105, 106]]


def _streams(eng, max_tokens: int):
    outs = []
    for gen in (eng.generate_token_ids, eng.AR_generate_token_ids):
        for p in PROMPTS:
            eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=max_tokens, ignore_eos=True))
        toks, n, acc, _ = gen()
        outs.append((toks, n, acc and [round(sum(a), 5) for a in acc]))
    return outs


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_engine_loads_checkpoints_and_matches_jax(tmp_path, kv_quant):
    """A 1-layer draft and a 3-layer target, tiny HF llamas from other seeds
    (initializer range 0.2, so that the logits are not near-tied): the
    engine holds the files' weights, PEARL == AR, and the port's streams and
    accepted-token totals equal the JAX engine's."""
    dirs = {}
    for name, layers, seed in (("draft", 1, 1), ("target", 3, 2)):
        torch.manual_seed(seed)
        model = tiny_hf("llama", layers=layers, init=0.2)
        dirs[name] = str(tmp_path / name)
        model.save_pretrained(dirs[name], safe_serialization=True)
    quant = dict(draft_kv_quant=kv_quant, target_kv_quant=kv_quant)
    teng = PearlEngine(PearlConfig(draft_model=dirs["draft"], target_model=dirs["target"], **quant, **ENGINE),
                       device="cpu")
    embed = loader.as_torch(loader.read_safetensors(f"{dirs['target']}/model.safetensors")[
        "model.embed_tokens.weight"])
    assert torch.equal(teng.target.params["embed"][:211], embed)
    assert teng.draft.cfg.model_path == dirs["draft"]
    # the JAX package reads "torch_dtype" only, which transformers no longer
    # writes: its configs (with the directories as model_path) get f32 here
    jm = {k: dataclasses.replace(jcfg.ModelConfig.from_json(v), dtype="float32") for k, v in dirs.items()}
    jeng = nano_pearl_tpu.PearlEngine(
        jcfg.PearlConfig(draft_model=jm["draft"], target_model=jm["target"], **quant, **ENGINE))
    assert jeng.target.cfg.model_path == dirs["target"]
    max_tokens = 1 + 4 * ENGINE["gamma"]
    (pearl, n, acc), (ar, _, _) = got = _streams(teng, max_tokens)
    assert pearl == ar and n == [max_tokens] * len(PROMPTS)
    assert _streams(jeng, max_tokens) == got


# ------------------------------------------------------------------ (e)

# Hkv * D -> (Hkv, D)
FOLDS = {32: (2, 16), 64: (2, 32), 192: (3, 64), 320: (5, 64), 128: (2, 64)}


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("bs", [16, 32, 256])
@pytest.mark.parametrize("fold", list(FOLDS))
def test_route_follows_jax_gates(fold, bs, kv_quant):
    """The JAX package takes its fast kernels where ``(Hkv * D) % 128 == 0``
    (bf16/f32 cache, pa:1434 and :2415) or ``_q8_fastpath_ok`` holds (1-byte
    cache, on the scales its ``make_kv_cache`` allocates), its BlockSpec
    fallbacks (K10a-d) elsewhere, on either schedule."""
    hkv, d = FOLDS[fold]
    cache = make_kv_cache(1, 1, bs, hkv, d, dtype=torch.bfloat16, quant=kv_quant)
    if kv_quant:
        jscales = jkv.make_kv_cache(1, 1, bs, hkv, d, quant=kv_quant)["s"]
        fast = jpa._q8_fastpath_ok(jscales, bs, hkv, d)
    else:
        fast = (hkv * d) % 128 == 0
    q8 = "_q8" if kv_quant else ""
    want = {
        ("decode", False): f"paged_decode{q8}" if fast else f"paged_decode_fallback{q8}",
        ("verify", False): f"paged_verify{q8}" if fast else f"paged_verify_fallback{q8}",
        ("decode", True): ("mono_q8" if q8 else "mono_attention") if fast else f"paged_decode_fallback{q8}",
        ("verify", True): ("mono_q8" if q8 else "mono_attention") if fast else f"paged_verify_fallback{q8}",
    }
    got = {key: tatt.attention_kernel(key[0], cache, mono=key[1]).__name__ for key in want}
    assert got == want


# ------------------------------------------------------------------ (f)


@pytest.mark.parametrize("head_dim,ok", [(8, False), (24, False), (272, False), (16, True), (48, True),
                                         (256, True)])
def test_check_supported_refuses_head_dims_the_kernels_do_not_take(head_dim, ok):
    cfg = tcfg.ModelConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=1, num_attention_heads=4,
                           num_key_value_heads=2, head_dim=head_dim, vocab_size=128, dtype="float32")
    check_supported(cfg, "cpu")  # the plain versions take any head dim
    if ok:
        check_supported(cfg, "cuda")
        return
    with pytest.raises(ValueError, match="head_dim"):
        check_supported(cfg, torch.device("cuda"))
    with pytest.raises(ValueError, match="head_dim"):  # at engine build, before any launch
        PearlEngine(PearlConfig(draft_model=cfg, target_model=cfg, **ENGINE), device="cuda")



def test_server_cli_serves_checkpoint_directories(checkpoints):
    """``serve -d DIR -t DIR --cpu`` builds the engine from the directories
    (f32 on the CPU, the throughput profile as the repository's serve.py
    picks for real pairs) and serves a request; without a pair or
    ``--layer-share`` it refuses."""
    from nano_pearl_tpu_torch import serve

    path = checkpoints["qwen3"][1]
    args = serve.parse_args(["-d", path, "-t", path, "--cpu", "--gamma", "3", "--max-model-len", "256"])
    eng = serve.build_engine(args, max_num_batched_tokens=256, kvcache_block_size=16, num_kvcache_blocks=32)
    assert eng.config.perf_profile == "throughput" and eng.target.cfg.model_path == path
    assert eng.target.cfg.dtype == "float32" and eng.target.cfg.head_dim == 16
    eng.add_request([3, 4, 5], SamplingParams(temperature=0.0, max_tokens=7, ignore_eos=True))
    toks, n, _, _ = eng.generate_token_ids()
    assert n == [7]
    with pytest.raises(ValueError, match="--draft-model"):
        serve.build_engine(serve.parse_args(["-d", path, "--cpu"]))
