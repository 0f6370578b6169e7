"""Decoder-only transformer for the Llama family (counterpart of
nano_pearl_tpu/models/transformer.py).

Parameters are a plain dict of tensors in the JAX package's layout, so
one set of weights crosses between the packages as numpy arrays
(``params_from_numpy``). Linear weights are stored ``[in, out]`` and
stacked over layers:

    embed:     [V, H]          layers.wq:   [L, H, Hq*D]
    final_ln:  [H]             layers.wk/wv:[L, H, Hkv*D]
    lm_head:   [V, H]          layers.wo:   [L, Hq*D, H]
    layers.input_ln/post_ln: [L, H]
    layers.wgate/wup: [L, H, F]   layers.wdown: [L, F, H]
    layers.bq/bk/bv: [L, Hq*D]/[L, Hkv*D] (qwen2)
    layers.q_norm/k_norm: [L, D] (qwen3)

An MoE model (Qwen3-MoE, Mixtral: ``ModelConfig.is_moe``) holds a router
and stacked experts in place of the dense MLP (ops/moe.py):

    layers.router: [L, H, E]
    layers.wgate/wup: [L, E, H, Fm]   layers.wdown: [L, E, Fm, H]

With ``ModelConfig.fuse_proj`` (dense models) ``fuse_projections`` joins
wq|wk|wv into ``wqkv`` [L, H, Hq*D + 2*Hkv*D] (with ``bqkv``) and
wgate|wup into ``wgu`` [L, H, 2F], one product each in place of three and
two.

With ``ModelConfig.quant`` ("int8" or "fp8") the seven projections (the
expert stacks among them; the router stays plain) and an untied LM head
are weight-only quantized dicts ``{"q", "s"}`` (ops/quant.py) and every
product goes through ``mm`` / ``mm_t``, which are ``x @ w`` / ``x @ w.T``
on plain weights.

Every phase (prefill, decode, packed verify) runs the same ``forward``
over N flat token rows; the attention flavour is a callable handed in.
The residual stream is carried in f32 across layers (a model-dtype
carry rounds once per layer and makes the logits depend on the layer
count even through pass-through layers, which breaks draft/target
agreement at the layer-share ceiling).

A tensor-parallel group (``parallel/sharding.py``: one weight shard and
one KV cache shard per rank) runs ``forward_tp`` and ``compute_logits_tp``:
each rank launches its own products and attention kernel on its heads and
columns, and the host sums the ranks' partial products of wo and wdown in
rank order (the JAX package's GSPMD reduce), looks the embedding up per
vocab shard and concatenates the logits over the vocab shards.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from nano_pearl_tpu_torch.config import ModelConfig
from nano_pearl_tpu_torch.ops.attention import check_head_dim
from nano_pearl_tpu_torch.ops.kv_cache import write_kv
from nano_pearl_tpu_torch.ops.moe import moe_mlp
from nano_pearl_tpu_torch.ops.quant import (
    QUANTIZED_LAYER_KEYS,
    is_quantized,
    layer_weight,
    mm,
    mm_t,
    quantize_weight,
)
from nano_pearl_tpu_torch.ops.rope import apply_rope, build_rope_table
from nano_pearl_tpu_torch.ops.sampling import mask_invalid_logits
from nano_pearl_tpu_torch.parallel.sharding import rank_sum, to_devices

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise NotImplementedError(f"model dtype {cfg.dtype!r} is not supported by the port")
    return _DTYPES[cfg.dtype]


def check_supported(cfg: ModelConfig, device=None) -> None:
    """Raise on a model dtype the port does not run, and on a CUDA
    ``device`` on a head dim the kernels do not take (``check_head_dim``:
    multiples of 16 from 16 to 256; the CPU's plain versions take any)."""
    torch_dtype(cfg)
    if device is not None and torch.device(device).type == "cuda":
        check_head_dim(cfg.head_dim)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, out_dtype=None) -> torch.Tensor:
    """f32 rms, cast to ``out_dtype`` (default: ``x``'s) before the weight
    multiply."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(out_dtype or x.dtype) * weight


def init_layers_numpy(
    cfg: ModelConfig, rng: np.random.Generator, num_layers: int, scale: float = 0.02
) -> dict:
    """``num_layers`` random f32 decoder layers, stacked, as numpy arrays;
    an MoE config draws a router and expert stacks in place of the dense
    MLP, as the JAX package's ``init_params``."""
    h, f, nl = cfg.hidden_size, cfg.intermediate_size, num_layers
    d = cfg.head_dim
    hq, hkv = cfg.num_attention_heads * d, cfg.num_key_value_heads * d

    def rnd(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    layers = {
        "input_ln": np.ones((nl, h), np.float32),
        "wq": rnd(nl, h, hq),
        "wk": rnd(nl, h, hkv),
        "wv": rnd(nl, h, hkv),
        "wo": rnd(nl, hq, h),
        "post_ln": np.ones((nl, h), np.float32),
    }
    if cfg.is_moe:
        e, fm = cfg.num_experts, cfg.moe_intermediate_size
        layers.update({
            "router": rnd(nl, h, e), "wgate": rnd(nl, e, h, fm), "wup": rnd(nl, e, h, fm),
            "wdown": rnd(nl, e, fm, h),
        })
    else:
        layers.update({"wgate": rnd(nl, h, f), "wup": rnd(nl, h, f), "wdown": rnd(nl, f, h)})
    if cfg.qkv_bias:
        layers.update({"bq": rnd(nl, hq), "bk": rnd(nl, hkv), "bv": rnd(nl, hkv)})
    if cfg.qk_norm:
        layers.update({"q_norm": np.ones((nl, d), np.float32), "k_norm": np.ones((nl, d), np.float32)})
    return layers


def init_params_numpy(cfg: ModelConfig, rng: np.random.Generator, scale: float = 0.02) -> dict:
    """Random f32 weights (tests, weightless benchmarks) in the JAX
    package's pytree layout, as numpy arrays: N(0, scale^2) matrices and
    unit norm weights, like ``transformer.init_params`` there."""
    layers = init_layers_numpy(cfg, rng, cfg.num_hidden_layers, scale)
    embed = rng.standard_normal((cfg.vocab_size, cfg.hidden_size), dtype=np.float32)
    embed *= np.float32(scale)
    lm_head = embed
    if not cfg.tie_word_embeddings:
        lm_head = rng.standard_normal(embed.shape, dtype=np.float32) * np.float32(scale)
    return {
        "embed": embed,
        "layers": layers,
        "final_ln": np.ones((cfg.hidden_size,), np.float32),
        "lm_head": lm_head,
    }


def quantize_params(params: dict, cfg: ModelConfig) -> dict:
    """Weight-only quantization of the plain projections (and an untied LM
    head, over its last axis) as the JAX runner quantizes the weights a
    caller hands in: the tensors as they are, in their own dtype."""
    layers = dict(params["layers"])
    for k in QUANTIZED_LAYER_KEYS:
        if not is_quantized(layers[k]):
            layers[k] = quantize_weight(layers[k], cfg.quant)
    out = dict(params, layers=layers)
    if not cfg.tie_word_embeddings and not is_quantized(params["lm_head"]):
        out["lm_head"] = quantize_weight(params["lm_head"], cfg.quant, contract_axis=-1)
    return out


def fuse_projections(layers: dict) -> dict:
    """wq|wk|wv -> ``wqkv`` and wgate|wup -> ``wgu``, joined on the out axis
    (plain or quantized leaves: ``q`` and ``s`` each), and bq|bk|bv ->
    ``bqkv``, as the JAX package's ``fuse_projections``. Dense models only:
    the experts batch their products on E already."""

    def cat(keys):
        vals = [layers[k] for k in keys]
        if is_quantized(vals[0]):
            return {part: torch.cat([v[part] for v in vals], dim=-1) for part in ("q", "s")}
        return torch.cat(vals, dim=-1)

    out = {k: v for k, v in layers.items() if k not in ("wq", "wk", "wv", "wgate", "wup", "bq", "bk", "bv")}
    out["wqkv"] = cat(["wq", "wk", "wv"])
    out["wgu"] = cat(["wgate", "wup"])
    if "bq" in layers:
        out["bqkv"] = cat(["bq", "bk", "bv"])
    return out


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The JAX package's parameter pytree, given as numpy arrays, as the
    port's dict of tensors on ``device``. bf16 arrays (ml_dtypes) cross
    as their 16-bit patterns and e4m3 ones as their bytes, since
    ``torch.from_numpy`` rejects both. Quantized leaves ``{"q", "s"}``
    keep their types. Under ``cfg.quant`` the plain weights it quantizes
    (``quantize_params``) cross in their own dtype and are quantized on
    ``device``; the others are cast to the model dtype."""
    dt = torch_dtype(cfg)
    quant_keys = set(QUANTIZED_LAYER_KEYS) | ({"lm_head"} if not cfg.tie_word_embeddings else set())
    if not cfg.quant:
        quant_keys = set()

    def conv(a, dtype):
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:  # torch.from_numpy warns on read-only arrays (JAX's)
            a = a.copy()
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        elif a.dtype.name == "float8_e4m3fn":
            t = torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
        else:
            t = torch.from_numpy(a)
        t = t.to(device)
        return t if dtype is None else t.to(dtype)

    def leaf(k, a):
        if isinstance(a, dict):  # already quantized: the stored types stay
            return {"q": conv(a["q"], None), "s": conv(a["s"], None)}
        return conv(a, None if k in quant_keys else dt)

    out = {k: leaf(k, v) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: leaf(k, v) for k, v in tree["layers"].items()}
    return quantize_params(out, cfg) if cfg.quant else out


def make_rope_table(cfg: ModelConfig, device=None) -> torch.Tensor:
    return build_rope_table(
        cfg.head_dim, cfg.max_position_embeddings, cfg.rope_theta, cfg.rope_scaling,
        device=device,
    )


def _qkv(cfg: ModelConfig, lp: dict, h1: torch.Tensor, rope_rows: torch.Tensor, n_q: int, n_kv: int):
    """A layer's post-rope q [N, n_q, D], k and v [N, n_kv, D] (``n_q`` /
    ``n_kv`` the heads the weights ``lp`` hold: all of them, or one
    tensor-parallel rank's)."""
    d = cfg.head_dim
    if "wqkv" in lp:
        qkv = mm(h1, lp["wqkv"])
        if cfg.qkv_bias:
            qkv = qkv + lp["bqkv"]
        q, k, v = qkv.split([n_q * d, n_kv * d, n_kv * d], dim=-1)
        v = v.contiguous()  # the kernels take V as it is; the rope writes q and k anew
    else:
        q = mm(h1, lp["wq"])
        k = mm(h1, lp["wk"])
        v = mm(h1, lp["wv"])
        if cfg.qkv_bias:
            q = q + lp["bq"]
            k = k + lp["bk"]
            v = v + lp["bv"]
    q = q.reshape(-1, n_q, d)
    k = k.reshape(-1, n_kv, d)
    v = v.reshape(-1, n_kv, d)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.rms_norm_eps)
    return apply_rope(q, rope_rows), apply_rope(k, rope_rows), v


def _attend(attn_fn, q, k, v, kv_cache, li: int, attn_args: tuple) -> torch.Tensor:
    """``attn_fn`` called as its marks ask (``run_layers``)."""
    if getattr(attn_fn, "wants_fresh_kv", False):
        return attn_fn(q, k, v, *attn_args)
    if getattr(attn_fn, "wants_fresh_and_cache", False):
        return attn_fn(q, k, v, kv_cache, li, *attn_args)
    return attn_fn(q, kv_cache, li, *attn_args)


def _dense_mlp(lp: dict, h2: torch.Tensor) -> torch.Tensor:
    """The dense MLP's output (under tensor parallelism a rank's partial
    product, its share of the ffn columns)."""
    if "wgu" in lp:
        gate, up = mm(h2, lp["wgu"]).chunk(2, dim=-1)
    else:
        gate, up = mm(h2, lp["wgate"]), mm(h2, lp["wup"])
    return mm(F.silu(gate.float()).to(h2.dtype) * up, lp["wdown"])


def run_layers(
    cfg: ModelConfig,
    layers: dict,  # stacked layer params, leading dim L
    kv_cache,  # [L, 2, NB+1, BS, Hkv*D] tensor or QuantKVCache, written in place
    x: torch.Tensor,  # [N, H]
    res: torch.Tensor,  # [N, H] f32 residual carried alongside
    rope_rows: torch.Tensor,  # [N, D]
    slots: torch.Tensor,  # [N] flat KV slots (garbage block for pads)
    attn_fn,
    attn_args: tuple,
    kv_write_fn=write_kv,
    moe_ragged: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The decoder layers; returns (x, res). ``attn_fn`` marked
    ``wants_fresh_kv`` is called as ``attn_fn(q, k, v, *attn_args)`` (the
    fresh-KV prefill), one marked ``wants_fresh_and_cache`` as
    ``attn_fn(q, k, v, cache, layer, *attn_args)`` (the prefix prefill and
    the deferred-write verify), otherwise as ``attn_fn(q, cache, layer,
    *attn_args)``. Every layer hands its post-rope K/V to
    ``kv_write_fn(cache, k, v, slots, layer)`` before its attention runs:
    ``write_kv`` stores them in the cache; the deferred verify's hook
    (engine/runner.py) collects them and leaves the cache alone.

    An MoE layer's MLP is ``ops/moe.moe_mlp``; ``moe_ragged`` lets a call of
    enough rows take its sorted dispatch. The runner passes it on prefill
    and on the throughput profile's verify, never on decode nor on the
    ceiling profile's verify: the draft's decode and the target's verify
    must run one dispatch, whose products round alike, or near-tied
    argmaxes flip between them (the JAX package measured MAT 11.25 in
    place of 14.0 with a sorted verify beside a dense decode)."""
    n_q, n_kv = cfg.num_attention_heads, cfg.num_key_value_heads
    eps = cfg.rms_norm_eps
    for li in range(layers["input_ln"].shape[0]):
        lp = {key: layer_weight(val, li) for key, val in layers.items()}  # views
        res2 = x.float() + res  # f32, exact
        h1 = rms_norm(res2, lp["input_ln"], eps, out_dtype=x.dtype)
        q, k, v = _qkv(cfg, lp, h1, rope_rows, n_q, n_kv)
        kv_write_fn(kv_cache, k, v, slots, li)
        o = _attend(attn_fn, q, k, v, kv_cache, li, attn_args)
        attn_out = mm(o.reshape(-1, n_q * cfg.head_dim), lp["wo"])
        res3 = attn_out.float() + res2  # f32 residual carry
        h2 = rms_norm(res3, lp["post_ln"], eps, out_dtype=x.dtype)
        if cfg.is_moe:
            x = moe_mlp(
                h2, lp["router"], lp["wgate"], lp["wup"], lp["wdown"], cfg.num_experts_per_tok,
                cfg.norm_topk_prob, cfg.valid_num_experts, allow_ragged=moe_ragged,
            )
        else:
            x = _dense_mlp(lp, h2)
        res = res3
    return x, res


def forward(
    cfg: ModelConfig,
    params: dict,
    kv_cache,  # written in place
    tokens: torch.Tensor,  # [N] int
    positions: torch.Tensor,  # [N] int
    slots: torch.Tensor,  # [N] int
    rope_table: torch.Tensor,  # [max_pos, D]
    attn_fn,
    attn_args: tuple,
    kv_write_fn=write_kv,
    moe_ragged: bool = False,
) -> torch.Tensor:
    """Run the decoder stack; returns the final-normed hidden [N, H]
    (``kv_write_fn``, ``moe_ragged``: see ``run_layers``)."""
    x = params["embed"][tokens.long()]
    # positions past the table reuse its last row, as JAX's gather clamps
    # out-of-range indices (the bench's 2239-token window on a 2048-row table)
    rope_rows = rope_table[torch.clamp(positions.long(), max=rope_table.shape[0] - 1)]
    x, res = run_layers(
        cfg, params["layers"], kv_cache, x, torch.zeros(x.shape, dtype=torch.float32, device=x.device),
        rope_rows, slots, attn_fn, attn_args, kv_write_fn, moe_ragged,
    )
    final = x.float() + res
    return rms_norm(final, params["final_ln"], cfg.rms_norm_eps, out_dtype=x.dtype)


def compute_logits(cfg: ModelConfig, params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """LM head in the model dtype, then f32 with the padded vocab masked."""
    logits = mm_t(hidden, params["lm_head"])
    return mask_invalid_logits(logits.float(), cfg.valid_vocab_size)


# ------------------------------------------------------ tensor parallelism


def _embed_tp(ranks, tokens: dict, devices: list) -> dict:
    """The embedding as a masked lookup per vocab shard, summed over the
    ranks ({device: [N, H]}; exactly the unsharded lookup: each token has
    one nonzero term)."""
    parts, off = [], 0
    for rank in ranks:
        emb = rank.params["embed"]
        v = emb.shape[0]
        local = tokens[rank.device].long() - off
        hit = (local >= 0) & (local < v)
        parts.append(torch.where(hit[:, None], emb[local.clamp(0, v - 1)], 0.0))
        off += v
    return rank_sum(parts, devices)


def run_layers_tp(
    cfg: ModelConfig, ranks, kv_caches, x: dict, res: dict, rope_rows: dict, slots: dict, attn_fn,
    attn_args: dict, kv_write_fns,
) -> tuple[dict, dict]:
    """``run_layers`` over a tensor-parallel group of ranks
    (``parallel/sharding.TPRank``), each with its cache in ``kv_caches``
    and its K/V hook in ``kv_write_fns``. The replicated activations (x,
    res, the rope rows, the slots, ``attn_args``) are {device: tensor}
    dicts, computed once per device that holds a rank. Each rank runs its
    q/k/v columns, its KV heads' cache write and attention kernel and its
    rows of wo; the ranks' wo products are summed in rank order
    (``rank_sum``), and likewise their shares of the MLP's wdown product.
    Dense models only."""
    tp = len(ranks)
    n_q, n_kv = cfg.num_attention_heads // tp, cfg.num_key_value_heads // tp
    eps = cfg.rms_norm_eps
    devices = [rank.device for rank in ranks]
    first = {dev: devices.index(dev) for dev in x}  # a rank whose replicated weights each device reads
    for li in range(ranks[0].params["layers"]["input_ln"].shape[0]):
        lps = [{key: layer_weight(val, li) for key, val in rank.params["layers"].items()} for rank in ranks]
        res2 = {dev: x[dev].float() + res[dev] for dev in x}
        h1 = {dev: rms_norm(res2[dev], lps[first[dev]]["input_ln"], eps, out_dtype=x[dev].dtype) for dev in x}
        parts = []
        for r, rank in enumerate(ranks):
            dev = rank.device
            q, k, v = _qkv(cfg, lps[r], h1[dev], rope_rows[dev], n_q, n_kv)
            kv_write_fns[r](kv_caches[r], k, v, slots[dev], li)
            o = _attend(attn_fn, q, k, v, kv_caches[r], li, attn_args[dev])
            parts.append(mm(o.reshape(-1, n_q * cfg.head_dim), lps[r]["wo"]))
        attn_out = rank_sum(parts, devices)
        res = {dev: attn_out[dev].float() + res2[dev] for dev in x}  # f32 residual carry
        h2 = {dev: rms_norm(res[dev], lps[first[dev]]["post_ln"], eps, out_dtype=x[dev].dtype) for dev in x}
        x = rank_sum([_dense_mlp(lps[r], h2[rank.device]) for r, rank in enumerate(ranks)], devices)
    return x, res


def forward_tp(
    cfg: ModelConfig, ranks, kv_caches, tokens: torch.Tensor, positions: torch.Tensor, slots: torch.Tensor,
    attn_fn, attn_args: tuple, kv_write_fns,
) -> dict:
    """``forward`` over a tensor-parallel group: the inputs (on any device)
    go to each device that holds a rank, the embedding is a masked lookup
    per vocab shard summed over the ranks, then ``run_layers_tp``; returns
    the final-normed hidden {device: [N, H]}, one copy per such device."""
    devices = [rank.device for rank in ranks]
    toks, pos, slot, args = (to_devices(a, devices) for a in (tokens, positions, slots, attn_args))
    rope = {}
    for rank in ranks:
        if rank.device not in rope:
            table = rank.rope_table
            rope[rank.device] = table[torch.clamp(pos[rank.device].long(), max=table.shape[0] - 1)]
    x = _embed_tp(ranks, toks, devices)
    res = {dev: torch.zeros(t.shape, dtype=torch.float32, device=dev) for dev, t in x.items()}
    x, res = run_layers_tp(cfg, ranks, kv_caches, x, res, rope, slot, attn_fn, args, kv_write_fns)
    final_ln = {rank.device: rank.params["final_ln"] for rank in reversed(ranks)}
    return {dev: rms_norm(x[dev].float() + res[dev], final_ln[dev], cfg.rms_norm_eps, out_dtype=x[dev].dtype)
            for dev in x}


def compute_logits_tp(cfg: ModelConfig, ranks, hidden: dict, out_device) -> torch.Tensor:
    """``compute_logits`` over a tensor-parallel group: each rank's vocab
    shard of the LM head, the shards' logits concatenated on
    ``out_device`` in rank order, then f32 with the padded vocab masked."""
    parts = [mm_t(hidden[rank.device], rank.params["lm_head"]).to(out_device) for rank in ranks]
    return mask_invalid_logits(torch.cat(parts, dim=-1).float(), cfg.valid_vocab_size)
