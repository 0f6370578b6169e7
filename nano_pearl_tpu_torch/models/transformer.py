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

Every phase (prefill, decode, packed verify) runs the same ``forward``
over N flat token rows; the attention flavour is a callable handed in.
The residual stream is carried in f32 across layers (a model-dtype
carry rounds once per layer and makes the logits depend on the layer
count even through pass-through layers, which breaks draft/target
agreement at the layer-share ceiling).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from nano_pearl_tpu_torch.config import ModelConfig
from nano_pearl_tpu_torch.ops.kv_cache import write_kv
from nano_pearl_tpu_torch.ops.rope import apply_rope, build_rope_table
from nano_pearl_tpu_torch.ops.sampling import mask_invalid_logits

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise NotImplementedError(f"model dtype {cfg.dtype!r} is not supported by the port")
    return _DTYPES[cfg.dtype]


def check_supported(cfg: ModelConfig) -> None:
    """Raise on model features the port does not run yet."""
    if cfg.is_moe:
        raise NotImplementedError("MoE models are not ported yet")
    if cfg.quant or cfg.kv_quant:
        raise NotImplementedError("weight and KV-cache quantisation are not ported yet")
    if cfg.fuse_proj:
        raise NotImplementedError("fused projections are not ported yet")
    torch_dtype(cfg)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, out_dtype=None) -> torch.Tensor:
    """f32 rms, cast to ``out_dtype`` (default: ``x``'s) before the weight
    multiply."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(out_dtype or x.dtype) * weight


def init_layers_numpy(
    cfg: ModelConfig, rng: np.random.Generator, num_layers: int, scale: float = 0.02
) -> dict:
    """``num_layers`` random f32 decoder layers, stacked, as numpy arrays."""
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
        "wgate": rnd(nl, h, f),
        "wup": rnd(nl, h, f),
        "wdown": rnd(nl, f, h),
    }
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


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The JAX package's parameter pytree, given as numpy arrays, as the
    port's dict of tensors on ``device``. bf16 arrays (ml_dtypes) cross
    as their 16-bit patterns, since ``torch.from_numpy`` rejects them."""
    dt = torch_dtype(cfg)

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(a)).to(dt)
        return t.to(device)

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: conv(v) for k, v in tree["layers"].items()}
    return out


def make_rope_table(cfg: ModelConfig, device=None) -> torch.Tensor:
    return build_rope_table(
        cfg.head_dim, cfg.max_position_embeddings, cfg.rope_theta, cfg.rope_scaling,
        device=device,
    )


def run_layers(
    cfg: ModelConfig,
    layers: dict,  # stacked layer params, leading dim L
    kv_cache: torch.Tensor,  # [L, 2, NB+1, BS, Hkv*D], written in place
    x: torch.Tensor,  # [N, H]
    res: torch.Tensor,  # [N, H] f32 residual carried alongside
    rope_rows: torch.Tensor,  # [N, D]
    slots: torch.Tensor,  # [N] flat KV slots (garbage block for pads)
    attn_fn,
    attn_args: tuple,
    kv_write_fn=write_kv,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The decoder layers; returns (x, res). ``attn_fn`` marked
    ``wants_fresh_kv`` is called as ``attn_fn(q, k, v, *attn_args)`` (the
    fresh-KV prefill), one marked ``wants_fresh_and_cache`` as
    ``attn_fn(q, k, v, cache, layer, *attn_args)`` (the prefix prefill and
    the deferred-write verify), otherwise as ``attn_fn(q, cache, layer,
    *attn_args)``. Every layer hands its post-rope K/V to
    ``kv_write_fn(cache, k, v, slots, layer)`` before its attention runs:
    ``write_kv`` stores them in the cache; the deferred verify's hook
    (engine/runner.py) collects them and leaves the cache alone."""
    d = cfg.head_dim
    n_q, n_kv = cfg.num_attention_heads, cfg.num_key_value_heads
    eps = cfg.rms_norm_eps
    fresh = getattr(attn_fn, "wants_fresh_kv", False)
    fresh_and_cache = getattr(attn_fn, "wants_fresh_and_cache", False)
    for li in range(layers["wq"].shape[0]):
        res2 = x.float() + res  # f32, exact
        h1 = rms_norm(res2, layers["input_ln"][li], eps, out_dtype=x.dtype)
        q = h1 @ layers["wq"][li]
        k = h1 @ layers["wk"][li]
        v = h1 @ layers["wv"][li]
        if cfg.qkv_bias:
            q = q + layers["bq"][li]
            k = k + layers["bk"][li]
            v = v + layers["bv"][li]
        q = q.reshape(-1, n_q, d)
        k = k.reshape(-1, n_kv, d)
        v = v.reshape(-1, n_kv, d)
        if cfg.qk_norm:
            q = rms_norm(q, layers["q_norm"][li], eps)
            k = rms_norm(k, layers["k_norm"][li], eps)
        q = apply_rope(q, rope_rows)
        k = apply_rope(k, rope_rows)
        kv_write_fn(kv_cache, k, v, slots, li)
        if fresh:
            o = attn_fn(q, k, v, *attn_args)
        elif fresh_and_cache:
            o = attn_fn(q, k, v, kv_cache, li, *attn_args)
        else:
            o = attn_fn(q, kv_cache, li, *attn_args)
        attn_out = o.reshape(-1, n_q * d) @ layers["wo"][li]
        res3 = attn_out.float() + res2  # f32 residual carry
        h2 = rms_norm(res3, layers["post_ln"][li], eps, out_dtype=x.dtype)
        act = F.silu((h2 @ layers["wgate"][li]).float()).to(x.dtype) * (h2 @ layers["wup"][li])
        x = act @ layers["wdown"][li]
        res = res3
    return x, res


def forward(
    cfg: ModelConfig,
    params: dict,
    kv_cache: torch.Tensor,  # written in place
    tokens: torch.Tensor,  # [N] int
    positions: torch.Tensor,  # [N] int
    slots: torch.Tensor,  # [N] int
    rope_table: torch.Tensor,  # [max_pos, D]
    attn_fn,
    attn_args: tuple,
    kv_write_fn=write_kv,
) -> torch.Tensor:
    """Run the decoder stack; returns the final-normed hidden [N, H]
    (``kv_write_fn``: see ``run_layers``)."""
    x = params["embed"][tokens.long()]
    # positions past the table reuse its last row, as JAX's gather clamps
    # out-of-range indices (the bench's 2239-token window on a 2048-row table)
    rope_rows = rope_table[torch.clamp(positions.long(), max=rope_table.shape[0] - 1)]
    x, res = run_layers(
        cfg, params["layers"], kv_cache, x, torch.zeros(x.shape, dtype=torch.float32, device=x.device),
        rope_rows, slots, attn_fn, attn_args, kv_write_fn,
    )
    final = x.float() + res
    return rms_norm(final, params["final_ln"], cfg.rms_norm_eps, out_dtype=x.dtype)


def compute_logits(cfg: ModelConfig, params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """LM head in the model dtype, then f32 with the padded vocab masked."""
    logits = hidden @ params["lm_head"].T
    return mask_invalid_logits(logits.float(), cfg.valid_vocab_size)
