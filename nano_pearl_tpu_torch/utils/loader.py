"""HF safetensors checkpoints into the JAX package's parameter layout
(counterpart of nano_pearl_tpu/utils/loader.py).

Loading is a pure data transformation, as in the JAX package:

1. read every ``*.safetensors`` file of the directory with the reader
   below (the format: an 8-byte little-endian header length, a JSON
   header of ``dtype`` / ``shape`` / ``data_offsets`` per tensor, then the
   raw bytes), memory-mapped, so only the tensors used are read;
2. map HF names to the pytree's keys (``_LAYER_MAP``, ``_TOP_MAP``);
3. transpose linear weights ``[out, in] -> [in, out]`` and zero-pad each
   tensor to the ``ModelConfig.pad_for_tp`` shapes;
4. stack per-layer tensors along a leading ``[L, ...]`` axis; a checkpoint
   without ``lm_head`` ties it to the embedding.

The result is numpy arrays, which ``models.transformer.params_from_numpy``
moves to the device (quantizing under ``ModelConfig.quant``). The module
reads files with numpy alone: it needs neither the ``safetensors`` nor the
``transformers`` package. BF16 tensors are carried as their uint16 bit
patterns and F8_E4M3 ones as uint8 until they are widened to the output
type. An MoE checkpoint's routers (Qwen3-MoE ``mlp.gate``, Mixtral
``block_sparse_moe.gate``) load as ``router`` [L, H, E]; its experts
(``mlp.experts.{j}.gate_proj|up_proj|down_proj``, Mixtral's
``block_sparse_moe.experts.{j}.w1|w3|w2``) are each transposed and stacked
on the E axis of ``wgate`` / ``wup`` / ``wdown``, zero-padded to the padded
expert count and ``moe_intermediate_size``.
"""

from __future__ import annotations

import json
import os
import re
from glob import glob

import numpy as np
import torch

from nano_pearl_tpu_torch.config import ModelConfig
from nano_pearl_tpu_torch.utils.logging import logger

# safetensors dtype -> the numpy type its bytes are read as (BF16 and
# F8_E4M3 as their bit patterns)
_ST_DTYPES = {
    "F32": np.float32, "F16": np.float16, "BF16": np.uint16, "I8": np.int8, "F8_E4M3": np.uint8,
}

# HF tensor name -> (pytree key, transpose); {i} = layer index
_LAYER_MAP = {
    "input_layernorm.weight": ("input_ln", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.q_proj.bias": ("bq", False),
    "self_attn.k_proj.bias": ("bk", False),
    "self_attn.v_proj.bias": ("bv", False),
    "self_attn.o_proj.weight": ("wo", True),
    "self_attn.q_norm.weight": ("q_norm", False),
    "self_attn.k_norm.weight": ("k_norm", False),
    "post_attention_layernorm.weight": ("post_ln", False),
    "mlp.gate_proj.weight": ("wgate", True),
    "mlp.up_proj.weight": ("wup", True),
    "mlp.down_proj.weight": ("wdown", True),
    # MoE routers (Qwen3-MoE / Mixtral): HF stores [E, H]
    "mlp.gate.weight": ("router", True),
    "block_sparse_moe.gate.weight": ("router", True),
}
# MoE expert tensors: Qwen3-MoE's mlp.experts.{j}.*_proj, Mixtral's
# block_sparse_moe.experts.{j}.w1 (gate) / w3 (up) / w2 (down)
_EXPERT_RE = re.compile(r"^(?:mlp|block_sparse_moe)\.experts\.(\d+)\.(gate_proj|up_proj|down_proj|w1|w2|w3)\.weight$")
_EXPERT_KEY = {"gate_proj": "wgate", "w1": "wgate", "up_proj": "wup", "w3": "wup", "down_proj": "wdown", "w2": "wdown"}
_TOP_MAP = {
    "model.embed_tokens.weight": "embed",
    "model.norm.weight": "final_ln",
    "lm_head.weight": "lm_head",
}
_LAYER_RE = re.compile(r"^model\.layers\.(\d+)\.(.+)$")


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """Every tensor of one ``.safetensors`` file, memory-mapped: F32, F16
    and I8 as themselves, BF16 as uint16 and F8_E4M3 as uint8 bit patterns
    (``as_torch`` views them as their torch types). Raises on any other
    dtype."""
    with open(path, "rb") as f:
        (n,) = np.frombuffer(f.read(8), dtype="<u8")
        header = json.loads(f.read(int(n)))
    header.pop("__metadata__", None)
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + int(n))
    out = {}
    for name, info in header.items():
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
        begin, end = info["data_offsets"]
        dt = np.dtype(_ST_DTYPES[info["dtype"]]).newbyteorder("<")
        out[name] = data[begin:end].view(dt).reshape(info["shape"])
    return out


def as_torch(a: np.ndarray) -> torch.Tensor:
    """A ``read_safetensors`` array as a torch tensor of its stored type
    (uint16 as bfloat16, uint8 as float8_e4m3fn), sharing memory where it
    can."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype == np.uint8:
        return torch.from_numpy(a).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


def _widen(a: np.ndarray, dtype) -> np.ndarray:
    """A stored array as numpy ``dtype`` (exact for every stored type into
    float32)."""
    if a.dtype in (np.uint16, np.uint8):
        return as_torch(a).to(torch.float32).numpy().astype(dtype, copy=False)
    return a.astype(dtype, copy=False)


def _pad_to(x: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """Zero-pad at the tail of every dim (padded head/ffn/vocab lanes carry
    zeros end to end, so the math is unchanged)."""
    if tuple(x.shape) == tuple(shape):
        return x
    return np.pad(x, [(0, t - s) for s, t in zip(x.shape, shape)])


def _expected_shapes(cfg: ModelConfig) -> dict:
    h, f, nl = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    d = cfg.head_dim
    hq, hkv = cfg.num_attention_heads * d, cfg.num_key_value_heads * d
    layers = {
        "input_ln": (nl, h), "wq": (nl, h, hq), "wk": (nl, h, hkv), "wv": (nl, h, hkv),
        "wo": (nl, hq, h), "post_ln": (nl, h),
    }
    if cfg.is_moe:
        e, fm = cfg.num_experts, cfg.moe_intermediate_size
        layers.update({"router": (nl, h, e), "wgate": (nl, e, h, fm), "wup": (nl, e, h, fm),
                       "wdown": (nl, e, fm, h)})
    else:
        layers.update({"wgate": (nl, h, f), "wup": (nl, h, f), "wdown": (nl, f, h)})
    if cfg.qkv_bias:
        layers.update({"bq": (nl, hq), "bk": (nl, hkv), "bv": (nl, hkv)})
    if cfg.qk_norm:
        layers.update({"q_norm": (nl, d), "k_norm": (nl, d)})
    v = cfg.vocab_size
    return {"embed": (v, h), "layers": layers, "final_ln": (h,), "lm_head": (v, h)}


def pad_params(tree: dict, cfg: ModelConfig) -> dict:
    """A parameter tree of numpy arrays (the JAX package's layout) with
    every plain array zero-padded at its tail to ``cfg``'s shapes: weights
    of the unpadded model handed to an engine whose tensor parallelism
    padded the heads, ffn or vocab (``ModelConfig.pad_for_tp``), as the
    loader pads a checkpoint. Arrays already at their shapes, quantized
    leaves and keys the shapes do not name pass as they are."""
    shapes = _expected_shapes(cfg)

    def pad(a, shape):
        return _pad_to(a, shape) if isinstance(a, np.ndarray) and shape is not None else a

    out = {k: pad(v, shapes.get(k)) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: pad(v, shapes["layers"].get(k)) for k, v in tree["layers"].items()}
    if tree.get("lm_head") is tree.get("embed"):
        out["lm_head"] = out["embed"]
    return out


def load_params(cfg: ModelConfig, path: str, dtype=np.float32) -> dict:
    """The HF checkpoint directory ``path`` as the JAX package's parameter
    pytree of numpy ``dtype`` arrays (float32 by default, which holds every
    stored bf16/f16 value exactly). ``cfg`` is the (``pad_for_tp``-padded)
    config the arrays are shaped for."""
    files = sorted(glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    index: dict[str, np.ndarray] = {}
    for file in files:
        index.update(read_safetensors(file))
    shapes = _expected_shapes(cfg)

    params: dict = {"layers": {}}
    for hf_name, key in _TOP_MAP.items():
        if hf_name in index:
            params[key] = _pad_to(_widen(index[hf_name], dtype), shapes[key])
    missing = {"embed", "final_ln"} - set(params)
    if missing:
        raise KeyError(f"checkpoint missing tensors for {missing}")
    if "lm_head" not in params:
        if not cfg.tie_word_embeddings:
            raise KeyError("checkpoint lacks lm_head and embeddings are not tied")
        params["lm_head"] = params["embed"]

    per_layer: dict[str, dict[int, str]] = {}
    per_expert: dict[str, dict[int, dict[int, str]]] = {}  # key -> layer -> expert -> name
    for name in index:
        m = _LAYER_RE.match(name)
        if not m:
            continue
        li, rest = int(m.group(1)), m.group(2)
        em = _EXPERT_RE.match(rest)
        if em:
            per_expert.setdefault(_EXPERT_KEY[em.group(2)], {}).setdefault(li, {})[int(em.group(1))] = name
            continue
        if rest not in _LAYER_MAP:
            logger.warning(f"ignoring unknown layer tensor {name}")
            continue
        per_layer.setdefault(_LAYER_MAP[rest][0], {})[li] = name
    transposed = {key for key, t in _LAYER_MAP.values() if t}
    for key, shape in shapes["layers"].items():
        experts = cfg.is_moe and key in ("wgate", "wup", "wdown")
        names = (per_expert if experts else per_layer).get(key, {})
        if sorted(names) != list(range(cfg.num_hidden_layers)):
            raise KeyError(f"checkpoint has layers {sorted(names)} of {key!r}, "
                           f"want 0..{cfg.num_hidden_layers - 1}")
        slices = []
        for i in range(cfg.num_hidden_layers):
            if experts:  # the layer's experts, each [out, in] -> [in, out], on E
                if sorted(names[i]) != list(range(cfg.valid_num_experts)):
                    raise KeyError(f"checkpoint layer {i} has experts {sorted(names[i])} of {key!r}, "
                                   f"want 0..{cfg.valid_num_experts - 1}")
                a = np.stack([_widen(index[names[i][j]], dtype).T for j in range(cfg.valid_num_experts)])
            else:
                a = _widen(index[names[i]], dtype)
                a = a.T if key in transposed else a
            slices.append(_pad_to(a, shape[1:]))
        params["layers"][key] = np.stack(slices)
    logger.info(f"loaded checkpoint from {path} ({len(index)} tensors)", color="green")
    return params
