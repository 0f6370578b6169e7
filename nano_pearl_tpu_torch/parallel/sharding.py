"""Tensor-parallel weight shards and the ranks' reductions (counterpart of
nano_pearl_tpu/parallel/sharding.py, whose ``param_specs`` shard the
pytree over the mesh's ``tp`` axis and leave the collectives to GSPMD).

The port runs a tensor-parallel group in one process: ``shard_params``
cuts the full (``pad_for_tp``-padded) parameter dict into one dict per
rank, each on its rank's device, as ``param_specs`` lays it out:

- by columns (output dim): wq, wk, wv, wgate, wup and the biases bq, bk,
  bv (ColumnParallelLinear); a fused ``wqkv`` / ``bqkv`` / ``wgu``
  (``fuse_projections``) part by part, so that rank r holds its own q, k
  and v heads (and gate and up columns) side by side;
- by rows (input dim): wo, wdown (RowParallelLinear);
- by vocab rows: embed and lm_head (VocabParallelEmbedding /
  ParallelLMHead);
- replicated: the norms, q_norm and k_norm.

A quantized leaf ``{"q", "s"}`` follows JAX's quant branch: a column
weight's per-output-channel scale splits with its columns, a row weight's
scale (its contraction axis, which is split, already reduced to 1) is
replicated, the LM head's ``[V, 1]`` scale splits with its rows. Weights
are quantized before they are sharded, so every rank's scale is the full
matrix's.

The partial products of the row-split weights (wo, wdown) and of the
vocab-split embedding are summed in rank order by ``rank_sum``, in f32,
on each device that holds a rank (the JAX package's GSPMD reduce); the
logits are concatenated over the vocab shards (``compute_logits_tp`` in
models/transformer.py). Dims divide ``tp`` because ``ModelConfig.
pad_for_tp`` padded them: load, pad, then shard.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from nano_pearl_tpu_torch.config import ModelConfig

COLUMN_KEYS = ("wq", "wk", "wv", "wgate", "wup", "bq", "bk", "bv")
ROW_KEYS = ("wo", "wdown")
VOCAB_KEYS = ("embed", "lm_head")


@dataclass
class TPRank:
    """One tensor-parallel rank of a model group: its device, its weight
    shard and its copy of the rope table."""

    device: torch.device
    params: dict
    rope_table: torch.Tensor


def _fused_parts(cfg: ModelConfig, key: str) -> list[int]:
    """Widths of the parts of a fused leaf's last axis."""
    d = cfg.head_dim
    if key in ("wqkv", "bqkv"):
        return [cfg.num_attention_heads * d, cfg.num_key_value_heads * d, cfg.num_key_value_heads * d]
    return [cfg.intermediate_size] * 2  # wgu: gate | up


def _chunks(x: torch.Tensor, tp: int, dim: int) -> list[torch.Tensor]:
    if x.shape[dim] % tp:
        raise ValueError(f"a dim of {x.shape[dim]} does not divide over tp {tp} (pad_for_tp first)")
    return list(torch.chunk(x, tp, dim=dim))


def _fused_chunks(x: torch.Tensor, parts: list[int], tp: int) -> list[torch.Tensor]:
    """Rank r's slice of each part of the last axis, joined in part order."""
    per_part = [_chunks(p, tp, -1) for p in torch.split(x, parts, dim=-1)]
    return [torch.cat([p[r] for p in per_part], dim=-1) for r in range(tp)]


def _leaf_chunks(key: str, val, cfg: ModelConfig, tp: int) -> list:
    """The tp shards of one leaf, by the module doc's rules."""
    if isinstance(val, dict):  # quantized
        q, s = val["q"], val["s"]
        if key in ROW_KEYS:
            return [{"q": c, "s": s} for c in _chunks(q, tp, -2)]
        if key == "lm_head":
            return [{"q": a, "s": b} for a, b in zip(_chunks(q, tp, 0), _chunks(s, tp, 0))]
        if key in ("wqkv", "wgu"):
            parts = _fused_parts(cfg, key)
            return [{"q": a, "s": b} for a, b in zip(_fused_chunks(q, parts, tp), _fused_chunks(s, parts, tp))]
        return [{"q": a, "s": b} for a, b in zip(_chunks(q, tp, -1), _chunks(s, tp, -1))]
    if key in COLUMN_KEYS:
        return _chunks(val, tp, -1)
    if key in ("wqkv", "bqkv", "wgu"):
        return _fused_chunks(val, _fused_parts(cfg, key), tp)
    if key in ROW_KEYS:
        return _chunks(val, tp, -2)
    if key in VOCAB_KEYS:
        return _chunks(val, tp, 0)
    return [val] * tp  # replicated


def _to(val, device):
    if isinstance(val, dict):
        return {k: v.to(device).contiguous() for k, v in val.items()}
    return val.to(device).contiguous()


def shard_params(params: dict, cfg: ModelConfig, tp: int, devices=None) -> list[dict]:
    """The per-rank parameter dicts of ``params`` (the full padded tree of
    the port's tensors, quantized or not, fused or not) over ``tp`` ranks,
    rank r's on ``devices[r]`` (default: where each tensor lies). MoE
    experts are not sharded here (tensor parallelism refuses MoE models at
    the engine)."""
    if cfg.is_moe:
        raise NotImplementedError("tensor parallelism over an MoE model is not ported")
    devices = list(devices) if devices is not None else [None] * tp
    ranks = [dict(layers={}) for _ in range(tp)]
    tied = params["lm_head"] is params["embed"]
    for key, val in params.items():
        if key == "layers" or (key == "lm_head" and tied):
            continue
        for r, c in enumerate(_leaf_chunks(key, val, cfg, tp)):
            ranks[r][key] = c if devices[r] is None else _to(c, devices[r])
    for key, val in params["layers"].items():
        for r, c in enumerate(_leaf_chunks(key, val, cfg, tp)):
            ranks[r]["layers"][key] = c if devices[r] is None else _to(c, devices[r])
    if tied:
        for rank in ranks:
            rank["lm_head"] = rank["embed"]
    return ranks


def rank_sum(parts: list[torch.Tensor], devices: list[torch.device]) -> dict:
    """The ranks' partial products summed in rank order, in f32, then
    rounded once to their dtype, on every device that holds a rank (each
    device sums the same terms in the same order, so every copy is the
    same): {device: sum}. One part is returned as it is."""
    if len(parts) == 1:
        return {devices[0]: parts[0]}
    out = {}
    for dev in dict.fromkeys(devices):
        acc = parts[0].to(dev).float()
        for p in parts[1:]:
            acc = acc + p.to(dev)
        out[dev] = acc.to(parts[0].dtype)
    return out


def to_devices(x, devices) -> dict:
    """{device: ``x`` on that device} for each distinct device; ``x`` a
    tensor or a tuple of arguments whose tensors move (the rest stay)."""
    def move(a, dev):
        if isinstance(a, torch.Tensor):
            return a if a.device == dev else a.to(dev)
        return a

    out = {}
    for dev in dict.fromkeys(devices):
        out[dev] = tuple(move(a, dev) for a in x) if isinstance(x, tuple) else move(x, dev)
    return out

