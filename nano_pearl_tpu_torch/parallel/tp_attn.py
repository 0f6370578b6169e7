"""Attention under tensor parallelism (counterpart of
nano_pearl_tpu/parallel/tp_attn.py).

Attention is head-local: each query head reads only its own KV head's
cache rows. So under tp each rank runs the existing kernel (K1/K2/K3 on
the main path, K5/K7/K12 under the throughput profile, K9a-c over a
1-byte cache, K10a-d at unaligned shapes) on its local ``Hq / tp`` query
heads and ``Hkv / tp`` cache heads with the shared block tables, on its
own device: no new kernel and no collective inside attention. The JAX
package does the same with a ``shard_map`` over the mesh's ``tp`` axis
around its Pallas kernels.

The functions here take the whole q (and fresh K/V) on one device and a
``TPKVCache`` (``ops/kv_cache.py``), cut the heads per rank, move each
rank's inputs to its device, run the rank's kernel and join the ranks'
outputs on q's device in rank order: the shape of the JAX functions, for
tests and kernel checks. The engine's forward makes the same per-rank
calls layer by layer, with each rank's heads already on its device
(``models/transformer.run_layers_tp``).
"""

from __future__ import annotations

import torch

from nano_pearl_tpu_torch.ops.attention import (
    paged_attention,
    paged_attention_grouped,
    paged_attention_grouped_fresh,
    prefill_self_attention,
)


def _heads(x: torch.Tensor, tp: int) -> list[torch.Tensor]:
    if x.shape[1] % tp:
        raise ValueError(f"{x.shape[1]} heads do not divide over tp {tp}")
    return list(torch.chunk(x, tp, dim=1))


def _device_of(cache) -> torch.device:
    return (cache.q if hasattr(cache, "q") else cache).device


def _on(a, dev):
    return a.to(dev) if isinstance(a, torch.Tensor) else a


def _per_rank(fn, q, cache, layer_idx: int, shared: tuple) -> torch.Tensor:
    """``fn(q_r, cache_r, layer_idx, *shared)`` once per rank r, on the
    rank's device (q_r: its heads of q); the outputs joined by heads on
    q's device."""
    outs = []
    for q_r, rank_cache in zip(_heads(q, cache.tp_size), cache.ranks):
        dev = _device_of(rank_cache)
        outs.append(fn(q_r.contiguous().to(dev), rank_cache, layer_idx, *(_on(a, dev) for a in shared)))
    return torch.cat([o.to(q.device) for o in outs], dim=1)


def tp_paged_attention(q, cache, layer_idx: int, block_tables, context_lens, scale: float) -> torch.Tensor:
    """Decode attention over a head-split cache: each rank's decode kernel
    (K1, K5's twin, K9a or K10a/K10c) on its heads."""
    return _per_rank(paged_attention, q, cache, layer_idx, (block_tables, context_lens, scale))


def tp_paged_attention_grouped(q, cache, layer_idx: int, group_tables, context_lens, scale: float,
                               rows_per_group: int) -> torch.Tensor:
    """Packed-verify attention over a head-split cache: each rank's verify
    kernel (K2, K9b or K10b/K10d) on its heads."""
    return _per_rank(paged_attention_grouped, q, cache, layer_idx,
                     (group_tables, context_lens, scale, rows_per_group))


def tp_paged_attention_grouped_fresh(q, cache, layer_idx: int, group_tables, context_lens, ctx0, fresh_k,
                                     fresh_v, scale: float, rows_per_group: int, **schedule) -> torch.Tensor:
    """The deferred-write verify over a head-split cache: the fresh K/V rows
    are cut by heads as the cache is; each rank's K7 + fresh-window merge
    (or K6a, K6b, K8b by ``schedule``, as ``paged_attention_grouped_fresh``)."""
    tp = cache.tp_size
    ks, vs, qs = _heads(fresh_k, tp), _heads(fresh_v, tp), _heads(q, tp)
    outs = []
    for r, rank_cache in enumerate(cache.ranks):
        dev = _device_of(rank_cache)
        outs.append(paged_attention_grouped_fresh(
            qs[r].contiguous().to(dev), rank_cache, layer_idx, _on(group_tables, dev), _on(context_lens, dev),
            _on(ctx0, dev), ks[r].contiguous().to(dev), vs[r].contiguous().to(dev), scale, rows_per_group,
            **schedule,
        ))
    return torch.cat([o.to(q.device) for o in outs], dim=1)


def tp_prefill_self_attention(q, k, v, q_positions, scale: float, devices) -> torch.Tensor:
    """Fresh-KV causal prefill with q, k and v cut by heads over the ranks'
    ``devices``: each rank's K3 on its heads."""
    tp = len(devices)
    qs, ks, vs = _heads(q, tp), _heads(k, tp), _heads(v, tp)
    outs = [
        prefill_self_attention(qs[r].contiguous().to(dev), ks[r].contiguous().to(dev), vs[r].contiguous().to(dev),
                               _on(q_positions, dev), scale)
        for r, dev in enumerate(devices)
    ]
    return torch.cat([o.to(q.device) for o in outs], dim=1)
