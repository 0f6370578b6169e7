"""Kernels K11a-d (the per-shard flash partials of sequence parallelism):
wrappers of ``csrc/paged_attention_partials.cu``.

K11a ``paged_decode_partials`` replaces ``_kernel_partial`` and K11c
``paged_verify_partials`` replaces ``_grouped_kernel_partial``, K11b
``paged_decode_partials_q8`` and K11d ``paged_verify_partials_q8``
replace ``_kernel_partial_q8`` and ``_grouped_kernel_partial_q8``
(entries ``paged_attention_pallas_partials`` and
``paged_attention_pallas_grouped_partials``), all in
nano_pearl_tpu/ops/pallas/paged_attention.py. The JAX package reaches them
only through ``parallel/sp.py``'s ``sp_paged_attention`` and
``sp_paged_attention_grouped``; so does the port
(``nano_pearl_tpu_torch/parallel/sp.py``). Their plain versions are
``paged_attention_partials_ref`` (K11a, K11b) and
``paged_attention_grouped_partials_ref`` (K11c, K11d), which read either
cache kind (ops/attention.py).

Each takes one shard of a block-sharded cache, the rows' LOCAL block
tables (clamped into the shard), their global contexts and ``is_local``
(int32, the tables' shape: 0 where the slot is another shard's), and
returns (o in q's dtype [N, Hq, D], m and l f32 [N, Hq]): o normalised by
its own sum, m the row max floored at -1e29, l the sum of exp(s - m). A
row with no local visible key gives (0, -1e29, 0).

What bounds them on the H100: bytes, as K1/K2 (a group reads its shard's
share of its context once per KV head). The design answer is K10's page
walk (``csrc/paged_walk.cuh``): bf16 queries on the tensor cores in cells
of keys at fixed positions, a cell with no local page doing no work, the
cells folded in order; f32 queries a page at a time on CUDA cores,
skipping the other shards' slots. Either way a K11c row equals the K11a
row of the same query, context and table bit for bit (K11d's K11b's),
which keeps the layer-share pair's draft decode and target verify equal
after the merge.

The same library carries the bf16 route of the deferred verify's and the
split-boundary schedule's kernels: K7 (``npt_partials`` with every slot
local) and K6b (``npt_fresh_walk``), launched by ``mono_attention.py``'s
wrappers; K6a (``npt_fresh_walk`` too), K8a and K8b (``npt_cut_walk``: the
walk with a cut cell), launched by ``paged_attention.py``'s.

Each wrapper takes the plain version for CPU tensors, launches the kernel
for CUDA tensors (counting the launch in ``.launches``), and raises on
anything else, a shard of the other kind included.
"""

from __future__ import annotations

import ctypes

import torch

from nano_pearl_tpu_torch.ops.attention import (
    paged_attention_grouped_partials_ref,
    paged_attention_partials_ref,
)
from nano_pearl_tpu_torch.ops.cuda import build, paged_walk

plain_decode = paged_attention_partials_ref
plain_verify = paged_attention_grouped_partials_ref

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention_partials")
    if not getattr(lib, "_npt_typed", False):
        tail = [_I] * 7 + [_LL, _LL, _F, _I]
        lib.npt_partials.argtypes = [_P] * 10 + tail + [_P]
        lib.npt_partials_q8.argtypes = [_P] * 11 + tail + [_I, _P]
        lib.npt_fresh_walk.argtypes = [_P] * 10 + tail + [_P]
        lib.npt_cut_walk.argtypes = [_P] * 11 + tail + [_P]
        for fn in (lib.npt_partials, lib.npt_partials_q8, lib.npt_fresh_walk, lib.npt_cut_walk):
            fn.restype = _I
        lib.npt_walk_cells.argtypes = [_I] * 10
        lib.npt_walk_cells.restype = _I
        lib.npt_walk_plan.argtypes = [_I] * 8
        lib.npt_walk_plan.restype = _LL
        lib._npt_typed = True
    return lib


def _launch(quant: bool, q, cache, layer_idx, tables, context_lens, is_local, scale, rows: int):
    """K11a/K11c (K11b/K11d with ``quant``) on ``tables.shape[0]`` groups of
    ``rows`` rows; returns (o, m, l)."""
    if (is_local.device != q.device or is_local.dtype != torch.int32 or is_local.shape != tables.shape
            or not is_local.is_contiguous()):
        raise ValueError(f"is_local must be contiguous int32 {tuple(tables.shape)} on q's device")
    n, hq = q.shape[:2]
    m_out = torch.empty((n, hq), dtype=torch.float32, device=q.device)
    l_out = torch.empty((n, hq), dtype=torch.float32, device=q.device)
    lib = _lib()
    fn = lib.npt_partials_q8 if quant else lib.npt_partials
    out = paged_walk.launch(lib, fn, quant, q, cache, layer_idx, tables, context_lens, scale, rows,
                            before=(is_local,), after=(m_out, l_out))
    return out, m_out, l_out


def paged_decode_partials(q, cache, layer_idx, block_tables, context_lens, is_local, scale):
    """K11a: q [N, Hq, D] against its own local table row and context."""
    if q.device.type == "cpu":
        return plain_decode(q, cache, layer_idx, block_tables, context_lens, is_local, scale)
    out = _launch(False, q, cache, layer_idx, block_tables, context_lens, is_local, scale, 1)
    paged_decode_partials.launches += 1
    return out


def paged_verify_partials(q, cache, layer_idx, group_tables, context_lens, is_local, scale, rows_per_group):
    """K11c: q [B*R, Hq, D]; the R rows of a group share its local table
    row and each has its own context."""
    if q.device.type == "cpu":
        return plain_verify(q, cache, layer_idx, group_tables, context_lens, is_local, scale, rows_per_group)
    out = _launch(False, q, cache, layer_idx, group_tables, context_lens, is_local, scale, int(rows_per_group))
    paged_verify_partials.launches += 1
    return out


def paged_decode_partials_q8(q, cache, layer_idx, block_tables, context_lens, is_local, scale):
    """K11b: K11a over a quantized shard."""
    if q.device.type == "cpu":
        return plain_decode(q, cache, layer_idx, block_tables, context_lens, is_local, scale)
    out = _launch(True, q, cache, layer_idx, block_tables, context_lens, is_local, scale, 1)
    paged_decode_partials_q8.launches += 1
    return out


def paged_verify_partials_q8(q, cache, layer_idx, group_tables, context_lens, is_local, scale,
                             rows_per_group):
    """K11d: K11c over a quantized shard."""
    if q.device.type == "cpu":
        return plain_verify(q, cache, layer_idx, group_tables, context_lens, is_local, scale, rows_per_group)
    out = _launch(True, q, cache, layer_idx, group_tables, context_lens, is_local, scale, int(rows_per_group))
    paged_verify_partials_q8.launches += 1
    return out


paged_decode_partials.launches = 0
paged_verify_partials.launches = 0
paged_decode_partials_q8.launches = 0
paged_verify_partials_q8.launches = 0
