"""Kernels K10a-d (the paged-attention fallbacks): wrappers of the page
walk's exports in ``csrc/paged_walk.cu`` (``npt_walk``, ``npt_walk_q8``).

K10a ``paged_decode_fallback`` and K10b ``paged_verify_fallback`` replace
``_kernel`` and ``_grouped_kernel``, K10c ``paged_decode_fallback_q8`` and
K10d ``paged_verify_fallback_q8`` replace ``_kernel_q8`` and
``_grouped_kernel_q8`` (entries ``paged_attention_pallas`` and
``paged_attention_pallas_grouped``, their BlockSpec fallbacks), all in
nano_pearl_tpu/ops/pallas/paged_attention.py. The JAX package runs them
where its fast kernels' gates fail: ``Hkv * D % 128 != 0``, and over a
1-byte cache also ``BS % 32 != 0``; ``ops/attention.attention_kernel``
routes the port's calls the same way. Their plain versions are
``paged_attention_ref`` (K10a, K10c) and ``paged_attention_grouped_ref``
(K10b, K10d), which read either cache kind (ops/attention.py).

What bounds them on the H100: bytes, as K1/K2 (a group reads its
context's K/V once per KV head). The design (``csrc/paged_walk.cuh``):
bf16 queries run on the tensor cores (``mma.sync``), each table's key
stream cut into cells at fixed positions (``paged_walk.walk_plan``), one
block per (group, KV head, row slice, cell), K/V pages copied with
``cp.async`` in a ring, and the cells folded in order by a second kernel
where the table holds several; f32 queries walk a page at a time on CUDA
cores. Either way a K10b row equals the K10a row of the same query,
context and table bit for bit (and K10d's K10c's): the decode <-> verify
agreement of the layer-share ceiling at these shapes.

Each wrapper takes the plain version for CPU tensors, launches the kernel
for CUDA tensors (counting the launch in ``.launches``), and raises on
anything else, a cache of the other kind included.
"""

from __future__ import annotations

from nano_pearl_tpu_torch.ops.attention import paged_attention_grouped_ref, paged_attention_ref
from nano_pearl_tpu_torch.ops.cuda import paged_walk

plain_decode = paged_attention_ref
plain_verify = paged_attention_grouped_ref

def _launch(quant: bool, q, cache, layer_idx, tables, context_lens, scale, rows: int):
    """K10a/K10b (K10c/K10d with ``quant``) on ``tables.shape[0]`` groups of
    ``rows`` rows; returns the output."""
    lib = paged_walk._lib()
    fn = lib.npt_walk_q8 if quant else lib.npt_walk
    return paged_walk.launch(lib, fn, quant, q, cache, layer_idx, tables, context_lens, scale, rows)


def paged_decode_fallback(q, cache, layer_idx, block_tables, context_lens, scale):
    """K10a: q [N, Hq, D] against its own block table row and context."""
    if q.device.type == "cpu":
        return plain_decode(q, cache, layer_idx, block_tables, context_lens, scale)
    out = _launch(False, q, cache, layer_idx, block_tables, context_lens, scale, 1)
    paged_decode_fallback.launches += 1
    return out


def paged_verify_fallback(q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group):
    """K10b: q [B*R, Hq, D]; the R rows of a group share its block table row
    and each has its own context length."""
    if q.device.type == "cpu":
        return plain_verify(q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group)
    out = _launch(False, q, cache, layer_idx, group_tables, context_lens, scale, int(rows_per_group))
    paged_verify_fallback.launches += 1
    return out


def paged_decode_fallback_q8(q, cache, layer_idx, block_tables, context_lens, scale):
    """K10c: K10a over a quantized cache."""
    if q.device.type == "cpu":
        return plain_decode(q, cache, layer_idx, block_tables, context_lens, scale)
    out = _launch(True, q, cache, layer_idx, block_tables, context_lens, scale, 1)
    paged_decode_fallback_q8.launches += 1
    return out


def paged_verify_fallback_q8(q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group):
    """K10d: K10b over a quantized cache."""
    if q.device.type == "cpu":
        return plain_verify(q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group)
    out = _launch(True, q, cache, layer_idx, group_tables, context_lens, scale, int(rows_per_group))
    paged_verify_fallback_q8.launches += 1
    return out


paged_decode_fallback.launches = 0
paged_verify_fallback.launches = 0
paged_decode_fallback_q8.launches = 0
paged_verify_fallback_q8.launches = 0
