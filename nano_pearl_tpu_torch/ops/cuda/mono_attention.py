"""Kernels K5 (grouped attention, mono schedule), K7 (cache-side flash
partials of the deferred verify), K9c and K6b: wrappers of
``csrc/mono_attention.cu`` for f32 queries and, for bf16 ones, of the
tensor-core page walk (``csrc/paged_walk.cuh``): K5 and K9c through K1/K2's
and K9a/K9b's launch (``paged_attention._attend``, ``csrc/paged_walk.cu``),
K7 and K6b through ``csrc/paged_attention_partials.cu``.

Where each route runs on the card: K5, K7, K6b and K9c with f32 queries on
the mono template below (the f32 exactness pairs), with bf16 queries on the
walk. No bf16 route falls back to the template (whose entries refuse bf16)
or to the plain version: a walk that fails to build or launch raises.

K5 ``mono_attention`` replaces ``_grouped_kernel_db_mono`` (entry
``_mono_call``) and K7 ``cache_partials`` replaces
``_grouped_kernel_db_mono_partial`` (entry
``paged_attention_pallas_grouped_cache_partials``), both in
nano_pearl_tpu/ops/pallas/paged_attention.py. K5 computes what K1 and K2
compute, so its plain versions are ``paged_attention_ref`` (one row per
group) and ``paged_attention_grouped_ref``; K7's is
``paged_attention_grouped_cache_partials_ref`` (ops/attention.py).

What bounds them on the H100: bytes (a group's K/V is read once per KV
head; 4 flops per byte at decode, 4 * R in a packed verify of R rows per
group, far under the card's ~295). The mono template's answer, after the
TPU kernels' flat (group, chunk) stream: one launch per call, whose
resident blocks walk a work list of (group, 256-key chunk, KV head) items
counted on the device from each group's own context, and the block that
finishes a (group, head) last folds its chunks' partials in chunk order in
the same launch (the source's header has the details). At a packed
verify's 14 rows its CUDA-core dot products are bound by shared-memory
reads; there the bf16 kernels run on the walk instead: ``mma.sync``, cells
of keys at fixed positions over the card's SMs, a ``cp.async`` ring. K7 is
K11c's launch with every slot local and K6b's adds one cell after the
table's for the round's fresh keys, read from their rows
(``paged_walk.launch``'s ``fresh``), each with a combine kernel. K5 and
K9c compute what K1/K2 and K9a/K9b compute, so they take their launch: the
walk and its combine, two launches a call, and rows equal to K1's and
K9a's bit for bit. A fold inside the walk's last block, the mono
schedule's one launch, measured slower than the combine kernel (PERF.md).
The template's arrival counters are kept per (device, stream), so two
launches in flight on two streams never share one.

K9c ``mono_q8`` is K5 over a quantized cache (``QuantKVCache``), the
throughput profile's decode and packed verify there; it replaces
``_grouped_kernel_db_mono_q8v2`` (entry ``_mono_call_q8``). Only its tile
load differs: 16 one-byte values per 16-byte load, dequantized per (slot,
head) and rounded to the query's dtype (bf16: the walk's 1-byte path, as
K9a/K9b; f32: the loader of K9a/K9b's f32 route). Its plain version is
K5's, which reads either cache kind.

K6b ``mono_fresh`` is the deferred-write packed verify on the mono
schedule with the fresh window folded in the same launch
(``NANO_PEARL_FRESH_MODE=kernel``): K7's walk over the cache below each
group's pre-round context, plus the fresh window read from the in-operand
fresh rows and folded after the cache's keys (f32: one more work item per
(group, KV head); bf16: the walk's last cell). It replaces
``_grouped_kernel_db_mono_fresh`` (entry ``_mono_call_fresh``); its plain
version is ``paged_attention_grouped_fresh_ref``. With bf16 queries the db
schedule's K6a (``paged_attention.paged_verify_fresh``) launches the same
walk, so their rows are equal bit for bit.

Each wrapper takes the plain version for CPU tensors, launches the kernel
for CUDA tensors (counting the launch in ``.launches``), and raises on
anything else, a cache of the other kind included.
"""

from __future__ import annotations

import ctypes

import torch

from nano_pearl_tpu_torch.ops.attention import (
    paged_attention_grouped_cache_partials_ref,
    paged_attention_grouped_fresh_ref,
    paged_attention_grouped_ref,
    paged_attention_ref,
)
from nano_pearl_tpu_torch.ops.cuda import build, paged_attention, paged_attention_partials, paged_walk
from nano_pearl_tpu_torch.ops.cuda.paged_walk import _check_fresh, _check_inputs
from nano_pearl_tpu_torch.ops.kv_cache import global_block_offsets

plain_partials = paged_attention_grouped_cache_partials_ref
plain_fresh = paged_attention_grouped_fresh_ref

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# arrival counters per (device, stream), zero between launches (each launch
# sets back the entries it used): two launches in flight on two streams
# never share one
_counters: dict[tuple[torch.device, int], torch.Tensor] = {}


def plain_mono(q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group=1):
    """K5's plain version: K1's for one row per group, K2's otherwise."""
    if rows_per_group == 1:
        return paged_attention_ref(q, cache, layer_idx, group_tables, context_lens, scale)
    return paged_attention_grouped_ref(
        q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group
    )


def _lib() -> ctypes.CDLL:
    lib = build.load("mono_attention")
    if not getattr(lib, "_npt_typed", False):
        tail = [_I] * 7 + [_LL, _LL, _F, _I, _I, _P]
        lib.npt_mono_attention.argtypes = [_P] * 8 + tail
        lib.npt_cache_partials.argtypes = [_P] * 10 + tail
        lib.npt_mono_q8.argtypes = [_P] * 9 + [_I] * 7 + [_LL, _LL, _F, _I, _I, _I, _P]
        lib.npt_mono_fresh.argtypes = [_P] * 11 + tail
        for fn in ("npt_mono_attention", "npt_cache_partials", "npt_mono_q8", "npt_mono_fresh"):
            getattr(lib, fn).restype = _I
        lib.npt_mono_chunk_tokens.restype = _I
        lib._npt_typed = True
    return lib


def _scratch(lib, groups, rows, hq, hkv, d, m, bs, device, stream: int, extra: int = 0):
    """(max_chunks, f32 partial acc, f32 (m, l), int32 arrival counters of
    ``stream``), for up to max_chunks + ``extra`` work items per group (K6b:
    its fresh window)."""
    max_chunks = -(-m * bs // lib.npt_mono_chunk_tokens())
    nq = rows * (hq // hkv)
    items = groups * (max_chunks + extra)
    acc = torch.empty((items, hkv, nq, d), dtype=torch.float32, device=device)
    ml = torch.empty((items, hkv, nq, 2), dtype=torch.float32, device=device)
    # one counter per (group, KV head, slice of the group's rows): at most
    # ``rows`` slices, where the rows do not fit one block (rows_per_block)
    cnt = _counters.get((device, stream))
    if cnt is None or cnt.numel() < groups * hkv * rows:
        cnt = _counters[device, stream] = torch.zeros(max(1024, groups * hkv * rows), dtype=torch.int32,
                                                      device=device)
    return max_chunks, acc, ml, cnt


def _launch(fn, what, q, cache, layer_idx, group_tables, context_lens, scale, r, outs):
    if r < 1:
        raise ValueError(f"rows_per_group must be >= 1, got {r}")
    b = group_tables.shape[0]
    quant = fn == "npt_mono_q8"
    hq, hkv, d, bs, m = _check_inputs(q, cache, group_tables, context_lens, b, b * r, quant=quant)
    k_off, v_off = global_block_offsets(cache, layer_idx)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    max_chunks, acc, ml, cnt = _scratch(lib, b, r, hq, hkv, d, m, bs, q.device, stream)
    is_bf16 = int(q.dtype == torch.bfloat16)
    # the C interfaces differ only in the cache's pointers and the trailing type flags
    cache_ptrs = (cache.q.data_ptr(), cache.s.data_ptr()) if quant else (cache.data_ptr(),)
    flags = (is_bf16, int(cache.q.dtype == torch.float8_e4m3fn)) if quant else (is_bf16,)
    err = getattr(lib, fn)(
        q.data_ptr(), *cache_ptrs, group_tables.data_ptr(), context_lens.data_ptr(),
        *(t.data_ptr() for t in outs), acc.data_ptr(), ml.data_ptr(), cnt.data_ptr(),
        b, r, m, hq, hkv, d, bs, k_off, v_off, float(scale), max_chunks,
        *flags, stream,
    )
    build.check(lib, err, what)


def _attend(q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group, quant: bool):
    """K5 (K9c with ``quant``) on the route of the query type: bf16 on
    K1/K2's (K9a/K9b's) walk and combine (``paged_attention._attend``), f32
    on the mono template (``npt_mono_attention`` / ``npt_mono_q8``)."""
    if q.dtype == torch.bfloat16:
        return paged_attention._attend(q, cache, layer_idx, group_tables, context_lens, scale,
                                       int(rows_per_group), quant)
    out = torch.empty_like(q)
    fn = "npt_mono_q8" if quant else "npt_mono_attention"
    _launch(fn, "mono_q8" if quant else "mono_attention", q, cache, layer_idx, group_tables, context_lens,
            scale, int(rows_per_group), (out,))
    return out


def mono_attention(q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group=1):
    """K5: q [B*R, Hq, D]; the R rows of a group share its block table row
    and each has its own context (>= 1). R = 1 is decode. bf16 on
    K1/K2's walk (rows equal K1's bit for bit), f32 on the mono template."""
    if q.device.type == "cpu":
        return plain_mono(q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group)
    out = _attend(q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group, False)
    mono_attention.launches += 1
    return out


def cache_partials(q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group):
    """K7: (o normalised in q's dtype, m, l f32 [B*R, Hq]) over the cache
    only, with cache-side contexts (>= 0; 0 gives o = 0, m = -1e29, l = 0)."""
    if q.device.type == "cpu":
        return plain_partials(q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group)
    n, hq = q.shape[0], q.shape[1]
    m_out = torch.empty((n, hq), dtype=torch.float32, device=q.device)
    l_out = torch.empty((n, hq), dtype=torch.float32, device=q.device)
    if q.dtype == torch.bfloat16:  # the walk: K11c's launch with every slot local
        lib = paged_attention_partials._lib()
        o = paged_walk.launch(lib, lib.npt_partials, False, q, cache, layer_idx, group_tables, context_lens,
                              scale, int(rows_per_group), before=(None,), after=(m_out, l_out))
    else:
        o = torch.empty_like(q)
        _launch("npt_cache_partials", "cache_partials", q, cache, layer_idx, group_tables,
                context_lens, scale, int(rows_per_group), (o, m_out, l_out))
    cache_partials.launches += 1
    return o, m_out, l_out


def mono_q8(q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group=1):
    """K9c: K5 over a quantized cache; bf16 on K9a/K9b's walk, its
    1-byte path (rows equal K9a's bit for bit), f32 on the mono template."""
    if q.device.type == "cpu":
        return plain_mono(q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group)
    out = _attend(q, cache, layer_idx, group_tables, context_lens, scale, rows_per_group, True)
    mono_q8.launches += 1
    return out


def mono_fresh(q, cache, layer_idx, group_tables, context_lens, ctx0, fresh_k, fresh_v, scale,
               rows_per_group):
    """K6b: the deferred-write packed verify of q [B*R, Hq, D] on the mono
    schedule: the cache below ctx0[g] (read-only) plus the fresh rows
    fresh_k/v [B*R, Hkv, D], row t of a group at position ctx0[g] + t;
    context_lens [B*R] each row's context with its visible fresh rows."""
    if q.device.type == "cpu":
        return plain_fresh(q, cache, layer_idx, group_tables, context_lens, ctx0, fresh_k, fresh_v, scale)
    lib = _lib()
    r, chunk = int(rows_per_group), lib.npt_mono_chunk_tokens()
    if not 1 <= r <= chunk:
        raise ValueError(f"mono_fresh takes 1 <= rows_per_group <= {chunk}, got {r}")
    if q.dtype == torch.bfloat16:  # the walk, the fresh window as its last cell
        walk = paged_attention_partials._lib()
        out = paged_walk.launch(walk, walk.npt_fresh_walk, False, q, cache, layer_idx, group_tables, context_lens,
                                scale, r, fresh=(ctx0, fresh_k, fresh_v))
        mono_fresh.launches += 1
        return out
    b = group_tables.shape[0]
    hq, hkv, d, bs, m = _check_inputs(q, cache, group_tables, context_lens, b, b * r)
    _check_fresh(q, ctx0, fresh_k, fresh_v, b, hkv, d)
    k_off, v_off = global_block_offsets(cache, layer_idx)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    max_chunks, acc, ml, cnt = _scratch(lib, b, r, hq, hkv, d, m, bs, q.device, stream, extra=1)
    out = torch.empty_like(q)
    err = lib.npt_mono_fresh(
        q.data_ptr(), cache.data_ptr(), fresh_k.data_ptr(), fresh_v.data_ptr(), group_tables.data_ptr(),
        context_lens.data_ptr(), ctx0.data_ptr(), out.data_ptr(), acc.data_ptr(), ml.data_ptr(),
        cnt.data_ptr(), b, r, m, hq, hkv, d, bs, k_off, v_off, float(scale), max_chunks,
        int(q.dtype == torch.bfloat16), stream,
    )
    build.check(lib, err, "mono_fresh")
    mono_fresh.launches += 1
    return out


mono_attention.launches = 0
cache_partials.launches = 0
mono_q8.launches = 0
mono_fresh.launches = 0
