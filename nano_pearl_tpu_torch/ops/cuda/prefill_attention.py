"""Kernels K3 (causal prefill self-attention) and K4 (prefill over a
cached prefix): wrappers of ``csrc/prefill_attention.cu``.

K3 ``prefill_self`` replaces ``_prefill_self_kernel`` (entry
``prefill_self_attention_pallas``) and K4 ``prefill_prefix`` replaces
``_prefill_prefix_kernel`` (entry ``prefill_prefix_attention_pallas``),
both in nano_pearl_tpu/ops/pallas/prefill_attention.py. Their plain
versions are ``prefill_self_attention_ref`` and
``prefill_prefix_attention_ref`` (ops/attention.py).

What bounds them on the H100: at prefill shapes (K3: 64-token prompts in
a 128-row bucket, D = 128; K4: 64 new rows over a 512-token prefix) the
unavoidable traffic and the flops are both a few microseconds or less,
so a launch's fixed cost and its longest block dominate; only a long
chunked-prefill pass is bound by operations. The design answer (the
source's note has the detail): bf16 queries run on the tensor cores
(``mma.sync``), one block per (query tile, KV head, sequence) with its
``qt * G`` query vectors 16 to a warp, K/V tiles staged with
``cp.async`` in a ring of stages, no work on tiles with no real row or
on keys past the last real row, and K4's key stream cut into cells of
``plan.cell`` keys at fixed positions, each a block of its own, folded
in order by a second kernel where a sequence has several. f32 queries
stay on CUDA cores (the tensor cores would round them to TF32).
``prefill_plan`` and ``key_cells`` mirror the launchers' choice.

Each wrapper takes the plain version for CPU tensors, launches the
kernel for CUDA tensors (counting the launch in ``.launches``), and
raises on anything else.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from nano_pearl_tpu_torch.ops.attention import (
    check_head_dim,
    prefill_prefix_attention_ref,
    prefill_self_attention_ref,
)
from nano_pearl_tpu_torch.ops.cuda import build
from nano_pearl_tpu_torch.ops.kv_cache import global_block_offsets

plain_prefill = prefill_self_attention_ref
plain_prefix = prefill_prefix_attention_ref

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = build.load("prefill_attention")
    if not getattr(lib, "_npt_typed", False):
        lib.npt_prefill_self.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P]
        lib.npt_prefill_self.restype = _I
        lib.npt_prefill_prefix.argtypes = (
            [_P] * 10 + [_I] * 7 + [_LL, _LL, _F, _I, _P]
        )
        lib.npt_prefill_prefix.restype = _I
        lib.npt_prefill_plan.argtypes = [_I, _I, _I, _I, _I]
        lib.npt_prefill_plan.restype = _LL
        lib._npt_typed = True
    return lib


MAX_SMEM = 232448  # bytes of shared memory a block may opt into on sm_90 (kMaxSmem)
THREADS = 256  # threads per block, at most (kThreads)
MMA_ROWS = 64  # bf16: query vectors per block, about (kMmaRows)
KEYS = 64  # bf16: keys per staged tile (kKeys); f32: kTile
CELL = 512  # bf16 K4: keys per partial (kCell)
Q_TILE = 16  # f32: query rows per block, at most (kQTile)


@dataclass(frozen=True)
class PrefillPlan:
    """The tiles of a K3/K4 launch: ``qt`` query rows per block,
    ``threads`` per block, ``smem`` bytes of dynamic shared memory, keys
    per cell (``cell``; 0: no split) and K/V tiles in flight (``stages``,
    bf16)."""

    qt: int
    threads: int
    smem: int
    cell: int
    stages: int

    @property
    def rows(self) -> int:
        """Query vectors a block's products hold (bf16: 16 a warp)."""
        return self.threads // 2


@functools.lru_cache(maxsize=None)
def prefill_plan(g: int, d: int, itemsize: int, prefix: bool = False) -> PrefillPlan:
    """The launchers' tiles (``prefill_plan`` in the source, exported as
    ``npt_prefill_plan``) for K3 or K4 (``prefix``), ``g`` query heads per
    KV head, head dim ``d`` and ``itemsize``-byte queries. bf16 (tensor
    cores): ``qt * g`` query vectors a multiple of 16 (``lcm(g, 16)``)
    where that fits eight warps, about ``MMA_ROWS`` of them, else ``qt =
    MMA_ROWS // g``; one warp per 16 vectors; Q, a ring of K/V stages of
    ``KEYS`` keys (K3 two; K4 three at D <= 128, else two) and, for K4, a
    cell's cache slots in shared memory; K4 in cells of ``CELL`` keys
    (``key_cells``). f32 (CUDA cores): the largest ``qt <= Q_TILE`` whose
    flash state fits, no split."""
    if itemsize == 2:
        unit = 16 // math.gcd(g, 16)
        qt = max(unit, MMA_ROWS // g // unit * unit) if unit * g <= THREADS // 2 else max(1, MMA_ROWS // g)
        threads = 32 * -(-qt * g // 16)
        stages = 3 if prefix and d <= 128 else 2
        slots = 2 * CELL if prefix else 0  # K4: a cell's cache slots
        smem = 2 * (d + 8) * (threads // 2 + 2 * stages * KEYS) + 4 * (stages * KEYS + slots)
        return PrefillPlan(qt, threads, smem, CELL if prefix else 0, stages)

    def smem(qt: int) -> int:
        nq = qt * g
        return 2 * 4 * KEYS * (d + 8) + 4 * (2 * nq * d + nq * KEYS + 3 * nq) + 4 * (qt + KEYS)

    qt = Q_TILE
    while qt > 1 and smem(qt) > MAX_SMEM:
        qt //= 2
    return PrefillPlan(qt, THREADS, smem(qt), 0, 1)


def key_cells(n_keys: int, cell: int) -> list[tuple[int, int]]:
    """The key ranges [lo, hi) K4's kernel cuts a sequence's stream of
    ``n_keys = nc + nn`` keys (cached first, then fresh) into, in the
    order the combine folds them: ``max(1, n_keys // cell)`` cells, cell c
    = [c * cell, (c + 1) * cell) but the last, which takes the rest. Real
    row i folds those that start at or before its last key, nc + i. A
    sequence of one cell needs no combine; the launch makes a grid and
    scratch for ``len(key_cells(mpre * bs + lq, cell))`` cells and skips
    the combine where that is 1."""
    n = max(1, n_keys // cell)
    return [(c * cell, (c + 1) * cell if c + 1 < n else n_keys) for c in range(n)]


def _check_fresh(q, k, v, extra: dict):
    """Validate q/k/v [N, H, D] and the int32 ``extra`` tensors on q's
    CUDA device; returns (n, hq, hkv, d)."""
    for name, t in {"q": q, "k": k, "v": v, **extra}.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in extra and t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes must match and be bf16 or f32: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape:
        raise ValueError(f"q/k/v must be [N, H, D]: {q.shape}, {k.shape}, {v.shape}")
    n, hq, d = q.shape
    hkv = k.shape[1]
    check_head_dim(d)
    if k.shape[0] != n or k.shape[2] != d or hq % hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if prefill_plan(hq // hkv, d, q.element_size(), prefix=True).threads > THREADS:
        raise ValueError(f"{hq // hkv} query heads per KV head do not fit one block (at most 128)")
    return n, hq, hkv, d


def prefill_self(q, k, v, q_positions, scale):
    """K3: q [B*Lq, Hq, D], k/v [B*Lq, Hkv, D], q_positions [B, Lq] int32
    (-1 = padded row) -> [B*Lq, Hq, D]."""
    if q.device.type == "cpu":
        return plain_prefill(q, k, v, q_positions, scale)
    n, hq, hkv, d = _check_fresh(q, k, v, {"q_positions": q_positions})
    if q_positions.ndim != 2 or n != q_positions.numel():
        raise ValueError(f"q_positions {tuple(q_positions.shape)} must be [B, Lq] with B * Lq = {n}")
    b, lq = q_positions.shape
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.npt_prefill_self(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(), out.data_ptr(),
        b, lq, hq, hkv, d, float(scale), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, err, "prefill_self")
    prefill_self.launches += 1
    return out


def prefill_prefix(q, k, v, cache, layer_idx, bt_pre, num_cached, n_new, scale):
    """K4: q [B*Lq, Hq, D] and fresh k/v [B*Lq, Hkv, D]; row i of sequence
    b sits at position num_cached[b] + i, is real iff i < n_new[b], and
    attends to the cached prefix (through bt_pre [B, Mpre]) and the fresh
    keys j <= i; padded rows give 0."""
    if q.device.type == "cpu":
        return plain_prefix(q, k, v, cache, layer_idx, bt_pre, num_cached, n_new, scale)
    n, hq, hkv, d = _check_fresh(
        q, k, v, {"bt_pre": bt_pre, "num_cached": num_cached, "n_new": n_new}
    )
    if cache.device != q.device or not cache.is_contiguous() or cache.dtype != q.dtype:
        raise ValueError(f"cache must be a contiguous {q.dtype} tensor on q's device")
    if cache.ndim != 5 or cache.shape[1] != 2 or cache.shape[-1] != hkv * d:
        raise ValueError(f"cache shape {tuple(cache.shape)} does not fold {hkv} x {d}")
    if bt_pre.ndim != 2 or bt_pre.shape[1] < 1:
        raise ValueError(f"bt_pre must be [B, Mpre >= 1], got {tuple(bt_pre.shape)}")
    b, mpre = bt_pre.shape
    if num_cached.shape != (b,) or n_new.shape != (b,) or n % b:
        raise ValueError(f"num_cached/n_new must be [{b}] and q rows a multiple of {b}")
    bs = cache.shape[3]
    k_off, v_off = global_block_offsets(cache, layer_idx)
    out = torch.empty_like(q)
    plan = prefill_plan(hq // hkv, d, q.element_size(), prefix=True)
    # (acc, m, l) partials of every row, head and cell, where a sequence of
    # the launch can have several cells (bf16)
    cells = len(key_cells(mpre * bs + n // b, plan.cell)) if plan.cell else 1
    part_acc = part_ml = None
    if cells > 1:
        part_acc = torch.empty((n, hq, cells, d), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((n, hq, cells, 2), dtype=torch.float32, device=q.device)
    lib = _lib()
    err = lib.npt_prefill_prefix(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cache.data_ptr(), bt_pre.data_ptr(),
        num_cached.data_ptr(), n_new.data_ptr(), out.data_ptr(),
        part_acc.data_ptr() if cells > 1 else None, part_ml.data_ptr() if cells > 1 else None,
        b, n // b, mpre, hq, hkv, d,
        bs, k_off, v_off, float(scale), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, err, "prefill_prefix")
    prefill_prefix.launches += 1
    return out


prefill_self.launches = 0
prefill_prefix.launches = 0
