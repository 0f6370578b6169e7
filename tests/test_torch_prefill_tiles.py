"""The tile and split choice of the prefill kernels K3 and K4
(``prefill_plan`` and ``key_cells`` in
nano_pearl_tpu_torch/ops/cuda/prefill_attention.py, the Python mirror of
``prefill_plan`` in csrc/prefill_attention.cu; the card holds the mirror
against the exported ``npt_prefill_plan`` in tests/test_torch_kernels.py
and chip_smoke.py). Pure Python on the CPU; imports no JAX.

For every head dim the kernels take and every GQA ratio of the tests and
paths: the block's shared memory fits, the tensor-core route's rows are
whole warps of 16 query vectors, and K4's cells cover a key stream exactly
once, in order, at boundaries fixed by key position. Last, K3's tile walk
emulated in torch shows why that route multiplies P V as hi + lo bf16
parts.
"""

import math

import pytest

from nano_pearl_tpu_torch.ops.cuda.prefill_attention import (
    CELL,
    KEYS,
    MAX_SMEM,
    MMA_ROWS,
    Q_TILE,
    THREADS,
    key_cells,
    prefill_plan,
)

DIMS = list(range(16, 257, 16))
ROUTES = {"bf16": 2, "f32": 4}
KERNELS = {"K3": False, "K4": True}  # prefill_plan's prefix


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("g", [1, 2, 4, 8, 16])
def test_plan_fits_one_block(g, route, kernel):
    """Shared memory within the 232,448 bytes a block may opt into, at most
    256 threads in whole warps, every query row of the tile in the block."""
    for d in DIMS:
        p = prefill_plan(g, d, ROUTES[route], KERNELS[kernel])
        assert 0 < p.smem <= MAX_SMEM, (g, d)
        assert 32 <= p.threads <= THREADS and p.threads % 32 == 0
        assert p.qt >= 1


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("g", [1, 2, 4, 8, 16])
def test_bf16_rows_are_whole_warps(g, kernel):
    """Tensor-core route: 16 query vectors a warp, qt * G of them exactly
    (no idle row where G divides 16), about MMA_ROWS, a query tile of at
    most 64 rows (one warp ballot of two words finds its last real row);
    K4 in cells of CELL keys, a whole number of K/V tiles, K3 unsplit."""
    prefix = KERNELS[kernel]
    for d in DIMS:
        p = prefill_plan(g, d, 2, prefix)
        assert p.rows % 16 == 0 and p.rows == p.threads // 32 * 16
        assert p.qt * g == p.rows == MMA_ROWS
        assert p.qt <= 64
        assert p.cell == (CELL if prefix else 0) and CELL % KEYS == 0


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("g", [3, 5, 6, 9, 12, 40, 128])
def test_bf16_rows_at_other_gqa_ratios(g, kernel):
    """G that does not divide 16 (SmolLM2's 15 heads over 5: G 3): whole
    warps of lcm(G, 16) rows where those fit eight warps, else qt = 64 / G
    with the last warp's spare rows idle; never more than 8 warps."""
    for d in DIMS:
        p = prefill_plan(g, d, 2, KERNELS[kernel])
        assert p.qt * g <= p.rows < p.qt * g + 16 and p.threads <= THREADS
        if math.lcm(g, 16) <= 128:
            assert p.qt * g % 16 == 0
        assert p.smem <= MAX_SMEM


def test_k4_keeps_more_tiles_in_flight():
    """K4's blocks walk a cell of 8 to 15 tiles, so its ring is deeper
    than K3's two stages at D <= 128 (three blocks an SM fit at D 64), and
    it alone holds a cell's cache slots (2 * CELL ints); the rest of the
    plan is K3's."""
    for g in (1, 4, 8):
        for d in DIMS:
            k3, k4 = prefill_plan(g, d, 2), prefill_plan(g, d, 2, True)
            assert k3.stages == 2 and k4.stages == (3 if d <= 128 else 2)
            assert (k3.qt, k3.threads) == (k4.qt, k4.threads)
            assert k4.smem - k3.smem == (k4.stages - 2) * KEYS * (4 * (d + 8) + 4) + 4 * 2 * CELL
            if d <= 64:
                assert 3 * k4.smem <= MAX_SMEM


def test_f32_query_tile_halves_only_while_it_does_not_fit():
    """CUDA-core route: qt is Q_TILE, halved while the flash state of
    qt * G f32 query vectors does not fit; no split."""
    for g in (1, 2, 4, 8, 16):
        for d in DIMS:
            p = prefill_plan(g, d, 4)
            assert p.cell == 0 and p == prefill_plan(g, d, 4, True)
            assert p.qt == Q_TILE or (p.qt < Q_TILE and _f32_smem(2 * p.qt, g, d) > MAX_SMEM)
    assert prefill_plan(4, 128, 4).qt == 16  # the main path's heads
    assert prefill_plan(8, 256, 4).qt == 4


def _f32_smem(qt, g, d):
    nq = qt * g
    return 2 * 4 * KEYS * (d + 8) + 4 * (2 * nq * d + nq * KEYS + 3 * nq) + 4 * (qt + KEYS)


def test_plan_at_the_paths_shapes():
    """The tiles the paths get: the main path's K3 (8x128 heads over 2:
    16 rows x 4 heads, 4 warps), the serve pair's K3/K4 (16x64 over 2: 8 x
    8), the checkpoint paths' K3 (15x64 over 5: 16 x 3, 3 warps)."""
    tiles = lambda g, d: (prefill_plan(g, d, 2).qt, prefill_plan(g, d, 2).threads)  # noqa: E731
    assert tiles(4, 128) == (16, 128)
    assert tiles(8, 64) == (8, 128)
    assert tiles(3, 64) == (16, 96)
    assert prefill_plan(8, 256, 2).smem == 2 * 264 * (64 + 2 * 2 * 64) + 4 * (2 * 64)
    assert prefill_plan(8, 64, 2, True).smem == 2 * 72 * (64 + 2 * 3 * 64) + 4 * (3 * 64 + 2 * 512)


@pytest.mark.parametrize("n_keys", [1, 63, 64, 511, 512, 513, 576, 1023, 1024, 1100, 3072])
def test_cells_cover_the_key_stream_once_in_order(n_keys):
    """The cells of a stream of n_keys keys: consecutive, starting at
    multiples of CELL, CELL keys each but the last, which takes the rest
    (CELL to 2 * CELL - 1 keys, or all of a shorter stream), together
    every key exactly once; max(1, n_keys // CELL) of them."""
    cells = key_cells(n_keys, CELL)
    assert [t for lo, hi in cells for t in range(lo, hi)] == list(range(n_keys))
    assert len(cells) == max(1, n_keys // CELL)
    assert all(lo == c * CELL for c, (lo, _) in enumerate(cells))
    assert all(hi - lo == CELL for lo, hi in cells[:-1])
    lo, hi = cells[-1]
    assert hi - lo < 2 * CELL and (hi - lo >= CELL or len(cells) == 1)


def test_a_serve_prefix_hit_is_one_cell():
    """The serve pair's prefix hit (512 cached + 64 new keys in a 128-row
    bucket over 2 pages of 256) is one cell, in every sequence and in the
    launch: no partials and no combine; a chunked pass (2048 + 1024) is 6."""
    assert len(key_cells(512 + 64, CELL)) == 1 and len(key_cells(2 * 256 + 128, CELL)) == 1
    assert len(key_cells(2048 + 1024, CELL)) == 6


@pytest.mark.parametrize("nc,nn,bs,mpre,lq", [(0, 128, 256, 1, 128), (512, 64, 256, 2, 128),
                                              (2048, 1024, 256, 8, 1024), (1300, 96, 16, 128, 96),
                                              (37, 40, 16, 8, 40), (1100, 0, 16, 128, 96)])
def test_a_rows_cells_do_not_depend_on_the_batch(nc, nn, bs, mpre, lq):
    """Row i of a sequence of nc cached and nn new keys folds the cells of
    its sequence's stream that start at or before its last key nc + i: a
    function of (nc, nn, i) alone, whatever the launch's grid (cells of
    its longest stream, mpre * bs + lq keys, never fewer than the
    sequence's)."""
    launch = key_cells(mpre * bs + lq, CELL)
    seq = key_cells(nc + nn, CELL)
    assert len(seq) <= len(launch)
    for i in range(0, nn, 7):
        row = [(lo, min(hi, nc + i + 1)) for lo, hi in seq if lo <= nc + i]
        assert [t for lo, hi in row for t in range(lo, hi)] == list(range(nc + i + 1))
        assert len(row) == min(len(seq), (nc + i + CELL) // CELL)  # the combine's count


def _tile_walk(q, k, v, pos, scale, p_parts):
    """K3's arithmetic on the CPU: 64-key tiles from key 0, an f32 online
    softmax, l the sum of the f32 p, and P V with P rounded to bf16 in
    ``p_parts`` parts (1: bf16(p); 2: hi = bf16(p), lo = bf16(p - hi))."""
    import torch

    b, lq = pos.shape
    n, hq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qb = q.reshape(b, lq, hkv, g, d).float()
    kb, vb = k.reshape(b, lq, hkv, d).float(), v.reshape(b, lq, hkv, d).float()
    s = torch.einsum("blkgd,bskd->bklgs", qb, kb) * scale
    visible = (pos[:, None, :] >= 0) & (pos[:, None, :] <= pos[:, :, None])
    s = torch.where(visible[:, None, :, None, :], s, torch.tensor(float("-inf")))
    m = torch.full(s.shape[:-1], -1e29)
    l = torch.zeros(s.shape[:-1])  # noqa: E741
    acc = torch.zeros(s.shape[:-1] + (d,))
    for c0 in range(0, lq, KEYS):
        st = s[..., c0 : c0 + KEYS]
        m_new = torch.maximum(m, st.amax(-1))
        p = torch.exp(st - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)  # noqa: E741
        hi = p.bfloat16().float()
        pv = torch.einsum("bklgs,bskd->bklgd", hi, vb[:, c0 : c0 + KEYS])
        if p_parts == 2:
            lo = (p - hi).bfloat16().float()
            pv = pv + torch.einsum("bklgs,bskd->bklgd", lo, vb[:, c0 : c0 + KEYS])
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3, 4).reshape(n, hq, d).to(q.dtype)


def test_one_bf16_p_misses_the_tolerance_hi_lo_meets_it():
    """Why the tensor-core kernels multiply P V as hi + lo bf16 parts: with
    P rounded once to bf16 (as the Pallas kernel rounds it) the output of
    32 prompts of 64 tokens at the main path's heads (8x128 over 2) misses
    chip_smoke.py's bf16 tolerance (rtol 8e-3, atol 1e-3) against the f32
    plain version; with the lo part it meets it."""
    import torch

    from nano_pearl_tpu_torch.ops.attention import prefill_self_attention_ref

    b, lq, n, hq, hkv, d = 32, 128, 64, 8, 2, 128
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((b * lq, hq, d), generator=gen).bfloat16()
    k = torch.randn((b * lq, hkv, d), generator=gen).bfloat16()
    v = torch.randn((b * lq, hkv, d), generator=gen).bfloat16()
    pos = torch.full((b, lq), -1, dtype=torch.int32)
    pos[:, :n] = torch.arange(n, dtype=torch.int32)
    real = (pos >= 0).reshape(-1)
    want = prefill_self_attention_ref(q, k, v, pos, d**-0.5)[real].float()
    tol = dict(rtol=8e-3, atol=1e-3)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(_tile_walk(q, k, v, pos, d**-0.5, 1)[real].float(), want, **tol)
    torch.testing.assert_close(_tile_walk(q, k, v, pos, d**-0.5, 2)[real].float(), want, **tol)
