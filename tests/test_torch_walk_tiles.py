"""The page walk behind K10a-d and K11a-d (csrc/paged_walk.cuh) on the CPU.

- The launch plan's mirror (``walk_plan`` and ``key_cells`` in
  nano_pearl_tpu_torch/ops/cuda/paged_walk.py; the card holds it against
  the exported ``npt_walk_plan`` in tests/test_torch_kernels.py and
  chip_smoke.py): for every head dim, G, page size and cache kind the
  tensor-core route's shared memory fits, its rows are whole 16-row
  warps, and its cells cover a key stream exactly once, in order, at
  boundaries fixed by key position and by the cache's shape alone.
- A torch emulation of the bf16 route's arithmetic (bf16 operands, f32
  accumulation, 64-key tiles, scores in log2 units, P as hi + lo bf16
  parts, fixed cells and their ordered combine), held against the JAX
  package on its jnp path (tests/conftest.py forces it; no interpret-mode
  Pallas): ``paged_attention_jnp`` (K10a), ``paged_attention_grouped``
  (K10b) and, per shard with the port's merge, ``parallel/sp.
  sp_paged_attention_grouped`` on a (sp=2, tp=1) mesh (K11c/K11d), at
  tests/test_torch_sp.py's f32 tolerance, 1e-5. Over an int8 cache the
  JAX side reads the values the walk reads: written by JAX's ``write_kv``,
  dequantized and rounded to bf16 as the kernels and the plain versions
  round them (the Pallas kernels' ``_kv_head``; JAX's jnp path keeps them
  in f32), as an f32 cache. In the emulation a verify row equals its
  decode row bit for bit.
- The bf16 route of the mono schedule's deferred verify on the same walk:
  K7 (K11c's arithmetic with every slot local) against the port's plain
  version and, merged with JAX's fresh-window partials, against JAX's
  ``paged_attention_grouped_fresh_jnp``; K6b (the cache cells below each
  group's pre-round context, then one cell of the fresh keys) against the
  same, at 1e-5.
- Why the kernels multiply P V as hi + lo bf16 parts where the Pallas
  kernels round P once: at K10b's and K11d's chip_smoke rows (contexts
  65-2300) one bf16 P meets chip_smoke.py's bf16 tolerance against the
  plain versions (which keep f32 P), but with contexts of 1-64 keys it
  misses it; hi + lo meets both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nano_pearl_tpu.ops import attention as jatt
from nano_pearl_tpu.ops import kv_cache as jkv
from nano_pearl_tpu.parallel import sp as jsp
from nano_pearl_tpu_torch.ops import attention as tatt
from nano_pearl_tpu_torch.ops import kv_cache as tkv
from nano_pearl_tpu_torch.ops.cuda.paged_attention import MAX_SMEM, rows_per_block
from nano_pearl_tpu_torch.ops.cuda.paged_walk import KEYS, THREADS, cell_keys, key_cells, n_cells, walk_plan
from nano_pearl_tpu_torch.parallel import sp as tsp

DIMS = list(range(16, 257, 16))
PAGES = [16, 32, 256]
LOG2E, LN2, M_FLOOR = 1.4426950408889634, 0.6931471805599453, -1e29
TOL = dict(rtol=8e-3, atol=1e-3)  # chip_smoke.py's bf16 tolerance


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: under the suite's parallel workers torch's
    spinning thread pool oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- the plan


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("g", list(range(1, 17)))
def test_bf16_plan_fits_in_whole_warps(g, q8):
    """Tensor-core route, every head dim, page size, G 1-16, decode and a
    verify of 14 rows: shared memory within the 232,448 bytes a block may
    opt into, 16 query vectors a warp, the block's warps (4 to 8) holding
    all rpb * G vectors of its rows, the ring no deeper than a cell's
    tiles."""
    for d in DIMS:
        for bs in PAGES:
            for rows in (1, 14):
                p = walk_plan(rows, g, 2, d, bs, 2, q8)
                assert 0 < p.smem <= MAX_SMEM, (d, bs, rows)
                assert p.warp_rows == 16 and p.threads % 32 == 0 and 128 <= p.threads <= THREADS
                assert p.rpb * g <= p.threads // 32 * 16 and 1 <= p.rpb <= rows
                assert p.rpb == rows or p.rpb * g > 8 * 16 - g  # split only where 8 warps are full
                assert p.cell % KEYS == 0 and 2 <= p.stages <= min(3, p.cell // KEYS)


@pytest.mark.parametrize("hkv", [1, 2, 3, 5, 8])
def test_cells_depend_on_the_cache_shape_alone(hkv):
    """The cell of a launch is a function of the cache (Hkv), never of the
    rows, G, page size or cache kind: a decode and a verify over the same
    table take the same cells."""
    cells = {walk_plan(rows, g, hkv, d, bs, 2, q8).cell
             for rows in (1, 3, 14) for g in (1, 3, 8) for d in (16, 64, 256) for bs in PAGES
             for q8 in (False, True)}
    assert cells == {cell_keys(hkv)} == {128 if hkv <= 2 else 256}


def test_f32_plan_is_the_page_walk():
    """f32 queries stay on CUDA cores: no cells, 256 threads, the rows per
    block of the other launchers (``rows_per_block``) at the page's tile."""
    for g in (1, 3, 8):
        for d in DIMS:
            for bs, tile in ((16, 16), (32, 32), (256, 64)):
                p = walk_plan(14, g, 2, d, bs, 4)
                assert (p.cell, p.warp_rows, p.threads, p.stages) == (0, 0, THREADS, 1)
                assert p.rpb == rows_per_block(14, g, d, 4, tile=tile) and p.smem <= MAX_SMEM


def test_plan_at_the_paths_shapes():
    """K10b at the checkpoint paths' verify (SmolLM2-360M: 15x64 heads over
    5, 14 rows): 256-key cells, the 42 query vectors in 3 warps of a
    4-warp block, 3 stages. K11d on an sp shard (8x128 over 2, int8): 128-key
    cells, 56 vectors in 4 warps, 2 stages. D 256 at G 8: 14 rows in 7
    warps."""
    k10b = walk_plan(14, 3, 5, 64, 256, 2)
    assert (k10b.cell, k10b.rpb, k10b.threads, k10b.stages) == (256, 14, 128, 3)
    k11d = walk_plan(14, 4, 2, 128, 256, 2, True)
    assert (k11d.cell, k11d.rpb, k11d.threads, k11d.stages) == (128, 14, 128, 2)
    assert k11d.smem == 2 * 136 * 64 + 2 * 64 * 144 * 2 + 2 * 2 * 136 * 64 + 4 * 64 * 2 + 4 * 128 * 3
    d256 = walk_plan(14, 8, 2, 256, 256, 2)
    assert (d256.rpb, d256.threads, d256.stages) == (14, 224, 2)
    assert walk_plan(14, 16, 2, 256, 256, 2).rpb == 8  # 128 vectors a block: 8 + 6 rows
    assert walk_plan(1, 3, 5, 64, 256, 2).threads == 128  # decode: one warp of rows, 4 warps


@pytest.mark.parametrize("cell", [128, 256])
@pytest.mark.parametrize("n_keys", [1, 64, 127, 128, 129, 255, 256, 257, 1000, 2304, 4096])
def test_cells_cover_the_key_stream_once_in_order(n_keys, cell):
    """The cells of a table of n_keys keys: ceil(n_keys / cell) of them (at
    least one; ``n_cells``, by which the wrappers size their scratch),
    starting at multiples of the cell, together every key exactly once in
    order; a row of context ctx folds those starting below min(ctx,
    n_keys), which cover its keys exactly."""
    cells = key_cells(n_keys, cell)
    assert [t for lo, hi in cells for t in range(lo, hi)] == list(range(n_keys))
    assert len(cells) == n_cells(n_keys, cell) == max(1, -(-n_keys // cell))
    assert all(lo == c * cell for c, (lo, _) in enumerate(cells))
    assert all(hi - lo == cell for lo, hi in cells[:-1])
    for ctx in (1, cell - 1, cell, cell + 1, 2 * cell, n_keys, n_keys + 5):
        keys = [t for lo, hi in cells if lo < min(ctx, n_keys) for t in range(lo, min(hi, ctx))]
        assert keys == list(range(min(ctx, n_keys)))


# ---------------------------------------------------------------- the emulation


def walk_emulation(q, k, v, ctx, rows, scale, cell, local=None, p_parts=2, exact_rows=False, fresh=None):
    """The bf16 route's arithmetic: q [B*R, Hq, D] (bf16 values), k, v [B, S,
    Hkv, D] (bf16 values) of each group's table of S = M * BS keys, ctx
    [B*R] (taken within S), ``local`` [B, S] (K11: the shard's keys) or
    None. Cells of ``cell`` keys from key 0, 64-key tiles within them;
    f32 scores in log2 units, the running max from -1e29, a key no row sees
    at -inf (p = 0), P V with P as ``p_parts`` bf16 parts (1: bf16(p); 2:
    hi + lo); each cell's (acc, m, l) with m in natural-log units (-1e29
    where l = 0); one cell written directly, several folded in order over
    the row's cells below its context with l > 0. ``exact_rows`` takes
    every sum as its own reduction over the last axis, so a row's bits
    cannot depend on the others. ``fresh`` (K6b): (fk, fv [B, R, Hkv, D],
    ctx0 [B]); the cache cells then end at each group's ctx0 (a row sees
    min(ctx, ctx0) of them) and one more cell holds the R fresh keys at
    positions ctx0 + t, seen where below the row's context, folded after
    the row's cache cells. Returns (o f32 unrounded, m, l) [B*R, Hq (, D)]."""
    n, hq, d = q.shape
    b, s, hkv, _ = k.shape
    g = hq // hkv
    ctx = ctx.reshape(b, rows)
    lim = ctx.clamp(max=s)  # the keys of the table a row sees
    if fresh is not None:
        lim = torch.minimum(lim, fresh[2][:, None])
    qf = q.float().reshape(b, rows, hkv, g, d)
    sl2 = scale * LOG2E
    vis = torch.arange(s)[None, None, :] < lim[:, :, None]
    if local is not None:
        vis = vis & local[:, None, :]

    def fold_cell(kc, vc, vis_c):
        """(acc, m (natural log; -1e29 where l = 0), l) of one cell's keys kc, vc
        [B, n, Hkv, D] seen as vis_c [B, R, n], in 64-key tiles from its first."""
        m = torch.full((b, rows, hkv, g), M_FLOOR)
        l = torch.zeros((b, rows, hkv, g))  # noqa: E741
        acc = torch.zeros((b, rows, hkv, g, d))
        for t0 in range(0, kc.shape[1], KEYS):
            kt, vt = kc[:, t0 : t0 + KEYS].float(), vc[:, t0 : t0 + KEYS].float()
            if exact_rows:
                sc = (qf[:, :, :, :, None, :] * kt.permute(0, 2, 1, 3)[:, None, :, None]).sum(-1)
            else:
                sc = torch.einsum("brkgd,btkd->brkgt", qf, kt)
            sc = torch.where(vis_c[:, :, None, None, t0 : t0 + kt.shape[1]], sc, torch.tensor(float("-inf")))
            mn = torch.maximum(m, sc.amax(-1) * sl2)
            p = torch.exp2(sc * sl2 - mn[..., None])
            alpha = torch.exp2(m - mn)
            l = l * alpha + p.sum(-1)  # noqa: E741
            hi_p = p.bfloat16().float()
            pv = 0
            for pp in [hi_p] + ([(p - hi_p).bfloat16().float()] if p_parts == 2 else []):
                if exact_rows:
                    pv = pv + (pp[..., None, :] * vt.permute(0, 2, 3, 1)[:, None, :, None]).sum(-1)
                else:
                    pv = pv + torch.einsum("brkgt,btkd->brkgd", pp, vt)
            acc = acc * alpha[..., None] + pv
            m = mn
        return acc, torch.where(l > 0, m * LN2, torch.tensor(M_FLOOR)), l

    parts, uses = [], []
    for lo, hi in key_cells(s, cell):
        acc, mc, lc = fold_cell(k[:, lo:hi], v[:, lo:hi], vis[:, :, lo:hi])
        parts.append((acc, mc, lc))
        uses.append((lo < lim)[:, :, None, None] & (lc > 0))
    if fresh is not None:
        fk, fv, ctx0 = fresh
        pos = ctx0[:, None] + torch.arange(rows)[None, :]  # [B, R] the fresh keys' positions
        acc, mc, lc = fold_cell(fk, fv, pos[:, None, :] < ctx[:, :, None])
        parts.append((acc, mc, lc))
        uses.append(lc > 0)
    if len(parts) == 1:
        at, mg, lt = parts[0]
    else:
        mg = torch.full((b, rows, hkv, g), M_FLOOR)
        for use, (_, mc, _) in zip(uses, parts):
            mg = torch.where(use, torch.maximum(mg, mc), mg)
        lt, at = torch.zeros_like(mg), torch.zeros((b, rows, hkv, g, d))
        for use, (acc, mc, lc) in zip(uses, parts):
            w = torch.exp(mc - mg)
            lt = torch.where(use, lc * w + lt, lt)
            at = torch.where(use[..., None], acc * w[..., None] + at, at)
    o = at / torch.clamp(lt, min=1e-30)[..., None]
    return o.reshape(n, hq, d), mg.reshape(n, hq), lt.reshape(n, hq)


L, NB, BS, HKV, HQ, D = 2, 47, 16, 2, 6, 16  # G 3 (SmolLM2's); NB + 1 = 48 splits over sp 2
M = 20  # 320 keys a table: cells [0, 128), [128, 256), [256, 320)
SCALE = D**-0.5
CELL = cell_keys(HKV)
ROWS = 3
# groups of three staircase rows at each side of the cell boundaries, a
# context of 1, the table's end and past it
CTX0 = [126, 254, 1, 318, 60, 330]


def _caches(quant):
    """The JAX cache and the port's copy of it: bf16-valued f32 rows, or an
    int8 cache written by JAX's ``write_kv`` (the port's copy) and, for
    JAX, its values dequantized and rounded to bf16 as the walk reads them,
    as f32 rows."""
    rng = np.random.default_rng(11)
    n = (NB + 1) * BS
    if quant is None:
        rows = rng.standard_normal((L, 2, NB + 1, BS, HKV * D)).astype(np.float32)
        rows = torch.from_numpy(rows).bfloat16().float().numpy()
        return jnp.asarray(rows), torch.from_numpy(rows.copy())
    jc = jkv.make_kv_cache(L, NB, BS, HKV, D, quant=quant, dtype=jnp.float32)
    for li in range(L):
        k = rng.standard_normal((n, HKV, D)).astype(np.float32) * rng.uniform(0.2, 3, (n, HKV, 1))
        v = rng.standard_normal((n, HKV, D)).astype(np.float32)
        jc = jkv.write_kv(jc, jnp.asarray(k), jnp.asarray(v), jnp.arange(n, dtype=jnp.int32), jnp.int32(li))
    stride = jc["s"].shape[-1] // HKV
    s = torch.from_numpy(np.asarray(jc["s"])[..., ::stride].view(np.int16).copy()).view(torch.bfloat16)
    tc = tkv.QuantKVCache(torch.from_numpy(np.asarray(jc["q"]).copy()), s)
    read = tkv.dequant_rows(tc.q, tc.s, D).bfloat16().float().reshape(tc.q.shape)
    return jnp.asarray(read.numpy()), tc


def _case():
    rng = np.random.default_rng(12)
    groups = len(CTX0)
    bt = np.stack([rng.permutation(NB)[:M] for _ in range(groups)]).astype(np.int32)
    ctx = np.array([c + i for c in CTX0 for i in range(ROWS)], np.int32)
    q = torch.from_numpy(rng.standard_normal((groups * ROWS, HQ, D)).astype(np.float32)).bfloat16()
    return q, bt, ctx


def _emulate(q, tc, bt, ctx, rows, local=None, **kw):
    k, v = tatt._gather_kv(tc, 1, torch.from_numpy(bt), D, torch.bfloat16)
    return walk_emulation(q, k, v, torch.from_numpy(ctx), rows, SCALE, CELL, local, **kw)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_emulated_walk_matches_jax_decode_and_verify(quant):
    """K10b (groups of 3 rows sharing a table) and K10a (one row a table)
    emulated against JAX's ``paged_attention_grouped`` and
    ``paged_attention_jnp``, contexts at each side of the cell boundaries,
    of 1 and past the table; the verify rows equal the decode rows bit for
    bit."""
    jc, tc = _caches(quant)
    q, bt, ctx = _case()
    qj = jnp.asarray(q.float().numpy())
    want = jatt.paged_attention_grouped(qj, jc, jnp.int32(1), jnp.asarray(bt), jnp.asarray(ctx), SCALE, ROWS,
                                        use_pallas=False)
    bt_rows = np.repeat(bt, ROWS, 0)
    want_rows = jatt.paged_attention_jnp(qj, jc, jnp.int32(1), jnp.asarray(bt_rows), jnp.asarray(ctx), SCALE)
    verify = _emulate(q, tc, bt, ctx, ROWS, exact_rows=True)[0]
    decode = _emulate(q, tc, bt_rows, ctx, 1, exact_rows=True)[0]
    np.testing.assert_allclose(verify.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(decode.numpy(), np.asarray(want_rows), rtol=1e-5, atol=1e-5)
    assert torch.equal(verify, decode)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_emulated_partials_match_jax_sp_verify(quant):
    """K11c (K11d over int8) emulated on each shard of the cache split over
    sp = 2 (the shard's keys only; group 0's pages all sit in shard 0),
    merged with the port's ``merge_partials``, against JAX's
    ``sp_paged_attention_grouped`` on a (sp=2, tp=1) mesh of the virtual
    CPU devices; per shard, verify rows equal decode rows bit for bit, and
    a row that sees no key of a shard gives (0, -1e29, 0) exactly."""
    import jax

    jc, tc = _caches(quant)
    q, bt, ctx = _case()
    bt[0] = np.arange(M)  # group 0: shard 0's blocks only
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("sp", "tp"))
    shard = jax.device_put(jc, NamedSharding(mesh, P(None, None, "sp", None, "tp")))
    sp_verify = jax.jit(lambda q, c, bt, ctx: jsp.sp_paged_attention_grouped(
        mesh, q, c, jnp.int32(1), bt, ctx, SCALE, rows_per_group=ROWS))
    want = sp_verify(jnp.asarray(q.float().numpy()), shard, jnp.asarray(bt), jnp.asarray(ctx))
    nb1 = (NB + 1) // 2
    if quant:
        shards = tuple(tkv.QuantKVCache(tc.q[:, :, i * nb1 : (i + 1) * nb1].contiguous(),
                                        tc.s[:, :, i * nb1 : (i + 1) * nb1].contiguous()) for i in range(2))
    else:
        shards = tuple(tc[:, :, i * nb1 : (i + 1) * nb1].contiguous() for i in range(2))
    sharded = tkv.ShardedKVCache(shards, ())
    parts = []
    bt_t, bt_rows = torch.from_numpy(bt), torch.from_numpy(np.repeat(bt, ROWS, 0))
    for sh, (lg, ig), (lr, ir) in zip(shards, tsp.shard_tables(bt_t, sharded), tsp.shard_tables(bt_rows, sharded)):
        verify = _emulate(q, sh, lg.numpy(), ctx, ROWS, ig.bool().repeat_interleave(BS, 1), exact_rows=True)
        decode = _emulate(q, sh, lr.numpy(), ctx, 1, ir.bool().repeat_interleave(BS, 1), exact_rows=True)
        assert all(torch.equal(a, b) for a, b in zip(verify, decode))
        parts.append(verify)
    o, m, l = parts[1]  # noqa: E741
    assert not o[:ROWS].any() and (m[:ROWS] == M_FLOOR).all() and not l[:ROWS].any()
    got = tsp.merge_partials(parts, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _row_case(hq, hkv, d, ctx0, rows=14, bs=256, seed=1):
    """chip_smoke.py's fallback/partials row: groups of 14 staircase rows at
    contexts ``ctx0``, random pages of 256 keys, bf16 cache and queries."""
    gen = torch.Generator().manual_seed(seed)
    groups = len(ctx0)
    m = -(-(int(max(ctx0)) + rows) // bs)
    nb = groups * m + 8
    cache = torch.randn((2, 2, nb + 1, bs, hkv * d), generator=gen).bfloat16()
    q = torch.randn((groups * rows, hq, d), generator=gen).bfloat16()
    bt = torch.randperm(nb, generator=gen).int()[: groups * m].reshape(groups, m).contiguous()
    ctx = torch.tensor([c + i for c in ctx0 for i in range(rows)], dtype=torch.int32)
    return q, cache, bt, ctx


def _meets_tol(got, want) -> bool:
    try:
        torch.testing.assert_close(got.bfloat16().float(), want.float(), **TOL)
    except AssertionError:
        return False
    return True


@pytest.mark.parametrize("kernel", ["K10b", "K11d"])
def test_one_bf16_p_at_the_rows_shapes_and_at_short_contexts(kernel):
    """K10b at the checkpoint paths' verify chunk (16 groups x 14 rows,
    15x64 heads over 5) and K11d on shard 0 of an sp cache (8x128 over 2,
    int8, even pages local): with contexts 65-2300 (chip_smoke.py's rows)
    one bf16 P meets the bf16 tolerance against the plain version, and
    so does hi + lo; with contexts of 1-64 keys (a verify right after a
    short prompt) one bf16 P misses it and hi + lo meets it."""
    from nano_pearl_tpu_torch.ops.kv_cache import _quantize_rows

    hq, hkv, d = (15, 5, 64) if kernel == "K10b" else (8, 2, 128)
    for lo, hi, one_meets in ((65, 2300, True), (1, 64, False)):
        ctx0 = np.random.default_rng(1).permutation(np.linspace(lo, hi, 16).astype(int))
        q, cache, bt, ctx = _row_case(hq, hkv, d, ctx0)
        local = is_local = None
        if kernel == "K11d":
            values, scales = _quantize_rows(cache.view(-1, hkv, d), torch.int8)
            cache = tkv.QuantKVCache(values.view(cache.shape), scales.view(cache.shape[:-1] + (hkv,)))
            is_local = (torch.arange(bt.shape[1])[None, :] % 2 == 0).expand(bt.shape).int().contiguous()
            local = is_local.bool().repeat_interleave(256, 1)
            want, _, l_want = tatt.paged_attention_grouped_partials_ref(q, cache, 1, bt, ctx, is_local, d**-0.5, 14)
            real = (l_want > 0).all(-1)  # rows that see a key of the shard
        else:
            want = tatt.paged_attention_grouped_ref(q, cache, 1, bt, ctx, d**-0.5, 14)
            real = torch.ones(len(ctx), dtype=torch.bool)
        k, v = tatt._gather_kv(cache, 1, bt, d, torch.bfloat16)
        outs = [walk_emulation(q, k, v, ctx, 14, d**-0.5, cell_keys(hkv), local, parts)[0] for parts in (1, 2)]
        assert _meets_tol(outs[0][real], want[real]) == one_meets, (lo, hi)
        assert _meets_tol(outs[1][real], want[real]), (lo, hi)


# ------------------------------------------- K7 and K6b on the walk (bf16)

# (pre-round context ctx0, real rows of the window) per group: no cache at
# all, windows across a 128-key and a 256-key cell boundary, one real row
# (its padding rows at context 1, as a pre-verify group's), a window deep
# in the table
MONO_GROUPS = ((0, 6), (125, 6), (253, 6), (300, 1), (470, 6))
MONO_ROWS, MONO_BS, MONO_M = 6, 16, 32  # 512 keys a table: 4 cells of 128 or 2 of 256


def _mono_case(hkv, g, d):
    """The deferred verify's operands at bf16 values in f32 (cache, q, fresh
    K/V), one group per MONO_GROUPS entry with random distinct pages,
    staircase contexts ctx0 + 1 .. ctx0 + R (padding rows at 1)."""
    rng = np.random.default_rng(100 + hkv * 10 + g + d)
    groups, r = len(MONO_GROUPS), MONO_ROWS
    nb = groups * MONO_M + 3
    bf = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16().float()  # noqa: E731
    cache = bf(2, 2, nb + 1, MONO_BS, hkv * d)
    q = bf(groups * r, g * hkv, d)
    fk, fv = bf(groups * r, hkv, d), bf(groups * r, hkv, d)
    bt = torch.from_numpy(rng.permutation(nb)[: groups * MONO_M].reshape(groups, MONO_M).astype(np.int32))
    ctx = torch.tensor([c + 1 + i if i < real else 1 for c, real in MONO_GROUPS for i in range(r)], dtype=torch.int32)
    ctx0 = torch.tensor([c for c, _ in MONO_GROUPS], dtype=torch.int32)
    return q, cache, bt, ctx, ctx0, fk, fv, d**-0.5


@pytest.mark.parametrize("hkv,g,d", [(1, 4, 64), (2, 3, 128), (2, 4, 128), (5, 3, 64)])
def test_emulated_k7_and_k6b_match_jax_deferred_verify(hkv, g, d):
    """K7 on the walk (K11c's arithmetic with every slot local, at the
    cache-side contexts min(ctx, ctx0)) and K6b (the cache cells at min(ctx,
    ctx0), then the fresh cell last) emulated at Hkv 1/2/5, G 3/4, D 64/128,
    over groups with no cache (ctx0 = 0), windows across a cell boundary and
    one real row. K7's partials equal the port's plain version's, and a row
    with cache context 0 gives (0, -1e29, 0) exactly; merged with JAX's
    ``fresh_window_partials`` by JAX's ``merge_attn_partials`` they give
    JAX's ``paged_attention_grouped_fresh_jnp``, as K6b does directly, and
    so does the port's plain K6b; all at the f32 tolerance of the tests
    above, 1e-5."""
    q, cache, bt, ctx, ctx0, fk, fv, scale = _mono_case(hkv, g, d)
    r, cell = MONO_ROWS, cell_keys(hkv)
    k, v = tatt._gather_kv(cache, 1, bt, d, torch.float32)
    ctx_cache = torch.minimum(ctx, ctx0.repeat_interleave(r))
    assert (ctx_cache == 0).any() and any(c0 // cell != (c0 + n) // cell for c0, n in MONO_GROUPS if c0)

    o7, m7, l7 = walk_emulation(q, k, v, ctx_cache, r, scale, cell)
    want = tatt.paged_attention_grouped_cache_partials_ref(q, cache, 1, bt, ctx_cache, scale, r)
    for got, w in zip((o7, m7, l7), want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)
    empty = ctx_cache == 0
    assert not o7[empty].any() and (m7[empty] == M_FLOOR).all() and not l7[empty].any()

    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    jfresh = jatt.paged_attention_grouped_fresh_jnp(j(q), j(cache), jnp.int32(1), j(bt), j(ctx), j(ctx0), j(fk),
                                                     j(fv), scale)
    of, mf, lf = jatt.fresh_window_partials(j(q), j(fk), j(fv), j(ctx), j(ctx0), scale, r)
    merged = jatt.merge_attn_partials(j(o7), j(m7), j(l7), of, mf, lf, jnp.float32)
    np.testing.assert_allclose(np.asarray(merged), np.asarray(jfresh), rtol=1e-5, atol=1e-5)

    groups = len(MONO_GROUPS)
    o6b = walk_emulation(q, k, v, ctx, r, scale, cell,
                         fresh=(fk.reshape(groups, r, hkv, d), fv.reshape(groups, r, hkv, d), ctx0))[0]
    np.testing.assert_allclose(o6b.numpy(), np.asarray(jfresh), rtol=1e-5, atol=1e-5)
    plain = tatt.paged_attention_grouped_fresh_ref(q, cache, 1, bt, ctx, ctx0, fk, fv, scale)
    np.testing.assert_allclose(plain.numpy(), np.asarray(jfresh), rtol=1e-5, atol=1e-5)
