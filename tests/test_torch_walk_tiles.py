"""The page walk behind K10a-d, K11a-d and the bf16 route of K1, K2, K5,
K6a, K6b, K7, K8a, K8b and K9a-c (csrc/paged_walk.cuh) on the CPU.

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
  Pallas): ``paged_attention_jnp`` (K10a; K1 at a fast-route shape, Hkv *
  D = 128), ``paged_attention_grouped`` (K10b; K2 there) and, per shard
  with the port's merge, ``parallel/sp.
  sp_paged_attention_grouped`` on a (sp=2, tp=1) mesh (K11c/K11d), at
  tests/test_torch_sp.py's f32 tolerance, 1e-5. Over an int8 or e4m3
  cache (the 1-byte path of K9a/K9b and K10c/K10d) the JAX side reads the
  values the walk reads: written by JAX's ``write_kv``,
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
- The split-boundary schedule's K8a and K8b and the db schedule's K6a on
  the walk: the cells with a cut (``key_cells``' cut, ``launch_cells``,
  ``row_cells``) cover each row's keys once, in order, and a K8b row folds
  the cells of its K8a row; emulated (``exact_rows``), K8b rows equal K8a
  rows bit for bit, K8a matches JAX's ``paged_attention_split`` and K6a
  and K8b ``paged_attention_grouped_fresh_jnp`` at 1e-5; a deferred verify
  takes at most ``cell_keys(hkv)`` rows a group.
- Which launch K1's, K2's, K9a's, K9b's, K6a's, K8a's and K8b's wrappers
  reach: the walk's for bf16 queries (its 1-byte export for K9a/K9b), the
  chunk template's for f32 ones, each counting its own launches.
- The mono schedule's K5 and K9c with bf16 queries on K1/K2's and
  K9a/K9b's walk: their plan at the throughput paths' shapes, an emulation
  at their decode and 14-row verify shapes that matches JAX's jnp paths at
  1e-5 (verify rows equal to decode rows bit for bit), and which launch
  their wrappers reach.
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
from nano_pearl_tpu_torch.ops.cuda.paged_walk import (
    KEYS,
    MAX_SMEM,
    THREADS,
    cell_keys,
    fresh_cells,
    key_cells,
    launch_cells,
    n_cells,
    row_cells,
    rows_per_block,
    walk_plan,
)
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
    warps. K1 / K2 at the main path's decode and verify (1 and 14 rows, G 4,
    D 128) and the serve pair's (1 and 8 rows, G 8, D 64); K9a / K9b at the
    quantized path's (1 and 14 rows, G 4, D 128, int8) and K9b at D 256, G 8
    over 1 byte."""
    k10b = walk_plan(14, 3, 5, 64, 256, 2)
    assert (k10b.cell, k10b.rpb, k10b.threads, k10b.stages) == (256, 14, 128, 3)
    k11d = walk_plan(14, 4, 2, 128, 256, 2, True)
    assert (k11d.cell, k11d.rpb, k11d.threads, k11d.stages) == (128, 14, 128, 2)
    assert k11d.smem == 2 * 136 * 64 + 2 * 64 * 144 * 2 + 2 * 2 * 136 * 64 + 4 * 64 * 2 + 4 * 128 * 3
    d256 = walk_plan(14, 8, 2, 256, 256, 2)
    assert (d256.rpb, d256.threads, d256.stages) == (14, 224, 2)
    assert walk_plan(14, 16, 2, 256, 256, 2).rpb == 8  # 128 vectors a block: 8 + 6 rows
    assert walk_plan(1, 3, 5, 64, 256, 2).threads == 128  # decode: one warp of rows, 4 warps
    # K1 / K2 on the main path (8x128 heads over 2, pages of 256): the decode's
    # 4 vectors in one warp of a 4-warp block, a verify group's 14 rows (56
    # vectors) in 4 warps; 128-key cells hold 2 tiles, so 2 stages
    for rows in (1, 14):
        p = walk_plan(rows, 4, 2, 128, 256, 2)
        assert (p.cell, p.rpb, p.threads, p.stages) == (128, rows, 128, 2), rows
    assert walk_plan(14, 4, 2, 128, 256, 2).smem == 2 * 136 * 64 + 2 * 2 * 136 * 64 * 2 + 4 * 64 * 2 + 4 * 128
    # ... and on the serve pair (16x64 over 2, G 8): the decode's 8 vectors, a
    # verify group's 8 rows (64 vectors) in 4 warps
    for rows in (1, 8):
        p = walk_plan(rows, 8, 2, 64, 256, 2)
        assert (p.cell, p.rpb, p.threads, p.stages) == (128, rows, 128, 2), rows
    # K9a / K9b on the quantized path (the main path's heads over a 1-byte
    # cache): K11d's tiles, raw bytes in the ring and one dequantized tile
    for rows in (1, 14):
        p = walk_plan(rows, 4, 2, 128, 256, 2, True)
        assert (p.cell, p.rpb, p.threads, p.stages) == (128, rows, 128, 2), rows
        mrows = 16 if rows == 1 else 64
        assert p.smem == 2 * 136 * mrows + 2 * 64 * 144 * 2 + 2 * 2 * 136 * 64 + 4 * 64 * 2 + 4 * 128 * 3
    # ... and K9b at D 256, G 8: 14 rows (112 vectors) in 7 warps, Q 59,136 +
    # ring 69,632 + dequantized tile 67,584 + tags 512 + slots and scales 1,536
    q8_d256 = walk_plan(14, 8, 2, 256, 256, 2, True)
    assert (q8_d256.cell, q8_d256.rpb, q8_d256.threads, q8_d256.stages) == (128, 14, 224, 2)
    assert q8_d256.smem == 2 * 264 * 112 + 2 * 64 * 272 * 2 + 2 * 2 * 264 * 64 + 4 * 64 * 2 + 4 * 128 * 3
    assert q8_d256.smem == 198_400 <= MAX_SMEM
    # K5 / K9c on the throughput and quant-throughput paths (the main path's
    # heads, 32 tables of 16 pages of 256 keys): K1/K2's plan (K9a/K9b's over
    # 1 byte), one slice of rows a (group, KV head), 32 cells of 128 keys,
    # 32 * 2 * 32 walk blocks a launch
    for q8 in (False, True):
        for rows in (1, 14):
            p = walk_plan(rows, 4, 2, 128, 256, 2, q8)
            assert (p.cell, p.rpb, p.threads, p.stages) == (128, rows, 128, 2), rows
            assert n_cells(16 * 256, p.cell) * 2 * 32 * -(-rows // p.rpb) == 2048
    # ... at D 256: G 4 (chip_smoke.py's row) in one slice of 14 rows, G 16
    # over 1 byte in two (8 + 6 rows)
    assert walk_plan(14, 4, 2, 256, 256, 2).rpb == 14
    assert walk_plan(14, 16, 2, 256, 256, 2, True).rpb == 8


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


def in_order_sum(x):
    """The sum over the last axis, added in index order one element at a time:
    each value's bits depend on its own terms alone, whatever the shape of
    ``x`` (torch's reductions pick their order by the shape)."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def exp(x, base=None):
    """e^x (2^x with ``base`` 2) of f32 ``x``, taken in f64 and rounded to f32:
    torch's f32 exp takes a vector path or a scalar one by an element's place
    in the tensor, whose last bits differ; rounded from f64, a value's bits
    depend on it alone."""
    return (torch.exp2 if base == 2 else torch.exp)(x.double()).float()


def walk_emulation(q, k, v, ctx, rows, scale, cell, local=None, p_parts=2, exact_rows=False, fresh=None, cut=None):
    """The bf16 route's arithmetic: q [B*R, Hq, D] (bf16 values), k, v [B, S,
    Hkv, D] (bf16 values) of each group's table of S = M * BS keys, ctx
    [B*R] (taken within S), ``local`` [B, S] (K11: the shard's keys) or
    None. Cells of ``cell`` keys from key 0, 64-key tiles within them;
    f32 scores in log2 units, the running max from -1e29, a key no row sees
    at -inf (p = 0), P V with P as ``p_parts`` bf16 parts (1: bf16(p); 2:
    hi + lo); each cell's (acc, m, l) with m in natural-log units (-1e29
    where l = 0); one cell written directly, several folded in order over
    the row's cells below its context with l > 0 (``exp`` in f64, rounded to
    f32). ``exact_rows`` takes every sum of products in index order
    (``in_order_sum``), so a row's bits depend on its own terms alone. ``fresh`` (K6a, K6b): (fk, fv [B, R, Hkv,
    D], ctx0 [B]); the cache cells then end at each group's ctx0 (a row sees
    min(ctx, ctx0) of them) and one more cell holds the R fresh keys at
    positions ctx0 + t, seen where below the row's context, folded after
    the row's cache cells. ``cut`` [B]: each group's own cells
    (``key_cells`` / ``fresh_cells``): K8a's b1 cuts the table cell that
    holds it; with ``fresh`` (K8b) it is ctx0, and the fresh window is cut
    at the cell multiple inside it. Returns (o f32 unrounded, m, l) [B*R,
    Hq (, D)]."""
    n, hq, d = q.shape
    b, s, hkv, _ = k.shape
    if cut is not None and b > 1:  # each group's own cells, one group at a time
        one = lambda t, i: t[i * rows : (i + 1) * rows]  # noqa: E731
        outs = [walk_emulation(one(q, i), k[i : i + 1], v[i : i + 1], one(ctx, i), rows, scale, cell,
                               None if local is None else local[i : i + 1], p_parts, exact_rows,
                               None if fresh is None else tuple(t[i : i + 1] for t in fresh), cut[i : i + 1])
                for i in range(b)]
        return tuple(torch.cat(t) for t in zip(*outs))
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
        [B, n, Hkv, D] seen as vis_c [B, R, n], in 64-key tiles from its first
        (a short last tile filled with keys no row sees, as the kernel's)."""
        m = torch.full((b, rows, hkv, g), M_FLOOR)
        l = torch.zeros((b, rows, hkv, g))  # noqa: E741
        acc = torch.zeros((b, rows, hkv, g, d))
        for t0 in range(0, kc.shape[1], KEYS):
            kt, vt = kc[:, t0 : t0 + KEYS].float(), vc[:, t0 : t0 + KEYS].float()
            pad = KEYS - kt.shape[1]
            kt, vt = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (kt, vt))
            seen = torch.nn.functional.pad(vis_c[:, :, t0 : t0 + KEYS], (0, pad))
            if exact_rows:
                sc = in_order_sum(qf[:, :, :, :, None, :] * kt.permute(0, 2, 1, 3)[:, None, :, None])
            else:
                sc = torch.einsum("brkgd,btkd->brkgt", qf, kt)
            sc = torch.where(seen[:, :, None, None], sc, torch.tensor(float("-inf")))
            mn = torch.maximum(m, sc.amax(-1) * sl2)
            p = exp(sc * sl2 - mn[..., None], 2)
            alpha = exp(m - mn, 2)
            l = l * alpha + p.sum(-1)  # noqa: E741
            hi_p = p.bfloat16().float()
            pv = 0
            for pp in [hi_p] + ([(p - hi_p).bfloat16().float()] if p_parts == 2 else []):
                if exact_rows:
                    pv = pv + in_order_sum(pp[..., None, :] * vt.permute(0, 2, 3, 1)[:, None, :, None])
                else:
                    pv = pv + torch.einsum("brkgt,btkd->brkgd", pp, vt)
            acc = acc * alpha[..., None] + pv
            m = mn
        return acc, torch.where(l > 0, m * LN2, torch.tensor(M_FLOOR)), l

    parts, uses = [], []
    table_cut = None if cut is None or fresh is not None else int(cut[0])
    for lo, hi in key_cells(s, cell, table_cut):
        if lo >= hi:  # K8a's cell where b1 cuts none: no row sees a key of it
            continue
        acc, mc, lc = fold_cell(k[:, lo:hi], v[:, lo:hi], vis[:, :, lo:hi])
        parts.append((acc, mc, lc))
        uses.append((lo < lim)[:, :, None, None] & (lc > 0))
    if fresh is not None:
        fk, fv, ctx0 = fresh
        pos = ctx0[:, None] + torch.arange(rows)[None, :]  # [B, R] the fresh keys' positions
        # the fresh rows of each fresh cell: all R, or (K8b) cut at the cell multiple
        spans = [(0, rows)] if cut is None else [
            (lo - int(ctx0[0]), hi - int(ctx0[0])) for lo, hi in fresh_cells(int(ctx0[0]), rows, cell, True)]
        for t0, t1 in spans:
            if t0 >= t1:
                continue
            acc, mc, lc = fold_cell(fk[:, t0:t1], fv[:, t0:t1], pos[:, None, t0:t1] < ctx[:, :, None])
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
            w = exp(mc - mg)
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


def _caches(quant, hkv=HKV, d=D):
    """The JAX cache and the port's copy of it (``hkv`` KV heads of ``d``):
    bf16-valued f32 rows, or an
    int8 or e4m3 (``"fp8"``) cache written by JAX's ``write_kv`` (the port's
    copy; e4m3 bytes move as uint8, which ``torch.from_numpy`` takes, and
    are viewed as ``float8_e4m3fn``) and, for JAX, its values dequantized
    and rounded to bf16 as the walk reads them, as f32 rows: the port's
    dequantized values equal JAX's ``dequant_rows`` of its own cache, rounded
    to bf16, bit for bit."""
    rng = np.random.default_rng(11)
    n = (NB + 1) * BS
    if quant is None:
        rows = rng.standard_normal((L, 2, NB + 1, BS, hkv * d)).astype(np.float32)
        rows = torch.from_numpy(rows).bfloat16().float().numpy()
        return jnp.asarray(rows), torch.from_numpy(rows.copy())
    jc = jkv.make_kv_cache(L, NB, BS, hkv, d, quant=quant, dtype=jnp.float32)
    for li in range(L):
        k = rng.standard_normal((n, hkv, d)).astype(np.float32) * rng.uniform(0.2, 3, (n, hkv, 1))
        v = rng.standard_normal((n, hkv, d)).astype(np.float32)
        jc = jkv.write_kv(jc, jnp.asarray(k), jnp.asarray(v), jnp.arange(n, dtype=jnp.int32), jnp.int32(li))
    stride = jc["s"].shape[-1] // hkv
    s = torch.from_numpy(np.asarray(jc["s"])[..., ::stride].view(np.int16).copy()).view(torch.bfloat16)
    values = np.asarray(jc["q"])
    if quant == "fp8":
        q8 = torch.from_numpy(values.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    else:
        q8 = torch.from_numpy(values.copy())
    tc = tkv.QuantKVCache(q8, s)
    read = tkv.dequant_rows(tc.q, tc.s, d).bfloat16().float().reshape(tc.q.shape)
    jax_read = jkv.dequant_rows(jc["q"], jc["s"], d).astype(jnp.bfloat16).astype(jnp.float32)
    np.testing.assert_array_equal(read.numpy(), np.asarray(jax_read).reshape(read.shape))
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


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_emulated_walk_matches_jax_decode_and_verify(quant):
    """K10b (groups of 3 rows sharing a table) and K10a (one row a table)
    emulated against JAX's ``paged_attention_grouped(..., use_pallas=False)``
    and ``paged_attention_jnp``, contexts at each side of the cell
    boundaries, of 1 and past the table; the verify rows equal the decode
    rows bit for bit. Over an int8 or e4m3 cache this is the walk's 1-byte
    path, which K10c/K10d and, for bf16 queries, K9a/K9b launch, on the same
    quantized values and scales as JAX's. Tolerance 1e-5: both sides sum
    the same bf16-valued products in f32, in other orders."""
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


@pytest.mark.parametrize("g", [4, 8])
def test_emulated_walk_matches_jax_at_k1_k2_shapes(g):
    """K1 and K2's bf16 route, the same walk, at a fast-route shape (Hkv 2,
    D 64: Hkv * D = 128, where ``attention_kernel`` sends decode to K1 and
    verify to K2) and G 4 and 8, emulated against JAX's
    ``paged_attention_jnp`` and ``paged_attention_grouped(...,
    use_pallas=False)`` on bf16-valued f32 inputs, with contexts at each side
    of the 128-key cell boundaries, of 1, and past the table; the verify
    rows equal the decode rows bit for bit."""
    hkv, d = 2, 64
    hq, scale = g * hkv, d**-0.5
    rng = np.random.default_rng(13 + g)
    rows_ = rng.standard_normal((L, 2, NB + 1, BS, hkv * d)).astype(np.float32)
    rows_ = torch.from_numpy(rows_).bfloat16().float().numpy()
    jc, tc = jnp.asarray(rows_), torch.from_numpy(rows_.copy())
    groups = len(CTX0)
    bt = np.stack([rng.permutation(NB)[:M] for _ in range(groups)]).astype(np.int32)
    ctx = np.array([c + i for c in CTX0 for i in range(ROWS)], np.int32)
    q = torch.from_numpy(rng.standard_normal((groups * ROWS, hq, d)).astype(np.float32)).bfloat16()
    qj = jnp.asarray(q.float().numpy())
    want = jatt.paged_attention_grouped(qj, jc, jnp.int32(1), jnp.asarray(bt), jnp.asarray(ctx), scale, ROWS,
                                        use_pallas=False)
    bt_rows = np.repeat(bt, ROWS, 0)
    want_rows = jatt.paged_attention_jnp(qj, jc, jnp.int32(1), jnp.asarray(bt_rows), jnp.asarray(ctx), scale)
    cell = cell_keys(hkv)
    assert cell == 128 and any(c < cell <= c + ROWS - 1 or c < 2 * cell <= c + ROWS - 1 for c in CTX0)

    def emulate(tables, rows):
        k, v = tatt._gather_kv(tc, 1, torch.from_numpy(tables), d, torch.bfloat16)
        return walk_emulation(q, k, v, torch.from_numpy(ctx), rows, scale, cell, exact_rows=True)[0]

    verify, decode = emulate(bt, ROWS), emulate(bt_rows, 1)
    np.testing.assert_allclose(verify.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(decode.numpy(), np.asarray(want_rows), rtol=1e-5, atol=1e-5)
    assert torch.equal(verify, decode)


def _record_launches(monkeypatch) -> list:
    """Replace the walk's launch (and its library, by a stand-in whose
    exports are their names) and the chunk template's launch by recorders;
    returns the list they append to: ("walk", the stand-in library, export,
    quant, rows) or ("chunk", entry, rows)."""
    from types import SimpleNamespace

    from nano_pearl_tpu_torch.ops.cuda import paged_attention as kpa
    from nano_pearl_tpu_torch.ops.cuda import paged_walk

    calls = []
    fake = SimpleNamespace(npt_walk="npt_walk", npt_walk_q8="npt_walk_q8")
    monkeypatch.setattr(paged_walk, "_lib", lambda: fake)

    def walk(lib, fn, quant, q, cache, layer, tables, ctx, scale, rows, **kw):
        calls.append(("walk", lib is fake, fn, quant, rows))
        return torch.empty_like(q)

    def chunk(fn, q, cache, layer, tables, ctx, scale, rows):
        calls.append(("chunk", fn, rows))
        return torch.empty_like(q)

    monkeypatch.setattr(paged_walk, "launch", walk)
    monkeypatch.setattr(kpa, "_launch", chunk)
    return calls


def test_k1_k2_route_by_query_type(monkeypatch):
    """The wrappers of K1 and K2 on a tensor that is not on the CPU (here
    on the meta device, with the launches replaced by recorders): bf16
    queries reach the page walk's launch (``paged_walk.launch`` of the
    walk's export ``npt_walk``, the cache taken as bf16), f32 queries the
    chunk template's (``npt_paged_decode`` / ``npt_paged_verify``), and each
    call counts one launch of its own kernel and none of K10a/K10b's."""
    from nano_pearl_tpu_torch.ops.cuda import paged_attention as kpa
    from nano_pearl_tpu_torch.ops.cuda import paged_attention_fallback as kfb

    calls = _record_launches(monkeypatch)
    counters = (kpa.paged_decode, kpa.paged_verify, kfb.paged_decode_fallback, kfb.paged_verify_fallback)
    for dtype in (torch.bfloat16, torch.float32):
        meta = dict(dtype=dtype, device="meta")
        q, cache = torch.empty((6, 8, 128), **meta), torch.empty((2, 2, 9, 256, 256), **meta)
        bt = torch.empty((6, 4), dtype=torch.int32, device="meta")
        ctx = torch.empty(6, dtype=torch.int32, device="meta")
        before = [fn.launches for fn in counters]
        assert kpa.paged_decode(q, cache, 1, bt, ctx, 0.1).shape == q.shape
        assert kpa.paged_verify(q, cache, 1, bt[:2], ctx, 0.1, 3).shape == q.shape
        assert [fn.launches - n for fn, n in zip(counters, before)] == [1, 1, 0, 0]
        if dtype == torch.bfloat16:
            assert calls[-2:] == [("walk", True, "npt_walk", False, 1), ("walk", True, "npt_walk", False, 3)]
        else:
            assert calls[-2:] == [("chunk", "npt_paged_decode", 1), ("chunk", "npt_paged_verify", 3)]
    with pytest.raises(ValueError):  # K2 takes two rows a group or more, on either route
        kpa.paged_verify(q, cache, 1, bt, ctx, 0.1, 1)


def test_k9_route_by_query_type(monkeypatch):
    """The wrappers of K9a and K9b on an int8 cache that is not on the CPU
    (the meta device, the launches replaced by recorders): bf16 queries
    reach the page walk's launch of its 1-byte export ``npt_walk_q8`` with
    ``quant`` set (K10c/K10d's launch), f32 queries the chunk template's
    ``npt_paged_decode_q8`` / ``npt_paged_verify_q8``; each call counts one
    launch of its own kernel and none of K10c/K10d's, and K9b refuses one
    row a group on either route."""
    from nano_pearl_tpu_torch.ops.cuda import paged_attention as kpa
    from nano_pearl_tpu_torch.ops.cuda import paged_attention_fallback as kfb

    calls = _record_launches(monkeypatch)
    cache = tkv.QuantKVCache(torch.empty((2, 2, 9, 256, 256), dtype=torch.int8, device="meta"),
                             torch.empty((2, 2, 9, 256, 2), dtype=torch.bfloat16, device="meta"))
    bt = torch.empty((6, 4), dtype=torch.int32, device="meta")
    ctx = torch.empty(6, dtype=torch.int32, device="meta")
    counters = (kpa.paged_decode_q8, kpa.paged_verify_q8, kfb.paged_decode_fallback_q8,
                kfb.paged_verify_fallback_q8, kpa.paged_decode, kpa.paged_verify)
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.empty((6, 8, 128), dtype=dtype, device="meta")
        before = [fn.launches for fn in counters]
        assert kpa.paged_decode_q8(q, cache, 1, bt, ctx, 0.1).shape == q.shape
        assert kpa.paged_verify_q8(q, cache, 1, bt[:2], ctx, 0.1, 3).shape == q.shape
        assert [fn.launches - n for fn, n in zip(counters, before)] == [1, 1, 0, 0, 0, 0]
        if dtype == torch.bfloat16:
            assert calls[-2:] == [("walk", True, "npt_walk_q8", True, 1), ("walk", True, "npt_walk_q8", True, 3)]
        else:
            assert calls[-2:] == [("chunk", "npt_paged_decode_q8", 1), ("chunk", "npt_paged_verify_q8", 3)]
        n = len(calls)
        with pytest.raises(ValueError):  # K9b takes two rows a group or more, on either route
            kpa.paged_verify_q8(q, cache, 1, bt, ctx, 0.1, 1)
        assert len(calls) == n


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


# ------------------------------- K6a, K8a and K8b on the walk (bf16): the cut


@pytest.mark.parametrize("cell", [128, 256])
def test_cut_cells_cover_the_key_stream_once_in_order(cell):
    """The cells of a launch with a cut (``key_cells``' cut, ``launch_cells``,
    ``row_cells``; the card's ``WalkCells``): K8a's table holds one cell more
    (``n_cells``), the cell that holds b1 split there when b1 lies inside
    one (else the last cell empty), together every key once, in order; K6a's
    and K8b's launches end the cache cells at ctx0 and add their fresh
    cell(s). For every row the cells the combine folds (``row_cells``) are
    those it sees a key of, and they cover its keys, cache then fresh, once
    and in order."""
    for n_keys in (64, cell - 1, cell, cell + 1, 3 * cell + 17, 4 * cell):
        for b1 in (-1, 0, 1, cell // 2, cell, cell + 3, 2 * cell - 1, n_keys - 1, n_keys, n_keys + 9):
            cells = key_cells(n_keys, cell, b1)
            assert len(cells) == n_cells(n_keys, cell, cut=True) == len(key_cells(n_keys, cell)) + 1
            assert [t for lo, hi in cells for t in range(lo, hi)] == list(range(n_keys))
            inside = 0 < b1 < n_keys and b1 % cell
            assert (b1 in [lo for lo, _ in cells]) == bool(inside) or b1 % cell == 0
            assert inside or cells[-1][0] >= cells[-1][1]
            for ctx in (1, b1, b1 + 1, n_keys, n_keys + 4):
                folded = row_cells(n_keys, cell, ctx, cut=b1)
                keys = [t for i in folded for t in range(cells[i][0], min(cells[i][1], ctx))]
                assert keys == list(range(min(ctx, n_keys))) and folded == list(range(len(folded)))
        for ctx0 in (0, 1, cell - 3, cell, cell + 5, 2 * cell - 1):
            for rows, split in ((1, False), (14, False), (14, True), (cell, True), (cell, False)):
                if ctx0 + rows > n_keys:
                    continue
                cut = ctx0 if split else None
                launch = launch_cells(n_keys, cell, cut, ctx0, rows)
                assert len(launch) == n_cells(n_keys, cell, cut=split, fresh=True)
                assert [t for lo, hi, fresh in launch if fresh for t in range(lo, hi)] == list(
                    range(ctx0, ctx0 + rows))
                assert sum(fresh for *_, fresh in launch) == 1 + split
                for ctx in (1, ctx0, ctx0 + 1, ctx0 + rows // 2 + 1, ctx0 + rows):
                    folded = row_cells(n_keys, cell, ctx, cut, ctx0, rows)
                    keys = [t for i in folded for t in range(launch[i][0], min(launch[i][1], ctx))]
                    assert keys == list(range(min(ctx, ctx0))) + list(range(ctx0, max(ctx, ctx0)))
                    assert all(launch[i][0] < min(launch[i][1], ctx) for i in folded)


@pytest.mark.parametrize("cell", [128, 256])
def test_k8b_rows_fold_the_cells_of_k8a_rows(cell):
    """What K8b == K8a rests on: at b1 = ctx0 and R <= cell, a K8b row of
    context ctx0 < ctx <= ctx0 + R folds the cells of the K8a row of the
    same context (``row_cells``), with the same tile starts (each cell's
    first key) and the same keys, in the same order: ctx0 inside a cell, on a
    cell multiple, 0, and windows that cross a multiple of 128 or 256."""
    n_keys = 4 * cell
    for ctx0 in (0, 1, 50, 125, 128, 250, cell - 1, cell, cell + 100, 2 * cell - 5):
        for rows in (1, 6, 14, cell):
            if ctx0 + rows > n_keys:
                continue
            verify = launch_cells(n_keys, cell, ctx0, ctx0, rows)
            decode = key_cells(n_keys, cell, ctx0)
            for ctx in range(ctx0 + 1, ctx0 + rows + 1):
                v = [(verify[i][0], min(verify[i][1], ctx)) for i in row_cells(n_keys, cell, ctx, ctx0, ctx0, rows)]
                d = [(decode[i][0], min(decode[i][1], ctx)) for i in row_cells(n_keys, cell, ctx, ctx0)]
                assert v == d, (ctx0, rows, ctx)


# (pre-round context ctx0, real rows of the window) per group: no cache,
# contexts 1-64, a window inside a cell, across a 128-key and a 256-key
# multiple, ctx0 on a multiple of 256 and of 128 alone, one real row
SPLIT_GROUPS = ((0, 6), (1, 6), (57, 6), (100, 6), (125, 6), (253, 6), (256, 6), (384, 6), (300, 1))
SPLIT_M = 25  # 400 keys a table: 4 cells of 128 or 2 of 256, the last one short


def _split_case(hkv, g, d):
    """The deferred verify's operands at bf16 values in f32 (``_mono_case``'s
    layout, one group per SPLIT_GROUPS entry) and the draft's copy of the
    cache with each group's fresh rows written at their slots, which K8a
    reads."""
    rng = np.random.default_rng(200 + hkv * 10 + g + d)
    groups, r = len(SPLIT_GROUPS), MONO_ROWS
    nb = groups * SPLIT_M + 3
    bf = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16().float()  # noqa: E731
    cache = bf(2, 2, nb + 1, MONO_BS, hkv * d)
    q = bf(groups * r, g * hkv, d)
    fk, fv = bf(groups * r, hkv, d), bf(groups * r, hkv, d)
    bt = torch.from_numpy(rng.permutation(nb)[: groups * SPLIT_M].reshape(groups, SPLIT_M).astype(np.int32))
    ctx = torch.tensor([c + 1 + i if i < real else 1 for c, real in SPLIT_GROUPS for i in range(r)], dtype=torch.int32)
    ctx0 = torch.tensor([c for c, _ in SPLIT_GROUPS], dtype=torch.int32)
    drafted = cache.clone()
    for i, (c, _) in enumerate(SPLIT_GROUPS):
        for t in range(r):
            page, off = int(bt[i, (c + t) // MONO_BS]), (c + t) % MONO_BS
            drafted[1, 0, page, off] = fk[i * r + t].reshape(-1)
            drafted[1, 1, page, off] = fv[i * r + t].reshape(-1)
    return q, cache, drafted, bt, ctx, ctx0, fk, fv, d**-0.5


@pytest.mark.parametrize("hkv,g,d", [(2, 3, 64), (4, 2, 64)])
def test_emulated_k8b_rows_equal_k8a_rows_and_match_jax(hkv, g, d):
    """K8a (each decode row's table cell that holds b1 = ctx0 cut there, over
    the draft's cache with the fresh rows written), K8b (the fresh window cut
    at the cell multiple inside it) and K6a (K6b's launch: one fresh cell)
    emulated with ``exact_rows`` at Hkv 2 and 4 (128- and 256-key cells)
    over SPLIT_GROUPS: every K8b row that sees a fresh key equals its K8a row
    bit for bit; K8a matches JAX's ``paged_attention_split`` on its jnp
    path, K8b and K6a JAX's ``paged_attention_grouped_fresh_jnp``, at the
    f32 tolerance of the tests above, 1e-5."""
    q, cache, drafted, bt, ctx, ctx0, fk, fv, scale = _split_case(hkv, g, d)
    r, cell, groups = MONO_ROWS, cell_keys(hkv), len(SPLIT_GROUPS)
    assert any(c // 128 != (c + n) // 128 and (c + n) // 256 == c // 256 for c, n in SPLIT_GROUPS)
    b1 = ctx0.repeat_interleave(r)
    bt_rows = bt.repeat_interleave(r, 0)
    kd, vd = tatt._gather_kv(drafted, 1, bt_rows, d, torch.float32)
    k8a = walk_emulation(q, kd, vd, ctx, 1, scale, cell, exact_rows=True, cut=b1)[0]
    k, v = tatt._gather_kv(cache, 1, bt, d, torch.float32)
    fresh = (fk.reshape(groups, r, hkv, d), fv.reshape(groups, r, hkv, d), ctx0)
    k8b = walk_emulation(q, k, v, ctx, r, scale, cell, exact_rows=True, fresh=fresh, cut=ctx0)[0]
    k6a = walk_emulation(q, k, v, ctx, r, scale, cell, exact_rows=True, fresh=fresh)[0]
    real = ctx > b1
    assert torch.equal(k8b[real], k8a[real])

    import jax

    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    split = jax.jit(lambda *a: jatt.paged_attention_split(a[0], a[1], jnp.int32(1), *a[2:], scale, use_pallas=False))
    want_a = split(j(q), j(drafted), j(bt_rows), j(ctx), j(b1))
    np.testing.assert_allclose(k8a.numpy(), np.asarray(want_a), rtol=1e-5, atol=1e-5)
    fresh_jnp = jax.jit(lambda *a: jatt.paged_attention_grouped_fresh_jnp(a[0], a[1], jnp.int32(1), *a[2:], scale))
    want_b = fresh_jnp(j(q), j(cache), j(bt), j(ctx), j(ctx0), j(fk), j(fv))
    for got in (k8b, k6a):
        np.testing.assert_allclose(got.numpy(), np.asarray(want_b), rtol=1e-5, atol=1e-5)


def test_k6a_k8a_k8b_route_by_query_type(monkeypatch):
    """The wrappers of K6a, K8a and K8b on tensors that are not on the CPU
    (the meta device, the launches replaced by recorders): bf16 queries
    reach the walk's launch (``paged_walk.launch``), K6a with K6b's export
    ``npt_fresh_walk`` and the fresh rows, K8a with ``npt_cut_walk`` and
    its b1 as the cut, K8b with ``npt_cut_walk``, the fresh rows and ctx0
    as the cut; f32 queries reach the chunk template's routes; each call
    counts one launch of its own kernel and none of K6b's."""
    from types import SimpleNamespace

    from nano_pearl_tpu_torch.ops.cuda import mono_attention as kmo
    from nano_pearl_tpu_torch.ops.cuda import paged_attention as kpa
    from nano_pearl_tpu_torch.ops.cuda import paged_attention_partials as kpp
    from nano_pearl_tpu_torch.ops.cuda import paged_walk

    calls = []
    fake = SimpleNamespace(npt_fresh_walk="npt_fresh_walk", npt_cut_walk="npt_cut_walk")
    monkeypatch.setattr(kpp, "_lib", lambda: fake)

    def walk(lib, fn, quant, q, cache, layer, tables, ctx, scale, rows, fresh=None, cut=None, **kw):
        calls.append(("walk", lib is fake, fn, quant, rows, fresh is not None and fresh[0] is c0,
                      None if cut is None else "b1" if cut is b1 else "ctx0" if cut is c0 else "other"))
        return torch.empty_like(q)

    monkeypatch.setattr(paged_walk, "launch", walk)
    monkeypatch.setattr(kpa, "_decode_split_f32", lambda *a: calls.append(("chunk", "split")) or torch.empty_like(a[0]))
    monkeypatch.setattr(kpa, "_fresh_f32",
                        lambda split, *a: calls.append(("chunk", "fresh", split, a[-1])) or torch.empty_like(a[0]))
    counters = (kpa.paged_decode_split, kpa.paged_verify_fresh, kpa.paged_verify_fresh_split, kmo.mono_fresh)
    for dtype in (torch.bfloat16, torch.float32):
        meta = dict(dtype=dtype, device="meta")
        i32 = dict(dtype=torch.int32, device="meta")
        q, cache = torch.empty((6, 8, 128), **meta), torch.empty((2, 2, 9, 256, 256), **meta)
        fk, fv = torch.empty((6, 2, 128), **meta), torch.empty((6, 2, 128), **meta)
        bt, c0 = torch.empty((6, 4), **i32), torch.empty(2, **i32)
        ctx, b1 = torch.empty(6, **i32), torch.empty(6, **i32)
        before = [fn.launches for fn in counters]
        assert kpa.paged_decode_split(q, cache, 1, bt, ctx, b1, 0.1).shape == q.shape
        assert kpa.paged_verify_fresh(q, cache, 1, bt[:2], ctx, c0, fk, fv, 0.1, 3).shape == q.shape
        assert kpa.paged_verify_fresh_split(q, cache, 1, bt[:2], ctx, c0, fk, fv, 0.1, 3).shape == q.shape
        assert [fn.launches - n for fn, n in zip(counters, before)] == [1, 1, 1, 0]
        if dtype == torch.bfloat16:
            assert calls[-3:] == [("walk", True, "npt_cut_walk", False, 1, False, "b1"),
                                  ("walk", True, "npt_fresh_walk", False, 3, True, None),
                                  ("walk", True, "npt_cut_walk", False, 3, True, "ctx0")]
        else:
            assert calls[-3:] == [("chunk", "split"), ("chunk", "fresh", False, 3), ("chunk", "fresh", True, 3)]
        with pytest.raises(ValueError):  # b1 of another length, on either route
            kpa.paged_decode_split(q, cache, 1, bt, ctx, c0, 0.1)


@pytest.mark.parametrize("hkv", [1, 2, 3, 8])
def test_deferred_verify_rows_are_bounded_by_the_cell(hkv):
    """``_fresh_rows``: a deferred verify (K6a, K8b) takes 1 to
    ``cell_keys(hkv)`` rows a group (128 at Hkv <= 2, else 256), so that
    K8b's window crosses at most one cell multiple; more, or none, is
    refused, through the wrappers too."""
    from nano_pearl_tpu_torch.ops.cuda import paged_attention as kpa

    cell = cell_keys(hkv)
    assert kpa._fresh_rows(cell, "k", hkv) == cell and kpa._fresh_rows(1, "k", hkv) == 1
    for bad in (0, cell + 1):
        with pytest.raises(ValueError):
            kpa._fresh_rows(bad, "k", hkv)
    rows, d = cell + 1, 16
    meta = dict(dtype=torch.bfloat16, device="meta")
    q, cache = torch.empty((rows, hkv, d), **meta), torch.empty((1, 2, 3, 256, hkv * d), **meta)
    f = torch.empty((rows, hkv, d), **meta)
    bt, ctx = torch.empty((1, 4), dtype=torch.int32, device="meta"), torch.empty(rows, dtype=torch.int32, device="meta")
    c0 = torch.empty(1, dtype=torch.int32, device="meta")
    for fn in (kpa.paged_verify_fresh, kpa.paged_verify_fresh_split):
        with pytest.raises(ValueError, match=f"<= {cell}"):
            fn(q, cache, 1, bt, ctx, c0, f, f, 0.1, rows)


# ---------------------------- K5 and K9c with bf16 queries (K1/K2's walk)


def _k5_case(g, d, hkv=2, rows=14, seed=14):
    """Groups of ``rows`` staircase rows from CTX0 (each side of the
    128-key cells, 1, the table's end and past it) at G ``g``, D ``d``."""
    rng = np.random.default_rng(seed + g)
    groups = len(CTX0)
    bt = np.stack([rng.permutation(NB)[:M] for _ in range(groups)]).astype(np.int32)
    ctx = np.array([c + i for c in CTX0 for i in range(rows)], np.int32)
    q = torch.from_numpy(rng.standard_normal((groups * rows, g * hkv, d)).astype(np.float32)).bfloat16()
    return q, bt, ctx


@pytest.mark.parametrize("g", [4, 8])
@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_emulated_k5_k9c_walk_matches_jax(quant, g):
    """K5 (bf16 cache) and K9c (int8, e4m3) with bf16 queries, emulated on
    the walk they share with K1/K2 (K9a/K9b), at Hkv 2, D 64 (Hkv * D =
    128, the fast route's shape), G 4 and 8, R 14 (groups of staircase rows
    across the 128-key cell boundaries, from a context of 1, at the table's
    end and past it) and R 1 (each row its own table): the rows match JAX's
    ``paged_attention_grouped(..., use_pallas=False)`` and
    ``paged_attention_jnp`` at 1e-5, the table takes several cells (so the
    combine folds), and the 14-row verify's rows equal the decode's bit for
    bit."""
    hkv, d = 2, 64
    scale = d**-0.5
    jc, tc = _caches(quant, hkv, d)
    q, bt, ctx = _k5_case(g, d, hkv)
    qj = jnp.asarray(q.float().numpy())
    cell = cell_keys(hkv)
    assert cell == 128 and any(c < cell <= c + 13 for c in CTX0) and max(ctx) > M * BS
    assert n_cells(M * BS, cell) > 1
    bt_rows = np.repeat(bt, 14, 0)
    got = {}
    for rows, tables in ((14, bt), (1, bt_rows)):
        if rows == 14:
            want = jatt.paged_attention_grouped(qj, jc, jnp.int32(1), jnp.asarray(bt), jnp.asarray(ctx), scale, 14,
                                                use_pallas=False)
        else:
            want = jatt.paged_attention_jnp(qj, jc, jnp.int32(1), jnp.asarray(bt_rows), jnp.asarray(ctx), scale)
        k, v = tatt._gather_kv(tc, 1, torch.from_numpy(tables), d, torch.bfloat16)
        got[rows] = walk_emulation(q, k, v, torch.from_numpy(ctx), rows, scale, cell, exact_rows=True)
        np.testing.assert_allclose(got[rows][0].numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got[14], got[1]))


def test_k5_k9c_route_by_query_type(monkeypatch):
    """The wrappers of K5 and K9c on tensors that are not on the CPU (the
    meta device, the launches replaced by recorders): bf16 queries reach
    the page walk's launch of K1/K2's export ``npt_walk`` over a bf16 cache
    and of K9a/K9b's ``npt_walk_q8`` with ``quant`` set over an int8 one;
    f32 queries reach the mono template's ``npt_mono_attention`` /
    ``npt_mono_q8``; each call counts one launch of its own kernel and none
    of K1/K2/K9a/K9b/K10a-d's."""
    from nano_pearl_tpu_torch.ops.cuda import mono_attention as kmo
    from nano_pearl_tpu_torch.ops.cuda import paged_attention as kpa
    from nano_pearl_tpu_torch.ops.cuda import paged_attention_fallback as kfb

    calls = _record_launches(monkeypatch)

    def template(fn, what, q, cache, layer, tables, ctx, scale, rows, outs):
        calls.append(("template", fn, rows))

    monkeypatch.setattr(kmo, "_launch", template)
    meta = dict(device="meta")
    bf16_cache = torch.empty((2, 2, 9, 256, 256), dtype=torch.bfloat16, **meta)
    q8_cache = tkv.QuantKVCache(torch.empty((2, 2, 9, 256, 256), dtype=torch.int8, **meta),
                                torch.empty((2, 2, 9, 256, 2), dtype=torch.bfloat16, **meta))
    bt = torch.empty((6, 4), dtype=torch.int32, **meta)
    ctx = torch.empty(6, dtype=torch.int32, **meta)
    counters = (kmo.mono_attention, kmo.mono_q8, kpa.paged_decode, kpa.paged_verify, kpa.paged_decode_q8,
                kpa.paged_verify_q8, *(getattr(kfb, n) for n in ("paged_decode_fallback", "paged_verify_fallback",
                                                                  "paged_decode_fallback_q8",
                                                                  "paged_verify_fallback_q8")))
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.empty((6, 8, 128), dtype=dtype, **meta)
        before = [fn.launches for fn in counters]
        assert kmo.mono_attention(q, bf16_cache.to(dtype), 1, bt, ctx, 0.1).shape == q.shape
        assert kmo.mono_attention(q, bf16_cache.to(dtype), 1, bt[:2], ctx, 0.1, 3).shape == q.shape
        assert kmo.mono_q8(q, q8_cache, 1, bt, ctx, 0.1).shape == q.shape
        assert kmo.mono_q8(q, q8_cache, 1, bt[:2], ctx, 0.1, 3).shape == q.shape
        assert [fn.launches - n for fn, n in zip(counters, before)] == [2, 2] + [0] * 8
        if dtype == torch.bfloat16:
            assert calls[-4:] == [("walk", True, "npt_walk", False, 1), ("walk", True, "npt_walk", False, 3),
                                  ("walk", True, "npt_walk_q8", True, 1), ("walk", True, "npt_walk_q8", True, 3)]
        else:
            assert calls[-4:] == [("template", "npt_mono_attention", 1), ("template", "npt_mono_attention", 3),
                                  ("template", "npt_mono_q8", 1), ("template", "npt_mono_q8", 3)]
