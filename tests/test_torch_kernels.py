"""The hand-written CUDA kernels K1 (paged decode), K2 (packed verify),
K3 (causal prefill), K4 (prefill over a cached prefix), K5 (grouped
attention on the mono schedule), K7 (cache-side partials of the deferred
verify), K12 (the deferred verify's writeback), K9a/K9b/K9c (K1, K2
and K5 over an int8 or e4m3 cache with bf16 scales) and the kernels of
the schedule overrides, K6a/K6b (the deferred verify on the db and mono
schedules, the fresh window in the kernel), K8a (split-boundary decode)
and K8b (split-boundary deferred verify), and the fallbacks K10a-d (decode
and packed verify at the shapes the fast kernels are not routed to, over a
bf16/f32 or a 1-byte cache) and K11a-d (the per-shard flash partials of
sequence parallelism, over two shards of one cache), against their plain
PyTorch versions; K8b's rows against K8a's, K10b's against K10a's, K10d's
against K10c's, K11c's against K11a's and K11d's against K11b's bit for
bit; every kernel at head dims 16 to 256, and the fast kernels at D 256
with a packed-verify group spread over blocks (the launchers'
rows-per-block choice, checked on the CPU too); K7 and K6b with bf16
queries on the tensor-core page walk (edge cases, contexts 1-64 and
65-2300), with f32 queries on the mono template; K1 and K2 with bf16
queries on the same walk (contexts 1-64 too), with f32 queries on the
chunk template; K9a and K9b with bf16 queries on the walk's 1-byte path
(K9b rows equal K9a's bit for bit at D 16-256, G 8, int8 and e4m3,
contexts across the 128-key cells), with f32 queries on the chunk
template, whose 1-byte entries refuse bf16; K6a, K8a and K8b with bf16 queries on the walk (K8a's and
K8b's with its cut cell: K8b rows equal K8a's and K6a rows K6b's bit for
bit, windows across 128- and 256-key multiples, as many rows as a cell,
Hkv 2-4, D 64-256; the cells the launchers read against the mirror's),
with f32 queries on the chunk template's cells; K5 and K9c with bf16
queries on K1/K2's and K9a/K9b's walk and combine (their rows equal K1's
and K9a's bit for bit at D 16-256, G 4/8, R 1 and 14, int8 and e4m3, and
at long contexts; two streams at once), with f32 queries on the mono
template, whose entries refuse bf16 and whose arrival counters are 0
after each call; and which kernels each route launches.

The kernel tests need a CUDA card and skip elsewhere; this file imports
neither JAX nor the JAX package, so the card runs it without the
suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

Tolerances: f32 1e-4 (the kernel folds 64-key tiles with an online
softmax, the plain version one softmax over all keys); bf16 rtol 8e-3,
atol 1e-3 (both accumulate in f32 and round the output to bf16 once, so
they may differ by one bf16 step, at most 2^-7 of the value). K7's m and
l are f32 in both dtypes and held at 1e-4; K12 moves bytes and is held
bit for bit. K9a-c are held at the same tolerances: their plain versions
round the dequantized K/V to the query's dtype, as the kernels do.
"""

import time

import pytest
import torch

from nano_pearl_tpu_torch.ops.cuda import kv_writeback as kkw
from nano_pearl_tpu_torch.ops.cuda import mono_attention as kmo
from nano_pearl_tpu_torch.ops.cuda import paged_attention as kpa
from nano_pearl_tpu_torch.ops.cuda import paged_attention_fallback as kfb
from nano_pearl_tpu_torch.ops.cuda import paged_attention_partials as kpp
from nano_pearl_tpu_torch.ops.cuda import paged_walk as kpw
from nano_pearl_tpu_torch.ops.cuda import prefill_attention as kpf
from nano_pearl_tpu_torch.ops.kv_cache import QuantKVCache

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4), torch.bfloat16: dict(rtol=8e-3, atol=1e-3)}


def paged_case(seed, n_tables, rows, dtype, device, nb=60, bs=32, hq=8, hkv=2, d=128, m=16, nl=2):
    """Random cache and queries, random block tables, staircase contexts;
    every third group of a packed verify is pre-verify style (one real
    row, padding rows at context 1)."""
    g = torch.Generator().manual_seed(seed)
    cache = torch.randn((nl, 2, nb + 1, bs, hkv * d), generator=g).to(dtype)
    q = torch.randn((n_tables * rows, hq, d), generator=g).to(dtype)
    bt = torch.randint(0, nb, (n_tables, m), generator=g, dtype=torch.int32)
    ctx = torch.ones((n_tables, rows), dtype=torch.int32)
    for i in range(n_tables):
        c0 = int(torch.randint(1, m * bs - rows + 1, (1,), generator=g))
        if rows > 1 and i % 3 == 1:
            ctx[i, 0] = c0
        else:
            ctx[i] = torch.arange(c0, c0 + rows, dtype=torch.int32)
    to = lambda x: x.to(device)  # noqa: E731
    return to(q), to(cache), nl - 1, to(bt), to(ctx.reshape(-1)), d**-0.5


def q8_case(seed, n_tables, rows, dtype, kind, device, **kw):
    """``paged_case`` over a quantized cache: random 1-byte values (int8 in
    [-127, 127], or e4m3 of N(0, 4^2)) and random positive bf16 scales per
    slot and KV head."""
    q, cache, layer, bt, ctx, scale = paged_case(seed, n_tables, rows, dtype, "cpu", **kw)
    g = torch.Generator().manual_seed(seed + 1000)
    hkv = cache.shape[-1] // q.shape[-1]
    if kind == "int8":
        values = torch.randint(-127, 128, cache.shape, generator=g, dtype=torch.int8)
    else:
        values = (4 * torch.randn(cache.shape, generator=g)).to(torch.float8_e4m3fn)
    scales = (0.01 + 0.05 * torch.rand(cache.shape[:-1] + (hkv,), generator=g)).to(torch.bfloat16)
    qc = QuantKVCache(values.to(device), scales.to(device))
    return q.to(device), qc, layer, bt.to(device), ctx.to(device), scale


def prefill_case(seed, dtype, device, b=3, lq=70, hq=8, hkv=2, d=128):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b * lq, hq, d), generator=g).to(dtype)
    k = torch.randn((b * lq, hkv, d), generator=g).to(dtype)
    v = torch.randn((b * lq, hkv, d), generator=g).to(dtype)
    pos = torch.full((b, lq), -1, dtype=torch.int32)
    for i, n in enumerate((lq, 37, 0)):  # full, ragged, fully padded
        pos[i, :n] = torch.arange(n, dtype=torch.int32)
    return [x.to(device) for x in (q, k, v, pos)] + [d**-0.5]


def prefix_case(seed, dtype, device, hq=16, hkv=2, d=64, lq=40, nb=40, bs=16, nl=2,
                nc=(37, 64, 0, 20), nn=(40, 17, 25, 0), mpre=8):
    """K4's arguments: a random cache, per-sequence prefix pages, fresh
    q/k/v; by default sequences with a multi-page prefix and a ragged tail,
    a block-aligned prefix, no prefix at all, and a fully padded one."""
    g = torch.Generator().manual_seed(seed)
    cache = torch.randn((nl, 2, nb + 1, bs, hkv * d), generator=g).to(dtype)
    nc = torch.tensor(nc, dtype=torch.int32)
    nn = torch.tensor(nn, dtype=torch.int32)
    b = len(nc)
    bt = torch.full((b, mpre), nb, dtype=torch.int32)  # garbage-block padding
    perm = torch.randperm(nb, generator=g).to(torch.int32)
    used = 0
    for i, c in enumerate(nc.tolist()):
        pages = -(-c // bs)
        bt[i, :pages] = perm[used : used + pages]
        used += pages
    q = torch.randn((b * lq, hq, d), generator=g).to(dtype)
    k = torch.randn((b * lq, hkv, d), generator=g).to(dtype)
    v = torch.randn((b * lq, hkv, d), generator=g).to(dtype)
    to = lambda x: x.to(device)  # noqa: E731
    return [to(q), to(k), to(v), to(cache), nl - 1, to(bt), to(nc), to(nn), d**-0.5]


def writeback_case(seed, dtype, device, nl=3, nb=20, bs=16, hd=256, groups=4, rows=6):
    """K12's arguments: a cache, one round's fresh K/V of every layer, and
    slots as the verify packs them: runs of consecutive slots, one crossing
    a page boundary, and padding rows that share garbage-block slots."""
    g = torch.Generator().manual_seed(seed)
    cache = torch.randn((nl, 2, nb + 1, bs, hd), generator=g).to(dtype)
    fresh = torch.randn((nl, 2, groups * rows, hd), generator=g).to(dtype)
    pages = torch.randperm(nb, generator=g)
    slots = [int(pages[i]) * bs + 3 + j for i in range(groups - 2) for j in range(rows)]
    slots += [int(pages[groups]) * bs + bs - 2 + j if j < 2 else int(pages[groups + 1]) * bs + j - 2
              for j in range(rows)]
    slots += [int(pages[groups + 2]) * bs] + [nb * bs + j % 2 for j in range(1, rows)]
    return cache.to(device), fresh.to(device), torch.tensor(slots, dtype=torch.int32, device=device)


def fresh_case(seed, dtype, device, rows=14, ctx0s=(40, 250, 0, 130), pre=(3,), nb=60, bs=32, hq=8,
               hkv=2, d=128, m=16, nl=2):
    """The deferred verify's arguments and the draft's view of the same
    keys: a random cache, each group's pages from the block manager's pool
    (garbage-block padding), its pre-round context ctx0 (by default a
    window inside a 256-key chunk, one across a chunk multiple, no cache at
    all, and a pre-verify group), fresh K/V of ``rows`` rows per group (row t
    at position ctx0 + t), staircase contexts (groups in ``pre``: one real
    row, then padding rows at context 1 in the garbage block); and a copy of
    the cache with the fresh rows written at their slots, which K8a reads.
    Returns (verify args without scale and rows, the copy, scale)."""
    g = torch.Generator().manual_seed(seed)
    cache = torch.randn((nl, 2, nb + 1, bs, hkv * d), generator=g).to(dtype)
    b = len(ctx0s)
    q = torch.randn((b * rows, hq, d), generator=g).to(dtype)
    fk = torch.randn((b * rows, hkv, d), generator=g).to(dtype)
    fv = torch.randn((b * rows, hkv, d), generator=g).to(dtype)
    perm = torch.randperm(nb, generator=g).to(torch.int32)
    bt = torch.full((b, m), nb, dtype=torch.int32)
    ctx = torch.ones((b, rows), dtype=torch.int32)
    drafted, used = cache.clone(), 0
    for i, c0 in enumerate(ctx0s):
        pages = -(-(c0 + rows) // bs)
        bt[i, :pages] = perm[used : used + pages]
        used += pages
        ctx[i] = torch.arange(c0 + 1, c0 + rows + 1, dtype=torch.int32)
        if i in pre:
            ctx[i, 1:] = 1
        for t in range(rows):
            pos = c0 + t
            page, off = int(bt[i, pos // bs]), pos % bs
            drafted[nl - 1, 0, page, off] = fk[i * rows + t].reshape(-1)
            drafted[nl - 1, 1, page, off] = fv[i * rows + t].reshape(-1)
    to = lambda x: x.to(device)  # noqa: E731
    ctx0 = torch.tensor(ctx0s, dtype=torch.int32)
    args = (to(q), to(cache), nl - 1, to(bt), to(ctx.reshape(-1)), to(ctx0), to(fk), to(fv))
    return args, to(drafted), d**-0.5


FRESH_KERNELS = {  # K6a, K8b, K6b: wrapper, its launch counter
    "K6a": kpa.paged_verify_fresh, "K8b": kpa.paged_verify_fresh_split, "K6b": kmo.mono_fresh,
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def test_wrappers_take_the_plain_version_on_cpu(monkeypatch):
    """CPU tensors go to the plain versions and launch nothing: each wrapper
    returns the very tensor its plain version returned, so the check does
    not rest on the plain version giving the same bits in a second call."""
    returned = []

    def spy(module, name):
        fn = getattr(module, name)

        def call(*args):
            returned.append(fn(*args))
            return returned[-1]

        monkeypatch.setattr(module, name, call)

    spy(kpa, "plain_decode")
    spy(kpa, "plain_verify")
    spy(kpf, "plain_prefill")
    spy(kpf, "plain_prefix")
    spy(kmo, "plain_mono")
    spy(kmo, "plain_partials")
    spy(kkw, "plain_write_fresh")
    counters = (kpa.paged_decode, kpa.paged_verify, kpf.prefill_self, kpf.prefill_prefix,
                kmo.mono_attention, kmo.cache_partials, kkw.write_fresh_kernel)
    before = [fn.launches for fn in counters]
    args = paged_case(0, 4, 1, torch.float32, "cpu")
    assert kpa.paged_decode(*args) is returned[-1]
    args = paged_case(1, 4, 3, torch.float32, "cpu")
    assert kpa.paged_verify(*args, 3) is returned[-1]
    args = prefill_case(2, torch.float32, "cpu")
    assert kpf.prefill_self(*args) is returned[-1]
    args = prefix_case(3, torch.float32, "cpu")
    assert kpf.prefill_prefix(*args) is returned[-1]
    args = paged_case(4, 4, 3, torch.float32, "cpu")
    assert kmo.mono_attention(*args, 3) is returned[-1]
    assert kmo.cache_partials(*args, 3) is returned[-1]
    cache, fresh, slots = writeback_case(5, torch.float32, "cpu")
    assert kkw.write_fresh_kernel(cache, fresh, slots) is returned[-1]
    assert len(returned) == 7
    assert [fn.launches for fn in counters] == before


def test_override_wrappers_take_the_plain_version_on_cpu(monkeypatch):
    """K6a, K6b, K8a and K8b's wrappers: CPU tensors go to the plain
    versions (``paged_attention_grouped_fresh_ref``; K1's for K8a) and
    launch nothing."""
    returned = []
    for module, name in ((kpa, "plain_decode"), (kpa, "plain_fresh"), (kmo, "plain_fresh")):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, fn=fn: returned.append(fn(*a)) or returned[-1])
    counters = (kpa.paged_decode_split, *FRESH_KERNELS.values())
    before = [fn.launches for fn in counters]
    args, drafted, scale = fresh_case(40, torch.float32, "cpu", rows=3)
    q, _, layer, bt, ctx, ctx0 = args[:6]
    for fn in FRESH_KERNELS.values():
        assert fn(*args, scale, 3) is returned[-1]
    b1 = ctx0.repeat_interleave(3)
    assert kpa.paged_decode_split(q, drafted, layer, bt.repeat_interleave(3, 0), ctx, b1, scale) is returned[-1]
    assert len(returned) == 4
    assert [fn.launches for fn in counters] == before


HEADS = [(8, 64), (8, 128), (16, 64)]  # (query heads, head_dim), 2 KV heads: G 4 and 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", HEADS)
def test_paged_decode_matches_plain(cuda, dtype, heads):
    hq, d = heads
    args = paged_case(10, 6, 1, dtype, cuda, hq=hq, d=d)
    n0 = kpa.paged_decode.launches
    got = kpa.paged_decode(*args)
    assert kpa.paged_decode.launches == n0 + 1
    torch.testing.assert_close(got.float(), kpa.plain_decode(*args).float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,heads", [(2, (8, 128)), (14, (8, 128)), (8, (16, 64))])
def test_paged_verify_matches_plain(cuda, dtype, rows, heads):
    hq, d = heads
    args = paged_case(11, 5, rows, dtype, cuda, hq=hq, d=d)
    got = kpa.paged_verify(*args, rows)
    torch.testing.assert_close(got.float(), kpa.plain_verify(*args, rows).float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,heads", [(7, (8, 128)), (8, (16, 64))])
def test_verify_rows_equal_decode_bitwise(cuda, dtype, rows, heads):
    """K2's rows equal K1 on the same query, table and context, bit for bit."""
    hq, d = heads
    q, cache, layer, bt, ctx, scale = paged_case(12, 5, rows, dtype, cuda, hq=hq, d=d)
    grouped = kpa.paged_verify(q, cache, layer, bt, ctx, scale, rows)
    single = kpa.paged_decode(q, cache, layer, bt.repeat_interleave(rows, 0).contiguous(), ctx, scale)
    assert torch.equal(grouped, single)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", HEADS)
def test_prefill_self_matches_plain(cuda, dtype, heads):
    hq, d = heads
    q, k, v, pos, scale = prefill_case(13, dtype, cuda, hq=hq, d=d)
    got, want = kpf.prefill_self(q, k, v, pos, scale), kpf.plain_prefill(q, k, v, pos, scale)
    real = (pos >= 0).reshape(-1)
    torch.testing.assert_close(got[real].float(), want[real].float(), **TOL[dtype])
    assert bool((got[~real] == 0).all())  # the M_FLOOR floor: 0, not NaN


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [(16, 64), (8, 128)])
def test_prefill_prefix_matches_plain(cuda, dtype, heads):
    hq, d = heads
    args = prefix_case(16, dtype, cuda, hq=hq, d=d)
    n0 = kpf.prefill_prefix.launches
    got, want = kpf.prefill_prefix(*args), kpf.plain_prefix(*args)
    assert kpf.prefill_prefix.launches == n0 + 1
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    lq = args[0].shape[0] // 4
    padded = (torch.arange(lq, device=cuda)[None, :] >= args[7][:, None]).reshape(-1)
    assert bool((got[padded] == 0).all())  # padded rows and the n_new = 0 sequence give 0


def test_prefill_prefix_equals_self_without_prefix(cuda):
    """With no cached prefix K4 computes what K3 does on the same rows."""
    q, k, v, cache, layer, bt, nc, nn, scale = prefix_case(17, torch.float32, cuda)
    nc = torch.zeros_like(nc)
    got = kpf.prefill_prefix(q, k, v, cache, layer, bt, nc, nn, scale)
    lq = q.shape[0] // 4
    pos = torch.arange(lq, dtype=torch.int32, device=cuda)[None, :].repeat(4, 1)
    pos = torch.where(pos < nn[:, None], pos, -1).contiguous()
    want = kpf.prefill_self(q, k, v, pos, scale)
    real = (pos >= 0).reshape(-1)
    torch.testing.assert_close(got[real], want[real], **TOL[torch.float32])


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, cache, _, bt, ctx, scale = paged_case(14, 3, 1, torch.float32, cuda, d=64)
    with pytest.raises(ValueError):  # cache on another device
        kpa.paged_decode(q, cache.cpu(), 0, bt, ctx, scale)
    with pytest.raises(ValueError):  # int64 block table
        kpa.paged_decode(q, cache, 0, bt.long(), ctx, scale)
    with pytest.raises(ValueError):  # head_dim 24: not a multiple of 16
        kpa.paged_decode(q[..., :24].contiguous(), cache[..., :48].contiguous(), 0, bt, ctx, scale)
    with pytest.raises(ValueError):  # dtype mismatch
        kpa.paged_decode(q.to(torch.bfloat16), cache, 0, bt, ctx, scale)
    qp, k, v, pos, s = prefill_case(15, torch.float32, cuda)
    with pytest.raises(ValueError):  # non-contiguous q
        kpf.prefill_self(qp.transpose(0, 1), k, v, pos, s)
    q, k, v, cache, layer, bt, nc, nn, s = prefix_case(18, torch.float32, cuda)
    with pytest.raises(ValueError):  # int64 num_cached
        kpf.prefill_prefix(q, k, v, cache, layer, bt, nc.long(), nn, s)
    with pytest.raises(ValueError):  # cache of another dtype
        kpf.prefill_prefix(q, k, v, cache.to(torch.bfloat16), layer, bt, nc, nn, s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 14])
@pytest.mark.parametrize("heads", [(8, 128), (16, 64)])
def test_mono_attention_matches_plain(cuda, dtype, rows, heads):
    """K5 at decode (one row per group) and at a packed verify's 14 rows;
    contexts up to 1280 positions, so groups span several key chunks."""
    hq, d = heads
    args = paged_case(19, 6, rows, dtype, cuda, hq=hq, d=d, m=40)
    n0 = kmo.mono_attention.launches
    got = kmo.mono_attention(*args, rows)
    assert kmo.mono_attention.launches == n0 + 1
    torch.testing.assert_close(got.float(), kmo.plain_mono(*args, rows).float(), **TOL[dtype])
    # the arrival counters are back to zero: a second launch agrees bit for bit
    assert torch.equal(kmo.mono_attention(*args, rows), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cache_partials_match_plain(cuda, dtype):
    """K7 with staircase cache contexts, rows at context 0 and one group
    with no cache context at all."""
    q, cache, layer, bt, ctx, scale = paged_case(20, 5, 14, dtype, cuda, m=40)
    ctx = ctx.clone()
    ctx[::5] = 0
    ctx[14:28] = 0
    n0 = kmo.cache_partials.launches
    got = kmo.cache_partials(q, cache, layer, bt, ctx, scale, 14)
    assert kmo.cache_partials.launches == n0 + 1
    want = kmo.plain_partials(q, cache, layer, bt, ctx, scale, 14)
    torch.testing.assert_close(got[0].float(), want[0].float(), **TOL[dtype])
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, **TOL[torch.float32])
    empty = ctx == 0
    assert bool((got[0][empty] == 0).all() and (got[2][empty] == 0).all())
    assert bool((got[1][empty] == -1e29).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_write_fresh_equals_plain_bitwise(cuda, dtype):
    cache, fresh, slots = writeback_case(21, dtype, cuda)
    want = kkw.plain_write_fresh(cache.clone(), fresh, slots)
    got = cache.clone()
    n0 = kkw.write_fresh_kernel.launches
    assert kkw.write_fresh_kernel(got, fresh, slots) is got
    assert kkw.write_fresh_kernel.launches == n0 + 1
    assert torch.equal(got, want)


def test_throughput_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, cache, layer, bt, ctx, scale = paged_case(22, 3, 2, torch.float32, cuda)
    with pytest.raises(ValueError):  # cache on another device
        kmo.mono_attention(q, cache.cpu(), layer, bt, ctx, scale, 2)
    with pytest.raises(ValueError):  # dtype mismatch
        kmo.cache_partials(q.to(torch.bfloat16), cache, layer, bt, ctx, scale, 2)
    with pytest.raises(ValueError):  # contexts of 3 rows per group for 2
        kmo.mono_attention(q, cache, layer, bt, ctx[:-1].contiguous(), scale, 2)
    cache, fresh, slots = writeback_case(23, torch.float32, cuda)
    with pytest.raises(ValueError):  # int64 slots
        kkw.write_fresh_kernel(cache, fresh, slots.long())
    with pytest.raises(ValueError):  # fresh of another dtype
        kkw.write_fresh_kernel(cache, fresh.to(torch.bfloat16), slots)
    with pytest.raises(ValueError):  # fresh rows != slots
        kkw.write_fresh_kernel(cache, fresh[:, :, :-1].contiguous(), slots)


def test_q8_wrappers_take_the_plain_version_on_cpu(monkeypatch):
    """K9a-c's wrappers, like the others: CPU tensors go to the plain
    versions, which are K1/K2/K5's and read either cache kind, and launch
    nothing."""
    returned = []
    for module, name in ((kpa, "plain_decode"), (kpa, "plain_verify"), (kmo, "plain_mono")):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, fn=fn: returned.append(fn(*a)) or returned[-1])
    counters = (kpa.paged_decode_q8, kpa.paged_verify_q8, kmo.mono_q8)
    before = [fn.launches for fn in counters]
    args = q8_case(30, 4, 1, torch.float32, "int8", "cpu")
    assert kpa.paged_decode_q8(*args) is returned[-1]
    args = q8_case(31, 4, 3, torch.float32, "fp8", "cpu")
    assert kpa.paged_verify_q8(*args, 3) is returned[-1]
    assert kmo.mono_q8(*args, 3) is returned[-1]
    assert len(returned) == 3
    assert [fn.launches for fn in counters] == before


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [(8, 128), (16, 64)])
def test_paged_decode_q8_matches_plain(cuda, kind, dtype, heads):
    hq, d = heads
    args = q8_case(32, 6, 1, dtype, kind, cuda, hq=hq, d=d)
    n0 = kpa.paged_decode_q8.launches
    got = kpa.paged_decode_q8(*args)
    assert kpa.paged_decode_q8.launches == n0 + 1
    torch.testing.assert_close(got.float(), kpa.plain_decode(*args).float(), **TOL[dtype])


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_verify_q8_matches_plain_and_k9a_bitwise(cuda, kind, dtype):
    """K9b at a packed verify's 14 rows against its plain version, and its
    rows against K9a's on the same query, table and context, bit for bit."""
    q, cache, layer, bt, ctx, scale = q8_case(33, 5, 14, dtype, kind, cuda)
    n0 = kpa.paged_verify_q8.launches
    got = kpa.paged_verify_q8(q, cache, layer, bt, ctx, scale, 14)
    assert kpa.paged_verify_q8.launches == n0 + 1
    want = kpa.plain_verify(q, cache, layer, bt, ctx, scale, 14)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    single = kpa.paged_decode_q8(q, cache, layer, bt.repeat_interleave(14, 0).contiguous(), ctx, scale)
    assert torch.equal(got, single)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 14])
def test_mono_q8_matches_plain(cuda, kind, dtype, rows):
    """K9c at decode and at 14 rows per group, contexts up to 1280
    positions (several key chunks per group); a second launch agrees bit
    for bit (the arrival counters are back to zero)."""
    args = q8_case(34, 6, rows, dtype, kind, cuda, m=40)
    n0 = kmo.mono_q8.launches
    got = kmo.mono_q8(*args, rows)
    assert kmo.mono_q8.launches == n0 + 1
    torch.testing.assert_close(got.float(), kmo.plain_mono(*args, rows).float(), **TOL[dtype])
    assert torch.equal(kmo.mono_q8(*args, rows), got)


def test_q8_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, cache, layer, bt, ctx, scale = q8_case(35, 3, 2, torch.float32, "int8", cuda)
    plain = paged_case(35, 3, 2, torch.float32, cuda)[1]
    with pytest.raises(ValueError):  # a bf16/f32 cache for a K9 kernel
        kpa.paged_decode_q8(q, plain, layer, bt.repeat_interleave(2, 0).contiguous(), ctx, scale)
    with pytest.raises(ValueError):  # a quantized cache for K1, K2, K5 and K7
        kpa.paged_decode(q, cache, layer, bt.repeat_interleave(2, 0).contiguous(), ctx, scale)
    with pytest.raises(ValueError):
        kpa.paged_verify(q, cache, layer, bt, ctx, scale, 2)
    with pytest.raises(ValueError):
        kmo.mono_attention(q, cache, layer, bt, ctx, scale, 2)
    with pytest.raises(ValueError):
        kmo.cache_partials(q, cache, layer, bt, ctx, scale, 2)
    with pytest.raises(ValueError):  # scales not one per slot and KV head
        kpa.paged_verify_q8(q, QuantKVCache(cache.q, cache.s[..., :1].contiguous()), layer, bt, ctx,
                            scale, 2)
    with pytest.raises(ValueError):  # values on the CPU
        kmo.mono_q8(q, QuantKVCache(cache.q.cpu(), cache.s), layer, bt, ctx, scale, 2)
    with pytest.raises(ValueError):  # head_dim 24: not a multiple of 16
        kmo.mono_q8(q[..., :24].contiguous(), QuantKVCache(cache.q[..., :48].contiguous(), cache.s),
                    layer, bt, ctx, scale, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", list(FRESH_KERNELS))
def test_verify_fresh_matches_plain(cuda, dtype, kernel):
    """K6a, K8b and K6b at 14 rows per group: a window inside a 256-key
    chunk, one across a chunk multiple, a group with no cache (ctx0 0) and
    a pre-verify group; a second launch agrees bit for bit."""
    fn = FRESH_KERNELS[kernel]
    args, _, scale = fresh_case(41, dtype, cuda)
    n0 = fn.launches
    got = fn(*args, scale, 14)
    assert fn.launches == n0 + 1
    torch.testing.assert_close(got.float(), kpa.plain_fresh(*args, scale).float(), **TOL[dtype])
    assert torch.equal(fn(*args, scale, 14), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_split_matches_plain(cuda, dtype):
    """K8a with boundaries inside a chunk, at a chunk multiple, at 0 and at
    the context, on contexts up to 1,280 positions."""
    q, cache, layer, bt, ctx, scale = paged_case(42, 8, 1, dtype, cuda, m=40)
    b1 = torch.stack([ctx // 3, ctx - ctx % 256, torch.zeros_like(ctx), ctx, ctx - 1, ctx // 2,
                      ctx - 7, ctx - 14]).diagonal().to(torch.int32).contiguous()
    n0 = kpa.paged_decode_split.launches
    got = kpa.paged_decode_split(q, cache, layer, bt, ctx, b1, scale)
    assert kpa.paged_decode_split.launches == n0 + 1
    torch.testing.assert_close(got.float(), kpa.plain_decode(q, cache, layer, bt, ctx, scale).float(),
                               **TOL[dtype])
    assert torch.equal(kpa.paged_decode_split(q, cache, layer, bt, ctx, b1, scale), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [4, 14])
def test_split_verify_rows_equal_split_decode_bitwise(cuda, dtype, rows):
    """K8b's rows equal K8a's, bit for bit, for the same query and context at
    b1 = ctx0, K8a reading the fresh rows from the draft's cache: windows
    inside a chunk and across a chunk multiple, ctx0 = 0 and a pre-verify
    group (its real row)."""
    args, drafted, scale = fresh_case(43, dtype, cuda, rows=rows)
    q, _, layer, bt, ctx, ctx0 = args[:6]
    verify = kpa.paged_verify_fresh_split(*args, scale, rows)
    b1 = ctx0.repeat_interleave(rows)
    decode = kpa.paged_decode_split(q, drafted, layer, bt.repeat_interleave(rows, 0), ctx, b1, scale)
    real = ctx > b1
    assert torch.equal(verify[real], decode[real])


def test_override_wrappers_reject_what_the_kernels_do_not_take(cuda):
    args, drafted, scale = fresh_case(44, torch.float32, cuda, rows=3)
    q, cache, layer, bt, ctx, ctx0, fk, fv = args
    with pytest.raises(ValueError):  # int64 ctx0
        kpa.paged_verify_fresh(q, cache, layer, bt, ctx, ctx0.long(), fk, fv, scale, 3)
    with pytest.raises(ValueError):  # fresh rows of another dtype
        kmo.mono_fresh(q, cache, layer, bt, ctx, ctx0, fk.to(torch.bfloat16), fv, scale, 3)
    with pytest.raises(ValueError):  # fresh rows for fewer query rows
        kpa.paged_verify_fresh_split(q, cache, layer, bt, ctx, ctx0, fk[:-1].contiguous(), fv, scale, 3)
    with pytest.raises(ValueError):  # more rows per group than one key chunk
        kpa.paged_verify_fresh_split(q, cache, layer, bt, ctx, ctx0, fk, fv, scale, 257)
    with pytest.raises(ValueError):  # b1 of another length
        kpa.paged_decode_split(q, drafted, layer, bt.repeat_interleave(3, 0), ctx, ctx0, scale)


FALLBACKS = {  # cache kind -> (decode, verify) wrappers: K10a/K10b, K10c/K10d
    None: (kfb.paged_decode_fallback, kfb.paged_verify_fallback),
    "int8": (kfb.paged_decode_fallback_q8, kfb.paged_verify_fallback_q8),
}


def test_fallback_wrappers_take_the_plain_version_on_cpu(monkeypatch):
    """K10a-d's wrappers: CPU tensors go to K1/K2's plain versions and
    launch nothing."""
    returned = []
    for name in ("plain_decode", "plain_verify"):
        fn = getattr(kfb, name)
        monkeypatch.setattr(kfb, name, lambda *a, fn=fn: returned.append(fn(*a)) or returned[-1])
    counters = [fn for pair in FALLBACKS.values() for fn in pair]
    before = [fn.launches for fn in counters]
    for kind, (dec, ver) in FALLBACKS.items():
        case = q8_case(60, 3, 2, torch.float32, kind, "cpu", hq=4, d=16) if kind else \
            paged_case(60, 3, 2, torch.float32, "cpu", hq=4, d=16)
        q, cache, layer, bt, ctx, scale = case
        assert ver(q, cache, layer, bt, ctx, scale, 2) is returned[-1]
        assert dec(q, cache, layer, bt.repeat_interleave(2, 0), ctx, scale) is returned[-1]
    assert len(returned) == 4
    assert [fn.launches for fn in counters] == before


# (Hq, Hkv, D): the tiny HF models' heads (Hkv * D 32), SmolLM2-360M's (320),
# and the bench pair's (256, aligned: K10 takes it all the same)
FALLBACK_HEADS = [(4, 2, 16), (15, 5, 64), (8, 2, 128)]


@pytest.mark.parametrize("kind", [None, "int8"])
@pytest.mark.parametrize("bs", [16, 256])
@pytest.mark.parametrize("heads", FALLBACK_HEADS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fallback_matches_plain_and_verify_rows_equal_decode_bitwise(cuda, dtype, heads, bs, kind):
    """K10b (K10d) against its plain version, and its rows against K10a
    (K10c) on the same query, table and context, bit for bit."""
    hq, hkv, d = heads
    rows, kw = 5, dict(hq=hq, hkv=hkv, d=d, bs=bs, m=16 if bs == 16 else 4, nb=60 if bs == 16 else 16)
    case = q8_case(61, 4, rows, dtype, kind, cuda, **kw) if kind else paged_case(61, 4, rows, dtype, cuda, **kw)
    q, cache, layer, bt, ctx, scale = case
    dec, ver = FALLBACKS[kind]
    n0 = (dec.launches, ver.launches)
    grouped = ver(q, cache, layer, bt, ctx, scale, rows)
    single = dec(q, cache, layer, bt.repeat_interleave(rows, 0).contiguous(), ctx, scale)
    assert (dec.launches, ver.launches) == (n0[0] + 1, n0[1] + 1)
    want = kfb.plain_verify(q, cache, layer, bt, ctx, scale, rows)
    torch.testing.assert_close(grouped.float(), want.float(), **TOL[dtype])
    assert torch.equal(grouped, single)


def test_fallback_splits_rows_that_do_not_fit(cuda):
    """At D 256 in f32 a group of 14 rows x 4 query heads does not fit in
    one block's shared memory: the rows go to two blocks, with the same
    bits per row."""
    q, cache, layer, bt, ctx, scale = paged_case(62, 3, 14, torch.float32, cuda, hq=8, hkv=2, d=256, m=4)
    grouped = kfb.paged_verify_fallback(q, cache, layer, bt, ctx, scale, 14)
    want = kfb.plain_verify(q, cache, layer, bt, ctx, scale, 14)
    torch.testing.assert_close(grouped, want, **TOL[torch.float32])
    single = kfb.paged_decode_fallback(q, cache, layer, bt.repeat_interleave(14, 0).contiguous(), ctx, scale)
    assert torch.equal(grouped, single)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [(8, 4, 32), (4, 2, 256)])
def test_fast_kernels_take_head_dims_32_and_256(cuda, dtype, heads):
    """K1, K2, K5 and K9a/K9b at D 32 and 256 with an aligned Hkv * D (the
    route's fast shapes): against their plain versions, K2 rows == K1."""
    hq, hkv, d = heads
    rows = 6
    q, cache, layer, bt, ctx, scale = paged_case(63, 3, rows, dtype, cuda, hq=hq, hkv=hkv, d=d, m=8)
    bt_rows = bt.repeat_interleave(rows, 0).contiguous()
    want = kpa.plain_verify(q, cache, layer, bt, ctx, scale, rows)
    grouped = kpa.paged_verify(q, cache, layer, bt, ctx, scale, rows)
    torch.testing.assert_close(grouped.float(), want.float(), **TOL[dtype])
    assert torch.equal(grouped, kpa.paged_decode(q, cache, layer, bt_rows, ctx, scale))
    mono = kmo.mono_attention(q, cache, layer, bt, ctx, scale, rows)
    torch.testing.assert_close(mono.float(), want.float(), **TOL[dtype])
    q, qc, layer, bt, ctx, scale = q8_case(64, 3, rows, dtype, "int8", cuda, hq=hq, hkv=hkv, d=d, m=8)
    grouped = kpa.paged_verify_q8(q, qc, layer, bt, ctx, scale, rows)
    torch.testing.assert_close(grouped.float(), kpa.plain_verify(q, qc, layer, bt, ctx, scale, rows).float(),
                               **TOL[dtype])
    assert torch.equal(grouped, kpa.paged_decode_q8(q, qc, layer, bt.repeat_interleave(rows, 0).contiguous(),
                                                    ctx, scale))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [(4, 2, 16), (8, 2, 256)])
def test_prefill_kernels_take_head_dims_16_and_256(cuda, dtype, heads):
    """K3 and K4 at D 16 and 256 (at 256 the query tile shrinks to fit the
    block's shared memory) against their plain versions."""
    hq, hkv, d = heads
    q, k, v, pos, scale = prefill_case(65, dtype, cuda, hq=hq, hkv=hkv, d=d)
    got, want = kpf.prefill_self(q, k, v, pos, scale), kpf.plain_prefill(q, k, v, pos, scale)
    real = (pos >= 0).reshape(-1)
    torch.testing.assert_close(got[real].float(), want[real].float(), **TOL[dtype])
    args = prefix_case(66, dtype, cuda, hq=hq, hkv=hkv, d=d)
    torch.testing.assert_close(kpf.prefill_prefix(*args).float(), kpf.plain_prefix(*args).float(),
                               **TOL[dtype])


def test_prefill_plan_mirror_matches_the_launchers(cuda):
    """The exported tile choice of K3/K4's launchers (``npt_prefill_plan``)
    equals the mirror ``prefill_plan`` for every head dim and GQA ratio."""
    lib = kpf._lib()
    for d in range(16, 257, 16):
        for g in (1, 2, 3, 4, 5, 8, 16):
            for bf16, size in ((1, 2), (0, 4)):
                for prefix in (False, True):
                    p = kpf.prefill_plan(g, d, size, prefix)
                    got = [lib.npt_prefill_plan(g, d, bf16, int(prefix), w) for w in range(5)]
                    assert got == [p.qt, p.threads, p.smem, p.cell, p.stages], (g, d, size, prefix)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_prefill_kernels_match_plain_at_g1_and_g8(cuda, dtype, g, d):
    """K3 and K4 with one query head per KV head (a block's 16 rows are 16
    query positions; on the tensor-core route 64) and with eight (16 rows
    = 2 positions x 8 heads), at head dims 16 to 256, against their plain
    versions; padded rows and the sequence with n_new = 0 give 0."""
    hq, hkv = 2 * g, 2
    q, k, v, pos, scale = prefill_case(70 + d + g, dtype, cuda, hq=hq, hkv=hkv, d=d)
    got, want = kpf.prefill_self(q, k, v, pos, scale), kpf.plain_prefill(q, k, v, pos, scale)
    real = (pos >= 0).reshape(-1)
    torch.testing.assert_close(got[real].float(), want[real].float(), **TOL[dtype])
    assert bool((got[~real] == 0).all())
    args = prefix_case(71 + d + g, dtype, cuda, hq=hq, hkv=hkv, d=d)
    got = kpf.prefill_prefix(*args)
    torch.testing.assert_close(got.float(), kpf.plain_prefix(*args).float(), **TOL[dtype])
    lq = args[0].shape[0] // 4
    padded = (torch.arange(lq, device=cuda)[None, :] >= args[7][:, None]).reshape(-1)
    assert bool((got[padded] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_prefix_split_matches_plain(cuda, dtype):
    """K4 where the bf16 launcher splits the key stream into cells of
    ``plan.cell`` keys (streams of 1,396 and 1,033 keys: two cells, the
    second one ending inside the fresh rows; 670 and 33: one cell; a fully
    padded sequence over a 1,100-key prefix: two cells, no real row)
    against its plain version; padded rows and n_new = 0 give 0."""
    hq, hkv, d, bs = 16, 2, 64, 16
    assert kpf.prefill_plan(hq // hkv, d, 2, prefix=True).cell == 512
    args = prefix_case(72, dtype, cuda, hq=hq, hkv=hkv, d=d, lq=96, nb=300, bs=bs,
                       nc=(1300, 600, 0, 1024, 1100), nn=(96, 70, 33, 9, 0), mpre=128)
    got = kpf.prefill_prefix(*args)
    torch.testing.assert_close(got.float(), kpf.plain_prefix(*args).float(), **TOL[dtype])
    padded = (torch.arange(96, device=cuda)[None, :] >= args[7][:, None]).reshape(-1)
    assert bool((got[padded] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_prefix_full_table_matches_plain(cuda, dtype):
    """K4 with nc at the table's end (Mpre * BS = 1,024 cached keys, so the
    bf16 launch has two cells and these sequences fill them) and with an nc
    past it (1,500), which the plain version's gather of Mpre pages takes
    as 1,024: against the plain version; padded rows give 0."""
    hq, hkv, d, bs, lq, mpre = 16, 2, 64, 16, 64, 64
    args = prefix_case(75, dtype, cuda, hq=hq, hkv=hkv, d=d, lq=lq, nb=240, bs=bs,
                       nc=(1024, 1024, 1024, 300), nn=(64, 40, 0, 64), mpre=mpre)
    assert len(kpf.key_cells(mpre * bs + lq, kpf.CELL)) == 2
    args[6][1] = 1500
    got = kpf.prefill_prefix(*args)
    torch.testing.assert_close(got.float(), kpf.plain_prefix(*args).float(), **TOL[dtype])
    padded = (torch.arange(lq, device=cuda)[None, :] >= args[7][:, None]).reshape(-1)
    assert bool((got[padded] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_self_rows_do_not_depend_on_the_bucket_bitwise(cuda, dtype):
    """K3's real rows give the same bits in a 128-row and in a 256-row
    bucket: tile and key boundaries are fixed by position, and the rows of
    a block's products are independent."""
    b, hq, hkv, d = 4, 8, 2, 128
    lens = (64, 37, 128, 1)
    g = torch.Generator().manual_seed(73)
    q = torch.randn((b, 128, hq, d), generator=g).to(dtype)
    k = torch.randn((b, 128, hkv, d), generator=g).to(dtype)
    v = torch.randn((b, 128, hkv, d), generator=g).to(dtype)
    outs = []
    for lq in (128, 256):
        pos = torch.full((b, lq), -1, dtype=torch.int32)
        for i, n in enumerate(lens):
            pos[i, :n] = torch.arange(n, dtype=torch.int32)
        pad = lambda x: torch.cat([x, torch.zeros((b, lq - 128) + x.shape[2:], dtype=dtype)], 1)  # noqa: E731
        args = [pad(x).reshape(b * lq, *x.shape[2:]).to(cuda) for x in (q, k, v)]
        out = kpf.prefill_self(*args, pos.to(cuda), d**-0.5).reshape(b, lq, hq, d)
        outs.append(out[:, :128])
    for i, n in enumerate(lens):
        assert torch.equal(outs[0][i, :n], outs[1][i, :n])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_prefix_rows_do_not_depend_on_the_batch_bitwise(cuda, dtype):
    """K4's rows of one sequence give the same bits run alone (its own
    block table, so fewer cells in the launch) and inside a batch of
    sequences with other prefixes."""
    hq, hkv, d, bs, lq = 16, 2, 64, 16, 64
    args = prefix_case(74, dtype, cuda, hq=hq, hkv=hkv, d=d, lq=lq, nb=200, bs=bs,
                       nc=(900, 40, 1500, 512), nn=(50, 64, 20, 7), mpre=128)
    q, k, v, cache, layer, bt, nc, nn, scale = args
    batch = kpf.prefill_prefix(*args)
    for i in range(4):
        rows = slice(i * lq, (i + 1) * lq)
        pages = -(-int(nc[i]) // bs)
        alone = kpf.prefill_prefix(q[rows], k[rows], v[rows], cache, layer, bt[i : i + 1, :pages].contiguous(),
                                   nc[i : i + 1], nn[i : i + 1], scale)
        assert torch.equal(alone, batch[rows])


def test_rows_per_block_choice():
    """The attention launchers' rows-per-block choice (``rows_per_block``,
    the mirror of ``flash_rows_per_block``): a group's rows stay in one
    block where its query vectors fit in shared memory, and are halved
    until they do: at D 256 and G 8, 14 rows go to blocks of 7 in bf16 and
    of 4 in f32, where the fast kernels refused the launch before."""
    rpb = kpw.rows_per_block
    assert rpb(14, 4, 128, 2) == 14  # the main path's verify chunk: one block per group
    assert rpb(14, 4, 128, 4) == 14
    assert rpb(14, 8, 256, 2) == 7
    assert rpb(14, 8, 256, 4) == 4
    assert rpb(1, 8, 256, 4) == 1
    assert rpb(14, 8, 256, 2, fixed=4 * 17) == 7  # K5's work list: (groups + 1) ints more
    for rows, g, d, size in ((14, 8, 256, 2), (14, 8, 256, 4), (64, 4, 128, 2), (14, 16, 64, 4)):
        r = rpb(rows, g, d, size)
        assert r == rows or rpb(2 * r, g, d, size) < 2 * r  # halved only while it did not fit
        assert rpb(r, g, d, size) == r  # the choice fits


def test_rows_per_block_mirror_matches_the_launchers(cuda):
    """The exported choice of the CUDA launchers equals the mirror."""
    lib = kpa._lib()
    for rows in (1, 7, 14, 64):
        for g, d in ((4, 128), (8, 256), (16, 64), (1, 16)):
            for bf16, size in ((1, 2), (0, 4)):
                for fixed, tile in ((0, 64), (4 * 33, 64), (0, 16)):
                    assert lib.npt_rows_per_block(rows, g, d, bf16, fixed, tile) == kpw.rows_per_block(
                        rows, g, d, size, fixed, tile)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fast_kernels_split_rows_that_do_not_fit(cuda, dtype):
    """At D 256 a packed verify of 14 rows over 8 query heads per KV head
    does not fit one block: K2, K9b, K5, K7, K6a, K8b and K6b spread each
    group's rows over blocks and match their plain versions; K2 rows equal
    K1's and K9b rows K9a's bit for bit."""
    rows, hq, hkv, d = 14, 16, 2, 256
    q, cache, layer, bt, ctx, scale = paged_case(67, 3, rows, dtype, cuda, hq=hq, hkv=hkv, d=d, m=4)
    bt_rows = bt.repeat_interleave(rows, 0).contiguous()
    want = kpa.plain_verify(q, cache, layer, bt, ctx, scale, rows)
    grouped = kpa.paged_verify(q, cache, layer, bt, ctx, scale, rows)
    torch.testing.assert_close(grouped.float(), want.float(), **TOL[dtype])
    assert torch.equal(grouped, kpa.paged_decode(q, cache, layer, bt_rows, ctx, scale))
    mono = kmo.mono_attention(q, cache, layer, bt, ctx, scale, rows)
    torch.testing.assert_close(mono.float(), want.float(), **TOL[dtype])
    o, m, l = kmo.cache_partials(q, cache, layer, bt, ctx, scale, rows)  # noqa: E741
    wo, wm, wl = kmo.plain_partials(q, cache, layer, bt, ctx, scale, rows)
    torch.testing.assert_close(o.float(), wo.float(), **TOL[dtype])
    torch.testing.assert_close(m, wm, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(l, wl, rtol=1e-4, atol=1e-4)
    q, qc, layer, bt, ctx, scale = q8_case(68, 3, rows, dtype, "int8", cuda, hq=hq, hkv=hkv, d=d, m=4)
    grouped = kpa.paged_verify_q8(q, qc, layer, bt, ctx, scale, rows)
    torch.testing.assert_close(grouped.float(), kpa.plain_verify(q, qc, layer, bt, ctx, scale, rows).float(),
                               **TOL[dtype])
    assert torch.equal(grouped, kpa.paged_decode_q8(q, qc, layer, bt.repeat_interleave(rows, 0).contiguous(),
                                                    ctx, scale))
    args, _, scale = fresh_case(69, dtype, cuda, rows=rows, hq=hq, hkv=hkv, d=d)
    want = kpa.plain_fresh(*args, scale)
    for fn in FRESH_KERNELS.values():
        torch.testing.assert_close(fn(*args, scale, rows).float(), want.float(), **TOL[dtype])


PARTIALS = {None: (kpp.paged_decode_partials, kpp.paged_verify_partials),
            "int8": (kpp.paged_decode_partials_q8, kpp.paged_verify_partials_q8)}


def partials_case(seed, rows, dtype, kind, device, nb=30, **kw):
    """``paged_case`` (or ``q8_case``) whose tables draw from the cache's
    first nb = 30 blocks, split into two shards of 15 (the garbage block
    left out): (q, the two shards, layer, each shard's (local tables,
    is_local), contexts, scale, the whole cache, the global tables)."""
    from nano_pearl_tpu_torch.ops.kv_cache import ShardedKVCache
    from nano_pearl_tpu_torch.parallel.sp import shard_tables

    case = q8_case(seed, 4, rows, dtype, kind, device, nb=nb, **kw) if kind else \
        paged_case(seed, 4, rows, dtype, device, nb=nb, **kw)
    q, cache, layer, bt, ctx, scale = case
    half = (nb + 1) // 2
    if kind:
        shards = tuple(QuantKVCache(cache.q[:, :, i * half : (i + 1) * half].contiguous(),
                                    cache.s[:, :, i * half : (i + 1) * half].contiguous()) for i in range(2))
    else:
        shards = tuple(cache[:, :, i * half : (i + 1) * half].contiguous() for i in range(2))
    sharded = ShardedKVCache(shards, ())
    return q, sharded, layer, shard_tables(bt, sharded), ctx, scale, cache, bt


def test_partials_wrappers_take_the_plain_version_on_cpu(monkeypatch):
    """K11a-d's wrappers: CPU tensors go to the plain versions and launch
    nothing."""
    returned = []
    for name in ("plain_decode", "plain_verify"):
        fn = getattr(kpp, name)
        monkeypatch.setattr(kpp, name, lambda *a, fn=fn: returned.append(fn(*a)) or returned[-1])
    counters = [fn for pair in PARTIALS.values() for fn in pair]
    before = [fn.launches for fn in counters]
    for kind, (dec, ver) in PARTIALS.items():
        q, sharded, layer, tables, ctx, scale, _, bt = partials_case(70, 2, torch.float32, kind, "cpu", hq=4, d=16)
        shard, (local, is_local) = sharded.shards[1], tables[1]
        assert ver(q, shard, layer, local, ctx, is_local, scale, 2) is returned[-1]
        rows_local, rows_is_local = local.repeat_interleave(2, 0), is_local.repeat_interleave(2, 0)
        assert dec(q, shard, layer, rows_local, ctx, rows_is_local, scale) is returned[-1]
    assert len(returned) == 4
    assert [fn.launches for fn in counters] == before


@pytest.mark.parametrize("kind", [None, "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_partials_match_plain_and_verify_rows_equal_decode_bitwise(cuda, dtype, kind):
    """K11c (K11d) per shard against its plain version (o at TOL, m and l
    at 1e-4), its (o, m, l) rows against K11a's (K11b's) bit for bit, and
    the shards' merge against K2 (K9b) over the whole cache."""
    from nano_pearl_tpu_torch.parallel.sp import merge_partials

    rows = 5
    q, sharded, layer, tables, ctx, scale, cache, bt = partials_case(71, rows, dtype, kind, cuda)
    dec, ver = PARTIALS[kind]
    parts = []
    for shard, (local, is_local) in zip(sharded.shards, tables):
        grouped = ver(q, shard, layer, local, ctx, is_local, scale, rows)
        want = kpp.plain_verify(q, shard, layer, local, ctx, is_local, scale, rows)
        torch.testing.assert_close(grouped[0].float(), want[0].float(), **TOL[dtype])
        for a, b in zip(grouped[1:], want[1:]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        single = dec(q, shard, layer, local.repeat_interleave(rows, 0).contiguous(), ctx,
                     is_local.repeat_interleave(rows, 0).contiguous(), scale)
        assert all(torch.equal(a, b) for a, b in zip(grouped, single))
        parts.append(grouped)
    whole = (kpa.paged_verify_q8 if kind else kpa.paged_verify)(q, cache, layer, bt, ctx, scale, rows)
    merged = merge_partials(parts, q.dtype).float()
    if dtype == torch.float32:
        torch.testing.assert_close(merged, whole.float(), **TOL[dtype])
        return
    # Each shard's o is rounded to bf16 before the merge (the Pallas entries
    # return it so), so the merge may differ from one pass over the whole
    # context by half a bf16 step of the shards' outputs, weighted as the
    # merge weighs them, besides the two outputs' own roundings: at most
    # 3 * 2^-8 of that weighted magnitude, which exceeds TOL where the
    # shards' outputs cancel.
    m_glob = torch.maximum(parts[0][1], parts[1][1])
    w = [l_s * torch.exp(m_s - m_glob) for _, m_s, l_s in parts]
    mag = sum(w_s[..., None] * o_s.float().abs() for w_s, (o_s, _, _) in zip(w, parts)) / sum(w)[..., None]
    assert ((merged - whole.float()).abs() <= 3 * 2**-8 * mag + TOL[dtype]["atol"]).all()


# ---- the bf16 page walk of K10a-d and K11a-d (csrc/paged_walk.cuh) ----

WALK_ROWS = 6


def walk_case(seed, g, d, bs, kind, device):
    """bf16 queries over a bf16 (``kind`` None), int8 or e4m3 cache of
    ``bs``-key pages, 2 KV heads (5 at g 3, SmolLM2-360M's: the other cell
    size), and six groups of six staircase rows whose contexts cross the
    walk's cells: 1..6, cell - 4 .. cell + 1, 2 cell - 3 .. 2 cell + 2, the
    table's end (T = M * BS) - 2 .. T + 3, T + 3 .. T + 8 (past it), 37..42.
    Group 0's first page sits in the second half of the blocks and group
    2's pages all in the first half. Returns (q, cache, layer, bt, ctx,
    scale, nb)."""
    from nano_pearl_tpu_torch.ops.cuda.paged_walk import cell_keys

    hkv = 5 if g == 3 else 2
    cell = cell_keys(hkv)
    m = -(-(2 * cell + 40) // bs)
    nb = 2 * (6 * m + 4) - 1  # nb + 1 blocks in two halves, each with room for every table
    half = (nb + 1) // 2
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((6 * WALK_ROWS, g * hkv, d), generator=gen).bfloat16()
    if kind is None:
        cache = torch.randn((2, 2, nb + 1, bs, hkv * d), generator=gen).bfloat16().to(device)
    else:
        shape = (2, 2, nb + 1, bs, hkv * d)
        values = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8) if kind == "int8" else \
            (4 * torch.randn(shape, generator=gen)).to(torch.float8_e4m3fn)
        scales = (0.01 + 0.05 * torch.rand(shape[:-1] + (hkv,), generator=gen)).to(torch.bfloat16)
        cache = QuantKVCache(values.to(device), scales.to(device))
    bt = torch.randperm(nb, generator=gen)[: 6 * m].reshape(6, m).to(torch.int32)
    bt[0, 0] = half + int(torch.randint(0, half - 1, (1,), generator=gen))  # not the garbage block nb
    bt[2] = torch.randperm(half, generator=gen)[:m].to(torch.int32)
    t = m * bs
    starts = (1, cell - 4, 2 * cell - 3, t - 2, t + 3, 37)
    ctx = torch.tensor([s + i for s in starts for i in range(WALK_ROWS)], dtype=torch.int32)
    return q.to(device), cache, 1, bt.to(device), ctx.to(device), d**-0.5, nb


def _halves(cache, nb):
    """The cache's first 2 * ((nb + 1) // 2) blocks split into two shards."""
    from nano_pearl_tpu_torch.ops.kv_cache import ShardedKVCache

    half = (nb + 1) // 2
    if isinstance(cache, QuantKVCache):
        shards = tuple(QuantKVCache(cache.q[:, :, i * half : (i + 1) * half].contiguous(),
                                    cache.s[:, :, i * half : (i + 1) * half].contiguous()) for i in range(2))
    else:
        shards = tuple(cache[:, :, i * half : (i + 1) * half].contiguous() for i in range(2))
    return ShardedKVCache(shards, ())


@pytest.mark.parametrize("g", [1, 3, 4, 8])
@pytest.mark.parametrize("d", [16, 64, 128, 256])
@pytest.mark.parametrize("bs", [16, 32, 256])
def test_walk_bf16_matches_plain_and_verify_rows_equal_decode_bitwise(cuda, bs, d, g):
    """K10b and K10d (int8 and e4m3) on the tensor-core walk against their
    plain versions at TOL, their rows against K10a / K10c on the same
    query, table and context bit for bit, and a second launch bit for bit;
    contexts of 1, at each side of the cell boundaries and past the table."""
    for kind in (None, "int8", "fp8"):
        q, cache, layer, bt, ctx, scale, _ = walk_case(80 + bs + d + g, g, d, bs, kind, cuda)
        dec, ver = FALLBACKS[None if kind is None else "int8"]
        grouped = ver(q, cache, layer, bt, ctx, scale, WALK_ROWS)
        want = kfb.plain_verify(q, cache, layer, bt, ctx, scale, WALK_ROWS)
        torch.testing.assert_close(grouped.float(), want.float(), **TOL[torch.bfloat16])
        single = dec(q, cache, layer, bt.repeat_interleave(WALK_ROWS, 0).contiguous(), ctx, scale)
        assert torch.equal(grouped, single), kind
        assert torch.equal(ver(q, cache, layer, bt, ctx, scale, WALK_ROWS), grouped), kind


@pytest.mark.parametrize("g", [1, 3, 4, 8])
@pytest.mark.parametrize("d", [16, 64, 128, 256])
@pytest.mark.parametrize("bs", [16, 32, 256])
def test_walk_bf16_partials_match_plain_and_verify_rows_equal_decode_bitwise(cuda, bs, d, g):
    """K11c and K11d (int8 and e4m3) per shard of a cache split in two,
    against their plain versions (o at TOL, m and l at 1e-4), their (o, m,
    l) rows against K11a / K11b bit for bit and a second launch bit for
    bit. Group 0's first page is the second shard's, so on the first shard
    its rows of context <= BS see no local key, and the second shard holds
    none of group 2's pages: those rows give (0, -1e29, 0) exactly."""
    from nano_pearl_tpu_torch.parallel.sp import shard_tables

    for kind in (None, "int8", "fp8"):
        q, cache, layer, bt, ctx, scale, nb = walk_case(90 + bs + d + g, g, d, bs, kind, cuda)
        sharded = _halves(cache, nb)
        dec, ver = PARTIALS[None if kind is None else "int8"]
        bt_rows = bt.repeat_interleave(WALK_ROWS, 0).contiguous()
        for s, (shard, (lg, ig), (lr, ir)) in enumerate(zip(sharded.shards, shard_tables(bt, sharded),
                                                            shard_tables(bt_rows, sharded))):
            grouped = ver(q, shard, layer, lg, ctx, ig, scale, WALK_ROWS)
            want = kpp.plain_verify(q, shard, layer, lg, ctx, ig, scale, WALK_ROWS)
            torch.testing.assert_close(grouped[0].float(), want[0].float(), **TOL[torch.bfloat16])
            for a, b in zip(grouped[1:], want[1:]):
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
            single = dec(q, shard, layer, lr, ctx, ir, scale)
            assert all(torch.equal(a, b) for a, b in zip(grouped, single)), (kind, s)
            again = ver(q, shard, layer, lg, ctx, ig, scale, WALK_ROWS)
            assert all(torch.equal(a, b) for a, b in zip(grouped, again)), (kind, s)
            empty = want[2] == 0  # (row, head) pairs that see no local key
            assert empty[2 * WALK_ROWS : 3 * WALK_ROWS].all() == (s == 1)
            assert bool(empty[0].all()) == (s == 0)
            o, m, l = grouped  # noqa: E741
            assert not o[empty].any() and (m[empty] == -1e29).all() and not l[empty].any()


def test_walk_bf16_rows_spread_over_blocks(cuda):
    """At 16 query heads per KV head a group of 14 rows is 224 query vectors,
    more than a block's 8 warps: the walk folds it in blocks of 8 and 6
    rows, each row with the bits of its decode (K10b == K10a, K11c == K11a),
    and matches the plain versions."""
    from nano_pearl_tpu_torch.ops.cuda.paged_walk import walk_plan
    from nano_pearl_tpu_torch.parallel.sp import shard_tables

    assert walk_plan(14, 16, 2, 64, 32, 2).rpb == 8
    q, cache, layer, bt, ctx, scale = paged_case(95, 3, 14, torch.bfloat16, cuda, hq=32, hkv=2, d=64, m=16)
    grouped = kfb.paged_verify_fallback(q, cache, layer, bt, ctx, scale, 14)
    torch.testing.assert_close(grouped.float(), kfb.plain_verify(q, cache, layer, bt, ctx, scale, 14).float(),
                               **TOL[torch.bfloat16])
    bt_rows = bt.repeat_interleave(14, 0).contiguous()
    assert torch.equal(grouped, kfb.paged_decode_fallback(q, cache, layer, bt_rows, ctx, scale))
    sharded = _halves(cache, cache.shape[2] - 1)
    for shard, (lg, ig), (lr, ir) in zip(sharded.shards, shard_tables(bt, sharded), shard_tables(bt_rows, sharded)):
        got = kpp.paged_verify_partials(q, shard, layer, lg, ctx, ig, scale, 14)
        want = kpp.plain_verify(q, shard, layer, lg, ctx, ig, scale, 14)
        torch.testing.assert_close(got[0].float(), want[0].float(), **TOL[torch.bfloat16])
        single = kpp.paged_decode_partials(q, shard, layer, lr, ctx, ir, scale)
        assert all(torch.equal(a, b) for a, b in zip(got, single))


def test_walk_plan_mirror_matches_the_launchers(cuda):
    """The exported plan of the walk's launchers (``npt_walk_plan``, in both
    walk libraries) equals the mirror ``walk_plan`` for every head dim, G,
    page size, cache kind and route."""
    from nano_pearl_tpu_torch.ops.cuda.paged_walk import walk_plan

    libs = (kpw._lib(), kpp._lib())
    for d in range(16, 257, 16):
        for g in (1, 2, 3, 4, 5, 8, 16):
            for hkv in (1, 2, 5):
                for bs in (16, 32, 256):
                    for rows in (1, 14):
                        for bf16, size in ((1, 2), (0, 4)):
                            for q8 in (0, 1):
                                p = walk_plan(rows, g, hkv, d, bs, size, bool(q8))
                                want = [p.cell, p.warp_rows, p.rpb, p.threads, p.stages, p.smem]
                                for lib in libs:
                                    got = [lib.npt_walk_plan(rows, g, hkv, d, bs, bf16, q8, w) for w in range(6)]
                                    assert got == want, (rows, g, hkv, d, bs, size, q8)


# ---- K7 and K6b with bf16 queries: the walk (csrc/paged_walk.cuh) ----

# pre-round contexts of a verify's groups: (a) no cache (ctx0 0), windows
# across a 128-key and a 256-key cell boundary, a pre-verify group (one
# real row), a window deep in the table; (b) contexts 1-64 (a verify right
# after a short prompt); (c) 65-2300 (chip_smoke.py's rows)
MONO_WALK_CTX0 = {
    "edges": ((0, 125, 253, 300, 470, 1000), (3,)),
    "short": (tuple(range(0, 50, 7)), (2,)),
    "long": (tuple(int(c) for c in torch.linspace(65, 2286, 12)), (5,)),
}


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [3, 4])
@pytest.mark.parametrize("hkv", [1, 2, 5])
def test_walk_k7_and_k6b_match_plain_and_relaunch_bitwise(cuda, hkv, g, d):
    """bf16 K7 (cache_partials at the cache-side contexts min(ctx, ctx0))
    and K6b (mono_fresh) on the tensor-core walk, at Hkv 1/2/5, G 3/4, D
    64/128, over each set of MONO_WALK_CTX0: against their plain versions
    (o at TOL, K7's m and l at 1e-4), a row with cache context 0 giving (0,
    -1e29, 0) exactly, and a second launch bit for bit."""
    rows, bf16 = 14, TOL[torch.bfloat16]
    for name, (ctx0s, pre) in MONO_WALK_CTX0.items():
        args, _, scale = fresh_case(120 + hkv + g + d, torch.bfloat16, cuda, rows=rows, ctx0s=ctx0s, pre=pre,
                                    nb=-(-sum(c + rows for c in ctx0s) // 32) + 2 * len(ctx0s), hq=g * hkv,
                                    hkv=hkv, d=d, m=-(-(max(ctx0s) + rows) // 32))
        q, cache, layer, bt, ctx, ctx0 = args[:6]
        n0 = kmo.mono_fresh.launches
        got = kmo.mono_fresh(*args, scale, rows)
        assert kmo.mono_fresh.launches == n0 + 1
        torch.testing.assert_close(got.float(), kpa.plain_fresh(*args, scale).float(), **bf16)
        assert torch.equal(kmo.mono_fresh(*args, scale, rows), got), name

        ctx_cache = torch.minimum(ctx, ctx0.repeat_interleave(rows)).contiguous()
        part_args = (q, cache, layer, bt, ctx_cache, scale, rows)
        n0 = kmo.cache_partials.launches
        o, m, l = kmo.cache_partials(*part_args)  # noqa: E741
        assert kmo.cache_partials.launches == n0 + 1
        wo, wm, wl = kmo.plain_partials(*part_args)
        torch.testing.assert_close(o.float(), wo.float(), **bf16)
        torch.testing.assert_close(m, wm, **TOL[torch.float32])
        torch.testing.assert_close(l, wl, **TOL[torch.float32])
        empty = ctx_cache == 0
        assert bool(empty.any()) == (0 in ctx0s), name
        assert not o[empty].any() and (m[empty] == -1e29).all() and not l[empty].any(), name
        assert all(torch.equal(a, b) for a, b in zip(kmo.cache_partials(*part_args), (o, m, l))), name


def _kernel_names(run) -> set:
    """The CUDA kernels one call of ``run`` launched (names without
    namespace or arguments), from a torch.profiler trace of a second call
    (the first may allocate and zero a wrapper's scratch). The session idles
    5 ms before and after the call, as chip_smoke.py's ``kernel_trace``
    does, and a session that holds no kernel record (now and then, see
    ``launched_blocks`` there) is taken again, up to 8 times."""
    from torch.profiler import ProfilerActivity, profile

    run()
    names = set()
    for _ in range(8):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.005)
            run()
            torch.cuda.synchronize()
            time.sleep(0.005)
        names = {e.key.split("(")[0].split("<")[0].split("::")[-1] for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}
        if names:
            break
    return names


def test_k7_and_k6b_routes_by_query_type(cuda):
    """bf16 K7 and K6b launch the walk (walk_mma_kernel and its combine) and
    no mono template; f32 K7 and K6b still launch the mono template alone,
    and match their plain versions at the f32 tolerance."""
    for dtype in (torch.bfloat16, torch.float32):
        args, _, scale = fresh_case(130, dtype, cuda)
        q, cache, layer, bt, ctx, ctx0 = args[:6]
        ctx_cache = torch.minimum(ctx, ctx0.repeat_interleave(14)).contiguous()
        for run in (lambda: kmo.mono_fresh(*args, scale, 14),
                    lambda: kmo.cache_partials(q, cache, layer, bt, ctx_cache, scale, 14)):
            names = _kernel_names(run)
            if dtype == torch.bfloat16:
                assert names == {"walk_mma_kernel", "walk_combine_kernel"}, names
            else:
                assert names == {"mono_kernel"}, names
        torch.testing.assert_close(kmo.mono_fresh(*args, scale, 14), kpa.plain_fresh(*args, scale),
                                   **TOL[dtype])


def test_k1_and_k2_route_by_query_type(cuda):
    """bf16 K1 and K2 launch the page walk (walk_mma_kernel and its combine)
    and count their own launches, not K10a/K10b's; f32 K1 and K2 launch the
    chunk template (paged_partial_kernel and its combine)."""
    for dtype in (torch.bfloat16, torch.float32):
        for rows in (1, 14):
            q, cache, layer, bt, ctx, scale = paged_case(131, 4, rows, dtype, cuda, bs=256, nb=40, m=4)
            if rows == 1:
                run = lambda: kpa.paged_decode(q, cache, layer, bt, ctx, scale)  # noqa: E731
            else:
                run = lambda: kpa.paged_verify(q, cache, layer, bt, ctx, scale, rows)  # noqa: E731
            counters = (kpa.paged_decode, kpa.paged_verify, kfb.paged_decode_fallback, kfb.paged_verify_fallback)
            before = [fn.launches for fn in counters]
            names = _kernel_names(run)
            counted = [fn.launches - n for fn, n in zip(counters, before)]
            own = 0 if rows == 1 else 1  # a warm-up and each trace count
            assert counted[own] >= 2 and counted[1 - own] == 0 and counted[2:] == [0, 0], counted
            if dtype == torch.bfloat16:
                assert names == {"walk_mma_kernel", "walk_combine_kernel"}, names
            else:
                assert names == {"paged_partial_kernel", "paged_combine_kernel"}, names


def test_k9a_and_k9b_route_by_query_type(cuda):
    """bf16 K9a and K9b launch the page walk's 1-byte path (walk_mma_kernel
    and its combine) and count their own launches, not K10c/K10d's nor
    K1/K2's; f32 K9a and K9b launch the chunk template (paged_partial_kernel
    and its combine), whose 1-byte entries refuse bf16 queries."""
    counters = (kpa.paged_decode_q8, kpa.paged_verify_q8, kfb.paged_decode_fallback_q8,
                kfb.paged_verify_fallback_q8, kpa.paged_decode, kpa.paged_verify)
    for kind in ("int8", "fp8"):
        for dtype in (torch.bfloat16, torch.float32):
            for rows in (1, 14):
                q, cache, layer, bt, ctx, scale = q8_case(132, 4, rows, dtype, kind, cuda, bs=256, nb=40, m=4)
                if rows == 1:
                    run = lambda: kpa.paged_decode_q8(q, cache, layer, bt, ctx, scale)  # noqa: E731
                else:
                    run = lambda: kpa.paged_verify_q8(q, cache, layer, bt, ctx, scale, rows)  # noqa: E731
                before = [fn.launches for fn in counters]
                names = _kernel_names(run)
                counted = [fn.launches - n for fn, n in zip(counters, before)]
                own = 0 if rows == 1 else 1  # a warm-up and each trace count
                assert counted[own] >= 2 and counted[1 - own] == 0 and counted[2:] == [0] * 4, counted
                if dtype == torch.bfloat16:
                    assert names == {"walk_mma_kernel", "walk_combine_kernel"}, names
                else:
                    assert names == {"paged_partial_kernel", "paged_combine_kernel"}, names
    q, cache, layer, bt, ctx, scale = q8_case(133, 2, 2, torch.bfloat16, "int8", cuda)
    for fn, rows in (("npt_paged_decode_q8", 1), ("npt_paged_verify_q8", 2)):
        tables = bt.repeat_interleave(2, 0).contiguous() if rows == 1 else bt
        with pytest.raises(RuntimeError):  # the chunk template has no bf16 1-byte instantiation
            kpa._launch(fn, q, cache, layer, tables, ctx, scale, rows)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("d", [16, 32, 128, 256])
def test_walk_k9b_rows_equal_k9a_bitwise(cuda, kind, d):
    """bf16 K9b on the walk's 1-byte path, G 8, D 16/32/128/256 (Hkv * D >=
    128, the fast route's shapes): groups of 14 staircase rows whose
    contexts start at 1 and at each side of the 128-key cell boundaries
    (rows 120-133, 250-263 cross one), against the plain version at TOL;
    its rows equal K9a's on the same query, context and table bit for bit,
    and a second launch of each gives equal bits."""
    rows, hkv = 14, max(2, 128 // d)
    ctx0 = (1, 60, 120, 250, 375, 498)
    q, cache, layer, bt, _, scale = q8_case(134 + d, len(ctx0), rows, torch.bfloat16, kind, cuda, hq=8 * hkv,
                                            hkv=hkv, d=d)
    ctx = torch.tensor([c + i for c in ctx0 for i in range(rows)], dtype=torch.int32, device=cuda)
    bt_rows = bt.repeat_interleave(rows, 0).contiguous()
    got = kpa.paged_verify_q8(q, cache, layer, bt, ctx, scale, rows)
    torch.testing.assert_close(got.float(), kpa.plain_verify(q, cache, layer, bt, ctx, scale, rows).float(),
                               **TOL[torch.bfloat16])
    single = kpa.paged_decode_q8(q, cache, layer, bt_rows, ctx, scale)
    assert torch.equal(got, single)
    assert torch.equal(kpa.paged_verify_q8(q, cache, layer, bt, ctx, scale, rows), got)
    assert torch.equal(kpa.paged_decode_q8(q, cache, layer, bt_rows, ctx, scale), single)


@pytest.mark.parametrize("rows,heads", [(14, (8, 128)), (8, (16, 64))])
def test_paged_verify_at_short_contexts(cuda, rows, heads):
    """K2 on the walk right after a short prompt: 16 groups at pre-round
    contexts 1-50 (rows see 1-63 keys; a single bf16 P misses the tolerance
    here, hi + lo meets it), against the plain version; K2 rows equal K1's
    bit for bit and a second launch gives the same bits."""
    hq, d = heads
    q, cache, layer, bt, _, scale = paged_case(132, 16, rows, torch.bfloat16, cuda, hq=hq, d=d, bs=256, nb=40, m=4)
    c0 = torch.linspace(1, 50, 16).int()
    ctx = (c0[:, None] + torch.arange(rows, dtype=torch.int32)[None, :]).reshape(-1).contiguous().to(cuda)
    got = kpa.paged_verify(q, cache, layer, bt, ctx, scale, rows)
    want = kpa.plain_verify(q, cache, layer, bt, ctx, scale, rows)
    torch.testing.assert_close(got.float(), want.float(), **TOL[torch.bfloat16])
    single = kpa.paged_decode(q, cache, layer, bt.repeat_interleave(rows, 0).contiguous(), ctx, scale)
    assert torch.equal(got, single)
    assert torch.equal(kpa.paged_verify(q, cache, layer, bt, ctx, scale, rows), got)


# ---- K6a, K8a and K8b with bf16 queries: the walk with a cut cell ----

# pre-round contexts of a verify's groups: (a) no cache, a window inside a
# cell, windows across a 128-key multiple alone (120, 380) and across a
# 256-key one (250), ctx0 on a multiple of 256 and of 128 alone, a
# pre-verify group, a window deep in the table; (b) contexts 1-64
SPLIT_WALK_CTX0 = {
    "edges": ((0, 100, 120, 250, 256, 380, 384, 1000), (2,)),
    "short": (tuple(range(0, 50, 7)), (3,)),
}


def _split_walk_case(seed, rows, ctx0s, pre, hkv, g, d, bs=32):
    """fresh_case at these heads, with a table wide enough for each group's
    window."""
    return fresh_case(seed, torch.bfloat16, "cuda", rows=rows, ctx0s=ctx0s, pre=pre,
                      nb=-(-sum(c + rows for c in ctx0s) // bs) + 2 * len(ctx0s), bs=bs, hq=g * hkv, hkv=hkv,
                      d=d, m=-(-(max(ctx0s) + rows) // bs))


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("hkv,g", [(2, 4), (3, 3), (4, 2)])
def test_walk_k6a_k8a_k8b_match_plain_and_k8b_equals_k8a(cuda, hkv, g, d):
    """bf16 K6a, K8b and K8a on the tensor-core walk at Hkv 2/3/4 (128- and
    256-key cells), D 64/128/256, 14 rows a group and as many as a cell,
    over each set of SPLIT_WALK_CTX0: against their plain versions at TOL,
    a second launch bit for bit, K6a rows equal to K6b's (one launch) and
    K8b rows equal to the K8a rows of the same query and context at b1 =
    ctx0 (K8a reading the fresh rows from the draft's cache), bit for
    bit, windows across a 128-key multiple included."""
    bf16, cell = TOL[torch.bfloat16], kpw.cell_keys(hkv)
    # a window of a whole cell: from no cache, across a 128-key multiple and a 256-key one
    cases = [(14, *ctx) for ctx in SPLIT_WALK_CTX0.items()] + [(cell, "cell_rows", ((0, 120, 250), (1,)))]
    for rows, name, (ctx0s, pre) in cases:
        args, drafted, scale = _split_walk_case(140 + hkv + g + d + rows, rows, ctx0s, pre, hkv, g, d)
        q, _, layer, bt, ctx, ctx0 = args[:6]
        want = kpa.plain_fresh(*args, scale)
        outs = {}
        for kernel in ("K6a", "K8b"):
            fn = FRESH_KERNELS[kernel]
            n0 = fn.launches
            outs[kernel] = fn(*args, scale, rows)
            assert fn.launches == n0 + 1
            torch.testing.assert_close(outs[kernel].float(), want.float(), **bf16)
            assert torch.equal(fn(*args, scale, rows), outs[kernel]), (kernel, name, rows)
        assert torch.equal(outs["K6a"], kmo.mono_fresh(*args, scale, rows)), (name, rows)
        b1 = ctx0.repeat_interleave(rows)
        dec = (q, drafted, layer, bt.repeat_interleave(rows, 0).contiguous(), ctx, b1, scale)
        n0 = kpa.paged_decode_split.launches
        decode = kpa.paged_decode_split(*dec)
        assert kpa.paged_decode_split.launches == n0 + 1
        torch.testing.assert_close(decode.float(), kpa.plain_decode(*dec[:5], scale).float(), **bf16)
        assert torch.equal(kpa.paged_decode_split(*dec), decode), (name, rows)
        real = ctx > b1
        assert torch.equal(outs["K8b"][real], decode[real]), (name, rows)


@pytest.mark.parametrize("hkv", [2, 4])
def test_walk_k8a_cuts_match_plain(cuda, hkv):
    """bf16 K8a with b1 inside a cell, on a 128-key multiple and a 256-key
    one, at 0, at and past the context, on contexts up to 1,280 keys,
    against K1's plain version; a second launch bit for bit."""
    q, cache, layer, bt, ctx, scale = paged_case(146 + hkv, 8, 1, torch.bfloat16, cuda, hq=4 * hkv, hkv=hkv, m=40)
    b1 = torch.stack([ctx // 3, ctx - ctx % 128, ctx - ctx % 256, torch.zeros_like(ctx), ctx, ctx + 9, ctx - 1,
                      ctx - 14]).diagonal().to(torch.int32).contiguous()
    got = kpa.paged_decode_split(q, cache, layer, bt, ctx, b1, scale)
    torch.testing.assert_close(got.float(), kpa.plain_decode(q, cache, layer, bt, ctx, scale).float(),
                               **TOL[torch.bfloat16])
    assert torch.equal(kpa.paged_decode_split(q, cache, layer, bt, ctx, b1, scale), got)


def test_k6a_k8a_k8b_route_by_query_type(cuda):
    """bf16 K6a, K8a and K8b launch the walk (walk_mma_kernel and its
    combine) and count their own launches; f32 ones launch the chunk
    template's cells (cell_partial_kernel and cell_combine_kernel)."""
    for dtype in (torch.bfloat16, torch.float32):
        args, drafted, scale = fresh_case(147, dtype, cuda)
        q, _, layer, bt, ctx, ctx0 = args[:6]
        dec = (q, drafted, layer, bt.repeat_interleave(14, 0).contiguous(), ctx, ctx0.repeat_interleave(14), scale)
        for fn, run in ((kpa.paged_verify_fresh, lambda: kpa.paged_verify_fresh(*args, scale, 14)),
                        (kpa.paged_verify_fresh_split, lambda: kpa.paged_verify_fresh_split(*args, scale, 14)),
                        (kpa.paged_decode_split, lambda: kpa.paged_decode_split(*dec))):
            n0, k6b = fn.launches, kmo.mono_fresh.launches
            names = _kernel_names(run)
            assert fn.launches - n0 >= 2 and kmo.mono_fresh.launches == k6b, fn.__name__
            if dtype == torch.bfloat16:
                assert names == {"walk_mma_kernel", "walk_combine_kernel"}, names
            else:
                assert names == {"cell_partial_kernel", "cell_combine_kernel"}, names


def test_walk_cells_mirror_matches_the_launchers(cuda):
    """The cells of a launch as the walk and its combine read them
    (``WalkCells``, exported as ``npt_walk_cells``) equal the mirror's
    ``launch_cells`` and ``row_cells``: tables with and without K8a's cut,
    K6a's fresh cell and K8b's cut window, at cells of 128 and 256 keys."""
    lib = kpp._lib()
    for cell in (128, 256):
        for keys in (64, cell, cell + 1, 4 * cell - 3):
            specs = [(0, 0, 0, 0, 0)] + [(1, b1, 0, 0, 0) for b1 in (-1, 0, 1, cell - 1, cell, cell + 7, keys - 1,
                                                                       keys, keys + 3)]
            specs += [(split, c0 if split else 0, 1, c0, rows) for c0 in (0, 1, cell - 3, cell, cell + 5)
                      for rows in (1, 14, cell) for split in (0, 1) if c0 + rows <= keys]
            for has_cut, cut, has_fresh, c0, rows in specs:
                want = kpw.launch_cells(keys, cell, cut if has_cut else None, c0 if has_fresh else None, rows)
                got = [tuple(lib.npt_walk_cells(keys, cell, has_cut, cut, has_fresh, c0, rows, 0, i, w)
                             for w in range(3)) for i in range(len(want))]
                assert lib.npt_walk_cells(keys, cell, has_cut, cut, has_fresh, c0, rows, 0, 0, 3) == len(want)
                assert got == [(lo, hi, int(f)) for lo, hi, f in want], (keys, cell, has_cut, cut, c0, rows)
                for ctx in (0, 1, cell - 1, cell + 2, c0, c0 + 1, c0 + rows, keys, keys + 5):
                    folded = kpw.row_cells(keys, cell, ctx, cut if has_cut else None, c0 if has_fresh else None, rows)
                    n = lib.npt_walk_cells(keys, cell, has_cut, cut, has_fresh, c0, rows, ctx, 0, 4)
                    assert [lib.npt_walk_cells(keys, cell, has_cut, cut, has_fresh, c0, rows, ctx, j, 5)
                            for j in range(n)] == folded, (keys, cell, has_cut, cut, c0, rows, ctx)


# ---- K5 and K9c with bf16 queries: K1/K2's and K9a/K9b's walk (csrc/paged_walk.cu) ----


def _counters_zero() -> bool:
    """Every arrival counter of the mono template, of every (device,
    stream), is back to 0."""
    torch.cuda.synchronize()
    return all(not bool(t.any()) for t in kmo._counters.values())


@pytest.mark.parametrize("kind", [None, "int8", "fp8"])
@pytest.mark.parametrize("g", [4, 8])
@pytest.mark.parametrize("d", [16, 32, 128, 256])
def test_walk_k5_rows_equal_k1_and_k9c_rows_equal_k9a_bitwise(cuda, d, g, kind):
    """bf16 K5 (a bf16 cache) and K9c (int8, e4m3) on K1's (K9a's) walk, G
    4 and 8, D 16/32/128/256 (Hkv * D >= 128), groups of 14 staircase rows
    whose contexts start at 1 and at each side of the 128-key cells (rows
    120-133, 250-263 cross one), and one row a table: against the plain
    version at TOL; the 14-row rows equal the decode rows and both equal
    K1's (K9a's) on the same query, context and table, bit for bit; a
    second launch gives the same bits, and no call leaves an arrival
    counter of the template set."""
    rows, hkv = 14, max(2, 128 // d)
    ctx0 = (1, 60, 120, 250, 375, 498)
    kw = dict(hq=g * hkv, hkv=hkv, d=d)
    if kind is None:
        q, cache, layer, bt, _, scale = paged_case(150 + d + g, len(ctx0), rows, torch.bfloat16, cuda, **kw)
        mono, single = kmo.mono_attention, kpa.paged_decode
    else:
        q, cache, layer, bt, _, scale = q8_case(150 + d + g, len(ctx0), rows, torch.bfloat16, kind, cuda, **kw)
        mono, single = kmo.mono_q8, kpa.paged_decode_q8
    ctx = torch.tensor([c + i for c in ctx0 for i in range(rows)], dtype=torch.int32, device=cuda)
    bt_rows = bt.repeat_interleave(rows, 0).contiguous()
    n0 = mono.launches
    verify = mono(q, cache, layer, bt, ctx, scale, rows)
    decode = mono(q, cache, layer, bt_rows, ctx, scale)
    assert mono.launches == n0 + 2 and _counters_zero()
    torch.testing.assert_close(verify.float(), kmo.plain_mono(q, cache, layer, bt, ctx, scale, rows).float(),
                               **TOL[torch.bfloat16])
    assert torch.equal(verify, decode)
    assert torch.equal(decode, single(q, cache, layer, bt_rows, ctx, scale))
    assert torch.equal(mono(q, cache, layer, bt, ctx, scale, rows), verify)
    assert torch.equal(mono(q, cache, layer, bt_rows, ctx, scale), decode)
    assert _counters_zero()


def _kernel_counts(run) -> dict:
    """The CUDA kernels one call of ``run`` launched and how many times
    each, from a torch.profiler trace of a second call (``_kernel_names``'
    sessions)."""
    from torch.profiler import ProfilerActivity, profile

    run()
    counts = {}
    for _ in range(8):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.005)
            run()
            torch.cuda.synchronize()
            time.sleep(0.005)
        counts = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
                name = e.key.split("(")[0].split("<")[0].split("::")[-1]
                counts[name] = counts.get(name, 0) + e.count
        if counts:
            break
    return counts


def test_k5_and_k9c_route_by_query_type(cuda):
    """bf16 K5 and K9c launch K1/K2's (K9a/K9b's) walk and its combine,
    one kernel each a call over a table of several cells, and count their
    own launches, not K1/K2/K9a/K9b's; f32 K5 and K9c launch the mono
    template alone."""
    counters = (kmo.mono_attention, kmo.mono_q8, kpa.paged_decode, kpa.paged_verify, kpa.paged_decode_q8,
                kpa.paged_verify_q8)
    for dtype in (torch.bfloat16, torch.float32):
        for rows in (1, 14):
            for kind in (None, "int8", "fp8"):
                if kind is None:
                    q, cache, layer, bt, ctx, scale = paged_case(160, 4, rows, dtype, cuda, bs=256, nb=40, m=4)
                    fn, own = kmo.mono_attention, 0
                else:
                    q, cache, layer, bt, ctx, scale = q8_case(160, 4, rows, dtype, kind, cuda, bs=256, nb=40, m=4)
                    fn, own = kmo.mono_q8, 1
                before = [c.launches for c in counters]
                counts = _kernel_counts(lambda: fn(q, cache, layer, bt, ctx, scale, rows))
                counted = [c.launches - n for c, n in zip(counters, before)]
                assert counted[own] >= 2 and not any(counted[:own] + counted[own + 1:]), counted
                if dtype == torch.bfloat16:
                    assert counts == {"walk_mma_kernel": 1, "walk_combine_kernel": 1}, counts
                else:
                    assert set(counts) == {"mono_kernel"}, counts


def test_walk_k5_on_two_streams_at_once(cuda):
    """K5 (verify and decode, bf16 and f32 queries) and K9c (bf16 and f32)
    launched on two streams at once, many times over; the mono template's
    f32 launches take their own stream's arrival counters: every output
    equals the same call's output alone, bit for bit, and the counters are
    0 afterwards."""
    runs = []
    for seed, rows, dtype in ((170, 14, torch.bfloat16), (171, 1, torch.bfloat16), (175, 14, torch.float32)):
        q, cache, layer, bt, ctx, scale = paged_case(seed, 8, rows, dtype, cuda, m=40)
        runs.append(lambda q=q, cache=cache, layer=layer, bt=bt, ctx=ctx, scale=scale, rows=rows:
                    kmo.mono_attention(q, cache, layer, bt, ctx, scale, rows))
    for seed, dtype in ((172, torch.bfloat16), (176, torch.float32)):
        args = q8_case(seed, 8, 14, dtype, "fp8", cuda, m=40)
        runs.append(lambda args=args: kmo.mono_q8(*args, 14))
    alone = [run() for run in runs]
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda))
    outs = [[] for _ in streams]
    for it in range(30):
        for j, s in enumerate(streams):
            i = (it + j) % len(runs)
            with torch.cuda.stream(s):
                outs[j].append((i, runs[i]()))
    torch.cuda.synchronize()
    for s_outs in outs:
        for i, got in s_outs:
            assert torch.equal(got, alone[i]), i
    used = {stream for _, stream in kmo._counters}
    assert {s.cuda_stream for s in streams} <= used and _counters_zero()


def test_mono_template_refuses_bf16(cuda):
    """Every entry of csrc/mono_attention.cu refuses bf16 queries (their
    bf16 routes run on the walk): K5's npt_mono_attention, K9c's
    npt_mono_q8, K7's npt_cache_partials and K6b's npt_mono_fresh."""
    q, cache, layer, bt, ctx, scale = paged_case(173, 3, 2, torch.bfloat16, cuda)
    out = torch.empty_like(q)
    with pytest.raises(RuntimeError):
        kmo._launch("npt_mono_attention", "mono_attention", q, cache, layer, bt, ctx, scale, 2, (out,))
    m_l = [torch.empty(q.shape[:2], dtype=torch.float32, device=cuda) for _ in range(2)]
    with pytest.raises(RuntimeError):
        kmo._launch("npt_cache_partials", "cache_partials", q, cache, layer, bt, ctx, scale, 2, (out, *m_l))
    q8 = q8_case(173, 3, 2, torch.bfloat16, "int8", cuda)
    with pytest.raises(RuntimeError):
        kmo._launch("npt_mono_q8", "mono_q8", *q8[:6], 2, (out,))
    (fq, fcache, flayer, fbt, fctx, c0, fk, fv), _, fscale = fresh_case(174, torch.bfloat16, cuda, rows=2)
    scratch = torch.zeros(1 << 20, dtype=torch.float32, device=cuda)
    cnt = torch.zeros(1024, dtype=torch.int32, device=cuda)
    b, m = fbt.shape
    hq, d = fq.shape[1:]
    ptrs = (fq, fcache, fk, fv, fbt, fctx, c0, torch.empty_like(fq), scratch, scratch, cnt)
    err = kmo._lib().npt_mono_fresh(*(t.data_ptr() for t in ptrs), b, 2, m, hq, fk.shape[1], d, fcache.shape[3],
                                    0, 0, fscale, 2, 1, torch.cuda.current_stream(cuda).cuda_stream)
    assert err != 0


def test_walk_k5_at_long_contexts(cuda):
    """bf16 K5 and K9c at 14 rows of G 8 (112 query vectors a block) over
    contexts of 14,800-16,370 keys, some 120 cells a row for the combine to
    fold: against the plain version at TOL and K1's (K9a's) rows bit for
    bit."""
    rows, hq, hkv, d, bs, m = 14, 16, 2, 128, 256, 64
    c0 = (14_800, 15_600, 16_356)
    assert -(-(max(c0) + rows - 1) // kpw.walk_plan(rows, hq // hkv, hkv, d, bs, 2).cell) > 120
    q, cache, layer, bt, _, scale = paged_case(180, len(c0), rows, torch.bfloat16, "cpu", nb=len(c0) * m + 4, bs=bs,
                                               hq=hq, hkv=hkv, d=d, m=m)
    bt = torch.arange(len(c0) * m, dtype=torch.int32).reshape(len(c0), m)
    ctx = torch.tensor([c + i for c in c0 for i in range(rows)], dtype=torch.int32)
    q, cache, bt, ctx = (t.to(cuda) for t in (q, cache, bt, ctx))
    bt_rows = bt.repeat_interleave(rows, 0).contiguous()
    caches = {None: cache}
    for kind, qdt in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        from nano_pearl_tpu_torch.ops.kv_cache import _quantize_rows

        values, scales = _quantize_rows(cache.view(-1, hkv, d), qdt)
        caches[kind] = QuantKVCache(values.view(cache.shape), scales.view(cache.shape[:-1] + (hkv,)))
    for kind, c in caches.items():
        mono, single = (kmo.mono_attention, kpa.paged_decode) if kind is None else (kmo.mono_q8, kpa.paged_decode_q8)
        got = mono(q, c, layer, bt, ctx, scale, rows)
        torch.testing.assert_close(got.float(), kmo.plain_mono(q, c, layer, bt, ctx, scale, rows).float(),
                                   **TOL[torch.bfloat16])
        assert torch.equal(got, single(q, c, layer, bt_rows, ctx, scale)), kind
