"""The hand-written CUDA kernels K1 (paged decode), K2 (packed verify),
K3 (causal prefill) and K4 (prefill over a cached prefix) against their
plain PyTorch versions.

The kernel tests need a CUDA card and skip elsewhere; this file imports
neither JAX nor the JAX package, so the card runs it without the
suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

Tolerances: f32 1e-4 (the kernel folds 64-key tiles with an online
softmax, the plain version one softmax over all keys); bf16 rtol 8e-3,
atol 1e-3 (both accumulate in f32 and round the output to bf16 once, so
they may differ by one bf16 step, at most 2^-7 of the value).
"""

import pytest
import torch

from nano_pearl_tpu_torch.ops.cuda import paged_attention as kpa
from nano_pearl_tpu_torch.ops.cuda import prefill_attention as kpf

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


def prefill_case(seed, dtype, device, b=3, lq=70, hq=8, hkv=2, d=128):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b * lq, hq, d), generator=g).to(dtype)
    k = torch.randn((b * lq, hkv, d), generator=g).to(dtype)
    v = torch.randn((b * lq, hkv, d), generator=g).to(dtype)
    pos = torch.full((b, lq), -1, dtype=torch.int32)
    for i, n in enumerate((lq, 37, 0)):  # full, ragged, fully padded
        pos[i, :n] = torch.arange(n, dtype=torch.int32)
    return [x.to(device) for x in (q, k, v, pos)] + [d**-0.5]


def prefix_case(seed, dtype, device, hq=16, hkv=2, d=64, lq=40, nb=40, bs=16, nl=2):
    """K4's arguments: a random cache, per-sequence prefix pages, fresh
    q/k/v; sequences with a multi-page prefix and a ragged tail, a
    block-aligned prefix, no prefix at all, and a fully padded one."""
    g = torch.Generator().manual_seed(seed)
    cache = torch.randn((nl, 2, nb + 1, bs, hkv * d), generator=g).to(dtype)
    nc = torch.tensor([37, 64, 0, 20], dtype=torch.int32)
    nn = torch.tensor([40, 17, 25, 0], dtype=torch.int32)
    b, mpre = len(nc), 8
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
    counters = (kpa.paged_decode, kpa.paged_verify, kpf.prefill_self, kpf.prefill_prefix)
    before = [fn.launches for fn in counters]
    args = paged_case(0, 4, 1, torch.float32, "cpu")
    assert kpa.paged_decode(*args) is returned[-1]
    args = paged_case(1, 4, 3, torch.float32, "cpu")
    assert kpa.paged_verify(*args, 3) is returned[-1]
    args = prefill_case(2, torch.float32, "cpu")
    assert kpf.prefill_self(*args) is returned[-1]
    args = prefix_case(3, torch.float32, "cpu")
    assert kpf.prefill_prefix(*args) is returned[-1]
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
    with pytest.raises(ValueError):  # head_dim 32
        kpa.paged_decode(q[..., :32].contiguous(), cache[..., :64].contiguous(), 0, bt, ctx, scale)
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
