"""The port's native block manager (nano_pearl_tpu_torch/native/block_manager.cc
through engine/native.py) against its Python ``BlockManager``: the same
BLAKE2b chain digests as ``chain_hash`` and ``hashlib.blake2b``, the same
allocations and prefix hits, the same free counts over 200 random
operations (one shard and pages striped over two), the engine's streams
equal under either manager, and a failed build raising (mirrors
tests/test_native.py)."""

import hashlib

import numpy as np
import pytest
import torch

from nano_pearl_tpu_torch import ModelConfig, PearlConfig, PearlEngine, SamplingParams
from nano_pearl_tpu_torch.engine import native
from nano_pearl_tpu_torch.engine.block_manager import BlockManager, chain_hash
from nano_pearl_tpu_torch.engine.sequence import SeqView

BS = 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: under the suite's parallel workers torch's
    spinning thread pool oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_blake2b_chain_hash_parity():
    """Digests of 0 to 300 tokens (messages across the 128-byte block
    boundaries), with and without a prefix, equal the Python manager's and
    hashlib's."""
    rng = np.random.default_rng(0)
    for n in (0, 1, 3, 8, 15, 16, 17, 64, 300):
        toks = rng.integers(0, 2**31, n).tolist()
        for prefix in (-1, 12345, 2**64 - 3):
            want = chain_hash(toks, prefix)
            assert native.native_chain_hash(toks, prefix) == want, (n, prefix)
        raw = hashlib.blake2b(np.asarray(toks, np.int64).tobytes(), digest_size=8).digest()
        assert native.native_chain_hash(toks) == int.from_bytes(raw, "little")


def _pair(num_blocks=32, shards=1):
    return BlockManager(num_blocks, BS, shards), native.NativeBlockManager(num_blocks, BS, shards)


@pytest.mark.parametrize("shards", [1, 2])
def test_allocate_parity_with_prefix_cache(shards):
    """A full prefix hit, a hit that diverges after one block, the
    fully-cached guard: the same tables, cached counts and free blocks."""
    py, nat = _pair(31, shards)
    streams = [list(range(40)), list(range(40)), list(range(16)) + [99] * 20, list(range(32))]
    for toks in streams:
        vp, vn = SeqView(toks, BS), SeqView(toks, BS)
        py.allocate(vp)
        nat.allocate(vn)
        assert vp.num_cached_tokens == vn.num_cached_tokens, toks
        assert vp.block_table == vn.block_table
        assert py.num_free_blocks == nat.num_free_blocks
    assert streams and vp.num_cached_tokens == 16  # the last stream hit its guard


@pytest.mark.parametrize("shards", [1, 2])
def test_randomized_op_sequence_parity(shards):
    """200 random allocations, growths, rollbacks, deallocations and prefix
    clears: after each the same tables and free counts (with two shards the
    pages striped alike)."""
    rng = np.random.default_rng(1 + shards)
    py, nat = _pair(47, shards)
    live: list[tuple[SeqView, SeqView]] = []
    bases = [rng.integers(0, 50, 64).tolist() for _ in range(3)]  # shared prefixes: hits
    hits = 0
    for step in range(200):
        op = rng.choice(["alloc", "ensure", "rollback", "dealloc", "clear"], p=[0.3, 0.3, 0.2, 0.17, 0.03])
        if op == "alloc" or not live:
            n = int(rng.integers(1, 60))
            toks = bases[rng.integers(3)][: int(rng.integers(0, n + 1))]
            toks = toks + rng.integers(0, 50, n - len(toks)).tolist()
            vp, vn = SeqView(toks, BS), SeqView(toks, BS)
            if py.can_allocate(vp) and nat.can_allocate(vn):
                py.allocate(vp)
                nat.allocate(vn)
                assert vp.num_cached_tokens == vn.num_cached_tokens
                hits += vp.num_cached_tokens > 0
                live.append((vp, vn))
        elif op == "ensure":
            vp, vn = live[rng.integers(len(live))]
            grow = rng.integers(0, 50, int(rng.integers(1, 24))).tolist()
            vp.token_ids.extend(grow)
            vn.token_ids.extend(grow)
            extra = int(rng.integers(1, 20))
            assert py.blocks_needed(vp, extra) == nat.blocks_needed(vn, extra)
            if py.can_ensure(vp, extra) and nat.can_ensure(vn, extra):
                py.ensure_capacity(vp, extra)
                nat.ensure_capacity(vn, extra)
        elif op == "rollback":
            vp, vn = live[rng.integers(len(live))]
            if len(vp) > 2:
                n = int(rng.integers(1, len(vp) - 1))
                py.rollback(vp, n)
                nat.rollback(vn, n)
                assert vp.token_ids == vn.token_ids
        elif op == "dealloc":
            vp, vn = live.pop(int(rng.integers(len(live))))
            py.deallocate(vp)
            nat.deallocate(vn)
        else:
            py.clear_prefix_cache()
            nat.clear_prefix_cache()
        assert all(a.block_table == b.block_table for a, b in live), f"step {step} {op}"
        assert py.num_free_blocks == nat.num_free_blocks, f"step {step} {op}"
    assert hits > 5


MODEL = dict(
    architecture="LlamaForCausalLM", hidden_size=64, intermediate_size=128, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, vocab_size=256, eos_token_id=0, dtype="float32",
    max_position_embeddings=512,
)


def _engine(native_bm: bool, **over):
    m = ModelConfig(**MODEL)
    cfg = PearlConfig(
        draft_model=m, target_model=m, max_model_len=128, max_num_batched_tokens=512, kvcache_block_size=8,
        num_kvcache_blocks=23, gamma=3, max_num_seqs=8, prefill_token_buckets=(32, 64, 128), dtype="float32",
        native_block_manager=native_bm, **over,
    )
    return PearlEngine(cfg, device="cpu")


@pytest.mark.parametrize("sp", [1, 2])
def test_engine_with_native_block_manager(sp):
    """PEARL == AR under the native manager, and the streams, prefix hits
    and free blocks equal the Python manager's on the same requests (a
    shared 16-token prefix; under sp the pages striped over 2 shards)."""
    prefix = list(range(10, 26))
    prompts = [prefix + [3, 4], prefix + [5], [7, 8, 9], prefix + [6, 6, 6]]

    def run(eng):
        out = []
        for i, p in enumerate(prompts):
            eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=12))
            if i in (0, 3):
                out.append(eng.generate_token_ids()[0])
        eng.add_request(prompts[1], SamplingParams(temperature=0.0, max_tokens=12))
        ar = eng.AR_generate_token_ids()[0]
        sch = eng.scheduler
        return out, ar, eng.orchestrator.prefix_hit_tokens, sch.draft_bm.num_free_blocks, sch.target_bm.num_free_blocks

    over = dict(draft_sp=sp, target_sp=sp) if sp > 1 else {}
    nat = _engine(True, **over)
    assert isinstance(nat.scheduler.target_bm, native.NativeBlockManager)
    assert nat.scheduler.target_bm.shards == sp
    got = run(nat)
    assert got == run(_engine(False, **over))
    assert got[2] > 0 and got[0][1][0] == got[1][0]  # prefix hits; PEARL == AR


def test_failed_build_raises(monkeypatch, tmp_path):
    """No compiler: building raises, and so does an engine asked for the
    native manager; nothing falls back to the Python manager."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)  # no library built before
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="native block manager"):
        native.load_native_lib()
    with pytest.raises(RuntimeError, match="native block manager"):
        _engine(True)
