"""Data-parallel serving in the port (engine/dp.py; mirrors tests/test_dp.py):
least-loaded routing, completions merged by sequence id equal to a single
engine's at T=0 on the same weights, and continuous serving with a request
joining mid-flight. Every replica runs the plain versions on the CPU, the
replicas sharing the one device."""

import numpy as np
import pytest
import torch

from nano_pearl_tpu_torch import ModelConfig, PearlConfig, PearlEngine, SamplingParams
from nano_pearl_tpu_torch.engine.dp import DataParallelEngine
from nano_pearl_tpu_torch.models.transformer import init_params_numpy

MODEL = dict(
    architecture="LlamaForCausalLM", hidden_size=64, intermediate_size=128, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, vocab_size=256, eos_token_id=0, dtype="float32",
    max_position_embeddings=512,
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: under the suite's parallel workers torch's
    spinning thread pool oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(**over):
    m = ModelConfig(**MODEL)
    return PearlConfig(
        draft_model=m, target_model=m, max_model_len=256, max_num_batched_tokens=512, kvcache_block_size=16,
        num_kvcache_blocks=96, gamma=3, max_num_seqs=8, prefill_token_buckets=(32, 64, 128, 256, 512),
        dtype="float32", **over,
    )


def prompts(n, rng):
    return [rng.integers(2, 255, int(rng.integers(3, 9))).tolist() for _ in range(n)]


def test_dp_routing_balances_load():
    dpe = DataParallelEngine(_config(), dp=2, device="cpu")
    assert [r.config.seed for r in dpe.replicas] == [0, 1]
    for p in prompts(8, np.random.default_rng(0)):
        dpe.add_request(p, SamplingParams(temperature=0.0, max_tokens=4))
    assert [len(r.scheduler.waiting) + len(r.scheduler.running) for r in dpe.replicas] == [4, 4]


def test_dp_generate_matches_single_engine_at_t0():
    """dp=2 gives the completions a single engine gives for the same
    requests on the same weights, merged in submission (sequence-id) order."""
    ps = prompts(6, np.random.default_rng(1))
    m = ModelConfig(**MODEL)
    weights = [init_params_numpy(m, np.random.default_rng(s)) for s in (10, 11)]
    sp = SamplingParams(temperature=0.0, max_tokens=12)
    single = PearlEngine(_config(), *weights, device="cpu")
    for p in ps:
        single.add_request(p, sp)
    want, want_n, _, _ = single.generate_token_ids()
    dpe = DataParallelEngine(_config(), dp=2, draft_params=weights[0], target_params=weights[1], device="cpu")
    for p in ps:
        dpe.add_request(p, sp)
    got, got_n, acc, elapsed = dpe.generate_token_ids()
    assert got == want and got_n == want_n
    assert len(acc) == len(ps) and elapsed > 0


def test_dp_serve_step_continuous():
    dpe = DataParallelEngine(_config(), dp=2, device="cpu")
    for p in prompts(4, np.random.default_rng(2)):
        dpe.submit(p, SamplingParams(temperature=0.0, max_tokens=6))
    done, added_midflight = [], False
    for _ in range(50):
        done.extend(dpe.serve_step(fused_rounds=4))
        if done and not added_midflight:  # mid-flight admission on one replica
            dpe.submit([9, 8, 7], SamplingParams(temperature=0.0, max_tokens=6))
            added_midflight = True
        if not dpe.has_work and added_midflight:
            break
    assert not dpe.has_work
    assert len(done) == 5
    assert all(len(t) == 6 for _, t, _ in done)
