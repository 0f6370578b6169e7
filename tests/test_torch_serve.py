"""Continuous serving in the port (engine.submit / serve_step / cancel /
stats and nano_pearl_tpu_torch/serve.py), mirroring the JAX package's
tests/test_continuous.py and tests/test_serve.py, and top-k/top-p held
against the JAX package's ``apply_top_k_top_p`` on numpy-seeded logits
(f32, 1e-6: the same sort, softmax and cumulative sum)."""

from __future__ import annotations

import dataclasses
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nano_pearl_tpu.ops.sampling import apply_top_k_top_p as japply
from nano_pearl_tpu_torch import ModelConfig, PearlConfig, PearlEngine, SamplingParams, serve
from nano_pearl_tpu_torch.models.transformer import init_params_numpy
from nano_pearl_tpu_torch.ops.sampling import NEG_INF, apply_top_k_top_p

MODEL = dict(
    hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, vocab_size=256, eos_token_id=0, dtype="float32",
    max_position_embeddings=512,
)


def _engine(**over) -> PearlEngine:
    m = ModelConfig(**MODEL)
    target = ModelConfig(**{**MODEL, "num_hidden_layers": 3})
    cfg = PearlConfig(
        draft_model=m, target_model=target, **{
            **dict(max_model_len=256, max_num_batched_tokens=512, kvcache_block_size=16,
                   num_kvcache_blocks=96, gamma=3, max_num_seqs=8,
                   prefill_token_buckets=(32, 64, 128, 256, 512), dtype="float32"),
            **over,
        },
    )
    dp = init_params_numpy(m, np.random.default_rng(50))
    tp = init_params_numpy(target, np.random.default_rng(51))
    return PearlEngine(cfg, dp, tp, device="cpu")


def sp(n, **kw):
    return SamplingParams(temperature=0.0, max_tokens=n, **kw)


def _drain(eng, fused_rounds=2):
    out = {}
    while eng.has_work:
        out.update({sid: toks for sid, toks, _ in eng.serve_step(fused_rounds)})
    return out


def test_mid_flight_admission_matches_batch_outputs():
    eng = _engine()
    eng.add_request([1, 2, 3, 4], sp(20))
    eng.add_request([9, 8, 7], sp(20))
    base, *_ = eng.generate_token_ids()
    id_a = eng.submit([1, 2, 3, 4], sp(20))
    outputs, steps, id_b = {}, 0, None
    while eng.has_work and steps < 200:
        outputs.update({sid: toks for sid, toks, _ in eng.serve_step(fused_rounds=2)})
        steps += 1
        if steps == 2:
            id_b = eng.submit([9, 8, 7], sp(20))
    assert set(outputs) == {id_a, id_b}
    # greedy streams do not depend on the batch a request runs in
    assert outputs[id_a] == base[0] and outputs[id_b] == base[1]


def test_serve_drains_and_idles():
    eng = _engine()
    assert eng.serve_step() == []  # no work: nothing happens
    eng.submit([5, 6], sp(6))
    got = []
    while eng.has_work:
        got += eng.serve_step()
    assert len(got) == 1 and len(got[0][1]) >= 6


def test_cancel_frees_blocks():
    eng = _engine()
    free0 = (eng.scheduler.draft_bm.num_free_blocks, eng.scheduler.target_bm.num_free_blocks)
    a = eng.submit([1, 2, 3, 4, 5], sp(40))
    b = eng.submit([7, 8, 9], sp(10))
    eng.serve_step(2)  # both admitted, some rounds run
    assert eng.cancel(a)
    assert not eng.cancel(a)  # already gone
    assert list(_drain(eng)) == [b]  # a cancelled request is never reported
    assert (eng.scheduler.draft_bm.num_free_blocks, eng.scheduler.target_bm.num_free_blocks) == free0
    c = eng.submit([4, 5, 6], sp(10))  # cancel of a request still waiting
    assert eng.cancel(c)
    assert not eng.has_work


def test_stats_counters():
    eng = _engine()
    s0 = eng.stats()
    assert s0["completed_requests"] == 0 and s0["waiting"] == 0 and s0["mat"] is None
    eng.submit([1, 2, 3], sp(8))
    assert eng.stats()["waiting"] == 1
    _drain(eng)
    s1 = eng.stats()
    assert s1["completed_requests"] == 1 and s1["running"] == 0
    assert s1["completed_tokens"] >= 8
    assert s1["draft_free_blocks"] == s0["draft_free_blocks"]
    assert 1 <= s1["mat"] <= eng.config.gamma
    assert "ttft_p50_s" not in s0
    assert 0 < s1["ttft_p50_s"] <= s1["e2e_p50_s"]
    assert 0 < s1["tpot_p50_s"] < s1["e2e_p95_s"]


def test_streaming_deltas():
    """serve_step(with_deltas=True): the chunks concatenate to the final
    completion, arrive before it finishes, and are never taken back."""
    eng = _engine()
    sid = eng.submit([1, 2, 3, 4, 5], sp(40, ignore_eos=True))
    streamed, final, saw_partial = [], None, False
    while eng.has_work:
        done, deltas = eng.serve_step(1, with_deltas=True)
        for rid, toks, finished in deltas:
            assert rid == sid
            saw_partial |= bool(toks) and not finished
            streamed += toks
        for _, toks, _ in done:
            final = toks
    assert saw_partial and final is not None and streamed == final


def test_warmup_leaves_no_trace():
    eng = _engine(warmup=(2,))
    s = eng.stats()
    assert not eng.has_work and s["completed_requests"] == 0
    assert s["target_free_blocks"] == 96 and not eng.scheduler.target_bm.hash_to_block


def _post(port, payload, path="/generate"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


@pytest.fixture
def http_server():
    engine = _engine()
    server = serve.PearlServer(engine, fused_rounds=2)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(server))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()
    server.stop()
    thread.join(timeout=30)
    assert not thread.is_alive() and not server.thread.is_alive()


def test_http_round_trip(http_server):
    port = http_server
    want, *_ = (lambda e: (e.add_request([1, 2, 3, 4, 5], sp(12)), e.generate_token_ids())[1])(_engine())
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=30) as r:
        assert json.loads(r.read())["ok"]
    results = {}

    def call(name, prompt, n):
        results[name] = _post(port, {"prompt": prompt, "max_tokens": n, "temperature": 0.0})

    threads = [threading.Thread(target=call, args=("a", [1, 2, 3, 4, 5], 12)),
               threading.Thread(target=call, args=("b", [7, 8, 9], 9))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    assert results["a"]["token_ids"] == want[0]
    assert results["b"]["num_tokens"] >= 1
    with pytest.raises(urllib.error.HTTPError) as e:  # no prompt: 400 with a JSON error
        _post(port, {"max_tokens": 4})
    assert e.value.code == 400 and "error" in json.loads(e.value.read())


def test_http_async_cancel_and_stream(http_server):
    port = http_server
    rid = _post(port, {"prompt": [1, 2, 3, 4, 5], "max_tokens": 10, "blocking": False})["request_id"]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/result?request_id={rid}", timeout=120) as r:
        assert json.loads(r.read())["num_tokens"] >= 10
    rid2 = _post(port, {"prompt": [9, 9, 9], "max_tokens": 200, "ignore_eos": True,
                        "blocking": False})["request_id"]
    assert _post(port, {"request_id": rid2}, "/cancel")["cancelled"] is True
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/result?request_id={rid2}", timeout=60) as r:
        assert json.loads(r.read())["cancelled"] is True
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps({"prompt": [1, 2, 3], "max_tokens": 30, "ignore_eos": True,
                         "stream": True}).encode(),
        headers={"Content-Type": "application/json"},
    )
    chunks, final = [], None
    with urllib.request.urlopen(req, timeout=120) as r:
        for raw in r:
            rec = json.loads(raw)
            if rec.get("done"):
                final = rec
            elif "token_ids" in rec:
                chunks += rec["token_ids"]
    assert final is not None and chunks == final["token_ids"] and final["num_tokens"] >= 30


def test_server_cli_builds_the_layer_share_pair(monkeypatch):
    """``--layer-share --cpu`` builds the serve pair in f32 on the CPU
    (narrowed here); without --cpu and without a card the engine raises."""
    wide = serve.layer_share_models

    def narrow(args):
        return tuple(dataclasses.replace(m, hidden_size=64, intermediate_size=128,
                                         num_attention_heads=4, head_dim=64, vocab_size=512)
                     for m in wide(args))

    d, t = wide(serve.parse_args(["--layer-share", "--cpu"]))
    assert (d.num_hidden_layers, t.num_hidden_layers, d.num_attention_heads, d.head_dim) == (3, 36, 16, 64)
    assert d.dtype == "float32" and d.hidden_size == 1024 and t.vocab_size == 32768
    monkeypatch.setattr(serve, "layer_share_models", narrow)
    args = serve.parse_args(["--layer-share", "--cpu", "--draft-layers", "1", "--target-layers", "2",
                             "--max-model-len", "256"])
    eng = serve.build_engine(args, max_num_batched_tokens=256)
    assert eng.device.type == "cpu" and eng.config.gamma == 8
    eng.submit([3, 4, 5], sp(9, ignore_eos=True))
    assert len(next(iter(_drain(eng).values()))) >= 9
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.build_engine(serve.parse_args(["--layer-share", "--draft-layers", "1",
                                                 "--target-layers", "2", "--max-model-len", "256"]))


@pytest.mark.parametrize("k,p,t", [(0, 1.0, 1.0), (5, 1.0, 1.0), (0, 0.7, 1.0), (8, 0.5, 0.9), (1, 1.0, 1.0)])
def test_apply_top_k_top_p_matches_jax(k, p, t):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(12, 50)).astype(np.float32)
    mixed_k = np.full((12,), k, np.int32)
    mixed_k[::3] = 0  # a row with the filter off beside filtered ones
    args = (mixed_k, np.full((12,), p, np.float32), np.full((12,), t, np.float32))
    got = apply_top_k_top_p(torch.from_numpy(logits), *map(torch.from_numpy, args)).numpy()
    want = np.asarray(japply(jnp.asarray(logits), *map(jnp.asarray, args)))
    np.testing.assert_array_equal(got > NEG_INF / 2, want > NEG_INF / 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_top_k_one_is_greedy_end_to_end():
    """top_k=1 at any temperature leaves only the argmax: PEARL and AR
    sampled under it equal greedy PEARL and AR (the filtered sampler,
    accept test and revise draw, end to end)."""
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7], [3, 1, 4, 1, 5, 9]]

    def run(params, ar):
        eng = _engine()
        for pr in prompts:
            eng.add_request(list(pr), params)
        out, *_ = eng.AR_generate_token_ids() if ar else eng.generate_token_ids()
        return out

    filt = SamplingParams(temperature=0.8, max_tokens=16, top_k=1)
    greedy = SamplingParams(temperature=0.0, max_tokens=16)
    assert run(filt, False) == run(filt, True) == run(greedy, False) == run(greedy, True)


def test_top_p_engine_runs_to_length():
    eng = _engine()
    params = SamplingParams(temperature=1.0, max_tokens=12, top_p=0.8, top_k=8, ignore_eos=True)
    for pr in ([1, 2, 3, 4, 5], [9, 8, 7]):
        eng.add_request(pr, params)
    pearl, *_ = eng.generate_token_ids()
    assert all(len(t) >= 12 for t in pearl)
