"""The port's engine over quantized weights and KV caches against the JAX
engine on the CPU, in f32: the same weights and cache kind give the same
PEARL and AR token streams and accepted-token totals."""

import numpy as np
import pytest

import nano_pearl_tpu
from nano_pearl_tpu import config as jcfg
from nano_pearl_tpu_torch import ModelConfig, PearlEngine
from nano_pearl_tpu_torch import config as tcfg
from nano_pearl_tpu_torch.models.transformer import init_params_numpy
from nano_pearl_tpu_torch.utils.layer_share import build_layer_share_pair
from test_torch_kv_quant import ENGINE, MODEL, _add, one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.mark.parametrize("case", ["int8, independent pair, ceiling", "fp8, noisy layer-share pair, throughput"])
def test_streams_match_jax_engine(case):
    """The same quantized weights and cache kind on both engines, in f32:
    the port's PEARL and AR token streams and accepted-token totals equal
    the JAX engine's. int8 on an independent random draft and target
    (partial acceptance) under the ceiling profile; fp8 on the 2L/3L
    layer-share pair with a noisy draft under the throughput profile,
    whose quantized verify is the classic one in both packages."""
    kind, pair, profile = case.split(", ")
    if pair.startswith("independent"):
        m = ModelConfig(**MODEL)
        dp = init_params_numpy(m, np.random.default_rng(10))
        tp = init_params_numpy(m, np.random.default_rng(11))
        target = MODEL
    else:
        target = {**MODEL, "num_hidden_layers": 3}
        dp, tp = build_layer_share_pair(ModelConfig(**MODEL), ModelConfig(**target), seed=3, draft_noise=0.05)
    quant = dict(draft_quant=kind, target_quant=kind, draft_kv_quant=kind, target_kv_quant=kind)

    def config(module):
        return module.PearlConfig(
            draft_model=module.ModelConfig(**MODEL), target_model=module.ModelConfig(**target), gamma=3,
            perf_profile=profile, **quant, **ENGINE,
        )

    jeng = nano_pearl_tpu.PearlEngine(config(jcfg), draft_params=dp, target_params=tp)
    teng = PearlEngine(config(tcfg), dp, tp, device="cpu")
    outs = []
    for eng in (jeng, teng):
        _add(eng, 16)
        p, n, acc, _ = eng.generate_token_ids()
        _add(eng, 16)
        a, _, _, _ = eng.AR_generate_token_ids()
        outs.append((p, n, [round(sum(x), 5) for x in acc], a))
    assert outs[0] == outs[1]
