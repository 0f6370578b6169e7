"""The weightless layer-share model pair (counterpart of
``build_layer_share_pair`` in bench.py).

The draft has ``Ld`` random layers. The target holds the draft's
embedding, head and layers, followed by ``Lt - Ld`` layers whose output
projections (``wo``, ``wdown``) are zero, so they pass the residual
stream through unchanged. At T=0 the two models then propose the same
tokens, which puts PEARL at its acceptance ceiling. An MoE pair (bench.py
``--moe``) is built the same way: its expert stacks live under the same
keys, so the extra layers' ``wdown`` stacks are zero too.
"""

from __future__ import annotations

import numpy as np

from nano_pearl_tpu_torch.config import ModelConfig
from nano_pearl_tpu_torch.models.transformer import init_layers_numpy, init_params_numpy


def build_layer_share_pair(
    mc_draft: ModelConfig, mc_target: ModelConfig, seed: int, draft_noise: float = 0.0
):
    """(draft, target) parameter pytrees as f32 numpy arrays in the JAX
    package's layout, from ``numpy.random.default_rng(seed)``. With
    ``draft_noise`` > 0 each draft layer weight ``w`` becomes ``w +
    draft_noise * std(w) * N(0, 1)`` in f32 (a norm weight of ones has
    std 0 and stays), the noise from ``numpy.random.default_rng(seed +
    2)``, as bench.py's ``build_layer_share_pair``; the target keeps the
    clean weights."""
    ld, lt = mc_draft.num_hidden_layers, mc_target.num_hidden_layers
    if lt <= ld:
        raise ValueError(f"target layers {lt} must exceed draft layers {ld}")
    rng = np.random.default_rng(seed)
    dp = init_params_numpy(mc_draft, rng)
    ext = init_layers_numpy(mc_target, rng, lt - ld)
    layers = {}
    for k, v in dp["layers"].items():
        extension = np.zeros_like(ext[k]) if k in ("wo", "wdown") else ext[k]
        layers[k] = np.concatenate([v, extension], axis=0)
    tp = {
        "embed": dp["embed"],
        "layers": layers,
        "final_ln": dp["final_ln"],
        "lm_head": dp["lm_head"],
    }
    if draft_noise > 0.0:
        nrng = np.random.default_rng(seed + 2)
        noisy = {}
        for k, v in dp["layers"].items():
            scale = np.float32(draft_noise) * np.std(v.astype(np.float32))
            noise = nrng.standard_normal(v.shape, dtype=np.float32)
            noisy[k] = (v.astype(np.float32) + scale * noise).astype(v.dtype)
        dp = dict(dp, layers=noisy)
    return dp, tp
