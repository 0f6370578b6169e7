"""Sampling on the device (counterpart of nano_pearl_tpu/ops/sampling.py).

Every argmax here runs over materialised f32 logits (``torch.argmax``
returns the first maximal index, as ``jnp.argmax`` does), so the draft's
greedy pick and the verdict's argmax rank the same tensor. Random draws
come from an explicit ``torch.Generator``; callers that must reproduce
another framework's draws pass them in pre-drawn instead.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def mask_invalid_logits(logits: torch.Tensor, valid_vocab: int) -> torch.Tensor:
    """Set the padded vocab tail to NEG_INF so padded ids are never picked."""
    if valid_vocab >= logits.shape[-1]:
        return logits
    out = logits.clone()
    out[..., valid_vocab:] = NEG_INF
    return out


def apply_top_k_top_p(
    logits: torch.Tensor,  # [..., V]
    top_k: torch.Tensor,  # [...] int32; <= 0 disables
    top_p: torch.Tensor,  # [...] float32; >= 1 disables
    temperatures: torch.Tensor | None = None,  # [...] for the nucleus mass
) -> torch.Tensor:
    """Top-k then top-p (nucleus) filtering with per-row settings: kept
    tokens keep their logits, the rest go to NEG_INF, so sampling, the
    PEARL accept test and the revise draw all see the renormalised filtered
    distribution. The nucleus mass is taken at the row's temperature
    (temperature -> top_k -> top_p, as HF's warpers run); the token that
    crosses ``top_p`` is kept and the top token always survives."""
    lf = logits.float()
    v = lf.shape[-1]
    sorted_desc = torch.sort(lf, dim=-1, descending=True).values
    iota = torch.arange(v, device=lf.device)
    k_eff = torch.where(top_k > 0, torch.clamp(top_k, 1, v), v)[..., None]
    in_k = iota < k_eff
    sorted_kept = torch.where(in_k, sorted_desc, torch.full_like(sorted_desc, NEG_INF))
    t = 1.0 if temperatures is None else torch.clamp(temperatures, min=1e-10)[..., None]
    probs = torch.softmax(sorted_kept / t, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < torch.clamp(top_p, max=1.0)[..., None]
    count = (keep & in_k).sum(dim=-1)
    thresh = torch.gather(sorted_desc, -1, torch.clamp(count - 1, min=0)[..., None])
    return torch.where(lf < thresh, torch.full_like(lf, NEG_INF), lf)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last dim, int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def gumbel_noise(
    shape, generator: torch.Generator | None, device
) -> torch.Tensor:
    """Gumbel(0, 1) noise from uniforms on [1e-10, 1), as jax.random.uniform
    with minval=1e-10, maxval=1 is mapped."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    u = u * (1.0 - 1e-10) + 1e-10
    return -torch.log(-torch.log(u))


def sample(
    logits: torch.Tensor,
    temperatures: torch.Tensor,
    generator: torch.Generator | None = None,
    gumbel: torch.Tensor | None = None,
) -> torch.Tensor:
    """Gumbel-max sampling with per-row temperature; T=0 rows are greedy.
    ``gumbel`` (same shape as ``logits``) replaces the drawn noise."""
    t = temperatures.reshape(temperatures.shape + (1,) * (logits.ndim - temperatures.ndim))
    if gumbel is None:
        gumbel = gumbel_noise(logits.shape, generator, logits.device)
    lf = logits.float()
    z = lf / torch.clamp(t, min=1e-10) + torch.where(t > 0, gumbel, torch.zeros_like(gumbel))
    # masked (NEG_INF) logits stay unsamplable after the gumbel bump
    z = torch.where(lf <= NEG_INF / 2, torch.full_like(z, NEG_INF), z)
    return torch.argmax(z, dim=-1).to(torch.int32)


def norm_probs(logits: torch.Tensor, temperatures: torch.Tensor) -> torch.Tensor:
    """Accept-test probabilities: one-hot(argmax) at T=0, softmax(logits/T)
    otherwise, per row."""
    t = temperatures.reshape(temperatures.shape + (1,) * (logits.ndim - temperatures.ndim))
    lf = logits.float()
    soft = torch.softmax(lf / torch.clamp(t, min=1e-10), dim=-1)
    hard = torch.nn.functional.one_hot(torch.argmax(lf, dim=-1), lf.shape[-1]).float()
    return torch.where(t > 0, soft, hard)
