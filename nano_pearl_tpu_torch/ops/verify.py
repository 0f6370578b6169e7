"""PEARL verification verdict on the device (counterpart of
nano_pearl_tpu/ops/verify.py, ported whole).

One batched program over ``[B, gamma]`` tensors replaces the reference's
per-sequence Python verify loop:

- accept test: r <= p_target(token), with one-hot probabilities at T=0
- revise token: sampled from the logits with the rejected token masked
- pre-verify sequences contribute one token, post-verify gamma tokens
  cut at the first rejection
- finish rules: EOS among the accepted tokens, max_tokens margin

The greedy branch is exact. The T>0 branch draws its uniforms ``r`` and
its Gumbel noise from ``generator``, unless the caller passes them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from nano_pearl_tpu_torch.ops.sampling import NEG_INF, norm_probs, sample


@dataclass
class VerifyResult:
    acc: torch.Tensor  # [B] bool: whole window accepted
    rollout: torch.Tensor  # [B] int32: tokens the draft rolls back beyond gamma
    revise: torch.Tensor  # [B] int32: corrected token (-1 when fully accepted)
    finish: torch.Tensor  # [B] bool
    n_acc: torch.Tensor  # [B] int32: accepted tokens this round


def verify_verdict(
    logits: torch.Tensor,  # [B, G, V] target logits for the packed window
    tbv: torch.Tensor,  # [B, G] int32 to-be-verified draft tokens
    is_pre: torch.Tensor,  # [B] bool
    temperatures: torch.Tensor,  # [B] f32
    num_completion: torch.Tensor,  # [B] int32 completion count before the update
    max_tokens: torch.Tensor,  # [B] int32
    ignore_eos: torch.Tensor,  # [B] bool
    eos_ids: torch.Tensor,  # [E] global stop set, or [B, S] per request (-1 padded)
    gamma: int,
    greedy: bool = False,
    generator: torch.Generator | None = None,
    r: torch.Tensor | None = None,  # [B, G] accept-test uniforms
    gumbel: torch.Tensor | None = None,  # [B, G, V] revise-sample noise
) -> VerifyResult:
    b, g, v = logits.shape
    if g != gamma:
        raise ValueError(f"logits window {g} != gamma {gamma}")
    dev = logits.device
    tbv = tbv.to(torch.int64)
    temps = temperatures[:, None].expand(b, g)
    if greedy:
        # T=0: the accept test is token == argmax, the revise pick the
        # argmax (the rejected token is never the argmax)
        argmax_tok = torch.argmax(logits, dim=-1)
        judge = tbv == argmax_tok
        revised = argmax_tok.to(torch.int32)
    else:
        probs = norm_probs(logits, temps)
        p_tok = torch.gather(probs, -1, tbv[..., None])[..., 0]
        if r is None:
            r = torch.rand((b, g), generator=generator, device=dev, dtype=torch.float32)
        judge = r <= p_tok
        masked = logits.float().scatter(-1, tbv[..., None], NEG_INF)
        revised = sample(masked, temps, generator=generator, gumbel=gumbel)

    stops = eos_ids if eos_ids.ndim == 2 else eos_ids[None, :].expand(b, -1)
    is_eos_tok = (tbv[..., None] == stops[:, None, :]).any(-1)  # [B, G]

    # post-verify: n = index of the first rejection (gamma if none)
    rej = ~judge
    any_rej = rej.any(dim=1)
    first_rej = torch.argmax(rej.to(torch.int8), dim=1)
    n_post = torch.where(any_rej, first_rej, torch.full_like(first_rej, gamma))
    pos = torch.arange(g, device=dev)[None, :]
    eos_hit_post = ((pos < n_post[:, None]) & is_eos_tok).any(dim=1)
    revise_post = torch.gather(revised, 1, torch.clamp(n_post, max=gamma - 1)[:, None])[:, 0]
    revise_post = torch.where(any_rej, revise_post, torch.full_like(revise_post, -1))
    acc_post = ~any_rej
    rollout_post = gamma - n_post
    finish_post = (eos_hit_post & ~ignore_eos) | (
        num_completion >= max_tokens - torch.clamp(n_post + 1, max=gamma)
    )

    # pre-verify: one token at window position 0
    j0 = judge[:, 0]
    rollout_pre = torch.where(j0, 0, gamma)
    revise_pre = revised[:, 0]
    finish_tok = torch.where(j0, tbv[:, 0].to(torch.int32), revise_pre)
    finish_eos = (finish_tok[:, None] == stops).any(-1)
    finish_pre = (finish_eos & ~ignore_eos) | (num_completion >= max_tokens - 1)
    n_pre = j0.to(torch.int32)

    return VerifyResult(
        acc=torch.where(is_pre, j0, acc_post),
        rollout=torch.where(is_pre, rollout_pre, rollout_post).to(torch.int32),
        revise=torch.where(is_pre, revise_pre, revise_post).to(torch.int32),
        finish=torch.where(is_pre, finish_pre, finish_post),
        n_acc=torch.where(is_pre, n_pre, n_post.to(torch.int32)).to(torch.int32),
    )
