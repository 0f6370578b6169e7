"""Mixture-of-Experts MLP block (counterpart of nano_pearl_tpu/ops/moe.py):
the Qwen3-MoE / Mixtral sparse SwiGLU block in place of the dense one.

Expert weights are stacked on a leading E axis: ``wgate`` / ``wup`` ``[E,
H, F]``, ``wdown`` ``[E, F, H]``, the router ``[H, E]``. A quantized expert
stack is ``{"q", "s"}`` with scale ``[E, 1, F]`` (``[E, 1, H]`` for
``wdown``), multiplied in after the product, as ``ops/quant.mm`` does.

Routing is HF's: an f32 softmax over all experts (those at and past
``valid_num_experts`` masked to -inf), top-k, and with ``norm_topk_prob``
the kept weights renormalised. Two dispatches, as in the JAX package:

- dense (``moe_mlp``'s default): every expert over every row, then the
  gate-weighted sum over E. Decode and the ceiling profile's verify run
  it, so that the draft's decode and the target's verify round alike;
- sorted (``allow_ragged`` and at least ``_RAGGED_MIN_ROWS`` rows, no
  quantized stack): the (token, expert) pairs sorted by expert with a
  stable sort (so by token within an expert), one product per expert over
  its contiguous segment of the sorted rows, and a combine that sums each
  token's terms in the sorted order. Its segment sizes are read on the
  host (one read a call), which the per-expert products need.

The expert products are plain matrix products, as the JAX package's
batched einsums and ``ragged_dot`` are (no Pallas kernel there): the dense
ones are batched products over E with the rows broadcast, so the expert
stack is read in place and never copied; the sorted ones one product per
expert into a slice of one output. Expert parallelism
(``moe_mlp_ep``) is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nano_pearl_tpu_torch.ops.quant import is_quantized

_RAGGED_MIN_ROWS = 128  # below this the dense products' waste is noise


def _route_topk(router_logits: torch.Tensor, top_k: int, norm_topk_prob: bool,
                valid_num_experts: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """(kept weights [N, k] f32, expert ids [N, k]) of HF's routing."""
    logits = router_logits.float()
    e = logits.shape[1]
    if valid_num_experts is not None and valid_num_experts < e:
        pad = torch.arange(e, device=logits.device) >= valid_num_experts
        logits = logits.masked_fill(pad, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.topk(probs, top_k, dim=-1)
    if norm_topk_prob:
        vals = vals / vals.sum(dim=-1, keepdim=True)
    return vals, idx


def route(router_logits: torch.Tensor, top_k: int, norm_topk_prob: bool,
          valid_num_experts: int | None = None) -> torch.Tensor:
    """The dense gate matrix [N, E] (f32): each row's kept weights at its
    experts, zeros elsewhere. Scattering into zeros is exact, since top-k
    picks an expert at most once a row."""
    vals, idx = _route_topk(router_logits, top_k, norm_topk_prob, valid_num_experts)
    gates = torch.zeros(router_logits.shape, dtype=torch.float32, device=router_logits.device)
    return gates.scatter_(1, idx, vals)


def _mm_e(x: torch.Tensor, w) -> torch.Tensor:
    """[N, H] x [E, H, F] -> [E, N, F]: a batched product over E with x
    broadcast, which reads the stack in place (``torch.einsum("nh,ehf->enf")``
    folds (E, F) into one operand of one product and copies the stack)."""
    if is_quantized(w):
        return torch.matmul(x[None], w["q"].to(x.dtype)) * w["s"].to(x.dtype)
    return torch.matmul(x[None], w)


def _mm_e_down(a: torch.Tensor, w) -> torch.Tensor:
    """[E, N, F] x [E, F, H] -> [E, N, H] (quantized: scale [E, 1, H])."""
    if is_quantized(w):
        return torch.bmm(a, w["q"].to(a.dtype)) * w["s"].to(a.dtype)
    return torch.bmm(a, w)


def _moe_mlp_sorted(x, router_logits, wgate, wup, wdown, top_k, norm_topk_prob, valid_num_experts):
    """The sorted dispatch: top_k * N rows through the expert FFNs in
    place of E * N, routing exact (no capacity drop)."""
    n, h = x.shape
    e = router_logits.shape[1]
    vals, idx = _route_topk(router_logits, top_k, norm_topk_prob, valid_num_experts)
    e_flat = idx.reshape(-1)  # [S = N * k], pair s is token s // k
    order = torch.sort(e_flat, stable=True).indices
    xg = x[order // top_k]  # the sorted rows
    sizes = torch.bincount(e_flat, minlength=e).tolist()  # the host read
    g = torch.empty((xg.shape[0], wgate.shape[-1]), dtype=x.dtype, device=x.device)
    u = torch.empty_like(g)
    o = torch.empty_like(xg)
    bounds = []
    start = 0
    for j, c in enumerate(sizes):
        if c:
            bounds.append((j, start, start + c))
            torch.matmul(xg[start : start + c], wgate[j], out=g[start : start + c])
            torch.matmul(xg[start : start + c], wup[j], out=u[start : start + c])
        start += c
    a = F.silu(g.float()).to(x.dtype) * u
    for j, lo, hi in bounds:
        torch.matmul(a[lo:hi], wdown[j], out=o[lo:hi])
    # combine: each token's k weighted terms in f32, summed in the sorted
    # order (its experts ascending), as the JAX package's combine product
    terms = o.float() * vals.reshape(-1)[order][:, None]
    where = torch.empty_like(order)
    where[order] = torch.arange(order.shape[0], device=x.device)
    where = where.reshape(n, top_k).sort(dim=1).values  # sorted positions of each token's pairs
    out = terms[where[:, 0]]
    for j in range(1, top_k):
        out = out + terms[where[:, j]]
    return out.to(x.dtype)


def moe_mlp(
    x: torch.Tensor,  # [N, H]
    router_w: torch.Tensor,  # [H, E]
    wgate,  # [E, H, F] or {"q", "s"}
    wup,  # [E, H, F]
    wdown,  # [E, F, H]
    top_k: int,
    norm_topk_prob: bool,
    valid_num_experts: int | None = None,
    allow_ragged: bool = False,
) -> torch.Tensor:
    """The sparse-MoE SwiGLU block, [N, H]. ``allow_ragged`` sends calls of
    at least ``_RAGGED_MIN_ROWS`` rows to the sorted dispatch unless an
    expert stack is quantized; otherwise every expert runs over every row
    and the gates weight the sum over E."""
    router_logits = x @ router_w  # [N, E]
    if (
        allow_ragged
        and x.shape[0] >= _RAGGED_MIN_ROWS
        and not any(is_quantized(w) for w in (wgate, wup, wdown))
    ):
        return _moe_mlp_sorted(x, router_logits, wgate, wup, wdown, top_k, norm_topk_prob, valid_num_experts)
    gates = route(router_logits, top_k, norm_topk_prob, valid_num_experts)
    g = _mm_e(x, wgate)  # [E, N, F]
    u = _mm_e(x, wup)
    a = F.silu(g.float()).to(x.dtype) * u
    o = _mm_e_down(a, wdown)  # [E, N, H]
    # the gate-weighted sum over E in the model dtype, as the JAX package's
    # einsum: one [1, E] x [E, H] product a row, o read through its strides
    return torch.bmm(gates.to(x.dtype)[:, None, :], o.transpose(0, 1)).squeeze(1)
