"""PEARL and AR rounds over device state (counterpart of
nano_pearl_tpu/engine/fused.py).

Draft gamma-scan, target packed verify, verdict and state update run as
torch operations on device tensors; the only host read per round is
``finished.all()``, which stands in for the JAX package's
``lax.while_loop`` condition, so a run stops exactly where JAX's does.

The state machine relies on the PEARL invariant that once both streams
start from the same prefill token, the draft and target committed
streams are identical after every verify-apply:

- accept: draft already holds [P|G], target appends G -> both [C P G]
- reject at n: both end as [C P[:n+1] r] with the same revise token r

so one token buffer and one length vector represent both views.

While a cap chunks the packed verify (``verify_group_cap``, 16 under
the "ceiling" profile), the draft's decode runs in calls of exactly the
row count of one packed-verify chunk (``GroupRunner.decode_call_rows``,
``verify_group_cap`` groups whatever the batch): a smaller batch is
padded up to it, a larger one padded to a multiple of it and decoded
chunk by chunk. So the draft's decode and the target's verify of the
same position run every matrix product at one shape and round alike on
the card, at any batch size and also when the batch changes between the
round that drafts a window and the round that verifies it. cuBLAS picks
its kernel by shape: on an H100, 32 decode rows against a 224-row verify
chunk already round the FFN's down projection differently
(chip_smoke.py's decode_verify_bitwise phase). The layer-share pair's
acceptance ceiling rests on this. With no cap (the "throughput"
profile's default: its deferred verify folds attention in another order
anyway) the decode runs at the batch bucket's rows in one call.

Under the split-boundary schedule (``NANO_PEARL_SPLIT=1``,
engine/runner.py) each gamma-scan step decodes through K8a with the cell
partition of the verify that will check its token: step 0's token is
checked by this round's verify, whose fresh window starts at
``b1 = length - num_input``; the tokens of steps >= 1 by the next round's
verify after a fully accepted round, whose window starts at the
round-start length ``b1 = L`` (a rejected tail is discarded unverified,
so only the accept path's boundary matters), as the JAX package's
``_draft_gamma``. AR keeps K1.
"""

from __future__ import annotations

import torch

from nano_pearl_tpu_torch.config import PearlConfig
from nano_pearl_tpu_torch.engine.runner import GroupRunner
from nano_pearl_tpu_torch.ops.sampling import apply_top_k_top_p, greedy, sample
from nano_pearl_tpu_torch.ops.verify import verify_verdict


def _row_slots(block_tables: torch.Tensor, positions: torch.Tensor, block_size: int):
    """Flat KV slot for (row, position) through that row's block table;
    positions [B, K] -> slots [B, K] int32."""
    page = torch.clamp(positions // block_size, max=block_tables.shape[1] - 1)
    blk = torch.gather(block_tables, 1, page.long())
    return (blk * block_size + positions % block_size).to(torch.int32)


def _write_at(tokens: torch.Tensor, vals: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """tokens with ``vals`` [B, K] written from column ``start`` [B] of each
    row; the start is clamped so the write fits, as
    ``lax.dynamic_update_slice`` clamps it."""
    k = vals.shape[1]
    start = torch.clamp(start, 0, tokens.shape[1] - k)
    cols = start[:, None].long() + torch.arange(k, device=tokens.device)[None, :]
    return tokens.scatter(1, cols, vals.to(tokens.dtype))


def _filter_args(state: dict) -> tuple[bool, bool]:
    """(greedy_only, filtered): every row at T=0, and whether any sampled
    batch row carries top-k/top-p (a greedy batch skips the filter: its
    argmax always survives it)."""
    greedy_only = bool((state["temps"] == 0).all())
    filtered = not greedy_only and bool(((state["tk"] > 0) | (state["tp"] < 1)).any())
    return greedy_only, filtered


class FusedPearl:
    """PEARL and AR round loops over both models' device state."""

    def __init__(self, pcfg: PearlConfig, draft: GroupRunner, target: GroupRunner):
        self.pcfg = pcfg
        self.draft = draft
        self.target = target
        self.block_size = pcfg.kvcache_block_size

    # ------------------------------------------------------------ PEARL

    def decode_chunking(self, b: int, gamma: int) -> tuple[int, int]:
        """(calls, rows per call) of each gamma-scan decode step over b
        rows: calls of one verify chunk's row count under a verify cap, one
        call of b rows without (module doc)."""
        rows = self.target.decode_call_rows(b, gamma)
        return -(-b // rows), rows

    def _draft_gamma(self, tokens_last, positions, bt, ctx, gamma: int, b1=None) -> torch.Tensor:
        """gamma greedy draft decode steps; returns [B, gamma] int32. The
        rows are padded to ``decode_chunking``'s calls x rows; padded rows
        sit at position 0 with context 1 in the garbage block (and boundary
        0). ``b1``: step 0's split boundary under the split schedule (module
        doc); steps >= 1 cut at the round-start length ``ctx``."""
        b = tokens_last.shape[0]
        calls, r = self.decode_chunking(b, gamma)
        pad = calls * r - b
        split = self.draft.split and b1 is not None
        toks, pos, cl, b1_next = tokens_last, positions, ctx, ctx
        if pad > 0:
            zeros = torch.zeros(pad, dtype=torch.int32, device=pos.device)
            toks, pos, cl = torch.cat([toks, zeros]), torch.cat([pos, zeros]), torch.cat([cl, zeros + 1])
            garbage = torch.full((pad, bt.shape[1]), self.draft.garbage_block, dtype=bt.dtype, device=bt.device)
            bt = torch.cat([bt, garbage])
            if split:
                b1, b1_next = torch.cat([b1, zeros]), torch.cat([b1_next, zeros])
        out = []
        for t in range(gamma):
            slots = _row_slots(bt, pos[:, None], self.block_size)[:, 0]
            rows = (toks, pos, slots, bt, cl)
            if split:
                rows += (b1 if t == 0 else b1_next,)
            logits = [
                self.draft.decode_step(*(x[c * r : (c + 1) * r] for x in rows))
                for c in range(calls)
            ]
            toks = greedy(logits[0] if calls == 1 else torch.cat(logits))
            out.append(toks[:b])
            pos, cl = pos + 1, cl + 1
        return torch.stack(out, dim=1)

    def _target_packed(self, tokens, length, num_input, bt, gamma: int) -> torch.Tensor:
        """The target's packed verify over each row's last ``num_input``
        committed tokens (padded to gamma rows); returns logits [B, gamma, V]."""
        tr, bs = self.target, self.block_size
        b = length.shape[0]
        j = torch.arange(gamma, dtype=torch.int32, device=length.device)[None, :]
        idx = length[:, None] - num_input[:, None] + j  # [B, G]
        valid = j < num_input[:, None]
        idx_c = torch.clamp(idx, min=0)
        toks = torch.gather(tokens, 1, idx_c.long())
        positions = torch.where(valid, idx_c, 0)
        ctx = torch.where(valid, idx_c + 1, 1).to(torch.int32)
        slots = torch.where(valid, _row_slots(bt, idx_c, bs), tr.garbage_block * bs + (j % bs))
        flat = lambda x: x.reshape(b * gamma).contiguous()  # noqa: E731
        logits = tr.packed_verify_forward(
            flat(toks), flat(positions), flat(slots.to(torch.int32)), bt, flat(ctx), gamma
        )
        return logits.reshape(b, gamma, -1)

    def _pearl_round(self, s: dict, gamma: int, greedy_only: bool, filtered: bool, generator) -> None:
        """One PEARL round; updates the state dict ``s`` in place."""
        tokens, length, pre, finished = s["tokens"], s["length"], s["pre"], s["finished"]
        g_j = torch.arange(gamma, device=length.device)[None, :]
        last = torch.gather(tokens, 1, torch.clamp(length - 1, min=0)[:, None].long())[:, 0]
        num_input = torch.where(pre, 1, gamma).to(torch.int32)
        G = self._draft_gamma(last, length - 1, s["bt_d"], length, gamma, b1=length - num_input)
        logits = self._target_packed(tokens, length, num_input, s["bt_t"], gamma)

        # to-be-verified window: the previous round shifted by one, ending
        # with the first token of this draft round
        idx = torch.clamp(length[:, None] - num_input[:, None] + 1 + g_j, min=0)
        tbv = torch.gather(tokens, 1, idx.long())
        tbv = torch.where(g_j == (num_input[:, None] - 1), G[:, :1], tbv)

        if filtered:
            # top-k/top-p shape the accept-test and revise distributions,
            # as they shape what AR samples
            temps = s["temps"][:, None]
            logits = apply_top_k_top_p(logits, s["tk"][:, None], s["tp"][:, None], temps)
        res = verify_verdict(
            logits, tbv, pre, s["temps"], length - s["prompt_len"], s["max_tokens"],
            s["ignore_eos"], s["eos_ids"], gamma, greedy=greedy_only, generator=generator,
        )
        acc, n, revise, fin = res.acc, res.n_acc, res.revise, res.finish
        active = ~finished

        new_len = torch.where(
            acc, length + gamma, torch.where(pre, length + 1, length - gamma + n + 2)
        ).to(torch.int32)
        tok_acc = _write_at(tokens, G, length)
        tok_rej = _write_at(tokens, revise[:, None], new_len - 1)
        new_tokens = torch.where(acc[:, None], tok_acc, tok_rej)
        s["tokens"] = torch.where(active[:, None], new_tokens, tokens)

        cur_acc = s["cur_acc"]
        rej_emit = active & ~acc
        emitted = s["emitted"] + torch.where(rej_emit, cur_acc + n + 1, 0)
        emit_cnt = s["emit_cnt"] + rej_emit.to(torch.int32)
        cur_acc2 = torch.where(acc, cur_acc + n, 0)
        # finish emits the running counter
        emitted = emitted + torch.where(active & fin, cur_acc2, 0)
        s["emitted"] = emitted.to(torch.int32)
        s["emit_cnt"] = (emit_cnt + (active & fin).to(torch.int32)).to(torch.int32)
        s["cur_acc"] = torch.where(active, torch.where(fin, 0, cur_acc2), cur_acc).to(torch.int32)
        s["length"] = torch.where(active, new_len, length)
        s["rounds"] = s["rounds"] + active.to(torch.int32)
        s["pre"] = torch.where(active, ~acc, pre)
        s["finished"] = finished | (fin & active)

    def run_pearl(self, state: dict, gamma: int, num_rounds: int, generator=None) -> dict:
        """Up to ``num_rounds`` PEARL rounds, stopping early once every row
        has finished; ``state["rounds_done"]`` counts the rounds run."""
        greedy_only, filtered = _filter_args(state)
        i = 0
        while i < num_rounds and not bool(state["finished"].all()):
            self._pearl_round(state, gamma, greedy_only, filtered, generator)
            i += 1
        state["rounds_done"] = i
        return state

    # --------------------------------------------------------------- AR

    def run_ar(self, state: dict, num_steps: int, generator=None) -> dict:
        """Up to ``num_steps`` target-only decode steps, stopping early once
        every row has finished."""
        tr, bs = self.target, self.block_size
        greedy_only, filtered = _filter_args(state)
        eos = state["eos_ids"]
        stops = eos if eos.ndim == 2 else eos[None, :]
        i = 0
        while i < num_steps and not bool(state["finished"].all()):
            tokens, length, finished = state["tokens"], state["length"], state["finished"]
            last = torch.gather(tokens, 1, torch.clamp(length - 1, min=0)[:, None].long())[:, 0]
            pos = length - 1
            slots = _row_slots(state["bt_t"], pos[:, None], bs)[:, 0]
            logits = tr.decode_step(last, pos, slots, state["bt_t"], length)
            if greedy_only:
                nxt = greedy(logits)
            else:
                if filtered:
                    logits = apply_top_k_top_p(logits, state["tk"], state["tp"], state["temps"])
                nxt = sample(logits, state["temps"], generator=generator)
            active = ~finished
            state["tokens"] = _write_at(tokens, torch.where(active, nxt, 0)[:, None], length)
            length = torch.where(active, length + 1, length)
            state["length"] = length
            is_eos = (nxt[:, None] == stops).any(-1)
            fin = (~state["ignore_eos"] & is_eos) | (length - state["prompt_len"] >= state["max_tokens"])
            state["finished"] = finished | (fin & active)
            i += 1
        state["rounds_done"] = i
        return state
