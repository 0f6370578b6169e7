"""Request state (reference: nano_pearl/pearl_engine/sequence.py).

Single-controller redesign: the reference replicates one ``Sequence``
object into every worker process, and the draft/target groups' copies
*diverge* (the draft runs gamma tokens ahead; each group appends its own
prefill sample). Here one host owns one ``Sequence`` holding two
``SeqView``s — ``draft`` (speculative stream) and ``target`` (committed
stream, the one outputs are read from, matching the reference reading
results from the target group's shm: pearl_engine.py:49-53).
"""

from __future__ import annotations

from enum import Enum, auto
from itertools import count

from nano_pearl_tpu_torch.config import SamplingParams


class SequenceStatus(Enum):
    WAITING = auto()
    RUNNING = auto()
    FINISHED = auto()


class SeqView:
    """One group's token stream + paged-cache addressing state."""

    __slots__ = ("token_ids", "block_table", "num_cached_tokens", "block_size")

    def __init__(self, token_ids: list[int], block_size: int):
        self.token_ids = list(token_ids)
        self.block_table: list[int] = []
        self.num_cached_tokens = 0
        self.block_size = block_size

    def __len__(self) -> int:
        return len(self.token_ids)

    @property
    def num_blocks(self) -> int:
        return -(-len(self.token_ids) // self.block_size)

    @property
    def num_cached_blocks(self) -> int:
        return self.num_cached_tokens // self.block_size

    @property
    def last_block_num_tokens(self) -> int:
        return len(self.token_ids) - (self.num_blocks - 1) * self.block_size

    @property
    def last_token(self) -> int:
        return self.token_ids[-1]

    def block_tokens(self, i: int) -> list[int]:
        return self.token_ids[i * self.block_size : (i + 1) * self.block_size]

    def token_to_slot(self, token_index: int) -> int:
        """Flat KV slot of a token (reference: sequence.py:84-88)."""
        block_id = self.block_table[token_index // self.block_size]
        return block_id * self.block_size + token_index % self.block_size

    def append(self, token_id: int):
        self.token_ids.append(token_id)

    def truncate(self, n: int):
        """Drop the last n tokens (reference: sequence.py:78-82); the KV
        contents need no device-side touch — rollback is pure length
        bookkeeping."""
        assert 0 < n < len(self.token_ids)
        del self.token_ids[-n:]


class Sequence:
    counter = count()

    def __init__(self, token_ids: list[int], sampling_params: SamplingParams, block_size: int):
        self.seq_id = next(Sequence.counter)
        self.status = SequenceStatus.WAITING
        self.num_prompt_tokens = len(token_ids)
        self.temperature = sampling_params.temperature
        self.max_tokens = sampling_params.max_tokens
        self.ignore_eos = sampling_params.ignore_eos
        self.top_k = sampling_params.top_k
        self.top_p = sampling_params.top_p
        self.stop_token_ids = tuple(sampling_params.stop_token_ids)
        # PEARL state (reference: sequence.py:30-32)
        self.pre_verify = True
        # draft window (gamma) of the request's last PEARL round: after an
        # accept its last window - 1 tokens are unverified
        # (Scheduler.drop_unverified)
        self.window = 0
        self.num_acc_tokens: list[int] = []
        self.cur_acc_tokens = 0
        self.num_rounds = 0  # PEARL rounds this request took part in (engine MAT)
        # completion tokens already handed to a streaming consumer
        # (engine.serve_step with_deltas); never exceeds the stable
        # (rollback-proof) frontier of the committed stream
        self.num_streamed = 0
        # serving latency stamps (perf_counter): set by engine.add_request
        # and the prefill sampling pass; feed the TTFT/TPOT percentiles in
        # engine.stats
        self.t_submit: float | None = None
        self.t_first: float | None = None
        self.draft = SeqView(token_ids, block_size)
        self.target = SeqView(token_ids, block_size)

    @property
    def is_finished(self) -> bool:
        return self.status == SequenceStatus.FINISHED

    @property
    def num_completion_tokens(self) -> int:
        """Committed (target-view) completion length."""
        return len(self.target) - self.num_prompt_tokens

    @property
    def completion_token_ids(self) -> list[int]:
        return self.target.token_ids[self.num_prompt_tokens :]

    @property
    def prompt_token_ids(self) -> list[int]:
        return self.target.token_ids[: self.num_prompt_tokens]
