"""Configuration for the PyTorch port of nano-PEARL.

A copy of ``nano_pearl_tpu/config.py`` (the port imports nothing of the
JAX package), so both packages read the same ``ModelConfig`` /
``PearlConfig`` fields and the tests can build one config for both.
Fields that only the JAX package acts on (mesh placement, parallel
layouts, quantisation) are kept so configs stay
interchangeable; the port's engine raises on the ones it does not run
yet (engine/engine.py).

- ``ModelConfig`` parses ``config.json`` directly, or is constructed
  in-memory for tests.
- TP padding (reference: pearl_config.py:37-67) is applied for *every*
  TP degree; when dims already divide evenly it is a no-op.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, replace

LANE = 128  # TPU lane width; MXU/VPU minor-dim tile.


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


@dataclass
class SamplingParams:
    """Per-request sampling parameters (reference: layers/sampler.py:45-52;
    top_k/top_p are beyond the reference's temperature-only sampler —
    they filter both the sampled distribution and the PEARL accept-test /
    revise distributions, see ops/sampling.apply_top_k_top_p)."""

    temperature: float = 1.0
    max_tokens: int = 64
    ignore_eos: bool = False
    top_k: int = 0  # <= 0: disabled
    top_p: float = 1.0  # >= 1: disabled
    # per-request stop tokens (beyond the reference): they EXTEND the
    # model's EOS set for this request; ignore_eos (a benchmarking knob)
    # disables both. Both execution paths honor them — the fused loop
    # builds a per-request [B, S] stop matrix consumed by the on-device
    # verdict (engine/pearl._build_fused_state, engine/fused.py).
    stop_token_ids: tuple = ()


@dataclass
class ModelConfig:
    """Architecture hyper-parameters of one model (draft or target).

    Mirrors the fields the reference reads off HF ``AutoConfig``
    (reference: pearl_config.py:20-67, models/llama.py, qwen2.py, qwen3.py).
    """

    architecture: str = "LlamaForCausalLM"
    hidden_size: int = 256
    intermediate_size: int = 1024
    num_hidden_layers: int = 2
    num_attention_heads: int = 4
    num_key_value_heads: int = 2
    head_dim: int | None = None
    vocab_size: int = 512
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    attention_bias: bool = False  # llama attention_bias / qwen2 implicit qkv bias
    qkv_bias: bool | None = None  # qwen2-style; overrides attention_bias for qkv
    qk_norm: bool = False  # qwen3 per-head q/k RMS norm
    eos_token_id: int | list[int] = 2
    dtype: str = "bfloat16"
    rope_scaling: dict | None = None
    quant: str | None = None  # None | "int8" | "fp8" (weight-only, per-out-channel)
    # Fuse wq|wk|wv -> wqkv and wgate|wup -> wgu at engine build time
    # (reference: QKVParallelLinear / MergedColumnParallelLinear fused
    # weights, linear.py:92-150). Dense models, pp=1 only.
    fuse_proj: bool = False
    kv_quant: str | None = None  # None | "int8" | "fp8" (KV cache, per-token-per-head scale)
    # Mixture-of-Experts (Qwen3-MoE / Mixtral; beyond the reference —
    # SURVEY §2.8 lists expert parallelism as absent there). num_experts=0
    # means dense. All decoder layers must be sparse (no mlp_only_layers).
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_intermediate_size: int | None = None  # per-expert FFN width
    norm_topk_prob: bool = True  # renormalize kept top-k probs (Mixtral: always)

    # Filled in by `pad_for_tp`; identical to the originals when no padding
    # was needed. Sharded dims must divide tp.
    tp_size: int = 1
    ep_size: int = 1
    valid_vocab_size: int = -1
    valid_num_heads: int = -1
    valid_num_kv_heads: int = -1
    valid_intermediate_size: int = -1
    valid_num_experts: int = -1
    model_path: str | None = None

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_attention_heads
        if self.qkv_bias is None:
            self.qkv_bias = self.attention_bias
        if self.valid_vocab_size < 0:
            self.valid_vocab_size = self.vocab_size
        if self.valid_num_heads < 0:
            self.valid_num_heads = self.num_attention_heads
        if self.valid_num_kv_heads < 0:
            self.valid_num_kv_heads = self.num_key_value_heads
        if self.valid_intermediate_size < 0:
            self.valid_intermediate_size = self.intermediate_size
        if self.is_moe and self.moe_intermediate_size is None:
            self.moe_intermediate_size = self.intermediate_size
        if self.valid_num_experts < 0:
            self.valid_num_experts = self.num_experts

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def eos_ids(self) -> list[int]:
        e = self.eos_token_id
        return [e] if isinstance(e, int) else list(e)

    @classmethod
    def from_json(cls, path: str) -> "ModelConfig":
        """Load from a HF-style ``config.json`` (directory or file path)."""
        cfg_file = path if path.endswith(".json") else os.path.join(path, "config.json")
        with open(cfg_file) as f:
            raw = json.load(f)
        arch = raw.get("architectures", ["?"])[0]
        qk_norm = arch in ("Qwen3ForCausalLM", "Qwen3MoeForCausalLM")
        # MoE (Qwen3-MoE: num_experts; Mixtral: num_local_experts, whose
        # intermediate_size IS the per-expert width and which always
        # renormalizes the kept top-k probabilities)
        num_experts = raw.get("num_experts", raw.get("num_local_experts", 0)) or 0
        if num_experts:
            assert not raw.get("mlp_only_layers"), "dense/sparse mixed layers unsupported"
            assert raw.get("decoder_sparse_step", 1) == 1, "every layer must be sparse"
        return cls(
            architecture=raw.get("architectures", ["LlamaForCausalLM"])[0],
            hidden_size=raw["hidden_size"],
            intermediate_size=raw["intermediate_size"],
            num_hidden_layers=raw["num_hidden_layers"],
            num_attention_heads=raw["num_attention_heads"],
            num_key_value_heads=raw.get("num_key_value_heads", raw["num_attention_heads"]),
            head_dim=raw.get("head_dim"),
            vocab_size=raw["vocab_size"],
            rms_norm_eps=raw.get("rms_norm_eps", 1e-6),
            rope_theta=raw.get("rope_theta", 10000.0),
            max_position_embeddings=raw.get("max_position_embeddings", 4096),
            tie_word_embeddings=raw.get("tie_word_embeddings", False),
            attention_bias=raw.get("attention_bias", False) or raw.get("bias", False),
            qkv_bias=raw.get("qkv_bias", True if raw.get("architectures", ["?"])[0] == "Qwen2ForCausalLM" else None),
            qk_norm=qk_norm,
            eos_token_id=raw.get("eos_token_id", 2),
            # transformers >= 4.56 writes "dtype" where older releases wrote "torch_dtype"
            dtype=raw.get("torch_dtype") or raw.get("dtype") or "bfloat16",
            rope_scaling=raw.get("rope_scaling"),
            num_experts=num_experts,
            num_experts_per_tok=raw.get("num_experts_per_tok", 2),
            moe_intermediate_size=raw.get("moe_intermediate_size"),
            norm_topk_prob=raw.get("norm_topk_prob", True),
            model_path=os.path.dirname(cfg_file) or ".",
        )

    def pad_for_tp(self, tp: int, ep: int = 1) -> "ModelConfig":
        """Pad head/ffn/vocab dims so every sharded dim divides ``tp``
        (and, for MoE, the expert count divides ``ep``).

        Reference: pearl_config.py:37-67 (non-2-power TP padding). We pad
        for any tp (no-op when divisible) and align intermediate/vocab to
        the 128-lane TPU tile per shard. Padded experts carry zero
        weights and are masked out of routing (ops/moe.py ``route``).
        """
        gqa_ratio = self.num_attention_heads // self.num_key_value_heads
        padded_kv = round_up(self.num_key_value_heads, tp)
        padded_heads = padded_kv * gqa_ratio
        padded_intermediate = round_up(self.intermediate_size, tp * LANE)
        padded_vocab = round_up(self.vocab_size, tp * LANE)
        assert ep == 1 or self.is_moe, "ep > 1 requires an MoE model"
        moe_f = self.moe_intermediate_size
        return replace(
            self,
            tp_size=tp,
            ep_size=ep,
            num_key_value_heads=padded_kv,
            num_attention_heads=padded_heads,
            intermediate_size=padded_intermediate,
            vocab_size=padded_vocab,
            valid_num_kv_heads=self.num_key_value_heads,
            valid_num_heads=self.num_attention_heads,
            valid_intermediate_size=self.intermediate_size,
            valid_vocab_size=self.vocab_size,
            num_experts=round_up(self.num_experts, ep) if self.is_moe else 0,
            valid_num_experts=self.num_experts,
            moe_intermediate_size=round_up(moe_f, tp * LANE) if self.is_moe else moe_f,
        )


@dataclass
class PearlConfig:
    """Global engine config (reference: pearl_config.py:69-107).

    ``draft_model`` / ``target_model`` accept either a checkpoint directory
    (with ``config.json`` + ``*.safetensors``) or an in-memory
    ``ModelConfig`` (tests / benchmarks with random weights).
    """

    draft_model: str | ModelConfig
    target_model: str | ModelConfig
    draft_tp: int = 1
    target_tp: int = 1
    # Sequence (context) parallelism per group: the paged KV cache's
    # block axis is sharded over an extra mesh axis and attention merges
    # partial softmaxes across shards (parallel/sp.py). A group then
    # spans tp*sp devices. Beyond the reference (SURVEY §2.8).
    draft_sp: int = 1
    target_sp: int = 1
    # Pipeline parallelism per group: stacked layer weights + the KV
    # cache's layer axis shard over a pp mesh axis; activations hand off
    # between stages over ICI (parallel/pp.py). A group spans tp*pp
    # devices; num_hidden_layers must divide pp. Beyond the reference
    # (SURVEY §2.8).
    draft_pp: int = 1
    target_pp: int = 1
    # Expert parallelism per group (MoE models only): the stacked expert
    # weights shard over an extra `ep` mesh axis and the gate-weighted
    # expert combine reduces across it (ops/moe.py, parallel/sharding.py).
    # A group then spans tp*ep devices. Beyond the reference (SURVEY §2.8:
    # expert parallelism absent there).
    draft_ep: int = 1
    target_ep: int = 1
    max_num_batched_tokens: int = 16384
    max_num_seqs: int = 256
    max_model_len: int = 4096
    # 256 matches the reference default (pearl_config.py:81).
    kvcache_block_size: int = 256
    num_kvcache_blocks: int = -1  # -1: derive from hbm_utilization
    hbm_utilization: float = 0.9
    gamma: int = -1  # -1: auto profile (reference: pearl_config.py:84)
    # gamma == -1 additionally enables ACCEPTANCE-ADAPTIVE gamma (beyond
    # the reference): the engine keeps an EWMA estimate of draft/target
    # agreement from observed committed tokens/round and re-picks gamma
    # from a throughput model at fused chunk boundaries / overlap rounds
    # (engine/pearl.py _adapt_gamma). Batch sizes profiled at engine
    # build for the speed-ratio seed gamma; None = the reference's
    # (1, 2, 4, 8, 16, 32) ladder. Pass a smaller tuple (e.g. just the
    # serving batch size) to bound profiling time.
    gamma_profile_batches: tuple | None = None
    seed: int = 0
    dtype: str = "bfloat16"
    # "overlap": per-round host loop, draft/target programs dispatched
    #   concurrently on disjoint sub-meshes (the reference's two-process
    #   concurrency, single-controller style); in the port, on two CUDA
    #   streams of the one device.
    # "fused": the whole multi-round loop compiled into one program with
    #   an on-device state machine — zero host syncs per round. Requires
    #   both groups on the same device set (single chip or union
    #   placement).
    # "auto": fused when device sets coincide, else overlap.
    execution_mode: str = "auto"
    # weight-only quantization per model group (None | "int8" | "fp8")
    draft_quant: str | None = None
    target_quant: str | None = None
    # KV-cache quantization per model group (None | "int8" | "fp8")
    draft_kv_quant: str | None = None
    target_kv_quant: str | None = None
    # use the native C++ block-manager core (native/block_manager.cc)
    native_block_manager: bool = False
    # Upper bounds on work per fused-loop chunk (rounds of the PEARL loop /
    # steps of the AR loop run between two host syncs of the state).
    max_dispatch_rounds: int = 48
    max_dispatch_steps: int = 256
    # Pre-compile the serving-path programs at engine init (reference:
    # warmup_model, pearl_model_runner.py:333-344 warms the max-shape
    # prefill before serving). False: compile lazily on first use (first
    # requests pay the compiles). True: warm batch bucket 1. A tuple of
    # batch sizes warms each of those decode buckets.
    warmup: bool | tuple = False
    # "disjoint": draft/target on separate device slices (overlap-friendly)
    # "union": both models TP-sharded over ALL devices (fused-friendly,
    #   full ICI width per model; needs draft_tp == target_tp == n_devices)
    placement: str = "disjoint"
    # Decode batch buckets (reference: the CUDA-graph capture buckets,
    # pearl_model_runner.py:276). None -> profile-dependent default
    # (__post_init__): under the "ceiling" profile the smallest decode
    # bucket is 8, for numerics: decode GEMMs with very few rows may
    # round differently from the packed-verify GEMMs, and the draft's
    # gamma-scan and the target's verify must agree at identical weights.
    decode_bucket_sizes: tuple[int, ...] | None = None
    prefill_token_buckets: tuple[int, ...] = (128, 256, 512, 1024, 2048, 4096, 8192, 16384)
    # Explicit device assignment (list of jax devices) or None for
    # automatic split: draft gets the first draft_tp devices, target the
    # next target_tp (reference: pearl_config.py:88-93). On hosts with
    # fewer devices than draft_tp+target_tp the groups share devices
    # (still correct; concurrency degrades gracefully).
    devices: object = None
    # Kernel-schedule profile (engine/runner.py resolves it; the JAX
    # package's NANO_PEARL_* overrides are not ported):
    # - "ceiling": per-sequence attention kernels + classic write-then-read
    #   verify: the schedule whose draft-decode and verify logits agree
    #   most often at identical weights (the layer-share bench). Kernels:
    #   K1 decode, K2 packed verify, K3/K4 prefill.
    # - "throughput": mono-schedule decode + deferred-write verify (fresh
    #   K/V kept out of the cache during the layers, written back once per
    #   round), for pairs whose acceptance comes from real divergence.
    #   Kernels: K5 decode, K7 + K12 packed verify, K3/K4 prefill.
    perf_profile: str = "ceiling"
    # Classic-verify sequence-group chunk cap (0 = off, -1 = profile
    # default: 16 under "ceiling", 0 otherwise): packed verifies run in
    # chunks of at most cap sequences, keeping the verify GEMMs' row
    # count near the decode stream's so the two streams round alike.
    verify_group_cap: int = -1

    draft_config: ModelConfig = field(init=False)
    target_config: ModelConfig = field(init=False)

    def __post_init__(self):
        if self.verify_group_cap == -1:
            self.verify_group_cap = 16 if self.perf_profile == "ceiling" else 0
        if self.decode_bucket_sizes is None:
            self.decode_bucket_sizes = (
                (8, 16, 32, 64, 128, 256, 512)
                if self.perf_profile == "ceiling"
                else (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
            )
        if self.perf_profile not in ("ceiling", "throughput"):
            raise ValueError(
                f"unknown perf_profile {self.perf_profile!r} "
                "(expected 'ceiling' or 'throughput')"
            )

        def resolve(m) -> ModelConfig:
            return ModelConfig.from_json(m) if isinstance(m, str) else m

        self.draft_config = resolve(self.draft_model).pad_for_tp(
            self.draft_tp, self.draft_ep
        )
        self.target_config = resolve(self.target_model).pad_for_tp(
            self.target_tp, self.target_ep
        )
        if self.draft_quant:
            self.draft_config = replace(self.draft_config, quant=self.draft_quant)
        if self.target_quant:
            self.target_config = replace(self.target_config, quant=self.target_quant)
        if self.draft_kv_quant:
            self.draft_config = replace(self.draft_config, kv_quant=self.draft_kv_quant)
        if self.target_kv_quant:
            self.target_config = replace(self.target_config, kv_quant=self.target_kv_quant)
        # max_num_batched_tokens MAY be smaller than max_model_len:
        # prompts longer than the budget prefill in block-aligned chunks
        # (chunked prefill, engine/pearl.py prefill_all — the reference
        # cannot admit them at all: scheduler.py:39 + one prefill() per
        # generate). It must cover at least one KV block so chunk
        # boundaries stay block-aligned.
        assert self.max_num_batched_tokens >= self.kvcache_block_size, (
            "max_num_batched_tokens must cover at least one KV block"
        )
        assert self.max_model_len % self.kvcache_block_size == 0, (
            "max_model_len must be a multiple of the KV block size"
        )
        # Reference asserts draft/target eos equality (pearl_config.py:102).
        d_eos, t_eos = set(self.draft_config.eos_ids), set(self.target_config.eos_ids)
        assert d_eos == t_eos, f"draft eos {d_eos} != target eos {t_eos}"
        self.eos = self.target_config.eos_ids

    @property
    def max_blocks_per_seq(self) -> int:
        return cdiv(self.max_model_len, self.kvcache_block_size)

    def bucket_batch(self, n: int) -> int:
        """Smallest decode bucket >= n (reference: pearl_model_runner.py:252)."""
        for b in self.decode_bucket_sizes:
            if b >= n:
                return b
        return round_up(n, self.decode_bucket_sizes[-1])

    def prefill_bucket_batch(self, n: int) -> int:
        """Tight batch bucket for PREFILL programs. Prefill never needs
        the ceiling profile's min-8 decode pad: the draft and target
        prefill the same prompts at the same shapes, so the two streams'
        prefill numerics match by construction. It also sidesteps an
        XLA:CPU compiler CHECK crash ("Invalid binary instruction
        opcode copy", hlo_instruction.cc) observed when compiling
        batch-padded ep x tp prefill programs on the virtual test mesh."""
        for b in (1, 2, 4) + tuple(self.decode_bucket_sizes):
            if b >= n:
                return b
        return round_up(n, self.decode_bucket_sizes[-1])

    def bucket_tokens(self, n: int) -> int:
        """Smallest prefill token bucket >= n."""
        for b in self.prefill_token_buckets:
            if b >= n:
                return b
        return round_up(n, self.prefill_token_buckets[-1])
