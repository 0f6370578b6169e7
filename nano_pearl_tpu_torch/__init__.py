"""nano-PEARL in PyTorch for NVIDIA Hopper GPUs.

The PyTorch and CUDA port of ``nano_pearl_tpu``: PEARL speculative
decoding (draft gamma-scan, packed target verify, on-device verdict and
state update) over a paged KV cache, with the attention kernels written
by hand in CUDA C++ for ``sm_90a`` (``csrc/``). It imports neither JAX
nor the JAX package; tests hold it against that package on the CPU.
"""

from nano_pearl_tpu_torch.config import ModelConfig, PearlConfig, SamplingParams
from nano_pearl_tpu_torch.engine.engine import PearlEngine

__all__ = ["ModelConfig", "PearlConfig", "PearlEngine", "SamplingParams"]
