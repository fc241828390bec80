"""PyTorch/CUDA port of the ecgmm multimodal ECG framework.

The JAX package `ecgmm_tpu` is the reference; this package re-implements
its serving path (`serve.pipeline.ServingPipeline.predict`) in PyTorch,
with the two TPU Pallas kernels on that path replaced by hand-written
CUDA kernels for Hopper (`ops/csrc/`). It imports nothing of JAX or of
`ecgmm_tpu`; the tests in `tests/test_torch_*.py` hold each module
against its JAX counterpart.
"""

from ecgmm_torch.config import ModelConfig

__all__ = ["ModelConfig"]
