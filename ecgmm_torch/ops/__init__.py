"""The port's kernels: each module holds a CUDA kernel's wrapper (used for
CUDA tensors), its plain PyTorch version (used for CPU tensors, and by the
tests and chip_smoke.py as the yardstick) and a launch counter. The one
exception is `spectrogram`, the CRNN's host-side STFT front end, which
has no kernel in either package.

The two serving kernels are also `torch.library` operators in the
`ecgmm` namespace (`ecgmm::fused_se`, `ecgmm::fused_se_backward`,
`ecgmm::attention_fusion`, `ecgmm::attention_fusion_backward`): a CUDA
implementation (the kernels, counted as in eager use), a CPU one (the
plain versions), a fake one (shapes only) and a registered backward.
Importing this package registers them; nothing is compiled. The entry
points `se.fused_se` and `fusion.fused_attention_fusion` call the
operators only inside `tracing_ops()`, which `serve/export.py` enters
while it traces the request program: a kernel launched through ctypes
outside an operator would leave only its output's allocation in a traced
graph. Outside the context the entry points are their eager selves.
"""

from ecgmm_torch.ops import fusion, se  # noqa: F401  (registers the ops)
from ecgmm_torch.ops._ext import tracing_ops

__all__ = ["tracing_ops"]
