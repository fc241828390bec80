"""Float32 in float32 on the card: TF32 off while a section runs.

cuDNN's `allow_tf32` defaults to True, so a float32 convolution on an
Ampere or later card rounds its inputs to TF32 unless the flag is off.
The flags are process-global, not thread-local: a serving process runs
request programs on several threads (HTTP handlers, the micro-batcher's
worker) next to each other. `no_tf32` therefore counts the sections open
in the process: the first to open saves the flags and turns both off,
every one turns them off again, and the last to close restores them.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_lock = threading.Lock()
_open = 0
_saved = None


@contextlib.contextmanager
def no_tf32():
    """cuDNN convolutions and cuBLAS matmuls in float32, not TF32, while
    the context lasts; the flags are restored when the last open section
    of the process closes. Every float32 op of the JAX package is float32
    (the signal models, the image-only ResNet-18, the fusion head's
    float32 layers); bf16 work under autocast is unaffected."""
    global _open, _saved
    with _lock:
        if _open == 0:
            _saved = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        _open += 1
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        with _lock:
            _open -= 1
            if _open == 0:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = _saved
