"""The port's kernels: each module holds a CUDA kernel's wrapper (used for
CUDA tensors), its plain PyTorch version (used for CPU tensors, and by the
tests and chip_smoke.py as the yardstick) and a launch counter. The one
exception is `spectrogram`, the CRNN's host-side STFT front end, which
has no kernel in either package."""
