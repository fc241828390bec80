"""The arithmetic of the reference's products: every convolution, dense
layer and batched product of `reference/models.py` goes through one of
these objects, so the same model computes exactly in float32 (the
reference) or in a lower precision (the control that has to come out as
not correct).

  * `Arith("float32")`: float32 operands, float32 accumulation. The caller
    turns TF32 off on the card (`exact_float32`).
  * `Arith("tf32")`: each operand rounded to TF32 (10 mantissa bits, to
    nearest), float32 accumulation: what a TF32 tensor core computes.
  * `Arith("bf16")`: each operand rounded to bfloat16, float32
    accumulation: near what bfloat16 autocast computes, for looking at
    where a bfloat16 program's gaps to the reference come from.
  * `Arith("fp8")`: each operand scaled by 448 / max|operand| and rounded
    to float8 e4m3, float32 accumulation: a per-tensor-scaled fp8 product,
    the step below bfloat16.

The rounding is written out, so a control computes the same on the CPU
and on the card."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to 10 mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x (float32) scaled so its largest magnitude is 448, rounded to
    float8 e4m3 and scaled back."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class Arith:
    def __init__(self, mode: str = "float32"):
        if mode not in ("float32", "tf32", "bf16", "fp8"):
            raise ValueError(f"unknown arithmetic {mode!r}")
        self.mode = mode

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand in this arithmetic. The rounding passes gradients
        straight through, so a backward multiplies by the rounded operands
        of the forward."""
        x = x.float()
        if self.mode == "float32":
            return x
        if self.mode == "tf32":
            low = round_tf32(x)
        elif self.mode == "bf16":
            low = x.to(torch.bfloat16).float()
        else:
            low = round_fp8(x)
        return x + (low - x).detach()

    def linear(self, x, w, b=None):
        y = F.linear(self.q(x), self.q(w))
        return y if b is None else y + b

    def conv1d(self, x, w, b=None, stride=1, padding=0):
        return F.conv1d(self.q(x), self.q(w), b, stride=stride,
                        padding=padding)

    def conv2d(self, x, w, b=None, stride=1, padding=0):
        return F.conv2d(self.q(x), self.q(w), b, stride=stride,
                        padding=padding)

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))


@contextlib.contextmanager
def exact_float32():
    """cuDNN and cuBLAS in float32, not TF32, while the context lasts."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
