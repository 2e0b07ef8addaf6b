"""Operand rounding of the reference's products.

``"f32"`` computes every product in float32 with TF32 off.  The lower
precisions are the controls of the output check: the reference with each
operand of every product (convolutions, projections, attention) rounded to
that format and the sums taken in float32, as the tensor cores take them.

* ``"tf32"``: 10 explicit mantissa bits, round to nearest even;
* ``"fp8"``: float8 e4m3 under one scale per operand (its largest
  magnitude to 448), the usual per-tensor scaling.
"""

from __future__ import annotations

import contextlib

import torch

MODES = ("f32", "tf32", "fp8")
_E4M3_MAX = 448.0


def _tf32(t: torch.Tensor) -> torch.Tensor:
    bits = t.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    t = t.float()
    amax = t.abs().amax()
    scale = torch.where(amax > 0, amax / _E4M3_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def rounder(mode: str):
    """The operand rounding of ``mode``: a function tensor -> float32 tensor."""
    if mode == "f32":
        return lambda t: t.float()
    if mode == "tf32":
        return _tf32
    if mode == "fp8":
        return _fp8
    raise ValueError(f"unknown precision {mode!r}; one of {MODES}")


@contextlib.contextmanager
def exact_f32():
    """TF32 off for matmuls and cuDNN while the reference runs, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
