"""The reference's arithmetic: exact float32 products, or the control's.

The control is the reference computed one precision below the stated one:
bfloat16 configurations are checked against the reference with every
product's operands rounded to float8 e4m3 (a scale for each tensor, its
largest magnitude onto e4m3's 448), as an fp8 matrix-multiply path would
feed them; attention's scores and probabilities are rounded the same way.
The rounding passes the gradient straight through. The benchmark's runs
never compute the control; a correct check has to fail it.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

E4M3_MAX = 448.0


def round_e4m3(x: Tensor) -> Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in x's
    dtype, with the identity's gradient."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = E4M3_MAX / amax
    q = (x.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q.to(x.dtype) - x.detach())


class Arith:
    """Products in float32; with ``lowp`` their operands rounded to e4m3."""

    def __init__(self, lowp: bool = False) -> None:
        self.lowp = lowp

    def round(self, x: Tensor) -> Tensor:
        return round_e4m3(x) if self.lowp else x

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        return self.round(a.float()) @ self.round(b.float())


class exact_f32:
    """Float32 products on the card without TF32, for the block's length."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False
