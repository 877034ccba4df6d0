"""Precision of the reference's matrix products.

``exact`` is the stated f32 (TF32 is switched off on the card, so an f32
product is f32).  The comparison's controls compute the reference one step
below the configuration's precision: ``tf32`` rounds each operand to TF32's
10-bit mantissa (nearest, ties to even), as the tensor cores take f32
inputs; ``fp8`` scales each operand by its absolute maximum and rounds it
to float8 e4m3.  ``matmul`` rounds the operands in the forward and the
incoming gradient in the backward, so a trained control multiplies in the
lower precision both ways.
"""
from __future__ import annotations

import torch


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def tf32(x: torch.Tensor) -> torch.Tensor:
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    s = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


PRECISIONS = {"exact": exact, "bf16": bf16, "tf32": tf32, "fp8": fp8}


class _Round(torch.autograd.Function):
    """``rnd(x)`` forward, the gradient passed on unchanged."""

    @staticmethod
    def forward(ctx, x, rnd):
        return rnd(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundGrad(torch.autograd.Function):
    """The identity forward, ``rnd`` of the gradient backward."""

    @staticmethod
    def forward(ctx, x, rnd):
        ctx.rnd = rnd
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.rnd(g), None


def matmul(a: torch.Tensor, b: torch.Tensor, rnd=exact) -> torch.Tensor:
    if rnd is exact:
        return a @ b
    return _RoundGrad.apply(_Round.apply(a, rnd) @ _Round.apply(b, rnd), rnd)


class tf32_off:
    """f32 products in full f32 on the card while the reference runs."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
