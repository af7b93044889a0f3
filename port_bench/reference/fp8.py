"""The correctness control: the reference computed in fp8 mixed
precision, the step below the configuration's bf16 that a later change
might take. The reference's forward runs under the program's bf16
autocast (`bf16_autocast`; the losses stay in f32, as the program
computes them), and within Fp8Products both operands of every convolution and matrix
product (F.conv2d, F.linear, torch.matmul and `@`) are rounded to
float8_e4m3fn with a per-tensor scale (the largest magnitude to e4m3's
largest value), and the gradient that reaches a product's output is
rounded to float8_e5m2 likewise, so that the backward's products take fp8
operands too. A comparison that passes this control cannot tell bf16 from
fp8."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _rounded(x, dtype, top: float):
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return (x.detach().float() * scale).to(dtype).float().div(scale).to(x.dtype)


class _GradToE5M2(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _rounded(g, torch.float8_e5m2, E5M2_MAX)


def round_fp8(x):
    """x rounded to e4m3 with a per-tensor scale; the gradient passes
    unchanged (straight through)."""
    if not isinstance(x, torch.Tensor) or not x.is_floating_point():
        return x
    return x + (_rounded(x, torch.float8_e4m3fn, E4M3_MAX) - x).detach()


_PRODUCTS = {F.conv2d: 2, F.linear: 2, torch.matmul: 2, torch.Tensor.__matmul__: 2,
             torch.Tensor.matmul: 2, torch.mm: 2, torch.bmm: 2}


class Fp8Products(TorchFunctionMode):
    """Within this mode, both operands of every product are rounded to fp8."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        n = _PRODUCTS.get(func)
        if not n:
            return func(*args, **kwargs)
        out = func(*(round_fp8(a) if i < n else a for i, a in enumerate(args)), **kwargs)
        return _GradToE5M2.apply(out) if out.requires_grad else out


def bf16_autocast(device: torch.device):
    """The program's mixed precision around a forward: bf16 autocast (the
    geometry, which the models keep out of autocast, stays f32)."""
    return lambda: torch.autocast(device.type, dtype=torch.bfloat16)
