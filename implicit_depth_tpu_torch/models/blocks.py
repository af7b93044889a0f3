"""Shared network blocks (torch, NCHW inside the conv stacks).

Counterpart of implicit_depth_tpu/models/blocks.py:
- BasicBlock: norm-free residual block, bias convs, LeakyReLU(0.2);
- DoubleBasicBlock: BasicBlock x num_repeats;
- instance_norm: nn.InstanceNorm2d defaults, f32 statistics;
- bilinear x2 upsample, bilinear resize (antialiased when downsampling,
  like jax.image.resize), max pool with "same" padding.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

Tensor = torch.Tensor


def conv3x3(cin: int, cout: int, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride, padding=1, bias=bias)


def conv1x1(cin: int, cout: int, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, stride, padding=0, bias=bias)


class BasicBlock(nn.Module):
    """Norm-free residual block with LeakyReLU(0.2); a stride or a channel
    change takes a conv shortcut (3x3 when strided, else 1x1)."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv3x3(cin, features, stride, bias=True)
        self.conv2 = conv3x3(features, features, 1, bias=True)
        self.downsample = None
        if cin != features or stride != 1:
            ds = conv3x3 if stride != 1 else conv1x1
            self.downsample = ds(cin, features, stride, bias=True)

    def forward(self, x: Tensor) -> Tensor:
        out = self.conv2(F.leaky_relu(self.conv1(x), 0.2))
        identity = x if self.downsample is None else self.downsample(x)
        return F.leaky_relu(out + identity, 0.2)


class DoubleBasicBlock(nn.Module):
    """BasicBlock x num_repeats, named block0, block1, ..."""

    def __init__(self, cin: int, features: int, num_repeats: int = 2):
        super().__init__()
        self.num_repeats = num_repeats
        for i in range(num_repeats):
            self.add_module(f"block{i}", BasicBlock(cin if i == 0 else features, features))

    def forward(self, x: Tensor) -> Tensor:
        for i in range(self.num_repeats):
            x = getattr(self, f"block{i}")(x)
        return x


def instance_norm(x_nchw: Tensor, eps: float = 1e-5) -> Tensor:
    """Per-(sample, channel) normalisation over H, W; no affine, biased
    variance, statistics in f32."""
    x32 = x_nchw.float()
    mean = x32.mean(dim=(2, 3), keepdim=True)
    var = x32.var(dim=(2, 3), keepdim=True, unbiased=False)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x_nchw.dtype)


def upsample2x_bilinear(x_nchw: Tensor) -> Tensor:
    return F.interpolate(x_nchw, scale_factor=2, mode="bilinear", align_corners=False)


def resize_bilinear(x_nchw: Tensor, out_h: int, out_w: int) -> Tensor:
    """Bilinear resize; antialiased when downsampling, as jax.image.resize is."""
    return F.interpolate(x_nchw, size=(out_h, out_w), mode="bilinear",
                         align_corners=False, antialias=True)


def max_pool_same(x_nchw: Tensor, window: int, stride: int = 1) -> Tensor:
    """F.max_pool2d(window, stride, padding=window//2)."""
    return F.max_pool2d(x_nchw, window, stride, padding=window // 2)
