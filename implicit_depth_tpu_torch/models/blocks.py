"""Shared network blocks (torch; the conv stacks' tensors are NCHW-shaped,
channels_last in memory at half precision).

Counterpart of implicit_depth_tpu/models/blocks.py:
- conv_memory_format, stack_input: the stacks' layout at a compute dtype,
  and a stack's input in it (counted in CONV_LAYOUT);
- memory_format_of, replicate_pad: a tensor's layout, and replicate
  padding that keeps channels_last;
- BasicBlock: norm-free residual block, bias convs, LeakyReLU(0.2)
  (leaky_relu02);
- DoubleBasicBlock: BasicBlock x num_repeats;
- MLP: Linear layers with LeakyReLU(0.01) between them, on the last axis;
- instance_norm: nn.InstanceNorm2d defaults, f32 statistics;
- bilinear and nearest x2 upsamples, bilinear resize (antialiased when
  downsampling, like jax.image.resize), max pool with "same" padding,
  sigmoid_custom.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from implicit_depth_tpu_torch.utils.profiling import CONV_LAYOUT

Tensor = torch.Tensor


def conv_memory_format(dtype: torch.dtype) -> torch.memory_format:
    """The memory format of the conv stacks at compute dtype `dtype`:
    channels_last at half precision, the layout of cuDNN's tensor-core
    convs, which transposes an NCHW tensor around each conv. At f32 the
    tensors keep the layouts torch gives them: the arithmetic on which
    the CPU tests' per-parameter gradient bounds against the JAX package
    were set (oneDNN's channels_last f32 sums round otherwise)."""
    return torch.channels_last if dtype in (torch.bfloat16, torch.float16) else torch.preserve_format


def stack_input(x_nchw: Tensor, dtype: torch.dtype) -> Tensor:
    """A conv stack's input in `dtype` and the stacks' memory format
    (conv_memory_format): the one place a stack's input changes layout.
    At half precision CONV_LAYOUT counts the inputs that came
    channels_last and those this call copies into it (one kernel, with
    the cast)."""
    fmt = conv_memory_format(dtype)
    if fmt == torch.channels_last:
        cl = x_nchw.is_contiguous(memory_format=fmt)
        CONV_LAYOUT["channels_last" if cl else "converted"] += 1
    return x_nchw.to(dtype, memory_format=fmt)


def memory_format_of(x_nchw: Tensor) -> torch.memory_format:
    """channels_last for a tensor laid out so (and not also contiguous),
    else contiguous_format."""
    cl = x_nchw.is_contiguous(memory_format=torch.channels_last) and not x_nchw.is_contiguous()
    return torch.channels_last if cl else torch.contiguous_format


def replicate_pad(x_nchw: Tensor, pad: int) -> Tensor:
    """F.pad(x, (pad,) * 4, mode="replicate") that keeps channels_last on
    every device (CUDA's 2-D replicate pad writes NCHW): a channels_last
    input is padded on its NHWC view as a 3-D pad with none on C."""
    if memory_format_of(x_nchw) != torch.channels_last:
        return F.pad(x_nchw, (pad,) * 4, mode="replicate")
    x_nhwc = x_nchw.permute(0, 2, 3, 1)
    return F.pad(x_nhwc, (0, 0) + (pad,) * 4, mode="replicate").permute(0, 3, 1, 2)


def leaky_relu02(x: Tensor) -> Tensor:
    return F.leaky_relu(x, 0.2)


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
        out = self.conv2(leaky_relu02(self.conv1(x)))
        identity = x if self.downsample is None else self.downsample(x)
        return leaky_relu02(out + identity)


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


class MLP(nn.Module):
    """Linear layers `fc{i}` to the widths of channel_list, LeakyReLU(0.01)
    after each, the last one's left out with disable_final_activation."""

    def __init__(self, in_channels: int, channel_list, disable_final_activation: bool = False):
        super().__init__()
        self.num_layers = len(channel_list)
        self.disable_final_activation = disable_final_activation
        cin = in_channels
        for i, ch in enumerate(channel_list):
            self.add_module(f"fc{i}", nn.Linear(cin, ch))
            cin = ch

    def forward(self, x: Tensor) -> Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
            if i < self.num_layers - 1 or not self.disable_final_activation:
                x = F.leaky_relu(x, 0.01)
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


def upsample2x_nearest(x_nchw: Tensor) -> Tensor:
    """Output pixel i takes input pixel i // 2: what jax.image.resize's
    "nearest" gives at an exact factor of 2."""
    return F.interpolate(x_nchw, scale_factor=2, mode="nearest")


def resize_bilinear(x_nchw: Tensor, out_h: int, out_w: int) -> Tensor:
    """Bilinear resize; antialiased when downsampling, as jax.image.resize is."""
    return F.interpolate(x_nchw, size=(out_h, out_w), mode="bilinear",
                         align_corners=False, antialias=True)


def max_pool_same(x_nchw: Tensor, window: int, stride: int = 1) -> Tensor:
    """F.max_pool2d(window, stride, padding=window//2)."""
    return F.max_pool2d(x_nchw, window, stride, padding=window // 2)


def sigmoid_custom(x: Tensor, multiplier: float = 1.0) -> Tensor:
    return torch.sigmoid(multiplier * x)
