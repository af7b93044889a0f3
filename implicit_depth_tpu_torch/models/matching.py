"""Matching feature encoder (torch, NCHW).

Counterpart of implicit_depth_tpu/models/matching.py::ResnetMatchingEncoder:
antialiased ResNet18 stem -> 16-dim features at 1/4 resolution,
  conv7x7/2 (64) -> BN -> ReLU -> [MaxPool(k2, s1, VALID) -> BlurPool(4, s2)]
  -> layer1 (2x BN BasicBlocks) -> 1x1 conv 128 -> InstanceNorm -> LeakyReLU(0.2)
  -> 3x3 conv 16 (replicate pad) -> InstanceNorm.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from implicit_depth_tpu_torch.models.blocks import instance_norm

Tensor = torch.Tensor


class BatchNorm(nn.Module):
    """Batch norm with flax `nn.BatchNorm(momentum=0.9)` semantics, following
    `self.training`. Eval: running statistics. Train: the batch mean and the
    biased batch variance, statistics and normalisation in f32 whatever the
    input dtype, and the running statistics move as 0.9 old + 0.1 batch,
    with the biased variance (torch.nn.BatchNorm2d would use the unbiased
    one). Parameters weight/bias, buffers running_mean/var."""

    MOMENTUM = 0.9

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: Tensor) -> Tensor:
        if self.training:
            x32 = x.float()
            var, mean = torch.var_mean(x32, dim=(0, 2, 3), unbiased=False)
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.mul_(m).add_((1.0 - m) * mean)
                self.running_var.mul_(m).add_((1.0 - m) * var)
            scale = self.weight.float() * torch.rsqrt(var + self.eps)
            y = (x32 - mean[:, None, None]) * scale[:, None, None] + self.bias.float()[:, None, None]
            return y.to(x.dtype)
        scale = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        shift = self.bias.float() - self.running_mean.float() * scale
        return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def blur_pool(x_nchw: Tensor, filt_size: int = 4, stride: int = 2) -> Tensor:
    """Anti-aliased downsampling: fixed binomial low-pass, depthwise,
    reflect padding (asymmetric for even filters), then stride."""
    taps = {3: [1.0, 2.0, 1.0], 4: [1.0, 3.0, 3.0, 1.0], 5: [1.0, 4.0, 6.0, 4.0, 1.0]}
    if filt_size not in taps:
        raise ValueError(filt_size)
    a = np.asarray(taps[filt_size])
    k2 = np.outer(a, a)
    k2 = k2 / k2.sum()
    c = x_nchw.shape[1]
    kernel = torch.as_tensor(k2, dtype=x_nchw.dtype, device=x_nchw.device)
    kernel = kernel[None, None].expand(c, 1, filt_size, filt_size)
    pad_l = (filt_size - 1) // 2
    pad_r = int(np.ceil((filt_size - 1) / 2))
    x = F.pad(x_nchw, (pad_l, pad_r, pad_l, pad_r), mode="reflect")
    return F.conv2d(x, kernel, stride=stride, groups=c)


class ResnetBlockBN(nn.Module):
    """torchvision-style BasicBlock: conv-BN-ReLU-conv-BN + shortcut."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, 3, stride, padding=1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, padding=1, bias=False)
        self.bn2 = BatchNorm(features)
        self.downsample_conv = None
        if cin != features or stride != 1:
            self.downsample_conv = nn.Conv2d(cin, features, 1, stride, bias=False)
            self.downsample_bn = BatchNorm(features)

    def forward(self, x: Tensor) -> Tensor:
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(identity))
        return F.relu(out + identity)


class ResnetMatchingEncoder(nn.Module):
    def __init__(self, num_ch_out: int = 16):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        self.layer1_0 = ResnetBlockBN(64, 64)
        self.layer1_1 = ResnetBlockBN(64, 64)
        self.head_conv1 = nn.Conv2d(64, 128, 1, bias=True)
        self.head_conv2 = nn.Conv2d(128, num_ch_out, 3, padding=0, bias=True)

    def forward(self, image_nchw: Tensor) -> Tensor:
        x = F.relu(self.bn1(self.conv1(image_nchw)))
        x = F.max_pool2d(x, 2, 1)
        x = blur_pool(x, 4, 2)
        x = self.layer1_1(self.layer1_0(x))
        x = F.leaky_relu(instance_norm(self.head_conv1(x)), 0.2)
        x = self.head_conv2(F.pad(x, (1, 1, 1, 1), mode="replicate"))
        return instance_norm(x)
