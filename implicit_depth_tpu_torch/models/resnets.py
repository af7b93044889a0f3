"""Bottleneck ResNet family of the image-encoder zoo (torch, NCHW).

Counterpart of implicit_depth_tpu/models/resnets.py, the reference's
alternatives to EfficientNetV2-S:
- ResNeXt101_64x4d: grouped bottlenecks (groups 64, width 4);
- SEResNeXtAA101d_32x8d: squeeze-excite, anti-aliased downsampling (blur
  pool), a deep stem and average-pooled shortcuts (groups 32, width 8).
features_only: 5 feature maps at strides (2, 4, 8, 16, 32), channels
(stem, 256, 512, 1024, 2048) with a stem of 128 channels (deep stem) or 64.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from implicit_depth_tpu_torch.models.matching import BatchNorm, avg_down, blur_pool

Tensor = torch.Tensor


class SqueezeExciteR(nn.Module):
    """ResNet-style squeeze-excite: the reduction is on the block's output
    channels; 1x1 convs fc1, fc2 with biases."""

    def __init__(self, channels: int, rd_channels: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, rd_channels, 1)
        self.fc2 = nn.Conv2d(rd_channels, channels, 1)

    def forward(self, x: Tensor) -> Tensor:
        s = F.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True)))
        return x * torch.sigmoid(self.fc2(s))


class Bottleneck(nn.Module):
    """1x1 -> grouped 3x3 -> 1x1 to planes * 4 channels, each with BN; with
    antialias a strided 3x3 runs at stride 1 and blur_pool(stride) follows
    it; with avg_down a strided shortcut is avg_down, then the 1x1 conv."""

    def __init__(self, cin: int, planes: int, stride: int = 1, groups: int = 1,
                 base_width: int = 64, use_se: bool = False, antialias: bool = False,
                 avg_down: bool = False):
        super().__init__()
        out_ch = planes * 4
        width = int(planes * (base_width / 64.0)) * groups
        self.stride = stride
        self.blur = antialias and stride > 1
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = BatchNorm(width)
        self.conv2 = nn.Conv2d(width, width, 3, 1 if self.blur else stride, padding=1,
                               groups=groups, bias=False)
        self.bn2 = BatchNorm(width)
        self.conv3 = nn.Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = BatchNorm(out_ch)
        self.se = SqueezeExciteR(out_ch, max(1, out_ch // 16)) if use_se else None
        self.downsample_conv = None
        self.pool_first = avg_down and stride != 1
        if cin != out_ch or stride != 1:
            self.downsample_conv = nn.Conv2d(cin, out_ch, 1, 1 if self.pool_first else stride,
                                             bias=False)
            self.downsample_bn = BatchNorm(out_ch)

    def forward(self, x: Tensor) -> Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        if self.blur:
            h = blur_pool(h, stride=self.stride)
        h = self.bn3(self.conv3(h))
        if self.se is not None:
            h = self.se(h)
        identity = x
        if self.downsample_conv is not None:
            if self.pool_first:
                identity = avg_down(identity)
            identity = self.downsample_bn(self.downsample_conv(identity))
        return F.relu(h + identity)


class ResNetBottleneckEncoder(nn.Module):
    """features_only bottleneck ResNet; layers (3, 4, 23, 3) is the 101.
    The deep stem is three 3x3 convs (64, 64, 128), the plain one a 7x7/2
    conv (64); the stem's activation is the first tap. Then a 3x3/2 max pool,
    or with antialias a 2x2 max pool at stride 1 (VALID) and blur_pool(2)."""

    PLANES = (64, 128, 256, 512)
    DEEP_STEM = (64, 64, 128)

    def __init__(self, layers: Sequence[int] = (3, 4, 23, 3), groups: int = 1,
                 base_width: int = 64, use_se: bool = False, antialias: bool = False,
                 deep_stem: bool = False, avg_down: bool = False):
        super().__init__()
        self.layers = tuple(layers)
        self.deep_stem = deep_stem
        self.antialias = antialias
        if deep_stem:
            cin = 3
            for i, ch in enumerate(self.DEEP_STEM):
                self.add_module(f"stem_conv{i}", nn.Conv2d(cin, ch, 3, 2 if i == 0 else 1,
                                                           padding=1, bias=False))
                self.add_module(f"stem_bn{i}", BatchNorm(ch))
                cin = ch
        else:
            self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
            self.bn1 = BatchNorm(64)
            cin = 64
        for li, (p, n) in enumerate(zip(self.PLANES, self.layers)):
            for bi in range(n):
                self.add_module(f"layer{li + 1}_{bi}", Bottleneck(
                    cin, p, stride=2 if (bi == 0 and li > 0) else 1, groups=groups,
                    base_width=base_width, use_se=use_se, antialias=antialias,
                    avg_down=avg_down))
                cin = p * 4

    @property
    def num_ch_enc(self) -> tuple:
        return (self.DEEP_STEM[-1] if self.deep_stem else 64, 256, 512, 1024, 2048)

    def forward(self, image_nchw: Tensor) -> list[Tensor]:
        x = image_nchw
        if self.deep_stem:
            for i in range(len(self.DEEP_STEM)):
                x = F.relu(getattr(self, f"stem_bn{i}")(getattr(self, f"stem_conv{i}")(x)))
        else:
            x = F.relu(self.bn1(self.conv1(x)))
        feats = [x]
        if self.antialias:
            x = blur_pool(F.max_pool2d(x, 2, 1), stride=2)
        else:
            x = F.max_pool2d(x, 3, 2, padding=1)
        for li, n in enumerate(self.layers):
            for bi in range(n):
                x = getattr(self, f"layer{li + 1}_{bi}")(x)
            feats.append(x)
        return feats


def ResNeXt101_64x4d() -> ResNetBottleneckEncoder:
    return ResNetBottleneckEncoder(layers=(3, 4, 23, 3), groups=64, base_width=4)


def SEResNeXtAA101d_32x8d() -> ResNetBottleneckEncoder:
    return ResNetBottleneckEncoder(layers=(3, 4, 23, 3), groups=32, base_width=8, use_se=True,
                                   antialias=True, deep_stem=True, avg_down=True)
