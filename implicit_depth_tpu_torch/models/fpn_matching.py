"""FPN matching encoder (torch, NCHW).

Counterpart of implicit_depth_tpu/models/fpn_matching.py: an MNASNet-100
backbone (timm mnasnet_100 features_only) and a feature pyramid over its 5
levels, whose 1/4-resolution level goes through a 3x3 conv, LeakyReLU(0.2),
a 1x1 projection to 16 channels and instance norm. Slower than the ResNet
matching encoder and, per the reference, more accurate.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from implicit_depth_tpu_torch.models.blocks import instance_norm, upsample2x_nearest
from implicit_depth_tpu_torch.models.matching import BatchNorm

Tensor = torch.Tensor


class DepthwiseSeparable(nn.Module):
    """Depthwise 3x3 -> BN -> ReLU -> pointwise 1x1 -> BN (no shortcut)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv_dw = nn.Conv2d(cin, cin, 3, padding=1, groups=cin, bias=False)
        self.bn1 = BatchNorm(cin)
        self.conv_pw = nn.Conv2d(cin, features, 1, bias=False)
        self.bn2 = BatchNorm(features)

    def forward(self, x: Tensor) -> Tensor:
        return self.bn2(self.conv_pw(F.relu(self.bn1(self.conv_dw(x)))))


class MnasInvertedResidual(nn.Module):
    """Expand 1x1 -> depthwise k x k (stride) -> project 1x1, BN after each,
    ReLU after the first two; a shortcut where the shape is kept."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 exp_ratio: int = 3):
        super().__init__()
        mid = cin * exp_ratio
        self.skip = cin == features and stride == 1
        self.conv_pw = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn1 = BatchNorm(mid)
        self.conv_dw = nn.Conv2d(mid, mid, kernel, stride, padding=kernel // 2, groups=mid,
                                 bias=False)
        self.bn2 = BatchNorm(mid)
        self.conv_pwl = nn.Conv2d(mid, features, 1, bias=False)
        self.bn3 = BatchNorm(features)

    def forward(self, x: Tensor) -> Tensor:
        h = F.relu(self.bn1(self.conv_pw(x)))
        h = F.relu(self.bn2(self.conv_dw(h)))
        h = self.bn3(self.conv_pwl(h))
        return h + x if self.skip else h


class MNASNet100(nn.Module):
    """features_only mnasnet_100: channels (16, 24, 40, 96, 320) at strides
    (2, 4, 8, 16, 32)."""

    num_ch_enc = (16, 24, 40, 96, 320)
    # per stage s1..s6: (blocks, (channels, kernel, first stride, expansion))
    STAGES = ((3, (24, 3, 2, 3)), (3, (40, 5, 2, 3)), (3, (80, 5, 2, 6)),
              (2, (96, 3, 1, 6)), (4, (192, 5, 2, 6)), (1, (320, 3, 1, 6)))
    TAPS = (1, 2, 4, 6)  # stages after which a feature map is taken (s0 is the first)

    def __init__(self):
        super().__init__()
        self.conv_stem = nn.Conv2d(3, 32, 3, 2, padding=1, bias=False)
        self.bn_stem = BatchNorm(32)
        self.s0_b0 = DepthwiseSeparable(32, 16)
        cin = 16
        for si, (n, (ch, k, s, e)) in enumerate(self.STAGES, start=1):
            for bi in range(n):
                self.add_module(f"s{si}_b{bi}",
                                MnasInvertedResidual(cin, ch, k, s if bi == 0 else 1, e))
                cin = ch

    def forward(self, image_nchw: Tensor) -> list[Tensor]:
        x = self.s0_b0(F.relu(self.bn_stem(self.conv_stem(image_nchw))))
        feats = [x]
        for si, (n, _) in enumerate(self.STAGES, start=1):
            for bi in range(n):
                x = getattr(self, f"s{si}_b{bi}")(x)
            if si in self.TAPS:
                feats.append(x)
        return feats


class FPNMatchingEncoder(nn.Module):
    """MNASNet + FPN -> num_ch_out matching features at 1/4 resolution.

    The pyramid is torchvision's: lateral 1x1 convs `lateral_{i}` on every
    level, a top-down path of exact 2x nearest upsamples and adds, and
    `output_1`, a 3x3 conv, on level 1, the only level read. Level 0's sum
    is not computed (nothing reads it), so `lateral_0` takes no part in the
    output; it stays a parameter, as in the JAX module. Each level must be
    exactly twice the size of the one above it, level 0 included (an image
    side of 32 n or 32 n - 1), or the JAX module's adds fail; here that is a
    ValueError, and nothing is padded."""

    def __init__(self, num_ch_out: int = 16, fpn_channels: int = 32):
        super().__init__()
        self.encoder = MNASNet100()
        for i, ch in enumerate(self.encoder.num_ch_enc):
            self.add_module(f"lateral_{i}", nn.Conv2d(ch, fpn_channels, 1))
        self.output_1 = nn.Conv2d(fpn_channels, fpn_channels, 3, padding=1)
        self.proj = nn.Conv2d(fpn_channels, num_ch_out, 1)

    def forward(self, image_nchw: Tensor) -> Tensor:
        feats = self.encoder(image_nchw)
        sizes = [tuple(f.shape[-2:]) for f in feats]
        if any(sizes[i] != (2 * sizes[i + 1][0], 2 * sizes[i + 1][1])
               for i in range(len(sizes) - 1)):
            raise ValueError(f"FPN levels {sizes} are not each twice the next: each image "
                             "side must be 32 n or 32 n - 1")
        x = self.lateral_4(feats[4])
        for i in (3, 2, 1):
            x = getattr(self, f"lateral_{i}")(feats[i]) + upsample2x_nearest(x)
        out = F.leaky_relu(self.output_1(x), 0.2)
        return instance_norm(self.proj(out))
