"""Frozen plain copy of implicit_depth_tpu_torch/models/image_encoders.py for the benchmark's
f32 reference; it imports nothing of the port. Unchanged.

Image prior encoders (features_only pyramids, torch, NCHW).

Counterpart of implicit_depth_tpu/models/image_encoders.py.
EfficientNetV2S mirrors timm `tf_efficientnetv2_s_in21ft1k` features_only:
TF SAME padding (asymmetric on the stride-2 convs), BN eps 1e-3, SiLU,

    stem conv3x3/2 24
    s0: ConvBnAct      r2  k3 s1 e1 c24  (skip)
    s1: EdgeResidual   r4  k3 s2 e4 c48
    s2: EdgeResidual   r4  k3 s2 e4 c64
    s3: InvertedResid. r6  k3 s2 e4 c128 se0.25
    s4: InvertedResid. r9  k3 s1 e6 c160 se0.25
    s5: InvertedResid. r15 k3 s2 e6 c256 se0.25

with feature taps after s0, s1, s2, s4, s5 -> channels (24, 48, 64, 160,
256) at strides (2, 4, 8, 16, 32). ResNet18D mirrors timm `resnet18d`
features_only: a deep 3x3 stem (32, 32, 64), a 3x3/2 max pool, BasicBlock
layers whose strided shortcuts average-pool first; channels (64, 64, 128,
256, 512). TinyEncoder is a small 5-level pyramid for tests.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference.matching import BatchNorm, ResnetBlockBN

Tensor = torch.Tensor


def pad_same(x: Tensor, k: int, s: int) -> Tensor:
    """TF SAME padding: the extra pixel of an odd total goes after."""
    ih, iw = x.shape[-2:]
    ph = max((-(-ih // s) - 1) * s + k - ih, 0)
    pw = max((-(-iw // s) - 1) * s + k - iw, 0)
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))


class Conv2dSame(nn.Conv2d):
    """Conv2d with TF SAME padding (no bias unless asked)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
                 bias: bool = False):
        super().__init__(cin, cout, k, stride, padding=0, groups=groups, bias=bias)

    def forward(self, x: Tensor) -> Tensor:
        return super().forward(pad_same(x, self.kernel_size[0], self.stride[0]))


def BatchNormTF(num_features: int) -> BatchNorm:
    """BN with the TF-EfficientNet eps (1e-3)."""
    return BatchNorm(num_features, eps=1e-3)


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, rd_channels: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(channels, rd_channels, 1)
        self.conv_expand = nn.Conv2d(rd_channels, channels, 1)

    def forward(self, x: Tensor) -> Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.conv_expand(F.silu(self.conv_reduce(s)))
        return x * torch.sigmoid(s)


class ConvBnAct(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.skip = cin == features and stride == 1
        self.conv = Conv2dSame(cin, features, 3, stride)
        self.bn1 = BatchNormTF(features)

    def forward(self, x: Tensor) -> Tensor:
        out = F.silu(self.bn1(self.conv(x)))
        return out + x if self.skip else out


class EdgeResidual(nn.Module):
    """Fused-MBConv: expand 3x3 conv + project 1x1."""

    def __init__(self, cin: int, features: int, exp_ratio: int = 4, stride: int = 1):
        super().__init__()
        mid = cin * exp_ratio
        self.skip = cin == features and stride == 1
        self.conv_exp = Conv2dSame(cin, mid, 3, stride)
        self.bn1 = BatchNormTF(mid)
        self.conv_pwl = nn.Conv2d(mid, features, 1, bias=False)
        self.bn2 = BatchNormTF(features)

    def forward(self, x: Tensor) -> Tensor:
        out = F.silu(self.bn1(self.conv_exp(x)))
        out = self.bn2(self.conv_pwl(out))
        return out + x if self.skip else out


class InvertedResidual(nn.Module):
    """MBConv with SE; the SE width comes from the block's input channels."""

    def __init__(self, cin: int, features: int, exp_ratio: int = 4, stride: int = 1,
                 se_ratio: float = 0.25):
        super().__init__()
        mid = cin * exp_ratio
        self.skip = cin == features and stride == 1
        self.conv_pw = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn1 = BatchNormTF(mid)
        self.conv_dw = Conv2dSame(mid, mid, 3, stride, groups=mid)
        self.bn2 = BatchNormTF(mid)
        self.se = SqueezeExcite(mid, max(1, int(cin * se_ratio)))
        self.conv_pwl = nn.Conv2d(mid, features, 1, bias=False)
        self.bn3 = BatchNormTF(features)

    def forward(self, x: Tensor) -> Tensor:
        out = F.silu(self.bn1(self.conv_pw(x)))
        out = F.silu(self.bn2(self.conv_dw(out)))
        out = self.bn3(self.conv_pwl(self.se(out)))
        return out + x if self.skip else out


class EfficientNetV2S(nn.Module):
    """features_only EfficientNetV2-S. Returns 5 feature maps."""

    num_ch_enc = (24, 48, 64, 160, 256)
    # (stage, block type, repeats, out channels, first stride, expansion)
    STAGES = (
        (0, ConvBnAct, 2, 24, 1, None),
        (1, EdgeResidual, 4, 48, 2, 4),
        (2, EdgeResidual, 4, 64, 2, 4),
        (3, InvertedResidual, 6, 128, 2, 4),
        (4, InvertedResidual, 9, 160, 1, 6),
        (5, InvertedResidual, 15, 256, 2, 6),
    )
    TAPS = (0, 1, 2, 4, 5)

    def __init__(self):
        super().__init__()
        self.conv_stem = Conv2dSame(3, 24, 3, 2)
        self.bn1 = BatchNormTF(24)
        cin = 24
        self.blocks = []
        for s, cls, reps, cout, stride, exp in self.STAGES:
            for i in range(reps):
                st = stride if i == 0 else 1
                blk = cls(cin, cout, st) if exp is None else cls(cin, cout, exp, st)
                self.add_module(f"s{s}_b{i}", blk)
                self.blocks.append((s, f"s{s}_b{i}"))
                cin = cout

    def forward(self, image_nchw: Tensor) -> list[Tensor]:
        x = F.silu(self.bn1(self.conv_stem(image_nchw)))
        feats = []
        for i, (s, name) in enumerate(self.blocks):
            x = getattr(self, name)(x)
            last_of_stage = i + 1 == len(self.blocks) or self.blocks[i + 1][0] != s
            if last_of_stage and s in self.TAPS:
                feats.append(x)
        return feats


class TinyEncoder(nn.Module):
    """Small 5-level pyramid for tests (no reference counterpart)."""

    num_ch_enc = (16, 24, 32, 48, 64)

    def __init__(self):
        super().__init__()
        cin = 3
        for i, ch in enumerate(self.num_ch_enc):
            self.add_module(f"conv{i}", nn.Conv2d(cin, ch, 3, 2, padding=1))
            cin = ch

    def forward(self, image_nchw: Tensor) -> list[Tensor]:
        feats = []
        x = image_nchw
        for i in range(len(self.num_ch_enc)):
            x = F.leaky_relu(getattr(self, f"conv{i}")(x), 0.2)
            feats.append(x)
        return feats


class ResNet18D(nn.Module):
    """features_only resnet18d: 5 feature maps at strides (2, 4, 8, 16, 32)."""

    num_ch_enc = (64, 64, 128, 256, 512)
    STEM = (32, 32, 64)
    LAYERS = ((64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2))  # (channels, blocks, stride)

    def __init__(self):
        super().__init__()
        cin = 3
        for i, ch in enumerate(self.STEM):
            self.add_module(f"stem_conv{i}", nn.Conv2d(cin, ch, 3, 2 if i == 0 else 1, padding=1,
                                                       bias=False))
            self.add_module(f"stem_bn{i}", BatchNorm(ch))
            cin = ch
        for li, (ch, n, stride) in enumerate(self.LAYERS):
            for bi in range(n):
                self.add_module(f"layer{li + 1}_{bi}", ResnetBlockBN(
                    cin, ch, stride if bi == 0 else 1, avg_down=True))
                cin = ch

    def forward(self, image_nchw: Tensor) -> list[Tensor]:
        x = image_nchw
        for i in range(len(self.STEM)):
            x = F.relu(getattr(self, f"stem_bn{i}")(getattr(self, f"stem_conv{i}")(x)))
        feats = [x]
        x = F.max_pool2d(x, 3, 2, padding=1)
        for li, (_, n, _) in enumerate(self.LAYERS):
            for bi in range(n):
                x = getattr(self, f"layer{li + 1}_{bi}")(x)
            feats.append(x)
        return feats
