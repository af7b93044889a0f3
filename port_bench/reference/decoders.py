"""Frozen plain copy of implicit_depth_tpu_torch/models/decoders.py for the benchmark's
f32 reference; it imports nothing of the port. The ray head is the plain one (kernels_plain).

Cost-volume encoder, U-Net++ decoder and binary query head (torch).

Counterpart of implicit_depth_tpu/models/decoders.py (CVEncoder, DecoderPP
with or without its 1x1 output heads, ConvBlockELU, SkipDecoder with or
without its regression heads, BinaryMLPNetwork). Conv stacks are NCHW;
the query head works on the last axis. DecoderPP computes only the final
column's output per scale, the one the reference keeps.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference.blocks import (BasicBlock, DoubleBasicBlock, upsample2x_bilinear,
                                                    upsample2x_nearest)

Tensor = torch.Tensor

NUM_CH_DEC = (64, 64, 128, 256)


class CVEncoder(nn.Module):
    """Fuses the cost volume (planes as channels) with the image-encoder
    stages from the matching scale on."""

    def __init__(self, num_planes: int, img_channels: Sequence[int],
                 num_ch_outs: Sequence[int] = (64, 128, 256, 384)):
        super().__init__()
        self.num_ch_outs = tuple(num_ch_outs)
        cin = num_planes
        for i, ch in enumerate(self.num_ch_outs):
            self.add_module(f"ds_conv_{i}", BasicBlock(cin, ch, stride=1 if i == 0 else 2))
            self.add_module(f"conv_{i}_0", BasicBlock(ch + img_channels[i], ch))
            self.add_module(f"conv_{i}_1", BasicBlock(ch, ch))
            cin = ch

    def forward(self, cost_nchw: Tensor, img_feats: Sequence[Tensor]) -> list[Tensor]:
        x = cost_nchw
        outputs = []
        for i in range(len(self.num_ch_outs)):
            x = getattr(self, f"ds_conv_{i}")(x)
            x = torch.cat([x, img_feats[i].to(x.dtype)], dim=1)
            x = getattr(self, f"conv_{i}_1")(getattr(self, f"conv_{i}_0")(x))
            outputs.append(x)
        return outputs


class DecoderPP(nn.Module):
    """Dense-skip grid decoder. Input: 5 encoder features at strides 2..32
    with channels `enc_channels`; output {scale: (b, NUM_CH_DEC[s], h_s, w_s)}
    for scales 0..3. `head_channels` > 0 appends a 1x1 conv head
    `output_head_{s}` per scale (the depth decoder: one log-depth channel),
    and the output takes its width."""

    def __init__(self, enc_channels: Sequence[int], head_channels: int = 0):
        super().__init__()
        self.head_channels = head_channels
        prev = list(enc_channels)
        for j in range(1, 5):
            max_i = 4 - j
            for i in range(max_i, -1, -1):
                ch = NUM_CH_DEC[i]
                self.add_module(f"right_conv_{i}{j - 1}", BasicBlock(prev[i], ch))
                self.add_module(f"diag_conv_{i + 1}{j - 1}", BasicBlock(prev[i + 1], ch))
                n_parts = 2
                if i + j != 4:
                    self.add_module(f"up_conv_{i + 1}{j}", BasicBlock(NUM_CH_DEC[i + 1], ch))
                    n_parts = 3
                self.add_module(f"in_conv_{i}{j}", DoubleBasicBlock(n_parts * ch, ch))
                if i + j == 4 and i != 0:
                    self.add_module(f"output_{i}", BasicBlock(ch, ch))
                if i + j == 4 and head_channels:
                    self.add_module(f"output_head_{i}", nn.Conv2d(ch, head_channels, 1))
            prev = list(NUM_CH_DEC[: max_i + 1]) + prev[max_i + 1:]

    def forward(self, enc_feats: Sequence[Tensor]) -> dict:
        prev = list(enc_feats)
        outputs: dict = {}
        for j in range(1, 5):
            col = []
            max_i = 4 - j
            for i in range(max_i, -1, -1):
                parts = [getattr(self, f"right_conv_{i}{j - 1}")(prev[i]),
                         upsample2x_bilinear(getattr(self, f"diag_conv_{i + 1}{j - 1}")(prev[i + 1]))]
                if i + j != 4:
                    parts.append(upsample2x_bilinear(getattr(self, f"up_conv_{i + 1}{j}")(col[-1])))
                out = getattr(self, f"in_conv_{i}{j}")(torch.cat(parts, dim=1))
                col.append(out)
                if i + j == 4:
                    head = out if i == 0 else getattr(self, f"output_{i}")(out)
                    if self.head_channels:
                        head = getattr(self, f"output_head_{i}")(head)
                    outputs[i] = head
            prev = col[::-1] + prev[max_i + 1:]
        return outputs


class ConvBlockELU(nn.Module):
    """Two 3x3 convs (conv1, conv2, with biases), each followed by ELU."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x: Tensor) -> Tensor:
        return F.elu(self.conv2(F.elu(self.conv1(x))))


class SkipDecoder(nn.Module):
    """Upsample-and-concatenate decoder over 5 encoder features with channels
    `enc_channels`. Block n = 1..4 is `block{n}_pre` (ConvBlockELU to
    (256, 128, 64, 64)[n-1] channels), an exact 2x nearest upsample, the
    concatenation with enc_feats[-(n+1)] and `block{n}_post`; its output is
    the features of scale 4 - n, whose widths are NUM_CH_DEC. With
    regression_heads each scale also gets `log_depth_{s}` from 1x1 convs
    `out{n}_{0,1,2}` (128, ELU, 128, ELU, 1)."""

    OUT_CH = (256, 128, 64, 64)

    def __init__(self, enc_channels: Sequence[int], regression_heads: bool = False):
        super().__init__()
        self.regression_heads = regression_heads
        cin = enc_channels[-1]
        for bi, ch in enumerate(self.OUT_CH):
            n = bi + 1
            self.add_module(f"block{n}_pre", ConvBlockELU(cin, ch))
            self.add_module(f"block{n}_post", ConvBlockELU(ch + enc_channels[-(bi + 2)], ch))
            if regression_heads:
                self.add_module(f"out{n}_0", nn.Conv2d(ch, 128, 1))
                self.add_module(f"out{n}_1", nn.Conv2d(128, 128, 1))
                self.add_module(f"out{n}_2", nn.Conv2d(128, 1, 1))
            cin = ch

    def forward(self, enc_feats: Sequence[Tensor]) -> dict:
        x = enc_feats[-1]
        outputs: dict = {}
        for bi in range(len(self.OUT_CH)):
            n = bi + 1
            x = upsample2x_nearest(getattr(self, f"block{n}_pre")(x))
            x = torch.cat([x, enc_feats[-(bi + 2)].to(x.dtype)], dim=1)
            x = getattr(self, f"block{n}_post")(x)
            scale = 3 - bi
            outputs[scale] = x
            if self.regression_heads:
                h = F.elu(getattr(self, f"out{n}_0")(x))
                h = F.elu(getattr(self, f"out{n}_1")(h))
                outputs[f"log_depth_{scale}"] = getattr(self, f"out{n}_2")(h)
        return outputs


class BinaryMLPNetwork(nn.Module):
    """Per-scale query MLPs: Linear -> ELU -> Linear -> ELU -> Linear(1).
    in_channels[s] is the scale's feature width plus the query depth."""

    def __init__(self, in_channels: Sequence[int], mlp_size: int = 128):
        super().__init__()
        self.num_scales = len(in_channels)
        for s, cin in enumerate(in_channels):
            self.add_module(f"s{s}_fc0", nn.Linear(cin, mlp_size))
            self.add_module(f"s{s}_fc1", nn.Linear(mlp_size, mlp_size))
            self.add_module(f"s{s}_fc2", nn.Linear(mlp_size, 1))

    def forward(self, inputs: Sequence[Tensor], max_scale_only: bool = False) -> dict:
        outputs = {}
        for s in ([0] if max_scale_only else range(len(inputs))):
            x = F.elu(getattr(self, f"s{s}_fc0")(inputs[s]))
            x = F.elu(getattr(self, f"s{s}_fc1")(x))
            outputs[f"pred_{s}"] = getattr(self, f"s{s}_fc2")(x)
        return outputs

    def factored(self, feats: Sequence[Tensor], depths: Sequence[Tensor],
                 priors: Optional[Sequence[Tensor]] = None) -> dict:
        """The same map as forward on concat([depth, feat, prior]) inputs,
        with fc0 distributed over the concat: the feature term
        fp = feat @ W0[1:1+c] + b0 is computed once per ray in the features'
        dtype, and the per-sample chain elu(fp + d k0d [+ p k0p]) -> fc1 ->
        elu -> fc2 runs as ops/ray_head.py::ray_head_mlp (kernels on CUDA
        tensors, the plain version on CPU tensors). fc0 row 0 is the depth
        row and row 1+c the prior row. feats[s] (b, N_s, c_s), depths[s] and
        priors[s] (b, N_s, S). Returns {"pred_s": (b, N_s, S)} in the
        features' dtype."""
        from port_bench.reference.kernels_plain import ray_head as ray_head_mlp

        outputs = {}
        for s in range(len(feats)):
            fc0, fc1, fc2 = (getattr(self, f"s{s}_fc{i}") for i in range(3))
            feat = feats[s]
            dt = feat.dtype
            c = feat.shape[-1]
            k0 = fc0.weight.t()  # (1 + c [+ 1], 128), (in, out)
            fp = feat @ k0[1: 1 + c].to(dt) + fc0.bias.to(dt)
            outputs[f"pred_{s}"] = ray_head_mlp(
                fp.contiguous(), depths[s].to(dt).contiguous(),
                None if priors is None else priors[s].to(dt).contiguous(),
                k0[0].float().contiguous(),
                None if priors is None else k0[1 + c].float().contiguous(),
                fc1.weight.t().float().contiguous(), fc1.bias.float(),
                fc2.weight.t().float().contiguous(), fc2.bias.float())
        return outputs
