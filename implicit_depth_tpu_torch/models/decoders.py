"""Cost-volume encoder, U-Net++ decoder and binary query head (torch).

Counterpart of implicit_depth_tpu/models/decoders.py (CVEncoder, DecoderPP
with no output heads, BinaryMLPNetwork.__call__). Conv stacks are NCHW;
the query head works on the last axis. DecoderPP computes only the final
column's output per scale, the one the reference keeps.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from implicit_depth_tpu_torch.models.blocks import BasicBlock, DoubleBasicBlock, upsample2x_bilinear

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
    for scales 0..3."""

    def __init__(self, enc_channels: Sequence[int]):
        super().__init__()
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
                    outputs[i] = out if i == 0 else getattr(self, f"output_{i}")(out)
            prev = col[::-1] + prev[max_i + 1:]
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
