"""The port's EfficientNetV2-S (models/image_encoders.py) pinned against the
independently recorded timm `tf_efficientnetv2_s` architecture table of
tests/test_effnetv2s_arch_table.py, as that test pins the JAX package's
encoder and the torch twin: per stage, each block's kind, shortcut, conv
widths, kernels, strides and groups, the squeeze-excite width (from the
block's input channels), BN eps 1e-3 and no conv bias outside the SE; the
stem; and the features_only taps' channels and strides. The weight bridge
maps the flax tree onto these modules name for name
(tests/test_torch_encoders.py), so a misread block would show here first.
"""

import pytest
import torch
import torch.nn as nn

from implicit_depth_tpu_torch.models import image_encoders as enc
from tests.test_effnetv2s_arch_table import (PLAN, TIMM_BN_EPS, TIMM_FEATURE_CHANNELS,
                                             TIMM_FEATURE_REDUCTIONS, TIMM_STEM_SIZE)

KINDS = {"cn": enc.ConvBnAct, "er": enc.EdgeResidual, "ir": enc.InvertedResidual}


@pytest.fixture(scope="module")
def net():
    return enc.EfficientNetV2S()


def _conv(conv, cin, cout, k, stride, groups=1):
    assert (conv.in_channels, conv.out_channels, conv.kernel_size, conv.stride, conv.groups) == \
        (cin, cout, (k, k), (stride, stride), groups)


@pytest.mark.parametrize("si", range(len(PLAN)))
def test_stage_matches_arch_table(net, si):
    names = [n for s, n in net.blocks if s == si]
    assert len(names) == len(PLAN[si])
    for bi, (want, name) in enumerate(zip(PLAN[si], names)):
        assert name == f"s{si}_b{bi}"
        blk = getattr(net, name)
        assert type(blk) is KINDS[want["kind"]] and blk.skip == want["has_skip"], name
        cin, cout, mid, k, st = want["cin"], want["cout"], want["mid"], want["k"], want["stride"]
        if want["kind"] == "cn":
            _conv(blk.conv, cin, cout, k, st)
        elif want["kind"] == "er":
            _conv(blk.conv_exp, cin, mid, k, st)
            _conv(blk.conv_pwl, mid, cout, 1, 1)
        else:
            _conv(blk.conv_pw, cin, mid, 1, 1)
            _conv(blk.conv_dw, mid, mid, k, st, groups=mid)
            _conv(blk.se.conv_reduce, mid, want["se_rd"], 1, 1)
            _conv(blk.se.conv_expand, want["se_rd"], mid, 1, 1)
            _conv(blk.conv_pwl, mid, cout, 1, 1)
        for sub, mod in blk.named_modules():
            if isinstance(mod, nn.Conv2d):
                assert (mod.bias is not None) == sub.startswith("se."), f"{name}.{sub}"
            elif isinstance(mod, enc.BatchNorm):
                assert mod.eps == TIMM_BN_EPS, f"{name}.{sub}"


def test_stem_and_taps_match_arch_table(net):
    _conv(net.conv_stem, 3, TIMM_STEM_SIZE, 3, 2)
    assert net.conv_stem.bias is None and net.bn1.eps == TIMM_BN_EPS
    assert len(net.blocks) == sum(len(stage) for stage in PLAN)
    with torch.no_grad():
        feats = net.eval()(torch.zeros(1, 3, 64, 96))
    assert tuple(f.shape[1] for f in feats) == TIMM_FEATURE_CHANNELS
    assert tuple(64 // f.shape[2] for f in feats) == TIMM_FEATURE_REDUCTIONS
    assert enc.EfficientNetV2S.num_ch_enc == TIMM_FEATURE_CHANNELS
