"""Port parity: models/decoders.py (CVEncoder, DecoderPP, BinaryMLPNetwork)
against the JAX package, seeded parameters crossing the weight bridge.

Tolerance: 1e-4 of the largest reference value (f32 convs and dense layers
summed in another order).
"""

import jax
import numpy as np
import pytest
import torch

from implicit_depth_tpu.models import decoders as jdec
from implicit_depth_tpu_torch.models import decoders
from tests.torch_parity import assert_close, bridged, nchw, nhwc, seeded_variables, t

REL = 1e-4
ENC_CH = (24, 48, 64, 160, 256)  # EfficientNetV2-S taps


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_cv_encoder():
    num_planes, h, w = 8, 16, 24
    cost = _x((1, h, w, num_planes), 0)
    img = [_x((1, h >> i, w >> i, ch), i + 1) for i, ch in enumerate(ENC_CH[1:])]
    jm = jdec.CVEncoder()
    v = seeded_variables(jm.init, cost, img, seed=1)
    tm = bridged(decoders.CVEncoder(num_planes, ENC_CH[1:]), v)
    with torch.no_grad():
        got = tm(nchw(cost), [nchw(x) for x in img])
    for g, r in zip(got, jax.jit(jm.apply)(v, cost, img), strict=True):
        assert_close(nhwc(g), r, REL)


@pytest.mark.parametrize("enc_ch", [(24, 64, 128, 256, 384), (16, 64, 128, 256, 384)])
def test_decoder_pp(enc_ch):
    h, w = 32, 48
    feats = [_x((1, h >> i, w >> i, ch), 10 + i) for i, ch in enumerate(enc_ch)]
    jm = jdec.DecoderPP(head_channels=0)
    v = seeded_variables(jm.init, feats, seed=2)
    tm = bridged(decoders.DecoderPP(enc_ch), v)
    with torch.no_grad():
        got = tm([nchw(x) for x in feats])
    ref = jax.jit(jm.apply)(v, feats)
    assert sorted(got) == sorted(ref) == [0, 1, 2, 3]
    for s in range(4):
        assert got[s].shape[1] == decoders.NUM_CH_DEC[s]
        assert_close(nhwc(got[s]), ref[s], REL)


@pytest.mark.parametrize("max_scale_only", [True, False])
def test_binary_mlp_network(max_scale_only):
    inputs = [_x((2, 6, 5, ch + 1), 20 + s) for s, ch in enumerate(decoders.NUM_CH_DEC)]
    jm = jdec.BinaryMLPNetwork()
    v = seeded_variables(jm.init, inputs, seed=3)  # all four scales
    tm = bridged(decoders.BinaryMLPNetwork([ch + 1 for ch in decoders.NUM_CH_DEC]), v)
    with torch.no_grad():
        got = tm([t(x) for x in inputs], max_scale_only=max_scale_only)
    ref = jm.apply(v, inputs, max_scale_only=max_scale_only)
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert_close(got[key], ref[key], REL)
