"""Port parity: models/blocks.py, models/matching.py and
models/image_encoders.py against the JAX package, with seeded parameters and
BN statistics in the flax modules' variable trees, crossing through the
weight bridge.

Tolerance: 1e-4 of the largest reference value per output (f32 convs summed
in another order, through up to ~40 layers for EfficientNetV2-S). One input
has odd spatial dims, which exercises the asymmetric TF SAME padding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_depth_tpu.models import blocks as jblocks
from implicit_depth_tpu.models import image_encoders as jenc
from implicit_depth_tpu.models import matching as jmatch
from implicit_depth_tpu_torch.models import blocks, image_encoders, matching
from tests.torch_parity import assert_close, bridged, nchw, nhwc, seeded_variables

REL = 1e-4


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("cin,features,stride", [(8, 8, 1), (8, 12, 1), (8, 12, 2)])
def test_basic_block(cin, features, stride):
    x = _x((2, 10, 14, cin))
    jm = jblocks.BasicBlock(features, stride)
    v = seeded_variables(jm.init, x)
    tm = bridged(blocks.BasicBlock(cin, features, stride), v)
    with torch.no_grad():
        assert_close(nhwc(tm(nchw(x))), jax.jit(jm.apply)(v, x), REL)


def test_leaky_relu02_matches_flax():
    """Elementwise, with zeros, both signs, large magnitudes and infinities."""
    import flax.linen as fnn

    x = np.concatenate([_x((1000,), seed=3) * 10.0,
                        np.float32([0.0, -0.0, 1e-30, -1e-30, 3e38, -3e38, np.inf, -np.inf])])
    got = blocks.leaky_relu02(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(fnn.leaky_relu(jnp.asarray(x), 0.2)))


def test_double_basic_block():
    x = _x((1, 8, 12, 6))
    jm = jblocks.DoubleBasicBlock(10)
    v = seeded_variables(jm.init, x)
    tm = bridged(blocks.DoubleBasicBlock(6, 10), v)
    with torch.no_grad():
        assert_close(nhwc(tm(nchw(x))), jax.jit(jm.apply)(v, x), REL)


def test_instance_norm_upsample_maxpool():
    x = _x((2, 9, 11, 4)) * 3 + 1
    assert_close(nhwc(blocks.instance_norm(nchw(x))), jblocks.instance_norm(x), 1e-5)
    assert_close(nhwc(blocks.upsample2x_bilinear(nchw(x))), jblocks.upsample2x_bilinear(x), 1e-6)
    for window in (3, 7):
        assert_close(nhwc(blocks.max_pool_same(nchw(x), window)),
                     jblocks.max_pool_same(x, window), 0.0)


@pytest.mark.parametrize("out_hw", [(5, 6), (18, 22), (9, 11)])
def test_resize_bilinear(out_hw):
    """jax.image.resize antialiases when downsampling; so must the port."""
    x = _x((2, 9, 11, 3))
    assert_close(nhwc(blocks.resize_bilinear(nchw(x), *out_hw)),
                 jblocks.resize_bilinear(x, *out_hw), 1e-5)


def test_blur_pool_reflect_asymmetric():
    x = _x((2, 9, 12, 5))
    assert_close(nhwc(matching.blur_pool(nchw(x))), jmatch.blur_pool(x), 1e-6)


@pytest.mark.parametrize("stride", [1, 2])
def test_resnet_block_bn(stride):
    x = _x((2, 8, 10, 16))
    jm = jmatch.ResnetBlockBN(24, stride)
    v = seeded_variables(jm.init, x, seed=1)
    tm = bridged(matching.ResnetBlockBN(16, 24, stride), v)
    with torch.no_grad():
        assert_close(nhwc(tm(nchw(x))), jax.jit(jm.apply)(v, x), REL)


def test_resnet_matching_encoder():
    x = _x((2, 32, 48, 3))
    jm = jmatch.ResnetMatchingEncoder()
    v = seeded_variables(jm.init, x, seed=2)
    tm = bridged(matching.ResnetMatchingEncoder(), v)
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    assert got.shape == (2, 8, 12, 16)
    assert_close(got, jax.jit(jm.apply)(v, x), REL)


def test_tiny_encoder():
    x = _x((1, 64, 96, 3))
    jm = jenc.TinyEncoder()
    v = seeded_variables(jm.init, x, seed=3)
    tm = bridged(image_encoders.TinyEncoder(), v)
    with torch.no_grad():
        got = tm(nchw(x))
    for g, r in zip(got, jax.jit(jm.apply)(v, x), strict=True):
        assert_close(nhwc(g), r, REL)


@pytest.fixture(scope="module")
def effnet():
    jm = jenc.EfficientNetV2S()
    v = seeded_variables(jm.init, jnp.zeros((1, 64, 96, 3)), seed=4)
    return jm, v, bridged(image_encoders.EfficientNetV2S(), v)


@pytest.mark.parametrize("hw", [(64, 96), (45, 67)])
def test_efficientnet_v2_s(effnet, hw):
    jm, v, tm = effnet
    x = _x((1,) + hw + (3,), seed=6)
    with torch.no_grad():
        got = tm(nchw(x))
    ref = jax.jit(jm.apply)(v, x)
    assert [g.shape[1] for g in got] == list(image_encoders.EfficientNetV2S.num_ch_enc)
    for g, r in zip(got, ref, strict=True):
        assert_close(nhwc(g), r, REL)


def test_conv_same_padding_is_asymmetric():
    """TF SAME on a stride-2 3x3 conv of an even input pads 0 before, 1
    after; Conv2d(padding=1) would not."""
    x = torch.zeros(1, 1, 4, 6)
    assert image_encoders.pad_same(x, 3, 2).shape[-2:] == (5, 7)
    y = image_encoders.pad_same(torch.ones(1, 1, 4, 6), 3, 2)
    assert y[0, 0, 0].sum() == 6 and y[0, 0, -1].sum() == 0
