"""Port parity for the encoder zoo and the skip decoder against the JAX
package, on the CPU in f32, with seeded parameters and BN statistics in the
flax modules' variable trees crossing through the weight bridge:
upsample2x_nearest, MLP, sigmoid_custom, ResnetBlockBN(avg_down), ResNet18D,
Bottleneck over its flags, the bottleneck encoders (ResNeXt101-64x4d and
SE-ResNeXt-AA101d-32x8d, each at reduced depth layers=(1, 1, 2, 1) with its
factory's flags, and each full factory once at 64x96), MNASNet100,
FPNMatchingEncoder, ConvBlockELU and SkipDecoder with and without its
regression heads, and the seeded init's fan-in on grouped convs.

Tolerance: 1e-4 of the largest reference value per output, as
tests/test_torch_encoders.py (f32 convs summed in another order; the full
101-layer factories stay within it). Sizes: 64x96, 63x95 (sides that are
not multiples of 32, which every module here accepts) and 45x67. Where the
JAX module refuses a size (an add of two levels or of a block's two
branches whose sizes differ) the test asserts that it does and that the
port raises too; nothing is padded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_depth_tpu.models import blocks as jblocks
from implicit_depth_tpu.models import decoders as jdec
from implicit_depth_tpu.models import fpn_matching as jfpn
from implicit_depth_tpu.models import image_encoders as jenc
from implicit_depth_tpu.models import matching as jmatch
from implicit_depth_tpu.models import resnets as jres
from implicit_depth_tpu_torch.models import blocks, decoders, fpn_matching, image_encoders, matching
from implicit_depth_tpu_torch.models import resnets
from implicit_depth_tpu_torch.weights import init_params
from tests.torch_parity import assert_close, bridged, nchw, nhwc, seeded_variables, to_numpy_tree

REL = 1e-4
ACCEPTED, REFUSED = (64, 96), (45, 67)
ODD = (63, 95)
FLAGS = {  # the factories' flags (implicit_depth_tpu/models/resnets.py)
    "resnext101_64x4d": dict(groups=64, base_width=4),
    "seresnextaa101d_32x8d": dict(groups=32, base_width=8, use_se=True, antialias=True,
                                  deep_stem=True, avg_down=True),
}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads in this module's process: `pytest -n 6` puts six
    test processes on the host's cores (see tests/test_torch_prior.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _check(jm, v, tm, x, accepted: bool = True) -> None:
    """The port's outputs (a tensor or a list) against the JAX module's, or,
    where the JAX module refuses x, that both refuse it."""
    if not accepted:
        with pytest.raises(TypeError):
            jm.apply(v, x)
        with pytest.raises((RuntimeError, ValueError)), torch.no_grad():
            tm(nchw(x))
        return
    ref = jax.jit(jm.apply)(v, x)
    with torch.no_grad():
        got = tm(nchw(x))
    if isinstance(got, torch.Tensor):
        got, ref = [got], [ref]
    assert len(got) == len(ref)
    for g, r in zip(got, ref, strict=True):
        assert_close(nhwc(g), r, REL)


# ----------------------------------------------------------------- blocks

@pytest.mark.parametrize("hw", [(5, 7), (12, 16)])
def test_upsample2x_nearest_is_exact(hw):
    x = _x((2,) + hw + (3,))
    got = nhwc(blocks.upsample2x_nearest(nchw(x)))
    np.testing.assert_array_equal(got, np.asarray(jblocks.upsample2x_nearest(jnp.asarray(x))))
    np.testing.assert_array_equal(got, x.repeat(2, axis=1).repeat(2, axis=2))


@pytest.mark.parametrize("final", [False, True], ids=["act", "no_final_act"])
def test_mlp(final):
    x = _x((3, 5, 7))
    jm = jblocks.MLP((16, 8, 4), disable_final_activation=final)
    v = seeded_variables(jm.init, x, seed=1)
    tm = bridged(blocks.MLP(7, (16, 8, 4), disable_final_activation=final), v)
    with torch.no_grad():
        got = tm(torch.tensor(x))
    ref = jm.apply(v, x)
    assert_close(got, ref, REL)


def test_sigmoid_custom():
    x = _x((4, 9)) * 3
    for m in (1.0, 2.5):
        assert_close(blocks.sigmoid_custom(torch.tensor(x), m), jblocks.sigmoid_custom(x, m), 1e-6)


# ---------------------------------------------------------- ResNet18-D family

@pytest.mark.parametrize("stride,hw,accepted", [
    (1, (9, 11), True), (2, (10, 12), True), (2, (9, 11), False)])
def test_resnet_block_bn_avg_down(stride, hw, accepted):
    """The "-d" shortcut pools 2x2 VALID (floor), as flax's nn.avg_pool: an
    odd side at stride 2 gives a shortcut one short of the strided conv's,
    which both frameworks refuse."""
    jm = jmatch.ResnetBlockBN(24, stride, avg_down=True)
    v = seeded_variables(jm.init, jnp.zeros((1, 10, 12, 16)), seed=2)
    tm = bridged(matching.ResnetBlockBN(16, 24, stride, avg_down=True), v)
    _check(jm, v, tm, _x((2,) + hw + (16,), seed=3), accepted)


@pytest.fixture(scope="module")
def resnet18d():
    jm = jenc.ResNet18D()
    v = seeded_variables(jm.init, jnp.zeros((1,) + ACCEPTED + (3,)), seed=4)
    return jm, v, bridged(image_encoders.ResNet18D(), v)


@pytest.mark.parametrize("hw", [ACCEPTED, ODD, REFUSED])
def test_resnet18d(resnet18d, hw):
    jm, v, tm = resnet18d
    if hw == ACCEPTED:
        with torch.no_grad():
            feats = tm(nchw(_x((1,) + hw + (3,))))
        assert [f.shape[1] for f in feats] == list(image_encoders.ResNet18D.num_ch_enc)
        assert [64 // f.shape[2] for f in feats] == [2, 4, 8, 16, 32]
    _check(jm, v, tm, _x((1,) + hw + (3,), seed=5), hw != REFUSED)


# ------------------------------------------------------------- bottlenecks

BOTTLENECK_FLAGS = {
    "plain": {}, "se": dict(use_se=True), "antialias": dict(antialias=True),
    "avg_down": dict(avg_down=True),
    "all": dict(use_se=True, antialias=True, avg_down=True),
}


@pytest.mark.parametrize("stride", [2, 1])
@pytest.mark.parametrize("flags", list(BOTTLENECK_FLAGS))
def test_bottleneck(flags, stride):
    """groups=4 and base_width=8 make conv2 a grouped 3x3 of 8 channels in 4
    groups (g > 1 and g < channels): flax stores (3, 3, 2, 8), torch wants
    (8, 2, 3, 3), which the bridge's HWIO -> OIHW permutation gives."""
    kw = dict(groups=4, base_width=8, **BOTTLENECK_FLAGS[flags])
    cin = 32 if stride == 2 else 64  # stride 1 at planes*4 channels: the identity shortcut
    jm = jres.Bottleneck(16, stride, **kw)
    v = seeded_variables(jm.init, jnp.zeros((1, 8, 10, cin)), seed=6)
    tm = bridged(resnets.Bottleneck(cin, 16, stride, **kw), v)
    kernel = to_numpy_tree(v)["params"]["conv2"]["kernel"]
    assert kernel.shape == (3, 3, 2, 8) and tm.conv2.weight.shape == (8, 2, 3, 3)
    np.testing.assert_array_equal(tm.conv2.weight.detach().numpy(), kernel.transpose(3, 2, 0, 1))
    assert (tm.downsample_conv is None) == (stride == 1)
    _check(jm, v, tm, _x((2, 8, 10, cin), seed=7))


def _bottleneck_pair(name, layers, seed):
    jm = jres.ResNetBottleneckEncoder(layers=layers, **FLAGS[name])
    v = seeded_variables(jm.init, jnp.zeros((1,) + ACCEPTED + (3,)), seed=seed)
    tm = bridged(resnets.ResNetBottleneckEncoder(layers=layers, **FLAGS[name]), v)
    return jm, v, tm


@pytest.fixture(scope="module", params=list(FLAGS))
def bottleneck_encoder(request):
    return request.param, _bottleneck_pair(request.param, (1, 1, 2, 1), seed=8)


@pytest.mark.parametrize("hw", [ACCEPTED, ODD, REFUSED])
def test_bottleneck_encoder_reduced_depth(bottleneck_encoder, hw):
    """ResNeXt's strided 1x1 shortcuts take any size; SE-ResNeXt-AA's
    average-pooled ones refuse 45x67, in both frameworks."""
    name, (jm, v, tm) = bottleneck_encoder
    accepted = hw != REFUSED or name == "resnext101_64x4d"
    _check(jm, v, tm, _x((1,) + hw + (3,), seed=9), accepted)


@pytest.mark.parametrize("name", list(FLAGS))
def test_bottleneck_factory_full_depth(name):
    """Each full 101-layer factory once at 64x96, b=1, as the JAX package's
    tests/test_encoder_zoo.py runs them."""
    jm = {"resnext101_64x4d": jres.ResNeXt101_64x4d,
          "seresnextaa101d_32x8d": jres.SEResNeXtAA101d_32x8d}[name]()
    tm = {"resnext101_64x4d": resnets.ResNeXt101_64x4d,
          "seresnextaa101d_32x8d": resnets.SEResNeXtAA101d_32x8d}[name]()
    assert tm.layers == (3, 4, 23, 3)
    x = _x((1,) + ACCEPTED + (3,), seed=10)
    v = seeded_variables(jm.init, x, seed=11)
    tm = bridged(tm, v)
    assert tm.num_ch_enc == jm.num_ch_enc == ((128,) if "aa" in name else (64,)) + (
        256, 512, 1024, 2048)
    _check(jm, v, tm, x)


# --------------------------------------------------------- FPN matching

@pytest.fixture(scope="module")
def mnasnet():
    jm = jfpn.MNASNet100()
    v = seeded_variables(jm.init, jnp.zeros((1,) + ACCEPTED + (3,)), seed=12)
    return jm, v, bridged(fpn_matching.MNASNet100(), v)


@pytest.mark.parametrize("hw", [ACCEPTED, REFUSED])
def test_mnasnet100(mnasnet, hw):
    """The backbone alone has no cross-level add: it takes 45x67 too."""
    jm, v, tm = mnasnet
    with torch.no_grad():
        feats = tm(nchw(_x((1,) + hw + (3,), seed=13)))
    assert [f.shape[1] for f in feats] == [16, 24, 40, 96, 320]
    _check(jm, v, tm, _x((1,) + hw + (3,), seed=13))


@pytest.fixture(scope="module")
def fpn():
    jm = jfpn.FPNMatchingEncoder()
    v = seeded_variables(jm.init, jnp.zeros((1,) + ACCEPTED + (3,)), seed=14)
    return jm, v, bridged(fpn_matching.FPNMatchingEncoder(), v)


@pytest.mark.parametrize("hw", [ACCEPTED, ODD, REFUSED])
def test_fpn_matching_encoder(fpn, hw):
    jm, v, tm = fpn
    assert "lateral_0" in to_numpy_tree(v)["params"] and tm.lateral_0.weight.shape == (32, 16, 1, 1)
    x = _x((2,) + hw + (3,), seed=15)
    if hw != REFUSED:
        with torch.no_grad():
            assert tm(nchw(x)).shape == (2, 16, -(-hw[0] // 4), -(-hw[1] // 4))
    _check(jm, v, tm, x, hw != REFUSED)


# ------------------------------------------------------------ skip decoder

def test_conv_block_elu():
    x = _x((2, 6, 8, 5))
    jm = jdec.ConvBlockELU(7)
    v = seeded_variables(jm.init, x, seed=16)
    _check(jm, v, bridged(decoders.ConvBlockELU(5, 7), v), x)


@pytest.mark.parametrize("heads", [False, True], ids=["features", "regression_heads"])
@pytest.mark.parametrize("stem", [64, 128])
def test_skip_decoder(heads, stem):
    """Encoder features of the BD trunk at matching scale 1: the encoder's
    scale-0 width (64, or 128 for the deep stem), then the CV encoder's
    (64, 128, 256, 384)."""
    channels = (stem, 64, 128, 256, 384)
    feats = [_x((2, 32 >> i, 48 >> i, c), seed=17 + i) for i, c in enumerate(channels)]
    jm = jdec.SkipDecoder(regression_heads=heads)
    v = seeded_variables(jm.init, feats, seed=21)
    tm = bridged(decoders.SkipDecoder(channels, regression_heads=heads), v)
    ref = jm.apply(v, feats)  # not jitted: jit cannot flatten a dict of int and str keys
    with torch.no_grad():
        got = tm([nchw(f) for f in feats])
    assert sorted(map(str, got)) == sorted(map(str, ref))
    for s in range(4):
        assert got[s].shape[1] == decoders.NUM_CH_DEC[s]
    for k in ref:
        assert_close(nhwc(got[k]), ref[k], REL)


# --------------------------------------------------------------- the init

def test_init_fan_in_of_grouped_and_biased_convs():
    """flax's lecun_normal takes fan_in = k * k * cin / groups, which is
    weight[0].numel() of a torch conv; the convs with biases (squeeze-excite,
    FPN, skip decoder) start at zero bias."""
    enc = init_params(resnets.ResNetBottleneckEncoder(layers=(1, 1, 1, 1), **FLAGS[
        "seresnextaa101d_32x8d"]), torch.Generator().manual_seed(0))
    conv2 = enc.layer4_0.conv2  # (2048, 64, 3, 3): 32 groups, fan_in 576
    assert conv2.groups == 32 and conv2.weight[0].numel() == 576
    std = float(conv2.weight.detach().std())
    assert abs(std - 576 ** -0.5) < 0.03 * 576 ** -0.5
    fpn_m = init_params(fpn_matching.FPNMatchingEncoder(), torch.Generator().manual_seed(1))
    dw = fpn_m.encoder.s5_b0.conv_dw  # depthwise 5x5: fan_in 25
    assert abs(float(dw.weight.detach().std()) - 0.2) < 0.03 * 0.2
    dec = init_params(decoders.SkipDecoder((64, 64, 128, 256, 384), regression_heads=True),
                      torch.Generator().manual_seed(2))
    biased = [m for net in (enc, fpn_m, dec) for m in net.modules()
              if isinstance(m, torch.nn.Conv2d) and m.bias is not None]
    assert len(biased) == 1 * 4 * 2 + 5 + 2 + 4 * 2 * 2 + 4 * 3
    assert all(float(m.bias.abs().max()) == 0.0 for m in biased)
