"""Port parity: DepthNet (models/depth_net.py), DecoderPP with its output
heads and the weight bridge on DepthNet trees, against the JAX package on
the CPU in f32. The port runs on CPU tensors, so its warp is kernel #5's
plain version; the JAX DepthNet runs its XLA warp.

Sizes follow tests/test_torch_bd_net.py: 64x96 images, K=2 source views,
8 depth bins, the tiny encoder. Tolerance: every depth output and
`lowest_cost` within 1e-4 of its largest value, as the BD model's outputs
(f32 sums in another order through ~60 layers; measured ~5e-6 here).
"""

import jax
import numpy as np
import pytest
import torch

from implicit_depth_tpu.models import decoders as jdec
from implicit_depth_tpu.models.depth_net import DepthNet as JDepthNet
from implicit_depth_tpu.utils.fixtures import synthetic_bd_batch
from implicit_depth_tpu_torch.models import decoders
from implicit_depth_tpu_torch.models.depth_net import DepthNet
from implicit_depth_tpu_torch.weights import init_params, load_state_dict, state_dict_from_flax
from tests.torch_parity import assert_close, bridged, nchw, nhwc, seeded_variables, to_numpy_tree

K, D_BINS = 2, 8
REL = 1e-4
OUTPUT_KEYS = sorted(["lowest_cost"] + [f"{p}_{s}" for p in ("log_depth_pred", "depth_pred")
                                        for s in range(4)])


@pytest.fixture(scope="module")
def batch():
    return synthetic_bd_batch(batch=1, num_src=K, height=64, width=96, num_rays=16,
                              samples_per_ray=8, seed=0)


def _torch_batch(d):
    return {k: torch.tensor(v) for k, v in d.items()}


def _variables(jnet, cur, src, seed):
    return seeded_variables(lambda key, c, s: jnet.init({"params": key}, c, s), cur, src,
                            seed=seed)


@pytest.mark.parametrize("volume", ["mlp_feature_volume", "simple_cost_volume",
                                    "zero_cost_volume"])
def test_depth_net_matches_jax(batch, volume):
    cur, src = batch
    kw = dict(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny",
              feature_volume_type=volume)
    jnet = JDepthNet(**kw)
    variables = _variables(jnet, cur, src, seed=11)
    ref = jax.jit(lambda v, c, s: jnet.apply(v, c, s))(variables, cur, src)

    net = bridged(DepthNet(**kw), variables)
    with torch.no_grad():
        got = net(_torch_batch(cur), _torch_batch(src))
    assert sorted(got) == sorted(ref) == OUTPUT_KEYS
    for key in OUTPUT_KEYS:
        assert got[key].dtype == torch.float32
        assert_close(got[key], ref[key], REL)
    assert got["depth_pred_0"].shape == (1, 32, 48, 1)
    assert got["depth_pred_3"].shape == (1, 4, 6, 1)


def test_depth_net_flip_matches_jax(batch):
    """The flip path: images flipped, matching features unflipped, the
    volume re-flipped, log depths unflipped."""
    cur, src = batch
    jnet = JDepthNet(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny")
    variables = _variables(jnet, cur, src, seed=12)
    ref = jax.jit(lambda v, c, s: jnet.apply(v, c, s, flip=True))(variables, cur, src)
    net = bridged(DepthNet(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny"),
                  variables)
    with torch.no_grad():
        got = net(_torch_batch(cur), _torch_batch(src), flip=True)
    for key in OUTPUT_KEYS:
        assert_close(got[key], ref[key], REL)


def test_decoder_pp_with_heads():
    enc_ch = (24, 64, 128, 256, 384)
    h, w = 32, 48
    rng = np.random.RandomState(3)
    feats = [rng.randn(1, h >> i, w >> i, ch).astype(np.float32) for i, ch in enumerate(enc_ch)]
    jm = jdec.DecoderPP(head_channels=1)
    v = seeded_variables(jm.init, feats, seed=4)
    assert {f"output_head_{i}" for i in range(4)} <= set(v["params"])
    tm = bridged(decoders.DecoderPP(enc_ch, head_channels=1), v)
    with torch.no_grad():
        got = tm([nchw(x) for x in feats])
    ref = jax.jit(jm.apply)(v, feats)
    for s in range(4):
        assert got[s].shape[1] == 1
        assert_close(nhwc(got[s]), ref[s], REL)


@pytest.mark.parametrize("train_bn", [False, True], ids=["eval_init", "train_init"])
def test_bridge_takes_depth_net_trees(batch, train_bn):
    """Eval- and train-initialised flagship DepthNet trees (EfficientNetV2-S,
    the metadata volume, the heads): every leaf lands once and the port's
    state_dict is covered with nothing optional."""
    cur, src = batch
    jnet = JDepthNet(num_src_views=K, num_depth_bins=D_BINS, train_bn=train_bn)
    variables = to_numpy_tree(_variables(jnet, cur, src, seed=5))
    sd = state_dict_from_flax(variables)
    assert len(sd) == len(jax.tree_util.tree_leaves(variables))
    net = DepthNet(num_src_views=K, num_depth_bins=D_BINS)
    assert set(sd) == set(net.state_dict())
    load_state_dict(net, sd)
    head = variables["params"]["decoder"]["output_head_2"]["kernel"]  # (1, 1, 128, 1) HWIO
    np.testing.assert_array_equal(net.decoder.output_head_2.weight.detach().numpy(),
                                  head.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        net.matching.bn1.running_var.numpy(),
        variables["batch_stats"]["matching"]["bn1"]["BatchNorm_0"]["var"])


def test_depth_net_refuses_unported_parts():
    """The skip decoder, the FPN matching encoder and the ResNet encoders
    build now, by the JAX package's names and in its order of tests;
    unknown names still raise (ValueError, as in JAX), and so does a volume
    type the port lacks (NotImplementedError)."""
    from implicit_depth_tpu_torch.models.decoders import SkipDecoder
    from implicit_depth_tpu_torch.models.fpn_matching import FPNMatchingEncoder
    from implicit_depth_tpu_torch.models.image_encoders import ResNet18D
    from implicit_depth_tpu_torch.models.resnets import ResNetBottleneckEncoder

    net = DepthNet(image_encoder_name="tiny", depth_decoder_name="skip",
                   matching_encoder_type="fpn")
    assert isinstance(net.decoder, SkipDecoder) and net.decoder.regression_heads
    assert isinstance(net.matching, FPNMatchingEncoder)
    assert isinstance(DepthNet(image_encoder_name="resnet").encoder, ResNet18D)
    assert isinstance(DepthNet(image_encoder_name="resnet18d").encoder, ResNet18D)
    se = DepthNet(image_encoder_name="seresnextaa101d_32x8d").encoder
    assert isinstance(se, ResNetBottleneckEncoder) and se.num_ch_enc[0] == 128
    for kw, error in ((dict(image_encoder_name="vgg16"), ValueError),
                      (dict(depth_decoder_name="no_such_decoder"), ValueError),
                      (dict(feature_volume_type="cost_volume"), NotImplementedError)):
        with pytest.raises(error):
            DepthNet(**kw)


def test_seeded_init_covers_the_heads():
    net = init_params(DepthNet(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny"),
                      torch.Generator().manual_seed(0))
    w = net.decoder.output_head_0.weight.detach()
    assert w.shape == (1, 64, 1, 1) and float(w.abs().sum()) > 0
    assert float(net.decoder.output_head_0.bias.detach().abs().sum()) == 0.0
