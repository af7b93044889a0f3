"""Port parity for the BD model built from the encoder zoo and the skip
decoder, against the JAX package on the CPU in f32: model (a) here; the
bottleneck models (b) and (c), the converter and the CLIs in
tests/test_torch_zoo_models.py; DepthNet in
tests/test_torch_depth_net_variants.py.

Models (the chip's zoo cells):
- (a) `resnet18d` image encoder, `fpn` matching encoder, `skip` decoder:
  every new part in one net;
- (b) `resnext101_64x4d`, ResNet matching, U-Net++;
- (c) `seresnextaa101d_32x8d`, ResNet matching, U-Net++.
Sizes follow tests/test_torch_bd_variants.py: K=2 source views, 8 planes,
64x96 images (b, c: the full 101-layer encoders). Tolerances:
- `forward_val` and the training forward: 1e-4 of the largest reference
  value per output, as tests/test_torch_encoders.py; `lowest_cost` the
  depth of the same arg-max plane on every pixel (1e-6 relative).
- One BD train step of model (a) (flip on, train-mode batch norm) against
  net.apply(mutable=["batch_stats"]) + binary_losses + jax.value_and_grad
  in float64 (jax.enable_x64): losses and batch statistics 1e-5 relative
  (AdamW against optax on every parameter: tests/test_torch_train.py and
  tests/test_torch_depth_net_variants.py). The gradients: relative L2
  error over all parameters 5e-3, the median over parameters of max|err| /
  max|ref| 1e-2 and the worst 2e-1. Why looser than tests/test_torch_bd_variants.py (2e-2 per
  parameter, median 1e-3): train-mode batch norm, each followed by a
  ReLU, sees 36 values a channel at MNASNet's 2x3 stride-32 level here and
  12 at ResNet18-D's, so the exact gradient is ill-conditioned: moving the
  images by 1e-7 (f32 rounding) moves the float64 gradients of single
  parameters by up to 3.4%. Measured against float64: the JAX package's
  own f32 step relative L2 4.1e-3, median 5.6e-3, worst 7.8e-2, 11 of 348
  parameters beyond 2e-2; the port's 2.1e-3, 4.3e-3, 1.4e-1 (one MNASNet
  stage-5 conv), 9 beyond 2e-2.
- Weight decay on a parameter without a gradient: nothing reads the FPN's
  `lateral_0` (its pyramid level is dead), so JAX's gradient there is
  exactly 0 and optax.adamw still decays it. The step uses wd 0.1, so a
  skipped decay (torch's AdamW on a None gradient) is 1e-4 of the value,
  far outside the 1e-6 at which the port's `lateral_0` after the step is
  held to the JAX step's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_depth_tpu.core.sampling import grid_sample as jgrid_sample
from implicit_depth_tpu.models.bd_net import BDNet as JBDNet
from implicit_depth_tpu.ops import image as jimage
from implicit_depth_tpu.train import losses as jlosses
from implicit_depth_tpu.train import state as jstate
from implicit_depth_tpu.utils.fixtures import synthetic_bd_batch
from implicit_depth_tpu_torch.models import decoders, fpn_matching, image_encoders, matching, resnets
from implicit_depth_tpu_torch.models.bd_net import TRAIN_ONLY_PREFIXES, BDNet
from implicit_depth_tpu_torch.train import state
from implicit_depth_tpu_torch.weights import load_state_dict, state_dict_from_flax
from tests.torch_parity import (assert_close, assert_tree_close, bridged, grad_agreement,
                                seeded_variables, to_numpy_tree)

K, D_BINS, N_PLANES = 2, 8, 3
LR, WD = 1e-3, 0.1
REL = 1e-4
MODELS = {
    "a": dict(image_encoder_name="resnet18d", matching_encoder_type="fpn",
              depth_decoder_name="skip"),
    "b": dict(image_encoder_name="resnext101_64x4d"),
    "c": dict(image_encoder_name="seresnextaa101d_32x8d"),
}
PARTS = {  # model -> (image encoder, matching encoder, decoder) types of the port
    "a": (image_encoders.ResNet18D, fpn_matching.FPNMatchingEncoder, decoders.SkipDecoder),
    "b": (resnets.ResNetBottleneckEncoder, matching.ResnetMatchingEncoder, decoders.DecoderPP),
    "c": (resnets.ResNetBottleneckEncoder, matching.ResnetMatchingEncoder, decoders.DecoderPP),
}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads in this module's process: `pytest -n 6` puts six
    test processes on the host's cores (see tests/test_torch_prior.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _torch(d):
    return {k: torch.tensor(v) for k, v in d.items()}


def _kw(model):
    return dict(num_src_views=K, num_depth_bins=D_BINS, **MODELS[model])


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64)
                        if np.asarray(x).dtype == np.float32 else np.asarray(x), tree)


def _same_planes(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def _running_stats(module) -> dict:
    return {k: v for k, v in module.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


# ------------------------------------------------------------------- BD eval

def check_forward_val(model):
    """forward_val of ZOO model `model`, port against JAX."""
    cur, src = synthetic_bd_batch(batch=1, num_src=K, height=64, width=96, num_planes=N_PLANES,
                                  with_train_keys=False, seed=0)
    jnet = JBDNet(**_kw(model))
    variables = seeded_variables(
        lambda key, c, s: jnet.init({"params": key}, c, s, method=JBDNet.forward_val),
        cur, src, seed=41)
    ref = jax.jit(lambda v, c, s: jnet.apply(v, c, s, method=JBDNet.forward_val))(
        variables, cur, src)
    net = bridged(BDNet(**_kw(model)), variables, TRAIN_ONLY_PREFIXES)
    assert tuple(map(type, (net.encoder, net.matching, net.decoder))) == PARTS[model]
    with torch.no_grad():
        got = net.forward_val(_torch(cur), _torch(src))
    assert got["pred_0"].shape == (1, 32, 48, N_PLANES)
    assert_close(got["pred_0"], ref["pred_0"], REL)
    _same_planes(got["lowest_cost"], ref["lowest_cost"])


def test_forward_val_matches_jax():
    check_forward_val("a")


# ---------------------------------------------------------------- BD train

@pytest.fixture(scope="module")
def bd_train_case():
    cur, src = synthetic_bd_batch(batch=2, num_src=K, height=64, width=96, num_planes=3,
                                  num_rays=64, samples_per_ray=8, seed=0)
    jnet = JBDNet(train_bn=True, **_kw("a"))
    variables = seeded_variables(lambda key, c, s: jnet.init({"params": key}, c, s, flip=False),
                                 cur, src, seed=42)
    return cur, src, jnet, variables


def test_bd_train_forward_matches_jax(bd_train_case):
    cur, src, jnet, variables = bd_train_case
    ref, _ = jax.jit(lambda v, c, s: jnet.apply(v, c, s, flip=True, mutable=["batch_stats"]))(
        variables, cur, src)
    net = BDNet(**_kw("a"))
    load_state_dict(net, state_dict_from_flax(to_numpy_tree(variables)))
    with torch.no_grad():
        got = net.train()(_torch(cur), _torch(src), flip=True)
    for k in ("pred_0", "pred_1", "pred_2", "pred_3"):
        assert got[k].shape == ref[k].shape
        assert_close(got[k], ref[k], REL)
    _same_planes(got["lowest_cost"], ref["lowest_cost"])


def test_bd_train_step_matches_jax(bd_train_case):
    cur, src, jnet, variables = bd_train_case

    def loss_fn(params, batch_stats, cur, src):
        gt, rays = cur["gt_depth"], cur["sampled_rays"]
        grid = jnp.stack([(rays[..., 0] / gt.shape[2] - 0.5) * 2,
                          (rays[..., 1] / gt.shape[1] - 0.5) * 2], -1)
        edge = jgrid_sample(jimage.get_edge_mask(gt), grid[:, :, None],
                            mode="nearest")[:, :, 0, 0][..., None]
        out, mutated = jnet.apply({"params": params, "batch_stats": batch_stats},
                                  cur, src, flip=True, mutable=["batch_stats"])
        preds = {k: v for k, v in out.items() if k.startswith("pred_")}
        ls = jlosses.binary_losses(out["query_depth"], out["target_depth"][..., None], preds,
                                   pos_weight=1.0, regularisation_weight=0.5, edge_mask=edge)
        return ls["loss"], (mutated["batch_stats"], ls)

    with jax.enable_x64(True):
        (_, (batch_stats, ref_losses)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
            *(jax.tree.map(jnp.asarray, _f64(x))
              for x in (variables["params"], variables["batch_stats"], cur, src)))
        batch_stats, ref_losses, grads = (to_numpy_tree(x)
                                          for x in (batch_stats, ref_losses, grads))
    lateral = grads["matching"]["lateral_0"]
    assert not np.any(lateral["kernel"]) and not np.any(lateral["bias"])  # a dead level

    net = BDNet(**_kw("a"))
    load_state_dict(net, state_dict_from_flax(to_numpy_tree(variables)))
    before = net.matching.lateral_0.weight.detach().clone()
    opt, sched = state.make_optimizer(net.parameters(), LR, WD)
    got = state.make_bd_train_step(net, opt, sched)((_torch(cur), _torch(src)), flip=True)

    # the parameter without a gradient: decayed as optax decays it (the JAX
    # step on that subtree alone; AdamW's updates are per parameter)
    def sub(tree):
        return {"matching": {"lateral_0": tree["matching"]["lateral_0"]}}

    st = jstate.create_train_state({"params": sub(variables["params"])},
                                   jstate.make_optimizer(LR, WD, (70000, 80000)))
    expected = st.apply_gradients(jax.tree.map(np.float32, sub(grads)), {}).params
    lateral_0 = {k: v for k, v in net.named_parameters() if k.startswith("matching.lateral_0.")}
    assert_tree_close(expected, "params", lateral_0, 1e-6)
    assert not torch.equal(net.matching.lateral_0.weight.detach(), before)
    assert torch.equal(net.matching.lateral_0.weight.grad, torch.zeros_like(before))

    assert sorted(got) == sorted(ref_losses)
    for k in ref_losses:
        assert_close(got[k], ref_losses[k], 1e-5)
    rel_l2, median, worst, name = grad_agreement(grads, net)
    assert rel_l2 <= 5e-3 and median <= 1e-2 and worst <= 2e-1, (rel_l2, median, worst, name)
    assert_tree_close(batch_stats, "batch_stats", _running_stats(net), 1e-5)


