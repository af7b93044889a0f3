"""Port parity for the BD model on the dot-product and zero volumes
(`feature_volume_type` simple_cost_volume / zero_cost_volume) against the
JAX package, on the CPU in f32, and what `fit` and `cli/test_bd.py` refuse
of --resume and --jax_distributed.

Sizes follow tests/test_torch_prior.py: the tiny encoder, K=2 source views,
8 planes, 64x96 images. Tolerances:
- `forward_val` and one training forward (batch norm in train mode, flip
  on): every `pred_*` within 5e-5 of its largest reference logit, as
  tests/test_torch_prior.py (f32 sums in another order), and `lowest_cost`
  the depth of the same arg-max plane on every pixel (1e-6 relative: a
  plane's depth may differ in the last f32 bit).
- One dot BD train step (flip on) against net.apply(mutable=["batch_stats"])
  + binary_losses + jax.value_and_grad run in float64 (jax.enable_x64), at
  the bounds of tests/test_torch_train.py: every loss 1e-5 relative, the
  updated batch statistics 1e-5, every parameter's gradient within 2e-2 of
  its largest value (+1e-8 for the head biases that instance norm cancels)
  and the median over parameters within 1e-3. Why float64, as
  tests/test_torch_prior.py: the JAX package's own f32 step is the noisier
  side here. Against float64 its matching encoder's gradients are up to
  ~6e-2 off, median 1.5e-3 over parameters; the port's worst is 5.9e-3,
  median 4.6e-4: f32 rounding through the dot volume's sums over views and
  channels, amplified through the backward of ~40 layers.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_depth_tpu.core.sampling import grid_sample as jgrid_sample
from implicit_depth_tpu.models.bd_net import BDNet as JBDNet
from implicit_depth_tpu.ops import image as jimage
from implicit_depth_tpu.train import losses as jlosses
from implicit_depth_tpu.utils.fixtures import synthetic_bd_batch
from implicit_depth_tpu_torch.models.bd_net import TRAIN_ONLY_PREFIXES, BDNet
from implicit_depth_tpu_torch.train import state
from implicit_depth_tpu_torch.weights import init_params, load_state_dict, state_dict_from_flax
from tests.torch_parity import (assert_close, assert_grad_tree_close, assert_tree_close, bridged,
                                seeded_variables, to_numpy_tree)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, D_BINS, N_PLANES = 2, 8, 3
VOLUMES = ["simple_cost_volume", "zero_cost_volume"]


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


def _kw(volume):
    return dict(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny",
                feature_volume_type=volume)


def _same_planes(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("volume", VOLUMES)
def test_forward_val_matches_jax(volume):
    cur, src = synthetic_bd_batch(batch=1, num_src=K, height=64, width=96, num_planes=N_PLANES,
                                  with_train_keys=False, seed=0)
    jnet = JBDNet(**_kw(volume))
    variables = seeded_variables(
        lambda key, c, s: jnet.init({"params": key}, c, s, method=JBDNet.forward_val),
        cur, src, seed=31)
    assert "volume_mlp" not in variables["params"]
    ref = jax.jit(lambda v, c, s: jnet.apply(v, c, s, method=JBDNet.forward_val))(
        variables, cur, src)
    net = bridged(BDNet(**_kw(volume)), variables, TRAIN_ONLY_PREFIXES)
    assert not hasattr(net, "volume_mlp")
    with torch.no_grad():
        got = net.forward_val(_torch(cur), _torch(src))
    assert got["pred_0"].shape == (1, 32, 48, N_PLANES)
    assert_close(got["pred_0"], ref["pred_0"], 5e-5)
    _same_planes(got["lowest_cost"], ref["lowest_cost"])
    if volume == "zero_cost_volume":  # no plane stands out: the first one
        assert (got["lowest_cost"] == got["lowest_cost"].min()).all()
    else:
        assert len(torch.unique(got["lowest_cost"])) > 1


@pytest.fixture(scope="module")
def train_batch():
    return synthetic_bd_batch(batch=2, num_src=K, height=64, width=96, num_planes=3,
                              num_rays=64, samples_per_ray=8, seed=0)


def _train_variables(jnet, cur, src, seed):
    return seeded_variables(lambda key, c, s: jnet.init({"params": key}, c, s, flip=False),
                            cur, src, seed=seed)


@pytest.mark.parametrize("volume", VOLUMES)
def test_train_forward_matches_jax(train_batch, volume):
    """The training forward with flip on and batch norm in train mode: the
    dot volume is built from the unflipped matching features and re-flipped,
    as the metadata volume is."""
    cur, src = train_batch
    jnet = JBDNet(train_bn=True, **_kw(volume))
    variables = _train_variables(jnet, cur, src, seed=32)
    ref, _ = jax.jit(lambda v, c, s: jnet.apply(v, c, s, flip=True, mutable=["batch_stats"]))(
        variables, cur, src)
    net = BDNet(**_kw(volume))
    load_state_dict(net, state_dict_from_flax(to_numpy_tree(variables)))
    with torch.no_grad():
        got = net.train()(_torch(cur), _torch(src), flip=True)
    for k in ("pred_0", "pred_1", "pred_2", "pred_3"):
        assert got[k].shape == ref[k].shape
        assert_close(got[k], ref[k], 5e-5)
    _same_planes(got["lowest_cost"], ref["lowest_cost"])


def test_dot_train_step_matches_jax(train_batch):
    cur, src = train_batch
    jnet = JBDNet(train_bn=True, **_kw("simple_cost_volume"))
    variables = _train_variables(jnet, cur, src, seed=33)

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

    def f64(tree):
        return jax.tree.map(lambda x: jnp.asarray(
            np.asarray(x, np.float64) if np.asarray(x).dtype == np.float32 else x), tree)

    with jax.enable_x64(True):
        (_, (batch_stats, ref_losses)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
            *(f64(x) for x in (variables["params"], variables["batch_stats"], cur, src)))
        batch_stats, ref_losses, grads = (to_numpy_tree(x)
                                          for x in (batch_stats, ref_losses, grads))

    net = BDNet(**_kw("simple_cost_volume"))
    load_state_dict(net, state_dict_from_flax(to_numpy_tree(variables)))
    opt, sched = state.make_optimizer(net.parameters(), 1e-3, 1e-4)
    got = state.make_bd_train_step(net, opt, sched)((_torch(cur), _torch(src)), flip=True)
    assert sorted(got) == sorted(ref_losses)
    for k in ref_losses:
        assert_close(got[k], ref_losses[k], 1e-5)
    rel_errs = assert_grad_tree_close(grads, net, 2e-2, atol=1e-8)
    assert np.median(list(rel_errs.values())) <= 1e-3
    assert net.matching.conv1.weight.grad.abs().max() > 0  # the volume carries a gradient
    running = {k: v for k, v in net.state_dict().items()
               if k.endswith(("running_mean", "running_var"))}
    assert_tree_close(batch_stats, "batch_stats", running, 1e-5)


@pytest.mark.parametrize("config, volume", [
    ("configs/models/dot_product_model.yaml", "simple_cost_volume"),
    ("configs/models/implicit_depth.yaml", "zero_cost_volume")], ids=["dot", "zero"])
def test_build_net_builds_the_volume_variants(config, volume):
    from implicit_depth_tpu_torch.config import parse_config
    from implicit_depth_tpu_torch.train.loop import build_net

    cfg, _ = parse_config(["--config_file", os.path.join(REPO, config),
                           "--feature_volume_type", volume, "--image_encoder_name", "tiny",
                           "--bd_sigmoid_multiplier", "2.5"])
    net = build_net(cfg)
    assert isinstance(net, BDNet) and net.feature_volume_type == volume
    assert net.compute_dtype == torch.bfloat16 and net.bd_sigmoid_multiplier == 2.5
    assert not any(k.startswith("volume_mlp.") for k in net.state_dict())
    net = init_params(net, torch.Generator().manual_seed(0)).cast_to_compute_dtype()
    assert net.cv_encoder.ds_conv_0.conv1.weight.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="no_such_volume"):
        BDNet(feature_volume_type="no_such_volume")


_CLI = ["--config_file", os.path.join(REPO, "configs/models/implicit_depth.yaml"),
        "--data_config_file", os.path.join(REPO, "configs/data/synthetic_smoke.yaml"),
        "--device", "cpu", "--image_encoder_name", "tiny"]


@pytest.mark.parametrize("flag", ["resume", "jax_distributed"])
def test_fit_refuses_unported_flags(tmp_path, flag):
    """fit takes --resume and --jax_distributed now (tests/test_torch_checkpoint.py,
    tests/test_torch_distributed.py); it refuses them where they cannot work,
    before it writes anything: a resume directory with no checkpoint, a
    process group without its address, size and rank."""
    from implicit_depth_tpu_torch.cli import train_bd

    if flag == "resume":
        value, error = ["--resume", str(tmp_path / "old_run")], FileNotFoundError
    else:
        value, error = ["--jax_distributed"], ValueError
    with pytest.raises(error, match="old_run" if flag == "resume" else "--coordinator_address"):
        train_bd.main(_CLI + ["--log_dir", str(tmp_path)] + value)
    assert not (tmp_path / "implicit_depth").exists()  # nothing written


def test_test_bd_refuses_jax_distributed():
    """cli/test_bd.py takes --jax_distributed now (tests/test_torch_distributed.py);
    without the process group's address, size and rank it refuses."""
    from implicit_depth_tpu_torch.cli import test_bd

    with pytest.raises(ValueError, match="--coordinator_address"):
        test_bd.main(_CLI + ["--jax_distributed"])
