"""Port parity: BD training against the JAX package on the CPU, in f32.

- Train-mode batch norm (batch mean, biased batch variance, running stats
  0.9 old + 0.1 batch) in the matching encoder and EfficientNetV2-S against
  flax with mutable batch_stats: outputs and running statistics 1e-4 of
  the largest value (as tests/test_torch_encoders.py; the deepest stages
  see 12 values per channel here, downstream of ~40 layers summed in
  another order).
- get_edge_mask and binary_losses: 1e-6 / 1e-5 relative.
- One whole BD train step (tiny encoder, K=2, D=8, 64x96, b=2, N=64, S=8)
  with flip off and on, against net.apply(mutable=["batch_stats"]) +
  binary_losses + jax.value_and_grad + optax.adamw: every loss 1e-5
  relative; the updated batch statistics 1e-5; the gradient of every
  parameter within 2e-2 of its largest value (+1e-8 for the head biases
  that instance norm cancels, ~1e-10), and the median over parameters
  within 1e-3. Why that loose: against a float64 run of the JAX step, with
  flip off the port's f32 gradients are the closer ones (median 3.7e-6,
  worst 1.2e-3; the JAX package's f32 ones median 6.7e-5, worst ~8e-3 in
  the matching encoder), with flip on the JAX package's (median 3.9e-6
  against the port's 5.7e-4, both worst ~4e-3). Neither side is off in a
  systematic way: the spread is f32 rounding amplified through the
  backward of ~40 layers. The parameters after the
  AdamW step equal optax.adamw applied to the port's own gradients (1e-6
  of the largest value): Adam's first step is lr * g / (|g| + eps), so
  comparing against the JAX step's parameters would amplify the gradients'
  rounding wherever |g| is near eps.
- The stepped learning rate, fit for two steps on the synthetic config with
  --device cpu, and the weight bridge on a train-initialised flax tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_depth_tpu.core.sampling import grid_sample as jgrid_sample
from implicit_depth_tpu.models import image_encoders as jenc
from implicit_depth_tpu.models import matching as jmatch
from implicit_depth_tpu.models.bd_net import BDNet as JBDNet
from implicit_depth_tpu.ops import image as jimage
from implicit_depth_tpu.train import losses as jlosses
from implicit_depth_tpu.train import state as jstate
from implicit_depth_tpu.utils.fixtures import synthetic_bd_batch
from implicit_depth_tpu_torch.models import image_encoders, matching
from implicit_depth_tpu_torch.models.bd_net import BDNet
from implicit_depth_tpu_torch.ops import image
from implicit_depth_tpu_torch.train import losses, state
from implicit_depth_tpu_torch.weights import load_state_dict, state_dict_from_flax
from tests.torch_parity import (assert_close, assert_grad_tree_close, assert_tree_close, bridged,
                                flax_tree_from_port, nchw, nhwc, seeded_variables, to_numpy_tree)

K, D_BINS = 2, 8
LR, WD = 1e-3, 1e-4


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _running_stats(module) -> dict:
    return {k: v for k, v in module.state_dict().items() if k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("which", ["matching", "efficientnet"])
def test_batch_norm_train_mode_matches_flax(which):
    x = _x((2, 64, 96, 3), seed=1)
    if which == "matching":
        jm, tm = jmatch.ResnetMatchingEncoder(use_running_average=False), matching.ResnetMatchingEncoder()
    else:
        jm, tm = jenc.EfficientNetV2S(use_running_average=False), image_encoders.EfficientNetV2S()
    v = seeded_variables(jm.init, x, seed=2)
    ref, mutated = jm.apply(v, x, mutable=["batch_stats"])
    tm = bridged(tm, v).train()
    with torch.no_grad():
        got = tm(nchw(x))
    for g, r in zip(got if isinstance(got, list) else [got], ref if isinstance(ref, list) else [ref],
                    strict=True):
        assert_close(nhwc(g), r, 1e-4)
    assert_tree_close(mutated["batch_stats"], "batch_stats", _running_stats(tm), 1e-4)


def test_edge_mask_matches_jax():
    rng = np.random.RandomState(3)
    depth = rng.uniform(0.5, 4.0, (2, 24, 32, 1)).astype(np.float32)
    depth[:, 5:9, 10:20] = 1.0  # a plateau: ties at the quantile
    ref = jimage.get_edge_mask(jnp.asarray(depth))
    got = image.get_edge_mask(torch.tensor(depth))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    gx, gy = image.spatial_gradient(torch.tensor(depth))
    jgx, jgy = jimage.spatial_gradient(jnp.asarray(depth))
    assert_close(gx, jgx, 1e-6)
    assert_close(gy, jgy, 1e-6)


def test_binary_losses_match_jax():
    rng = np.random.RandomState(4)
    b, n, s = 2, 60, 8
    query = rng.uniform(0.3, 5.0, (b, n, s)).astype(np.float32)
    query[0, :3] = 0.0  # invalid samples
    gt = rng.uniform(0.5, 4.0, (b, n, 1)).astype(np.float32)
    gt[1, :5] = 0.0  # invalid rays
    preds = {f"pred_{i}": (rng.randn(b, -(-n // (i + 1)), s) * 2).astype(np.float32) for i in range(4)}
    edge = (rng.rand(b, n, 1) > 0.7).astype(np.float32)
    for pos_weight, edge_mask in ((1.0, edge), (2.5, None)):
        ref = jlosses.binary_losses(jnp.asarray(query), jnp.asarray(gt),
                                    {k: jnp.asarray(v) for k, v in preds.items()},
                                    pos_weight=pos_weight, regularisation_weight=0.5,
                                    edge_mask=None if edge_mask is None else jnp.asarray(edge_mask))
        got = losses.binary_losses(torch.tensor(query), torch.tensor(gt),
                                   {k: torch.tensor(v) for k, v in preds.items()},
                                   pos_weight=pos_weight, regularisation_weight=0.5,
                                   edge_mask=None if edge_mask is None else torch.tensor(edge_mask))
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert_close(got[k], ref[k], 1e-5)


@pytest.fixture(scope="module")
def train_case():
    cur, src = synthetic_bd_batch(batch=2, num_src=K, height=64, width=96, num_planes=3,
                                  num_rays=64, samples_per_ray=8, seed=0)
    jnet = JBDNet(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny", train_bn=True)
    variables = seeded_variables(lambda key, c, s: jnet.init({"params": key}, c, s, flip=False),
                                 cur, src, seed=21)
    return cur, src, jnet, variables


def _jax_step(jnet, variables, cur, src, flip):
    gt = jnp.asarray(cur["gt_depth"])
    hg, wg = gt.shape[1], gt.shape[2]
    rays = jnp.asarray(cur["sampled_rays"])
    grid = jnp.stack([(rays[..., 0] / wg - 0.5) * 2, (rays[..., 1] / hg - 0.5) * 2], -1)
    edge = jgrid_sample(jimage.get_edge_mask(gt), grid[:, :, None], mode="nearest")[:, :, 0, 0][..., None]

    def loss_fn(params):
        out, mutated = jnet.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                  cur, src, flip=flip, mutable=["batch_stats"])
        preds = {k: v for k, v in out.items() if k.startswith("pred_")}
        ls = jlosses.binary_losses(out["query_depth"], out["target_depth"][..., None], preds,
                                   pos_weight=1.0, regularisation_weight=0.5, edge_mask=edge)
        return ls["loss"], (mutated["batch_stats"], ls)

    (_, (batch_stats, ls)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return ls, grads, batch_stats


@pytest.mark.parametrize("flip", [False, True], ids=["noflip", "flip"])
def test_bd_train_step_matches_jax(train_case, flip):
    cur, src, jnet, variables = train_case
    ref_losses, grads, batch_stats = _jax_step(jnet, variables, cur, src, flip)

    net = BDNet(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny")
    load_state_dict(net, state_dict_from_flax(to_numpy_tree(variables)))
    opt, sched = state.make_optimizer(net.parameters(), LR, WD)
    step = state.make_bd_train_step(net, opt, sched)
    got = step(({k: torch.tensor(v) for k, v in cur.items()},
                {k: torch.tensor(v) for k, v in src.items()}), flip=flip)

    assert sorted(got) == sorted(ref_losses)
    for k in ref_losses:
        assert_close(got[k], ref_losses[k], 1e-5)
    rel_errs = assert_grad_tree_close(grads, net, 2e-2, atol=1e-8)
    assert np.median(list(rel_errs.values())) <= 1e-3
    assert_tree_close(batch_stats, "batch_stats", _running_stats(net), 1e-5)
    port_grads = flax_tree_from_port(variables["params"], "params",
                                     {n: p.grad for n, p in net.named_parameters()})
    st = jstate.create_train_state(variables, jstate.make_optimizer(LR, WD, (70000, 80000)))
    expected = st.apply_gradients(port_grads, batch_stats).params
    assert_tree_close(expected, "params", dict(net.named_parameters()), 1e-6)


def test_stepped_lr_schedule():
    f = state.stepped_lr((18000, 36000))
    assert (f(0), f(17999), f(18000), f(36000)) == (1.0, 1.0, 0.1, 0.1 * 0.1)
    p = torch.nn.Parameter(torch.zeros(3))
    opt, sched = state.make_optimizer([p], lr=1e-4, wd=0.0, lr_steps=(2, 4))
    seen = []
    for _ in range(6):
        seen.append(opt.param_groups[0]["lr"])
        p.grad = torch.ones(3)
        opt.step()
        sched.step()
    ref = jstate.stepped_lr(1e-4, (2, 4))
    np.testing.assert_allclose(seen, [float(ref(i)) for i in range(6)], rtol=1e-6)


def test_fit_two_steps_on_cpu(tmp_path):
    from implicit_depth_tpu_torch.cli import train_bd

    res = train_bd.main([
        "--config_file", "configs/models/implicit_depth.yaml",
        "--data_config_file", "configs/data/synthetic_smoke.yaml",
        "--device", "cpu", "--max_steps", "2", "--image_encoder_name", "tiny",
        "--precision", "32", "--log_dir", str(tmp_path), "--num_workers", "2",
        "--log_interval", "1", "--val_interval", "2", "--val_batches", "1",
        "--synthetic_num_frames", "8"])
    assert res["step"] == 2 and np.isfinite(res["losses"]["loss"])
    assert 0.0 <= res["val"]["val/harmonic_iou"] <= 1.0 or np.isnan(res["val"]["val/harmonic_iou"])
    ckpt = torch.load(res["checkpoint"], map_location="cpu", weights_only=True)
    assert ckpt["step"] == 2 and set(ckpt) == {"model", "optimizer", "step"}
    assert "binary_mlp.s3_fc0.weight" in ckpt["model"]


def test_bridge_takes_a_train_initialised_tree():
    """A training tree of the flagship encoder holds the query heads of all
    four scales and the batch statistics; every leaf lands once, and the
    port's state_dict is covered with nothing optional."""
    cur, src = synthetic_bd_batch(batch=1, num_src=K, height=64, width=96, num_rays=16,
                                  samples_per_ray=8, seed=0)
    jnet = JBDNet(num_src_views=K, num_depth_bins=D_BINS, train_bn=True)
    variables = to_numpy_tree(seeded_variables(
        lambda key, c, s: jnet.init({"params": key}, c, s, flip=False), cur, src, seed=3))
    assert {"s1_fc0", "s2_fc0", "s3_fc0"} <= set(variables["params"]["binary_mlp"])
    sd = state_dict_from_flax(variables)
    assert len(sd) == len(jax.tree_util.tree_leaves(variables))
    net = BDNet(num_src_views=K, num_depth_bins=D_BINS)
    assert set(sd) == set(net.state_dict())
    load_state_dict(net, sd)
    np.testing.assert_array_equal(
        net.encoder.s5_b0.bn1.running_var.numpy(),
        variables["batch_stats"]["encoder"]["s5_b0"]["bn1"]["BatchNorm_0"]["var"])
