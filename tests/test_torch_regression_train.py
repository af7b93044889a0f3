"""Port parity: the depth-regression slice against the JAX package on the
CPU, in f32.

- ops/image.py: gaussian_blur, blur_pool, pyrdown, normals_from_depth; 1e-5
  of the largest value (f32 depthwise convs summed in another order).
- The nearest upsample of the lower-scale log depths equals
  jax.image.resize(method="nearest") exactly, and is index i // f at an
  integer factor f.
- Each regression loss and `regression_losses` (scannet and hypersim), with
  NaN-invalid GT depths and a partly False mask on both sides: 1e-5
  relative.
- compute_depth_metrics_batched and regression_plane_scores: 1e-5 relative,
  NaN in the same places.
- One whole regression train step (tiny DepthNet, K=2, D=8, 64x96, b=2,
  train-mode batch norm), flip off and on, against net.apply(mutable=
  ["batch_stats"]) + regression_losses + jax.value_and_grad run in float64
  (jax.enable_x64): every loss and the updated batch statistics 1e-5
  relative; the gradient of every parameter within 1e-2 of its largest
  value (+5e-8 for biases that instance norm cancels: both sides hold
  rounding noise of ~1e-8 there), the median over
  parameters within 1e-3. Why float64: the JAX package's own f32 step is
  the noisier side here (worst parameter 4.2e-2 from float64 without flip,
  3.9e-2 with it, against the port's 7.7e-4 and 4.9e-3): the sobel
  gradients of the depth losses and f32 rounding amplified through the
  backward of ~40 layers. The parameters after the AdamW step equal
  optax.adamw applied to the port's own gradients (1e-6), as in
  tests/test_torch_train.py.
The CLIs of the slice are tested in tests/test_torch_regression_cli.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_depth_tpu.eval import binary_metrics as jbm
from implicit_depth_tpu.eval import metrics as jmetrics
from implicit_depth_tpu.models.depth_net import DepthNet as JDepthNet
from implicit_depth_tpu.ops import image as jimage
from implicit_depth_tpu.train import losses as jlosses
from implicit_depth_tpu.train import state as jstate
from implicit_depth_tpu.utils.fixtures import synthetic_bd_batch
from implicit_depth_tpu_torch.eval import binary_metrics as bm
from implicit_depth_tpu_torch.eval import metrics
from implicit_depth_tpu_torch.models.depth_net import DepthNet
from implicit_depth_tpu_torch.ops import image
from implicit_depth_tpu_torch.train import losses, state
from implicit_depth_tpu_torch.weights import load_state_dict, state_dict_from_flax
from tests.torch_parity import (assert_close, assert_grad_tree_close, assert_tree_close,
                                flax_tree_from_port, seeded_variables, t, to_numpy_tree)

K, D_BINS = 2, 8
LR, WD = 1e-3, 1e-4


def _depth(shape, seed, nan_frac=0.0):
    rng = np.random.RandomState(seed)
    d = rng.uniform(0.5, 4.0, shape).astype(np.float32)
    d[rng.rand(*shape) < nan_frac] = np.nan
    return d


def _assert_same(got, ref, rel=1e-5):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    if np.isfinite(ref).any():
        assert_close(np.nan_to_num(got), np.nan_to_num(ref), rel)


def test_blur_pyramid_and_normals_match_jax():
    x = np.random.RandomState(0).randn(2, 24, 36, 3).astype(np.float32)
    assert_close(image.gaussian_blur(t(x)), jimage.gaussian_blur(jnp.asarray(x)), 1e-5)
    assert_close(image.blur_pool(t(x)), jimage.blur_pool(jnp.asarray(x)), 1e-5)
    got, ref = image.pyrdown(t(x)), jimage.pyrdown(jnp.asarray(x))
    assert [g.shape for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref, strict=True):
        assert_close(g, r, 1e-5)
    depth = _depth((2, 24, 36, 1), 1)
    invK = np.linalg.inv(np.array([[30.0, 0, 18, 0], [0, 28.0, 12, 0], [0, 0, 1, 0],
                                   [0, 0, 0, 1]], np.float32))[None].repeat(2, 0)
    assert_close(image.normals_from_depth(t(depth), t(invK)),
                 jimage.normals_from_depth(jnp.asarray(depth), jnp.asarray(invK)), 1e-5)


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_nearest_upsample_is_jax_resize(factor):
    x = np.random.RandomState(factor).randn(2, 5, 7, 1).astype(np.float32)
    h, w = 5 * factor, 7 * factor
    got = losses.upsample_nearest(t(x), h, w).numpy()
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, h, w, 1), method="nearest"))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, x[:, np.arange(h) // factor][:, :, np.arange(w) // factor])


@pytest.fixture(scope="module")
def loss_case():
    """A NaN-masked regression batch and a prediction at four scales."""
    rng = np.random.RandomState(7)
    cur, src = synthetic_bd_batch(batch=2, num_src=K, height=64, width=96, with_train_keys=True,
                                  num_rays=4, samples_per_ray=2, seed=3)
    depth = _depth((2, 32, 48, 1), 4, nan_frac=0.1)
    depth[0, :6, :10] = np.nan
    cur["depth"] = depth
    cur["mask"] = np.isfinite(depth) & (depth > 0)
    cur["normals"] = np.asarray(jimage.normals_from_depth(
        jnp.nan_to_num(jnp.asarray(depth), nan=0.0), jnp.asarray(cur["invK_s0"])))
    src["depth"] = _depth((2, K, 32, 48, 1), 5, nan_frac=0.2)
    out = {f"log_depth_pred_{s}": (0.3 * rng.randn(2, 32 >> s, 48 >> s, 1) + 0.7).astype(np.float32)
           for s in range(4)}
    out["depth_pred_0"] = np.exp(out["log_depth_pred_0"])
    out["normals_pred"] = np.asarray(jimage.normals_from_depth(
        jnp.asarray(out["depth_pred_0"]), jnp.asarray(cur["invK_s0"])))
    return cur, src, out


def test_each_regression_loss_matches_jax(loss_case):
    cur, src, out = loss_case
    mask = cur["mask"]
    log_gt = np.log(np.where(mask, cur["depth"], 1.0))
    j = {k: jnp.asarray(v) for k, v in out.items()}
    _assert_same(losses.scale_invariant_loss(t(log_gt), t(out["log_depth_pred_0"]), t(mask, torch.bool)),
                 jlosses.scale_invariant_loss(jnp.asarray(log_gt), j["log_depth_pred_0"],
                                              jnp.asarray(mask)))
    _assert_same(losses.ms_gradient_loss(t(cur["depth"]), t(out["depth_pred_0"])),
                 jlosses.ms_gradient_loss(jnp.asarray(cur["depth"]), j["depth_pred_0"]))
    _assert_same(losses.normals_loss(t(cur["normals"]), t(out["normals_pred"])),
                 jlosses.normals_loss(jnp.asarray(cur["normals"]), j["normals_pred"]))
    _assert_same(
        losses.mv_depth_loss(t(out["depth_pred_0"]), t(src["depth"]), t(cur["invK_s0"]),
                             t(src["K_s0"]), t(cur["world_T_cam"]), t(src["cam_T_world"])),
        jlosses.mv_depth_loss(j["depth_pred_0"], jnp.asarray(src["depth"]),
                              jnp.asarray(cur["invK_s0"]), jnp.asarray(src["K_s0"]),
                              jnp.asarray(cur["world_T_cam"]), jnp.asarray(src["cam_T_world"])))


def test_scale_invariant_loss_goes_nan_on_both_sides():
    """sqrt of a negative mean: NaN in both frameworks."""
    log_gt = np.zeros((1, 2, 2, 1), np.float32)
    log_pred = np.full((1, 2, 2, 1), -1.0, np.float32)
    mask = np.ones((1, 2, 2, 1), bool)
    got = losses.scale_invariant_loss(t(log_gt), t(log_pred), t(mask, torch.bool), si_lambda=2.0)
    ref = jlosses.scale_invariant_loss(jnp.asarray(log_gt), jnp.asarray(log_pred),
                                       jnp.asarray(mask), si_lambda=2.0)
    assert np.isnan(float(got)) and np.isnan(float(ref))


@pytest.mark.parametrize("dataset", ["scannet", "hypersim"])
def test_regression_losses_match_jax(loss_case, dataset):
    cur, src, out = loss_case
    ref = jlosses.regression_losses({k: jnp.asarray(v) for k, v in cur.items()},
                                    {k: jnp.asarray(v) for k, v in src.items()},
                                    {k: jnp.asarray(v) for k, v in out.items()}, dataset=dataset)
    tcur = {k: torch.tensor(v) for k, v in cur.items()}
    got = losses.regression_losses(tcur, {k: torch.tensor(v) for k, v in src.items()},
                                   {k: torch.tensor(v) for k, v in out.items()}, dataset=dataset)
    assert sorted(got) == sorted(ref)
    for k in ref:
        _assert_same(got[k], ref[k])
    assert np.isfinite(float(got["loss"]))


def test_depth_metrics_and_plane_scores_match_jax():
    rng = np.random.RandomState(9)
    gt = _depth((3, 40), 10, nan_frac=0.2)
    gt[2] = np.nan  # an all-invalid row: NaN metrics on both sides
    pred = rng.uniform(0.4, 4.5, (3, 40)).astype(np.float32)
    valid = np.nan_to_num(gt, nan=0.0) > 0.5
    gt1 = np.nan_to_num(gt, nan=1.0)
    for mult_a in (False, True):
        ref = jmetrics.compute_depth_metrics_batched(jnp.asarray(gt1), jnp.asarray(pred),
                                                     jnp.asarray(valid), mult_a=mult_a)
        got = metrics.compute_depth_metrics_batched(t(gt1), t(pred), t(valid, torch.bool),
                                                    mult_a=mult_a)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].shape == (3,)
            _assert_same(got[k], ref[k])

    gt_map = _depth((2, 6, 8, 1), 11, nan_frac=0.1)
    pred_map = rng.uniform(0.4, 4.5, (2, 6, 8, 1)).astype(np.float32)
    query = np.broadcast_to(np.linspace(1.5, 5.0, 8, dtype=np.float32), (2, 6, 8, 8)).copy()
    ref = jbm.regression_plane_scores(jnp.asarray(query), jnp.asarray(gt_map),
                                      jnp.asarray(pred_map))
    got = bm.regression_plane_scores(t(query), t(gt_map), t(pred_map))
    for k in ref:
        _assert_same(got[k], ref[k])


# ------------------------------------------------------------ train step

def _regression_batch():
    cur, src = synthetic_bd_batch(batch=2, num_src=K, height=64, width=96, num_rays=4,
                                  samples_per_ray=2, seed=0)
    depth = cur["depth"]
    depth[0, :5, :7] = np.nan
    depth[1, 20:, 40:] = np.nan
    cur["mask"] = np.isfinite(depth)
    src["depth"][0, 1, :8] = np.nan
    cur = {k: v for k, v in cur.items() if k not in ("gt_depth", "sampled_rays", "sampled_depths")}
    return cur, src


@pytest.fixture(scope="module")
def train_case():
    cur, src = _regression_batch()
    jnet = JDepthNet(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny",
                     train_bn=True)
    variables = seeded_variables(lambda key, c, s: jnet.init({"params": key}, c, s), cur, src,
                                 seed=21)
    return cur, src, jnet, variables


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64)
                        if np.asarray(x).dtype == np.float32 else np.asarray(x), tree)


@pytest.fixture(scope="module")
def jax_step_f64(train_case):
    """flip -> (losses, grads, batch_stats) of the loss function of
    make_regression_train_step, differentiated in float64 (numpy trees).
    flip is traced, so both flips share one compile."""
    cur, src, jnet, variables = train_case

    def loss_fn(params, batch_stats, cur, src, flip):
        depth_nan = jnp.where(cur["mask"], cur["depth"], jnp.nan)
        cur = dict(cur, normals=jimage.normals_from_depth(jnp.nan_to_num(depth_nan, nan=0.0),
                                                          cur["invK_s0"]))
        out, mutated = jnet.apply({"params": params, "batch_stats": batch_stats},
                                  cur, src, flip=flip, mutable=["batch_stats"])
        out = dict(out)
        out["normals_pred"] = jimage.normals_from_depth(out["depth_pred_0"], cur["invK_s0"])
        ls = jlosses.regression_losses(cur, src, out)
        return ls["loss"], (mutated["batch_stats"], ls)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    def run(flip):
        with jax.enable_x64(True):
            v, c, s = (jax.tree.map(jnp.asarray, _f64(x)) for x in (variables, cur, src))
            (_, (batch_stats, ls)), grads = grad_fn(v["params"], v["batch_stats"], c, s,
                                                    jnp.asarray(flip))
            return to_numpy_tree(ls), to_numpy_tree(grads), to_numpy_tree(batch_stats)

    return run


def _running_stats(module) -> dict:
    return {k: v for k, v in module.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("flip", [False, True], ids=["noflip", "flip"])
def test_regression_train_step_matches_jax(train_case, jax_step_f64, flip):
    cur, src, _, variables = train_case
    ref_losses, grads, batch_stats = jax_step_f64(flip)

    net = DepthNet(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny")
    load_state_dict(net, state_dict_from_flax(to_numpy_tree(variables)))
    opt, sched = state.make_optimizer(net.parameters(), LR, WD)
    step = state.make_regression_train_step(net, opt, sched)
    got = step(({k: torch.tensor(v) for k, v in cur.items()},
                {k: torch.tensor(v) for k, v in src.items()}), flip=flip)

    assert sorted(got) == sorted(ref_losses)
    for k in ref_losses:
        assert_close(got[k], ref_losses[k], 1e-5)
    rel_errs = assert_grad_tree_close(grads, net, 1e-2, atol=5e-8)
    assert np.median(list(rel_errs.values())) <= 1e-3
    assert_tree_close(batch_stats, "batch_stats", _running_stats(net), 1e-5)
    port_grads = flax_tree_from_port(variables["params"], "params",
                                     {n: p.grad for n, p in net.named_parameters()})
    st = jstate.create_train_state(variables, jstate.make_optimizer(LR, WD, (70000, 80000)))
    expected = st.apply_gradients(port_grads, jax.tree.map(np.float32, batch_stats)).params
    assert_tree_close(expected, "params", dict(net.named_parameters()), 1e-6)
