"""Port parity for the temporal model's prior channel against the JAX
package, on the CPU in f32: `forward_val` with and without a prior,
`sample_prior`, the prior's training augmentation and the BD train step of
a net with the prior, `build_net` on the temporal config, and
`lazy_load_state_dict`.

Sizes follow tests/test_torch_bd_net.py and tests/test_torch_train.py: the
tiny encoder, K=2 source views, 8 planes, 64x96 images. Tolerances:
- forward_val: 5e-5 of the largest reference logit, as
  tests/test_torch_bd_net.py (f32 sums in another order).
- sample_prior: the warped coordinates agree to f32 rounding, so a nearest
  sample may take the neighbouring pixel where a coordinate sits on a
  pixel boundary; all but 1e-3 of the pixels are equal.
- The train step (flip on): the JAX reference is built from the JAX
  model's own methods (`trunk`, the sampling of run_mlp_train,
  `binary_mlp.factored`) with the same augmented priors handed in, and run
  in float64 (jax.enable_x64), as tests/test_torch_regression_train.py;
  the losses 1e-5 relative, the updated batch statistics 1e-5, every
  parameter's gradient within 2e-2 of its largest value (+1e-8 for the
  head biases that instance norm cancels) and the median within 1e-3, the
  bounds of tests/test_torch_train.py. Why float64: here the JAX package's
  own f32 step is the noisier side (worst parameter 2.3e-2 from float64,
  median 3.1e-4, against the port's 1.7e-2 and 1.9e-5): f32 rounding
  amplified through the backward of ~40 layers. The augmentation itself is
  checked by its statistics and against its formula, never against JAX's
  random stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_depth_tpu.core.sampling import grid_sample as jgrid_sample
from implicit_depth_tpu.models.bd_net import SCALES
from implicit_depth_tpu.models.bd_net import BDNet as JBDNet
from implicit_depth_tpu.ops import image as jimage
from implicit_depth_tpu.train import losses as jlosses
from implicit_depth_tpu.utils.fixtures import synthetic_bd_batch
from implicit_depth_tpu_torch.models.bd_net import (TRAIN_ONLY_PREFIXES, BDNet, augment_prior,
                                                    draw_prior_noise, prior_noise_shapes)
from implicit_depth_tpu_torch.models.depth_net import DepthNet
from implicit_depth_tpu_torch.train import state
from implicit_depth_tpu_torch.weights import (init_params, lazy_load_state_dict, load_state_dict,
                                              state_dict_from_flax)
from tests.torch_parity import (assert_close, assert_grad_tree_close, assert_tree_close, bridged,
                                seeded_variables, to_numpy_tree)

K, D_BINS, N_PLANES = 2, 8, 3


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """`pytest -n 6` puts six test processes on the host's cores. With
    torch's OpenMP pool at one thread per core in each, the cores are
    oversubscribed and every parallel op's barrier waits on descheduled
    threads (a tiny train step took 60x longer beside a second such
    process). Two threads in this module's process."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _torch(d):
    return {k: torch.tensor(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def eval_case():
    cur, src = synthetic_bd_batch(batch=1, num_src=K, height=64, width=96, num_planes=N_PLANES,
                                  with_train_keys=False, seed=0)
    h0, w0 = cur["rendered_depth"].shape[1:3]
    rng = np.random.RandomState(3)
    cur["prior_prediction"] = rng.rand(1, h0, w0, 1).astype(np.float32)
    # the prior seen from a camera 0.6 m to the side: part of the view falls
    # outside the prior's frame
    cur["prior_cam_T_world"] = cur["cam_T_world"].copy()
    cur["prior_cam_T_world"][:, 0, 3] += 0.6
    jnet = JBDNet(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny",
                  use_prior=True)
    variables = seeded_variables(
        lambda key, c, s: jnet.init({"params": key}, c, s, method=JBDNet.forward_val),
        cur, src, seed=13)
    net = bridged(BDNet(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny",
                        use_prior=True), variables, TRAIN_ONLY_PREFIXES)
    return cur, src, jnet, variables, net


@pytest.mark.parametrize("given", [True, False], ids=["prior", "noprior"])
def test_forward_val_with_prior_matches_jax(eval_case, given):
    cur, src, jnet, variables, net = eval_case
    if not given:
        cur = {k: v for k, v in cur.items() if not k.startswith("prior_")}
    ref = jax.jit(lambda v, c, s: jnet.apply(v, c, s, method=JBDNet.forward_val))(
        variables, cur, src)
    with torch.no_grad():
        got = net.forward_val(_torch(cur), _torch(src))
    assert got["pred_0"].shape == (1, 32, 48, N_PLANES)
    assert net.binary_mlp.s0_fc0.weight.shape == (128, 64 + 2)  # depth, features, prior
    assert_close(got["pred_0"], ref["pred_0"], 5e-5)


def test_sample_prior_matches_jax(eval_case):
    cur, _, jnet, variables, net = eval_case
    args = (cur["rendered_depth"][..., 1:2], cur["prior_prediction"], cur["world_T_cam"],
            cur["prior_cam_T_world"], cur["K_s0"], cur["invK_s0"])
    ref = np.asarray(jnet.apply(variables, *args, method=JBDNet.sample_prior))
    got = net.sample_prior(*(torch.tensor(a) for a in args)).numpy()
    assert got.shape == ref.shape == (1, 32, 48, 1)
    assert 0.05 < (ref == 0).mean() < 0.95  # outside the prior's frame: zero padding
    assert (got == ref).mean() >= 1 - 1e-3
    rendered = torch.tensor(args[0]).clone()
    rendered[0, :5] = 0.0  # no rendered depth: no prior
    assert (net.sample_prior(rendered, *(torch.tensor(a) for a in args[1:]))[0, :5] == -1).all()


def test_prior_augmentation_statistics():
    """25% of the priors are -1, 25% are flipped, and the rest sit within
    0.45 of the ground-truth occupancy; augment_prior is its formula."""
    gen = torch.Generator().manual_seed(4)
    shape = (2, 3000, 64)
    noise = draw_prior_noise(shape, torch.float32, gen)
    assert [u.shape for u, _ in noise] == [torch.Size(s) for s in prior_noise_shapes(shape)]
    assert [s[1] for s in prior_noise_shapes(shape)] == [3000, 1500, 1000, 750]
    rng = np.random.RandomState(5)
    depths = torch.tensor(rng.uniform(0.3, 5.0, shape).astype(np.float32))
    target = torch.tensor(rng.uniform(0.5, 4.5, shape[:2]).astype(np.float32))
    u, p = noise[0]
    prior = augment_prior(depths, target, u, p).numpy()
    occ = (depths < target[..., None]).numpy()
    un, pn = u.numpy(), p.numpy()
    ref = np.where(occ, 1.0 - 0.45 * un, 0.45 * un)
    ref = np.where(pn < 0.5, 1.0 - ref, ref)
    np.testing.assert_allclose(prior, np.where(pn < 0.25, -1.0, ref), rtol=0, atol=1e-7)
    none = prior == -1
    flipped = ~none & ((prior > 0.5) != occ)
    assert abs(none.mean() - 0.25) < 0.01 and abs(flipped.mean() - 0.25) < 0.01
    dist = np.where(prior > 0.5, 1.0 - prior, prior)[~none]
    assert dist.min() >= 0.0 and dist.max() <= 0.45 + 1e-6 and dist.mean() > 0.2
    bf = draw_prior_noise(shape, torch.bfloat16, gen)
    assert all(u.dtype == torch.bfloat16 for pair in bf for u in pair)
    assert augment_prior(depths, target, *bf[0]).dtype == torch.bfloat16


def _jax_augment(sub_depths, sub_target, u, p):
    prior = (sub_depths < sub_target[..., None]).astype(u.dtype)
    prior = jnp.where(prior == 1.0, prior - u * 0.45, prior + u * 0.45)
    prior = jnp.where(p < 0.5, 1.0 - prior, prior)
    return jnp.where(p < 0.25, -1.0, prior)


def _jax_prior_forward(module, cur, src, noise, flip):
    """The JAX model's train forward with the priors made from `noise` by
    the augmentation's formula: `trunk`, run_mlp_train's sampling,
    `binary_mlp.factored`."""
    t = module.trunk(cur, src, flip)
    gt = cur["gt_depth"]
    hg, wg = gt.shape[1], gt.shape[2]
    rays, depths = cur["sampled_rays"], cur["sampled_depths"]
    grid = jnp.stack([(rays[..., 0] / wg - 0.5) * 2.0, (rays[..., 1] / hg - 0.5) * 2.0], -1)
    target = jgrid_sample(gt, grid[:, :, None], mode="bilinear")[:, :, 0, 0]
    feats, sub_depths, priors = [], [], []
    for scale in SCALES:
        feats.append(jgrid_sample(t["features"][scale], grid[:, :: scale + 1][:, :, None],
                                  mode="bilinear")[:, :, 0])
        sub_depths.append(depths[:, :: scale + 1])
        priors.append(_jax_augment(sub_depths[-1], target[:, :: scale + 1], *noise[scale]))
    preds = module.binary_mlp.factored(feats, sub_depths, priors)
    out = {"target_depth": target, "query_depth": depths}
    out.update({k: v[..., 0] for k, v in preds.items()})
    return out


def test_prior_train_step_matches_jax():
    cur, src = synthetic_bd_batch(batch=2, num_src=K, height=64, width=96, num_planes=3,
                                  num_rays=64, samples_per_ray=8, seed=0)
    jnet = JBDNet(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny",
                  train_bn=True, use_prior=True)
    variables = seeded_variables(
        lambda key, c, s: jnet.init({"params": key, "aug": key}, c, s, flip=False),
        cur, src, seed=23)
    rng = np.random.RandomState(6)
    noise = [tuple(rng.rand(*shape).astype(np.float32) for _ in range(2))
             for shape in prior_noise_shapes(cur["sampled_depths"].shape)]
    flip = True

    def loss_fn(params, batch_stats, cur, src, noise):
        gt, rays = cur["gt_depth"], cur["sampled_rays"]
        grid = jnp.stack([(rays[..., 0] / gt.shape[2] - 0.5) * 2,
                          (rays[..., 1] / gt.shape[1] - 0.5) * 2], -1)
        edge = jgrid_sample(jimage.get_edge_mask(gt), grid[:, :, None],
                            mode="nearest")[:, :, 0, 0][..., None]
        out, mutated = jnet.apply({"params": params, "batch_stats": batch_stats},
                                  cur, src, noise, flip, method=_jax_prior_forward,
                                  mutable=["batch_stats"])
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
            *(f64(x) for x in (variables["params"], variables["batch_stats"], cur, src, noise)))
        batch_stats, ref_losses, grads = (to_numpy_tree(x)
                                          for x in (batch_stats, ref_losses, grads))

    net = BDNet(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny",
                use_prior=True)
    load_state_dict(net, state_dict_from_flax(to_numpy_tree(variables)))
    opt, sched = state.make_optimizer(net.parameters(), 1e-3, 1e-4)
    step = state.make_bd_train_step(net, opt, sched)
    got = step((_torch(cur), _torch(src)), flip=flip,
               prior_noise=[tuple(torch.tensor(u) for u in pair) for pair in noise])
    assert sorted(got) == sorted(ref_losses)
    for k in ref_losses:
        assert_close(got[k], ref_losses[k], 1e-5)
    rel_errs = assert_grad_tree_close(grads, net, 2e-2, atol=1e-8)
    assert np.median(list(rel_errs.values())) <= 1e-3
    assert net.binary_mlp.s3_fc0.weight.grad[:, -1].abs().max() > 0  # the prior row learns
    running = {k: v for k, v in net.state_dict().items()
               if k.endswith(("running_mean", "running_var"))}
    assert_tree_close(batch_stats, "batch_stats", running, 1e-5)


def test_train_step_draws_the_prior_on_the_batch_device():
    """Without given draws the step draws them from its own generator: the
    same state and seed give the same loss."""
    cur, src = synthetic_bd_batch(batch=1, num_src=K, height=64, width=96, num_planes=3,
                                  num_rays=16, samples_per_ray=8, seed=1)
    losses = []
    for _ in range(2):
        net = init_params(BDNet(num_src_views=K, num_depth_bins=D_BINS,
                                image_encoder_name="tiny", use_prior=True),
                          torch.Generator().manual_seed(0))
        opt, sched = state.make_optimizer(net.parameters())
        step = state.make_bd_train_step(net, opt, sched,
                                        generator=torch.Generator().manual_seed(3))
        losses.append(float(step((_torch(cur), _torch(src)), flip=False)["loss"]))
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    with pytest.raises(ValueError):
        net(_torch(cur), _torch(src))  # a net with the prior needs its draws


def test_build_net_builds_the_temporal_config():
    from implicit_depth_tpu_torch.config import parse_config
    from implicit_depth_tpu_torch.train.loop import build_net

    cfg, _ = parse_config(["--config_file", "configs/models/implicit_depth_temporal.yaml",
                           "--image_encoder_name", "tiny"])
    net = build_net(cfg)
    assert net.use_prior and net.compute_dtype == torch.bfloat16
    assert [net.binary_mlp.get_submodule(f"s{s}_fc0").in_features for s in SCALES] == [
        66, 66, 130, 258]
    assert set(init_params(net, torch.Generator().manual_seed(0)).state_dict()) == set(
        net.state_dict())


def test_lazy_load_copies_matching_names_and_shapes():
    """From a DepthNet's state_dict into the BD model with the prior: every
    key with the same name and shape is copied, nothing else moves."""
    source = init_params(DepthNet(num_src_views=K, num_depth_bins=D_BINS,
                                  image_encoder_name="tiny"), torch.Generator().manual_seed(1))
    target = init_params(BDNet(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny",
                               use_prior=True), torch.Generator().manual_seed(2))
    src_sd = source.state_dict()
    before = {k: v.clone() for k, v in target.state_dict().items()}
    src_sd["encoder.no_such_layer.weight"] = torch.zeros(3)
    src_sd["cv_encoder.ds_conv_0.conv1.weight"] = torch.zeros(1, 2, 3, 3)  # a shape that differs
    n = lazy_load_state_dict(target, src_sd)
    after = target.state_dict()
    matched = {k for k, v in src_sd.items() if k in before and before[k].shape == v.shape}
    assert n == len(matched) > 50
    assert "cv_encoder.ds_conv_0.conv1.weight" not in matched
    assert not any(k.startswith("binary_mlp.") for k in matched)
    for k, v in after.items():
        torch.testing.assert_close(v, src_sd[k] if k in matched else before[k], rtol=0, atol=0)


def test_fit_starts_the_temporal_model_from_a_regression_model(tmp_path, capsys):
    """cli/train_bd.py on the temporal config with
    --lazy_load_weights_from_checkpoint: one step, seeded from a DepthNet."""
    from implicit_depth_tpu_torch.cli import train_bd
    from implicit_depth_tpu_torch.train.checkpoint import load_weights

    reg = init_params(DepthNet(num_src_views=2, num_depth_bins=64, image_encoder_name="tiny"),
                      torch.Generator().manual_seed(1))
    ckpt = str(tmp_path / "regression.pt")
    torch.save({"model": reg.state_dict()}, ckpt)
    res = train_bd.main([
        "--config_file", "configs/models/implicit_depth_temporal.yaml",
        "--data_config_file", "configs/data/synthetic_smoke.yaml", "--device", "cpu",
        "--max_steps", "1", "--image_encoder_name", "tiny", "--precision", "32",
        "--model_num_views", "3", "--batch_size", "2", "--log_dir", str(tmp_path),
        "--num_workers", "2", "--val_batches", "1", "--synthetic_num_frames", "6",
        "--lazy_load_weights_from_checkpoint", ckpt])
    assert res["step"] == 1 and np.isfinite(res["losses"]["loss"])
    assert "lazy-loaded" in capsys.readouterr().out
    model = load_weights(res["checkpoint"])  # the checkpoint directory's model
    assert model["binary_mlp.s0_fc0.weight"].shape == (128, 66)
    # one AdamW step at lr 1e-4 moves a weight by about 1e-4: the encoder's
    # weights are the regression model's
    for key in ("encoder.conv1.weight", "matching.conv1.weight"):
        torch.testing.assert_close(model[key], reg.state_dict()[key], rtol=0, atol=2e-4)
