"""Port parity: BDNet.forward_val and the weight bridge.

The JAX package runs its CPU path (f32, unfused volume); the port runs on
CPU tensors, so its volume is the fused kernel's plain version. Sizes follow
tests/test_bd_net.py: 64x96 images, K=2 source views, 8 depth bins, 3
query planes.

Tolerance on the logits `pred_0`: 5e-5 of the largest reference logit
(measured 2.2e-6 with the tiny encoder and 1.2e-6 with EfficientNetV2-S:
f32 sums in another order through ~60 layers).
`lowest_cost` is the depth of the arg-max plane: the same plane on every
pixel (1e-6 relative: a plane's depth may differ in the last f32 bit).
"""

import jax
import numpy as np
import pytest
import torch

from implicit_depth_tpu.models.bd_net import BDNet as JBDNet
from implicit_depth_tpu.utils.fixtures import synthetic_bd_batch
from implicit_depth_tpu_torch.models.bd_net import TRAIN_ONLY_PREFIXES, BDNet
from implicit_depth_tpu_torch.models.matching import BatchNorm
from implicit_depth_tpu_torch.weights import load_state_dict, state_dict_from_flax
from tests.torch_parity import assert_close, seeded_variables, to_numpy_tree

K, D_BINS, N_PLANES = 2, 8, 3


@pytest.fixture(scope="module")
def batch():
    return synthetic_bd_batch(batch=1, num_src=K, height=64, width=96, num_planes=N_PLANES,
                              num_rays=16, samples_per_ray=8, seed=0)


def _torch_batch(d):
    return {k: torch.tensor(v) for k, v in d.items()}


def _eval_variables(jnet, cur, src, seed):
    return seeded_variables(
        lambda key, c, s: jnet.init({"params": key}, c, s, method=JBDNet.forward_val),
        cur, src, seed=seed)


@pytest.mark.parametrize("encoder", ["tiny", "efficientnet"])
def test_forward_val_matches_jax(batch, encoder):
    cur, src = batch
    jnet = JBDNet(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name=encoder)
    variables = _eval_variables(jnet, cur, src, seed=11)
    ref = jax.jit(lambda v, c, s: jnet.apply(v, c, s, method=JBDNet.forward_val))(
        variables, cur, src)

    net = BDNet(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name=encoder)
    load_state_dict(net, state_dict_from_flax(to_numpy_tree(variables)), TRAIN_ONLY_PREFIXES)
    with torch.no_grad():
        got = net.eval().forward_val(_torch_batch(cur), _torch_batch(src))
    assert got["pred_0"].shape == (1, 32, 48, N_PLANES)
    assert_close(got["pred_0"], ref["pred_0"], 5e-5)
    np.testing.assert_allclose(got["lowest_cost"].numpy(), np.asarray(ref["lowest_cost"]),
                               rtol=1e-6)


def test_bridge_consumes_every_leaf(batch):
    cur, src = batch
    jnet = JBDNet(num_src_views=K, num_depth_bins=D_BINS)
    variables = to_numpy_tree(_eval_variables(jnet, cur, src, seed=1))
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    sd = state_dict_from_flax(variables)
    assert len(sd) == n_leaves
    net = BDNet(num_src_views=K, num_depth_bins=D_BINS)
    model_keys = set(net.state_dict())
    assert set(sd) <= model_keys
    assert all(k.startswith(TRAIN_ONLY_PREFIXES) for k in model_keys - set(sd))
    # depthwise conv and BN leaves land where they should
    dw = variables["params"]["encoder"]["s3_b0"]["conv_dw"]["kernel"]
    np.testing.assert_array_equal(sd["encoder.s3_b0.conv_dw.weight"].numpy(),
                                  dw.transpose(3, 2, 0, 1))
    assert sd["encoder.s3_b0.conv_dw.weight"].shape[1:] == (1, 3, 3)
    np.testing.assert_array_equal(
        sd["matching.bn1.running_var"].numpy(),
        variables["batch_stats"]["matching"]["bn1"]["BatchNorm_0"]["var"])
    assert sd["volume_mlp.fc0_kernel"].shape == (72, 128)  # raw (in, out), k=2


def test_bridge_rejects_unknown_leaves():
    with pytest.raises(KeyError):
        state_dict_from_flax({"params": {"encoder": {"conv": {"weird": np.zeros(3)}}}})
    with pytest.raises(KeyError):
        state_dict_from_flax({"intermediates": {"x": np.zeros(3)}})
    sd = state_dict_from_flax({"params": {"no_such_module": {"kernel": np.zeros((2, 3))}}})
    with pytest.raises(KeyError):
        load_state_dict(BDNet(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny"),
                        sd, TRAIN_ONLY_PREFIXES)


def test_bridge_loads_train_initialised_tree(batch):
    """A training tree holds the query heads of all four scales; it loads
    strictly, with nothing optional."""
    cur, src = batch
    jnet = JBDNet(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny")
    variables = seeded_variables(lambda key, c, s: jnet.init({"params": key}, c, s, flip=False),
                                 cur, src, seed=2)
    assert "s3_fc0" in variables["params"]["binary_mlp"]
    net = BDNet(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny")
    load_state_dict(net, state_dict_from_flax(to_numpy_tree(variables)))
    np.testing.assert_array_equal(
        net.binary_mlp.s3_fc0.weight.detach().numpy(),
        np.asarray(variables["params"]["binary_mlp"]["s3_fc0"]["kernel"]).T)


def test_warm_forward_val_equals_the_grad_enabled_eval(batch):
    """Eval batch norm's cached scale and shift (models/matching.py::BatchNorm):
    a warm bf16 forward_val under inference_mode gives the grad-enabled eval
    answer, which computes them on every call, bit for bit."""
    cur, src = (_torch_batch(d) for d in batch)
    with torch.random.fork_rng():
        torch.manual_seed(5)
        net = BDNet(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny",
                    compute_dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                for t in (m.weight, m.bias, m.running_mean):
                    t.copy_(torch.randn(t.shape, generator=g) * 0.2 + (t is m.weight))
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
    net.eval().cast_to_compute_dtype()
    with torch.enable_grad():
        ref = net.forward_val(cur, src)
    with torch.inference_mode():
        net.forward_val(cur, src)
        warm = net.forward_val(cur, src)
    for key in ("pred_0", "lowest_cost"):
        assert torch.equal(warm[key], ref[key].detach())
