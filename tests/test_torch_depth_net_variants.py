"""Port parity for DepthNet built from the encoder zoo and the skip decoder
(model (a) of tests/test_torch_model_variants.py: `resnet18d`, `fpn`,
`skip` with its regression heads) against the JAX package on the CPU in
f32.

- DepthNet's forward (flip on, eval-mode batch norm): 1e-4 of the largest
  reference value per output; `lowest_cost` on the same plane (1e-6).
- One regression step (flip on, train-mode batch norm) against
  net.apply(mutable=["batch_stats"]) + regression_losses +
  jax.value_and_grad in float64 (jax.enable_x64): losses and batch
  statistics 1e-5 relative; the parameters after AdamW equal optax.adamw
  applied to the port's gradients (1e-6). The gradients: relative L2 error
  over all parameters 5e-3, the median over parameters of max|err| /
  max|ref| 1e-3 and the worst 2e-1, for the reason
  tests/test_torch_model_variants.py gives (MNASNet's train-mode batch
  norm at 36 values a channel). Measured against float64: the JAX
  package's own f32 step relative L2 2.1e-3, median 1.2e-5, worst 1.9e-1,
  98 of 348 parameters beyond 1e-2 of their largest value; the port's
  1.4e-3, 6.6e-6, 7.5e-2, 38 beyond 1e-2.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from implicit_depth_tpu.models.depth_net import DepthNet as JDepthNet
from implicit_depth_tpu.ops import image as jimage
from implicit_depth_tpu.train import losses as jlosses
from implicit_depth_tpu.train import state as jstate
from implicit_depth_tpu_torch.models import decoders
from implicit_depth_tpu_torch.models.depth_net import DepthNet
from implicit_depth_tpu_torch.train import state
from implicit_depth_tpu_torch.weights import load_state_dict, state_dict_from_flax
from tests.test_torch_model_variants import (LR, REL, WD, _f64, _kw, _running_stats, _same_planes,
                                             _torch)
from tests.test_torch_regression_train import _regression_batch
from tests.torch_parity import (assert_close, assert_tree_close, bridged, flax_tree_from_port,
                                grad_agreement, seeded_variables, to_numpy_tree)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads in this module's process, as in
    tests/test_torch_model_variants.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reg_case():
    cur, src = _regression_batch()
    jnet = JDepthNet(train_bn=True, **_kw("a"))
    variables = seeded_variables(lambda key, c, s: jnet.init({"params": key}, c, s), cur, src,
                                 seed=43)
    return cur, src, jnet, variables


def test_depth_net_forward_matches_jax(reg_case):
    cur, src, _, variables = reg_case
    jnet = JDepthNet(**_kw("a"))
    ref = jax.jit(lambda v, c, s: jnet.apply(v, c, s, flip=True))(variables, cur, src)
    net = bridged(DepthNet(**_kw("a")), variables)
    assert isinstance(net.decoder, decoders.SkipDecoder) and net.decoder.regression_heads
    with torch.no_grad():
        got = net(_torch(cur), _torch(src), flip=True)
    keys = [k for k in ref if k.startswith(("depth_pred_", "log_depth_pred_"))]
    assert len(keys) == 8 and sorted(got) == sorted(ref)
    for k in keys:
        assert_close(got[k], ref[k], REL)
    _same_planes(got["lowest_cost"], ref["lowest_cost"])


def test_regression_train_step_matches_jax(reg_case):
    cur, src, jnet, variables = reg_case

    def loss_fn(params, batch_stats, cur, src):
        depth_nan = jnp.where(cur["mask"], cur["depth"], jnp.nan)
        cur = dict(cur, normals=jimage.normals_from_depth(jnp.nan_to_num(depth_nan, nan=0.0),
                                                          cur["invK_s0"]))
        out, mutated = jnet.apply({"params": params, "batch_stats": batch_stats},
                                  cur, src, flip=True, mutable=["batch_stats"])
        out = dict(out)
        out["normals_pred"] = jimage.normals_from_depth(out["depth_pred_0"], cur["invK_s0"])
        ls = jlosses.regression_losses(cur, src, out)
        return ls["loss"], (mutated["batch_stats"], ls)

    with jax.enable_x64(True):
        v, c, s = (jax.tree.map(jnp.asarray, _f64(x)) for x in (variables, cur, src))
        (_, (batch_stats, ref_losses)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(v["params"], v["batch_stats"], c, s)
        batch_stats, ref_losses, grads = (to_numpy_tree(x)
                                          for x in (batch_stats, ref_losses, grads))

    net = DepthNet(**_kw("a"))
    load_state_dict(net, state_dict_from_flax(to_numpy_tree(variables)))
    opt, sched = state.make_optimizer(net.parameters(), LR, WD)
    got = state.make_regression_train_step(net, opt, sched)((_torch(cur), _torch(src)), flip=True)
    assert sorted(got) == sorted(ref_losses)
    for k in ref_losses:
        assert_close(got[k], ref_losses[k], 1e-5)
    rel_l2, median, worst, name = grad_agreement(grads, net)
    assert rel_l2 <= 5e-3 and median <= 1e-3 and worst <= 2e-1, (rel_l2, median, worst, name)
    assert_tree_close(batch_stats, "batch_stats", _running_stats(net), 1e-5)
    port_grads = flax_tree_from_port(variables["params"], "params",
                                     {n: p.grad for n, p in net.named_parameters()})
    st = jstate.create_train_state(variables, jstate.make_optimizer(LR, WD, (70000, 80000)))
    expected = jax.jit(lambda g: st.apply_gradients(g, st.batch_stats).params)(port_grads)
    assert_tree_close(expected, "params", dict(net.named_parameters()), 1e-6)
