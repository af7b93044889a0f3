"""Port parity: the backward of the fused metadata volume.

- The plain version of kernel #2 (`fused_metadata_volume_bwd_reference`,
  what the wrapper runs on CPU tensors) against the JAX package's
  `fused_metadata_volume_bwd` in interpret mode, at B=1, K=2, C=16, F=128,
  H=8, W=12, D=5 with f32 features: all ten cotangents within
  atol 5e-3, rtol 5e-3, the bound tests/test_fused_volume.py:170-176 holds
  the TPU kernel's gradients to.
- The training Function (`MetadataVolumeMLP.fused_train`: forward kernel #1,
  backward kernel #2, plain versions here) against `jax.grad` of the JAX
  package's unfused volume (build_warped_views + MetadataVolumeMLP), w.r.t.
  the MLP parameters and both feature maps. Bound 1e-4 of each gradient's
  largest value: both sides are f32 (measured ~1e-6; sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_depth_tpu.models import volume_mlp as jvm
from implicit_depth_tpu.ops import fused_volume as jfv
from implicit_depth_tpu.volumes import cost_volume as jcv
from implicit_depth_tpu_torch.models import volume_mlp
from implicit_depth_tpu_torch.ops import fused_volume
from tests.test_torch_volume import _geometry
from tests.torch_parity import assert_close, bridged, seeded_variables, t

B, K, H, W, C, D = 1, 2, 8, 12, 16, 5


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(11)
    cur = rng.randn(B, H, W, C).astype(np.float32)
    src = rng.randn(B, K, H, W, C).astype(np.float32)
    g = _geometry(B, K, H, W, D, seed=2)
    geo = (g["src_K"], g["src_T_cur"], g["cur_invK"], g["cur_T_src"], g["planes"])
    wv = jcv.build_warped_views(cur, src, *geo)
    net = jvm.MetadataVolumeMLP(num_src_views=K, matching_dim=C)
    variables = seeded_variables(net.init, wv, cur, seed=5)
    ct = rng.randn(B, D, H, W).astype(np.float32)
    return dict(cur=cur, src=src, geo=geo, net=net, variables=variables, ct=ct,
                tnet=bridged(volume_mlp.MetadataVolumeMLP(K, C), variables))


def test_plain_backward_matches_jax_kernel(case):
    src_K, src_T_cur, cur_invK, cur_T_src, planes = case["geo"]
    A, b, origins, invK3 = jvm._geometry_operands(src_K, src_T_cur, cur_invK, cur_T_src)
    wops = jvm._weight_operands(case["variables"]["params"], case["cur"], invK3, cur_T_src,
                                k=K, c=C, hidden=128)
    base, w_visT, w_metaT, w_plane, w_fc1T, b_fc1, w_fc2, _ = wops
    args = (case["cur"], case["src"], A, b, origins, invK3, planes, base, w_visT, w_metaT,
            w_plane, w_fc1T, b_fc1, w_fc2)
    ref = jfv.fused_metadata_volume_bwd(case["ct"], *args, hidden=128, interpret=True)
    got = fused_volume.fused_metadata_volume_bwd(t(case["ct"]), *(t(x).contiguous() for x in args))
    assert fused_volume.fused_metadata_volume_bwd.launches == 0  # CPU: the plain version
    for name in fused_volume.FusedVolumeCotangents._fields:
        g, r = getattr(got, name), np.asarray(getattr(ref, name))
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), r, atol=5e-3, rtol=5e-3, err_msg=name)


def test_training_function_grads_match_jax(case):
    src_K, src_T_cur, cur_invK, cur_T_src, planes = case["geo"]
    ct = case["ct"]

    def jloss(variables, cur, src):
        wv = jcv.build_warped_views(cur, src, *case["geo"])
        return jnp.sum(case["net"].apply(variables, wv, cur) * ct)

    jg_vars, jg_cur, jg_src = jax.grad(jloss, argnums=(0, 1, 2))(
        case["variables"], jnp.asarray(case["cur"]), jnp.asarray(case["src"]))

    tnet = case["tnet"]
    tnet.zero_grad()
    cur = t(case["cur"]).requires_grad_(True)
    src = t(case["src"]).requires_grad_(True)
    vol = tnet.fused_train(cur, src, *(t(x) for x in case["geo"]))
    (vol * t(ct)).sum().backward()

    assert_close(cur.grad, jg_cur, 1e-4)
    assert_close(src.grad, jg_src, 1e-4)
    jp = jg_vars["params"]
    assert_close(tnet.fc0_kernel.grad, jp["fc0_kernel"], 1e-4)
    assert_close(tnet.fc0_bias.grad, jp["fc0_bias"], 1e-4)
    for name in ("fc1", "fc2"):
        layer = getattr(tnet, name)
        assert_close(layer.weight.grad.t(), jp[name]["kernel"], 1e-4)
        assert_close(layer.bias.grad, jp[name]["bias"], 1e-4)


def test_training_function_counts_no_launch_on_cpu(case):
    before = (fused_volume.fused_metadata_volume.launches,
              fused_volume.fused_metadata_volume_bwd.launches)
    src = t(case["src"]).requires_grad_(True)
    vol = case["tnet"].fused_train(t(case["cur"]), src, *(t(x) for x in case["geo"]))
    vol.sum().backward()
    assert src.grad is not None and torch.isfinite(src.grad).all()
    assert (fused_volume.fused_metadata_volume.launches,
            fused_volume.fused_metadata_volume_bwd.launches) == before


def test_backward_rejects_bad_cotangent(case):
    with torch.no_grad():
        ops = volume_mlp.fused_operands(case["tnet"].params_dict(), t(case["cur"]),
                                        t(case["src"]), *(t(x) for x in case["geo"]),
                                        k=K, c=C, hidden=128)
    with pytest.raises(ValueError):
        fused_volume.fused_metadata_volume_bwd(torch.zeros(B, D, H, W + 1), *ops[:14])
    with pytest.raises(ValueError):
        fused_volume.fused_metadata_volume_bwd(torch.zeros(B, D, H, W).double(), *ops[:14])


def test_backward_smem_budget_of_the_flagship():
    """Seven source views fit the backward's shared-memory budget."""
    assert fused_volume.bwd_smem_bytes(7) <= fused_volume.SMEM_LIMIT < fused_volume.bwd_smem_bytes(8)
