"""Port parity: the backward of the fused metadata volume.

- The plain version of kernel #2 (`fused_metadata_volume_bwd_reference`,
  what the wrapper runs on CPU tensors) against the JAX package's
  `fused_metadata_volume_bwd` in interpret mode, at B=1, K=2, C=16, F=128,
  H=8, W=12, D=5 with f32 features: all ten cotangents within
  atol 5e-3, rtol 5e-3, the bound tests/test_fused_volume.py:170-176 holds
  the TPU kernel's gradients to. With bf16 features, the plain versions of
  #1 and #2 against the JAX kernels in bf16 (bounds and their reason at
  the bf16 section below).
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
from implicit_depth_tpu_torch.core import sampling
from implicit_depth_tpu_torch.models import volume_mlp
from implicit_depth_tpu_torch.ops import fused_volume
from implicit_depth_tpu_torch.volumes import cost_volume
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_backward_by_batch_element_matches_whole_batch(case, dtype):
    """chip_smoke.py holds kernel #2 at the train step's batch against the
    plain version run one batch element at a time: that is the whole
    batch's plain version (weight gradients summed in another order)."""
    import chip_smoke

    rng = np.random.RandomState(12)
    g = _geometry(3, K, H, W, D, seed=4)
    with torch.no_grad():
        ops = volume_mlp.fused_operands(
            case["tnet"].params_dict(), t(rng.randn(3, H, W, C)).to(dtype),
            t(rng.randn(3, K, H, W, C)).to(dtype),
            *(t(g[x]) for x in ("src_K", "src_T_cur", "cur_invK", "cur_T_src", "planes")),
            k=K, c=C, hidden=128)[:14]
    ct = t(rng.randn(3, D, H, W))
    whole = fused_volume.fused_metadata_volume_bwd_reference(ct, *ops)
    split = chip_smoke.volume_bwd_reference_by_batch(ct, ops)
    for name in fused_volume.FusedVolumeCotangents._fields:
        r = getattr(whole, name)
        assert getattr(split, name).shape == r.shape, name
        assert_close(getattr(split, name), r, 1e-5)


# ------------------------------------------------------------------ bf16
#
# The JAX kernels in bf16 round their matrix operands: the warped visuals
# and h1 in the forward (implicit_depth_tpu/ops/fused_volume.py:207, :239),
# and vis, h1, dh2p, dacc in the backward (:487, :522, :534, :539). The
# port's plain versions round at those points. The JAX kernels also build
# the warp from bilinear-hat x weights cast to bf16 (:180, :464), and round
# the scatter's operand, the y-hat-weighted cotangent, to bf16 (:580):
# artefacts of their one-hot MXU gather and scatter that the port (kernel
# and plain version) does not carry over. Through
# the LeakyReLU slopes that last rounding moves the gradients by a few
# percent in relative L2 (a slope flip changes an element by ~100%), so to
# hold the port's rounding points to the JAX kernel's the tests below give
# the port's gather sampler the same bf16 x weights (`_hat_sampler`).
# Measured at this fixture, per cotangent, relative L2: 1.9e-3 at most
# (dsrc) with the port's rounding points, 3.6e-2 without them (the f32
# plain version on the same bf16 values); 6.1e-2 for the port as it ships,
# with exact x weights. Bound: 5e-3 per cotangent; the forward 1e-3
# (measured 2.1e-4).

BF16_REL = 5e-3
BF16_FWD_REL = 1e-3


def _hat_sampler(img, x_idx, y_idx):
    """core/sampling.py::sample_bilinear_idx with the x weights rounded to
    bf16, as the JAX kernels' hat operands: weight 1 - |i - x| at the two
    columns around x."""
    x0, y0 = torch.floor(x_idx), torch.floor(y_idx)
    wx0 = (1.0 - (x_idx - x0)).bfloat16().float()[..., None]
    wx1 = (1.0 - torch.abs(x0 + 1 - x_idx)).bfloat16().float()[..., None]
    dy = (y_idx - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    gather = sampling._gather_nhwc
    top = gather(img, x0i, y0i) * wx0 + gather(img, x0i + 1, y0i) * wx1
    bot = gather(img, x0i, y0i + 1) * wx0 + gather(img, x0i + 1, y0i + 1) * wx1
    return top * (1.0 - dy) + bot * dy


@pytest.fixture(scope="module")
def bf16_case(case):
    """The JAX kernels' forward and backward in interpret mode on bf16
    features (w_visT and w_fc1T cast as their wrappers cast them), and the
    port's operands with the same values."""
    src_K, src_T_cur, cur_invK, cur_T_src, planes = case["geo"]
    A, b, origins, invK3 = jvm._geometry_operands(src_K, src_T_cur, cur_invK, cur_T_src)
    wops = jvm._weight_operands(case["variables"]["params"], case["cur"], invK3, cur_T_src,
                                k=K, c=C, hidden=128)
    base, w_visT, w_metaT, w_plane, w_fc1T, b_fc1, w_fc2, b_fc2 = wops
    bf = jnp.bfloat16
    args = (jnp.asarray(case["cur"], bf), jnp.asarray(case["src"], bf), A, b, origins, invK3,
            planes, base, jnp.asarray(w_visT, bf), w_metaT, w_plane, jnp.asarray(w_fc1T, bf),
            b_fc1, w_fc2)
    ops = [t(np.asarray(x, np.float32)) for x in args]
    for i in (0, 1, 8, 11):  # cur, src, w_visT, w_fc1T
        ops[i] = ops[i].bfloat16()
    return dict(
        bwd=jfv.fused_metadata_volume_bwd(case["ct"], *args, hidden=128, interpret=True),
        fwd=np.asarray(jfv.fused_metadata_volume(*args, b_fc2, hidden=128, interpret=True)),
        ops=tuple(x.contiguous() for x in ops), b_fc2=t(b_fc2), ct=t(case["ct"]))


def _rel_l2(got, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got.double().numpy() - ref) / np.linalg.norm(ref))


def test_plain_forward_matches_jax_kernel_bf16(bf16_case, monkeypatch):
    monkeypatch.setattr(cost_volume, "sample_bilinear_idx", _hat_sampler)
    before = fused_volume.fused_metadata_volume.launches
    with torch.no_grad():
        got = fused_volume.fused_metadata_volume(*bf16_case["ops"], bf16_case["b_fc2"])
    assert fused_volume.fused_metadata_volume.launches == before
    assert got.dtype == torch.float32 and tuple(got.shape) == bf16_case["fwd"].shape
    assert _rel_l2(got, bf16_case["fwd"]) <= BF16_FWD_REL


def test_plain_backward_matches_jax_kernel_bf16(bf16_case, monkeypatch):
    monkeypatch.setattr(cost_volume, "sample_bilinear_idx", _hat_sampler)
    got = fused_volume.fused_metadata_volume_bwd(bf16_case["ct"], *bf16_case["ops"])
    assert fused_volume.fused_metadata_volume_bwd.launches == 0  # CPU: the plain version
    for name in fused_volume.FusedVolumeCotangents._fields:
        g, r = getattr(got, name), np.asarray(getattr(bf16_case["bwd"], name))
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape, name
        assert _rel_l2(g, r) <= BF16_REL, (name, _rel_l2(g, r))


def test_bf16_rounding_points_decide_the_match(bf16_case, monkeypatch):
    """The bound above holds the rounding points: without them (the f32
    plain version on the same bf16 values) the gradients miss it by far."""
    monkeypatch.setattr(cost_volume, "sample_bilinear_idx", _hat_sampler)
    got = fused_volume.fused_metadata_volume_bwd(bf16_case["ct"],
                                                 *(x.float() for x in bf16_case["ops"]))
    worst = max(_rel_l2(getattr(got, name), getattr(bf16_case["bwd"], name))
                for name in ("dsrc", "dcur", "dbase", "dw_visT", "dw_fc1T"))
    assert worst > 4 * BF16_REL
