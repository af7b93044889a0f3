"""Port parity: volumes/cost_volume.py, models/volume_mlp.py and the plain
version of the fused volume kernel (ops/fused_volume.py) against the JAX
package's unfused volume (build_warped_views + MetadataVolumeMLP.__call__),
which is what JAX runs on the CPU.

Tolerances: warp fields 1e-5 of the largest value (f32 coordinates rounded
in another order move bilinear weights by ~1e-7); the first-layer operands
1e-5; the volume atol 2e-3, rtol 1e-3, as tests/test_fused_volume.py holds
the TPU kernel to the same reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_depth_tpu.core import geometry as jgeo
from implicit_depth_tpu.models import volume_mlp as jvm
from implicit_depth_tpu.volumes import cost_volume as jcv
from implicit_depth_tpu_torch.models import volume_mlp
from implicit_depth_tpu_torch.ops import fused_volume
from implicit_depth_tpu_torch.volumes import cost_volume
from tests.torch_parity import assert_close, bridged, seeded_variables, t

CONFIGS = {
    "b2k3": dict(b=2, k=3, h=16, w=40, c=16, d=8),
    "k7c16": dict(b=1, k=7, h=12, w=20, c=16, d=6),
}


def _geometry(b, k, h, w, d, seed):
    Kmat = np.eye(4, dtype=np.float32)
    Kmat[0, 0], Kmat[1, 1], Kmat[0, 2], Kmat[1, 2] = w / 3.0, h / 3.0, w / 2.0, h / 2.0
    src_T_cur = np.zeros((b, k, 4, 4), np.float32)
    for bi in range(b):
        for ki in range(k):
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = jgeo.rotz(0.08 * (ki + 1) + 0.02 * bi) @ jgeo.roty(-0.04 * ki)
            T[:3, 3] = [0.15 * ki + 0.05, -0.08, 0.03 * (bi + 1 + seed)]
            src_T_cur[bi, ki] = T
    return dict(
        src_K=np.broadcast_to(Kmat, (b, k, 4, 4)).copy(),
        src_T_cur=src_T_cur,
        cur_invK=np.broadcast_to(np.linalg.inv(Kmat), (b, 4, 4)).copy(),
        cur_T_src=np.linalg.inv(src_T_cur).astype(np.float32),
        planes=np.asarray(jgeo.log_depth_planes(0.5, 4.0, d)),
    )


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    cfg = CONFIGS[request.param]
    b, k, h, w, c, d = (cfg[x] for x in "bkhwcd")
    rng = np.random.RandomState(7)
    cur = rng.randn(b, h, w, c).astype(np.float32)
    src = rng.randn(b, k, h, w, c).astype(np.float32)
    g = _geometry(b, k, h, w, d, seed=1)
    geo = (g["src_K"], g["src_T_cur"], g["cur_invK"], g["cur_T_src"], g["planes"])
    wv = jcv.build_warped_views(cur, src, *geo)
    net = jvm.MetadataVolumeMLP(num_src_views=k, matching_dim=c)
    variables = seeded_variables(net.init, wv, cur, seed=3)
    tnet = bridged(volume_mlp.MetadataVolumeMLP(k, c), variables)
    return dict(cfg=cfg, cur=cur, src=src, geo=geo, wv=wv, net=net,
                variables=variables, tnet=tnet)


def test_build_warped_views_fields(case):
    got = cost_volume.build_warped_views(t(case["cur"]), t(case["src"]),
                                         *(t(x) for x in case["geo"]))
    for name in jcv.WarpedViews._fields:
        assert_close(getattr(got, name), getattr(case["wv"], name), 1e-5)


def test_metadata_input_channels():
    assert volume_mlp.metadata_input_channels(7, 16) == jvm.metadata_input_channels(7, 16) == 202


def test_weight_operands(case):
    k, c = case["cfg"]["k"], case["cfg"]["c"]
    params = case["variables"]["params"]
    src_K, src_T_cur, cur_invK, cur_T_src, _ = case["geo"]
    jgeo_ops = jvm._geometry_operands(src_K, src_T_cur, cur_invK, cur_T_src)
    jops = jvm._weight_operands(params, case["cur"], jgeo_ops[3], cur_T_src, k=k, c=c, hidden=128)
    geo_ops = volume_mlp._geometry_operands(t(src_K), t(src_T_cur), t(cur_invK), t(cur_T_src))
    for got, ref in zip(geo_ops, jgeo_ops, strict=True):
        assert_close(got, ref, 1e-6)
    with torch.no_grad():
        ops = volume_mlp._weight_operands(case["tnet"].params_dict(), t(case["cur"]), geo_ops[3],
                                          t(cur_T_src), k=k, c=c, hidden=128)
    for got, ref in zip(ops, jops, strict=True):  # base, w_visT, w_metaT, ..., b_fc2
        assert_close(got, ref, 1e-5)


def test_metadata_mlp_forward(case):
    ref = case["net"].apply(case["variables"], case["wv"], case["cur"])
    twv = cost_volume.build_warped_views(t(case["cur"]), t(case["src"]),
                                         *(t(x) for x in case["geo"]))
    with torch.no_grad():
        got = case["tnet"](twv, t(case["cur"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-3, rtol=1e-3)


def test_fused_plain_version_matches_jax_volume(case):
    """The kernel's plain version, on the operands the kernel gets, is the
    JAX package's unfused volume."""
    ref = case["net"].apply(case["variables"], case["wv"], case["cur"])
    with torch.no_grad():
        ops = volume_mlp.fused_operands(case["tnet"].params_dict(), t(case["cur"]),
                                        t(case["src"]), *(t(x) for x in case["geo"]),
                                        k=case["cfg"]["k"], c=case["cfg"]["c"], hidden=128)
        got = fused_volume.fused_metadata_volume_reference(*ops)
    b, d, h, w = (case["cfg"][x] for x in "bdhw")
    assert got.shape == (b, d, h, w) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-3, rtol=1e-3)


def test_dispatch_takes_plain_path_on_cpu(case):
    """On CPU tensors the wrapper runs the plain version and does not count
    a kernel launch."""
    before = fused_volume.fused_metadata_volume.launches
    with torch.no_grad():
        got = case["tnet"].fused(t(case["cur"]), t(case["src"]), *(t(x) for x in case["geo"]))
    assert fused_volume.fused_metadata_volume.launches == before
    ref = case["net"].apply(case["variables"], case["wv"], case["cur"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-3, rtol=1e-3)


def test_dispatch_bf16_features_on_cpu(case):
    """bf16 features: the wrapper runs the plain version, which computes in
    f32 on the bf16 operands and rounds the warped visuals and h1 to bf16
    before their products, as the JAX kernel does. That moves the volume by
    bf16 rounding from the all-f32 computation on the same values: bound 1e-2
    relative L2 (measured 2.3e-3 and 2.7e-3)."""
    with torch.no_grad():
        ops = volume_mlp.fused_operands(case["tnet"].params_dict(),
                                        t(case["cur"], torch.bfloat16), t(case["src"], torch.bfloat16),
                                        *(t(x) for x in case["geo"]),
                                        k=case["cfg"]["k"], c=case["cfg"]["c"], hidden=128)
        got = fused_volume.fused_metadata_volume(*ops)
        ref = fused_volume.fused_metadata_volume_reference(*ops)
        f32 = fused_volume.fused_metadata_volume_reference(*(x.float() for x in ops))
    assert ops[1].dtype == ops[8].dtype == ops[11].dtype == torch.bfloat16
    assert torch.equal(got, ref)
    assert not torch.equal(got, f32)
    assert ((got - f32).norm() / f32.norm()).item() <= 1e-2


def test_dispatch_rejects_bad_operands(case):
    with torch.no_grad():
        ops = list(volume_mlp.fused_operands(case["tnet"].params_dict(), t(case["cur"]),
                                             t(case["src"]), *(t(x) for x in case["geo"]),
                                             k=case["cfg"]["k"], c=case["cfg"]["c"], hidden=128))
    bad_dtype = ops.copy()
    bad_dtype[7] = ops[7].double()  # base must be f32
    with pytest.raises(TypeError):
        fused_volume.fused_metadata_volume(*bad_dtype)
    bad_shape = ops.copy()
    bad_shape[9] = ops[9][:, :-1].contiguous()  # w_metaT (F, K*8)
    with pytest.raises(ValueError):
        fused_volume.fused_metadata_volume(*bad_shape)
    strided = ops.copy()
    strided[0] = ops[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        fused_volume.fused_metadata_volume(*strided)


def test_overall_source_mask_matches_jax():
    """At 24x32, K=2, 4 planes, b=2 seeded poses (chip_smoke's coverage
    geometry: each second view turned by ~70 degrees and pushed back, so
    that part of the image falls out of it and behind it): the masks are
    equal but at pixels where some view's u or v lies within 1e-4 px of a
    border (2 or w-2, 2 or h-2; f32 homographies summed in another order),
    which are counted and are the only exceptions. Under bf16 autocast the
    port's mask is the same: its geometry stays f32."""
    import chip_smoke

    b, k, h, w, c, d = 2, 2, 24, 32, 16, 4
    rng = np.random.RandomState(11)
    src_K, src_T_cur, cur_invK, cur_T_src = chip_smoke.coverage_geometry(b, k, h, w, seed=11)
    planes = np.asarray(jgeo.log_depth_planes(0.25, 5.0, d))
    cur = rng.randn(b, h, w, c).astype(np.float32)
    src = rng.randn(b, k, h, w, c).astype(np.float32)
    geo = (src_K, src_T_cur, cur_invK, cur_T_src, planes)
    jwv = jax.jit(jcv.build_warped_views)(cur, src, *geo)
    wv = cost_volume.build_warped_views(t(cur), t(src), *(t(x) for x in geo))
    ref = np.asarray(jax.jit(jcv.overall_source_mask, static_argnums=(4, 5))(
        jwv, src_K, src_T_cur, cur_invK, h, w))
    got = cost_volume.overall_source_mask(wv, t(src_K), t(src_T_cur), t(cur_invK), h, w)
    assert got.dtype == torch.bool and got.shape == (b, h, w)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert torch.equal(cost_volume.overall_source_mask(
            wv, t(src_K), t(src_T_cur), t(cur_invK), h, w), got)
    near = chip_smoke.mask_border_pixels(src_K, src_T_cur, cur_invK, float(planes[-1]), h, w)
    differ = got.numpy() != ref
    assert not (differ & ~near).any(), (int(differ.sum()), int(near.sum()))
    assert ref.any() and not ref.all() and not ref[0].all() and not ref[1].all()


def test_lowest_cost_depth():
    rng = np.random.RandomState(0)
    cost = rng.randn(2, 8, 5, 6).astype(np.float32)
    planes = np.asarray(jgeo.log_depth_planes(0.25, 5.0, 8))
    assert_close(cost_volume.lowest_cost_depth(t(cost), t(planes)),
                 jcv.lowest_cost_depth(jnp.asarray(cost), jnp.asarray(planes)), 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_forward_by_batch_equals_whole_batch(dtype):
    """chip_smoke.py holds kernel #1 at the train step's batch against the
    plain version run one batch element at a time: that is the whole
    batch's plain version. Matrix products over fewer rows may sum in
    another order: in f32 that moves the volume by ~1e-7 (bound 1e-5 of the
    largest value); in bf16 the same f32 differences can round h1 one bf16
    ulp apart (measured: 2 points of 2100 moved, by at most 2.3e-4), so
    every point is held to the f32 kernel's bound, atol 2e-3 + rtol 1e-3."""
    import chip_smoke
    from implicit_depth_tpu_torch.weights import init_params

    b, k, h, w, d = 3, 3, 10, 14, 5
    rng = np.random.RandomState(13)
    g = _geometry(b, k, h, w, d, seed=5)
    gen = torch.Generator().manual_seed(0)
    mlp = init_params(volume_mlp.MetadataVolumeMLP(k, 16), gen)
    with torch.no_grad():
        for p in mlp.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
        ops = volume_mlp.fused_operands(
            mlp.params_dict(), t(rng.randn(b, h, w, 16), dtype), t(rng.randn(b, k, h, w, 16), dtype),
            *(t(g[x]) for x in ("src_K", "src_T_cur", "cur_invK", "cur_T_src", "planes")),
            k=k, c=16, hidden=128)
        whole = fused_volume.fused_metadata_volume_reference(*ops)
        split = chip_smoke.volume_reference_by_batch(ops)
    assert ops[1].dtype == dtype and whole.shape == (b, d, h, w)
    if dtype == torch.float32:
        assert_close(split, whole, 1e-5)
    else:
        np.testing.assert_allclose(split.numpy(), whole.numpy(), atol=chip_smoke.ATOL,
                                   rtol=chip_smoke.RTOL)
