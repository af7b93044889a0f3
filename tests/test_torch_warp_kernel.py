"""Port parity: the plane-sweep warp (ops/warp_kernel.py, kernels #5 and #6)
and the flat branch of build_warped_views, against the JAX package on the
CPU in f32. On CPU tensors the port's wrappers run the kernels' plain
versions; the JAX kernels run in Pallas interpret mode.

Tolerances, as tests/test_warp_kernel.py holds the TPU kernels: the warp
atol 2e-4, rtol 1e-4; its transpose atol 3e-4, rtol 1e-3 (f32 coordinates
rounded in another order move bilinear weights by ~1e-7, and the transpose
sums up to 4 D contributions per source pixel). The warped-view fields 1e-5
of the largest value, as tests/test_torch_volume.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_depth_tpu.core import geometry as jgeo
from implicit_depth_tpu.core.sampling import sample_bilinear_idx as jsample
from implicit_depth_tpu.ops import warp_kernel as jwk
from implicit_depth_tpu.volumes import cost_volume as jcv
from implicit_depth_tpu_torch.ops import warp_kernel as wk
from implicit_depth_tpu_torch.volumes import cost_volume
from tests.torch_parity import assert_close, t

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
BWD_TOL = dict(atol=3e-4, rtol=1e-3)


def _setup(seed=0, K=2, H=16, W=128, C=8, D=3):
    """The inputs of tests/test_warp_kernel.py: modest rotation and
    translation per view, some samples behind the camera or out of frame."""
    rng = np.random.RandomState(seed)
    src = rng.randn(K, H, W, C).astype(np.float32)
    A = np.zeros((K, 3, 3), np.float32)
    b = np.zeros((K, 3), np.float32)
    for k in range(K):
        R = jgeo.rotz(0.1 * (k + 1)) @ jgeo.roty(-0.05 * k)
        Kmat = np.array([[W / 3, 0, W / 2], [0, H / 3, H / 2], [0, 0, 1.0]])
        A[k] = (Kmat @ R @ np.linalg.inv(Kmat)).astype(np.float32)
        b[k] = (Kmat @ np.array([0.2 * k + 0.1, -0.1, 0.02])).astype(np.float32)
    planes = np.asarray(jgeo.log_depth_planes(0.5, 4.0, D))
    return src, A, b, planes


def _xla_sampler(src, A, b, planes):
    """The JAX package's exact XLA sampler on the warp's coordinates."""
    K, H, W, C = src.shape
    e3 = np.zeros((3,), np.float32)
    e3[2] = 1.0
    M = planes[None, :, None, None] * A[:, None] + (b[..., None] * e3)[:, None]
    xyz = np.einsum("kdij,hwj->kdhwi", M, np.asarray(jgeo.pixel_grid(H, W)))
    z = np.maximum(xyz[..., 2], 1e-5)
    x = np.clip(xyz[..., 0] / z - 0.5, -2.0 * W, 2.0 * W)
    y = np.clip(xyz[..., 1] / z - 0.5, -2.0 * H, 2.0 * H)
    return np.stack([np.asarray(jsample(jnp.asarray(src[k]), jnp.asarray(x[k]), jnp.asarray(y[k])))
                     for k in range(K)])


SHAPES = {"16x128": (16, 128), "ragged12x72": (12, 72), "ragged10x130": (10, 130)}


@pytest.mark.parametrize("hw", sorted(SHAPES))
def test_warp_planes_matches_jax_kernel_and_sampler(hw):
    H, W = SHAPES[hw]
    src, A, b, planes = _setup(H=H, W=W)
    got = wk.warp_planes(t(src), t(A), t(b), t(planes))
    assert got.shape == (2, 3, H, W, 8) and got.dtype == torch.float32
    ref_kernel = jwk.warp_planes(jnp.asarray(src), jnp.asarray(A), jnp.asarray(b),
                                 jnp.asarray(planes), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_kernel), **FWD_TOL)
    np.testing.assert_allclose(got.numpy(), _xla_sampler(src, A, b, planes), **FWD_TOL)


def test_warp_planes_zero_padding():
    """A translation that pushes every sample out of frame gives exact zeros."""
    src, A, b, planes = _setup(K=1, D=2)
    A[0] = np.eye(3)
    b[0] = [1e4, 0.0, 0.0]
    assert torch.all(wk.warp_planes(t(src), t(A), t(b), t(planes)) == 0.0)


def test_warp_planes_identity():
    """The identity homography at plane depth 1 reproduces the source."""
    src = np.random.RandomState(1).randn(1, 16, 128, 8).astype(np.float32)
    got = wk.warp_planes(t(src), torch.eye(3)[None], torch.zeros((1, 3)), torch.ones(1))
    np.testing.assert_allclose(got[0, 0].numpy(), src[0], atol=1e-5)


@pytest.mark.parametrize("hw", ["16x128", "ragged12x72"])
def test_warp_planes_bwd_matches_jax_kernel(hw):
    H, W = SHAPES[hw]
    src, A, b, planes = _setup(H=H, W=W)
    ct = np.random.RandomState(3).randn(2, 3, H, W, 8).astype(np.float32)
    got = wk.warp_planes_bwd(t(ct), t(A), t(b), t(planes))
    ref = jwk.warp_planes_bwd(jnp.asarray(ct), jnp.asarray(A), jnp.asarray(b),
                              jnp.asarray(planes), interpret=True)
    assert got.shape == (2, H, W, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **BWD_TOL)


def test_warp_planes_diff_gradient_is_the_transpose():
    """The autograd Function's source gradient is warp_planes_bwd (here its
    plain version, autograd of the plain forward); the geometry gets none."""
    src, A, b, planes = _setup(H=12, W=72)
    ct = torch.tensor(np.random.RandomState(4).randn(2, 3, 12, 72, 8).astype(np.float32))
    s = t(src).requires_grad_(True)
    At = t(A).requires_grad_(True)
    out = wk.warp_planes_diff(s, At, t(b), t(planes))
    (out * ct).sum().backward()
    np.testing.assert_allclose(s.grad.numpy(),
                               wk.warp_planes_bwd_reference(ct, t(A), t(b), t(planes)).numpy(),
                               atol=1e-6, rtol=1e-6)
    assert At.grad is None


def test_warp_planes_bf16_rounds_once():
    """bf16 features: the f32 blend rounded once to bf16, and the transpose
    returns the cotangent's dtype."""
    src, A, b, planes = _setup(H=12, W=72)
    got = wk.warp_planes(t(src).bfloat16(), t(A), t(b), t(planes))
    ref = wk.warp_planes(t(src).bfloat16().float(), t(A), t(b), t(planes)).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, ref)
    ct = torch.randn((2, 3, 12, 72, 8), generator=torch.Generator().manual_seed(0))
    g = wk.warp_planes_bwd(ct.bfloat16(), t(A), t(b), t(planes))
    assert g.dtype == torch.bfloat16


def test_warp_planes_checks_its_operands():
    src, A, b, planes = _setup(H=12, W=72)
    with pytest.raises(ValueError):
        wk.warp_planes(t(src)[0], t(A), t(b), t(planes))
    with pytest.raises(ValueError):
        wk.warp_planes(t(src), t(A)[:1], t(b), t(planes))
    with pytest.raises(TypeError):
        wk.warp_planes(t(src), t(A).double(), t(b), t(planes))
    with pytest.raises(ValueError):
        wk.warp_planes_bwd(torch.zeros((2, 4, 12, 72, 8)), t(A), t(b), t(planes))


def _views_case(b=2, k=3, h=12, w=20, c=16, d=6, seed=0):
    rng = np.random.RandomState(seed)
    Kmat = np.eye(4, dtype=np.float32)
    Kmat[0, 0], Kmat[1, 1], Kmat[0, 2], Kmat[1, 2] = w / 3.0, h / 3.0, w / 2.0, h / 2.0
    src_T_cur = np.zeros((b, k, 4, 4), np.float32)
    for bi in range(b):
        for ki in range(k):
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = jgeo.rotz(0.08 * (ki + 1) + 0.02 * bi) @ jgeo.roty(-0.04 * ki)
            T[:3, 3] = [0.15 * ki + 0.05, -0.08, 0.03 * (bi + 2)]
            src_T_cur[bi, ki] = T
    geo = (np.broadcast_to(Kmat, (b, k, 4, 4)).copy(), src_T_cur,
           np.broadcast_to(np.linalg.inv(Kmat), (b, 4, 4)).copy(),
           np.linalg.inv(src_T_cur).astype(np.float32),
           np.asarray(jgeo.log_depth_planes(0.5, 4.0, d)))
    return (rng.randn(b, h, w, c).astype(np.float32), rng.randn(b, k, h, w, c).astype(np.float32),
            geo)


def test_flat_build_warped_views_matches_jax():
    """The port's flat branch (the warp through warp_planes_diff, z from
    row 2 of the homography) against the JAX package's non-flat branch:
    every WarpedViews field. (The JAX flat branch needs the TPU kernel
    outside interpret mode.)"""
    cur, src, geo = _views_case()
    ref = jcv.build_warped_views(cur, src, *geo)
    got = cost_volume.build_warped_views(t(cur), t(src), *(t(x) for x in geo))
    for name in jcv.WarpedViews._fields:
        assert_close(getattr(got, name), getattr(ref, name), 1e-5)
    assert_close(cost_volume.dot_cost_volume(got), jcv.dot_cost_volume(ref), 1e-5)
    zero = cost_volume.zero_cost_volume(2, 6, 12, 20)
    np.testing.assert_array_equal(zero.numpy(), np.asarray(jcv.zero_cost_volume(2, 6, 12, 20)))


def test_flat_build_warped_views_gradient_matches_jax():
    """Gradients w.r.t. both feature maps through the flat branch (the
    transpose on the source features, the dot metadata on the current
    ones) against jax.vjp of the JAX package's warp."""
    cur, src, geo = _views_case(b=1, k=2, seed=1)
    w = np.random.RandomState(5).randn(6).astype(np.float32)

    def jloss(c, s):
        wv = jcv.build_warped_views(c, s, *geo)
        return jnp.sum(wv.feats ** 2) + jnp.sum(wv.dot * w[:, None, None])

    jgc, jgs = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(cur), jnp.asarray(src))
    c, s = t(cur).requires_grad_(True), t(src).requires_grad_(True)
    wv = cost_volume.build_warped_views(c, s, *(t(x) for x in geo))
    (torch.sum(wv.feats ** 2) + torch.sum(wv.dot * t(w)[:, None, None])).backward()
    assert_close(c.grad, jgc, 1e-5)
    assert_close(s.grad, jgs, 1e-5)


AT_CENTRE = (20, 13, 4)  # (u0, v0, d0) of chip_smoke.warp_operands' at-centre view 0


def _card_operands(kind):
    """The warp operands of the card checks (chip_smoke.warp_operands), on
    the CPU at a small shape: "eval" (small random poses), "extreme" (every
    other view turned ~70 degrees and pushed back) and "at_centre" (view 0's
    camera centre on output point AT_CENTRE)."""
    import chip_smoke

    geo = {"eval": {}, "extreme": {"extreme": True}, "at_centre": {"at_centre": AT_CENTRE}}[kind]
    shape = dict(K=3, H=50, W=70, D=13) if kind == "extreme" else dict(K=2, H=40, W=56, D=8)
    return chip_smoke.warp_operands(**shape, dtype=torch.float32, seed=1, device="cpu", **geo)


def test_at_centre_operands_put_a_clamped_sample_in_frame():
    """The at-centre operands make r exactly 0 at (u0, v0, d0) of view 0: z
    sits at its clamp and the sample lands at (-0.5, -0.5), whose tap (1, 1)
    is texel (0, 0). The inverse homography does not reach such a sample,
    so the card check of the transpose on these operands tests the kernel's
    clamped case."""
    _, A, b, planes = _card_operands("at_centre")
    x, y, clamped = wk.sample_points(A, b, planes, 40, 56)
    u0, v0, d0 = AT_CENTRE
    assert bool(clamped[0, d0, v0, u0])
    assert x[0, d0, v0, u0].item() == -0.5 and y[0, d0, v0, u0].item() == -0.5
    in_frame = clamped & (x > -1) & (x < 56) & (y > -1) & (y < 40)
    assert in_frame[0, d0, v0, u0] and int(in_frame.sum()) >= 1


@pytest.mark.parametrize("kind", ["eval", "extreme", "at_centre"])
def test_candidate_boxes_cover_every_tap(kind):
    """Every (pixel, plane) whose sample has a tap in a tile of the
    transpose lies in that tile's candidate box of its case (z clamped or
    not), as ops/warp_kernel.py::candidate_boxes mirrors the kernel's rule.
    The samples are the kernels' bits (sample_points)."""
    _, A, b, planes = _card_operands(kind)
    K, D = A.shape[0], planes.shape[0]
    H, W = (50, 70) if kind == "extreme" else (40, 56)
    tw, th = wk.BWD_TILE
    boxes = torch.from_numpy(wk.candidate_boxes(A, b, planes, H, W))
    assert boxes.shape == (K, D, -(-H // th), -(-W // tw), 2, 4)
    x, y, clamped = wk.sample_points(A, b, planes, H, W)
    k, d, v, u = torch.meshgrid(*(torch.arange(n) for n in (K, D, H, W)), indexing="ij")
    taps = 0
    for dy in (0, 1):
        for dx in (0, 1):
            tx, ty = torch.floor(x).long() + dx, torch.floor(y).long() + dy
            hit = (tx >= 0) & (tx < W) & (ty >= 0) & (ty < H)
            box = boxes[k[hit], d[hit], ty[hit] // th, tx[hit] // tw, clamped[hit].long()]
            uu, vv = u[hit], v[hit]
            inside = (uu >= box[:, 0]) & (uu <= box[:, 1]) & (vv >= box[:, 2]) & (vv <= box[:, 3])
            assert bool(inside.all()), f"{int((~inside).sum())} taps outside their boxes"
            taps += int(hit.sum())
    assert taps > 10_000
    has_clamped_box = bool((boxes[..., 1, 0] <= boxes[..., 1, 1]).any())
    assert has_clamped_box == (kind == "at_centre")
