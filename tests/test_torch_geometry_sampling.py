"""Port parity: core/geometry.py and core/sampling.py against the JAX package.

Tolerances: the geometry is f32 on both sides with the products summed in
another order, so values agree to a few f32 ulps (rel 1e-6 of the largest
value); sampling agrees to 1e-5 of the largest value (bilinear weights are
recomputed from the same coordinates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.nn.functional as F

from implicit_depth_tpu.core import geometry as jgeo
from implicit_depth_tpu.core import sampling as jsamp
from implicit_depth_tpu_torch.core import geometry, sampling
from tests.torch_parity import assert_close, t


def _poses(rng, b, k):
    T = np.zeros((b, k, 4, 4), np.float32)
    for bi in range(b):
        for ki in range(k):
            M = np.eye(4, dtype=np.float32)
            M[:3, :3] = jgeo.rotz(rng.uniform(-0.2, 0.2)) @ jgeo.roty(rng.uniform(-0.2, 0.2))
            M[:3, 3] = rng.uniform(-0.3, 0.3, 3)
            T[bi, ki] = M
    return T


def _intrinsics(b, k, h, w):
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = w * 0.9, w * 0.9, w / 2, h / 2
    return np.broadcast_to(K, (b, k, 4, 4)).copy(), np.broadcast_to(np.linalg.inv(K), (b, 4, 4)).copy()


@pytest.mark.parametrize("h,w", [(4, 6), (7, 5)])
def test_pixel_grid(h, w):
    assert_close(geometry.pixel_grid(h, w), jgeo.pixel_grid(h, w), 0.0)


def test_homographies_and_planes():
    rng = np.random.RandomState(0)
    b, k, h, w = 2, 3, 12, 20
    sK, cinvK = _intrinsics(b, k, h, w)
    sTc = _poses(rng, b, k)
    planes = np.asarray(jgeo.log_depth_planes(0.25, 5.0, 16))
    assert_close(geometry.log_depth_planes(0.25, 5.0, 16), planes, 1e-6)
    A, bb = geometry.homography_components(t(sK), t(sTc), t(cinvK))
    jA, jb = jgeo.homography_components(sK, sTc, cinvK)
    assert_close(A, jA, 1e-6)
    assert_close(bb, jb, 1e-6)
    assert_close(geometry.plane_homographies(t(sK), t(sTc), t(cinvK), t(planes)),
                 jgeo.plane_homographies(sK, sTc, cinvK, planes), 1e-6)


def test_pose_distance_and_normalize():
    rng = np.random.RandomState(1)
    T = _poses(rng, 2, 4)
    T[0, 0] = np.eye(4)  # identity rotation: the clamp at 0 must hold
    for got, ref in zip(geometry.pose_distance(t(T)), jgeo.pose_distance(T)):
        assert_close(got, ref, 1e-6, atol=1e-6)
    v = rng.randn(5, 7, 3).astype(np.float32)
    v[0, 0] = 0.0
    assert_close(geometry.normalize(t(v)), jgeo.normalize(v), 1e-6)


@pytest.mark.parametrize("lead", [(3,), (2, 4)], ids=["batch", "batch_views"])
def test_camera_rays_from_origin(lead):
    """Unit rays from origins (*lead, 3) to points (*lead, n, 3), the
    origin broadcast over the points; a point at its origin gives the zero
    ray (the norm's clamp at eps) on both sides."""
    rng = np.random.RandomState(3)
    pts = rng.uniform(-4.0, 4.0, lead + (9, 3)).astype(np.float32)
    origin = rng.uniform(-1.0, 1.0, lead + (3,)).astype(np.float32)
    pts[(0,) * len(lead) + (4,)] = origin[(0,) * len(lead)]
    got = geometry.camera_rays_from_origin(t(pts), t(origin))
    ref = jax.jit(jgeo.camera_rays_from_origin)(pts, origin)
    assert got.shape == lead + (9, 3)
    assert_close(got, ref, 1e-6)
    zero = (0,) * len(lead) + (4,)
    assert not np.asarray(ref)[zero].any() and not got.numpy()[zero].any()


def test_backproject_and_project():
    rng = np.random.RandomState(2)
    b, h, w = 2, 6, 9
    K, invK = _intrinsics(b, 1, h, w)
    depth = rng.uniform(0.5, 4.0, (b, h, w)).astype(np.float32)
    pts = geometry.backproject_depth(t(depth), t(invK))
    assert_close(pts, jgeo.backproject_depth(depth, invK), 1e-6)
    T = _poses(rng, b, 1)[:, 0]
    got = geometry.project_points(pts.reshape(b, -1, 4), t(K[:, 0]), t(T))
    ref = jgeo.project_points(np.asarray(pts).reshape(b, -1, 4), K[:, 0], T)
    assert_close(got, ref, 1e-5)


@pytest.mark.parametrize("dtype", [np.float32])
def test_sample_bilinear_and_nearest_idx(dtype):
    rng = np.random.RandomState(3)
    n, h, w, c = 3, 7, 9, 5
    img = rng.randn(n, h, w, c).astype(dtype)
    x = rng.uniform(-2, w + 1, (n, 4, 6)).astype(np.float32)
    y = rng.uniform(-2, h + 1, (n, 4, 6)).astype(np.float32)
    x[0, 0, :3] = [0.0, w - 1.0, 2.5]  # exact pixel centres and a rounding tie
    got = sampling.sample_bilinear_idx(t(img), t(x), t(y))
    ref = jax.vmap(jsamp.sample_bilinear_idx)(img, x, y)
    assert_close(got, ref, 1e-5)
    got = sampling.sample_nearest_idx(t(img), t(x), t(y))
    ref = jax.vmap(jsamp.sample_nearest_idx)(img, x, y)
    assert_close(got, ref, 0.0)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_matches_jax(mode, align_corners):
    rng = np.random.RandomState(4)
    img = rng.randn(2, 6, 8, 3).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 5, 4, 2)).astype(np.float32)
    got = sampling.grid_sample(t(img), t(grid), mode=mode, align_corners=align_corners)
    ref = jsamp.grid_sample(jnp.asarray(img), jnp.asarray(grid), mode=mode,
                            align_corners=align_corners)
    assert_close(got, ref, 1e-5)


def test_grid_sample_matches_torch_grid_sample():
    """The index-space convention is F.grid_sample's (align_corners=False,
    zeros padding)."""
    rng = np.random.RandomState(5)
    img = rng.randn(2, 6, 8, 3).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 5, 4, 2)).astype(np.float32)
    got = sampling.grid_sample(t(img), t(grid))
    ref = F.grid_sample(t(img).permute(0, 3, 1, 2), t(grid), mode="bilinear",
                        padding_mode="zeros", align_corners=False).permute(0, 2, 3, 1)
    assert_close(got, ref.numpy(), 1e-5)
