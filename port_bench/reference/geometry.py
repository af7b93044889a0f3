"""Frozen plain copy of implicit_depth_tpu_torch/core/geometry.py for the benchmark's
f32 reference; it imports nothing of the port. Unchanged.

Camera geometry primitives (torch, f32).

Counterpart of implicit_depth_tpu/core/geometry.py. The pose and
intrinsics products are f32 at full precision: on the GPU the caller keeps
`torch.backends.cuda.matmul.allow_tf32 = False` (PyTorch's default), so
`einsum` runs in true f32 like the JAX package's `Precision.HIGHEST`.

`rotx`, `roty`, `rotz` and `qvec2rotmat` are host-side numpy, copies of
the JAX module's (the data loaders' world-frame fix-ups).
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def pixel_grid(height: int, width: int, dtype=torch.float32, device=None) -> Tensor:
    """Homogeneous pixel-centre coordinates, shape (H, W, 3):
    grid[y, x] = (x + 0.5, y + 0.5, 1)."""
    xs = torch.arange(width, dtype=dtype, device=device) + 0.5
    ys = torch.arange(height, dtype=dtype, device=device) + 0.5
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx, yy, torch.ones_like(xx)], dim=-1)


def to_homogeneous(points: Tensor) -> Tensor:
    """(..., k) -> (..., k+1) with a trailing 1."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def backproject_depth(depth_hw: Tensor, invK_44: Tensor) -> Tensor:
    """(..., H, W) depths -> (..., H, W, 4) homogeneous camera points,
    X = depth * K^-1 @ (u+0.5, v+0.5, 1)."""
    h, w = depth_hw.shape[-2], depth_hw.shape[-1]
    grid = pixel_grid(h, w, depth_hw.dtype, depth_hw.device)
    rays = torch.einsum("...ij,hwj->...hwi", invK_44[..., :3, :3], grid)
    return to_homogeneous(rays * depth_hw[..., None])


def project_points(points_n4: Tensor, K_44: Tensor, cam_T_world_44: Tensor,
                   eps: float = 1e-5) -> Tensor:
    """(..., N, 4) homogeneous points -> (..., N, 3) = (u, v, z); z is
    clamped below at `eps` before the divide."""
    P = torch.einsum("...ij,...jk->...ik", K_44, cam_T_world_44)[..., :3, :]
    cam = torch.einsum("...ij,...nj->...ni", P, points_n4)
    z = torch.clamp(cam[..., 2:3], min=eps)
    return torch.cat([cam[..., :2] / z, z], dim=-1)


def homography_components(src_K_k44: Tensor, src_T_cur_k44: Tensor,
                          cur_invK_44: Tensor) -> tuple[Tensor, Tensor]:
    """A = srcK R curK^-1 and b = srcK t, so that the plane-sweep warp at
    depth d is M(d) = d A + b e3^T. Shapes (..., k, 3, 3) and (..., k, 3)."""
    A = torch.einsum(
        "...kij,...kjl,...lm->...kim",
        src_K_k44[..., :3, :3], src_T_cur_k44[..., :3, :3], cur_invK_44[..., :3, :3],
    )
    b = torch.einsum("...kij,...kj->...ki", src_K_k44[..., :3, :3], src_T_cur_k44[..., :3, 3])
    return A, b


def plane_homographies(src_K_k44: Tensor, src_T_cur_k44: Tensor,
                       cur_invK_44: Tensor, depth_planes_d: Tensor) -> Tensor:
    """(..., k, d, 3, 3) matrices M with (x, y, z)^T = M @ (u+.5, v+.5, 1)."""
    A, b = homography_components(src_K_k44, src_T_cur_k44, cur_invK_44)
    const = torch.zeros_like(A)
    const[..., :, 2] = b
    d = depth_planes_d[..., None, :, None, None]
    return d * A[..., :, None, :, :] + const[..., :, None, :, :]


def log_depth_planes(min_depth: float, max_depth: float, num_planes: int,
                     dtype=torch.float32, device=None) -> Tensor:
    """Log-spaced depth planes, computed in `dtype` as the JAX package does."""
    ramp = torch.linspace(0.0, 1.0, num_planes, dtype=dtype, device=device)
    lo = torch.log(torch.tensor(min_depth, dtype=dtype, device=device))
    span = torch.log(torch.tensor(max_depth / min_depth, dtype=dtype, device=device))
    return torch.exp(lo + span * ramp)


def pose_distance(pose_44: Tensor):
    """DVMVS pose distance -> (combined, rotation_measure, translation_measure)."""
    R = pose_44[..., :3, :3]
    t = pose_44[..., :3, 3]
    trace = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    r_measure = torch.sqrt(torch.clamp(
        2.0 * (1.0 - torch.clamp(trace, max=3.0) / 3.0), min=0.0))
    t_measure = torch.linalg.norm(t, dim=-1)
    combined = torch.sqrt(t_measure ** 2 + r_measure ** 2)
    return combined, r_measure, t_measure


def normalize(v: Tensor, dim: int = -1, eps: float = 1e-12) -> Tensor:
    """L2-normalise along `dim`, with the norm clamped at `eps`."""
    return v / torch.clamp(torch.linalg.norm(v, dim=dim, keepdim=True), min=eps)


def camera_rays_from_origin(points_n3: Tensor, origin_3: Tensor) -> Tensor:
    """Unit rays (..., n, 3) from a camera origin (..., 3) to points
    (..., n, 3); the origin broadcasts over the points."""
    return normalize(points_n3 - origin_3[..., None, :], dim=-1)


def rotx(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)


def roty(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)


def rotz(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)


def qvec2rotmat(qvec) -> np.ndarray:
    """Quaternion (w, x, y, z) to rotation matrix (utils/geometry_utils.py:198-220)."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * w * x],
            [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x**2 - 2 * y**2],
        ]
    )
