"""Plane-sweep warp of the source views and its metadata (torch, NHWC).

Counterpart of implicit_depth_tpu/volumes/cost_volume.py (its unfused,
non-flat branch). Every source view is warped to every depth plane with
`F.grid_sample` semantics (bilinear, zeros padding, align_corners=False)
and the metadata groups of the reference's 202-channel concat are returned
as separate tensors (WarpedViews); the metadata MLP consumes them with
per-group matmuls against slices of its first-layer kernel.

Faithful quirks kept from the reference: z is clamped at 1e-5 before the
validity test, so the mask is identically 1 and the clamped z is the depth
metadata; the ray "cosine" is a plain dot of two unit rays.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from implicit_depth_tpu_torch.core import geometry
from implicit_depth_tpu_torch.core.sampling import sample_bilinear_idx

Tensor = torch.Tensor


class WarpedViews(NamedTuple):
    """Warp products and metadata groups (b batch, k source views,
    d planes, h/w matching resolution, c matching channels)."""

    feats: Tensor        # (b, k, d, h, w, c) warped source features
    depths: Tensor       # (b, k, d, h, w) clamped source-view depth
    mask: Tensor         # (b, k, d, h, w) identically 1
    dot: Tensor          # (b, k, d, h, w) <warped src, cur>
    cur_rays: Tensor     # (b, h, w, 3) unit rays of the current view
    src_rays: Tensor     # (b, k, d, h, w, 3) unit rays from the source origins
    ray_angle: Tensor    # (b, k, d, h, w) cos of the angle between them
    pose_dist: Tensor    # (b, k, 3) (combined, r, t) pose distances
    depth_planes: Tensor  # (d,)


def warped_views_from_components(
    cur_feats_bhwc: Tensor,
    src_feats_bkhwc: Tensor,
    A_bk33: Tensor,
    b_bk3: Tensor,
    origins_bk3: Tensor,
    invK_b33: Tensor,
    depth_planes_d: Tensor,
    pose_dist_bk3: Tensor,
    compute_dtype=torch.float32,
) -> WarpedViews:
    """The warp and metadata from the homography components
    (A, b = geometry.homography_components), the source origins in the
    current frame and the current inverse intrinsics."""
    b, k, h, w, c = src_feats_bkhwc.shape
    d = depth_planes_d.shape[0]
    grid_hw3 = geometry.pixel_grid(h, w, device=src_feats_bkhwc.device)

    # M(d) = d A + b e3^T, applied to the +0.5-centred pixel grid (f32)
    const = torch.zeros_like(A_bk33)
    const[..., :, 2] = b_bk3
    M = depth_planes_d[None, None, :, None, None] * A_bk33[:, :, None] + const[:, :, None]
    xyz = torch.einsum("bkdij,hwj->bkdhwi", M, grid_hw3)  # (b, k, d, h, w, 3)
    z = torch.clamp(xyz[..., 2], min=1e-5)
    x_idx = torch.clamp(xyz[..., 0] / z - 0.5, -2.0 * w, 2.0 * w)
    y_idx = torch.clamp(xyz[..., 1] / z - 0.5, -2.0 * h, 2.0 * h)

    src = src_feats_bkhwc.to(compute_dtype).reshape(b * k, h, w, c)
    feats = sample_bilinear_idx(src, x_idx.reshape(b * k, d, h, w),
                                y_idx.reshape(b * k, d, h, w))
    feats = feats.reshape(b, k, d, h, w, c)

    mask = torch.ones_like(z, dtype=compute_dtype)
    cur = cur_feats_bhwc.to(compute_dtype)
    dot = torch.einsum("bkdhwc,bhwc->bkdhw", feats, cur) * mask

    rays = torch.einsum("bij,hwj->bhwi", invK_b33, grid_hw3)
    cur_rays = geometry.normalize(rays)
    world_pts = (rays.to(compute_dtype)[:, None, None]
                 * depth_planes_d.to(compute_dtype)[None, None, :, None, None, None])
    src_origin = origins_bk3.to(compute_dtype)
    src_rays = geometry.normalize(world_pts - src_origin[:, :, None, None, None, :])
    ray_angle = torch.einsum("bhwi,bkdhwi->bkdhw", cur_rays.to(compute_dtype), src_rays)

    return WarpedViews(
        feats=feats,
        depths=z.to(compute_dtype),
        mask=mask,
        dot=dot,
        cur_rays=cur_rays.to(compute_dtype),
        src_rays=src_rays.to(compute_dtype),
        ray_angle=ray_angle.to(compute_dtype),
        pose_dist=pose_dist_bk3.to(compute_dtype),
        depth_planes=depth_planes_d,
    )


def build_warped_views(
    cur_feats_bhwc: Tensor,
    src_feats_bkhwc: Tensor,
    src_K_bk44: Tensor,
    src_T_cur_bk44: Tensor,
    cur_invK_b44: Tensor,
    src_poses_bk44: Tensor,
    depth_planes_d: Tensor,
    compute_dtype=torch.float32,
) -> WarpedViews:
    """Warps all source views onto the current view at every depth plane.

    src_T_cur: current-cam -> source-cam; src_poses: source-cam ->
    current-cam (cur_T_src). Geometry is f32 whatever `compute_dtype`.
    """
    A, b = geometry.homography_components(src_K_bk44, src_T_cur_bk44, cur_invK_b44)
    pd, rm, tm = geometry.pose_distance(src_poses_bk44)
    return warped_views_from_components(
        cur_feats_bhwc, src_feats_bkhwc, A, b, src_poses_bk44[:, :, :3, 3],
        cur_invK_b44[:, :3, :3], depth_planes_d, torch.stack([pd, rm, tm], dim=-1),
        compute_dtype=compute_dtype,
    )


def lowest_cost_depth(cost_bdhw: Tensor, depth_planes_d: Tensor) -> Tensor:
    """Depth of the arg-max plane, (b, h, w)."""
    return depth_planes_d[torch.argmax(cost_bdhw, dim=1)]
