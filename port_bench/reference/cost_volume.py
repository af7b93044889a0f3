"""Frozen plain copy of implicit_depth_tpu_torch/volumes/cost_volume.py for the benchmark's
f32 reference; it imports nothing of the port. The warp is the plain one (kernels_plain).

Plane-sweep warp of the source views and its metadata (torch, NHWC),
the dot-product and zero cost volumes, and the mask of pixels that some
source view sees at the last plane.

Counterpart of implicit_depth_tpu/volumes/cost_volume.py. Every source view
is warped to every depth plane with `F.grid_sample` semantics (bilinear,
zeros padding, align_corners=False) and the metadata groups of the
reference's 202-channel concat are returned as separate tensors
(WarpedViews); the metadata MLP consumes them with per-group matmuls against
slices of its first-layer kernel. Two warps:
- `build_warped_views`, the JAX package's flat branch: the warp kernels of
  ops/warp_kernel.py (DepthNet's path);
- `warped_views_from_components`, its non-flat branch: the gather sampler,
  on which the plain versions of the fused volume kernels are built.

Faithful quirks kept from the reference: z is clamped at 1e-5 before the
validity test, so the mask is identically 1 and the clamped z is the depth
metadata; the ray "cosine" is a plain dot of two unit rays.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from port_bench.reference import geometry
from port_bench.reference.sampling import sample_bilinear_idx
from port_bench.reference.kernels_plain import warp_planes as warp_planes_diff

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


def _with_metadata(feats: Tensor, z: Tensor, cur_feats_bhwc: Tensor, origins_bk3: Tensor,
                   invK_b33: Tensor, depth_planes_d: Tensor, pose_dist_bk3: Tensor,
                   compute_dtype) -> WarpedViews:
    """The metadata groups around warped features `feats` (b, k, d, h, w, c)
    and the clamped source depth `z` (b, k, d, h, w)."""
    h, w = z.shape[-2:]
    grid_hw3 = geometry.pixel_grid(h, w, device=z.device)
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
    current frame and the current inverse intrinsics, with the gather
    sampler: the plain versions of the fused volume kernels build on it, so
    it never runs a kernel."""
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
    return _with_metadata(feats, z, cur_feats_bhwc, origins_bk3, invK_b33, depth_planes_d,
                          pose_dist_bk3, compute_dtype)


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
    """Warps all source views onto the current view at every depth plane
    through ops/warp_kernel.py::warp_planes_diff (the JAX package's flat
    branch): kernel #5 forward and #6 backward on CUDA tensors, their plain
    versions on CPU tensors. Batch and views are flattened into the warp's
    view axis; only the source depth z (row 2 of the homography) is
    computed here.

    src_T_cur: current-cam -> source-cam; src_poses: source-cam ->
    current-cam (cur_T_src). Geometry is f32 whatever `compute_dtype`; the
    warped features take `compute_dtype`.
    """
    b, k, h, w, c = src_feats_bkhwc.shape
    d = depth_planes_d.shape[0]
    A, bv = geometry.homography_components(src_K_bk44, src_T_cur_bk44, cur_invK_b44)
    grid_hw3 = geometry.pixel_grid(h, w, device=src_feats_bkhwc.device)
    z = torch.einsum("bkj,hwj->bkhw", A[..., 2, :], grid_hw3)
    z = torch.clamp(depth_planes_d[None, None, :, None, None] * z[:, :, None]
                    + bv[..., 2, None, None, None], min=1e-5)   # (b, k, d, h, w)

    src = src_feats_bkhwc.to(compute_dtype).reshape(b * k, h, w, c).contiguous()
    feats = warp_planes_diff(src, A.reshape(b * k, 3, 3).contiguous(),
                             bv.reshape(b * k, 3).contiguous(), depth_planes_d.float().contiguous())
    feats = feats.reshape(b, k, d, h, w, c)
    pd, rm, tm = geometry.pose_distance(src_poses_bk44)
    return _with_metadata(feats, z, cur_feats_bhwc, src_poses_bk44[:, :, :3, 3],
                          cur_invK_b44[:, :3, :3], depth_planes_d,
                          torch.stack([pd, rm, tm], dim=-1), compute_dtype)


def dot_cost_volume(wv: WarpedViews) -> Tensor:
    """Plain dot-product cost volume summed over views, (b, d, h, w)."""
    return wv.dot.sum(dim=1)


def zero_cost_volume(batch: int, num_planes: int, h: int, w: int, dtype=torch.float32,
                     device=None) -> Tensor:
    """The ablation volume of zeros, (b, d, h, w)."""
    return torch.zeros((batch, num_planes, h, w), dtype=dtype, device=device)


def lowest_cost_depth(cost_bdhw: Tensor, depth_planes_d: Tensor) -> Tensor:
    """Depth of the arg-max plane, (b, h, w)."""
    return depth_planes_d[torch.argmax(cost_bdhw, dim=1)]


def overall_source_mask(wv: WarpedViews, src_K_bk44: Tensor, src_T_cur_bk44: Tensor,
                        cur_invK_b44: Tensor, h: int, w: int) -> Tensor:
    """(b, h, w) bool: true where any source view is usable at the last
    depth plane, i.e. its sample lies strictly inside a 2 px border (z
    clamped at 1e-5, as in the warp, so "in front of the view" always
    holds). Geometry in f32 with autocast off."""
    with torch.autocast(wv.depth_planes.device.type, enabled=False):
        M = geometry.plane_homographies(src_K_bk44.float(), src_T_cur_bk44.float(),
                                        cur_invK_b44.float(), wv.depth_planes[-1:].float())[:, :, 0]
        grid_hw3 = geometry.pixel_grid(h, w, device=M.device)
        xyz = torch.einsum("bkij,hwj->bkhwi", M, grid_hw3)
        z = torch.clamp(xyz[..., 2], min=1e-5)
        u, v = xyz[..., 0] / z, xyz[..., 1] / z
        return ((u > 2) & (u < w - 2) & (v > 2) & (v < h - 2)).any(dim=1)
