"""Frozen plain copy of implicit_depth_tpu_torch/models/volume_mlp.py for the benchmark's
f32 reference; it imports nothing of the port. The fused volume is the plain one (kernels_plain), one batch element at a time.

Metadata feature-volume MLP (the SimpleRecon "metadata cost volume").

Counterpart of implicit_depth_tpu/models/volume_mlp.py. Per (pixel, plane)
the reference concatenates 202 channels (visual features of all views plus
geometric metadata) and runs MLP([202, 128, 128, 1]) with LeakyReLU(0.01).
The concat is never built: fc0 is applied per metadata group through row
slices of one (202, hidden) kernel kept in the reference's channel order

    [ src visual k*c | cur visual c | mask k | depths k | plane 1 |
      dot k | ray_angle k | cur ray 3 | src rays k*3 |
      pose_penalty k | r_measure k | t_measure k ]

Two paths share the parameters:
- forward: over a WarpedViews bundle (grouped matmuls);
- fused:   ops/fused_volume.py::fused_metadata_volume, which on a CUDA
  tensor is the hand-written kernel (warp + metadata + MLP, nothing of
  size (k, d, h, w, .) in device memory) and on a CPU tensor its plain
  version.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference import geometry
from port_bench.reference.cost_volume import WarpedViews

Tensor = torch.Tensor


def fc0_slices(kernel: Tensor, k: int, c: int, hidden: int, dtype=None) -> dict:
    """Row slices of the (202, hidden) fc0 kernel in the reference order."""
    w1 = kernel if dtype is None else kernel.to(dtype)
    out = {}
    o = 0
    for name, n in (("vis_src", k * c), ("vis_cur", c), ("mask", k), ("depths", k),
                    ("plane", 1), ("dot", k), ("angle", k), ("ray_cur", 3),
                    ("ray_src", k * 3), ("pen", k), ("rm", k), ("tm", k)):
        out[name] = w1[o: o + n]
        o += n
    if o != w1.shape[0]:
        raise ValueError(f"fc0 kernel has {w1.shape[0]} rows, expected {o}")
    out["vis_src"] = out["vis_src"].reshape(k, c, hidden)
    out["ray_src"] = out["ray_src"].reshape(k, 3, hidden)
    out["plane"] = out["plane"][0]
    return out


def apply_metadata_mlp(params: dict, wv: WarpedViews, cur_feats_bhwc: Tensor,
                       *, k: int, c: int, hidden: int, dt) -> Tensor:
    """Grouped-matmul metadata MLP over a WarpedViews bundle with explicit
    params {fc0_kernel, fc0_bias, fc1: {kernel, bias}, fc2: {kernel, bias}}
    (kernels in (in, out) layout). Returns (b, d, h, w)."""
    w = fc0_slices(params["fc0_kernel"], k, c, hidden, dtype=dt)
    cur = cur_feats_bhwc.to(dt)

    h1 = torch.einsum("bkdhwc,kcf->bdhwf", wv.feats.to(dt), w["vis_src"])
    meta4 = torch.stack([wv.depths.to(dt), wv.mask.to(dt), wv.dot.to(dt),
                         wv.ray_angle.to(dt)], dim=-1)  # (b, k, d, h, w, 4)
    w_meta4 = torch.stack([w["depths"], w["mask"], w["dot"], w["angle"]], dim=1)
    h1 = h1 + torch.einsum("bkdhwi,kif->bdhwf", meta4, w_meta4)
    h1 = h1 + torch.einsum("bkdhwi,kif->bdhwf", wv.src_rays.to(dt), w["ray_src"])

    h1 = h1 + (wv.depth_planes.to(dt)[:, None] * w["plane"])[None, :, None, None, :]
    per_pix = torch.einsum("bhwc,cf->bhwf", cur, w["vis_cur"])
    per_pix = per_pix + torch.einsum("bhwi,if->bhwf", wv.cur_rays.to(dt), w["ray_cur"])
    h1 = h1 + per_pix[:, None]
    w_pose = torch.stack([w["pen"], w["rm"], w["tm"]], dim=-2)  # (k, 3, hidden)
    per_b = torch.einsum("bki,kif->bf", wv.pose_dist.to(dt), w_pose)
    h1 = h1 + per_b[:, None, None, None, :]

    h1 = F.leaky_relu(h1 + params["fc0_bias"].to(dt), 0.01)
    h2 = F.leaky_relu(h1 @ params["fc1"]["kernel"].to(dt) + params["fc1"]["bias"].to(dt), 0.01)
    out = h2 @ params["fc2"]["kernel"].to(dt) + params["fc2"]["bias"].to(dt)
    return out[..., 0]


def _geometry_operands(src_K_bk44: Tensor, src_T_cur_bk44: Tensor,
                       cur_invK_b44: Tensor, cur_T_src_bk44: Tensor):
    """Kernel geometry operands: A, b, source origins, current K^-1 (3x3)."""
    A_bk33, b_bk3 = geometry.homography_components(src_K_bk44, src_T_cur_bk44, cur_invK_b44)
    origins = cur_T_src_bk44[:, :, :3, 3]
    invK3 = cur_invK_b44[:, :3, :3]
    return A_bk33, b_bk3, origins, invK3


def _weight_operands(params: dict, cur_feats_bhwc: Tensor, invK3_b33: Tensor,
                     cur_T_src_bk44: Tensor, *, k: int, c: int, hidden: int):
    """The (b, h, F, w) `base` map of first-layer terms that do not depend
    on the plane or the source samples (current visuals, current rays, pose
    distances, the mask row [identically 1], fc0 bias), plus the repacked
    MLP weights. All f32."""
    F_ = hidden
    h, w = cur_feats_bhwc.shape[1:3]
    sl = fc0_slices(params["fc0_kernel"].float(), k, c, hidden)

    grid_hw3 = geometry.pixel_grid(h, w, device=cur_feats_bhwc.device)
    rays = torch.einsum("bij,hwj->bhwi", invK3_b33, grid_hw3)
    cur_rays = geometry.normalize(rays)
    per_pix = torch.einsum("bhwc,cf->bhwf", cur_feats_bhwc.float(), sl["vis_cur"])
    per_pix = per_pix + torch.einsum("bhwi,if->bhwf", cur_rays, sl["ray_cur"])
    pd, rm, tm = geometry.pose_distance(cur_T_src_bk44)
    pose = torch.stack([pd, rm, tm], dim=-1)  # (b, k, 3)
    w_pose = torch.stack([sl["pen"], sl["rm"], sl["tm"]], dim=-2)
    per_b = torch.einsum("bki,kif->bf", pose.float(), w_pose)
    base = per_pix + per_b[:, None, None, :] + sl["mask"].sum(0) + params["fc0_bias"].float()
    base = base.permute(0, 1, 3, 2).contiguous()  # (b, h, F, w)

    w_visT = sl["vis_src"].reshape(k * c, F_).t().contiguous()  # (F, k*c)
    zeros = torch.zeros_like(sl["depths"])
    w_meta = torch.stack(
        [sl["depths"], sl["dot"], sl["angle"], sl["ray_src"][:, 0], sl["ray_src"][:, 1],
         sl["ray_src"][:, 2], zeros, zeros], dim=1)  # (k, 8, F)
    w_metaT = w_meta.reshape(k * 8, F_).t().contiguous()  # (F, k*8)

    return (base, w_visT, w_metaT, sl["plane"][:, None].contiguous(),
            params["fc1"]["kernel"].float().t().contiguous(),
            params["fc1"]["bias"].float()[:, None].contiguous(),
            params["fc2"]["kernel"].float()[:, :1].contiguous(),
            params["fc2"]["bias"].float().reshape(1).contiguous())


def fused_operands(params: dict, cur_feats_bhwc: Tensor, src_feats_bkhwc: Tensor,
                   src_K_bk44: Tensor, src_T_cur_bk44: Tensor, cur_invK_b44: Tensor,
                   cur_T_src_bk44: Tensor, planes_d: Tensor,
                   *, k: int, c: int, hidden: int) -> tuple:
    """The operand tuple of ops/fused_volume.py::fused_metadata_volume.
    Features keep their dtype (f32 or bf16), and w_visT and w_fc1T take
    it too, as the kernel's contract says; the rest is f32."""
    A, b, origins, invK3 = _geometry_operands(
        src_K_bk44.float(), src_T_cur_bk44.float(), cur_invK_b44.float(),
        cur_T_src_bk44.float())
    (base, w_visT, w_metaT, w_plane, w_fc1T, b_fc1, w_fc2, b_fc2) = _weight_operands(
        params, cur_feats_bhwc, invK3, cur_T_src_bk44.float(), k=k, c=c, hidden=hidden)
    cdt = src_feats_bkhwc.dtype
    return (cur_feats_bhwc.to(cdt).contiguous(), src_feats_bkhwc.contiguous(),
            A.contiguous(), b.contiguous(), origins.contiguous(), invK3.contiguous(),
            planes_d.float().contiguous(), base, w_visT.to(cdt), w_metaT, w_plane,
            w_fc1T.to(cdt), b_fc1, w_fc2, b_fc2)


def fused_forward(params: dict, cur_feats_bhwc: Tensor, src_feats_bkhwc: Tensor,
                  src_K_bk44: Tensor, src_T_cur_bk44: Tensor, cur_invK_b44: Tensor,
                  cur_T_src_bk44: Tensor, planes_d: Tensor,
                  *, k: int, c: int, hidden: int) -> Tensor:
    """Warp + metadata + MLP through ops/fused_volume.py: the CUDA kernel
    for CUDA tensors, its plain version for CPU tensors. Returns
    (b, d, h, w) f32."""
    return _plain_volume(*fused_operands(
        params, cur_feats_bhwc, src_feats_bkhwc, src_K_bk44, src_T_cur_bk44,
        cur_invK_b44, cur_T_src_bk44, planes_d, k=k, c=c, hidden=hidden))


def _plain_volume(cur, src, A, b, origins, invK, planes, base, *weights) -> Tensor:
    """Kernel #1's plain function over its operands, one batch element at a
    time (kernels_plain.by_element)."""
    from port_bench.reference.kernels_plain import by_element, fused_volume

    def one(cur, src, A, b, origins, invK, base):
        return fused_volume(cur, src, A, b, origins, invK, planes, base, *weights)

    return by_element(one, cur, src, A, b, origins, invK, base)


def metadata_input_channels(num_src_views: int, matching_dim: int) -> int:
    """Width of the reference's metadata concat (202 for k=7, c=16)."""
    k, c = num_src_views, matching_dim
    return c * (1 + k) + (1 + k) + 3 * (1 + k) + k + k + k + 3 * k


class MetadataVolumeMLP(nn.Module):
    """Produces the (b, d, h, w) feature volume. Parameter names follow the
    flax module: fc0_kernel (202, hidden) and fc0_bias are raw parameters,
    fc1 and fc2 are Linear layers."""

    def __init__(self, num_src_views: int = 7, matching_dim: int = 16, hidden: int = 128):
        super().__init__()
        self.num_src_views = num_src_views
        self.matching_dim = matching_dim
        self.hidden = hidden
        cin = metadata_input_channels(num_src_views, matching_dim)
        self.fc0_kernel = nn.Parameter(torch.zeros(cin, hidden))
        self.fc0_bias = nn.Parameter(torch.zeros(hidden))
        self.fc1 = nn.Linear(hidden, hidden)
        self.fc2 = nn.Linear(hidden, 1)

    def params_dict(self) -> dict:
        """The parameters in the JAX package's (in, out) kernel layout."""
        return {
            "fc0_kernel": self.fc0_kernel,
            "fc0_bias": self.fc0_bias,
            "fc1": {"kernel": self.fc1.weight.t(), "bias": self.fc1.bias},
            "fc2": {"kernel": self.fc2.weight.t(), "bias": self.fc2.bias},
        }

    def forward(self, wv: WarpedViews, cur_feats_bhwc: Tensor) -> Tensor:
        """The volume over a WarpedViews bundle, in the features' dtype."""
        return apply_metadata_mlp(
            self.params_dict(), wv, cur_feats_bhwc,
            k=self.num_src_views, c=self.matching_dim, hidden=self.hidden, dt=wv.feats.dtype)

    def fused(self, cur_feats_bhwc: Tensor, src_feats_bkhwc: Tensor, src_K_bk44: Tensor,
              src_T_cur_bk44: Tensor, cur_invK_b44: Tensor, cur_T_src_bk44: Tensor,
              planes_d: Tensor) -> Tensor:
        """Single-kernel warp + metadata + MLP (eval path)."""
        return fused_forward(
            self.params_dict(), cur_feats_bhwc, src_feats_bkhwc, src_K_bk44,
            src_T_cur_bk44, cur_invK_b44, cur_T_src_bk44, planes_d,
            k=self.num_src_views, c=self.matching_dim, hidden=self.hidden)

    def fused_train(self, cur_feats_bhwc: Tensor, src_feats_bkhwc: Tensor, src_K_bk44: Tensor,
                    src_T_cur_bk44: Tensor, cur_invK_b44: Tensor, cur_T_src_bk44: Tensor,
                    planes_d: Tensor) -> Tensor:
        """The differentiable volume (b, d, h, w) f32 of the training path:
        ops/fused_volume.py::fused_metadata_volume_train, forward kernel #1
        and backward kernel #2 over the operands. Autograd carries the
        operand gradients to the parameters and the current features
        through `_weight_operands` (the `base` map and the repacked
        weights); the current features' dot-metadata gradient from the
        kernel adds to it. The geometry is a constant."""

        k, c = self.num_src_views, self.matching_dim
        A, b, origins, invK3 = _geometry_operands(
            src_K_bk44.float(), src_T_cur_bk44.float(), cur_invK_b44.float(),
            cur_T_src_bk44.float())
        weights = _weight_operands(self.params_dict(), cur_feats_bhwc, invK3,
                                   cur_T_src_bk44.float(), k=k, c=c, hidden=self.hidden)
        cdt = src_feats_bkhwc.dtype
        return _plain_volume(
            cur_feats_bhwc.to(cdt).contiguous(), src_feats_bkhwc.contiguous(), A.contiguous(),
            b.contiguous(), origins.contiguous(), invK3.contiguous(),
            planes_d.float().contiguous(), *weights)
