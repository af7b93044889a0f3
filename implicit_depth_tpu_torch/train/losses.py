"""Training losses, counterpart of implicit_depth_tpu/train/losses.py, with
explicit masks where the reference used NaN:
- BD: masked_mean, bce_with_logits, binary_losses (BCE with logits and a
  sharpness regulariser over the four query scales);
- regression: scale_invariant_loss, ms_gradient_loss, normals_loss,
  mv_depth_loss and regression_losses (the SimpleRecon cocktail
  ms + grad + normals + 0.2 mv, with a hypersim branch without the last
  three)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from implicit_depth_tpu_torch.core import geometry
from implicit_depth_tpu_torch.core.sampling import grid_sample
from implicit_depth_tpu_torch.ops import image as image_ops

Tensor = torch.Tensor


def masked_mean(x: Tensor, mask: Tensor, eps: float = 1e-10) -> Tensor:
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=eps)


def bce_with_logits(logits: Tensor, target: Tensor, pos_weight: float = 1.0) -> Tensor:
    """BCEWithLogitsLoss(reduction='none', pos_weight)."""
    return pos_weight * target * F.softplus(-logits) + (1.0 - target) * F.softplus(logits)


def binary_losses(query_depth: Tensor, gt_depth: Tensor, preds: dict, *,
                  pos_weight: float = 1.0, regularisation_weight: float = 0.5,
                  edge_mask: Optional[Tensor] = None, sigmoid_multiplier: float = 1.0,
                  train: bool = True, subsample_axis: int = 1) -> dict:
    """BCE + sharpness regulariser over scales. target = (query < gt),
    valid where both depths > 0; scale s > 0 uses every (s+1)-th ray along
    `subsample_axis`. query_depth (b, N, S), gt_depth broadcastable to it,
    preds {"pred_s": logits}, edge_mask (b, N, 1) or None."""
    target = (query_depth < gt_depth).float()
    mask = (gt_depth > 0) & (query_depth > 0)
    losses = {}
    total = 0.0
    scales = (0, 1, 2, 3) if train else (0,)
    for s in scales:
        pred = preds[f"pred_{s}"].float()
        if train and s > 0:
            sl = [slice(None)] * target.dim()
            sl[subsample_axis] = slice(None, None, s + 1)
            t_s, m_s = target[tuple(sl)], mask[tuple(sl)]
            e_s = edge_mask[tuple(sl)] if edge_mask is not None else None
        else:
            t_s, m_s, e_s = target, mask, edge_mask
        bce = masked_mean(bce_with_logits(pred, t_s, pos_weight), m_s)
        losses[f"binary_loss/{s}"] = bce
        reg_mask = m_s if e_s is None else (e_s > 0) & m_s
        dist = 2.0 * (0.5 - torch.abs(torch.sigmoid(sigmoid_multiplier * pred) - 0.5))
        reg = masked_mean(dist, reg_mask)
        losses[f"reg_loss/{s}"] = reg
        total = total + bce + regularisation_weight * reg
    losses["binary_loss"] = total / len(scales)
    losses["loss"] = losses["binary_loss"]
    return losses


def scale_invariant_loss(log_gt: Tensor, log_pred: Tensor, mask: Tensor,
                         si_lambda: float = 0.85) -> Tensor:
    """Eigen's scale-invariant loss over the masked pixels."""
    m = mask.to(log_gt.dtype)
    n = torch.clamp(m.sum(), min=1e-10)
    diff = (log_gt - log_pred) * m
    mean_sq = torch.sum(diff * diff) / n
    mean = torch.sum(diff) / n
    return torch.sqrt(mean_sq - si_lambda * mean * mean)


def ms_gradient_loss(depth_gt: Tensor, depth_pred: Tensor, num_scales: int = 4) -> Tensor:
    """L1 of the sobel gradients over a `num_scales` blur-pool pyramid; GT
    gradients that are not finite (NaN-invalid depths) are masked."""
    loss = 0.0
    for g, p in zip(image_ops.pyrdown(depth_gt, num_scales),
                    image_ops.pyrdown(depth_pred, num_scales)):
        g_grad = torch.stack(image_ops.spatial_gradient(g), dim=-1)
        p_grad = torch.stack(image_ops.spatial_gradient(p), dim=-1)
        finite = torch.isfinite(g_grad).all(dim=-1, keepdim=True).expand_as(g_grad)
        err = torch.abs(torch.where(finite, p_grad - g_grad, 0.0))
        loss = loss + masked_mean(err, finite)
    return loss


def normals_loss(normals_gt: Tensor, normals_pred: Tensor) -> Tensor:
    """0.5 (1 - <n_gt, n_pred>) over the pixels where both are finite."""
    finite = (torch.isfinite(normals_gt).all(dim=-1, keepdim=True)
              & torch.isfinite(normals_pred).all(dim=-1, keepdim=True))
    ng = torch.where(finite, normals_gt, 1.0)
    npr = torch.where(finite, normals_pred, 1.0)
    dot = torch.sum(ng * npr, dim=-1, keepdim=True)
    return masked_mean(0.5 * (1.0 - dot), finite)


def mv_depth_loss(depth_pred: Tensor, src_depth: Tensor, cur_invK: Tensor, src_K: Tensor,
                  cur_world_T_cam: Tensor, src_cam_T_world: Tensor) -> Tensor:
    """Multi-view depth consistency: the predicted depth (b, h, w, 1) is
    projected into each source view (src_depth (b, k, h, w, 1), NaN
    invalid); log-L1 against the source depth sampled (nearest) there,
    where the projection is not occluded (z < 1.05 sampled) and both are
    positive; mean over views."""
    b, h, w, _ = depth_pred.shape
    pred_pts = geometry.backproject_depth(depth_pred[..., 0], cur_invK)     # (b, h, w, 4)
    world = torch.einsum("bij,bhwj->bhwi", cur_world_T_cam, pred_pts)
    losses = []
    for k in range(src_depth.shape[1]):
        proj = geometry.project_points(world.reshape(b, -1, 4), src_K[:, k], src_cam_T_world[:, k])
        uv = proj[..., :2].reshape(b, h, w, 2)
        z = proj[..., 2].reshape(b, h, w, 1)
        grid = torch.stack([2 * uv[..., 0] / w - 1, 2 * uv[..., 1] / h - 1], -1)
        sampled = grid_sample(torch.nan_to_num(src_depth[:, k], nan=0.0), grid, mode="nearest")
        valid = (z < 1.05 * sampled) & (z > 0) & (sampled > 0)
        err = torch.abs(torch.log(torch.clamp(sampled, min=1e-12))
                        - torch.log(torch.clamp(z, min=1e-12)))
        losses.append(masked_mean(err, valid))
    return torch.stack(losses).mean()


def upsample_nearest(x_bhwc: Tensor, h: int, w: int) -> Tensor:
    """Nearest-neighbour resize to (h, w), as jax.image.resize(method=
    "nearest") samples: output pixel i reads input floor((i + .5) in / out),
    which is i // f at an integer factor f."""
    hs, ws = x_bhwc.shape[1], x_bhwc.shape[2]
    iy = torch.floor((torch.arange(h, device=x_bhwc.device) + 0.5) * (hs / h)).long()
    ix = torch.floor((torch.arange(w, device=x_bhwc.device) + 0.5) * (ws / w)).long()
    return x_bhwc[:, iy][:, :, ix]


def regression_losses(cur_data: dict, src_data: dict, outputs: dict, *,
                      dataset: str = "scannet") -> dict:
    """The SimpleRecon loss cocktail. cur_data: depth (b, h, w, 1) with NaN
    invalids, mask (b, h, w, 1) bool, normals (b, h, w, 3), invK_s0,
    world_T_cam; src_data: depth, K_s0, cam_T_world; outputs:
    log_depth_pred_s (b, h_s, w_s, 1), depth_pred_0, normals_pred. The loss
    is ms + grad + normals + 0.2 mv (hypersim: ms alone); si, abs, inv_abs
    and log_l1 are logged."""
    depth_gt = cur_data["depth"]
    mask_b = cur_data["mask"]
    gt_safe = torch.where(mask_b, depth_gt, 1.0)
    log_gt = torch.log(gt_safe)
    depth_pred = outputs["depth_pred_0"]
    log_pred = outputs["log_depth_pred_0"]

    h, w = depth_gt.shape[1], depth_gt.shape[2]
    ms_loss = 0.0
    for s in range(4):
        key = f"log_depth_pred_{s}"
        if key not in outputs:
            continue
        lp = outputs[key]
        if lp.shape[1] != h:
            lp = upsample_nearest(lp, h, w)
        ms_loss = ms_loss + masked_mean(torch.abs(log_gt - lp), mask_b) / (2 ** s)

    abs_loss = masked_mean(torch.abs(gt_safe - depth_pred), mask_b)
    si = scale_invariant_loss(log_gt, log_pred, mask_b)
    mask_lim = mask_b & (depth_pred > 0.1)
    inv_abs = masked_mean(torch.abs(1.0 / gt_safe - 1.0 / torch.clamp(depth_pred, min=1e-6)),
                          mask_lim)
    log_l1 = masked_mean(torch.abs(log_gt - log_pred), mask_b)

    if dataset == "hypersim":
        zero = torch.zeros((), device=depth_gt.device)
        grad = norm_l = mv = zero
    else:
        grad = ms_gradient_loss(depth_gt, depth_pred)
        norm_l = normals_loss(cur_data["normals"], outputs["normals_pred"])
        mv = mv_depth_loss(depth_pred, src_data["depth"], cur_data["invK_s0"], src_data["K_s0"],
                           cur_data["world_T_cam"], src_data["cam_T_world"])

    return {"loss": ms_loss + grad + norm_l + 0.2 * mv, "ms_loss": ms_loss, "grad_loss": grad,
            "normals_loss": norm_l, "mv_loss": mv, "si_loss": si, "abs_loss": abs_loss,
            "inv_abs_loss": inv_abs, "log_l1_loss": log_l1}
