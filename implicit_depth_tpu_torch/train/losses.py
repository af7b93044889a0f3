"""BD training losses, counterpart of implicit_depth_tpu/train/losses.py
(masked_mean, bce_with_logits, binary_losses): BCE with logits and a
sharpness regulariser over the four query scales, with explicit masks where
the reference used NaN. The regression losses come with the regression
slice."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

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
