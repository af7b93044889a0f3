"""Occlusion (binary-depth) scores, counterpart of
implicit_depth_tpu/eval/binary_metrics.py. NaN-masked reductions as in the
reference, including the NaN IoU of an empty bin that the averagers skip.

Layouts: gt depth (b, h, w, 1) with NaN invalid; query depths and
predictions (b, h, w, d), d = query planes. Score keys are the JAX
package's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from implicit_depth_tpu_torch.ops.image import max_pool_dilate

Tensor = torch.Tensor

DEFAULT_PLANES = tuple(1.5 + 0.5 * x for x in range(8))
DEFAULT_THRESHOLDS = tuple(np.linspace(0.3, 0.7, 5))


def get_boundary_mask(depth_bhw1: Tensor, rendered_bhwd: Tensor) -> Tensor:
    """Dilated occlusion-boundary mask."""
    invalid = torch.isnan(depth_bhw1)
    target = (rendered_bhwd < depth_bhw1).float()
    edges = max_pool_dilate(target, 3) - target
    edges = torch.where(invalid, 0.0, edges)
    dilated = max_pool_dilate(edges, 7)
    dilated = torch.where(invalid, float("nan"), dilated)
    return (dilated > 0).float()


def get_surface_mask(depth_bhw1: Tensor, rendered_bhwd: Tensor, threshold: float = 0.05) -> Tensor:
    """|gt - q| / gt < threshold."""
    return (torch.abs(depth_bhw1 - rendered_bhwd) / depth_bhw1 < threshold).float()


class Thresholder:
    """Per-depth-bin decision thresholds."""

    def __init__(self, planes, thresholds, device=None):
        planes = torch.as_tensor(planes, dtype=torch.float32, device=device)
        bins = torch.zeros_like(planes)
        bins[:-1] = (planes[1:] + planes[:-1]) / 2.0
        bins[-1] = 100.0
        self.bins = bins
        self.thresholds = torch.as_tensor(thresholds, dtype=torch.float32, device=device)

    def to(self, device) -> "Thresholder":
        out = Thresholder.__new__(Thresholder)
        out.bins = self.bins.to(device)
        out.thresholds = self.thresholds.to(device)
        return out

    def get_thresholds(self, query_depth: Tensor) -> Tensor:
        idx = torch.searchsorted(self.bins, query_depth.contiguous(), right=True)
        return self.thresholds[idx]


def _iou_terms(pred_bdN: Tensor, target_bdN: Tensor) -> Tensor:
    inter = torch.nansum(pred_bdN * target_bdN, dim=2)
    t_cnt = torch.nansum(target_bdN, dim=2)
    p_cnt = torch.nansum(pred_bdN, dim=2)
    return inter / (t_cnt + p_cnt - inter)


def _flatten_dN(x_bhwd: Tensor) -> Tensor:
    """(b, h, w, d) -> (b, d, N)."""
    b, h, w, d = x_bhwd.shape
    return x_bhwd.permute(0, 3, 1, 2).reshape(b, d, h * w)


def plane_scores(query_bhwd: Tensor, gt_bhw1: Tensor, pred_bhwd: Tensor, threshold,
                 extra_mask_bhwd: Optional[Tensor] = None) -> dict:
    """Pos/neg/harmonic IoU per (batch, plane) at a scalar or per-element
    threshold; `extra_mask` restricts scoring (surface/boundary variants).
    Returns {"iou", "iou_pos", "iou_neg"}, each (b, d)."""
    gt = gt_bhw1.expand_as(query_bhwd)
    valid = (gt > 0) & (query_bhwd > 0) & ~torch.isnan(gt)
    if extra_mask_bhwd is not None:
        valid = valid & (extra_mask_bhwd > 0) & ~torch.isnan(extra_mask_bhwd)

    valid_bdN = _flatten_dN(valid.float()) > 0
    target_bdN = _flatten_dN((query_bhwd < gt).float())
    pred_bdN = _flatten_dN(pred_bhwd)
    if isinstance(threshold, (float, int)):
        thresh_bdN = threshold
    else:
        thresh_bdN = _flatten_dN(threshold.expand_as(query_bhwd))

    nan = torch.tensor(float("nan"), device=query_bhwd.device)
    target_bdN = torch.where(valid_bdN, target_bdN, nan)
    pred_t_bdN = torch.where(valid_bdN, (pred_bdN > thresh_bdN).float(), nan)

    iou_pos = _iou_terms(pred_t_bdN, target_bdN)
    iou_neg = _iou_terms(1.0 - pred_t_bdN, 1.0 - target_bdN)
    iou = 2.0 * iou_pos * iou_neg / (iou_pos + iou_neg)
    return {"iou": iou, "iou_pos": iou_pos, "iou_neg": iou_neg}


def scores_to_dict(scores: dict, thresholds=None,
                   depth_planes: Sequence[float] = DEFAULT_PLANES,
                   tag: Optional[str] = None, is_rendering: bool = False,
                   threshold_decimals: int = 1) -> dict:
    """(b, d) IoU arrays -> the reference's flat keys
    [tag_]iou[_pos|_neg][_{thr}]_d_{plane} -> (b,) tensors."""
    out = {}
    prefix = f"{tag}_" if tag else ""
    d = scores["iou"].shape[1]
    for key in ("iou", "iou_pos", "iou_neg"):
        for di in range(d):
            plane = -1 if is_rendering else depth_planes[di]
            if thresholds is None:
                out[f"{prefix}{key}_d_{plane:.1f}"] = scores[key][:, di]
            else:
                out[f"{prefix}{key}_{thresholds:.{threshold_decimals}f}_d_{plane:.1f}"] = \
                    scores[key][:, di]
    return out
