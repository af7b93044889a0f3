"""Temporal (flicker) evaluation, counterpart of
implicit_depth_tpu/eval/temporal.py.

Per scene, every `eval_length` frames a new occlusion plane is placed at
the 0.75 quantile of the GT depth in front of the current camera; the model
predicts the plane's occlusion in each frame, with the previous frame's
prediction as its prior; the GT mesh's vertices visible in a frame collect
its binarised prediction, and the score counts per-vertex flips across each
window.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from implicit_depth_tpu_torch.eval.rasterizer import (load_ply, render_plane_depth,
                                                      sample_vertex_predictions)


class TemporalEvaluator:
    def __init__(self, height: int = 192, width: int = 256):
        self.height = height
        self.width = width
        self.total_diffs = 0.0
        self.total_verts = 0
        self.verts: Optional[np.ndarray] = None
        self.faces: Optional[np.ndarray] = None
        self.anchor_pose: Optional[np.ndarray] = None
        self.plane_distance: Optional[float] = None
        self.vertex_predictions: list = []

    # ---- scene / window lifecycle --------------------------------------
    def initialise_new_scene(self, gt_mesh_path: Optional[str] = None,
                             verts: Optional[np.ndarray] = None,
                             faces: Optional[np.ndarray] = None) -> None:
        if gt_mesh_path is not None:
            verts, faces = load_ply(gt_mesh_path)
        self.verts, self.faces = verts, faces
        self.vertex_predictions = []

    def initialise_new_plane(self, depth_gt_hw: np.ndarray, world_T_cam_44: np.ndarray) -> None:
        """A plane at the 0.75 quantile of the GT depth (NaN ignored) in
        front of this camera."""
        self.anchor_pose = np.asarray(world_T_cam_44, np.float64)
        self.plane_distance = float(np.nanquantile(depth_gt_hw, 0.75))
        self.vertex_predictions = []

    def render_plane(self, cam_T_world_44, K_44, device=None) -> torch.Tensor:
        """(h, w) f32 depth of the current plane in this camera, 0 where a
        pixel's ray misses it, on `device` (by default K_44's device, which
        must then be a tensor)."""
        if device is None:
            if not isinstance(K_44, torch.Tensor):
                raise ValueError("render_plane: pass a device, or K_44 as a tensor on one")
            device = K_44.device
        f32 = dict(dtype=torch.float32, device=device)
        return render_plane_depth(
            torch.as_tensor(self.anchor_pose, **f32), torch.as_tensor(self.plane_distance, **f32),
            torch.as_tensor(cam_T_world_44, **f32), torch.as_tensor(K_44, **f32),
            self.height, self.width)

    # ---- per-frame update ----------------------------------------------
    @staticmethod
    def mask_prediction_edges(pred_hw: np.ndarray, edge_size: int = 4) -> np.ndarray:
        out = np.full_like(pred_hw, -1.0)
        out[edge_size:-edge_size, edge_size:-edge_size] = pred_hw[edge_size:-edge_size,
                                                                  edge_size:-edge_size]
        return out

    def update_vertex_predictions(self, pred_hw: np.ndarray, cam_T_world_44: np.ndarray,
                                  K_44: np.ndarray) -> None:
        """Samples the edge-masked prediction at the visible GT-mesh
        vertices (one fused C++ call)."""
        self.vertex_predictions.append(sample_vertex_predictions(
            self.verts, self.faces, np.asarray(cam_T_world_44), np.asarray(K_44)[:3, :3],
            np.asarray(pred_hw, np.float32)))

    def compute_vertex_occlusion_changes(self) -> None:
        """Adds the window's binarised per-vertex flips: -1 (unseen) is NaN,
        > 0.5 is 1, < 0.5 is 0; flips count only where both frames saw the
        vertex."""
        if len(self.vertex_predictions) < 2:
            return
        preds = np.stack(self.vertex_predictions).astype(np.float64)
        preds[preds == -1] = np.nan
        preds[preds > 0.5] = 1.0
        preds[preds < 0.5] = 0.0
        diffs = np.abs(preds[1:] - preds[:-1])
        self.total_diffs += float(np.nansum(diffs))
        self.total_verts += diffs.shape[1]

    def temporal_score(self, n_scans: int, eval_length: int = 15, warmup: int = 2,
                       frame_multiplier: int = 8) -> float:
        """Flips per (eval_length - warmup) * frame_multiplier frames of
        each scene."""
        denom = (eval_length - warmup) * frame_multiplier * n_scans
        return self.total_diffs / max(denom, 1)
