"""Occlusion-matte inference, counterpart of
implicit_depth_tpu/apps/inference.py (parity: inference/inference.py).

Per frame of a dense-tuple sequence: query the BD model with a rendered
virtual-asset depth map (loaded per frame, hole-filled with a 7x7 max
pool, inference/inference.py:115-128; or a fixed 2 m plane :129-131),
feed the previous prediction back as the temporal prior (:139-157), save
sigmoid mattes as .npy (:159-162). The net runs on its own device; with
the prior, the matte and the pose stay there from one frame to the next.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from implicit_depth_tpu_torch.data.mvs_dataset import collate
from implicit_depth_tpu_torch.eval.occlusion_eval import make_forward_fn
from implicit_depth_tpu_torch.ops.image import max_pool_dilate
from implicit_depth_tpu_torch.utils.device import batch_to_device


def load_rendered_depth(load_dir: Optional[str], frame_id: str, h: int, w: int) -> np.ndarray:
    """Rendered asset depth (h, w, 1) f32 with its holes (depth <= 0)
    filled by a 7x7 max pool, or a fixed 2 m plane without a directory."""
    if load_dir is None:
        return np.full((h, w, 1), 2.0, np.float32)
    path = os.path.join(load_dir, f"{frame_id}.npy")
    depth = np.load(path).astype(np.float32)
    if depth.ndim == 2:
        depth = depth[..., None]
    filled = max_pool_dilate(torch.from_numpy(depth)[None], 7)[0].numpy()
    return np.where(depth > 0, depth, filled)


def run_inference(
    net,
    dataset,
    output_dir: str,
    rendered_depth_load_dir: Optional[str] = None,
    sigmoid_multiplier: float = 1.0,
    use_prior: bool = False,
    max_frames: Optional[int] = None,
    frame_ms: Optional[list] = None,
) -> list[str]:
    """Sequential per-frame matting with `net` (a BDNet, on its device, in
    eval mode); returns the saved file paths, one `{frame id:05d}.npy` (the
    id as given when it is not digits) of the (h, w) f32 sigmoid matte per
    frame. With use_prior each frame gets the previous frame's matte and
    cam_T_world as its prior (none on the first frame). `frame_ms`, when
    given, receives each frame's wall time in ms, up to the matte's
    readback."""
    os.makedirs(output_dir, exist_ok=True)
    device = next(net.parameters()).device
    net.eval()
    fwd = make_forward_fn(net, sigmoid_multiplier=sigmoid_multiplier)
    saved = []
    prior_pred = None
    prior_pose = None
    n = len(dataset) if max_frames is None else min(len(dataset), max_frames)
    with torch.inference_mode():
        for i in range(n):
            t0 = time.perf_counter()
            cur, src = collate([dataset[i]])
            frame_id = cur.get("frame_id_string", [str(i)])[0]
            h, w = cur["depth"].shape[1:3]
            cur["rendered_depth"] = load_rendered_depth(rendered_depth_load_dir, frame_id,
                                                        h, w)[None]
            cur, src = batch_to_device((cur, src), device)
            if use_prior:
                cur["prior_prediction"] = prior_pred
                cur["prior_cam_T_world"] = prior_pose

            pred = fwd(cur, src)  # (1, h, w, 1)
            matte = pred[0, ..., 0].cpu().numpy()
            # zero-padded like the reference (inference/inference.py:162
            # saves f"{frame_idx:05d}.npy") so composite_capture's padded
            # mask lookup (inference/composite.py:99) finds the mattes
            fid = f"{int(frame_id):05d}" if str(frame_id).isdigit() else str(frame_id)
            path = os.path.join(output_dir, f"{fid}.npy")
            np.save(path, matte)
            saved.append(path)
            if frame_ms is not None:
                frame_ms.append((time.perf_counter() - t0) * 1e3)

            if use_prior:
                prior_pred = pred
                prior_pose = cur["cam_T_world"]
    return saved
