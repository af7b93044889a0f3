"""Copy of implicit_depth_tpu/utils/visualization.py (the port imports nothing of the JAX
package); only this first paragraph differs.

Visualization helpers (parity: utils/visualization_utils.py)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def colormap_image(
    values_hw: np.ndarray,
    mask_hw: Optional[np.ndarray] = None,
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    colormap: str = "turbo",
    invalid_color=(0.0, 0.0, 0.0),
    flip: bool = True,
    return_vminvmax: bool = False,
):
    """Colormapped (h, w, 3) image from a scalar map
    (utils/visualization_utils.py:38-95: turbo, masked percentile
    normalisation, inverted values by default for depth)."""
    import matplotlib.cm as cm

    values = np.asarray(values_hw, np.float32)
    valid = np.isfinite(values)
    if mask_hw is not None:
        valid &= np.asarray(mask_hw) > 0
    vals = values[valid]
    if vmin is None:
        vmin = float(np.percentile(vals, 5)) if vals.size else 0.0
    if vmax is None:
        vmax = float(np.percentile(vals, 95)) if vals.size else 1.0
    norm = np.clip((values - vmin) / max(vmax - vmin, 1e-10), 0, 1)
    if flip:
        norm = 1.0 - norm
    rgb = cm.get_cmap(colormap)(norm)[..., :3].astype(np.float32)
    rgb[~valid] = invalid_color
    if return_vminvmax:
        return rgb, vmin, vmax
    return rgb


def prepare_image_for_logging(img: np.ndarray, normalize: bool = True,
                              colormap: bool = False, invert: bool = False) -> np.ndarray:
    """(h, w[, c]) -> (h, w, 3) float in [0, 1]
    (utils/visualization_utils.py:15-27)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if colormap:
        return colormap_image(img, flip=invert)
    if normalize:
        lo, hi = np.nanmin(img), np.nanmax(img)
        img = (img - lo) / max(hi - lo, 1e-10)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    return np.clip(img, 0, 1)


def save_image(path: str, img: np.ndarray) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def quick_viz_export(output_dir: str, frame_id: str, image_hw3: np.ndarray,
                     depth_hw: np.ndarray, pred_hw: np.ndarray,
                     mask_hw: Optional[np.ndarray] = None) -> None:
    """Side-by-side GT/pred depth panel dump
    (utils/visualization_utils.py:98-192 behaviour)."""
    gt_viz, vmin, vmax = colormap_image(depth_hw, mask_hw, return_vminvmax=True)
    pred_viz = colormap_image(pred_hw, vmin=vmin, vmax=vmax)
    panel = np.concatenate([np.asarray(image_hw3), gt_viz, pred_viz], axis=1)
    save_image(os.path.join(output_dir, f"{frame_id}.png"), panel)


def write_video(path: str, frames: list[np.ndarray], fps: int = 30) -> None:
    """mp4 export via cv2 (the reference shells out to ffmpeg,
    inference/composite.py:145-159; ffmpeg is not in this image)."""
    import cv2

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        arr = np.clip(np.asarray(f) * 255.0, 0, 255).astype(np.uint8)
        writer.write(cv2.cvtColor(arr, cv2.COLOR_RGB2BGR))
    writer.release()


def normalize_depth(depth_hw: np.ndarray, mask_hw: Optional[np.ndarray] = None,
                    robust: bool = False) -> np.ndarray:
    """Percentile-trimmed depth normalisation for visualisation
    (utils/generic_utils.py:43-81): drops the top/bottom 10% of valid
    values, then (x - shift)/scale with mean/std (or median/MAD when
    robust)."""
    valid = np.isfinite(depth_hw)
    if mask_hw is not None:
        valid &= np.asarray(mask_hw) > 0
    vals = np.sort(depth_hw[valid].ravel())
    if vals.size == 0:
        return depth_hw
    trim = vals.size // 10
    core = vals[trim: vals.size - trim] if vals.size > 2 * trim else vals
    if robust:
        shift = np.median(core)
        scale = np.mean(np.abs(core - shift))
    else:
        shift = core.mean()
        scale = core.std()
    return (depth_hw - shift) / max(scale, 1e-10)
