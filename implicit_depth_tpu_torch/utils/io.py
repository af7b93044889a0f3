"""Host-side image / text IO (replaces utils/generic_utils.py:166-246).

Copy of implicit_depth_tpu/utils/io.py (the port imports nothing of the
JAX package)."""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

try:
    from PIL import Image
    _HAVE_PIL = True
except ImportError:  # pragma: no cover
    _HAVE_PIL = False


def readlines(path: str) -> list[str]:
    with open(path) as f:
        return f.read().splitlines()


def read_image(
    path: str,
    height: Optional[int] = None,
    width: Optional[int] = None,
    value_scale_factor: float = 1.0,
    nearest: bool = False,
    target_aspect_ratio: Optional[float] = None,
) -> np.ndarray:
    """Reads an image file -> float32 array scaled by value_scale_factor.

    RGB images return (h, w, 3) in [0, 1]*scale; single-channel images
    (e.g. 16-bit depth PNGs) return (h, w).
    Mirrors utils/generic_utils.py:166-214 (optional resize with bilinear
    or nearest resampling, optional centre crop to an aspect ratio).
    """
    assert _HAVE_PIL, "PIL required for image IO"
    img = Image.open(path)

    if target_aspect_ratio:
        img = crop_to_aspect(img, target_aspect_ratio)

    if height is not None and width is not None and img.size != (width, height):
        resample = Image.NEAREST if nearest else Image.BILINEAR
        img = img.resize((width, height), resample=resample)

    arr = np.asarray(img)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    else:
        arr = arr.astype(np.float32)
    if arr.ndim == 3 and arr.shape[2] == 4:
        arr = arr[..., :3]
    return arr * value_scale_factor


def crop_to_aspect(img, target_aspect_ratio: float = 4.0 / 3.0):
    """Centre crop to an aspect ratio (utils/generic_utils.py:217-246)."""
    w, h = img.size
    actual = w / h
    if actual > target_aspect_ratio:
        new_w = h * target_aspect_ratio
        left = (w - new_w) / 2
        return img.crop((left, 0, left + new_w, h))
    if actual < target_aspect_ratio:
        new_h = w / target_aspect_ratio
        top = (h - new_h) / 2
        return img.crop((0, top, w, top + new_h))
    return img


def color_jitter(img_hw3: np.ndarray, rng: np.random.RandomState,
                 brightness: float = 0.2, contrast: float = 0.2,
                 saturation: float = 0.2, hue: float = 0.2) -> np.ndarray:
    """Lightweight ColorJitter equivalent (torchvision transform used at
    datasets/scannet_dataset.py:88). Factor semantics match torchvision:
    uniform in [1-x, 1+x] (hue in [-x, x] as a channel roll in HSV-lite)."""
    out = img_hw3
    b = rng.uniform(1 - brightness, 1 + brightness)
    out = out * b
    c = rng.uniform(1 - contrast, 1 + contrast)
    mean = out.mean()
    out = (out - mean) * c + mean
    s = rng.uniform(1 - saturation, 1 + saturation)
    gray = out.mean(axis=-1, keepdims=True)
    out = (out - gray) * s + gray
    h = rng.uniform(-hue, hue)
    if abs(h) > 1e-6:
        # cheap hue-ish rotation: blend channels cyclically
        rolled = np.roll(out, 1, axis=-1)
        out = out * (1 - abs(h)) + rolled * abs(h)
    return np.clip(out, 0.0, 1.0).astype(np.float32)
