"""VDR capture.json sequence access (parity: inference/vdr_sequence.py).

Copy of implicit_depth_tpu/apps/vdr_sequence.py with only its imports changed
(the port imports nothing of the JAX package).

Reads a raw iPhone AR capture directory — `capture.json` plus per-frame
RGB jpgs, LiDAR depth `.bin`s and (optionally) rendered virtual layers —
and exposes frames, poses (GL -> CV via M @ T @ M,
inference/vdr_sequence.py:60-93), intrinsics and images. This is the
glue that lets `scripts/composite.py` and `scripts/inference.py` run
end-to-end off a capture without hand-prepared per-frame directories.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

# By default, pad frame-filename numbers to 5 digits so names sort
# (inference/vdr_sequence.py:13-21)
DEFAULT_NUM_PAD_DIGITS = 5

# OpenGL (x right, y up, z back) -> CV (x right, y down, z forward)
_M_GL_CV = np.diag([1.0, -1.0, -1.0, 1.0])


def pad_image_fname(fname: str, num_digits: int = DEFAULT_NUM_PAD_DIGITS) -> str:
    """frame_25.jpg -> frame_00025.jpg (sortable names)."""
    number = fname
    if number.startswith("frame_"):
        number = number[len("frame_"):]
    if number.endswith(".jpg"):
        number = number[: -len(".jpg")]
    return f"frame_{number.zfill(num_digits)}.jpg"


class VDRSequence:
    """A parsed capture directory.

    `capture.json` schema (per frame): `image` (rgb filename; `rgb` is
    accepted as an alias), `pose4x4` (flattened column-major OpenGL
    camera pose), `intrinsics` [fx, fy, cx, cy, ...], `resolution`
    [w, h], `depth` (raw float32 LiDAR bin), `depthResolution` [w, h].
    """

    def __init__(self, path: str) -> None:
        self.path = str(path)
        with open(os.path.join(self.path, "capture.json")) as f:
            self.capture = json.load(f)

    @property
    def frames(self) -> list:
        return self.capture["frames"]

    def __len__(self) -> int:
        return len(self.frames)

    @staticmethod
    def image_name(frame: dict) -> str:
        return frame.get("image") or frame["rgb"]

    def load_pose_for_frame(self, frame: dict) -> np.ndarray:
        """world_T_cam in CV convention: M @ T_gl @ M
        (inference/vdr_sequence.py:83-93)."""
        T = np.asarray(frame["pose4x4"], np.float64).reshape(4, 4).T
        return (_M_GL_CV @ T @ _M_GL_CV).astype(np.float32)

    @staticmethod
    def load_intrinsics_from_frame(frame: dict) -> tuple[np.ndarray, tuple]:
        fx, fy, cx, cy = frame["intrinsics"][:4]
        K = np.eye(3)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
        w, h = frame["resolution"]
        return K, (h, w)

    def load_rgb_from_frame(self, frame: dict) -> np.ndarray:
        """(h, w, 3) uint8 RGB."""
        from PIL import Image

        path = os.path.join(self.path, self.image_name(frame))
        return np.asarray(Image.open(path).convert("RGB"))

    def load_lidar_from_frame(self, frame: dict) -> np.ndarray:
        w, h = frame["depthResolution"]
        path = os.path.join(self.path, frame["depth"])
        return np.fromfile(path, dtype=np.float32).reshape(h, w)

    def load_virtual_layer(self, renders_dir: str, frame: dict
                           ) -> tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """(rgba float [0,1], virtual depth) for a frame from a renders
        dir holding frame_XXXXX.png (+ .npy depth), or (None, None)
        when absent (inference/composite.py:78-124)."""
        from PIL import Image

        stem = os.path.splitext(pad_image_fname(self.image_name(frame)))[0]
        rgba_path = os.path.join(renders_dir, stem + ".png")
        rgba = None
        if os.path.exists(rgba_path):
            rgba = np.asarray(Image.open(rgba_path)).astype(np.float32) / 255.0
            if rgba.shape[-1] == 3:
                rgba = np.concatenate([rgba, np.ones_like(rgba[..., :1])], -1)
        depth_path = os.path.join(renders_dir, stem + ".npy")
        vdepth = np.load(depth_path) if os.path.exists(depth_path) else None
        return rgba, vdepth
