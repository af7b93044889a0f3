"""7-Scenes dataset (parity: datasets/seven_scenes_dataset.py).

Copy of implicit_depth_tpu/data/seven_scenes.py with only its imports changed
(the port imports nothing of the JAX package).

Kinect capture: frame-XXXXXX.color.png, frame-XXXXXX.depth.proj.png
(the projected/undistorted depth produced by
scripts/preprocess_7scenes.py; raw Kinect depth has 65535 invalids),
frame-XXXXXX.pose.txt. Fixed intrinsics fx=fy=525, cx=320, cy=240 at
640x480 (seven_scenes_dataset.py:385-430); world frame fixed up by
rotx(+pi/2) (:504-534).
"""

from __future__ import annotations

import os

import numpy as np

from implicit_depth_tpu_torch.core.geometry import rotx
from implicit_depth_tpu_torch.data.mvs_dataset import GenericMVSDataset
from implicit_depth_tpu_torch.utils.io import read_image


class SevenScenesDataset(GenericMVSDataset):
    def __init__(self, dataset_path: str, split: str,
                 min_valid_depth: float = 1e-3, max_valid_depth: float = 10.0,
                 **kwargs):
        super().__init__(dataset_path=dataset_path, split=split, **kwargs)
        self.min_valid_depth = min_valid_depth
        self.max_valid_depth = max_valid_depth

    @staticmethod
    def get_sub_folder_dir(split: str) -> str:
        return ""

    def _scan_dir(self, scan_id: str) -> str:
        # scan ids look like "chess/seq-01"
        return os.path.join(self.dataset_path, scan_id)

    def get_valid_frame_ids(self, scan_id: str, store_computed: bool = False):
        d = self._scan_dir(scan_id)
        ids = sorted(
            f.split(".")[0].split("-")[1]
            for f in os.listdir(d) if f.endswith(".color.png")
        )
        return [f"{scan_id} {fid} 0" for fid in ids]

    def load_pose(self, scan_id, frame_id):
        path = os.path.join(self._scan_dir(scan_id), f"frame-{frame_id}.pose.txt")
        T = np.genfromtxt(path).astype(np.float32)
        R_fix = rotx(np.pi / 2).astype(np.float32)
        T[:3, :3] = R_fix @ T[:3, :3]
        T[:3, 3] = R_fix @ T[:3, 3]
        return T, np.linalg.inv(T).astype(np.float32)

    def load_intrinsics(self, scan_id=None, frame_id=None, flip: bool = False) -> dict:
        K = np.eye(4)
        K[0, 0] = K[1, 1] = 525.0
        K[0, 2], K[1, 2] = 320.0, 240.0
        if flip:
            K[0, 2] = 640.0 - K[0, 2]
        out = {
            "K_full_depth": K.astype(np.float32),
            "invK_full_depth": np.linalg.inv(K).astype(np.float32),
        }
        Kd = K.copy()
        Kd[0] *= self.depth_width / 640.0
        Kd[1] *= self.depth_height / 480.0
        for s in range(5):
            Ks = Kd.copy()
            Ks[:2] /= 2**s
            out[f"K_s{s}"] = Ks.astype(np.float32)
            out[f"invK_s{s}"] = np.linalg.inv(Ks).astype(np.float32)
        return out

    def load_color(self, scan_id, frame_id):
        d = self._scan_dir(scan_id)
        cached = os.path.join(d, f"frame-{frame_id}.color.{self.image_width}.png")
        path = cached if os.path.exists(cached) else os.path.join(
            d, f"frame-{frame_id}.color.png")
        return read_image(path, height=self.image_height, width=self.image_width)

    def get_high_res_color_path(self, scan_id, frame_id):
        return os.path.join(self._scan_dir(scan_id), f"frame-{frame_id}.color.png")

    def _load_depth_png(self, path, h=None, w=None):
        depth = read_image(path, height=h, width=w, value_scale_factor=1e-3, nearest=True)
        invalid = ~((depth > self.min_valid_depth) & (depth < self.max_valid_depth))
        depth = depth.astype(np.float32)
        depth[invalid] = np.nan
        return depth

    def load_depth(self, scan_id, frame_id):
        path = os.path.join(self._scan_dir(scan_id), f"frame-{frame_id}.depth.proj.png")
        return self._load_depth_png(path, self.depth_height, self.depth_width)

    def load_full_res_depth(self, scan_id, frame_id):
        path = os.path.join(self._scan_dir(scan_id), f"frame-{frame_id}.depth.proj.png")
        return self._load_depth_png(path)
