"""VDR (iPhone AR capture) dataset (parity: datasets/vdr_dataset.py).

Copy of implicit_depth_tpu/data/vdr.py with only its imports changed
(the port imports nothing of the JAX package).

Per-scan `capture.json` carries frame filenames, 5-element intrinsics and
a flattened column-major OpenGL pose per frame (vdr_dataset.py:284-310);
poses convert GL->CV + rotx(-pi/2) (:188-222). LiDAR depth is a raw
float32 .bin with a uint8 confidence map; confidence 0 is invalid
(:421-470). Flip augmentation is unsupported (:243).
"""

from __future__ import annotations

import json
import os

import numpy as np

from implicit_depth_tpu_torch.core.geometry import rotx
from implicit_depth_tpu_torch.data.hypersim import GL_TO_CV
from implicit_depth_tpu_torch.data.mvs_dataset import GenericMVSDataset
from implicit_depth_tpu_torch.utils.io import read_image


class VDRDataset(GenericMVSDataset):
    def __init__(self, dataset_path: str, split: str,
                 native_depth_width: int = 256, native_depth_height: int = 192,
                 **kwargs):
        super().__init__(dataset_path=dataset_path, split=split, **kwargs)
        self.native_depth_width = native_depth_width
        self.native_depth_height = native_depth_height
        self._meta: dict = {}

    @staticmethod
    def get_sub_folder_dir(split: str) -> str:
        return ""

    def _scan_dir(self, scan_id: str) -> str:
        return os.path.join(self.dataset_path, scan_id)

    def _capture(self, scan_id: str) -> list:
        if scan_id not in self._meta:
            with open(os.path.join(self._scan_dir(scan_id), "capture.json")) as f:
                self._meta[scan_id] = json.load(f)["frames"]
        return self._meta[scan_id]

    def get_valid_frame_ids(self, scan_id: str, store_computed: bool = False):
        return [f"{scan_id} {i} 0" for i in range(len(self._capture(scan_id)))]

    def load_pose(self, scan_id, frame_id):
        frame = self._capture(scan_id)[int(frame_id)]
        # flattened column-major 4x4 -> transpose
        T = np.asarray(frame["pose4x4"], np.float32).reshape(4, 4).T
        T = T * GL_TO_CV
        R_fix = rotx(-np.pi / 2).astype(np.float32)
        T[:3, :3] = R_fix @ T[:3, :3]
        T[:3, 3] = R_fix @ T[:3, 3]
        return T, np.linalg.inv(T).astype(np.float32)

    def load_intrinsics(self, scan_id, frame_id, flip: bool = False) -> dict:
        assert not flip, "Flipping isn't supported for VDR (vdr_dataset.py:243)"
        frame = self._capture(scan_id)[int(frame_id)]
        img_w, img_h = frame["resolution"]
        fx, fy, cx, cy = frame["intrinsics"][:4]
        K = np.eye(4)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
        out = {}
        Kf = K.copy()
        Kf[0] *= self.native_depth_width / img_w
        Kf[1] *= self.native_depth_height / img_h
        out["K_full_depth"] = Kf.astype(np.float32)
        out["invK_full_depth"] = np.linalg.inv(Kf).astype(np.float32)
        Kd = K.copy()
        Kd[0] *= self.depth_width / img_w
        Kd[1] *= self.depth_height / img_h
        for s in range(5):
            Ks = Kd.copy()
            Ks[:2] /= 2**s
            out[f"K_s{s}"] = Ks.astype(np.float32)
            out[f"invK_s{s}"] = np.linalg.inv(Ks).astype(np.float32)
        return out

    def _color_name(self, frame: dict, frame_id) -> str:
        """capture.json names the RGB under 'image' (vdr_sequence.py:103);
        older captures use 'rgb'; the reference dataset itself derives
        'frame_{id}.jpg' without reading the json (vdr_dataset.py:541)."""
        return (frame.get("image") or frame.get("rgb")
                or f"frame_{int(frame_id)}.jpg")

    def load_color(self, scan_id, frame_id):
        frame = self._capture(scan_id)[int(frame_id)]
        path = os.path.join(self._scan_dir(scan_id),
                            self._color_name(frame, frame_id))
        return read_image(path, height=self.image_height, width=self.image_width)

    def get_high_res_color_path(self, scan_id, frame_id):
        frame = self._capture(scan_id)[int(frame_id)]
        return os.path.join(self._scan_dir(scan_id),
                            self._color_name(frame, frame_id))

    def _load_lidar(self, scan_id, frame_id):
        frame = self._capture(scan_id)[int(frame_id)]
        ddir = self._scan_dir(scan_id)
        # fallback names match the reference's derivation (unpadded:
        # vdr_dataset.py:342 depth_{id}.bin, :375 depthConfidence_{id}.bin)
        depth = np.fromfile(
            os.path.join(ddir, frame.get("depth", f"depth_{int(frame_id)}.bin")),
            dtype=np.float32,
        ).reshape(-1, self.native_depth_width)
        conf = np.fromfile(
            os.path.join(ddir, frame.get("depthConfidence",
                                         f"depthConfidence_{int(frame_id)}.bin")),
            dtype=np.uint8,
        ).reshape(-1, self.native_depth_width)
        depth = depth.copy()
        depth[conf == 0] = np.nan
        return depth

    def load_full_res_depth(self, scan_id, frame_id):
        return self._load_lidar(scan_id, frame_id)

    def load_depth(self, scan_id, frame_id):
        import cv2

        d = self._load_lidar(scan_id, frame_id)
        return cv2.resize(d, (self.depth_width, self.depth_height),
                          interpolation=cv2.INTER_NEAREST)
