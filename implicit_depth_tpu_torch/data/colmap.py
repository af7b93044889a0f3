"""COLMAP-format capture dataset (parity: datasets/colmap_dataset.py).

Copy of implicit_depth_tpu/data/colmap.py with only its imports changed
(the port imports nothing of the JAX package).

Loads text-format COLMAP sparse reconstructions (images.txt quaternion
poses -> world_T_cam via qvec2rotmat(-q), colmap_dataset.py:425-451;
cameras.txt intrinsics) plus the captured RGB frames; depth is DUMMY
(ones, colmap_dataset.py:46,455-476) — this dataset serves inference and
compositing only. World frame fixed up by rotx(+pi/2).
"""

from __future__ import annotations

import os

import numpy as np

from implicit_depth_tpu_torch.core.geometry import qvec2rotmat, rotx
from implicit_depth_tpu_torch.data.mvs_dataset import GenericMVSDataset
from implicit_depth_tpu_torch.utils.io import read_image


def parse_colmap_cameras(path: str) -> dict:
    """cameras.txt -> {camera_id: (model, w, h, params)}."""
    cams = {}
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cams[int(parts[0])] = (parts[1], int(parts[2]), int(parts[3]),
                               [float(p) for p in parts[4:]])
    return cams


def parse_colmap_images(path: str) -> dict:
    """images.txt -> {image_name: (world_T_cam, camera_id)}."""
    out = {}
    lines = [l.strip() for l in open(path)]
    data_lines = [l for l in lines if l and not l.startswith("#")]
    for i in range(0, len(data_lines), 2):  # every 2nd line is 2D points
        parts = data_lines[i].split()
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        # COLMAP stores cam_T_world as (q, t); world_T_cam = [R^T | -R^T t]
        Rc = qvec2rotmat(qvec)
        T = np.eye(4)
        T[:3, :3] = Rc.T
        T[:3, 3] = -Rc.T @ tvec
        out[name] = (T.astype(np.float32), cam_id)
    return out


class ColmapDataset(GenericMVSDataset):
    def __init__(self, dataset_path: str, split: str, **kwargs):
        super().__init__(dataset_path=dataset_path, split=split, **kwargs)
        self._poses: dict = {}
        self._cams: dict = {}

    @staticmethod
    def get_sub_folder_dir(split: str) -> str:
        return ""

    def _scan_dir(self, scan_id: str) -> str:
        return os.path.join(self.dataset_path, scan_id)

    def _load_capture(self, scan_id: str):
        if scan_id in self._poses:
            return
        sparse = os.path.join(self._scan_dir(scan_id), "sparse")
        self._cams[scan_id] = parse_colmap_cameras(os.path.join(sparse, "cameras.txt"))
        self._poses[scan_id] = parse_colmap_images(os.path.join(sparse, "images.txt"))

    def get_valid_frame_ids(self, scan_id: str, store_computed: bool = False):
        self._load_capture(scan_id)
        return [f"{scan_id} {name} 0" for name in sorted(self._poses[scan_id])]

    def load_pose(self, scan_id, frame_id):
        self._load_capture(scan_id)
        T, _ = self._poses[scan_id][frame_id]
        T = T.copy()
        R_fix = rotx(np.pi / 2).astype(np.float32)
        T[:3, :3] = R_fix @ T[:3, :3]
        T[:3, 3] = R_fix @ T[:3, 3]
        return T, np.linalg.inv(T).astype(np.float32)

    def load_intrinsics(self, scan_id, frame_id=None, flip: bool = False) -> dict:
        self._load_capture(scan_id)
        cam_id = next(iter(self._cams[scan_id]))
        model, w, h, params = self._cams[scan_id][cam_id]
        if model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
            fx = fy = params[0]
            cx, cy = params[1], params[2]
        else:  # PINHOLE, OPENCV, ...
            fx, fy, cx, cy = params[:4]
        K = np.eye(4)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
        if flip:
            K[0, 2] = w - K[0, 2]
        Kd = K.copy()
        Kd[0] *= self.depth_width / w
        Kd[1] *= self.depth_height / h
        out = {}
        for s in range(5):
            Ks = Kd.copy()
            Ks[:2] /= 2**s
            out[f"K_s{s}"] = Ks.astype(np.float32)
            out[f"invK_s{s}"] = np.linalg.inv(Ks).astype(np.float32)
        return out

    def load_color(self, scan_id, frame_id):
        path = os.path.join(self._scan_dir(scan_id), "images", frame_id)
        return read_image(path, height=self.image_height, width=self.image_width)

    def get_high_res_color_path(self, scan_id, frame_id):
        return os.path.join(self._scan_dir(scan_id), "images", frame_id)

    def load_depth(self, scan_id, frame_id):
        return np.ones((self.depth_height, self.depth_width), np.float32)

    def load_full_res_depth(self, scan_id, frame_id):
        return np.ones((self.depth_height, self.depth_width), np.float32)
