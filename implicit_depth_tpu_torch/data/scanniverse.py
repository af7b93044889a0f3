"""Scanniverse capture dataset (parity: datasets/scanniverse_dataset.py).

Copy of implicit_depth_tpu/data/scanniverse.py with only its imports changed
(the port imports nothing of the JAX package).

Per-scan `frames.txt` holds text-protobuf-style frame records with a
quaternion pose and intrinsics (scanniverse_dataset.py:137-249); world
frame fixed up by rotx(+pi/2). Depth is DUMMY (ones) — inference only.
"""

from __future__ import annotations

import os
import re

import numpy as np

from implicit_depth_tpu_torch.core.geometry import rotx
from implicit_depth_tpu_torch.data.mvs_dataset import GenericMVSDataset
from implicit_depth_tpu_torch.utils.io import read_image


def quat_xyzw_to_rotmat(q):
    """scipy-style (x, y, z, w) quaternion -> rotation matrix."""
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def parse_frames_txt(text: str) -> dict:
    """Parses `frames { ... }` blocks into per-frame metadata dicts with
    keys: id, quadR (x,y,z,w), T (3,), fx, fy, cx, cy, width, height."""
    frames = {}
    for m in re.finditer(r"frames \{(.*?)\n\}", text, flags=re.S):
        block = m.group(1)

        def fval(name, default=None):
            mm = re.search(rf"\b{name}:\s*([-\d.eE]+)", block)
            return float(mm.group(1)) if mm else default

        def flist(name):
            return [float(v) for v in re.findall(rf"\b{name}:\s*([-\d.eE]+)", block)]

        fid = int(fval("id", len(frames)))
        frames[str(fid)] = {
            "quadR": flist("quadR") or flist("q"),
            "T": flist("T") or flist("t"),
            "fx": fval("fx"), "fy": fval("fy"),
            "cx": fval("cx"), "cy": fval("cy"),
            "width": fval("width", 1440), "height": fval("height", 1920),
        }
    return frames


class ScanniverseDataset(GenericMVSDataset):
    def __init__(self, dataset_path: str, split: str, **kwargs):
        super().__init__(dataset_path=dataset_path, split=split, **kwargs)
        self.capture_metadata: dict = {}

    @staticmethod
    def get_sub_folder_dir(split: str) -> str:
        return ""

    def _scan_dir(self, scan_id: str) -> str:
        return os.path.join(self.dataset_path, scan_id)

    def load_capture_metadata(self, scan_id: str):
        if scan_id in self.capture_metadata:
            return
        with open(os.path.join(self._scan_dir(scan_id), "frames.txt")) as f:
            self.capture_metadata[scan_id] = parse_frames_txt(f.read())

    def get_valid_frame_ids(self, scan_id: str, store_computed: bool = False):
        self.load_capture_metadata(scan_id)
        return [f"{scan_id} {fid} 0" for fid in sorted(self.capture_metadata[scan_id], key=int)]

    def load_pose(self, scan_id, frame_id):
        self.load_capture_metadata(scan_id)
        meta = self.capture_metadata[scan_id][str(int(frame_id))]
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = quat_xyzw_to_rotmat(meta["quadR"])
        T[:3, 3] = meta["T"]
        R_fix = rotx(np.pi / 2).astype(np.float32)
        T[:3, :3] = R_fix @ T[:3, :3]
        T[:3, 3] = R_fix @ T[:3, 3]
        return T, np.linalg.inv(T).astype(np.float32)

    def load_intrinsics(self, scan_id, frame_id=None, flip: bool = False) -> dict:
        self.load_capture_metadata(scan_id)
        meta = self.capture_metadata[scan_id][str(int(frame_id))]
        K = np.eye(4)
        K[0, 0], K[1, 1] = meta["fx"], meta["fy"]
        K[0, 2], K[1, 2] = meta["cx"], meta["cy"]
        w, h = meta["width"], meta["height"]
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
        path = os.path.join(self._scan_dir(scan_id), "images", f"frame_{int(frame_id):05d}.jpg")
        return read_image(path, height=self.image_height, width=self.image_width)

    def get_high_res_color_path(self, scan_id, frame_id):
        return os.path.join(self._scan_dir(scan_id), "images",
                            f"frame_{int(frame_id):05d}.jpg")

    def load_depth(self, scan_id, frame_id):
        return np.ones((self.depth_height, self.depth_width), np.float32)

    def load_full_res_depth(self, scan_id, frame_id):
        return np.ones((self.depth_height, self.depth_width), np.float32)
