"""ScanNetv2 dataset (parity: datasets/scannet_dataset.py).

Copy of implicit_depth_tpu/data/scannet.py with only its imports changed
(the port imports nothing of the JAX package).

Expected disk layout (scannet_dataset.py:21-77):
    dataset_path/scans[_test]/<scan>/
        <scan>.txt                      (metadata incl. depthWidth/Height)
        <scan>_vh_clean_2.ply           (GT mesh)
        intrinsic/intrinsic_depth.txt
        sensor_data/frame-XXXXXX.pose.txt
        sensor_data/frame-XXXXXX.color.jpg [.color.512.png cached]
        sensor_data/frame-XXXXXX.depth.png [.depth.256.png cached]
Depth PNGs are millimetres (*1e-3); invalid depths become NaN.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from implicit_depth_tpu_torch.data.mvs_dataset import GenericMVSDataset
from implicit_depth_tpu_torch.utils.io import color_jitter, read_image, readlines
from implicit_depth_tpu_torch.utils import native_io


class ScanNetDataset(GenericMVSDataset):
    def __init__(self, dataset_path: str, split: str,
                 min_valid_depth: float = 1e-3, max_valid_depth: float = 10.0,
                 color_jitter_train: bool = True, **kwargs):
        super().__init__(dataset_path=dataset_path, split=split, **kwargs)
        self.min_valid_depth = min_valid_depth
        self.max_valid_depth = max_valid_depth
        self.color_jitter_train = color_jitter_train
        self._meta_cache: dict = {}
        self._K_cache: dict = {}

    # ---- paths ----------------------------------------------------------
    @staticmethod
    def get_sub_folder_dir(split: str) -> str:
        return "scans_test" if split == "test" else "scans"

    @property
    def scenes_path(self) -> str:
        return os.path.join(self.dataset_path, self.get_sub_folder_dir(self.split))

    def _scan_dir(self, scan_id: str) -> str:
        return os.path.join(self.scenes_path, scan_id)

    def _sensor(self, scan_id: str, frame_id, suffix: str) -> str:
        return os.path.join(self._scan_dir(scan_id), "sensor_data", f"frame-{frame_id}.{suffix}")

    @staticmethod
    def get_gt_mesh_path(dataset_path: str, split: str, scan_id: str) -> str:
        return os.path.join(dataset_path, ScanNetDataset.get_sub_folder_dir(split),
                            scan_id, f"{scan_id}_vh_clean_2.ply")

    # ---- metadata -------------------------------------------------------
    def _metadata(self, scan_id: str) -> dict:
        if scan_id not in self._meta_cache:
            lines = readlines(os.path.join(self._scan_dir(scan_id), f"{scan_id}.txt"))
            self._meta_cache[scan_id] = dict(l.split(" = ") for l in lines if " = " in l)
        return self._meta_cache[scan_id]

    # ---- valid frames (scannet_dataset.py:211-306) -----------------------
    def get_valid_frame_path(self, scan_id: str) -> str:
        return os.path.join(self._scan_dir(scan_id), "valid_frames.txt")

    def get_valid_frame_ids(self, scan_id: str, store_computed: bool = True) -> list[str]:
        scan_id = scan_id.rstrip("\n")
        cached = self.get_valid_frame_path(scan_id)
        if os.path.exists(cached):
            return readlines(cached)

        meta = self._metadata(scan_id)
        count = int(meta["numColorFrames"].strip())
        valid, dist, bad = [], 0, 0
        for i in range(count):
            fid = f"{i:06d}"
            color = self._sensor(scan_id, fid, "color.jpg")
            depth = self._sensor(scan_id, fid, "depth.png")
            pose = self._sensor(scan_id, fid, "pose.txt")
            if not (os.path.isfile(color) and os.path.isfile(depth)):
                dist += 1
                bad += 1
                continue
            T = np.genfromtxt(pose).astype(np.float32)
            if not np.isfinite(T).all():
                dist += 1
                bad += 1
                continue
            valid.append(f"{scan_id} {fid} {dist}")
            dist = 0
        if store_computed:
            try:
                with open(cached, "w") as f:
                    f.write("\n".join(valid) + "\n")
            except OSError as e:  # read-only dataset dirs are fine
                print(f"Couldn't cache valid_frames for {scan_id}: {e}")
        return valid

    # ---- loaders ---------------------------------------------------------
    def load_color(self, scan_id, frame_id) -> np.ndarray:
        cached = self._sensor(scan_id, frame_id, f"color.{self.image_width}.png")
        path = cached if os.path.exists(cached) else self._sensor(scan_id, frame_id, "color.jpg")
        img = None
        if path.endswith(".jpg"):
            # native libjpeg fast path (GIL-free; see utils/native_io.py)
            img = native_io.decode_color_jpeg(path, self.image_height, self.image_width)
        if img is None:
            img = read_image(path, height=self.image_height, width=self.image_width)
        if self.split == "train" and self.color_jitter_train:
            img = color_jitter(img, self.rng)
        return img

    def get_high_res_color_path(self, scan_id, frame_id):
        # cached resize at the high-res height if present, else native jpg
        # (scannet_dataset.py:349-375)
        cached = self._sensor(
            scan_id, frame_id, f"color.{self.high_res_image_height}.png")
        return cached if os.path.exists(cached) else self._sensor(
            scan_id, frame_id, "color.jpg")

    def load_pose(self, scan_id, frame_id):
        T = np.genfromtxt(self._sensor(scan_id, frame_id, "pose.txt")).astype(np.float32)
        return T, np.linalg.inv(T).astype(np.float32)

    def load_intrinsics(self, scan_id, frame_id=None, flip: bool = False) -> dict:
        key = (scan_id, flip)
        if key in self._K_cache:
            return self._K_cache[key]
        meta = self._metadata(scan_id)
        K = np.genfromtxt(
            os.path.join(self._scan_dir(scan_id), "intrinsic", "intrinsic_depth.txt")
        ).astype(np.float64)
        if K.shape == (3, 3):
            K44 = np.eye(4)
            K44[:3, :3] = K
            K = K44
        native_w = float(meta["depthWidth"])
        native_h = float(meta["depthHeight"])
        if flip:
            K[0, 2] = native_w - K[0, 2]

        out = {
            "K_full_depth": K.astype(np.float32),
            "invK_full_depth": np.linalg.inv(K).astype(np.float32),
        }
        Kd = K.copy()
        Kd[0] *= self.depth_width / native_w
        Kd[1] *= self.depth_height / native_h
        for s in range(5):
            Ks = Kd.copy()
            Ks[:2] /= 2**s
            out[f"K_s{s}"] = Ks.astype(np.float32)
            out[f"invK_s{s}"] = np.linalg.inv(Ks).astype(np.float32)
        self._K_cache[key] = out
        return out

    def _load_depth_png(self, path: str, h: Optional[int] = None, w: Optional[int] = None) -> np.ndarray:
        if h is not None:
            native = native_io.decode_depth_png(
                path, h, w, scale=1e-3,
                min_valid=self.min_valid_depth, max_valid=self.max_valid_depth)
            if native is not None:
                return native
        depth = read_image(path, height=h, width=w, value_scale_factor=1e-3, nearest=True)
        invalid = ~((depth > self.min_valid_depth) & (depth < self.max_valid_depth))
        depth = depth.astype(np.float32)
        depth[invalid] = np.nan
        return depth

    def load_depth(self, scan_id, frame_id) -> np.ndarray:
        cached = self._sensor(scan_id, frame_id, f"depth.{self.depth_width}.png")
        path = cached if os.path.exists(cached) else self._sensor(scan_id, frame_id, "depth.png")
        return self._load_depth_png(path, self.depth_height, self.depth_width)

    def load_full_res_depth(self, scan_id, frame_id) -> np.ndarray:
        return self._load_depth_png(self._sensor(scan_id, frame_id, "depth.png"))

    def get_frame_id_string(self, frame_id) -> str:
        return str(frame_id)
