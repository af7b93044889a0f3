"""ARKit (NeuralRecon-format) capture dataset (parity: datasets/arkit_dataset.py).

Copy of implicit_depth_tpu/data/arkit.py with only its imports changed
(the port imports nothing of the JAX package).

Scenes preprocessed with NeuralRecon's ARKit scripts: per-frame
poses/<id>.txt (already CV-convention world_T_cam), intrinsics/<id>.txt
(pre-scaled 3x3), images/<id>.jpg. Depth is DUMMY (arkit_dataset.py:24) —
this loader exists for inference/compositing. Video-frame extraction
helpers from the reference (arkit_dataset.py:425-649) are covered by
scripts/preprocess_arkit.py.
"""

from __future__ import annotations

import os

import numpy as np

from implicit_depth_tpu_torch.data.mvs_dataset import GenericMVSDataset
from implicit_depth_tpu_torch.utils.io import read_image


class ARKitDataset(GenericMVSDataset):
    def __init__(self, dataset_path: str, split: str,
                 native_depth_width: int = 640, native_depth_height: int = 480,
                 **kwargs):
        super().__init__(dataset_path=dataset_path, split=split, **kwargs)
        self.native_depth_width = native_depth_width
        self.native_depth_height = native_depth_height

    @staticmethod
    def get_sub_folder_dir(split: str) -> str:
        return ""

    def _scan_dir(self, scan_id: str) -> str:
        return os.path.join(self.dataset_path, scan_id)

    def get_valid_frame_ids(self, scan_id: str, store_computed: bool = False):
        d = os.path.join(self._scan_dir(scan_id), "poses")
        ids = sorted(os.path.splitext(f)[0] for f in os.listdir(d) if f.endswith(".txt"))
        valid = []
        for fid in ids:
            T = np.genfromtxt(os.path.join(d, f"{fid}.txt"))
            if np.isfinite(T).all():
                valid.append(f"{scan_id} {fid} 0")
        return valid

    def load_pose(self, scan_id, frame_id):
        T = np.genfromtxt(
            os.path.join(self._scan_dir(scan_id), "poses", f"{frame_id}.txt")
        ).astype(np.float32)
        return T, np.linalg.inv(T).astype(np.float32)

    def load_intrinsics(self, scan_id, frame_id=None, flip: bool = False) -> dict:
        K = np.eye(4)
        K[:3, :3] = np.genfromtxt(
            os.path.join(self._scan_dir(scan_id), "intrinsics", f"{frame_id}.txt")
        )
        if flip:
            K[0, 2] = self.native_depth_width - K[0, 2]
        Kd = K.copy()
        Kd[0] *= self.depth_width / self.native_depth_width
        Kd[1] *= self.depth_height / self.native_depth_height
        out = {}
        for s in range(5):
            Ks = Kd.copy()
            Ks[:2] /= 2**s
            out[f"K_s{s}"] = Ks.astype(np.float32)
            out[f"invK_s{s}"] = np.linalg.inv(Ks).astype(np.float32)
        return out

    def load_color(self, scan_id, frame_id):
        path = os.path.join(self._scan_dir(scan_id), "images", f"{frame_id}.jpg")
        return read_image(path, height=self.image_height, width=self.image_width)

    def get_high_res_color_path(self, scan_id, frame_id):
        # cached resize (arkit_dataset.py:270-292) if present, else native
        cached = os.path.join(self._scan_dir(scan_id), "images",
                              f"{frame_id}_{self.high_res_image_height}.png")
        return cached if os.path.exists(cached) else os.path.join(
            self._scan_dir(scan_id), "images", f"{frame_id}.jpg")

    def load_depth(self, scan_id, frame_id):
        return np.ones((self.depth_height, self.depth_width), np.float32)

    def load_full_res_depth(self, scan_id, frame_id):
        return np.ones((self.depth_height, self.depth_width), np.float32)
