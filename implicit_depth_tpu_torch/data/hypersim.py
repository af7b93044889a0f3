"""Hypersim dataset (parity: datasets/hypersim_dataset.py).

Copy of implicit_depth_tpu/data/hypersim.py with only its imports changed
(the port imports nothing of the JAX package).

Scan ids are '<scene>/<cam>' (e.g. 'ai_001_001/cam_00'). Poses come from
camera_keyframe_positions/orientations HDF5 in asset units (scaled by
meters_per_asset_unit), OpenGL convention -> CV + rotx(-pi/2)
(hypersim_dataset.py:647-711). Intrinsics derive from M_proj / M_screen
(hypersim_dataset.py:444-529). Depths are PLANAR depths precomputed from
ray distances (scripts/generate_hypersim_planar_depths.py; conversion
implemented in `perpendicular_depth_from_distance`,
hypersim_dataset.py:780-807). Anomalous (mode-dominated) renders are
filtered (hypersim_dataset.py:179-198).
"""

from __future__ import annotations

import json
import os

import numpy as np

from implicit_depth_tpu_torch.core.geometry import rotx
from implicit_depth_tpu_torch.data.mvs_dataset import GenericMVSDataset
from implicit_depth_tpu_torch.utils.io import read_image

GL_TO_CV = np.array(
    [[1, -1, -1, 1], [-1, 1, 1, -1], [-1, 1, 1, -1], [1, 1, 1, 1]], np.float32
)


def gl_pose_to_cv(world_T_cam_gl: np.ndarray) -> np.ndarray:
    """OpenGL camera pose -> OpenCV convention + rotx(-pi/2) world frame."""
    T = world_T_cam_gl.astype(np.float32) * GL_TO_CV
    R_fix = rotx(-np.pi / 2).astype(np.float32)
    T[:3, :3] = R_fix @ T[:3, :3]
    T[:3, 3] = R_fix @ T[:3, 3]
    return T


def perpendicular_depth_from_distance(distance_hw: np.ndarray, rays_cam_hw3: np.ndarray) -> np.ndarray:
    """Converts Hypersim ray distances to planar (z) depth
    (hypersim_dataset.py:780-807): depth = -distance * ray_z (rays in the
    OpenGL camera frame point down -z)."""
    return -distance_hw * rays_cam_hw3[..., 2]


def image_is_anomalous(img: np.ndarray, threshold: float = 0.3) -> bool:
    """Mode-fraction filter (hypersim_dataset.py:179-198): an image is
    anomalous when more than `threshold` of its pixels share one value
    (bad/black renders). Works on raw uint8 color and float depth alike."""
    flat = np.asarray(img).ravel()
    if flat.size == 0:
        return True
    _, counts = np.unique(flat, return_counts=True)
    return counts.max() / flat.size > threshold


class HypersimDataset(GenericMVSDataset):
    def __init__(self, dataset_path: str, split: str,
                 split_json_dir: str = "data_splits/hypersim",
                 min_valid_depth: float = 1e-3, max_valid_depth: float = 20.0,
                 use_min_max_depth: bool = False,
                 **kwargs):
        super().__init__(dataset_path=dataset_path, split=split, **kwargs)
        self.split_json_dir = split_json_dir
        self.min_valid_depth = min_valid_depth
        self.max_valid_depth = max_valid_depth
        # False: NaN-only masking; True: additionally mask outside
        # (min_valid, max_valid) (hypersim_dataset.py:135-145, 560-570)
        self.use_min_max_depth = use_min_max_depth
        self._cam_params: dict = {}
        self._scale_cache: dict = {}
        self._h5: dict = {}

    @staticmethod
    def get_sub_folder_dir(split: str) -> str:
        return ""

    def _scene_cam(self, scan_id: str):
        scene, cam = os.path.split(scan_id)
        return scene, cam

    def _detail_dir(self, scan_id: str) -> str:
        scene, cam = self._scene_cam(scan_id)
        return os.path.join(self.dataset_path, scene, "_detail", cam)

    def _frame_ids(self, scan_id: str) -> list:
        sub = "standard_split" if self.split == "test" else "bd_split"
        name = (f"{self.split}_files_all.json" if self.split == "test"
                else f"{self.split}_files_bd.json")
        with open(os.path.join(self.split_json_dir, sub, name)) as f:
            return json.load(f)[scan_id]

    def get_valid_frame_path(self, scan_id: str) -> str:
        return os.path.join(self.dataset_path, "valid_frames", scan_id,
                            "valid_frames.txt")

    def get_valid_frame_ids(self, scan_id: str, store_computed: bool = True):
        """Computes (or loads cached) valid frames for a scan, filtering
        anomalous color/depth renders and non-finite poses — the
        reference's mode-fraction filter applied during valid-frame
        computation (hypersim_dataset.py:210-283)."""
        cache_path = self.get_valid_frame_path(scan_id)
        if os.path.exists(cache_path):
            with open(cache_path) as f:
                return [ln.strip() for ln in f if ln.strip()]

        valid_frames = []
        dist_to_last_valid = 0
        bad = 0
        for fid in self._frame_ids(scan_id):
            if self._frame_is_bad(scan_id, fid):
                bad += 1
                dist_to_last_valid += 1
                continue
            valid_frames.append(f"{scan_id} {fid} {dist_to_last_valid}")
            dist_to_last_valid = 0
        if bad:
            print(f"Scene {scan_id}: filtered {bad} bad frames.")

        if store_computed:
            try:
                os.makedirs(os.path.dirname(cache_path), exist_ok=True)
                with open(cache_path, "w") as f:
                    f.write("\n".join(valid_frames) + "\n")
            except OSError as e:
                print(f"couldn't save valid_frames at {cache_path}: {e}")
        return valid_frames

    def _frame_is_bad(self, scan_id: str, frame_id) -> bool:
        """True when the frame's color or depth render is anomalous or its
        pose is non-finite (hypersim_dataset.py:237-266)."""
        from PIL import Image

        scene, cam = self._scene_cam(scan_id)
        img_path = os.path.join(self._image_dir(scan_id),
                                f"scene_{cam}_final_preview",
                                f"frame.{int(frame_id):04d}.tonemap.jpg")
        if image_is_anomalous(np.asarray(Image.open(img_path))):
            return True
        if image_is_anomalous(self._depth_h5(scan_id, frame_id)):
            return True
        world_T_cam, _ = self.load_pose(scan_id, frame_id)
        return not np.isfinite(world_T_cam).all()

    # ---- camera parameters ------------------------------------------------
    def _params(self, scan_id: str) -> dict:
        scene, _ = self._scene_cam(scan_id)
        if scene in self._cam_params:
            return self._cam_params[scene]
        import pandas as pd

        df = pd.read_csv(
            os.path.join(self.dataset_path, "metadata_camera_parameters.csv"),
            index_col="scene_name",
        ).loc[scene]
        w, h = int(df["settings_output_img_width"]), int(df["settings_output_img_height"])
        M_proj = np.array([[df[f"M_proj_{i}{j}"] for j in range(4)] for i in range(4)])
        M_screen = np.array([
            [0.5 * (w - 1), 0, 0, 0.5 * (w - 1)],
            [0, -0.5 * (h - 1), 0, 0.5 * (h - 1)],
            [0, 0, 0.5, 0.5],
            [0, 0, 0, 1.0],
        ])
        sc = M_screen @ M_proj
        M_cam_from_uv = np.array([[df[f"M_cam_from_uv_{i}{j}"] for j in range(3)]
                                  for i in range(3)]) if "M_cam_from_uv_00" in df else None
        params = {
            "width": w, "height": h,
            "fx": abs(sc[0, 0]), "fy": abs(sc[1, 1]),
            "cx": abs(sc[0, 2]), "cy": abs(sc[1, 2]),
            "M_cam_from_uv": M_cam_from_uv,
        }
        self._cam_params[scene] = params
        return params

    def _meters_per_unit(self, scan_id: str) -> float:
        scene, _ = self._scene_cam(scan_id)
        if scene not in self._scale_cache:
            import pandas as pd

            df = pd.read_csv(os.path.join(self.dataset_path, scene, "_detail",
                                          "metadata_scene.csv"))
            row = df[df.parameter_name == "meters_per_asset_unit"]
            self._scale_cache[scene] = float(row.parameter_value.iloc[0])
        return self._scale_cache[scene]

    def load_intrinsics(self, scan_id, frame_id=None, flip: bool = False) -> dict:
        p = self._params(scan_id)
        K = np.eye(4)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = p["fx"], p["fy"], p["cx"], p["cy"]
        if flip:
            K[0, 2] = p["width"] - K[0, 2]
        out = {
            "K_full_depth": K.astype(np.float32),
            "invK_full_depth": np.linalg.inv(K).astype(np.float32),
        }
        Kd = K.copy()
        Kd[0] *= self.depth_width / p["width"]
        Kd[1] *= self.depth_height / p["height"]
        for s in range(5):
            Ks = Kd.copy()
            Ks[:2] /= 2**s
            out[f"K_s{s}"] = Ks.astype(np.float32)
            out[f"invK_s{s}"] = np.linalg.inv(Ks).astype(np.float32)
        return out

    # ---- pose ---------------------------------------------------------------
    def load_pose(self, scan_id, frame_id):
        import h5py

        d = self._detail_dir(scan_id)
        frame = int(frame_id)
        with h5py.File(os.path.join(d, "camera_keyframe_positions.hdf5"), "r") as f:
            t = np.asarray(f["dataset"][frame], np.float64)
        with h5py.File(os.path.join(d, "camera_keyframe_orientations.hdf5"), "r") as f:
            R = np.asarray(f["dataset"][frame], np.float64)
        scale = self._meters_per_unit(scan_id)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t * scale
        world_T_cam = gl_pose_to_cv(T)
        return world_T_cam, np.linalg.inv(world_T_cam).astype(np.float32)

    # ---- images / depth -------------------------------------------------------
    def _image_dir(self, scan_id: str) -> str:
        scene, cam = self._scene_cam(scan_id)
        return os.path.join(self.dataset_path, scene, "images")

    def load_color(self, scan_id, frame_id):
        scene, cam = self._scene_cam(scan_id)
        path = os.path.join(self._image_dir(scan_id),
                            f"scene_{cam}_final_preview",
                            f"frame.{int(frame_id):04d}.tonemap.jpg")
        return read_image(path, height=self.image_height, width=self.image_width)

    def get_high_res_color_path(self, scan_id, frame_id):
        scene, cam = self._scene_cam(scan_id)
        return os.path.join(self._image_dir(scan_id),
                            f"scene_{cam}_final_preview",
                            f"frame.{int(frame_id):04d}.tonemap.jpg")

    def _depth_h5(self, scan_id, frame_id, planar: bool = True):
        import h5py

        scene, cam = self._scene_cam(scan_id)
        name = "depth_meters" if planar else "depth_meters"
        geo = os.path.join(self._image_dir(scan_id), f"scene_{cam}_geometry_hdf5")
        planar_path = os.path.join(geo, f"frame.{int(frame_id):04d}.planar_depth_meters.hdf5")
        dist_path = os.path.join(geo, f"frame.{int(frame_id):04d}.depth_meters.hdf5")
        if planar and os.path.exists(planar_path):
            with h5py.File(planar_path, "r") as f:
                return np.asarray(f["dataset"], np.float32)
        with h5py.File(dist_path, "r") as f:
            distance = np.asarray(f["dataset"], np.float32)
        p = self._params(scan_id)
        if p["M_cam_from_uv"] is None:
            return distance  # fall back: distance as depth
        h, w = distance.shape
        u, v = np.meshgrid(np.linspace(0, 1, w), np.linspace(1, 0, h))
        uv1 = np.stack([u, v, np.ones_like(u)], -1)
        rays = uv1 @ np.asarray(p["M_cam_from_uv"]).T
        rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
        return perpendicular_depth_from_distance(distance, rays)

    def _mask_invalid(self, depth):
        if self.use_min_max_depth:
            invalid = ~((depth > self.min_valid_depth) & (depth < self.max_valid_depth)
                        & np.isfinite(depth))
        else:
            invalid = ~np.isfinite(depth)
        depth = depth.copy()
        depth[invalid] = np.nan
        return depth

    def load_depth(self, scan_id, frame_id):
        import cv2

        d = self._depth_h5(scan_id, frame_id)
        d = cv2.resize(d, (self.depth_width, self.depth_height),
                       interpolation=cv2.INTER_NEAREST)
        return self._mask_invalid(d)

    def load_full_res_depth(self, scan_id, frame_id):
        return self._mask_invalid(self._depth_h5(scan_id, frame_id))
