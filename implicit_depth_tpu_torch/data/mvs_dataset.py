"""Generic MVS dataset contract (host-side numpy).

Copy of implicit_depth_tpu/data/mvs_dataset.py with only its imports
changed: the port keeps its own copy so that it imports nothing of the
JAX package. The original reimplements datasets/generic_mvs_dataset.py for the NHWC batch contract
used by BDNet/DepthNet:

cur frame dict:
  image (h, w, 3) imagenet-normalised fp32
  depth (hd, wd, 1) fp32, NaN = invalid; mask (hd, wd, 1) bool
  gt_depth (hg, wg, 1) NaN-free (invalid -> 0) for BD target sampling
  K_s{0..4} / invK_s{0..4} (4, 4); K_full_depth/invK_full_depth optional
  world_T_cam / cam_T_world (4, 4)
  [train BD] sampled_rays (N, 2) pixel coords (+0.5 centres, gt_depth
             space), sampled_depths (N, S)
  [val BD]   rendered_depth (hd, wd, P), 8 planes 1.5..5.0 m
  [optional] high_res_color (Hh, Wh, 3) imagenet-normalised
             (generic_mvs_dataset.py:604-609)
src dict: same keys stacked on a leading source axis, sorted by DVMVS
pose distance to the reference frame
(datasets/generic_mvs_dataset.py:791-807).

Ray/depth sampling parity: generate_depth_samples
(datasets/generic_mvs_dataset.py:660-727): stratified samples over the
frame's [min, max] valid depth plus near-surface gaussian samples
(additive sigma=0.05 or multiplicative), near-edge ray boosting via a
sobel edge mask.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from implicit_depth_tpu_torch.data.keyframes import pose_distance_np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def imagenet_normalize(img_hw3: np.ndarray) -> np.ndarray:
    return (img_hw3 - IMAGENET_MEAN) / IMAGENET_STD


def reverse_imagenet_normalize(img_hw3: np.ndarray) -> np.ndarray:
    return img_hw3 * IMAGENET_STD + IMAGENET_MEAN


def intrinsics_pyramid(K_full: np.ndarray, image_h: int, image_w: int,
                       native_h: int, native_w: int, num_scales: int = 5) -> dict:
    """K_s0 is at depth resolution (image/2); each scale halves again
    (datasets/scannet_dataset.py:436-488 behaviour)."""
    out = {}
    K = K_full.astype(np.float64).copy()
    # rescale from native resolution to image resolution
    K[0] *= image_w / native_w
    K[1] *= image_h / native_h
    K44 = np.eye(4)
    K44[:3, :3] = K[:3, :3]
    for s in range(num_scales):
        Ks = K44.copy()
        scale = 2.0 ** (s + 1)
        Ks[0] /= scale
        Ks[1] /= scale
        out[f"K_s{s}"] = Ks.astype(np.float32)
        out[f"invK_s{s}"] = np.linalg.inv(Ks).astype(np.float32)
    return out


def sobel_edge_mask(depth_hw: np.ndarray, threshold: float = 0.975) -> np.ndarray:
    """Edge mask on inverse depth (generic_mvs_dataset.py:649-658)."""
    inv = 1.0 / depth_hw
    inv = np.nan_to_num(inv, nan=0.0, posinf=0.0)
    pad = np.pad(inv, 1, mode="edge")
    gx = (
        (pad[:-2, 2:] + 2 * pad[1:-1, 2:] + pad[2:, 2:])
        - (pad[:-2, :-2] + 2 * pad[1:-1, :-2] + pad[2:, :-2])
    ) / 8.0
    gy = (
        (pad[2:, :-2] + 2 * pad[2:, 1:-1] + pad[2:, 2:])
        - (pad[:-2, :-2] + 2 * pad[:-2, 1:-1] + pad[:-2, 2:])
    ) / 8.0
    mag = np.sqrt(gx * gx + gy * gy + 1e-6)
    finite = np.isfinite(mag)
    thr = np.quantile(mag[finite], threshold) if finite.any() else np.inf
    return mag > thr


@dataclass
class BDSamplingConfig:
    num_rays: int = 4096
    samples_per_ray: int = 64
    near_surface_ratio: float = 0.25
    surface_noise_type: str = "additive"
    near_edge_sampling: bool = False
    near_edge_ratio: float = 0.4
    validation_planes: Sequence[float] = field(
        default_factory=lambda: list(np.linspace(1.5, 5.0, 8))
    )


class GenericMVSDataset:
    """Base class; subclasses implement the per-frame loaders."""

    def __init__(
        self,
        dataset_path: str,
        split: str,
        mv_tuple_file_suffix: Optional[str] = None,
        tuple_info_file_location: Optional[str] = None,
        limit_to_scan_id: Optional[str] = None,
        num_images_in_tuple: Optional[int] = None,
        image_height: int = 384,
        image_width: int = 512,
        include_full_res_depth: bool = False,
        include_high_res_color: bool = False,
        high_res_image_height: int = 480,
        high_res_image_width: int = 640,
        shuffle_tuple: bool = False,
        get_bd_info: bool = False,
        full_depth_supervision: bool = True,
        bd_config: Optional[BDSamplingConfig] = None,
        skip_frames: Optional[int] = None,
        pass_frame_id: bool = False,
        seed: int = 0,
    ):
        self.dataset_path = dataset_path
        self.split = split
        self.image_height = image_height
        self.image_width = image_width
        self.depth_height = image_height // 2
        self.depth_width = image_width // 2
        self.include_full_res_depth = include_full_res_depth
        self.include_high_res_color = include_high_res_color
        self.high_res_image_height = high_res_image_height
        self.high_res_image_width = high_res_image_width
        self.shuffle_tuple = shuffle_tuple
        self.get_bd_info = get_bd_info
        self.full_depth_supervision = full_depth_supervision
        self.bd = bd_config or BDSamplingConfig()
        self.num_images_in_tuple = num_images_in_tuple
        self.pass_frame_id = pass_frame_id
        self.rng = np.random.RandomState(seed)

        self.frame_tuples: list[str] = []
        if mv_tuple_file_suffix is not None:
            path = os.path.join(tuple_info_file_location, f"{split}{mv_tuple_file_suffix}")
            assert os.path.exists(path), f"Tuple file missing: {path}"
            with open(path) as f:
                self.frame_tuples = f.read().splitlines()
            if limit_to_scan_id is not None:
                self.frame_tuples = [
                    t for t in self.frame_tuples if t.split(" ")[0] == limit_to_scan_id
                ]
            if skip_frames is not None:
                self.frame_tuples = self.frame_tuples[::skip_frames]

    def __len__(self) -> int:
        return len(self.frame_tuples)

    # ---- abstract per-frame loaders ----------------------------------
    def load_color(self, scan_id, frame_id) -> np.ndarray:
        """(h, w, 3) float in [0,1] at image resolution."""
        raise NotImplementedError

    def load_pose(self, scan_id, frame_id):
        """-> (world_T_cam (4,4), cam_T_world (4,4))."""
        raise NotImplementedError

    def load_intrinsics(self, scan_id, frame_id, flip: bool = False) -> dict:
        """-> K_s{i}/invK_s{i} dict (see intrinsics_pyramid)."""
        raise NotImplementedError

    def load_depth(self, scan_id, frame_id) -> np.ndarray:
        """(hd, wd) float depth at depth resolution; NaN invalid."""
        raise NotImplementedError

    def load_full_res_depth(self, scan_id, frame_id) -> np.ndarray:
        """(H, W) native-res depth; NaN invalid."""
        raise NotImplementedError

    def get_high_res_color_path(self, scan_id, frame_id) -> Optional[str]:
        """Filepath of the frame's RGB at (or above) high-res resolution;
        None when the dataset has no high-res source."""
        return None

    def load_high_res_color(self, scan_id, frame_id) -> np.ndarray:
        """(Hh, Wh, 3) float in [0,1] at high_res_image_{height,width}
        (generic_mvs_dataset.py:472-494)."""
        from implicit_depth_tpu_torch.utils.io import read_image

        path = self.get_high_res_color_path(scan_id, frame_id)
        if path is None:
            raise NotImplementedError(
                f"{type(self).__name__} has no high-res color source"
            )
        return read_image(
            path, height=self.high_res_image_height, width=self.high_res_image_width
        )

    def get_frame_id_string(self, frame_id) -> str:
        return str(frame_id)

    # ---- frame assembly ----------------------------------------------
    def get_frame(self, scan_id, frame_id, flip: bool = False, bd_info: bool = False) -> dict:
        world_T_cam, cam_T_world = self.load_pose(scan_id, frame_id)
        if flip:
            F = np.eye(4, dtype=world_T_cam.dtype)
            F[0, 0] = -1.0
            world_T_cam = world_T_cam @ F
            cam_T_world = np.linalg.inv(world_T_cam)

        image = self.load_color(scan_id, frame_id)
        if flip:
            image = image[:, ::-1].copy()
        image = imagenet_normalize(image.astype(np.float32))

        depth = self.load_depth(scan_id, frame_id).astype(np.float32)
        if flip:
            depth = depth[:, ::-1].copy()
        mask = np.isfinite(depth) & (depth > 0)

        out = {
            "image": image,
            "world_T_cam": world_T_cam.astype(np.float32),
            "cam_T_world": cam_T_world.astype(np.float32),
            "depth": depth[..., None],
            "mask": mask[..., None],
        }
        out.update(self.load_intrinsics(scan_id, frame_id, flip=flip))

        if self.include_full_res_depth or (bd_info and self.full_depth_supervision):
            fr = self.load_full_res_depth(scan_id, frame_id).astype(np.float32)
            if flip:
                fr = fr[:, ::-1].copy()
            out["full_res_depth"] = fr[..., None]
            out["full_res_mask"] = (np.isfinite(fr) & (fr > 0))[..., None]

        if self.include_high_res_color:
            # generic_mvs_dataset.py:604-609: normalised + data-space flip
            hrc = self.load_high_res_color(scan_id, frame_id).astype(np.float32)
            if flip:
                hrc = hrc[:, ::-1].copy()
            out["high_res_color"] = imagenet_normalize(hrc)

        if self.pass_frame_id:
            out["frame_id_string"] = self.get_frame_id_string(frame_id)

        if bd_info:
            if self.full_depth_supervision:
                d, m = out["full_res_depth"][..., 0], out["full_res_mask"][..., 0]
            else:
                d, m = depth, mask
            out.update(self.generate_depth_samples(d, m))
            out["gt_depth"] = np.where(m, d, 0.0)[..., None].astype(np.float32)
        return out

    def generate_depth_samples(self, depth_hw: np.ndarray, mask_hw: np.ndarray) -> dict:
        """BD ray/depth samples (generic_mvs_dataset.py:660-727)."""
        bd = self.bd
        if self.split != "train":
            hd, wd = self.depth_height, self.depth_width
            planes = np.asarray(bd.validation_planes, np.float32)
            rendered = np.broadcast_to(planes[None, None, :], (hd, wd, len(planes)))
            return {"rendered_depth": np.ascontiguousarray(rendered)}

        h, w = depth_hw.shape
        xs, ys = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
        grid = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)
        valid = mask_hw.ravel()
        flat_depth = depth_hw.ravel()

        n_rays = bd.num_rays
        random_per_ray = int(bd.samples_per_ray * (1 - bd.near_surface_ratio))
        surface_per_ray = bd.samples_per_ray - random_per_ray

        if valid.sum() < n_rays:
            min_d, max_d = 0.5, 5.0
            rays = grid[:n_rays]
            surface = flat_depth[:n_rays]
        else:
            min_d = flat_depth[valid].min()
            max_d = flat_depth[valid].max()
            vgrid = grid[valid]
            vdepth = flat_depth[valid]
            if bd.near_edge_sampling:
                n_plain = int(n_rays * (1 - bd.near_edge_ratio))
                idx = self.rng.permutation(len(vgrid))[:n_plain]
                rays1, d1 = vgrid[idx], vdepth[idx]
                edge = sobel_edge_mask(depth_hw).ravel()
                egrid = grid[edge]
                edepth = flat_depth[edge]
                eidx = self.rng.permutation(len(egrid))[: n_rays - n_plain]
                rays = np.concatenate([rays1, egrid[eidx]])
                surface = np.concatenate([d1, edepth[eidx]])
            else:
                idx = self.rng.permutation(len(vgrid))[:n_rays]
                rays, surface = vgrid[idx], vdepth[idx]

        ramp = np.linspace(0, 1, random_per_ray, dtype=np.float32)[None, :]
        samples = min_d + ramp * (max_d - min_d)
        stride = (max_d - min_d) / random_per_ray
        samples = samples - stride / 2 + self.rng.rand(n_rays, random_per_ray).astype(np.float32) * stride

        if surface_per_ray:
            noise = self.rng.randn(n_rays, surface_per_ray).astype(np.float32) * 0.05
            if bd.surface_noise_type == "additive":
                near = surface[:, None] + noise
            elif bd.surface_noise_type == "multiplicative":
                near = surface[:, None] * (1.0 + noise)
            else:
                raise ValueError(bd.surface_noise_type)
            samples = np.concatenate([samples, near], axis=1)

        return {
            "sampled_rays": rays.astype(np.float32),
            "sampled_depths": samples.astype(np.float32),
        }

    # ---- tuple assembly ------------------------------------------------
    def __getitem__(self, idx: int):
        flip = self.split == "train" and bool(self.rng.rand() < 0.5)
        scan_id, *frame_ids = self.frame_tuples[idx].split(" ")
        if self.shuffle_tuple:
            rest = frame_ids[1:]
            self.rng.shuffle(rest)
            frame_ids = frame_ids[:1] + rest
        if self.num_images_in_tuple is not None:
            frame_ids = frame_ids[: self.num_images_in_tuple]

        frames = [
            self.get_frame(scan_id, fid, flip=flip, bd_info=self.get_bd_info and i == 0)
            for i, fid in enumerate(frame_ids)
        ]
        cur, src_list = frames[0], frames[1:]

        if not self.shuffle_tuple:
            # order sources by DVMVS pose distance to the reference
            pens = [
                pose_distance_np(
                    np.eye(4), cur["cam_T_world"].astype(np.float64) @ s["world_T_cam"].astype(np.float64)
                )[0]
                for s in src_list
            ]
            src_list = [src_list[i] for i in np.argsort(pens)]

        src = {}
        for key in src_list[0]:
            if key == "frame_id_string":
                src[key] = [s[key] for s in src_list]
            else:
                src[key] = np.stack([s[key] for s in src_list])
        return cur, src


def collate(samples: list) -> tuple[dict, dict]:
    """Stacks a list of (cur, src) samples into batched numpy dicts."""
    curs, srcs = zip(*samples)
    def stack(dicts):
        out = {}
        for k in dicts[0]:
            if k == "frame_id_string":
                out[k] = [d[k] for d in dicts]
            else:
                out[k] = np.stack([d[k] for d in dicts])
        return out
    return stack(curs), stack(srcs)
