"""Procedural synthetic MVS dataset (test fixture + e2e smoke training).

Copy of implicit_depth_tpu/data/synthetic.py with only its imports
changed (the port imports nothing of the JAX package).

No reference counterpart (the reference has no test suite, SURVEY.md §4);
this fills that gap: a scene of textured axis-aligned rectangles in front
of a background wall, rendered analytically (exact depth, multi-view
consistent color), with cameras on a jittered arc. Serves unit/e2e tests,
the eval-driver harness, and profiling without ScanNet on disk.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from implicit_depth_tpu_torch.data.mvs_dataset import BDSamplingConfig, GenericMVSDataset


def _camera_rays(K: np.ndarray, h: int, w: int) -> np.ndarray:
    xs, ys = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
    pix = np.stack([xs, ys, np.ones_like(xs)], -1)  # (h, w, 3)
    invK = np.linalg.inv(K[:3, :3])
    return pix @ invK.T  # (h, w, 3), z = 1


class SyntheticScene:
    """A wall at z=z_far plus `num_rects` floating textured rectangles."""

    def __init__(self, seed: int = 0, num_rects: int = 6, z_far: float = 4.5):
        rng = np.random.RandomState(seed)
        self.z_far = z_far
        self.rects = []  # (z, x0, x1, y0, y1, color_seed)
        for i in range(num_rects):
            z = rng.uniform(1.0, 3.8)
            cx, cy = rng.uniform(-1.2, 1.2), rng.uniform(-0.9, 0.9)
            sx, sy = rng.uniform(0.3, 1.0), rng.uniform(0.3, 1.0)
            self.rects.append((z, cx - sx, cx + sx, cy - sy, cy + sy, rng.uniform(0, 10, 3)))

    def _texture(self, x, y, seed3, out):
        """Writes the 3 texture channels of the (masked) pixels into `out`
        (n, 3) in place — no intermediate stacks (the np.stack-per-surface
        formulation dominated host data time on 1-core hosts)."""
        np.sin(3.1 * x * (1 + seed3[0]) + seed3[1], out=out[:, 0])
        np.sin(2.7 * y * (1 + seed3[1]) + seed3[2], out=out[:, 1])
        np.sin(2.3 * (x + y) * (1 + seed3[2]) + seed3[0], out=out[:, 2])
        out *= 0.5
        out += 0.5

    def render(self, world_T_cam: np.ndarray, K: np.ndarray, h: int, w: int):
        """Returns (color (h,w,3) in [0,1], depth (h,w) camera z-depth)."""
        rays_cam = _camera_rays(K, h, w)
        R = world_T_cam[:3, :3]
        o = world_T_cam[:3, 3]
        rays_w = (rays_cam @ R.T).astype(np.float32)  # scaled so cam-z == 1

        depth = np.full((h, w), np.inf, np.float32)
        color = np.zeros((h, w, 3), np.float32)
        dz = rays_w[..., 2]
        inv_dz = 1.0 / np.where(np.abs(dz) < 1e-9, 1e-9, dz)

        surfaces = [(self.z_far, -1e9, 1e9, -1e9, 1e9, np.array([1.0, 2.0, 3.0]))] + self.rects
        for z0, x0, x1, y0, y1, cseed in surfaces:
            t = (z0 - o[2]) * inv_dz
            px = o[0] + t * rays_w[..., 0]
            py = o[1] + t * rays_w[..., 1]
            hit = (t > 0.05) & (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1) & (t < depth)
            idx = np.nonzero(hit.ravel())[0]
            if idx.size == 0:
                continue
            depth.ravel()[idx] = t.ravel()[idx]
            # texture evaluated only at the hit pixels
            tex = np.empty((idx.size, 3), np.float32)
            self._texture(px.ravel()[idx], py.ravel()[idx], cseed, tex)
            color.reshape(-1, 3)[idx] = tex

        depth[np.isinf(depth)] = np.nan
        return color, depth


class SyntheticDataset(GenericMVSDataset):
    """GenericMVSDataset over SyntheticScene; frames indexed 0..n-1 along a
    camera arc. Tuples: each frame + its num_views-1 predecessors."""

    def __init__(
        self,
        num_frames: int = 16,
        num_views: int = 8,
        image_height: int = 64,
        image_width: int = 96,
        split: str = "train",
        scene_seed: int = 0,
        full_res_scale: int = 2,
        bd_config: Optional[BDSamplingConfig] = None,
        **kwargs,
    ):
        super().__init__(
            dataset_path="<synthetic>",
            split=split,
            image_height=image_height,
            image_width=image_width,
            bd_config=bd_config,
            **kwargs,
        )
        self.scene = SyntheticScene(seed=scene_seed)
        self.num_frames = num_frames
        self.full_res_scale = full_res_scale
        self.frame_tuples = []
        for i in range(num_views - 1, num_frames):
            ids = [str(i)] + [str(i - j - 1) for j in range(num_views - 1)]
            self.frame_tuples.append("scene0 " + " ".join(ids))

        rng = np.random.RandomState(scene_seed + 1)
        self.poses = []
        for i in range(num_frames):
            ang = 0.04 * (i - num_frames / 2)
            c, s = np.cos(ang), np.sin(ang)
            T = np.eye(4, dtype=np.float64)
            T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
            T[:3, 3] = [
                0.25 * np.sin(0.5 * i) + 0.02 * rng.randn(),
                0.05 * np.cos(0.7 * i),
                -0.05 * i / num_frames,
            ]
            self.poses.append(T)

        fx = 0.9 * image_width
        self.K_full = np.eye(4, dtype=np.float64)
        self.K_full[0, 0] = fx
        self.K_full[1, 1] = fx
        self.K_full[0, 2] = image_width / 2
        self.K_full[1, 2] = image_height / 2

        self._cache: dict = {}

    # ---- loaders -------------------------------------------------------
    def _render(self, frame_id: int, h: int, w: int):
        key = (frame_id, h, w)
        if key not in self._cache:
            K = self.K_full.copy()
            K[0] *= w / self.image_width
            K[1] *= h / self.image_height
            self._cache[key] = self.scene.render(self.poses[frame_id], K, h, w)
        return self._cache[key]

    def load_color(self, scan_id, frame_id):
        color, _ = self._render(int(frame_id), self.image_height, self.image_width)
        return color

    def load_pose(self, scan_id, frame_id):
        T = self.poses[int(frame_id)].astype(np.float32)
        return T, np.linalg.inv(T).astype(np.float32)

    def load_intrinsics(self, scan_id, frame_id, flip: bool = False) -> dict:
        out = {}
        K44 = self.K_full.copy()
        if flip:
            K44[0, 2] = self.image_width - K44[0, 2]
        for s in range(5):
            Ks = K44.copy()
            scale = 2.0 ** (s + 1)
            Ks[0] /= scale
            Ks[1] /= scale
            out[f"K_s{s}"] = Ks.astype(np.float32)
            out[f"invK_s{s}"] = np.linalg.inv(Ks).astype(np.float32)
        return out

    def load_depth(self, scan_id, frame_id):
        _, depth = self._render(int(frame_id), self.depth_height, self.depth_width)
        return depth

    def load_full_res_depth(self, scan_id, frame_id):
        _, depth = self._render(
            int(frame_id),
            self.image_height * self.full_res_scale // 2,
            self.image_width * self.full_res_scale // 2,
        )
        return depth

    def get_valid_frame_ids(self, scan_id=None, store_computed: bool = False):
        """All synthetic frames are valid; dist-to-last-valid is 0."""
        return [f"scene0 {i} 0" for i in range(self.num_frames)]

    @staticmethod
    def get_gt_mesh_path(dataset_path: str, split: str, scan_id: str,
                         target_faces: int = 1_000_000) -> str:
        """Procedural GT mesh for temporal evaluation (the role ScanNet's
        `_vh_clean_2.ply` plays, scannet.py:53-55): the default scene's
        background wall + floating rectangles, tessellated to
        ~`target_faces` triangles and cached as binary PLY."""
        import os
        import struct
        import tempfile

        cache = os.path.join(tempfile.gettempdir(), "implicit_depth_tpu_meshes")
        os.makedirs(cache, exist_ok=True)
        path = os.path.join(cache, f"{scan_id}_synthetic_{target_faces}.ply")
        if os.path.exists(path):
            return path

        scene = SyntheticScene(seed=0)
        surfaces = [(scene.z_far, -4.0, 4.0, -3.0, 3.0)] + [
            r[:5] for r in scene.rects
        ]
        total_area = sum((x1 - x0) * (y1 - y0) for _, x0, x1, y0, y1 in surfaces)
        all_verts, all_faces = [], []
        base = 0
        for z, x0, x1, y0, y1 in surfaces:
            area = (x1 - x0) * (y1 - y0)
            n_quads = max(4, int(target_faces / 2 * area / total_area))
            nx = max(2, int(np.sqrt(n_quads * (x1 - x0) / (y1 - y0))))
            ny = max(2, n_quads // max(nx, 1))
            xs, ys = np.meshgrid(np.linspace(x0, x1, nx + 1), np.linspace(y0, y1, ny + 1))
            v = np.stack([xs, ys, np.full_like(xs, z)], -1).reshape(-1, 3)
            ii = np.arange((nx + 1) * (ny + 1)).reshape(ny + 1, nx + 1)
            f1 = np.stack([ii[:-1, :-1], ii[1:, :-1], ii[:-1, 1:]], -1).reshape(-1, 3)
            f2 = np.stack([ii[1:, :-1], ii[1:, 1:], ii[:-1, 1:]], -1).reshape(-1, 3)
            all_verts.append(v.astype(np.float32))
            all_faces.append(np.concatenate([f1, f2]).astype(np.int32) + base)
            base += v.shape[0]
        verts = np.concatenate(all_verts)
        faces = np.concatenate(all_faces)

        with open(path, "wb") as f:
            f.write(
                (
                    "ply\nformat binary_little_endian 1.0\n"
                    f"element vertex {len(verts)}\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    f"element face {len(faces)}\n"
                    "property list uchar int vertex_indices\nend_header\n"
                ).encode("ascii")
            )
            f.write(verts.astype("<f4").tobytes())
            fdata = np.empty((len(faces),), dtype=np.dtype("u1,<i4,<i4,<i4"))
            fdata["f0"] = 3
            fdata["f1"], fdata["f2"], fdata["f3"] = faces[:, 0], faces[:, 1], faces[:, 2]
            f.write(fdata.tobytes())
        return path
