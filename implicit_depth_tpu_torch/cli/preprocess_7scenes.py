"""7-Scenes preprocessing (counterpart of scripts/preprocess_7scenes.py;
reference: data_scripts/7scenes_preprocessing.py). Host only: numpy and
PIL, no model.

    python -m implicit_depth_tpu_torch.cli.preprocess_7scenes --dataset_path 7scenes/ \
        [--scenes chess fire]

Registers each raw Kinect depth frame (frame-XXXXXX.depth.png, mm, 65535
invalid) onto the RGB camera and writes frame-XXXXXX.depth.proj.png beside
it, skipping frames that have one. The Kinect's RGB and IR cameras are
offset; with the community-standard calibration (depth K: f=585,
c=(320, 240); RGB K: f=525, c=(320, 240); a 2.45 cm baseline along x) each
depth pixel is backprojected, moved into the RGB frame and splatted with a
z-buffer (the nearest point wins).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

K_DEPTH = np.array([[585.0, 0, 320.0], [0, 585.0, 240.0], [0, 0, 1.0]])
K_RGB = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1.0]])
# depth camera -> rgb camera (baseline along x)
RGB_T_DEPTH = np.eye(4)
RGB_T_DEPTH[0, 3] = -0.0245


def project_depth_to_rgb(depth_mm: np.ndarray) -> np.ndarray:
    """A (h, w) uint16 depth map in mm of the depth camera -> the same seen
    from the RGB camera (0 where no point lands)."""
    h, w = depth_mm.shape
    depth_m = depth_mm.astype(np.float64) / 1000.0
    valid = (depth_mm != 65535) & (depth_mm > 0)

    ys, xs = np.nonzero(valid)
    z = depth_m[ys, xs]
    pts = np.linalg.inv(K_DEPTH) @ np.stack([(xs + 0.5) * z, (ys + 0.5) * z, z])
    pts = RGB_T_DEPTH[:3, :3] @ pts + RGB_T_DEPTH[:3, 3:4]
    uvw = K_RGB @ pts
    u = np.round(uvw[0] / uvw[2] - 0.5).astype(int)
    v = np.round(uvw[1] / uvw[2] - 0.5).astype(int)
    zr = uvw[2]
    inb = (u >= 0) & (u < w) & (v >= 0) & (v < h) & (zr > 0)

    out = np.zeros((h, w), np.float64)
    # z-buffer splat: far to near, so that the nearer point is written last
    order = np.argsort(-zr[inb])
    uu, vv, zz = u[inb][order], v[inb][order], zr[inb][order]
    out[vv, uu] = zz
    return (out * 1000.0).astype(np.uint16)


def main(argv=None) -> dict:
    from PIL import Image

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset_path", required=True)
    p.add_argument("--scenes", nargs="*", default=None)
    args = p.parse_args(argv)

    scenes = args.scenes or sorted(
        d for d in os.listdir(args.dataset_path)
        if os.path.isdir(os.path.join(args.dataset_path, d)))
    written = {}
    for scene in scenes:
        sdir = os.path.join(args.dataset_path, scene)
        for seq in sorted(d for d in os.listdir(sdir) if d.startswith("seq-")):
            qdir = os.path.join(sdir, seq)
            n = 0
            for f in sorted(os.listdir(qdir)):
                if not f.endswith(".depth.png") or f.endswith(".depth.proj.png"):
                    continue
                out_path = os.path.join(qdir, f.replace(".depth.png", ".depth.proj.png"))
                if os.path.exists(out_path):
                    continue
                depth = np.asarray(Image.open(os.path.join(qdir, f)))
                Image.fromarray(project_depth_to_rgb(depth), mode="I;16").save(out_path)
                n += 1
            print(f"{scene}/{seq}: projected {n} depth maps")
            written[f"{scene}/{seq}"] = n
    return written


if __name__ == "__main__":
    main()
