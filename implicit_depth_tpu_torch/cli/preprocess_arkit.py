"""ARKit capture preprocessing (counterpart of scripts/preprocess_arkit.py;
reference: datasets/arkit_dataset.py:425-649 process_data,
NeuralRecon-style). Host only: numpy and cv2, no model.

    python -m implicit_depth_tpu_torch.cli.preprocess_arkit --capture_dir raw/ \
        --output_dir scene_a/ [--size 640 480] [--frame_skip 1]

Reads a raw capture: Frames.m4v (the video), Frames.txt (a timestamp per
frame), ARposes.txt ("ts, tx, ty, tz, qw, qx, qy, qz" lines) and K.txt (the
intrinsics; an iPhone default at 1920x1440 without it). Writes the layout
data/arkit.py reads: images/<id>.jpg (resized to --size), poses/<id>.txt
(world_T_cam in OpenCV axes) and intrinsics/<id>.txt (scaled to --size),
for every --frame_skip-th frame with a pose within 50 ms. ARKit's camera
looks down -z with y up (OpenGL); the rotation is turned into OpenCV axes
with core/geometry.py::qvec2rotmat.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from implicit_depth_tpu_torch.core.geometry import qvec2rotmat

GL_TO_CV = np.diag([1.0, -1.0, -1.0])


def load_poses(path: str) -> list:
    """[(timestamp, 4x4 world_T_cam in OpenCV axes)] of an ARposes.txt."""
    poses = []
    with open(path) as f:
        for line in f:
            line = line.strip().replace(",", " ")
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            ts, t, q = vals[0], vals[1:4], vals[4:8]
            T = np.eye(4)
            T[:3, :3] = qvec2rotmat(q) @ GL_TO_CV
            T[:3, 3] = t
            poses.append((ts, T))
    return poses


def main(argv=None) -> int:
    import cv2

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--capture_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--size", type=int, nargs=2, default=(640, 480),
                   help="output frame width height")
    p.add_argument("--frame_skip", type=int, default=1)
    args = p.parse_args(argv)

    for sub in ("images", "poses", "intrinsics"):
        os.makedirs(os.path.join(args.output_dir, sub), exist_ok=True)

    poses = load_poses(os.path.join(args.capture_dir, "ARposes.txt"))
    with open(os.path.join(args.capture_dir, "Frames.txt")) as f:
        frame_ts = [float(line.strip().replace(",", " ").split()[0])
                    for line in f if line.strip() and not line.startswith("#")]

    k_path = os.path.join(args.capture_dir, "K.txt")
    if os.path.exists(k_path):
        K = np.genfromtxt(k_path)[:3, :3]
    else:  # iPhone default at 1920x1440
        K = np.array([[1600.0, 0, 960.0], [0, 1600.0, 720.0], [0, 0, 1.0]])

    cap = cv2.VideoCapture(os.path.join(args.capture_dir, "Frames.m4v"))
    ow, oh = args.size
    Ks = K.copy()
    Ks[0] *= ow / cap.get(cv2.CAP_PROP_FRAME_WIDTH)
    Ks[1] *= oh / cap.get(cv2.CAP_PROP_FRAME_HEIGHT)

    pose_ts = np.array([pose[0] for pose in poses])
    written = 0
    try:
        for i, ts in enumerate(frame_ts):
            ok, frame = cap.read()
            if not ok:
                break
            if i % args.frame_skip:
                continue
            j = int(np.argmin(np.abs(pose_ts - ts)))
            if abs(pose_ts[j] - ts) > 0.05:  # no pose close enough
                continue
            fid = f"{written:06d}"
            cv2.imwrite(os.path.join(args.output_dir, "images", f"{fid}.jpg"),
                        cv2.resize(frame, (ow, oh)))
            np.savetxt(os.path.join(args.output_dir, "poses", f"{fid}.txt"), poses[j][1])
            np.savetxt(os.path.join(args.output_dir, "intrinsics", f"{fid}.txt"), Ks)
            written += 1
    finally:
        cap.release()
    print(f"extracted {written} frames to {args.output_dir}")
    return written


if __name__ == "__main__":
    main()
