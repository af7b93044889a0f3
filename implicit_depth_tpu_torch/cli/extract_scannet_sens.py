"""Extracts ScanNet .sens archives into the layout data/scannet.py reads
(counterpart of scripts/extract_scannet_sens.py; reference:
data_scripts/scannet_wrangling_scripts/, which wraps ScanNet's SensorData
reader). Host only: numpy, zlib and PIL, no model.

    python -m implicit_depth_tpu_torch.cli.extract_scannet_sens \
        --scans_dir scans/ --output_dir scans_extracted/ [--frame_skip 1]

The .sens container (version 4, as the ScanNet release documents it):
  header: u32 version, u64 length + sensor name, four 4x4 f32 matrices
          (colour intrinsics and extrinsics, depth intrinsics and
          extrinsics), i32 colour and depth compression types, u32 colour
          width and height, u32 depth width and height, f32 depth shift and
          4 bytes of padding, u64 frame count;
  per frame: 4x4 f32 camera-to-world pose, u64 colour and depth
          timestamps, u64 colour and depth payload sizes, the JPEG colour
          bytes, the zlib-compressed uint16 depth bytes.

For every <scan>/<scan>.sens under --scans_dir writes <output_dir>/<scan>/:
sensor_data/frame-XXXXXX.{color.jpg, depth.png, pose.txt} (every
--frame_skip-th frame; the JPEG bytes as stored), <scan>.txt (the scan's
metadata) and intrinsic/intrinsic_{depth,color}.txt.
"""

from __future__ import annotations

import argparse
import os
import struct
import zlib

import numpy as np


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def extract_sens(sens_path: str, out_dir: str, frame_skip: int = 1,
                 export_color: bool = True, export_depth: bool = True,
                 export_pose: bool = True) -> int:
    """Extracts one .sens file into out_dir; returns the frames written."""
    from PIL import Image

    os.makedirs(os.path.join(out_dir, "sensor_data"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "intrinsic"), exist_ok=True)

    with open(sens_path, "rb") as f:
        version, = _read(f, "<I")
        if version != 4:
            raise ValueError(f"unsupported .sens version {version} in {sens_path}")
        strlen, = _read(f, "<Q")
        sensor_name = f.read(strlen).decode("ascii", "ignore")
        K_color = np.array(_read(f, "<16f")).reshape(4, 4)
        _read(f, "<16f")  # colour extrinsics
        K_depth = np.array(_read(f, "<16f")).reshape(4, 4)
        _read(f, "<16f")  # depth extrinsics
        _read(f, "<ii")  # colour and depth compression types
        color_w, color_h = _read(f, "<II")
        depth_w, depth_h = _read(f, "<II")
        _read(f, "<fI")  # depth shift, padding
        num_frames, = _read(f, "<Q")

        np.savetxt(os.path.join(out_dir, "intrinsic", "intrinsic_depth.txt"), K_depth)
        np.savetxt(os.path.join(out_dir, "intrinsic", "intrinsic_color.txt"), K_color)
        scan = os.path.basename(out_dir.rstrip("/"))
        with open(os.path.join(out_dir, f"{scan}.txt"), "w") as meta:
            meta.write(f"colorWidth = {color_w}\ncolorHeight = {color_h}\n")
            meta.write(f"depthWidth = {depth_w}\ndepthHeight = {depth_h}\n")
            meta.write(f"fx_depth = {K_depth[0, 0]}\nfy_depth = {K_depth[1, 1]}\n")
            meta.write(f"mx_depth = {K_depth[0, 2]}\nmy_depth = {K_depth[1, 2]}\n")
            meta.write(f"numColorFrames = {num_frames}\n")
            meta.write(f"numDepthFrames = {num_frames}\n")
            meta.write(f"sensorName = {sensor_name.strip()}\n")

        written = 0
        for i in range(num_frames):
            pose = np.array(_read(f, "<16f")).reshape(4, 4)
            _read(f, "<QQ")  # colour and depth timestamps
            color_size, depth_size = _read(f, "<QQ")
            color_bytes = f.read(color_size)
            depth_bytes = f.read(depth_size)
            if i % frame_skip:
                continue
            base = os.path.join(out_dir, "sensor_data", f"frame-{i:06d}")
            if export_pose:
                np.savetxt(base + ".pose.txt", pose)
            if export_color:
                with open(base + ".color.jpg", "wb") as cf:
                    cf.write(color_bytes)
            if export_depth:
                depth = np.frombuffer(zlib.decompress(depth_bytes), np.uint16)
                Image.fromarray(depth.reshape(depth_h, depth_w), mode="I;16").save(
                    base + ".depth.png")
            written += 1
        return written


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scans_dir", required=True, help="a directory of <scan>/<scan>.sens")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--frame_skip", type=int, default=1)
    args = p.parse_args(argv)

    scans = [d for d in sorted(os.listdir(args.scans_dir))
             if os.path.exists(os.path.join(args.scans_dir, d, f"{d}.sens"))]
    written = {}
    for scan in scans:
        written[scan] = extract_sens(os.path.join(args.scans_dir, scan, f"{scan}.sens"),
                                     os.path.join(args.output_dir, scan),
                                     frame_skip=args.frame_skip)
        print(f"{scan}: extracted {written[scan]} frames")
    return written


if __name__ == "__main__":
    main()
