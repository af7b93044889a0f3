"""Precomputes Hypersim planar depths from ray distances (counterpart of
scripts/generate_hypersim_planar_depths.py; reference:
data_scripts/generate_hypersim_planar_depths.py). Host only: numpy and
h5py, no model.

    python -m implicit_depth_tpu_torch.cli.generate_hypersim_planar_depths \
        --data_config_file configs/data/hypersim_default_train.yaml

For every valid frame of every scan of the config's split file (or
--single_debug_scan_id) that has none yet, writes
frame.XXXX.planar_depth_meters.hdf5 (f16, gzip 4) beside its distance file:
data/hypersim.py's depth from the distance file made planar through the
camera's ray matrix. h5py is imported when the tool runs.
"""

from __future__ import annotations

import os
from multiprocessing.pool import ThreadPool

import numpy as np

from implicit_depth_tpu_torch.config import parse_config
from implicit_depth_tpu_torch.data.hypersim import HypersimDataset
from implicit_depth_tpu_torch.data.registry import get_dataset


def main(argv=None) -> dict:
    import h5py

    cfg, _ = parse_config(argv)
    _, scans = get_dataset("hypersim", cfg.dataset_scan_split_file, cfg.single_debug_scan_id)
    ds = HypersimDataset(dataset_path=cfg.dataset_path, split=cfg.split)

    def run(scan):
        n = 0
        for line in ds.get_valid_frame_ids(scan):
            fid = line.split(" ")[1]
            scene, cam = os.path.split(scan)
            geo = os.path.join(ds.dataset_path, scene, "images", f"scene_{cam}_geometry_hdf5")
            out = os.path.join(geo, f"frame.{int(fid):04d}.planar_depth_meters.hdf5")
            if os.path.exists(out):
                continue
            depth = ds._depth_h5(scan, fid, planar=False)
            with h5py.File(out, "w") as f:
                f.create_dataset("dataset", data=depth.astype(np.float16),
                                 compression="gzip", compression_opts=4)
            n += 1
        print(f"{scan}: wrote {n} planar depth files")
        return n

    with ThreadPool(cfg.num_workers) as pool:
        return dict(zip(scans, pool.map(run, scans)))


if __name__ == "__main__":
    main()
