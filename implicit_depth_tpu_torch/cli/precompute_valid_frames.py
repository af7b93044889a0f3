"""Precomputes each scan's valid frames (counterpart of
scripts/precompute_valid_frames.py; reference:
data_scripts/precompute_valid_frames.py). Host only: numpy, no model.

    python -m implicit_depth_tpu_torch.cli.precompute_valid_frames \
        --data_config_file configs/data/scannet_default_train.yaml

Over every scan of the config's split file (or --single_debug_scan_id), the
dataset's get_valid_frame_ids(scan, store_computed=True), which writes the
scan's valid-frames file where the dataset keeps it.
"""

from __future__ import annotations

from multiprocessing.pool import ThreadPool

from implicit_depth_tpu_torch.config import parse_config
from implicit_depth_tpu_torch.data.registry import get_dataset


def main(argv=None) -> dict:
    cfg, _ = parse_config(argv)
    cls, scans = get_dataset(cfg.dataset, cfg.dataset_scan_split_file, cfg.single_debug_scan_id)
    ds = cls(dataset_path=cfg.dataset_path, split=cfg.split, mv_tuple_file_suffix=None,
             image_height=cfg.image_height, image_width=cfg.image_width)

    def run(scan):
        valid = ds.get_valid_frame_ids(scan, store_computed=True)
        print(f"{scan}: {len(valid)} valid frames")
        return len(valid)

    with ThreadPool(cfg.num_workers) as pool:
        return dict(zip(scans, pool.map(run, scans)))


if __name__ == "__main__":
    main()
