"""Generates test-frame tuples (counterpart of
scripts/generate_test_tuples.py; reference:
data_scripts/generate_test_tuples.py). Host only: numpy, no model.

    python -m implicit_depth_tpu_torch.cli.generate_test_tuples \
        --data_config_file configs/data/scannet_default_test.yaml [--frame_tuple_type dense]

Over every scan of the config's split file (or --single_debug_scan_id),
data/tuples.py::generate_test_tuples_for_scan with the config's
frame_tuple_type and num_images_in_tuple (else model_num_views), the
Hypersim keyframe thresholds for hypersim; writes
{tuple_info_file_location}/{split}{mv_tuple_file_suffix}, a line per tuple.
"""

from __future__ import annotations

import os
from multiprocessing.pool import ThreadPool

from implicit_depth_tpu_torch.config import parse_config
from implicit_depth_tpu_torch.data.keyframes import DVMVSConfig, DVMVSHypersimConfig
from implicit_depth_tpu_torch.data.registry import get_dataset
from implicit_depth_tpu_torch.data.tuples import generate_test_tuples_for_scan


def write_tuples(cfg, lines_of_scan) -> str:
    """Runs lines_of_scan(ds, scan, kf_cfg) over the config's scans on
    cfg.num_workers threads and writes the lines, in scan order, to
    {tuple_info_file_location}/{split}{mv_tuple_file_suffix}."""
    cls, scans = get_dataset(cfg.dataset, cfg.dataset_scan_split_file, cfg.single_debug_scan_id)
    ds = cls(dataset_path=cfg.dataset_path, split=cfg.split, mv_tuple_file_suffix=None,
             image_height=cfg.image_height, image_width=cfg.image_width)
    kf_cfg = DVMVSHypersimConfig if cfg.dataset == "hypersim" else DVMVSConfig

    def run(scan):
        lines = lines_of_scan(ds, scan, kf_cfg)
        print(f"{scan}: {len(lines)} tuples")
        return lines

    with ThreadPool(cfg.num_workers) as pool:
        all_lines = [line for lines in pool.map(run, scans) for line in lines]
    out = os.path.join(cfg.tuple_info_file_location, f"{cfg.split}{cfg.mv_tuple_file_suffix}")
    os.makedirs(cfg.tuple_info_file_location, exist_ok=True)
    with open(out, "w") as f:
        f.write("\n".join(all_lines) + "\n")
    print(f"wrote {len(all_lines)} tuples to {out}")
    return out


def main(argv=None) -> str:
    cfg, _ = parse_config(argv)
    return write_tuples(cfg, lambda ds, scan, kf_cfg: generate_test_tuples_for_scan(
        ds, scan, cfg.frame_tuple_type, num_views=cfg.num_images_in_tuple or cfg.model_num_views,
        config=kf_cfg))


if __name__ == "__main__":
    main()
