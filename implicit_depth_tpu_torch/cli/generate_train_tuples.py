"""Generates train-frame tuples (counterpart of
scripts/generate_train_tuples.py; reference:
data_scripts/generate_train_tuples.py). Host only: numpy, no model.

    python -m implicit_depth_tpu_torch.cli.generate_train_tuples \
        --data_config_file configs/data/scannet_default_train.yaml

Over every scan of the config's split file (or --single_debug_scan_id),
data/tuples.py::generate_train_tuples_for_scan with num_images_in_tuple
(else model_num_views) views; writes
{tuple_info_file_location}/{split}{mv_tuple_file_suffix}.
"""

from __future__ import annotations

from implicit_depth_tpu_torch.cli.generate_test_tuples import write_tuples
from implicit_depth_tpu_torch.config import parse_config
from implicit_depth_tpu_torch.data.tuples import generate_train_tuples_for_scan


def main(argv=None) -> str:
    cfg, _ = parse_config(argv)
    return write_tuples(cfg, lambda ds, scan, kf_cfg: generate_train_tuples_for_scan(
        ds, scan, num_views=cfg.num_images_in_tuple or cfg.model_num_views, config=kf_cfg))


if __name__ == "__main__":
    main()
