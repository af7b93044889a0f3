"""Validation threshold sweep with the PyTorch port (counterpart of
scripts/validate_bd.py): scores the 8 fixed planes at 17 thresholds
0.1-0.9, each kept under its own 2-decimal key, and prints the best
threshold of each plane, to pick the per-plane test thresholds.

    python -m implicit_depth_tpu_torch.cli.validate_bd \
        --config_file configs/models/implicit_depth.yaml \
        --data_config_file configs/data/scannet_default_val.yaml \
        --load_weights_from_checkpoint weights.pt [--device cuda]

The checkpoint is loaded as cli/test_bd.py loads it.
The scores go to <output_base_path>/<name>/val_sweep/. The device defaults
to cuda; --device cpu runs the kernels' plain versions on the CPU.
"""

from __future__ import annotations

import os

import numpy as np

from implicit_depth_tpu_torch.cli.test_bd import load_bd_net
from implicit_depth_tpu_torch.config import parse_config
from implicit_depth_tpu_torch.data.registry import get_dataset
from implicit_depth_tpu_torch.eval.occlusion_eval import evaluate_scenes
from implicit_depth_tpu_torch.train.loop import build_dataset

THRESHOLDS = np.linspace(0.1, 0.9, 17)
PLANES = [1.5 + 0.5 * i for i in range(8)]


def main(argv=None) -> dict:
    """Runs the sweep; returns evaluate_scenes' result with
    "best_thresholds", the best threshold of each plane."""
    cfg, device = parse_config(argv)
    net = load_bd_net(cfg, device)
    _, scans = get_dataset(cfg.dataset, cfg.dataset_scan_split_file, cfg.single_debug_scan_id)
    datasets = {scan: build_dataset(cfg, cfg.split, limit_to_scan_id=scan)
                for scan in (scans or ["scene0"])}
    results = evaluate_scenes(net, datasets,
                              output_dir=os.path.join(cfg.output_base_path, cfg.name, "val_sweep"),
                              batch_size=cfg.val_batch_size, name=cfg.name,
                              thresholds=tuple(THRESHOLDS), threshold_decimals=2)
    metrics = results["all_scene"].final_metrics
    best = [max((metrics[f"iou_{t:.2f}_d_{d:.1f}"], t) for t in THRESHOLDS)[1] for d in PLANES]
    print("best per-plane thresholds:", [f"{b:.2f}" for b in best])
    results["best_thresholds"] = best
    return results


if __name__ == "__main__":
    main()
