"""Depth-regression evaluation with the PyTorch port (counterpart of the
non-temporal branch of scripts/test_reg.py): per-frame depth metrics of
DepthNet, optionally at native resolution (--high_res_validation) and as
plane IoU of the regressed depth (--regression_plane_eval), and the model
time.

    python -m implicit_depth_tpu_torch.cli.test_reg \
        --config_file configs/models/regression_model.yaml \
        --data_config_file configs/data/scannet_default_test.yaml \
        --load_weights_from_checkpoint weights.pt [--device cuda]

The checkpoint is the port's state_dict (`torch.save`), e.g. from
implicit_depth_tpu_torch.weights.state_dict_from_flax, or a checkpoint of
cli/train.py. The device defaults to cuda; pass --device cpu to run the
plain versions of the kernels on the CPU. The averages go to
<output_base_path>/<name>/scores/depth_metrics.json. Temporal regression
eval (--temporal_eval) is not ported yet.
"""

from __future__ import annotations

import os

import torch

from implicit_depth_tpu_torch.config import parse_config
from implicit_depth_tpu_torch.data.registry import get_dataset
from implicit_depth_tpu_torch.eval.depth_eval import evaluate_depth
from implicit_depth_tpu_torch.train.loop import build_dataset, build_net
from implicit_depth_tpu_torch.weights import load_state_dict


def main(argv=None) -> dict:
    cfg, device = parse_config(argv)
    # f32 stays f32 (the JAX package's precision): no TF32 in convs or matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cfg.temporal_eval:
        raise SystemExit("temporal regression eval is not ported yet")
    if not cfg.load_weights_from_checkpoint:
        raise SystemExit("--load_weights_from_checkpoint is required")
    net = build_net(cfg, "regression")
    state = torch.load(cfg.load_weights_from_checkpoint, map_location="cpu", weights_only=True)
    load_state_dict(net, state.get("model", state))
    net = net.to(device).eval().cast_to_compute_dtype()

    _, scans = get_dataset(cfg.dataset, cfg.dataset_scan_split_file, cfg.single_debug_scan_id)
    kind = "bd" if cfg.regression_plane_eval else "regression"
    datasets = {scan: build_dataset(cfg, cfg.split, kind, limit_to_scan_id=scan)
                for scan in (scans or ["scene0"])}
    results = evaluate_depth(
        net, datasets, batch_size=cfg.val_batch_size, name=cfg.name,
        high_res_validation=cfg.high_res_validation,
        regression_plane_eval=cfg.regression_plane_eval,
        max_batches_per_scene=(None if cfg.max_frames is None
                               else -(-cfg.max_frames // max(cfg.val_batch_size, 1))))
    avg = results["all_scene"]
    avg.pretty_print_results(print_running_metrics=False)
    out_dir = os.path.join(cfg.output_base_path, cfg.name, "scores")
    os.makedirs(out_dir, exist_ok=True)
    avg.output_json(os.path.join(out_dir, "depth_metrics.json"))
    print(f"model_time: {results['model_time_ms']:.2f} ms/frame")
    return results


if __name__ == "__main__":
    main()
