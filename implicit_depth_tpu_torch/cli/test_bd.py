"""Occlusion evaluation with the PyTorch port (counterpart of
scripts/test_bd.py): per-scene 8-plane queries, per-plane thresholds,
all/surface/boundary IoU tables and the model time; with
--binary_eval_depth, depth from the binary oracle (the bisection of
BDNet.forward_infer_depth at the same thresholds) scored with the depth
metrics; with --cache_depths, each frame's prediction pickled under
<output_base_path>/<name>/depth_cache/<scene>/; or, with --temporal_eval,
the temporal (flicker) score over each scene's frames against its GT mesh
(eval/temporal_driver.py; --temporal_scan for the window loop). Single
process: --jax_distributed is refused.

    python -m implicit_depth_tpu_torch.cli.test_bd \
        --config_file configs/models/implicit_depth.yaml \
        --data_config_file configs/data/scannet_default_test.yaml \
        --load_weights_from_checkpoint weights.pt [--device cuda] \
        [--binary_eval_depth] [--cache_depths]
    python -m implicit_depth_tpu_torch.cli.test_bd --temporal_eval \
        --config_file configs/models/implicit_depth_temporal.yaml \
        --data_config_file configs/data/synthetic_temporal.yaml \
        --load_weights_from_checkpoint weights.pt

The checkpoint is the port's state_dict (`torch.save`), e.g. from
implicit_depth_tpu_torch.weights.state_dict_from_flax. The device defaults
to cuda; pass --device cpu to run the plain version of the kernel on the
CPU.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from implicit_depth_tpu_torch.config import parse_config
from implicit_depth_tpu_torch.data.registry import get_dataset
from implicit_depth_tpu_torch.eval import binary_metrics as bm
from implicit_depth_tpu_torch.eval.occlusion_eval import evaluate_scenes
from implicit_depth_tpu_torch.models.bd_net import TRAIN_ONLY_PREFIXES
from implicit_depth_tpu_torch.train.loop import build_dataset, build_net
from implicit_depth_tpu_torch.weights import load_state_dict


def load_bd_net(cfg, device: str):
    """The config's BDNet with the port state_dict of
    --load_weights_from_checkpoint (the training-only query heads may be
    missing), on `device`, in eval mode at the compute dtype."""
    # f32 stays f32 (the JAX package's precision): no TF32 in convs or matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not cfg.load_weights_from_checkpoint:
        raise SystemExit("--load_weights_from_checkpoint is required")
    net = build_net(cfg)
    state = torch.load(cfg.load_weights_from_checkpoint, map_location="cpu", weights_only=True)
    load_state_dict(net, state, optional_prefixes=TRAIN_ONLY_PREFIXES)
    return net.to(device).eval().cast_to_compute_dtype()


def main(argv=None) -> dict:
    cfg, device = parse_config(argv)
    if cfg.jax_distributed:
        raise NotImplementedError("--jax_distributed is not ported: test_bd evaluates in one "
                                  "process")
    net = load_bd_net(cfg, device)
    ds_cls, scans = get_dataset(cfg.dataset, cfg.dataset_scan_split_file,
                                cfg.single_debug_scan_id)
    datasets = {scan: build_dataset(cfg, cfg.split, limit_to_scan_id=scan, pass_frame_id=True)
                for scan in (scans or ["scene0"])}
    if cfg.temporal_eval:
        return run_temporal(cfg, net, datasets, ds_cls)

    planes = np.linspace(1.5, 5.0, 8, dtype=np.float32)
    thr = [0.5, 0.4] + [0.3] * 6 if cfg.use_validation_thresholds else [0.5] * 8
    results = evaluate_scenes(
        net, datasets,
        output_dir=os.path.join(cfg.output_base_path, cfg.name, "scores"),
        batch_size=cfg.val_batch_size, name=cfg.name,
        thresholder=bm.Thresholder(planes, np.asarray(thr, np.float32)),
        binary_eval_depth=cfg.binary_eval_depth,
        max_batches_per_scene=(None if cfg.max_frames is None
                               else -(-cfg.max_frames // max(cfg.val_batch_size, 1))),
        cache_dir=(os.path.join(cfg.output_base_path, cfg.name, "depth_cache")
                   if cfg.cache_depths else None),
        sigmoid_multiplier=cfg.bd_sigmoid_multiplier,
    )
    avg = results["all_scene"]
    avg.pretty_print_results(print_running_metrics=False)
    if not cfg.binary_eval_depth:
        for metric in ("iou", "surface_iou", "boundary_iou"):
            avg.pretty_print_metric_table(metric_name=metric, single_iou=True,
                                          depths=[1.5 + 0.5 * i for i in range(8)],
                                          print_running_metrics=False)
    print(f"model_time: {results['model_time_ms']:.2f} ms/frame")
    return results


def run_temporal(cfg, net, datasets: dict, ds_cls, regression: bool = False) -> dict:
    """The temporal score of `net` over `datasets`, the meshes from
    ds_cls.get_gt_mesh_path; prints it with the flips, vertices and rate."""
    from implicit_depth_tpu_torch.eval.temporal_driver import evaluate_temporal

    meshes = {scan: ds_cls.get_gt_mesh_path(cfg.dataset_path, cfg.split, scan)
              for scan in datasets}
    result = evaluate_temporal(
        net, datasets, meshes, eval_length=cfg.eval_length, warmup=cfg.warmup,
        frame_multiplier=cfg.eval_frame_multiplier,
        sigmoid_multiplier=cfg.bd_sigmoid_multiplier, height=cfg.depth_height,
        width=cfg.depth_width, max_frames_per_scene=cfg.max_frames, regression=regression,
        use_scan=cfg.temporal_scan)
    ft = ", ".join(f"{t:.3f}" for t in result["frame_times"])
    print(f"temporal_score: {result['temporal_score']:.4f} "
          f"({result['total_diffs']:.0f} flips / {result['total_verts']} verts), "
          f"{result['frames_per_sec']:.2f} frames/s (median) over {result['n_frames']} frames "
          f"[{ft}]")
    return result


if __name__ == "__main__":
    main()
