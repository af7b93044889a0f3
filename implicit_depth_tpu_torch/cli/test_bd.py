"""Occlusion evaluation with the PyTorch port (counterpart of
scripts/test_bd.py): per-scene 8-plane queries, per-plane thresholds,
all/surface/boundary IoU tables and the model time; with
--binary_eval_depth, depth from the binary oracle (the bisection of
BDNet.forward_infer_depth at the same thresholds) scored with the depth
metrics; with --cache_depths, each frame's prediction pickled under
<output_base_path>/<name>/depth_cache/<scene>/; or, with --temporal_eval,
the temporal (flicker) score over each scene's frames against its GT mesh
(eval/temporal_driver.py; --temporal_scan for the window loop).

    python -m implicit_depth_tpu_torch.cli.test_bd \
        --config_file configs/models/implicit_depth.yaml \
        --data_config_file configs/data/scannet_default_test.yaml \
        --load_weights_from_checkpoint weights.pt [--device cuda] \
        [--binary_eval_depth] [--cache_depths]
    python -m implicit_depth_tpu_torch.cli.test_bd --temporal_eval \
        --config_file configs/models/implicit_depth_temporal.yaml \
        --data_config_file configs/data/synthetic_temporal.yaml \
        --load_weights_from_checkpoint weights.pt

The checkpoint is a port state_dict (`torch.save`, e.g. from
implicit_depth_tpu_torch.weights.state_dict_from_flax or
cli/convert_checkpoint.py), a checkpoint directory of cli/train_bd.py, or
its `{model, ...}` file. The device defaults to cuda; pass --device cpu to
run the plain version of the kernel on the CPU.

Over N processes (as scripts/test_bd.py): start the same command N times
with --jax_distributed --coordinator_address HOST:PORT
--distributed_num_processes N --distributed_process_id r. Rank r evaluates
the scenes [r::N] of the split on cuda:{r % device_count} and writes their
{scan}_metrics.json; after a barrier rank 0 averages exactly this split's
scene files into all_scenes_metrics.json (scene-averaged). With
--temporal_eval each rank writes its flips and scene count to
<output_base_path>/<name>/temporal/rank{r}.json, and after a barrier rank
0 prints the global score with the reference's normalisation,
flips / ((eval_length - warmup) * eval_frame_multiplier * scenes).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from implicit_depth_tpu_torch.config import parse_config
from implicit_depth_tpu_torch.data.registry import get_dataset
from implicit_depth_tpu_torch.eval import binary_metrics as bm
from implicit_depth_tpu_torch.eval.metrics import ResultsAverager
from implicit_depth_tpu_torch.eval.occlusion_eval import evaluate_scenes
from implicit_depth_tpu_torch.models.bd_net import TRAIN_ONLY_PREFIXES
from implicit_depth_tpu_torch.parallel import distributed
from implicit_depth_tpu_torch.train.checkpoint import load_weights
from implicit_depth_tpu_torch.train.loop import build_dataset, build_net
from implicit_depth_tpu_torch.weights import load_state_dict


def load_bd_net(cfg, device: str):
    """The config's BDNet with the weights of --load_weights_from_checkpoint
    (checkpoint.load_weights; the training-only query heads may be
    missing), on `device`, in eval mode at the compute dtype."""
    # f32 stays f32 (the JAX package's precision): no TF32 in convs or matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not cfg.load_weights_from_checkpoint:
        raise SystemExit("--load_weights_from_checkpoint is required")
    net = build_net(cfg)
    load_state_dict(net, load_weights(cfg.load_weights_from_checkpoint),
                    optional_prefixes=TRAIN_ONLY_PREFIXES)
    return net.to(device).eval().cast_to_compute_dtype()


def main(argv=None) -> dict:
    cfg, device = parse_config(argv)
    if not cfg.jax_distributed:
        return evaluate(cfg, device)
    distributed.initialize(cfg.coordinator_address, cfg.distributed_num_processes,
                           cfg.distributed_process_id, device=device)
    try:
        return evaluate(cfg, str(distributed.local_device(device)))
    finally:
        distributed.shutdown()


def evaluate(cfg, device: str) -> dict:
    """The evaluation of main, on this rank's share of the scenes."""
    pid, pcount = distributed.process_info()
    net = load_bd_net(cfg, device)
    ds_cls, scans = get_dataset(cfg.dataset, cfg.dataset_scan_split_file,
                                cfg.single_debug_scan_id)
    all_scans = list(scans or ["scene0"])  # the whole split, for rank 0's merge
    datasets = {scan: build_dataset(cfg, cfg.split, limit_to_scan_id=scan, pass_frame_id=True)
                for scan in all_scans[pid::pcount]}
    if cfg.temporal_eval:
        result = run_temporal(cfg, net, datasets, ds_cls)
        if pcount > 1:
            merge_temporal(cfg, result, len(datasets))
        return result

    planes = np.linspace(1.5, 5.0, 8, dtype=np.float32)
    thr = [0.5, 0.4] + [0.3] * 6 if cfg.use_validation_thresholds else [0.5] * 8
    out_dir = os.path.join(cfg.output_base_path, cfg.name, "scores")
    results = evaluate_scenes(
        net, datasets,
        output_dir=out_dir,
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
    if pcount > 1:
        # a barrier on the host (ranks finish their scenes minutes apart),
        # then rank 0 averages exactly this split's scene files: a glob
        # would also take stale files of earlier runs in the same directory
        distributed.barrier("test_bd_scenes_done")
        if pid != 0:
            return results
        avg = merge_scene_metrics(cfg.name, out_dir, all_scans)
        results["all_scene"] = avg
    avg.pretty_print_results(print_running_metrics=False)
    if not cfg.binary_eval_depth:
        for metric in ("iou", "surface_iou", "boundary_iou"):
            avg.pretty_print_metric_table(metric_name=metric, single_iou=True,
                                          depths=[1.5 + 0.5 * i for i in range(8)],
                                          print_running_metrics=False)
    print(f"model_time: {results['model_time_ms']:.2f} ms/frame")
    return results


def merge_scene_metrics(name: str, out_dir: str, scans) -> ResultsAverager:
    """The average of the scenes' {scan}_metrics.json (each scene counts
    once), written to out_dir/all_scenes_metrics.json."""
    avg = ResultsAverager(name, "scene-averaged metrics (multi-process merge)")
    for scan in sorted(scans):
        scene = ResultsAverager(name, "scene")
        scene.from_json(os.path.join(out_dir, f"{scan}_metrics.json"))
        avg.update_results(scene.final_metrics)
    avg.compute_final_average(ignore_nans=True)
    avg.output_json(os.path.join(out_dir, "all_scenes_metrics.json"))
    return avg


def merge_temporal(cfg, result: dict, n_scenes: int) -> None:
    """Writes this rank's flips and scene count; after a barrier, rank 0
    adds every rank's and stores and prints the global temporal score
    (result["global_temporal_score"])."""
    pid, pcount = distributed.process_info()
    tdir = os.path.join(cfg.output_base_path, cfg.name, "temporal")
    os.makedirs(tdir, exist_ok=True)
    with open(os.path.join(tdir, f"rank{pid}.json"), "w") as f:
        json.dump({"total_diffs": result["total_diffs"], "n_scenes": n_scenes}, f)
    distributed.barrier("temporal_scenes_done")
    if pid != 0:
        return
    diffs = scenes = 0.0
    for r in range(pcount):
        with open(os.path.join(tdir, f"rank{r}.json")) as f:
            d = json.load(f)
        diffs += d["total_diffs"]
        scenes += d["n_scenes"]
    denom = (cfg.eval_length - cfg.warmup) * cfg.eval_frame_multiplier * scenes
    result["global_temporal_score"] = diffs / max(denom, 1)
    print(f"global temporal_score: {result['global_temporal_score']:.4f} over {int(scenes)} "
          f"scenes / {pcount} processes")


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
