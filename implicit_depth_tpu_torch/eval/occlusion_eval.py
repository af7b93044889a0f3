"""Dense occlusion (binary-depth) evaluation loop, counterpart of
implicit_depth_tpu/eval/occlusion_eval.py.

The host loop (depth_eval.timed_batches) feeds batches from the port's
numpy BatchLoader and runs the forward; this module scores on the device
and averages per scene. Two modes, as the JAX package's:
- occlusion IoU: `BDNet.forward_val` at the rendered query planes, then
  all/surface/boundary IoU per plane at the thresholder's per-bin
  thresholds, or at each swept threshold;
- depth from the binary oracle (`binary_eval_depth`):
  `BDNet.forward_infer_depth` (the bisection, at the thresholder's
  thresholds where one is given), scored with the depth metrics against
  the ground truth (NaN read as 1, valid where above 0.5).
`model_time` follows the reference protocol (depth_eval.py). With a
`cache_dir`, each frame's prediction is pickled under the key
`search_depths` or `pred_0` (utils/caching.py, the `--cache_depths` path).
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import torch

from implicit_depth_tpu_torch.eval import binary_metrics as bm
from implicit_depth_tpu_torch.eval.depth_eval import depth_frame_metrics, score_rows, timed_batches
from implicit_depth_tpu_torch.eval.metrics import ResultsAverager
from implicit_depth_tpu_torch.models.blocks import resize_bilinear
from implicit_depth_tpu_torch.ops.fused_volume import fused_metadata_volume
from implicit_depth_tpu_torch.utils.caching import cache_model_outputs

Tensor = torch.Tensor


def make_forward_fn(net, binary_eval_depth: bool = False,
                    thresholder: Optional[bm.Thresholder] = None,
                    sigmoid_multiplier: float = 1.0):
    """Model-only forward, the timed unit: (cur, src) -> f32 predictions,
    the sigmoid predictions (b, h0, w0, P), or with binary_eval_depth the
    bisection's depths (b, h0, w0, 1). The thresholder lies on the net's
    device. Every caller of forward_val takes its answer from here: the
    eval loop, apps/inference.py, the temporal driver, BD validation."""
    if binary_eval_depth:
        tb = None if thresholder is None else thresholder.bins
        tv = None if thresholder is None else thresholder.thresholds

        def fwd(cur_data: dict, src_data: dict) -> Tensor:
            out = net.forward_infer_depth(cur_data, src_data, threshold_bins=tb,
                                          threshold_values=tv)
            return out["search_depths"][..., None].float()

        return fwd

    def fwd(cur_data: dict, src_data: dict) -> Tensor:
        out = net.forward_val(cur_data, src_data)
        return torch.sigmoid(sigmoid_multiplier * out["pred_0"].float())

    return fwd


def make_score_fn(binary_eval_depth: bool = False,
                  thresholds: Optional[Sequence[float]] = None,
                  thresholder: Optional[bm.Thresholder] = None,
                  depth_planes: Sequence[float] = bm.DEFAULT_PLANES,
                  threshold_decimals: int = 1):
    """Scorer over a computed prediction: {key: (b,) tensor}."""

    def _resize(x_bhwd: Tensor, h: int, w: int) -> Tensor:
        return resize_bilinear(x_bhwd.permute(0, 3, 1, 2), h, w).permute(0, 2, 3, 1)

    def score(pred: Tensor, cur_data: dict) -> dict:
        gt = cur_data["depth"]  # (b, hd, wd, 1), NaN invalid
        if binary_eval_depth:
            if pred.shape[1:3] != gt.shape[1:3]:
                raise ValueError(f"depths at {tuple(pred.shape[1:3])} against ground truth at "
                                 f"{tuple(gt.shape[1:3])}: the scorer compares pixel by pixel")
            return depth_frame_metrics(cur_data, pred)
        query = cur_data["rendered_depth"]
        hd, wd = gt.shape[1], gt.shape[2]
        pred_r = pred
        if pred.shape[1] != hd:
            pred_r = _resize(pred, hd, wd)
            query = _resize(query, hd, wd)
        scores = {}
        if thresholder is not None:
            thr = thresholder.get_thresholds(query)
            surface = bm.get_surface_mask(gt, query)
            boundary = bm.get_boundary_mask(gt, query)
            for tag, extra in ((None, None), ("surface", surface), ("boundary", boundary)):
                s = bm.plane_scores(query, gt, pred_r, thr, extra_mask_bhwd=extra)
                scores.update(bm.scores_to_dict(s, None, depth_planes, tag=tag))
        else:
            for t in (thresholds or bm.DEFAULT_THRESHOLDS):
                s = bm.plane_scores(query, gt, pred_r, float(t))
                scores.update(bm.scores_to_dict(s, float(t), depth_planes,
                                                threshold_decimals=threshold_decimals))
        return scores

    return score


def evaluate_scenes(
    net,
    datasets_by_scene: dict,
    output_dir: Optional[str] = None,
    batch_size: int = 4,
    name: str = "implicit_depth_tpu_torch",
    thresholds: Optional[Sequence[float]] = None,
    thresholder: Optional[bm.Thresholder] = None,
    binary_eval_depth: bool = False,
    max_batches_per_scene: Optional[int] = None,
    cache_dir: Optional[str] = None,
    sigmoid_multiplier: float = 1.0,
    threshold_decimals: int = 1,
) -> dict:
    """Per-scene evaluation loop on the device that holds `net`.

    datasets_by_scene: {scene_id: dataset yielding (cur, src)}. With
    cache_dir, the predictions go to <cache_dir>/<scene_id>/<frame
    id>.pickle, keyed by the batch's frame_id_string where the dataset
    passes it.
    Returns {"all_scene": ResultsAverager, "scenes": {id: averager},
    "model_time_ms", "step_time_ms" (forward + scoring + readback, per
    frame, first batch skipped), "forwards", "launches" (fused volume
    kernel launches during the loop), "nonfinite_preds"}.
    """
    device = next(net.parameters()).device
    if thresholder is not None:
        thresholder = thresholder.to(device)
    fwd = make_forward_fn(net, binary_eval_depth, thresholder, sigmoid_multiplier)
    score = make_score_fn(binary_eval_depth, thresholds, thresholder,
                          threshold_decimals=threshold_decimals)

    all_avg = ResultsAverager(name, "frame metrics")
    per_scene = {s: ResultsAverager(name, f"scene {s}") for s in datasets_by_scene}
    fwd_time = step_time = 0.0
    fwd_frames = forwards = nonfinite = 0
    launches0 = fused_metadata_volume.launches
    with torch.inference_mode():
        for scene_id, bi, cur, cur_t, pred, dt in timed_batches(
                net, datasets_by_scene, batch_size, max_batches_per_scene, fwd):
            t1 = time.perf_counter()
            rows = score_rows(score(pred, cur_t))
            nb = len(rows)
            if forwards:
                fwd_time += dt
                step_time += dt + time.perf_counter() - t1
                fwd_frames += nb
            forwards += 1
            nonfinite += int((~torch.isfinite(pred)).sum())
            for elem in rows:
                elem["model_time"] = dt / nb * 1000.0
                per_scene[scene_id].update_results(elem)
                all_avg.update_results(elem)
            if cache_dir is not None:  # frames numbered where cur has no frame ids
                pred_key = "search_depths" if binary_eval_depth else "pred_0"
                cache_model_outputs(os.path.join(cache_dir, str(scene_id)),
                                    {pred_key: pred.cpu().numpy()}, cur, {}, bi, batch_size)

    for scene_id, scene_avg in per_scene.items():
        scene_avg.compute_final_average(ignore_nans=True)
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            scene_avg.output_json(os.path.join(output_dir, f"{scene_id}_metrics.json"))
    all_avg.compute_final_average(ignore_nans=True)
    if output_dir:
        all_avg.output_json(os.path.join(output_dir, "all_scenes_metrics.json"))
    return {
        "all_scene": all_avg,
        "scenes": per_scene,
        "model_time_ms": fwd_time / max(fwd_frames, 1) * 1000.0,
        "step_time_ms": step_time / max(fwd_frames, 1) * 1000.0,
        "forwards": forwards,
        "launches": fused_metadata_volume.launches - launches0,
        "nonfinite_preds": nonfinite,
    }
