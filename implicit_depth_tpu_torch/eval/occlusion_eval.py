"""Dense occlusion (binary-depth) evaluation loop, counterpart of
implicit_depth_tpu/eval/occlusion_eval.py (the non-binary path).

The host loop feeds batches from the port's numpy BatchLoader,
runs `BDNet.forward_val`, scores all/surface/boundary IoU on the device and
averages per scene. `model_time` follows the reference protocol: forward
wall time per frame at steady state (the first batch, which builds the
kernel and warms cuDNN, is skipped), with a device synchronise on each
side of the forward.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import torch

from implicit_depth_tpu_torch.data.loader import BatchLoader
from implicit_depth_tpu_torch.eval import binary_metrics as bm
from implicit_depth_tpu_torch.eval.metrics import ResultsAverager
from implicit_depth_tpu_torch.models.blocks import resize_bilinear
from implicit_depth_tpu_torch.ops.fused_volume import fused_metadata_volume

Tensor = torch.Tensor


def make_forward_fn(net, sigmoid_multiplier: float = 1.0):
    """Model-only forward, the timed unit: (cur, src) -> sigmoid
    predictions (b, h0, w0, P) f32."""

    def fwd(cur_data: dict, src_data: dict) -> Tensor:
        out = net.forward_val(cur_data, src_data)
        return torch.sigmoid(sigmoid_multiplier * out["pred_0"].float())

    return fwd


def make_score_fn(thresholds: Optional[Sequence[float]] = None,
                  thresholder: Optional[bm.Thresholder] = None,
                  depth_planes: Sequence[float] = bm.DEFAULT_PLANES,
                  threshold_decimals: int = 1):
    """Scorer over a computed prediction: {key: (b,) tensor}."""

    def _resize(x_bhwd: Tensor, h: int, w: int) -> Tensor:
        return resize_bilinear(x_bhwd.permute(0, 3, 1, 2), h, w).permute(0, 2, 3, 1)

    def score(pred: Tensor, cur_data: dict) -> dict:
        gt = cur_data["depth"]  # (b, hd, wd, 1), NaN invalid
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate_scenes(
    net,
    datasets_by_scene: dict,
    output_dir: Optional[str] = None,
    batch_size: int = 4,
    name: str = "implicit_depth_tpu_torch",
    thresholds: Optional[Sequence[float]] = None,
    thresholder: Optional[bm.Thresholder] = None,
    max_batches_per_scene: Optional[int] = None,
    sigmoid_multiplier: float = 1.0,
    threshold_decimals: int = 1,
) -> dict:
    """Per-scene evaluation loop on the device that holds `net`.

    datasets_by_scene: {scene_id: dataset yielding (cur, src)}.
    Returns {"all_scene": ResultsAverager, "scenes": {id: averager},
    "model_time_ms", "step_time_ms" (forward + scoring + readback, per
    frame, first batch skipped), "forwards", "launches" (fused volume
    kernel launches during the loop), "nonfinite_preds"}.
    """
    device = next(net.parameters()).device
    fwd = make_forward_fn(net, sigmoid_multiplier)
    if thresholder is not None:
        thresholder = thresholder.to(device)
    score = make_score_fn(thresholds, thresholder, threshold_decimals=threshold_decimals)

    all_avg = ResultsAverager(name, "frame metrics")
    per_scene = {}
    fwd_time = step_time = 0.0
    fwd_frames = forwards = nonfinite = 0
    launches0 = fused_metadata_volume.launches
    first_batch = True
    with torch.inference_mode():
        for scene_id, ds in datasets_by_scene.items():
            scene_avg = ResultsAverager(name, f"scene {scene_id}")
            loader = BatchLoader(ds, batch_size, shuffle=False, num_workers=4,
                                 prefetch=2, drop_last=False, epochs=1)
            for bi, (cur, src) in enumerate(iter(loader)):
                if max_batches_per_scene is not None and bi >= max_batches_per_scene:
                    loader.stop()
                    break
                cur_t = {k: torch.as_tensor(v).to(device) for k, v in cur.items()
                         if k != "frame_id_string"}
                src_t = {k: torch.as_tensor(v).to(device) for k, v in src.items()
                         if k != "frame_id_string"}
                nb = cur_t["image"].shape[0]
                _sync(device)

                t0 = time.perf_counter()
                pred = fwd(cur_t, src_t)
                _sync(device)
                dt = time.perf_counter() - t0
                scores = score(pred, cur_t)
                keys = sorted(scores)
                arr = torch.stack([scores[k] for k in keys], dim=-1).cpu().numpy()  # (b, n)
                dt_step = time.perf_counter() - t0
                forwards += 1
                nonfinite += int((~torch.isfinite(pred)).sum())
                if not first_batch:
                    fwd_time += dt
                    step_time += dt_step
                    fwd_frames += nb
                first_batch = False

                for ei in range(nb):
                    elem = {k: arr[ei, i] for i, k in enumerate(keys)}
                    elem["model_time"] = dt / nb * 1000.0
                    scene_avg.update_results(elem)
                    all_avg.update_results(elem)

            scene_avg.compute_final_average(ignore_nans=True)
            per_scene[scene_id] = scene_avg
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
