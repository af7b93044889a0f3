"""Depth-regression evaluation loop, counterpart of the non-temporal branch of
scripts/test_reg.py: per-frame depth metrics of DepthNet's scale-0
prediction, optionally scored at native resolution (`high_res_validation`)
and as binary plane IoU (`regression_plane_eval`).

The host loop feeds batches from the port's numpy BatchLoader. `model_time`
follows the reference protocol: forward wall time per frame at steady state
(the first batch, which builds the kernels and warms cuDNN, is skipped),
with a device synchronise on each side of the forward.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from implicit_depth_tpu_torch.data.loader import BatchLoader
from implicit_depth_tpu_torch.eval import binary_metrics as bm
from implicit_depth_tpu_torch.eval.metrics import ResultsAverager, compute_depth_metrics_batched
from implicit_depth_tpu_torch.models.blocks import resize_bilinear

Tensor = torch.Tensor


def depth_frame_metrics(cur_data: dict, pred_bhw1: Tensor, high_res_validation: bool = False,
                        regression_plane_eval: bool = False) -> dict:
    """{metric: (b,) tensor} for a predicted depth (b, h, w, 1): the depth
    metrics over GT depths above 0.5 m (NaN invalid) and, with
    `regression_plane_eval`, the plane IoUs of (query < prediction)
    against cur_data["rendered_depth"]."""
    pred = pred_bhw1.float()
    if high_res_validation and "full_res_depth" in cur_data:
        gt = cur_data["full_res_depth"]
        pred = resize_bilinear(pred.permute(0, 3, 1, 2), gt.shape[1], gt.shape[2]).permute(0, 2, 3, 1)
    else:
        gt = cur_data["depth"]
    b = gt.shape[0]
    valid = torch.nan_to_num(gt, nan=0.0) > 0.5
    metrics = compute_depth_metrics_batched(torch.nan_to_num(gt, nan=1.0).reshape(b, -1),
                                            pred.reshape(b, -1), valid.reshape(b, -1))
    if regression_plane_eval:
        s = bm.regression_plane_scores(cur_data["rendered_depth"], gt, pred)
        metrics.update(bm.scores_to_dict(s))
    return metrics


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate_depth(net, datasets_by_scene: dict, batch_size: int = 4,
                   name: str = "implicit_depth_tpu_torch", high_res_validation: bool = False,
                   regression_plane_eval: bool = False,
                   max_batches_per_scene: Optional[int] = None) -> dict:
    """Evaluation loop on the device that holds `net` (a DepthNet in eval
    mode). datasets_by_scene: {scene_id: dataset yielding (cur, src)}.
    Returns {"all_scene": ResultsAverager over every frame, "model_time_ms",
    "forwards", "nonfinite_preds"}."""
    device = next(net.parameters()).device
    avg = ResultsAverager(name, "depth metrics")
    fwd_time = 0.0
    fwd_frames = forwards = nonfinite = 0
    with torch.inference_mode():
        for ds in datasets_by_scene.values():
            loader = BatchLoader(ds, batch_size, shuffle=False, num_workers=4, prefetch=2,
                                 drop_last=False, epochs=1)
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
                pred = net(cur_t, src_t)["depth_pred_0"]
                _sync(device)
                dt = time.perf_counter() - t0
                if forwards:
                    fwd_time += dt
                    fwd_frames += nb
                forwards += 1
                nonfinite += int((~torch.isfinite(pred)).sum())
                metrics = depth_frame_metrics(cur_t, pred, high_res_validation,
                                              regression_plane_eval)
                keys = sorted(metrics)
                arr = torch.stack([metrics[k] for k in keys], dim=-1).cpu().numpy()  # (b, n)
                for ei in range(nb):
                    avg.update_results({k: arr[ei, i] for i, k in enumerate(keys)})
    avg.compute_final_average(ignore_nans=True)
    return {"all_scene": avg, "model_time_ms": fwd_time / max(fwd_frames, 1) * 1000.0,
            "forwards": forwards, "nonfinite_preds": nonfinite}
