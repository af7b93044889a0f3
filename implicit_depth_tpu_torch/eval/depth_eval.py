"""Depth-regression evaluation loop, counterpart of the non-temporal branch of
scripts/test_reg.py: per-frame depth metrics of DepthNet's scale-0
prediction, optionally scored at native resolution (`high_res_validation`)
and as binary plane IoU (`regression_plane_eval`).

Its batch loop, `timed_batches`, and the readback of per-element scores,
`score_rows`, are also occlusion_eval.evaluate_scenes'. Both loops'
`model_time` follows the reference protocol: forward wall time per frame at
steady state (the first batch, which builds the kernels and warms cuDNN, is
skipped), with the device drained on each side of the forward.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator, Optional

import torch

from implicit_depth_tpu_torch.data.loader import BatchLoader
from implicit_depth_tpu_torch.eval import binary_metrics as bm
from implicit_depth_tpu_torch.eval.metrics import ResultsAverager, compute_depth_metrics_batched
from implicit_depth_tpu_torch.models.blocks import resize_bilinear
from implicit_depth_tpu_torch.utils.device import batch_to_device
from implicit_depth_tpu_torch.utils.profiling import force_sync

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


def timed_batches(net, datasets_by_scene: dict, batch_size: int,
                  max_batches_per_scene: Optional[int], fwd: Callable) -> Iterator[tuple]:
    """(scene_id, batch index, host cur, device cur, fwd(cur, src), the
    forward's seconds) per batch of each scene's dataset, in order, cut at
    max_batches_per_scene: each batch uploaded with batch_to_device to the
    device that holds `net`, the forward timed with the device drained on
    each side, under the caller's grad mode."""
    device = next(net.parameters()).device
    for scene_id, ds in datasets_by_scene.items():
        loader = BatchLoader(ds, batch_size, shuffle=False, num_workers=4, prefetch=2,
                             drop_last=False, epochs=1)
        for bi, batch in enumerate(iter(loader)):
            if max_batches_per_scene is not None and bi >= max_batches_per_scene:
                loader.stop()
                break
            up = batch_to_device(batch, device)
            force_sync(up)
            t0 = time.perf_counter()
            pred = fwd(*up)
            force_sync(pred)
            yield scene_id, bi, batch[0], up[0], pred, time.perf_counter() - t0


def score_rows(scores: dict) -> list[dict]:
    """{key: (b,) tensor} on the device as b {key: host scalar} dicts, read
    back in one copy."""
    keys = sorted(scores)
    arr = torch.stack([scores[k] for k in keys], dim=-1).cpu().numpy()  # (b, n)
    return [dict(zip(keys, row)) for row in arr]


def evaluate_depth(net, datasets_by_scene: dict, batch_size: int = 4,
                   name: str = "implicit_depth_tpu_torch", high_res_validation: bool = False,
                   regression_plane_eval: bool = False,
                   max_batches_per_scene: Optional[int] = None) -> dict:
    """Evaluation loop on the device that holds `net` (a DepthNet in eval
    mode). datasets_by_scene: {scene_id: dataset yielding (cur, src)}.
    Returns {"all_scene": ResultsAverager over every frame, "model_time_ms",
    "forwards", "nonfinite_preds"}."""
    avg = ResultsAverager(name, "depth metrics")
    fwd_time = 0.0
    fwd_frames = forwards = nonfinite = 0
    with torch.inference_mode():
        for _, _, _, cur_t, pred, dt in timed_batches(
                net, datasets_by_scene, batch_size, max_batches_per_scene,
                lambda cur, src: net(cur, src)["depth_pred_0"]):
            rows = score_rows(depth_frame_metrics(cur_t, pred, high_res_validation,
                                                  regression_plane_eval))
            if forwards:
                fwd_time += dt
                fwd_frames += len(rows)
            forwards += 1
            nonfinite += int((~torch.isfinite(pred)).sum())
            for row in rows:
                avg.update_results(row)
    avg.compute_final_average(ignore_nans=True)
    return {"all_scene": avg, "model_time_ms": fwd_time / max(fwd_frames, 1) * 1000.0,
            "forwards": forwards, "nonfinite_preds": nonfinite}
