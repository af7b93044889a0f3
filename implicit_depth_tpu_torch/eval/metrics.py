"""Depth metrics and results averaging with reference-compatible JSON
output. Counterpart of implicit_depth_tpu/eval/metrics.py:
`compute_depth_metrics_batched` runs on the device with NaN-masked means
(torch.nanmean, NaN of an empty row like the reference); ResultsAverager is
host-side numpy."""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor


def compute_depth_metrics_batched(gt_bN: Tensor, pred_bN: Tensor, valid_bN: Tensor,
                                  mult_a: bool = False) -> dict:
    """Per-element depth metrics over the valid entries of each row:
    {abs_diff, abs_rel, sq_rel, rmse, rmse_log, a5, a10, a25, a0..a3}, each
    (b,)."""
    nan = torch.tensor(float("nan"), dtype=gt_bN.dtype, device=gt_bN.device)
    gt = torch.where(valid_bN, gt_bN, nan)
    pred = torch.where(valid_bN, pred_bN, nan)
    thresh = torch.maximum(gt / pred, pred / gt)

    def a_metric(limit):
        m = torch.nanmean(torch.where(valid_bN, (thresh < limit).to(gt.dtype), nan), dim=1)
        return m * 100.0 if mult_a else m

    return {
        "abs_diff": torch.nanmean(torch.abs(gt - pred), dim=1),
        "abs_rel": torch.nanmean(torch.abs(gt - pred) / gt, dim=1),
        "sq_rel": torch.nanmean((gt - pred) ** 2 / gt, dim=1),
        "rmse": torch.sqrt(torch.nanmean((gt - pred) ** 2, dim=1)),
        "rmse_log": torch.sqrt(torch.nanmean((torch.log(gt) - torch.log(pred)) ** 2, dim=1)),
        "a5": a_metric(1.05),
        "a10": a_metric(1.10),
        "a25": a_metric(1.25),
        "a0": a_metric(1.10),
        "a1": a_metric(1.25),
        "a2": a_metric(1.25 ** 2),
        "a3": a_metric(1.25 ** 3),
    }


class ResultsAverager:
    """Running and final averages of per-frame metric dicts."""

    def __init__(self, exp_name: str, metrics_name: str):
        self.exp_name = exp_name
        self.metrics_name = metrics_name
        self.elem_metrics_list: list[dict] = []
        self.running_metrics: Optional[dict] = None
        self.running_count = 0
        self.final_metrics: Optional[dict] = None

    def update_results(self, elem_metrics: dict) -> None:
        elem = {k: float(np.asarray(v)) for k, v in elem_metrics.items()}
        self.elem_metrics_list.append(dict(elem))
        if self.running_metrics is None:
            self.running_metrics = dict(elem)
        else:
            for k, v in elem.items():
                self.running_metrics[k] = (
                    self.running_metrics[k] * self.running_count + v
                ) / (self.running_count + 1)
        self.running_count += 1

    def compute_final_average(self, ignore_nans: bool = False) -> None:
        self.final_metrics = {}
        if not self.elem_metrics_list:
            return
        for key in self.running_metrics:
            values = np.array([e[key] for e in self.elem_metrics_list])
            self.final_metrics[key] = float(np.nanmean(values) if ignore_nans else values.mean())

    def _metrics(self, running: bool) -> dict:
        return self.running_metrics if running else self.final_metrics

    def output_json(self, filepath: str, print_running_metrics: bool = False) -> None:
        metrics = self._metrics(print_running_metrics) or {}
        out = {
            "exp_name": self.exp_name,
            "metrics_type": self.metrics_name,
            "scores": {k: float(v) for k, v in metrics.items()},
            "metrics_string": "".join(f"{k:8} " for k in metrics),
            "scores_string": "".join(f"{v:.4f},".ljust(8) + " " for v in metrics.values()),
        }
        with open(filepath, "w") as f:
            json.dump(out, f, indent=4)

    def from_json(self, filepath: str) -> None:
        """Loads the final metrics of an output_json file (the multi-process
        merge of cli/test_bd.py reads each scene's)."""
        with open(filepath) as f:
            d = json.load(f)
        self.exp_name = d["exp_name"]
        self.metrics_name = d["metrics_type"]
        self.final_metrics = {k: float(v) for k, v in d["scores"].items()}
        self.elem_metrics_list = [dict(self.final_metrics)]

    def pretty_print_results(self, print_exp_name: bool = True,
                             print_running_metrics: bool = True) -> None:
        metrics = self._metrics(print_running_metrics)
        if not metrics:
            print("WARNING: No valid metrics to print.")
            return
        if print_exp_name:
            print(f"{self.exp_name}, {self.metrics_name}")
        for k, v in metrics.items():
            print(f"{k:8}: {v:.4f}")

    def print_sheets_friendly(self, print_exp_name: bool = True,
                              include_metrics_names: bool = False,
                              print_running_metrics: bool = True) -> None:
        """The metrics as one comma-separated row of values (under a row of
        their names with `include_metrics_names`), for pasting into a
        spreadsheet."""
        metrics = self._metrics(print_running_metrics)
        if not metrics:
            print("WARNING: No valid metrics to print.")
            return
        if print_exp_name:
            print(f"{self.exp_name}, {self.metrics_name}")
        if include_metrics_names:
            print("".join(f"{k:8} " for k in metrics))
        print("".join(f"{v:.4f},".ljust(8) + " " for v in metrics.values()))

    def pretty_print_metric_table(self, metric_name: str = "iou",
                                  thresholds=np.linspace(0.3, 0.7, 5),
                                  depths=(1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 4.5),
                                  single_iou: bool = False,
                                  print_running_metrics: bool = True) -> None:
        metrics = self._metrics(print_running_metrics)
        if not metrics:
            print("WARNING: No valid metrics to print.")
            return
        print(f"{self.exp_name}, {self.metrics_name}")
        if single_iou:
            rows = [[metrics[f"{metric_name}_d_{d:.1f}"] for d in depths]]
            index = [metric_name]
        else:
            rows = [[metrics[f"{metric_name}_{t:.1f}_d_{d:.1f}"] for d in depths]
                    for t in thresholds]
            arr = np.array(rows)
            rows.append(list(arr.max(0)))
            rows.append(list(np.asarray(thresholds)[arr.argmax(0)]))
            index = [f"{metric_name} {t}" for t in thresholds] + ["best_iou", "best_thresh"]
        print(" " * 16 + " ".join(f"{d}m".rjust(9) for d in depths))
        for name, row in zip(index, rows):
            print(f"{name:16}" + " ".join(f"{v:9.4f}" for v in row))
