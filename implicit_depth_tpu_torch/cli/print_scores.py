"""Reloads a scores JSON (an output of eval/metrics.py::ResultsAverager,
e.g. <output_base_path>/<name>/scores/all_scenes_metrics.json) and prints
its metrics and its per-plane table (counterpart of scripts/print_scores.py;
reference: utils/print_scores.py). Host only.

    python -m implicit_depth_tpu_torch.cli.print_scores scores.json [--metric iou]

The table is the single-threshold one; the JAX script's --single_iou flag,
which could only be on, is not taken.
"""

from __future__ import annotations

import argparse

from implicit_depth_tpu_torch.eval.metrics import ResultsAverager


def main(argv=None) -> ResultsAverager:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("json_path")
    p.add_argument("--metric", default="iou")
    args = p.parse_args(argv)
    ra = ResultsAverager("scores", "reloaded")
    ra.from_json(args.json_path)
    ra.pretty_print_results(print_running_metrics=False)
    try:
        ra.pretty_print_metric_table(
            metric_name=args.metric, single_iou=True,
            depths=[1.5 + 0.5 * i for i in range(8)], print_running_metrics=False)
    except KeyError:  # a depth-metrics file has no per-plane table
        pass
    return ra


if __name__ == "__main__":
    main()
