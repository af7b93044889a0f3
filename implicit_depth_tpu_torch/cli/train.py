"""Depth-regression training with the PyTorch port (counterpart of
scripts/train.py), single process on one device; `run` is shared with
cli/train_bd.py.

    python -m implicit_depth_tpu_torch.cli.train \
        --config_file configs/models/regression_model.yaml \
        --data_config_file configs/data/scannet_default_train.yaml \
        [--device cuda] [--max_steps N] [--load_weights_from_checkpoint weights.pt]

The device defaults to cuda (the CUDA kernels); --device cpu runs their
plain versions on the CPU. Checkpoints ({model, optimizer, step}) go to
<log_dir>/<name>/checkpoints at every validation and at the end; scalars
are printed one JSON object per line.
"""

from __future__ import annotations

import json

import torch

from implicit_depth_tpu_torch.config import parse_config
from implicit_depth_tpu_torch.train.loop import fit


def run(argv, kind: str) -> dict:
    """Parses the command line and trains the model of `kind` ("bd" or
    "regression"), printing the scalars."""
    cfg, device = parse_config(argv)
    # f32 stays f32 (the JAX package's precision): no TF32 in convs or matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def log(step: int, scalars: dict) -> None:
        print(json.dumps({"step": step, **scalars}), flush=True)

    result = fit(cfg, kind=kind, device=device, log_cb=log)
    print(f"trained {result['step']} steps; checkpoint {result['checkpoint']}")
    return result


def main(argv=None) -> dict:
    return run(argv, "regression")


if __name__ == "__main__":
    main()
