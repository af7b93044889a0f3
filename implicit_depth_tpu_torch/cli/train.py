"""Depth-regression training with the PyTorch port (counterpart of
scripts/train.py); `run` is shared with cli/train_bd.py.

    python -m implicit_depth_tpu_torch.cli.train \
        --config_file configs/models/regression_model.yaml \
        --data_config_file configs/data/scannet_default_train.yaml \
        [--device cuda] [--max_steps N] [--load_weights_from_checkpoint weights.pt] \
        [--resume <log_dir>/<name>/checkpoints/last]

The device defaults to cuda (the CUDA kernels); --device cpu runs their
plain versions on the CPU. At every validation and at the end a checkpoint
directory ckpt_{step:08d}/ (state.pt with model, optimizer, scheduler and
step; meta.json) goes to <log_dir>/<name>/checkpoints, which keeps the best
three on the validation metric and a `last` link; scalars go to
<log_dir>/<name>/metrics.jsonl (and TensorBoard where tensorboardX
imports) and are printed one JSON object per line. --resume continues a
run from a checkpoint directory, with the same batches an uninterrupted
run would take.

Data parallel over N processes (one per device; rank r takes
cuda:{r % device_count}): start the same command N times, adding

    --jax_distributed --coordinator_address HOST:PORT \
        --distributed_num_processes N --distributed_process_id r

for r = 0 .. N-1 (HOST:PORT is a free port of rank 0's host). cfg.batch_size
is the global batch; each rank loads its batch_size / N rows of it, and
rank 0 logs and writes the checkpoints.
"""

from __future__ import annotations

import json

import torch

from implicit_depth_tpu_torch.config import parse_config
from implicit_depth_tpu_torch.parallel import distributed
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

    try:
        result = fit(cfg, kind=kind, device=device, log_cb=log)
    finally:
        if cfg.jax_distributed:
            distributed.shutdown()
    print(f"trained {result['step']} steps; checkpoint {result['checkpoint']}")
    return result


def main(argv=None) -> dict:
    return run(argv, "regression")


if __name__ == "__main__":
    main()
