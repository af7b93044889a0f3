"""Strips the optimizer and scheduler from a training checkpoint, keeping
the weights and the config (counterpart of scripts/strip_checkpoint.py;
reference: weights/strip_checkpoint.py). Host only.

    python -m implicit_depth_tpu_torch.cli.strip_checkpoint \
        <log_dir>/<name>/checkpoints/ckpt_00001000 weights.pt

The input is a checkpoint directory of train/checkpoint.py (state.pt:
model, optimizer, scheduler, step; meta.json: config, metrics, step). The
output is a weights-only file (train/checkpoint.py::save_params: the model
state_dict, batch-norm statistics included, and the config in
`<out_path>.json`), which every CLI's --load_weights_from_checkpoint and
train/checkpoint.py::load_weights read.
"""

from __future__ import annotations

import argparse

from implicit_depth_tpu_torch.train import checkpoint as ckpt_lib


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("ckpt_dir", help="a checkpoint directory of train/checkpoint.py")
    p.add_argument("out_path", help="the weights file to write")
    args = p.parse_args(argv)

    meta = ckpt_lib.load_meta(args.ckpt_dir)
    ckpt_lib.save_params(args.out_path, ckpt_lib.load_weights(args.ckpt_dir),
                         config=meta.get("config"))
    print(f"wrote {args.out_path}")
    return args.out_path


if __name__ == "__main__":
    main()
