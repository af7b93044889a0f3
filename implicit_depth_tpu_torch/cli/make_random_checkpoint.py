"""Writes a weights file of seeded random weights for a model config
(counterpart of scripts/make_random_checkpoint.py), to drive the eval and
temporal CLIs end to end where no trained or converted checkpoint is at
hand.

    python -m implicit_depth_tpu_torch.cli.make_random_checkpoint \
        --config_file configs/models/X.yaml [--data_config_file configs/data/Y.yaml] \
        --output rand.pt [--seed 0]

The config's BDNet (train/loop.py::build_net) takes weights.init_params
from a torch.Generator seeded with --seed, drawn on the host. The file
holds what the JAX script's eval-initialised tree holds: every tensor but
the training-only query heads (bd_net.TRAIN_ONLY_PREFIXES), which
cli/test_bd.py's load does not need; it loads into the net strictly
otherwise (weights.load_state_dict). It is a train/checkpoint.py::
save_params file, which every CLI's --load_weights_from_checkpoint takes.
The default --output is random_init.pt in the temporary directory. Other
flags go to config.parse_config (--device is accepted and unused: the
weights are made on the host).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from implicit_depth_tpu_torch.config import parse_config
from implicit_depth_tpu_torch.models.bd_net import TRAIN_ONLY_PREFIXES
from implicit_depth_tpu_torch.train import checkpoint as ckpt_lib
from implicit_depth_tpu_torch.train.loop import build_net
from implicit_depth_tpu_torch.weights import init_params


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], add_help=False)
    ap.add_argument("--output", default=os.path.join(tempfile.gettempdir(), "random_init.pt"))
    ap.add_argument("--seed", type=int, default=0)
    args, rest = ap.parse_known_args(argv)
    cfg, _ = parse_config(rest)

    net = init_params(build_net(cfg, "bd"), torch.Generator().manual_seed(args.seed))
    state = {k: v for k, v in net.state_dict().items() if not k.startswith(TRAIN_ONLY_PREFIXES)}
    ckpt_lib.save_params(args.output, state)
    n = sum(v.numel() for v in state.values())
    print(f"wrote {args.output}: {n / 1e6:.1f}M params")
    return args.output


if __name__ == "__main__":
    main()
