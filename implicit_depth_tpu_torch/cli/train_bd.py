"""BD training with the PyTorch port (counterpart of scripts/train_bd.py).

    python -m implicit_depth_tpu_torch.cli.train_bd \
        --config_file configs/models/implicit_depth.yaml \
        --data_config_file configs/data/scannet_default_train.yaml \
        [--device cuda] [--max_steps N] [--load_weights_from_checkpoint weights.pt]

The options, checkpoints, --resume and the data-parallel launch of N
processes (--jax_distributed ...) are those of cli/train.py; the
checkpoints keep the best three on val/harmonic_iou.
"""

from __future__ import annotations

from implicit_depth_tpu_torch.cli.train import run


def main(argv=None) -> dict:
    return run(argv, "bd")


if __name__ == "__main__":
    main()
