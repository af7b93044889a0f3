"""BD training with the PyTorch port (counterpart of scripts/train_bd.py),
single process on one device.

    python -m implicit_depth_tpu_torch.cli.train_bd \
        --config_file configs/models/implicit_depth.yaml \
        --data_config_file configs/data/scannet_default_train.yaml \
        [--device cuda] [--max_steps N] [--load_weights_from_checkpoint weights.pt]

The device defaults to cuda (the CUDA kernels); --device cpu runs their
plain versions on the CPU. Checkpoints ({model, optimizer, step}) go to
<log_dir>/<name>/checkpoints at every validation and at the end; scalars
are printed one JSON object per line.
"""

from __future__ import annotations

from implicit_depth_tpu_torch.cli.train import run


def main(argv=None) -> dict:
    return run(argv, "bd")


if __name__ == "__main__":
    main()
