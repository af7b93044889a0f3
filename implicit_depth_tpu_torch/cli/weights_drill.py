"""Weights-arrival drill (counterpart of scripts/weights_drill.py): a
released reference `.ckpt` -> a converted port weights file -> the eval
CLI's tables, in one command.

    python -m implicit_depth_tpu_torch.cli.weights_drill --ckpt weights/implicit_depth.ckpt \
        [--data_config configs/data/scannet_default_test.yaml] [--workdir DIR] \
        [--max_frames N] [--single_debug_scan_id S] [eval CLI flags, e.g. --device cpu]

1. loads the Lightning checkpoint with cli/convert_checkpoint.py's loading
   (its `options.Options` shim makes the pickled hyper_parameters readable
   without the reference package) and converts its state_dict
   (convert_checkpoint.convert; bd or regression from the keys);
2. writes <workdir>/converted.pt (train/checkpoint.py::save_params, with
   {"kind", "hyper_parameters"} in converted.pt.json);
3. writes <workdir>/ckpt_opts.yaml, an eval model config of the
   checkpoint's own hyper-parameters (the architecture and BD eval keys of
   _TRANSFER_KEYS; data and infrastructure keys stay local) that names the
   converted file;
4. runs cli/test_bd.main (bd) or cli/test_reg.main (regression) in this
   process on that config and --data_config, results under
   <workdir>/results; unknown flags go to that CLI as given.

The default data config is the synthetic one, which proves the whole path
without data; the default workdir is weights_drill in the temporary
directory.
"""

from __future__ import annotations

import argparse
import os
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the config keys that transfer from the checkpoint's hyper_parameters to
# the eval config (model architecture and BD eval behaviour)
_TRANSFER_KEYS = (
    "image_encoder_name", "depth_decoder_name", "matching_encoder_type",
    "matching_feature_dims", "matching_scale", "matching_num_depth_bins",
    "min_matching_depth", "max_matching_depth", "cv_encoder_type",
    "feature_volume_type", "use_prior", "bd_sigmoid_multiplier",
    "model_num_views", "loss_type", "name",
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True, help="released .ckpt path")
    ap.add_argument("--data_config", default="configs/data/synthetic_smoke.yaml")
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "weights_drill"))
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--single_debug_scan_id", default=None)
    args, extra = ap.parse_known_args(argv)

    import torch
    import yaml

    from implicit_depth_tpu_torch.cli import convert_checkpoint, test_bd, test_reg
    from implicit_depth_tpu_torch.train import checkpoint as ckpt_lib

    os.makedirs(args.workdir, exist_ok=True)
    convert_checkpoint.install_options_shim()
    # the released files pickle an Options object: a trusted local file only
    payload = torch.load(args.ckpt, map_location="cpu", weights_only=False)
    state_dict, kind, hp = convert_checkpoint.convert(payload)
    print(f"[drill] checkpoint kind: {kind} ({len(payload.get('state_dict', payload))} tensors)")
    converted = os.path.join(args.workdir, "converted.pt")
    ckpt_lib.save_params(converted, state_dict, config={"kind": kind, "hyper_parameters": hp})
    print(f"[drill] converted -> {converted}")

    opts = {k: hp[k] for k in _TRANSFER_KEYS if k in hp}
    opts["load_weights_from_checkpoint"] = converted
    cfg_path = os.path.join(args.workdir, "ckpt_opts.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(opts, f)
    print(f"[drill] eval config from ckpt hparams: {sorted(opts)}")

    data_config = (args.data_config if os.path.isabs(args.data_config)
                   else os.path.join(REPO, args.data_config))
    cli_args = ["--config_file", cfg_path, "--data_config_file", data_config,
                "--output_base_path", os.path.join(args.workdir, "results")]
    if args.max_frames is not None:
        cli_args += ["--max_frames", str(args.max_frames)]
    if args.single_debug_scan_id:
        cli_args += ["--single_debug_scan_id", args.single_debug_scan_id]
    cli = test_bd if kind == "bd" else test_reg
    print(f"[drill] running: {cli.__name__} {' '.join(cli_args + extra)}")
    result = cli.main(cli_args + extra)
    print("[drill] OK")
    return result


if __name__ == "__main__":
    main()
