"""Converts a released reference `.ckpt` (PyTorch Lightning) into a port
weights file (counterpart of scripts/convert_checkpoint.py).

    python -m implicit_depth_tpu_torch.cli.convert_checkpoint \
        --input weights/implicit_depth.ckpt --output weights/implicit_depth.pt \
        [--kind bd|regression|auto]

The Lightning checkpoint holds the BDModel (or DepthModel) state_dict under
"state_dict", with keys like `encoder.conv_stem.weight` (timm
tf_efficientnetv2_s), `matching_model.net.*`, `cost_volume.mlp.net.*`,
`cost_volume_net.convs.*`, `depth_decoder.convs.*` and `binary_mlp.mlps.*`
(reference: experiment_modules/bd_model.py:39-141). The kind is detected
from the keys (`binary_mlp.*`: bd). The output is a weights-only port
state_dict (train/checkpoint.py::save_params) that every CLI's
--load_weights_from_checkpoint takes, with `<output>.json` beside it:
{"kind", "hyper_parameters"}, the option fields of the checkpoint's
pickled reference `options.Options` (the reference restores its eval
options from them, test_bd.py:74-79).
"""

from __future__ import annotations

import argparse
import sys
import types


def install_options_shim() -> None:
    """Makes the released .ckpts loadable without the reference package:
    they embed a pickled reference `options.Options` instance in
    hyper_parameters (bd_model.py:41 save_hyperparameters), and unpickling
    needs that class importable; the shim restores the instance's
    attribute dict. (The same as scripts/convert_checkpoint.py's.)"""
    if "options" in sys.modules:
        return

    class Options:
        pass

    mod = types.ModuleType("options")
    mod.Options = Options
    sys.modules["options"] = mod


def opts_to_dict(hparams) -> dict:
    """hyper_parameters -> a JSON-serialisable dict of the option fields.
    (The same as scripts/convert_checkpoint.py's.)"""
    if hasattr(hparams, "get") and "opts" in hparams:
        hparams = hparams["opts"]
    src = getattr(hparams, "__dict__", None) or (
        hparams if isinstance(hparams, dict) else {})
    out = {}
    for k, v in src.items():
        if isinstance(v, (bool, int, float, str, type(None))):
            out[k] = v
        elif isinstance(v, (list, tuple)) and all(
                isinstance(x, (bool, int, float, str)) for x in v):
            out[k] = list(v)
    return out


def convert(payload: dict, kind: str = "auto") -> tuple[dict, str, dict]:
    """A loaded reference checkpoint (or a bare state_dict) -> (port
    state_dict, kind, option fields)."""
    from implicit_depth_tpu_torch.train import checkpoint as ckpt_lib

    sd = payload.get("state_dict", payload)
    if kind == "auto":
        kind = "bd" if any(k.startswith("binary_mlp.") for k in sd) else "regression"
    fn = (ckpt_lib.convert_reference_bd_state_dict if kind == "bd"
          else ckpt_lib.convert_reference_depth_state_dict)
    return fn(sd), kind, opts_to_dict(payload.get("hyper_parameters", {}))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", required=True, help="reference .ckpt path")
    ap.add_argument("--output", required=True, help="output port weights path")
    ap.add_argument("--kind", choices=("bd", "regression", "auto"), default="auto",
                    help="checkpoint family: implicit_depth*.ckpt (bd) or regression.ckpt; "
                         "auto-detected from the state_dict")
    args = ap.parse_args(argv)

    import torch

    from implicit_depth_tpu_torch.train import checkpoint as ckpt_lib

    install_options_shim()
    # the released files pickle an Options object: a trusted local file only
    payload = torch.load(args.input, map_location="cpu", weights_only=False)
    state_dict, kind, hparams = convert(payload, args.kind)
    print(f"checkpoint kind: {kind}")
    ckpt_lib.save_params(args.output, state_dict,
                         config={"kind": kind, "hyper_parameters": hparams})
    n = sum(v.numel() for v in state_dict.values())
    print(f"wrote {args.output}: {n / 1e6:.1f}M values in {len(state_dict)} tensors "
          f"(source {len(payload.get('state_dict', payload))} tensors)")
    return {"kind": kind, "state_dict": state_dict, "hyper_parameters": hparams}


if __name__ == "__main__":
    main()
