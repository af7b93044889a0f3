"""Weights: the bridge from the JAX package's flax variables to the port's
`state_dict`, and a seeded init that mirrors flax's initialisers.

The port's submodules carry the flax module names (`encoder`, `matching`,
`volume_mlp`, `cv_encoder`, `decoder`, `binary_mlp`, `s0_b0`, `conv_dw`,
...), so the bridge is a path map plus layout changes:

- conv kernels HWIO -> OIHW (a depthwise (3, 3, 1, mid) becomes (mid, 1, 3, 3));
- dense kernels (in, out) -> Linear weight (out, in);
- `volume_mlp/fc0_kernel` (202, 128) and `fc0_bias` stay raw parameters;
- flax names the BatchNorm inside the port's BN wrappers `BatchNorm_0`:
  `bn1/BatchNorm_0/{scale,bias}` and `batch_stats/.../BatchNorm_0/{mean,var}`
  map to `bn1.{weight,bias,running_mean,running_var}`.

Every leaf is consumed exactly once; an unknown leaf raises. A released
upstream checkpoint loads through the converters of
`train/checkpoint.py` (`convert_reference_bd_state_dict`, which ends in
this bridge; `cli/convert_checkpoint.py`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _flatten(tree: dict, prefix: tuple = ()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def state_dict_from_flax(variables_np: dict) -> dict:
    """flax {"params", "batch_stats"} tree with numpy leaves -> the port's
    state_dict (torch f32 tensors). Raises on a leaf it cannot place."""
    out: dict = {}
    for path, leaf in _flatten(variables_np):
        collection, names, name = path[0], list(path[1:-1]), path[-1]
        arr = np.asarray(leaf, dtype=np.float32)
        in_bn = bool(names) and names[-1] == "BatchNorm_0"
        if in_bn:
            names = names[:-1]
        if collection == "params" and in_bn and name in ("scale", "bias"):
            tname = _BN_LEAVES[name]
        elif collection == "batch_stats" and in_bn and name in ("mean", "var"):
            tname = _BN_LEAVES[name]
        elif collection == "params" and not in_bn and name == "kernel":
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            elif arr.ndim == 2:
                arr = arr.T  # (in, out) -> (out, in)
            else:
                raise ValueError(f"kernel {'/'.join(path)} has rank {arr.ndim}")
            tname = "weight"
        elif collection == "params" and not in_bn and name in ("bias", "fc0_kernel", "fc0_bias"):
            tname = name
        else:
            raise KeyError(f"no place in the port for flax leaf {'/'.join(path)}")
        key = ".".join(names + [tname])
        if key in out:
            raise KeyError(f"two flax leaves map to {key}")
        out[key] = torch.from_numpy(np.array(arr, copy=True, order="C"))
    return out


def load_state_dict(model: nn.Module, state_dict: dict, optional_prefixes=()) -> None:
    """Strict load, except that keys under `optional_prefixes` may be
    missing (e.g. the training-only query heads, which an eval-initialised
    flax tree does not hold)."""
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    if unexpected:
        raise KeyError(f"state_dict keys the model does not have: {unexpected}")
    missing = [k for k in missing if not k.startswith(tuple(optional_prefixes))]
    if missing:
        raise KeyError(f"model keys the state_dict does not have: {missing}")


def lazy_load_state_dict(model: nn.Module, state_dict: dict) -> int:
    """Copies every entry of `state_dict` whose name and shape both match one
    of `model`'s (parameters and batch-norm statistics) and leaves the rest
    as they are: how a model starts from another's weights, e.g. the BD
    model from a regression model (the JAX package's lazy_load_params).
    Returns the number of tensors copied."""
    own = model.state_dict()
    matched = {k: v for k, v in state_dict.items() if k in own and own[k].shape == v.shape}
    with torch.no_grad():
        for k, v in matched.items():
            own[k].copy_(v)
    return len(matched)


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    # flax lecun_normal: truncated normal at +-2 std, rescaled to unit variance;
    # drawn in index order, so a channels_last weight gets the same values
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    draw = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    t.copy_(nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std, generator=generator))


def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init with flax's defaults: lecun-normal kernels, zero biases,
    unit BN scale and variance, zero BN shift and mean."""
    from implicit_depth_tpu_torch.models.matching import BatchNorm
    from implicit_depth_tpu_torch.models.volume_mlp import MetadataVolumeMLP

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                _lecun_normal_(m.weight, m.weight[0].numel(), generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            elif isinstance(m, MetadataVolumeMLP):
                _lecun_normal_(m.fc0_kernel, m.fc0_kernel.shape[0], generator)
                m.fc0_bias.zero_()
    return model
