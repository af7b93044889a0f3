"""Checkpoints, counterpart of implicit_depth_tpu/train/checkpoint.py.

The store: one directory per save, `ckpt_{step:08d}/`, holding `state.pt`
(torch.save of {"model": state_dict, "optimizer", "scheduler", "step"})
and `meta.json` ({"config", "metrics", "step"}: the JAX package's schema),
with `CheckpointManager`'s policy: the top-k saves on a monitored metric
(max or min) and a `last` symlink re-pointed at every save (the reference's
ModelCheckpoint: top-3 on val/harmonic_iou, save_last).

Async writes. A jax array is immutable, so the JAX package hands its state
to the writer thread. A torch state_dict holds the live tensors, which the
next optimizer step changes in place: `snapshot` copies the model's and the
optimizer's tensors (and the scheduler's state) to the host before `save`
returns, and only the serialisation and the disk write run on the thread.

Weights only: `save_params` / `load_params` (the strip_checkpoint
equivalent, with the config in a `.json` sidecar), and `load_weights`, which
takes a checkpoint directory, a weights-only file or a `{model, ...}` file.
A lazy (partial) load is `weights.lazy_load_state_dict`.

The converters from the reference's released `.ckpt` state_dicts are
numpy copies of the JAX package's (below); `convert_reference_bd_state_dict`
and `convert_reference_depth_state_dict` compose each with the weight
bridge (`weights.state_dict_from_flax`) into a port state_dict.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from implicit_depth_tpu_torch.weights import load_state_dict, state_dict_from_flax


# --------------------------------------------------------------------- #
# the store, with top-k retention
# --------------------------------------------------------------------- #

class CheckpointManager:
    """Keeps `save_top_k` checkpoints ranked by the metric `monitor` (mode
    "max" or "min") plus a rolling `last` symlink. With async_write the
    serialisation and the disk write of a save run on a background thread
    (one at a time); `wait()` joins it (also called by the next save and by
    best_path) and raises what the write raised."""

    def __init__(self, directory: str, monitor: str = "loss", mode: str = "min",
                 save_top_k: int = 3, async_write: bool = False):
        self.directory = directory
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.async_write = async_write
        self._entries: list[tuple[float, str]] = []
        self._pending: Optional[threading.Thread] = None
        self._error: list[BaseException] = []
        # paths evicted from top-k that cannot be deleted yet because they
        # are the in-flight write and/or the current `last` target
        self._deferred_prune: list[str] = []
        os.makedirs(directory, exist_ok=True)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error:
            raise RuntimeError("the checkpoint write failed") from self._error.pop()

    def save(self, model: torch.nn.Module, optimizer=None, scheduler=None, *, step: int,
             config: Optional[dict] = None, metrics: Optional[dict] = None) -> str:
        """Saves model, optimizer, scheduler and step as ckpt_{step:08d};
        returns its path."""
        path = os.path.join(self.directory, f"ckpt_{step:08d}")
        self.wait()  # one in-flight write at a time
        payload = snapshot(model, optimizer, scheduler, step)  # host copies, now
        if self.async_write:
            def write():
                try:
                    _write_state(path, payload, config, metrics)
                except BaseException as e:  # re-raised by wait()
                    self._error.append(e)

            self._pending = threading.Thread(target=write, daemon=True)
            self._pending.start()
        else:
            _write_state(path, payload, config, metrics)

        evicted: list[str] = []
        if metrics and self.monitor in metrics:
            self._entries.append((float(metrics[self.monitor]), path))
            self._entries.sort(key=lambda e: e[0], reverse=(self.mode == "max"))
            evicted = [p for _, p in self._entries[self.save_top_k:]]
            self._entries = self._entries[: self.save_top_k]

        last = os.path.join(self.directory, "last")
        if os.path.islink(last):
            os.unlink(last)
        elif os.path.exists(last):
            shutil.rmtree(last, ignore_errors=True)
        os.symlink(os.path.basename(path), last)

        # The just-saved `path` may still be mid-write on the thread and is
        # always the `last` target, so it is never deleted in this call even
        # if its metric fell outside top-k: it is deferred and pruned by a
        # later save, once `last` points elsewhere and wait() has joined it.
        to_prune = [p for p in self._deferred_prune + evicted if p != path]
        self._deferred_prune = [p for p in evicted if p == path]
        for stale in to_prune:
            if os.path.isdir(stale):
                shutil.rmtree(stale, ignore_errors=True)
        return path

    def best_path(self) -> Optional[str]:
        self.wait()
        return self._entries[0][1] if self._entries else None


def _to_host(tree):
    """A copy of a (nested) state_dict whose tensors are detached host
    copies, sharing no storage with the live ones."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def snapshot(model: torch.nn.Module, optimizer=None, scheduler=None, step: int = 0) -> dict:
    """{"model", "optimizer", "scheduler", "step"} as host copies: what a
    later in-place update of the live tensors cannot change."""
    return {"model": _to_host(model.state_dict()),
            "optimizer": None if optimizer is None else _to_host(optimizer.state_dict()),
            "scheduler": None if scheduler is None else _to_host(scheduler.state_dict()),
            "step": int(step)}


def _write_state(path: str, payload: dict, config: Optional[dict] = None,
                 metrics: Optional[dict] = None) -> None:
    os.makedirs(path, exist_ok=True)
    torch.save(payload, os.path.join(path, "state.pt"))
    meta = {"config": config or {}, "metrics": {k: float(v) for k, v in (metrics or {}).items()},
            # the step top-level: the resume offset reads it here rather than
            # loading state.pt (peek_step is the fallback)
            "step": int(payload["step"])}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)


def save_state(path: str, model: torch.nn.Module, optimizer=None, scheduler=None, *,
               step: int, config: Optional[dict] = None,
               metrics: Optional[dict] = None) -> None:
    _write_state(path, snapshot(model, optimizer, scheduler, step), config, metrics)


def _read_state(path: str) -> dict:
    return torch.load(os.path.join(path, "state.pt"), map_location="cpu", weights_only=True)


def restore_state(path: str, model: torch.nn.Module, optimizer=None, scheduler=None) -> int:
    """Loads a checkpoint directory into the model (strict), the optimizer
    and the scheduler, where given; returns its step."""
    payload = _read_state(path)
    load_state_dict(model, payload["model"])
    if optimizer is not None:
        optimizer.load_state_dict(payload["optimizer"])
    if scheduler is not None:
        scheduler.load_state_dict(payload["scheduler"])
    return int(payload["step"])


def peek_step(path: str) -> int:
    """The step recorded in a checkpoint directory's state.pt."""
    return int(torch.load(os.path.join(path, "state.pt"), map_location="cpu", mmap=True,
                          weights_only=True)["step"])


def load_meta(path: str) -> dict:
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def save_params(path: str, state_dict: dict, config: Optional[dict] = None) -> None:
    """Weights-only checkpoint (the strip_checkpoint equivalent): the
    state_dict, and the config in `path + ".json"`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(_to_host(state_dict), path)
    if config is not None:
        with open(path + ".json", "w") as f:
            json.dump(config, f, indent=2, default=str)


def load_params(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_weights(path: str) -> dict:
    """The model state_dict of a checkpoint directory, of a weights-only
    file, or of a {"model": state_dict, ...} file."""
    state = _read_state(path) if os.path.isdir(path) else load_params(path)
    return state["model"] if isinstance(state.get("model"), dict) else state


def convert_reference_bd_state_dict(sd: dict) -> dict:
    """A reference BDModel state_dict -> the port's BDNet state_dict."""
    params, stats = convert_reference_bd_checkpoint(sd)
    return state_dict_from_flax({"params": params, "batch_stats": stats})


def convert_reference_depth_state_dict(sd: dict) -> dict:
    """A reference DepthModel state_dict -> the port's DepthNet state_dict."""
    params, stats = convert_reference_depth_checkpoint(sd)
    return state_dict_from_flax({"params": params, "batch_stats": stats})


# --------------------------------------------------------------------- #
# torch .ckpt conversion: a copy of implicit_depth_tpu/train/checkpoint.py
# (from `_t` to the end, its lines 222-498) with nothing changed; it returns
# flax-layout (params, batch_stats) trees with numpy leaves
# --------------------------------------------------------------------- #

def _t(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x)


def _conv_w(x) -> np.ndarray:
    """torch conv (O, I, kh, kw) -> flax (kh, kw, I, O)."""
    return _t(x).transpose(2, 3, 1, 0)


def _dense_w(x) -> np.ndarray:
    return _t(x).T


def convert_basic_block(sd: dict, prefix: str) -> dict:
    """Reference norm-free BasicBlock (modules/layers.py:34-95) ->
    models.blocks.BasicBlock params."""
    out = {
        "conv1": {"kernel": _conv_w(sd[f"{prefix}.conv1.weight"]),
                   "bias": _t(sd[f"{prefix}.conv1.bias"])},
        "conv2": {"kernel": _conv_w(sd[f"{prefix}.conv2.weight"]),
                   "bias": _t(sd[f"{prefix}.conv2.bias"])},
    }
    if f"{prefix}.downsample.0.weight" in sd:
        out["downsample"] = {
            "kernel": _conv_w(sd[f"{prefix}.downsample.0.weight"]),
            "bias": _t(sd[f"{prefix}.downsample.0.bias"]),
        }
    return out


def convert_volume_mlp(sd: dict, prefix: str = "cost_volume.mlp.net") -> dict:
    """FeatureVolumeManager MLP (202->128->128->1) -> MetadataVolumeMLP."""
    return {
        "fc0_kernel": _dense_w(sd[f"{prefix}.0.weight"]),
        "fc0_bias": _t(sd[f"{prefix}.0.bias"]),
        "fc1": {"kernel": _dense_w(sd[f"{prefix}.2.weight"]), "bias": _t(sd[f"{prefix}.2.bias"])},
        "fc2": {"kernel": _dense_w(sd[f"{prefix}.4.weight"]), "bias": _t(sd[f"{prefix}.4.bias"])},
    }


def convert_binary_mlp(sd: dict, prefix: str = "binary_mlp.mlps") -> dict:
    """BinaryMLPNetwork (modules/networks.py:87-115): per-scale Sequential
    Linear(0)/Linear(2)/Linear(4)."""
    out = {}
    for s in range(4):
        for li, idx in enumerate((0, 2, 4)):
            key = f"{prefix}.s{s}.{idx}"
            if f"{key}.weight" not in sd:
                continue
            out[f"s{s}_fc{li}"] = {
                "kernel": _dense_w(sd[f"{key}.weight"]),
                "bias": _t(sd[f"{key}.bias"]),
            }
    return out


def convert_cv_encoder(sd: dict, prefix: str = "cost_volume_net.convs") -> dict:
    """CVEncoder (modules/networks.py:186-215)."""
    out = {}
    for i in range(4):
        out[f"ds_conv_{i}"] = convert_basic_block(sd, f"{prefix}.ds_conv_{i}")
        out[f"conv_{i}_0"] = convert_basic_block(sd, f"{prefix}.conv_{i}.0")
        out[f"conv_{i}_1"] = convert_basic_block(sd, f"{prefix}.conv_{i}.1")
    return out


def convert_decoder_pp(sd: dict, prefix: str = "depth_decoder.convs", heads: bool = False) -> dict:
    """BDDecoderPP / DepthDecoderPP grids (modules/networks.py:20-84,
    118-183). Only the effective (last-write) output_{i} heads are used."""
    out = {}
    pat = re.compile(rf"^{re.escape(prefix)}\.(diag_conv|right_conv|up_conv)_(\d)(\d)\.conv1\.weight$")
    for key in list(sd.keys()):
        m = pat.match(key)
        if m:
            name = f"{m.group(1)}_{m.group(2)}{m.group(3)}"
            out[name] = convert_basic_block(sd, f"{prefix}.{name}")
    for j in range(1, 5):
        for i in range(4 - j, -1, -1):
            name = f"in_conv_{i}{j}"
            out[name] = {
                "block0": convert_basic_block(sd, f"{prefix}.{name}.0"),
                "block1": convert_basic_block(sd, f"{prefix}.{name}.conv_0"),
            }
    for i in range(1, 4):
        out[f"output_{i}"] = convert_basic_block(sd, f"{prefix}.output_{i}.0")
    if heads:
        for i in range(4):
            w = f"{prefix}.output_{i}.1.weight"
            if w in sd:
                out[f"output_head_{i}"] = {"kernel": _conv_w(sd[w]),
                                            "bias": _t(sd[f"{prefix}.output_{i}.1.bias"])}
    return out


def convert_matching_encoder(sd: dict, prefix: str = "matching_model.net") -> dict:
    """ResnetMatchingEncoder (modules/networks.py:236-287). Sequential
    layout: 0 conv1, 1 bn1, 4 layer1, 5 conv1x1, 8 conv3x3."""
    def bn(p):
        return {
            "scale": _t(sd[f"{p}.weight"]), "bias": _t(sd[f"{p}.bias"]),
            "mean": _t(sd[f"{p}.running_mean"]), "var": _t(sd[f"{p}.running_var"]),
        }

    def res_block(p):
        out = {
            "conv1": {"kernel": _conv_w(sd[f"{p}.conv1.weight"])},
            "conv2": {"kernel": _conv_w(sd[f"{p}.conv2.weight"])},
            "bn1": bn(f"{p}.bn1"), "bn2": bn(f"{p}.bn2"),
        }
        return out

    return {
        "conv1": {"kernel": _conv_w(sd[f"{prefix}.0.weight"])},
        "bn1": bn(f"{prefix}.1"),
        "layer1_0": res_block(f"{prefix}.4.0"),
        "layer1_1": res_block(f"{prefix}.4.1"),
        "head_conv1": {"kernel": _conv_w(sd[f"{prefix}.5.weight"]), "bias": _t(sd[f"{prefix}.5.bias"])},
        "head_conv2": {"kernel": _conv_w(sd[f"{prefix}.8.weight"]), "bias": _t(sd[f"{prefix}.8.bias"])},
    }


def _bn(sd: dict, p: str) -> dict:
    return {
        "scale": _t(sd[f"{p}.weight"]), "bias": _t(sd[f"{p}.bias"]),
        "mean": _t(sd[f"{p}.running_mean"]), "var": _t(sd[f"{p}.running_var"]),
    }


# (kind, repeats) per stage of tf_efficientnetv2_s; kind: cn=ConvBnAct,
# er=EdgeResidual (fused-MBConv), ir=InvertedResidual (MBConv+SE)
# (timm model def; mirrored by models.image_encoders.EfficientNetV2S)
_EFFNETV2S_STAGES = (("cn", 2), ("er", 4), ("er", 4), ("ir", 6), ("ir", 9), ("ir", 15))


def convert_efficientnetv2s(sd: dict, prefix: str = "encoder") -> dict:
    """timm `tf_efficientnetv2_s(_in21ft1k)` features_only state_dict ->
    models.image_encoders.EfficientNetV2S params (reference image encoder,
    experiment_modules/bd_model.py:46-51). Returns a tree with fused
    {scale,bias,mean,var} BN dicts — run through split_bn."""
    out = {
        "conv_stem": {"kernel": _conv_w(sd[f"{prefix}.conv_stem.weight"])},
        "bn1": _bn(sd, f"{prefix}.bn1"),
    }
    for s, (kind, reps) in enumerate(_EFFNETV2S_STAGES):
        for i in range(reps):
            p = f"{prefix}.blocks.{s}.{i}"
            if kind == "cn":
                blk = {
                    "conv": {"kernel": _conv_w(sd[f"{p}.conv.weight"])},
                    "bn1": _bn(sd, f"{p}.bn1"),
                }
            elif kind == "er":
                blk = {
                    "conv_exp": {"kernel": _conv_w(sd[f"{p}.conv_exp.weight"])},
                    "bn1": _bn(sd, f"{p}.bn1"),
                    "conv_pwl": {"kernel": _conv_w(sd[f"{p}.conv_pwl.weight"])},
                    "bn2": _bn(sd, f"{p}.bn2"),
                }
            else:
                blk = {
                    "conv_pw": {"kernel": _conv_w(sd[f"{p}.conv_pw.weight"])},
                    "bn1": _bn(sd, f"{p}.bn1"),
                    "conv_dw": {"kernel": _conv_w(sd[f"{p}.conv_dw.weight"])},
                    "bn2": _bn(sd, f"{p}.bn2"),
                    "se": {
                        "conv_reduce": {
                            "kernel": _conv_w(sd[f"{p}.se.conv_reduce.weight"]),
                            "bias": _t(sd[f"{p}.se.conv_reduce.bias"]),
                        },
                        "conv_expand": {
                            "kernel": _conv_w(sd[f"{p}.se.conv_expand.weight"]),
                            "bias": _t(sd[f"{p}.se.conv_expand.bias"]),
                        },
                    },
                    "conv_pwl": {"kernel": _conv_w(sd[f"{p}.conv_pwl.weight"])},
                    "bn3": _bn(sd, f"{p}.bn3"),
                }
            out[f"s{s}_b{i}"] = blk
    return out


def convert_resnet18d(sd: dict, prefix: str = "encoder") -> dict:
    """timm `resnet18d` features_only state_dict ->
    models.image_encoders.ResNet18D params (bd_model.py:65-68). timm's
    deep stem is conv1.{0,3,6} convs with conv1.{1,4} BNs and a top-level
    bn1 after the last stem conv; '-d' downsample = AvgPool + 1x1 conv
    at downsample.{1,2}."""
    out = {
        "stem_conv0": {"kernel": _conv_w(sd[f"{prefix}.conv1.0.weight"])},
        "stem_bn0": _bn(sd, f"{prefix}.conv1.1"),
        "stem_conv1": {"kernel": _conv_w(sd[f"{prefix}.conv1.3.weight"])},
        "stem_bn1": _bn(sd, f"{prefix}.conv1.4"),
        "stem_conv2": {"kernel": _conv_w(sd[f"{prefix}.conv1.6.weight"])},
        "stem_bn2": _bn(sd, f"{prefix}.bn1"),
    }
    for li in range(1, 5):
        for bi in range(2):
            p = f"{prefix}.layer{li}.{bi}"
            blk = {
                "conv1": {"kernel": _conv_w(sd[f"{p}.conv1.weight"])},
                "bn1": _bn(sd, f"{p}.bn1"),
                "conv2": {"kernel": _conv_w(sd[f"{p}.conv2.weight"])},
                "bn2": _bn(sd, f"{p}.bn2"),
            }
            if f"{p}.downsample.1.weight" in sd:
                blk["downsample_conv"] = {
                    "kernel": _conv_w(sd[f"{p}.downsample.1.weight"])}
                blk["downsample_bn"] = _bn(sd, f"{p}.downsample.2")
            out[f"layer{li}_{bi}"] = blk
    return out


def split_bn(converted: dict) -> tuple[dict, dict]:
    """Splits {scale,bias,mean,var} BN dicts into flax params
    ({scale,bias} under BatchNorm_0) and batch_stats ({mean,var})."""
    params, stats = {}, {}
    for k, v in converted.items():
        if isinstance(v, dict):
            if set(v.keys()) == {"scale", "bias", "mean", "var"}:
                params[k] = {"BatchNorm_0": {"scale": v["scale"], "bias": v["bias"]}}
                stats[k] = {"BatchNorm_0": {"mean": v["mean"], "var": v["var"]}}
            else:
                p, s = split_bn(v)
                params[k] = p
                if s:
                    stats[k] = s
        else:
            params[k] = v
    return params, stats


def convert_image_encoder(state_dict: dict, prefix: str = "encoder") -> dict:
    """Dispatches on the timm layout present in the state_dict:
    conv_stem.* -> tf_efficientnetv2_s, conv1.0.* -> resnet18d."""
    if f"{prefix}.conv_stem.weight" in state_dict:
        return convert_efficientnetv2s(state_dict, prefix)
    if f"{prefix}.conv1.0.weight" in state_dict:
        return convert_resnet18d(state_dict, prefix)
    raise ValueError(
        f"unrecognised image-encoder layout under '{prefix}.' "
        "(supported: tf_efficientnetv2_s, resnet18d)"
    )


def convert_reference_depth_checkpoint(state_dict: dict) -> tuple[dict, dict]:
    """Converts a reference DepthModel state_dict (experiment_modules/
    depth_model.py) to (params, batch_stats) for DepthNet — same subnets
    as the BD model minus the binary MLP, plus the per-scale 1x1 depth
    heads (modules/networks.py:158-161)."""
    params: dict = {}
    stats: dict = {}
    p, s = split_bn(convert_image_encoder(state_dict))
    params["encoder"], stats["encoder"] = p, s
    p, s = split_bn(convert_matching_encoder(state_dict))
    params["matching"], stats["matching"] = p, s
    if any(k.startswith("cost_volume.mlp") for k in state_dict):
        params["volume_mlp"] = convert_volume_mlp(state_dict)
    params["cv_encoder"] = convert_cv_encoder(state_dict)
    params["decoder"] = convert_decoder_pp(state_dict, "depth_decoder.convs", heads=True)
    return params, stats


def convert_reference_bd_checkpoint(state_dict: dict) -> tuple[dict, dict]:
    """Converts a reference BDModel state_dict to (params, batch_stats)
    subtrees keyed by our module names — a COMPLETE tree for
    BDNet.apply, including the timm image encoder."""
    params: dict = {}
    stats: dict = {}
    p, s = split_bn(convert_image_encoder(state_dict))
    params["encoder"], stats["encoder"] = p, s
    p, s = split_bn(convert_matching_encoder(state_dict))
    params["matching"], stats["matching"] = p, s
    params["volume_mlp"] = convert_volume_mlp(state_dict)
    params["cv_encoder"] = convert_cv_encoder(state_dict)
    params["decoder"] = convert_decoder_pp(state_dict, "depth_decoder.convs", heads=False)
    params["binary_mlp"] = convert_binary_mlp(state_dict)
    return params, stats
