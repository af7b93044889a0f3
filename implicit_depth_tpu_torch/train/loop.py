"""Training orchestration, counterpart of implicit_depth_tpu/train/loop.py:
`build_net` and `build_dataset` (shared with the eval CLIs), and `fit`, a
single-process training loop for the BD model (kind "bd") or DepthNet
(kind "regression").

fit wires: dataset -> the port's BatchLoader -> the kind's train step ->
log scalars every log_interval steps -> validation every val_interval steps
(BD: `forward_val` + `legacy_and_new_iou`; regression: `regression_losses`
of the eval-mode forward) -> `torch.save` of {model, optimizer, step} at
each validation and at the end. A config's lazy_load_weights_from_checkpoint
(a port state_dict, e.g. of a regression model) seeds every entry whose
name and shape match (weights.lazy_load_state_dict). Not ported yet, and
refused where a flag asks for them (--resume, --jax_distributed): the
CheckpointManager's top-k and resume with the data-order skip, async
writes, the ExperimentLogger and multi-process data parallelism.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from implicit_depth_tpu_torch.config import Config
from implicit_depth_tpu_torch.data.loader import BatchLoader
from implicit_depth_tpu_torch.data.mvs_dataset import BDSamplingConfig
from implicit_depth_tpu_torch.data.registry import get_dataset
from implicit_depth_tpu_torch.eval import binary_metrics as bm
from implicit_depth_tpu_torch.models.bd_net import BDNet
from implicit_depth_tpu_torch.models.depth_net import DepthNet
from implicit_depth_tpu_torch.ops import image as image_ops
from implicit_depth_tpu_torch.train import losses as loss_lib
from implicit_depth_tpu_torch.train import state as state_lib
from implicit_depth_tpu_torch.weights import init_params, lazy_load_state_dict, load_state_dict

KINDS = ("bd", "regression")


def build_net(cfg: Config, kind: str = "bd"):
    """The model of a config, with bf16 compute at precision 16: BDNet for
    kind "bd", DepthNet for kind "regression". Raises NotImplementedError
    for parts the port does not have yet."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    common = dict(
        image_encoder_name=cfg.image_encoder_name,
        matching_scale=cfg.matching_scale,
        matching_feature_dims=cfg.matching_feature_dims,
        num_depth_bins=cfg.matching_num_depth_bins,
        num_src_views=cfg.num_src_views,
        min_matching_depth=cfg.min_matching_depth,
        max_matching_depth=cfg.max_matching_depth,
        compute_dtype=torch.bfloat16 if cfg.precision == 16 else torch.float32,
    )
    if kind == "regression":
        return DepthNet(feature_volume_type=cfg.feature_volume_type,
                        depth_decoder_name=cfg.depth_decoder_name,
                        matching_encoder_type=cfg.matching_encoder_type, **common)
    if (cfg.depth_decoder_name, cfg.matching_encoder_type) != ("unet_pp", "resnet"):
        raise NotImplementedError("the port's BD model runs the U-Net++ decoder and the ResNet "
                                  "matching encoder")
    return BDNet(feature_volume_type=cfg.feature_volume_type, use_prior=cfg.use_prior,
                 bd_sigmoid_multiplier=cfg.bd_sigmoid_multiplier, **common)


def build_dataset(cfg: Config, split: str, kind: str = "bd", limit_to_scan_id=None,
                  pass_frame_id: bool = False):
    """The dataset of a config (the JAX package's numpy datasets), with the
    BD keys (rays and samples, or rendered query depths) for kind "bd"."""
    cls, _ = get_dataset(cfg.dataset, None, None)
    kwargs = dict(
        pass_frame_id=pass_frame_id,
        split=split,
        image_height=cfg.image_height,
        image_width=cfg.image_width,
        shuffle_tuple=cfg.shuffle_tuple,
        get_bd_info=kind == "bd",
        full_depth_supervision=cfg.full_depth_supervision,
        bd_config=BDSamplingConfig(
            num_rays=cfg.num_rays,
            samples_per_ray=cfg.samples_per_ray,
            near_surface_ratio=cfg.near_surface_ratio,
            surface_noise_type=cfg.surface_noise_type,
        ),
        include_full_res_depth=cfg.high_res_validation,
    )
    if cfg.dataset == "synthetic":
        return cls(num_views=cfg.model_num_views, num_frames=cfg.synthetic_num_frames, **kwargs)
    if cfg.dataset == "hypersim":
        kwargs["use_min_max_depth"] = cfg.use_min_max_depth
    return cls(dataset_path=cfg.dataset_path,
               mv_tuple_file_suffix=cfg.mv_tuple_file_suffix,
               tuple_info_file_location=cfg.tuple_info_file_location,
               num_images_in_tuple=cfg.num_images_in_tuple or cfg.model_num_views,
               limit_to_scan_id=limit_to_scan_id,
               skip_frames=cfg.skip_frames, **kwargs)


def batch_to_device(batch, device: torch.device) -> tuple[dict, dict]:
    """A collated numpy (cur, src) batch as tensors on `device`."""
    return tuple({k: torch.as_tensor(v).to(device) for k, v in d.items()
                  if k != "frame_id_string"} for d in batch)


def _bd_val_metrics(net: BDNet, cfg: Config, cur: dict, src: dict) -> dict:
    pred = torch.sigmoid(cfg.bd_sigmoid_multiplier * net.forward_val(cur, src)["pred_0"].float())
    return bm.legacy_and_new_iou(cur["rendered_depth"], cur["depth"], pred)


def _regression_val_metrics(net: DepthNet, cfg: Config, cur: dict, src: dict) -> dict:
    """The regression losses of the eval-mode forward (the JAX package's
    regression val_step); the losses in f32, outside autocast."""
    out = dict(net(cur, src))
    with torch.autocast(cur["image"].device.type, enabled=False):
        cur = dict(cur)
        invK = cur["invK_s0"].float()
        depth = torch.where(cur["mask"], cur["depth"].float(), float("nan"))
        cur["normals"] = image_ops.normals_from_depth(torch.nan_to_num(depth, nan=0.0), invK)
        out["normals_pred"] = image_ops.normals_from_depth(out["depth_pred_0"], invK)
        return loss_lib.regression_losses(cur, src, out, dataset=cfg.dataset)


def validate(net, cfg: Config, val_ds, device: torch.device, kind: str = "bd") -> dict:
    """NaN-skipping mean over up to cfg.val_batches batches of the kind's
    validation metrics (eval mode, the config's compute dtype): BD IoUs or
    the regression losses."""
    metrics_fn = _bd_val_metrics if kind == "bd" else _regression_val_metrics
    loader = BatchLoader(val_ds, cfg.val_batch_size, shuffle=False,
                         num_workers=cfg.num_workers, epochs=1)
    cdt = net.compute_dtype
    seen: dict = {}
    net.eval()
    with torch.no_grad(), torch.autocast(device.type, dtype=cdt, enabled=cdt != torch.float32):
        for bi, batch in enumerate(iter(loader)):
            if bi >= cfg.val_batches:
                loader.stop()
                break
            cur, src = batch_to_device(batch, device)
            for k, v in metrics_fn(net, cfg, cur, src).items():
                seen.setdefault(k, []).append(float(v))
    net.train()
    return {f"val/{k}": float(np.nanmean(v)) for k, v in seen.items()}


def fit(cfg: Config, kind: str = "bd", device: str = "cuda", max_steps: Optional[int] = None,
        log_cb: Optional[Callable] = None) -> dict:
    """Trains the model of `cfg` (kind "bd" or "regression") on one device.
    Returns {"step", "losses" (the last step's), "val" (the last
    validation), "checkpoint" (the last file written)}. Refuses --resume and
    --jax_distributed, which the port does not have yet."""
    for flag in ("resume", "jax_distributed"):
        if getattr(cfg, flag):
            raise NotImplementedError(f"--{flag} is not ported: fit trains one process from "
                                      "step 0")
    max_steps = max_steps or cfg.max_steps
    dev = torch.device(device)
    net = init_params(build_net(cfg, kind), torch.Generator().manual_seed(cfg.random_seed))
    if cfg.load_weights_from_checkpoint:
        state = torch.load(cfg.load_weights_from_checkpoint, map_location="cpu", weights_only=True)
        load_state_dict(net, state.get("model", state))
    elif cfg.lazy_load_weights_from_checkpoint:
        state = torch.load(cfg.lazy_load_weights_from_checkpoint, map_location="cpu",
                           weights_only=True)
        n = lazy_load_state_dict(net, state.get("model", state))
        print(f"lazy-loaded {n} of {len(net.state_dict())} tensors from "
              f"{cfg.lazy_load_weights_from_checkpoint}")
    net.to(dev).train()

    train_ds = build_dataset(cfg, "train", kind)
    val_ds = build_dataset(cfg, "val", kind)
    loader = BatchLoader(train_ds, cfg.batch_size, num_workers=cfg.num_workers,
                         seed=cfg.random_seed)
    opt, sched = state_lib.make_optimizer(net.parameters(), cfg.lr, cfg.wd, cfg.lr_steps)
    gen = torch.Generator().manual_seed(cfg.random_seed + 2)
    if kind == "bd":
        step_fn = state_lib.make_bd_train_step(
            net, opt, sched, pos_weight=cfg.binary_loss_positive_weight,
            regularisation_weight=cfg.bd_regularisation_weight,
            edge_regularisation=cfg.bd_edge_regularision, generator=gen)
    else:
        step_fn = state_lib.make_regression_train_step(net, opt, sched, dataset=cfg.dataset,
                                                       generator=gen)
    ckpt_dir = os.path.join(cfg.log_dir, cfg.name, "checkpoints")

    def save(step: int) -> str:
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.join(ckpt_dir, f"step_{step:08d}.pt")
        torch.save({"model": net.state_dict(), "optimizer": opt.state_dict(), "step": step},
                   path)
        return path

    step, losses, vm, ckpt = 0, {}, {}, None
    t0 = time.perf_counter()
    it = iter(loader)
    while step < max_steps:
        try:
            batch = next(it)
        except StopIteration:
            it = iter(loader)
            batch = next(it)
        losses = step_fn(batch_to_device(batch, dev))
        step += 1
        if step % cfg.log_interval == 0:
            scalars = {f"train/{k}": float(v) for k, v in losses.items()}
            scalars["train/steps_per_sec"] = cfg.log_interval / max(time.perf_counter() - t0, 1e-9)
            scalars.update({f"data/{k}": float(v) for k, v in loader.stats().items()})
            t0 = time.perf_counter()
            if log_cb:
                log_cb(step, scalars)
        if step % cfg.val_interval == 0 or step >= max_steps:
            vm = validate(net, cfg, val_ds, dev, kind)
            if log_cb and vm:
                log_cb(step, vm)
            ckpt = save(step)
    loader.stop()
    return {"step": step, "losses": {k: float(v) for k, v in losses.items()}, "val": vm,
            "checkpoint": ckpt}
