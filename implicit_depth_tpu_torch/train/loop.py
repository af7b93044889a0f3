"""Training orchestration, counterpart of implicit_depth_tpu/train/loop.py:
`build_net` and `build_dataset` (shared with the eval CLIs), and `fit`, the
training loop of the BD model (kind "bd") or DepthNet (kind "regression"),
in one process or data parallel over several.

fit wires: dataset -> the port's BatchLoader (this rank's rows of each
global batch) -> the kind's train step -> scalars every log_interval steps
-> validation every val_interval steps and at the end (BD: `forward_val` +
`legacy_and_new_iou`; regression: `regression_losses` of the eval-mode
forward; over the global validation batch) -> the CheckpointManager (top-3
on val/harmonic_iou, max, for BD and on val/loss, min, for regression; a
`last` link; async writes) and the ExperimentLogger, both on rank 0 only.

- Weights: load_weights_from_checkpoint (strict) or
  lazy_load_weights_from_checkpoint (every entry whose name and shape
  match, weights.lazy_load_state_dict) take a checkpoint directory, a
  weights-only file or a {model, ...} file (checkpoint.load_weights).
- Resume: --resume <checkpoint directory> restores the model, optimizer,
  scheduler and step, and the loader skips the batches already taken
  (start_batch = the step in meta.json, or state.pt's). The training
  items' random draws (the rays and samples, the train flip of the
  dataset) come from an rng of each item's own, seeded with (random_seed,
  epoch, index) (`EpochSeededLoader`): the JAX package's datasets draw
  them from one stream per dataset, in the order its loader threads happen
  to call, so its resumed run (and any run with several loader threads)
  takes the same tuples but other draws. Here a resumed run, a run with
  any number of threads and the ranks of a data-parallel run take the
  same batches, bit for bit, as one uninterrupted process. As in the JAX
  package, which rebuilds its step key from PRNGKey(seed + 2) at every
  call, the flip generator starts again from seed + 2: a resumed run does
  not replay the flips an uninterrupted run would draw after the resume
  point (pass train_flip=False to compare the two).
- Data parallel (--jax_distributed with --coordinator_address,
  --distributed_num_processes and --distributed_process_id; see
  parallel/distributed.py): each rank steps on its rows of the global
  batch cfg.batch_size, on cuda:{rank % device_count} (or the CPU), and
  the ranks meet at a barrier before the first step.
"""

from __future__ import annotations

import copy
import dataclasses
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
from implicit_depth_tpu_torch.parallel import distributed
from implicit_depth_tpu_torch.train import checkpoint as ckpt_lib
from implicit_depth_tpu_torch.train import losses as loss_lib
from implicit_depth_tpu_torch.train import state as state_lib
from implicit_depth_tpu_torch.train.logging import ExperimentLogger, copy_code_state
from implicit_depth_tpu_torch.utils.profiling import span
from implicit_depth_tpu_torch.weights import init_params, lazy_load_state_dict, load_state_dict

KINDS = ("bd", "regression")


def build_net(cfg: Config, kind: str = "bd"):
    """The model of a config, with bf16 compute at precision 16: BDNet for
    kind "bd", DepthNet for kind "regression". The encoders and the decoder
    come from the config's names (image_encoder_name, matching_encoder_type,
    depth_decoder_name); an unknown image encoder or decoder is a
    ValueError, a volume type the port lacks a NotImplementedError."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    common = dict(
        image_encoder_name=cfg.image_encoder_name,
        feature_volume_type=cfg.feature_volume_type,
        depth_decoder_name=cfg.depth_decoder_name,
        matching_encoder_type=cfg.matching_encoder_type,
        matching_scale=cfg.matching_scale,
        matching_feature_dims=cfg.matching_feature_dims,
        num_depth_bins=cfg.matching_num_depth_bins,
        num_src_views=cfg.num_src_views,
        min_matching_depth=cfg.min_matching_depth,
        max_matching_depth=cfg.max_matching_depth,
        compute_dtype=torch.bfloat16 if cfg.precision == 16 else torch.float32,
    )
    if kind == "regression":
        return DepthNet(**common)
    return BDNet(use_prior=cfg.use_prior, bd_sigmoid_multiplier=cfg.bd_sigmoid_multiplier,
                 **common)


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


class _SeededItems:
    """dataset[(epoch, index)] is dataset[index] drawn with an rng of its
    own, RandomState((seed, epoch, index)), on a shallow copy of the
    dataset (its caches shared)."""

    def __init__(self, dataset, seed: int):
        self.dataset = dataset
        self.seed = seed

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, key):
        epoch, index = (int(k) for k in key)
        item = copy.copy(self.dataset)
        item.rng = np.random.RandomState([self.seed, epoch, index])
        return item[index]


class EpochSeededLoader(BatchLoader):
    """The BatchLoader over a dataset whose items draw from their own rng
    (_SeededItems): the epoch order is the BatchLoader's, each entry paired
    with its epoch."""

    def __init__(self, dataset, batch_size: int, seed: int = 0, **kwargs):
        super().__init__(_SeededItems(dataset, seed), batch_size, seed=seed, **kwargs)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        order = super()._epoch_order(epoch)
        return np.stack([np.full_like(order, epoch), order], axis=1)


def batch_to_device(batch, device: torch.device) -> tuple[dict, dict]:
    """A collated numpy (cur, src) batch as tensors on `device`."""
    with span("idt.upload"):
        return tuple({k: torch.as_tensor(v).to(device) for k, v in d.items()
                      if k != "frame_id_string"} for d in batch)


def _bd_val_metrics(net: BDNet, cfg: Config, cur: dict, src: dict) -> tuple:
    """The IoUs of the global validation batch (each rank's rows gathered)
    and this rank's prediction."""
    pred = torch.sigmoid(cfg.bd_sigmoid_multiplier * net.forward_val(cur, src)["pred_0"].float())
    query, gt, pred_all = (distributed.gather_rows(t)
                           for t in (cur["rendered_depth"], cur["depth"], pred))
    return bm.legacy_and_new_iou(query, gt, pred_all), pred


def _regression_val_metrics(net: DepthNet, cfg: Config, cur: dict, src: dict) -> tuple:
    """The regression losses of the eval-mode forward (the JAX package's
    regression val_step; global ratios in a process group), in f32 outside
    autocast, and the predicted depth."""
    out = dict(net(cur, src))
    with torch.autocast(cur["image"].device.type, enabled=False):
        cur = dict(cur)
        invK = cur["invK_s0"].float()
        depth = torch.where(cur["mask"], cur["depth"].float(), float("nan"))
        cur["normals"] = image_ops.normals_from_depth(torch.nan_to_num(depth, nan=0.0), invK)
        out["normals_pred"] = image_ops.normals_from_depth(out["depth_pred_0"], invK)
        return loss_lib.regression_losses(cur, src, out, dataset=cfg.dataset), out["depth_pred_0"]


def _log_bd_panels(logger: ExperimentLogger, step: int, cur: dict, pred: torch.Tensor) -> None:
    """Validation image panels (the JAX package's _log_bd_panels,
    bd_model.py:558-645): input RGB, GT depth, binary target and
    prediction at the first query plane, for up to 4 batch elements. Only
    with a writer: colormap_image needs matplotlib, which a training
    machine need not have."""
    if logger.tb is None:
        return
    from implicit_depth_tpu_torch.data.mvs_dataset import reverse_imagenet_normalize
    from implicit_depth_tpu_torch.utils.visualization import (colormap_image,
                                                               prepare_image_for_logging)

    image, depth, rendered = (cur[k].float().cpu().numpy()
                              for k in ("image", "depth", "rendered_depth"))
    pred = pred.float().cpu().numpy()
    for j in range(min(image.shape[0], 4)):
        logger.log_image(step, f"val/image/{j}",
                         np.clip(reverse_imagenet_normalize(image[j]), 0, 1))
        logger.log_image(step, f"val/depth/{j}", colormap_image(depth[j, ..., 0]))
        mask = (np.nan_to_num(depth[j, ..., 0]) > 0) & (rendered[j, ..., 0] > 0)
        target = (rendered[j, ..., 0] < depth[j, ..., 0]) & mask
        logger.log_image(step, f"val/target/{j}",
                         prepare_image_for_logging(target.astype(np.float32), normalize=False))
        logger.log_image(step, f"val/pred/{j}",
                         prepare_image_for_logging(pred[j, ..., 0] * mask, normalize=False))


def validate(net, cfg: Config, val_ds, device: torch.device, kind: str = "bd",
             logger: Optional[ExperimentLogger] = None, step: int = 0) -> dict:
    """NaN-skipping mean over up to cfg.val_batches batches of the kind's
    validation metrics (eval mode, the config's compute dtype): BD IoUs or
    the regression losses, each of the global batch (every rank loads its
    rows, as in training). With a logger, BD's first batch is also logged
    as image panels (one process only, as the JAX package)."""
    metrics_fn = _bd_val_metrics if kind == "bd" else _regression_val_metrics
    pid, pcount = distributed.process_info()
    loader = BatchLoader(val_ds, cfg.val_batch_size, shuffle=False,
                         num_workers=cfg.num_workers, epochs=1, shard_id=pid, num_shards=pcount)
    cdt = net.compute_dtype
    seen: dict = {}
    net.eval()
    with torch.no_grad(), torch.autocast(device.type, dtype=cdt, enabled=cdt != torch.float32):
        for bi, batch in enumerate(iter(loader)):
            if bi >= cfg.val_batches:
                loader.stop()
                break
            cur, src = batch_to_device(batch, device)
            metrics, pred = metrics_fn(net, cfg, cur, src)
            for k, v in metrics.items():
                seen.setdefault(k, []).append(float(v))
            if kind == "bd" and bi == 0 and logger is not None and pcount == 1:
                _log_bd_panels(logger, step, cur, pred)
    net.train()
    return {f"val/{k}": float(np.nanmean(v)) for k, v in seen.items()}


def resume_step_of(path: str) -> int:
    """The step a checkpoint directory was saved at: meta.json's, else the
    one in state.pt (a hand-built checkpoint may lack meta.json's)."""
    try:
        meta = ckpt_lib.load_meta(path)
        return int(meta.get("step", meta["metrics"]["step"]))
    except (OSError, KeyError, ValueError, TypeError):
        step = ckpt_lib.peek_step(path)
        print(f"resume: meta.json lacks 'step'; the data-order offset is state.pt's step {step}")
        return step


def fit(cfg: Config, kind: str = "bd", device: str = "cuda", max_steps: Optional[int] = None,
        log_cb: Optional[Callable] = None, batch_cb: Optional[Callable] = None,
        train_flip: bool = True) -> dict:
    """Trains the model of `cfg` (kind "bd" or "regression"); data parallel
    with cfg.jax_distributed. log_cb(step, scalars) sees every logged
    scalar dict and batch_cb(step, batch) every numpy batch before its
    step (step = the step it makes, from 1). Returns {"step", "losses"
    (the last step's), "val" (the last validation), "checkpoint" (the last
    checkpoint directory saved, on rank 0), "log_dir"}."""
    max_steps = max_steps or cfg.max_steps
    if cfg.jax_distributed:
        distributed.initialize(cfg.coordinator_address, cfg.distributed_num_processes,
                               cfg.distributed_process_id, device=device)
    pid, pcount = distributed.process_info()
    dev = distributed.local_device(device)
    resume_step = resume_step_of(cfg.resume) if cfg.resume else 0
    net = init_params(build_net(cfg, kind), torch.Generator().manual_seed(cfg.random_seed))
    if cfg.load_weights_from_checkpoint:
        load_state_dict(net, ckpt_lib.load_weights(cfg.load_weights_from_checkpoint))
    elif cfg.lazy_load_weights_from_checkpoint:
        n = lazy_load_state_dict(net, ckpt_lib.load_weights(cfg.lazy_load_weights_from_checkpoint))
        print(f"lazy-loaded {n} of {len(net.state_dict())} tensors from "
              f"{cfg.lazy_load_weights_from_checkpoint}")
    net.to(dev).train()
    opt, sched = state_lib.make_optimizer(net.parameters(), cfg.lr, cfg.wd, cfg.lr_steps)
    step = 0
    if cfg.resume:
        step = ckpt_lib.restore_state(cfg.resume, net, opt, sched)
        if step != resume_step:
            raise ValueError(f"{cfg.resume}: state.pt holds step {step}, meta.json "
                             f"{resume_step}")

    train_ds = build_dataset(cfg, "train", kind)
    val_ds = build_dataset(cfg, "val", kind)
    # the epoch order is a pure function of (seed, epoch): a resumed run
    # skips the batches already taken at the index level
    loader = EpochSeededLoader(train_ds, cfg.batch_size, seed=cfg.random_seed,
                               num_workers=cfg.num_workers, start_batch=step, shard_id=pid,
                               num_shards=pcount)
    gen = torch.Generator().manual_seed(cfg.random_seed + 2)
    if kind == "bd":
        step_fn = state_lib.make_bd_train_step(
            net, opt, sched, pos_weight=cfg.binary_loss_positive_weight,
            regularisation_weight=cfg.bd_regularisation_weight,
            edge_regularisation=cfg.bd_edge_regularision, train_flip=train_flip, generator=gen)
    else:
        step_fn = state_lib.make_regression_train_step(net, opt, sched, dataset=cfg.dataset,
                                                       train_flip=train_flip, generator=gen)

    # logging, code snapshot and checkpoints: rank 0 only
    logger = mgr = None
    monitor, mode = ("val/harmonic_iou", "max") if kind == "bd" else ("val/loss", "min")
    if pid == 0:
        logger = ExperimentLogger(cfg.log_dir, cfg.name)
        try:
            copy_code_state(os.path.join(logger.dir, "code"))
        except OSError as e:
            print(f"code snapshot failed: {e}")
        mgr = ckpt_lib.CheckpointManager(os.path.join(logger.dir, "checkpoints"),
                                         monitor=monitor, mode=mode, async_write=True)
    cfg_dict = dataclasses.asdict(cfg)

    def log(step_i: int, scalars: dict) -> None:
        if logger is not None:
            logger.log_scalars(step_i, scalars)
        if log_cb:
            log_cb(step_i, scalars)

    losses, vm, ckpt = {}, {}, None
    # align the ranks before the first collective (the first step's):
    # per-rank loader and build skew must not land inside its timeout
    distributed.barrier("pre_first_step")
    t0 = time.perf_counter()
    it = iter(loader)
    while step < max_steps:
        try:
            batch = next(it)
        except StopIteration:
            it = iter(loader)
            batch = next(it)
        if batch_cb:
            batch_cb(step + 1, batch)
        losses = step_fn(batch_to_device(batch, dev))
        step += 1
        if step % cfg.log_interval == 0:
            scalars = {f"train/{k}": float(v) for k, v in losses.items()}
            scalars["train/steps_per_sec"] = cfg.log_interval / max(time.perf_counter() - t0, 1e-9)
            scalars.update({f"data/{k}": float(v) for k, v in loader.stats().items()})
            t0 = time.perf_counter()
            log(step, scalars)
        if step % cfg.val_interval == 0 or step >= max_steps:
            vm = validate(net, cfg, val_ds, dev, kind, logger=logger, step=step)
            if vm:
                log(step, vm)
            if mgr is not None:
                metrics = dict(vm or {monitor: 0.0})
                metrics["step"] = step  # recorded for the data-order resume
                ckpt = mgr.save(net, opt, sched, step=step, config=cfg_dict, metrics=metrics)
    loader.stop()
    if mgr is not None:
        mgr.wait()  # join the in-flight write
    if logger is not None:
        logger.close()
    return {"step": step, "losses": {k: float(v) for k, v in losses.items()}, "val": vm,
            "checkpoint": ckpt, "log_dir": None if logger is None else logger.dir}
