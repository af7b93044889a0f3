"""Optimizer and the training steps, counterpart of
implicit_depth_tpu/train/state.py (make_optimizer, make_bd_train_step,
make_regression_train_step).

- AdamW (decoupled weight decay, eps 1e-8, on every parameter, as optax's
  `adamw` with a schedule; a parameter that backward leaves without a
  gradient, such as the FPN's `lateral_0`, gets a zero one, so that it is
  decayed and counted as optax does: `fill_missing_grads`) and the stepped learning rate x1 / x0.1 / x0.01
  at lr_steps, with optax.piecewise_constant_schedule's boundaries: the
  update with index i (0-based) runs at the rate for i, scaled by 0.1 once
  i >= lr_steps[0] and again once i >= lr_steps[1].
- The BD step: flip ~ Bernoulli(0.5) from the step's torch.Generator (or
  given), for a net with the prior the augmentation's uniform draws from a
  second generator on the batch's device (or given), the edge mask of
  gt_depth sampled at the rays (nearest), the train forward with batch norm
  in train mode, `binary_losses`, backward, optimizer step.
- The regression step: the same flip draw, GT normals from the NaN-masked
  depth, DepthNet's train forward, predicted normals from depth_pred_0,
  `regression_losses`, backward, optimizer step.

Data parallel (parallel/distributed.py): in a process group of more than
one rank each rank steps on its rows of the global batch. Batch norm and
the losses reduce over the global batch, the flip is one draw that every
rank makes alike (the same seed), the prior's draws are made for the
global batch and each rank takes its rows, and the gradients are averaged
over the ranks before the optimizer step: one logical step on the global
batch, as the JAX step on a batch sharded over processes.

Mixed precision: parameters stay f32; at bf16 compute the conv and dense
stacks run under torch.autocast(dtype=bfloat16), the counterpart of flax's
f32 params with `dtype=bfloat16`. The models keep the pose products and the
volume geometry in f32 (autocast off there), and the kernels take the
features in bf16 as their contracts say. The losses run in f32, outside
autocast.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from implicit_depth_tpu_torch.core.sampling import grid_sample
from implicit_depth_tpu_torch.models.bd_net import draw_prior_noise
from implicit_depth_tpu_torch.ops import image as image_ops
from implicit_depth_tpu_torch.parallel import distributed
from implicit_depth_tpu_torch.train import losses as loss_lib
from implicit_depth_tpu_torch.utils.profiling import span

Tensor = torch.Tensor


def stepped_lr(lr_steps) -> Callable[[int], float]:
    """The factor on the base rate for the update with index i."""
    s0, s1 = int(lr_steps[0]), int(lr_steps[1])
    return lambda i: (0.1 if i >= s0 else 1.0) * (0.1 if i >= s1 else 1.0)


def make_optimizer(params, lr: float = 1e-4, wd: float = 1e-4, lr_steps=(70000, 80000)):
    """(AdamW, LambdaLR) over `params`; call the scheduler's step() after
    every optimizer step."""
    opt = torch.optim.AdamW(params, lr=lr, weight_decay=wd, eps=1e-8, betas=(0.9, 0.999))
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, stepped_lr(lr_steps))


def fill_missing_grads(params) -> None:
    """Gives every trainable parameter whose .grad is None a zero gradient.
    torch's AdamW skips such a parameter (no weight decay, no step count),
    where optax.adamw decays every parameter, including those whose
    gradient is exactly 0; in a process group it also keeps the ranks'
    gradient all-reduce over the same tensors."""
    for p in params:
        if p.requires_grad and p.grad is None:
            p.grad = torch.zeros_like(p)


def edge_mask_at_rays(gt_depth: Tensor, rays: Tensor) -> Tensor:
    """get_edge_mask(gt_depth) sampled (nearest) at the rays -> (b, N, 1)."""
    hg, wg = gt_depth.shape[1], gt_depth.shape[2]
    edge = image_ops.get_edge_mask(gt_depth)
    grid = torch.stack([(rays[..., 0] / wg - 0.5) * 2, (rays[..., 1] / hg - 0.5) * 2], -1)
    return grid_sample(edge, grid[:, :, None], mode="nearest")[:, :, 0, 0][..., None]


def _draw_flip(gen: torch.Generator, train_flip: bool) -> bool:
    return bool(torch.rand((), generator=gen) < 0.5) if train_flip else False


def make_bd_train_step(net, optimizer, scheduler=None, *, pos_weight: float = 1.0,
                       regularisation_weight: float = 0.5, edge_regularisation: bool = True,
                       train_flip: bool = True,
                       generator: Optional[torch.Generator] = None,
                       forward_only: bool = False) -> Callable:
    """Returns step(batch, flip=None, prior_noise=None) -> losses (detached
    tensors). batch = (cur_data, src_data) tensors on the net's device; flip
    None draws from `generator` (Bernoulli(0.5)) when train_flip is set,
    else no flip. For a net with use_prior, prior_noise None draws the
    prior's augmentation (bd_net.draw_prior_noise, in the compute dtype)
    from a generator on the batch's device, seeded with the flip
    generator's seed + 1; in a process group, for the global batch, of
    which this rank takes its rows.

    forward_only=True is the profilers' probe (cli/profile_train.py), not a
    training mode: the step's exact loss path, with the same draws from
    the generators, under no_grad, and no backward, optimizer or scheduler
    step. Train-mode batch norm moves its running statistics during the
    forward; they are put back, so that the net, the optimizer and the
    scheduler are left bit-equal, as the JAX probe returns its input state.
    For the same generator state it returns the full step's losses.

    The step runs in the span idt.step (utils/profiling.py::SPANS), its
    loss in idt.step.loss, the backward in idt.step.backward and the
    optimizer's work in idt.step.optimizer: twice a step, since zero_grad
    comes before the backward."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    prior_gens: dict = {}  # device -> the prior's generator there

    def step(batch, flip: Optional[bool] = None, prior_noise: Optional[list] = None) -> dict:
        with span("idt.step"):
            return _step(batch, flip, prior_noise)

    def _step(batch, flip: Optional[bool], prior_noise: Optional[list]) -> dict:
        cur_data, src_data = batch
        if flip is None:
            flip = _draw_flip(gen, train_flip)
        if net.use_prior and prior_noise is None:
            dev_t = cur_data["sampled_depths"].device
            if dev_t not in prior_gens:
                prior_gens[dev_t] = torch.Generator(device=dev_t).manual_seed(
                    gen.initial_seed() + 1)
            b, n, s = cur_data["sampled_depths"].shape
            world = distributed.process_info()[1]
            prior_noise = [tuple(distributed.rank_rows(u) for u in pair) for pair in
                           draw_prior_noise((b * world, n, s), net.compute_dtype,
                                            prior_gens[dev_t])]
        edge = None
        if edge_regularisation:
            with torch.no_grad():
                edge = edge_mask_at_rays(cur_data["gt_depth"].float(), cur_data["sampled_rays"])
        net.train()
        if forward_only:
            buffers = {name: b.clone() for name, b in net.named_buffers()}
        cdt = net.compute_dtype
        dev = cur_data["image"].device.type
        with torch.no_grad() if forward_only else contextlib.nullcontext():
            with torch.autocast(dev, dtype=cdt, enabled=cdt != torch.float32):
                out = net(cur_data, src_data, flip=flip, prior_noise=prior_noise)
            preds = {k: v for k, v in out.items() if k.startswith("pred_")}
            with span("idt.step.loss"):
                losses = loss_lib.binary_losses(
                    out["query_depth"], out["target_depth"][..., None], preds,
                    pos_weight=pos_weight, regularisation_weight=regularisation_weight,
                    edge_mask=edge)
        if forward_only:
            with torch.no_grad():
                for name, b in net.named_buffers():
                    b.copy_(buffers[name])
            return {k: v.detach() for k, v in losses.items()}
        with span("idt.step.optimizer"):
            optimizer.zero_grad(set_to_none=True)
        with span("idt.step.backward"):
            losses["loss"].backward()
        with span("idt.step.optimizer"):
            fill_missing_grads(net.parameters())
            distributed.average_gradients(net.parameters())
            optimizer.step()
            if scheduler is not None:
                scheduler.step()
        return {k: v.detach() for k, v in losses.items()}

    return step


def make_regression_train_step(net, optimizer, scheduler=None, *, dataset: str = "scannet",
                               train_flip: bool = True,
                               generator: Optional[torch.Generator] = None) -> Callable:
    """Returns step(batch, flip=None) -> losses (detached tensors) for a
    DepthNet. batch = (cur_data, src_data) tensors on the net's device,
    cur_data with depth (NaN invalid), mask and invK_s0; flip None draws
    from `generator` (Bernoulli(0.5)) when train_flip is set, else no flip.

    The step runs in the spans of make_bd_train_step's: idt.step, the
    predicted normals and the losses in idt.step.loss, idt.step.backward
    and idt.step.optimizer (utils/profiling.py::SPANS)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)

    def step(batch, flip: Optional[bool] = None) -> dict:
        with span("idt.step"):
            return _step(batch, flip)

    def _step(batch, flip: Optional[bool]) -> dict:
        cur_data, src_data = batch
        if flip is None:
            flip = _draw_flip(gen, train_flip)
        cur_data = dict(cur_data)
        with torch.no_grad():
            depth = torch.where(cur_data["mask"], cur_data["depth"].float(), float("nan"))
            cur_data["normals"] = image_ops.normals_from_depth(
                torch.nan_to_num(depth, nan=0.0), cur_data["invK_s0"].float())
        net.train()
        cdt = net.compute_dtype
        dev = cur_data["image"].device.type
        with torch.autocast(dev, dtype=cdt, enabled=cdt != torch.float32):
            out = dict(net(cur_data, src_data, flip=flip))
        with span("idt.step.loss"):
            out["normals_pred"] = image_ops.normals_from_depth(out["depth_pred_0"],
                                                               cur_data["invK_s0"].float())
            losses = loss_lib.regression_losses(cur_data, src_data, out, dataset=dataset)
        with span("idt.step.optimizer"):
            optimizer.zero_grad(set_to_none=True)
        with span("idt.step.backward"):
            losses["loss"].backward()
        with span("idt.step.optimizer"):
            fill_missing_grads(net.parameters())
            distributed.average_gradients(net.parameters())
            optimizer.step()
            if scheduler is not None:
                scheduler.step()
        return {k: v.detach() for k, v in losses.items()}

    return step
