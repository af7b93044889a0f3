"""The reference training steps in f32: the BD step and the regression
step of implicit_depth_tpu_torch/train/state.py written out plainly over
the frozen nets and losses, with AdamW's arithmetic by hand (torch.optim's
AdamW: decoupled decay, then the bias-corrected update), and a record of
what the benchmark compares: each step's loss, the first step's gradient
norm of every parameter, and every parameter's change after the steps."""

from __future__ import annotations

import contextlib
import math

import torch

from port_bench.reference import image as image_ops
from port_bench.reference import losses as loss_lib
from port_bench.reference.sampling import grid_sample

Tensor = torch.Tensor


class AdamW:
    """torch.optim.AdamW(lr, betas=(0.9, 0.999), eps=1e-8, weight_decay)
    at a constant rate, every parameter stepped (a missing gradient is 0)."""

    def __init__(self, named_params, lr: float, wd: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = dict(named_params)
        self.lr, self.wd, self.betas, self.eps = lr, wd, betas, eps
        self.m = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.t = 0

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        b1, b2 = self.betas
        bc1, bc2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for k, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.mul_(1.0 - self.lr * self.wd)
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(bc2)).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)


def edge_mask_at_rays(gt_depth: Tensor, rays: Tensor) -> Tensor:
    hg, wg = gt_depth.shape[1], gt_depth.shape[2]
    edge = image_ops.get_edge_mask(gt_depth)
    grid = torch.stack([(rays[..., 0] / wg - 0.5) * 2, (rays[..., 1] / hg - 0.5) * 2], -1)
    return grid_sample(edge, grid[:, :, None], mode="nearest")[:, :, 0, 0][..., None]


def bd_loss(net, batch, flip: bool, config: dict, forward_ctx=contextlib.nullcontext) -> Tensor:
    cur, src = batch
    edge = None
    if config.get("bd_edge_regularision", True):
        with torch.no_grad():
            edge = edge_mask_at_rays(cur["gt_depth"].float(), cur["sampled_rays"])
    net.train()
    with forward_ctx():
        out = net(cur, src, flip=flip)
    preds = {k: v for k, v in out.items() if k.startswith("pred_")}
    return loss_lib.binary_losses(
        out["query_depth"], out["target_depth"][..., None], preds,
        pos_weight=config.get("binary_loss_positive_weight", 1.0),
        regularisation_weight=config.get("bd_regularisation_weight", 0.5),
        edge_mask=edge)["loss"]


def regression_loss(net, batch, flip: bool, config: dict,
                    forward_ctx=contextlib.nullcontext) -> Tensor:
    cur, src = batch
    cur = dict(cur)
    with torch.no_grad():
        depth = torch.where(cur["mask"], cur["depth"].float(), float("nan"))
        cur["normals"] = image_ops.normals_from_depth(torch.nan_to_num(depth, nan=0.0),
                                                      cur["invK_s0"].float())
    net.train()
    with forward_ctx():
        out = dict(net(cur, src, flip=flip))
    out["normals_pred"] = image_ops.normals_from_depth(out["depth_pred_0"], cur["invK_s0"].float())
    return loss_lib.regression_losses(cur, src, out, dataset=config.get("dataset", "scannet"))["loss"]


LOSSES = {"bd": bd_loss, "regression": regression_loss}


class TrainRecord:
    """What the benchmark compares of the first steps of a training run:
    losses (one float a step), grad_norms (the first step's gradient norm
    of every parameter), change_norms (each parameter's distance from its
    start after the steps), stat_norms (each batch-norm running
    statistic's distance from its start after the steps)."""

    def __init__(self, losses, grad_norms: dict, change_norms: dict, stat_norms: dict):
        self.losses = list(losses)
        self.grad_norms = dict(grad_norms)
        self.change_norms = dict(change_norms)
        self.stat_norms = dict(stat_norms)


def norms(tensors: dict) -> dict:
    names = list(tensors)
    if not names:
        return {}
    vals = torch.stack([t.detach().float().norm() for t in tensors.values()]).cpu().tolist()
    return dict(zip(names, vals))


def running_stats(net) -> dict:
    """The batch-norm running statistics of a net, by name."""
    return {k: b for k, b in net.named_buffers() if k.endswith(("running_mean", "running_var"))}


def run_steps(net, batches, flips, config: dict, forward_ctx=contextlib.nullcontext) -> TrainRecord:
    """len(batches) reference steps from the net's current weights;
    `forward_ctx` wraps each forward (the control's bf16 autocast)."""
    loss_fn = LOSSES[config["kind"]]
    params = dict(net.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    stats0 = {k: b.clone() for k, b in running_stats(net).items()}
    opt = AdamW(params.items(), lr=config["lr"], wd=config["wd"])
    losses, grad_norms = [], {}
    for i, (batch, flip) in enumerate(zip(batches, flips)):
        opt.zero_grad()
        loss = loss_fn(net, batch, bool(flip), config, forward_ctx)
        loss.backward()
        if i == 0:
            grad_norms = norms({k: p.grad if p.grad is not None else torch.zeros_like(p)
                                for k, p in params.items()})
        opt.step()
        losses.append(float(loss.detach()))
    change = norms({k: p.detach() - start[k] for k, p in params.items()})
    stats = norms({k: b - stats0[k] for k, b in running_stats(net).items()})
    return TrainRecord(losses, grad_norms, change, stats)
