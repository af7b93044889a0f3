"""The benchmark's calls into the program under test, the PyTorch and
CUDA port `implicit_depth_tpu_torch`: its kernels' build, its net from a
benchmark configuration, its upload, and the timed entries each driver
uses. Everything of the program that a run touches goes through here; the
reference (port_bench/reference) never does."""

from __future__ import annotations

import torch


def port_config(config: dict):
    """The port's Config from the benchmark configuration's keys that it has."""
    from implicit_depth_tpu_torch.config import Config

    fields = Config.__dataclass_fields__
    return Config(**{k: v for k, v in config.items() if k in fields})


def build_kernels() -> None:
    """Compiles the port's CUDA kernels (or finds them built in
    implicit_depth_tpu_torch/csrc/build/ from an earlier run)."""
    from implicit_depth_tpu_torch.ops import cuda_build

    cuda_build.build()


def build_net(config: dict):
    """The port's net of a configuration (train/loop.py::build_net), on the CPU."""
    from implicit_depth_tpu_torch.train.loop import build_net as port_build_net

    return port_build_net(port_config(config), config["kind"])


def batch_to_device(batch, device):
    """The port's upload of a host (cur, src) batch (train/loop.py::batch_to_device)."""
    from implicit_depth_tpu_torch.train.loop import batch_to_device as port_upload

    return port_upload(batch, device)


def eval_forward(net, config: dict):
    """The eval frame's forward: (cur, src) on the device -> the answer
    tensor on the device. BD: eval/occlusion_eval.py::make_forward_fn
    (forward_val, the sigmoid matte (b, h0, w0, P)); regression:
    DepthNet.forward's depth_pred_0 (b, h0, w0, 1)."""
    if config["kind"] == "bd":
        from implicit_depth_tpu_torch.eval.occlusion_eval import make_forward_fn

        return make_forward_fn(net, sigmoid_multiplier=config.get("bd_sigmoid_multiplier", 1.0))
    return lambda cur, src: net(cur, src)["depth_pred_0"]


def train_step(net, config: dict, seed: int):
    """(step, optimizer): the port's training step of the configuration's
    kind (train/state.py) over make_optimizer's AdamW and schedule;
    step(batch, flip) -> the detached losses."""
    from implicit_depth_tpu_torch.train import state

    cfg = port_config(config)
    opt, sched = state.make_optimizer(net.parameters(), lr=cfg.lr, wd=cfg.wd,
                                      lr_steps=cfg.lr_steps)
    gen = torch.Generator().manual_seed(seed)
    if config["kind"] == "bd":
        step = state.make_bd_train_step(
            net, opt, sched, pos_weight=cfg.binary_loss_positive_weight,
            regularisation_weight=cfg.bd_regularisation_weight,
            edge_regularisation=cfg.bd_edge_regularision, generator=gen)
    else:
        step = state.make_regression_train_step(net, opt, sched, dataset=cfg.dataset,
                                                generator=gen)
    return (lambda batch, flip: step(batch, flip=bool(flip))), opt
