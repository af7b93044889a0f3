"""The half-precision conv stacks run channels_last end to end
(models/blocks.py::conv_memory_format, stack_input).

At bf16 compute BDNet and DepthNet hold their conv weights channels_last
from construction, and each stack's input enters in that layout, so every
conv sees a channels_last input and weight and cuDNN runs its NHWC
kernels with no transpose around them. Forward pre-hooks on every
nn.Conv2d check the layouts in a bf16 eval forward and in a BD and a
regression train step (bf16 autocast), where each conv weight's gradient
must come back channels_last as well. CONV_LAYOUT counts the stacks'
inputs: the image comes channels_last, and the matching images and the
cost volume are the two copies a forward makes. An f32 net keeps torch's
layouts (NCHW weights) and counts nothing. Card test:
tests/test_torch_cuda_kernels.py (`-k channels_last`).
"""

import contextlib

import pytest
import torch

from implicit_depth_tpu_torch.models.bd_net import BDNet
from implicit_depth_tpu_torch.models.depth_net import DepthNet
from implicit_depth_tpu_torch.train import state
from implicit_depth_tpu_torch.utils.fixtures import synthetic_bd_batch
from implicit_depth_tpu_torch.utils.profiling import CONV_LAYOUT
from implicit_depth_tpu_torch.weights import init_params

CL = torch.channels_last
K, D_BINS, H, W = 2, 8, 32, 64


@contextlib.contextmanager
def conv_layouts(net: torch.nn.Module):
    """Yields a list that gathers, for each nn.Conv2d call, its name and
    whether its input and its weight were channels_last."""
    seen: list = []
    handles = []
    for name, m in net.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            def hook(mod, args, name=name):
                seen.append((name, args[0].is_contiguous(memory_format=CL),
                             mod.weight.is_contiguous(memory_format=CL)))
            handles.append(m.register_forward_pre_hook(hook))
    try:
        yield seen
    finally:
        for h in handles:
            h.remove()


def _batch(device="cpu"):
    cur, src = synthetic_bd_batch(batch=2, num_src=K, height=H, width=W, num_planes=2,
                                  num_rays=64, samples_per_ray=8, seed=1)
    return ({k: torch.tensor(v, device=device) for k, v in cur.items()},
            {k: torch.tensor(v, device=device) for k, v in src.items()})


def _net(kind: str, dtype: torch.dtype) -> torch.nn.Module:
    """The net with torch's default init: the layouts do not hang on the values."""
    cls = DepthNet if kind == "regression" else BDNet
    return cls(num_src_views=K, num_depth_bins=D_BINS, compute_dtype=dtype)


CASES = {"forward_val-f32": ("bd_eval", torch.float32),
         "forward_val-bf16": ("bd_eval", torch.bfloat16),
         "bd_train_step": ("bd", torch.bfloat16),
         "regression_train_step": ("regression", torch.bfloat16)}


def setup_case(case: str, device="cpu") -> tuple:
    """(net, run) of a case on `device`: run() makes one forward_val (f32
    or bf16) or one train step (BD or regression, bf16 under autocast)."""
    kind, dtype = CASES[case]
    net = _net(kind, dtype).to(device)
    batch = _batch(device)
    if kind == "bd_eval":
        net.eval().cast_to_compute_dtype()

        def run():
            with torch.inference_mode():
                return net.forward_val(*batch)
        return net, run
    opt, sched = state.make_optimizer(net.parameters())
    make = state.make_bd_train_step if kind == "bd" else state.make_regression_train_step
    step = make(net, opt, sched)
    return net, lambda: step(batch, flip=True)


def check_layouts(net: torch.nn.Module, seen: list, train: bool) -> None:
    """Every conv of `net` ran, each on a channels_last input and weight;
    after a train step each conv weight's gradient is channels_last too."""
    convs = {name: m for name, m in net.named_modules() if isinstance(m, torch.nn.Conv2d)}
    assert {name for name, _, _ in seen} == set(convs)
    assert [name for name, x_cl, _ in seen if not x_cl] == []
    assert [name for name, _, w_cl in seen if not w_cl] == []
    if train:
        assert [n for n, m in convs.items() if m.weight.grad is None
                or not m.weight.grad.is_contiguous(memory_format=CL)] == []


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_conv_runs_channels_last(case):
    net, run = setup_case(case)
    before = dict(CONV_LAYOUT)
    with conv_layouts(net) as seen:
        run()
    counted = {k: CONV_LAYOUT[k] - before[k] for k in CONV_LAYOUT}
    if case == "forward_val-f32":  # f32 keeps torch's layouts: NCHW weights, no copy
        assert all(m.weight.is_contiguous() for m in net.modules()
                   if isinstance(m, torch.nn.Conv2d))
        assert counted == {"channels_last": 0, "converted": 0}
        return
    check_layouts(net, seen, train=case.endswith("train_step"))
    # the image comes channels_last; the matching images and the volume are copied
    assert counted == {"channels_last": 1, "converted": 2}


def test_seeded_init_does_not_hang_on_the_layout():
    """weights.init_params draws each kernel in index order: a bf16 net
    (channels_last weights) gets the values an f32 net (NCHW) gets."""
    nets = [init_params(BDNet(image_encoder_name="tiny", num_src_views=K, num_depth_bins=D_BINS,
                              compute_dtype=dt), torch.Generator().manual_seed(5))
            for dt in (torch.float32, torch.bfloat16)]
    assert not nets[0].encoder.conv1.weight.is_contiguous(memory_format=CL)
    assert nets[1].encoder.conv1.weight.is_contiguous(memory_format=CL)
    ref = nets[0].state_dict()
    assert all(torch.equal(v, ref[k]) for k, v in nets[1].state_dict().items())
