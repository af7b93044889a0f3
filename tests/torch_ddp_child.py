"""One rank of the data-parallel CPU tests (tests/test_torch_distributed.py).

    python tests/torch_ddp_child.py RANK WORLD PORT INPUTS OUTPUT [DEVICE]

joins a gloo process group of WORLD ranks at 127.0.0.1:PORT, runs every
case of INPUTS (torch.save of {"cases": [...], ...}; see run_case) on this
rank's rows of the global batch on DEVICE (cpu, or cuda: the ranks share
the card), then the barrier cases, and saves {case: result} (on the host)
to OUTPUT. The same run_case, called in one process with no group, gives
the one-process reference. Imports torch and the port only.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from implicit_depth_tpu_torch.models.bd_net import BDNet  # noqa: E402
from implicit_depth_tpu_torch.models.depth_net import DepthNet  # noqa: E402
from implicit_depth_tpu_torch.models.matching import BatchNorm  # noqa: E402
from implicit_depth_tpu_torch.parallel import distributed  # noqa: E402
from implicit_depth_tpu_torch.train import state  # noqa: E402
from implicit_depth_tpu_torch.weights import load_state_dict  # noqa: E402

K, D_BINS, LR, WD = 2, 8, 1e-3, 1e-4
STEP_CASES = {  # case -> (model, flip, use_prior)
    "bd-noflip": ("bd", False, False),
    "bd-flip": ("bd", True, False),
    "bd-prior": ("bd", True, True),
    "regression": ("regression", True, False),
}


def _rows(batch: dict, device: str = "cpu") -> dict:
    return {k: distributed.rank_rows(torch.as_tensor(v)).to(device) for k, v in batch.items()}


def _host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return {k: _host(v) for k, v in tree.items()} if isinstance(tree, dict) else tree


def run_case(case: str, inputs: dict, device: str = "cpu") -> dict:
    """One case on this rank's rows of inputs' global batch (all of it in
    one process): "bn", the port's BatchNorm in train mode (output, running
    statistics, input gradient and the weight gradient summed over the
    ranks of sum(y * w)), or a train step of STEP_CASES (losses, averaged
    gradients, running statistics); results on the host."""
    if case == "bn":
        x = _rows({"x": inputs["bn_x"]}, device)["x"].requires_grad_(True)
        w = _rows({"w": inputs["bn_w"]}, device)["w"]
        bn = BatchNorm(x.shape[1]).to(device)
        bn.train()
        y = bn(x)
        (y * w).sum().backward()
        return _host({"y": y, "x_grad": x.grad,
                      "weight_grad": distributed.global_sum(bn.weight.grad.clone()),
                      "running_mean": bn.running_mean, "running_var": bn.running_var})
    model, flip, use_prior = STEP_CASES[case]
    if model == "bd":
        net = BDNet(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny",
                    use_prior=use_prior)
    else:
        net = DepthNet(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny")
    load_state_dict(net, inputs["state_dicts"][case])
    net.to(device)
    opt, sched = state.make_optimizer(net.parameters(), LR, WD)
    gen = torch.Generator().manual_seed(inputs["seed"])
    make = state.make_bd_train_step if model == "bd" else state.make_regression_train_step
    step = make(net, opt, sched, generator=gen)
    cur, src = inputs["batches"][model]
    losses = step((_rows(cur, device), _rows(src, device)), flip=flip)
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": _host({n: p.grad for n, p in net.named_parameters() if p.grad is not None}),
            "running": _host({k: v for k, v in net.state_dict().items()
                              if k.endswith(("running_mean", "running_var"))})}


def assert_grads_agree(got: dict, ref: dict) -> None:
    """Two steps' gradients {name: tensor} agree: relative L2 error 1e-3 over
    all parameters together and 2e-2 per parameter (parameters whose
    gradient is below 1e-6 of the largest skipped: the head biases that
    instance norm cancels), and the median over parameters of max|got -
    ref| / max|ref| within 1e-3 (tests/test_torch_distributed.py says
    why relative L2)."""
    assert set(got) == set(ref)
    got = {k: v.double().cpu() for k, v in got.items()}
    ref = {k: v.double().cpu() for k, v in ref.items()}
    largest = max(float(r.norm()) for r in ref.values())
    per = {k: float((got[k] - r).norm() / r.norm()) for k, r in ref.items()
           if float(r.norm()) >= 1e-6 * largest}
    worst = max(per, key=per.get)
    assert per[worst] <= 2e-2, (worst, per[worst])
    total = (sum(float((got[k] - r).norm() ** 2) for k, r in ref.items())
             / sum(float(r.norm() ** 2) for r in ref.values())) ** 0.5
    assert total <= 1e-3, total
    assert float(np.median([float((got[k] - r).abs().max() / r.abs().max())
                            for k, r in ref.items() if float(r.abs().max()) > 0])) <= 1e-3


def barrier_cases(rank: int) -> dict:
    """Rank 1 reaches the first barrier SKEW_S late; rank 0 must wait for
    it. Then rank 1 skips a barrier that rank 0 waits on for 3 s: rank 0's
    must raise, not hang."""
    skew_s = 2.0
    if rank == 1:
        time.sleep(skew_s)
    t0 = time.perf_counter()
    distributed.barrier("skewed", timeout_s=60)
    waited = time.perf_counter() - t0
    raised = None
    if rank == 0:
        t0 = time.perf_counter()
        try:
            distributed.barrier("missing", timeout_s=3)
        except RuntimeError as e:
            raised = (str(e), time.perf_counter() - t0)
    else:
        time.sleep(8.0)  # outlives rank 0's timeout, then leaves
    return {"waited_s": waited, "skew_s": skew_s, "missing_raised": raised}


def main(argv) -> None:
    rank, world, port = (int(a) for a in argv[:3])
    inputs_path, output_path = argv[3:5]
    device = argv[5] if len(argv) > 5 else "cpu"
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo", device=device,
                           timeout_s=120)
    inputs = torch.load(inputs_path, weights_only=False)
    results = {case: run_case(case, inputs, device) for case in inputs["cases"]}
    results["barrier"] = barrier_cases(rank)
    torch.save(results, output_path)
    # no shutdown: rank 1 left the group's last barrier on purpose


if __name__ == "__main__":
    main(sys.argv[1:])
