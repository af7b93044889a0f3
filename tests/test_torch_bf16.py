"""The port's bf16 numerics against the JAX package's own bf16.

Every shipped model config sets `precision: 16`. The JAX models keep f32
parameters and compute their conv and dense stacks in `dtype=bfloat16`; the
port's eval casts those stacks to bf16 (`BDNet.cast_to_compute_dtype`) and
its train step runs them under bf16 autocast (train/state.py). Neither side
matches the other bit for bit, so each is measured against the JAX f32
model on the same weights and inputs (the 64x96, K=2 batch of
tests/test_torch_bd_net.py; seeded variables as its EfficientNetV2-S
forward and as the tiny step of tests/test_torch_train.py), and the port's
error may be at most BF16_FACTOR times JAX's own bf16 error; where signs are
compared, the port keeps at least JAX's share less SIGN_SLACK.

- Forward: `forward_val`'s `pred_0`, tiny encoder and EfficientNetV2-S.
  Max error (of the largest reference logit), relative L2, share of logits
  with the reference's sign.
- Train step: one BD step, tiny encoder, flip off. Each loss's relative
  error (the largest over the losses), and the gradients of all parameters
  together: max error (of the largest reference gradient), relative L2, and
  the share of nonzero reference gradients whose sign is kept.

Measured on the CPU (JAX bf16 / port bf16, each against JAX f32; the tiny
net's weights are the train tree of the step, seed 21):
- forward, tiny: max 2.62e-2 / 2.54e-2, rel. L2 2.28e-2 / 2.18e-2, signs
  99.24% / 99.28%;
- forward, EfficientNetV2-S: max 1.36e-2 / 1.15e-2, rel. L2 5.85e-3 /
  4.61e-3, signs 100% / 100%;
- train step: losses 1.06e-3 / 6.94e-4; gradients max 2.66e-2 / 2.48e-2,
  rel. L2 1.11e-1 / 1.06e-1, signs 95.52% / 96.02%.
Rounding the volume's geometry (intrinsics, relative poses, planes) to
bf16 in the port takes its gradients to max 7.72e-2 and signs 94.34%,
which fails here; the forward moves less (max 3.27e-2 tiny, 1.65e-2
EfficientNetV2-S) and passes.
"""

import concurrent.futures
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_depth_tpu.models.bd_net import BDNet as JBDNet
from implicit_depth_tpu_torch.models.bd_net import TRAIN_ONLY_PREFIXES, BDNet
from implicit_depth_tpu_torch.train import state
from implicit_depth_tpu_torch.weights import load_state_dict, state_dict_from_flax
from tests.test_torch_bd_net import D_BINS, K, _eval_variables, _torch_batch, batch  # noqa: F401
from tests.test_torch_train import _jax_step
from tests.torch_parity import seeded_variables, to_numpy_tree

BF16_FACTOR = 2.0
SIGN_SLACK = 0.005
DTYPES = (jnp.float32, jnp.bfloat16)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jnet(encoder: str, dt, **kw) -> JBDNet:
    return JBDNet(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name=encoder,
                  compute_dtype=dt, **kw)


def _forward(jnet):
    return lambda v, c, s: jnet.apply(v, c, s, method=JBDNet.forward_val)["pred_0"]


def _train_step(jnet, variables):
    def step(params, c, s):
        return _jax_step(jnet, {**variables, "params": params}, c, s, flip=False)[:2]
    return step


def _run(programs: dict, cur, src) -> dict:
    """{key: (fn, variables)} -> {key: numpy outputs of jit(fn)(variables,
    cur, src)}. Each program is compiled in a thread (XLA's compiler
    releases the GIL) while the next one is traced."""
    with concurrent.futures.ThreadPoolExecutor(len(programs)) as pool:
        compiling = {k: pool.submit(jax.jit(fn).lower(v, cur, src).compile)
                     for k, (fn, v) in programs.items()}
        return {k: jax.tree.map(np.asarray, c.result()(programs[k][1], cur, src))
                for k, c in compiling.items()}


def _tiny_variables(cur, src) -> dict:
    """The tiny BDNet's seeded train tree (as tests/test_torch_train.py's)."""
    return seeded_variables(
        lambda key, c, s: _jnet("tiny", jnp.float32, train_bn=True).init({"params": key}, c, s,
                                                                          flip=False),
        cur, src, seed=21)


def _forward_runs(workdir: str) -> None:
    """The forward part of jax_runs, in a process of its own so that it
    traces while the fixture traces the train steps: reads the batch from
    workdir/batch.npz and writes workdir/forward.npz (pred_0 of the tiny net
    and of EfficientNetV2-S at f32 and at bf16, and EfficientNetV2-S's
    seeded variables as the port's state_dict)."""
    with np.load(os.path.join(workdir, "batch.npz")) as f:
        cur, src = ({k.split("/", 1)[1]: f[k] for k in f.files if k.startswith(part + "/")}
                    for part in ("cur", "src"))
    variables = {"tiny": _tiny_variables(cur, src),
                 "efficientnet": _eval_variables(_jnet("efficientnet", jnp.float32), cur, src,
                                                 seed=11)}
    preds = _run({(enc, dt): (_forward(_jnet(enc, dt)), v) for enc, v in variables.items()
                  for dt in DTYPES[::-1]}, cur, src)
    sd = state_dict_from_flax(to_numpy_tree(variables["efficientnet"]))
    np.savez(os.path.join(workdir, "forward.npz"),  # bf16 values are exact in f32
             **{f"{enc}/{dt.dtype.name}": p.astype(np.float32) for (enc, dt), p in preds.items()},
             **{f"sd/{k}": v.numpy() for k, v in sd.items()})


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads in this module's process: beside the other test
    processes of `pytest -n 6`, torch's OpenMP pool at one thread per core
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_runs(batch, tmp_path_factory):  # noqa: F811
    """The JAX programs at f32 and bf16, and the port's state_dicts of their
    seeded variables: the tiny BD step's losses and gradients here, and
    meanwhile forward_val's pred_0 of the tiny net (on the step's train
    tree) and of EfficientNetV2-S in a child process (_forward_runs)."""
    cur, src = batch
    workdir = str(tmp_path_factory.mktemp("bf16"))
    np.savez(os.path.join(workdir, "batch.npz"), **{f"cur/{k}": v for k, v in cur.items()},
             **{f"src/{k}": v for k, v in src.items()})
    child = subprocess.Popen(
        [sys.executable, "-c", "import tests.conftest; from tests.test_torch_bf16 import "
         f"_forward_runs; _forward_runs({workdir!r})"], cwd=REPO)
    tiny = _tiny_variables(cur, src)
    out = _run({("step", dt): (_train_step(_jnet("tiny", dt, train_bn=True), tiny),
                               tiny["params"]) for dt in DTYPES[::-1]}, cur, src)
    assert child.wait(timeout=600) == 0
    with np.load(os.path.join(workdir, "forward.npz")) as f:
        out.update({(enc, dt): f[f"{enc}/{dt.dtype.name}"] for enc in ("tiny", "efficientnet")
                    for dt in DTYPES})
        effnet = {k[3:]: torch.tensor(f[k]) for k in f.files if k.startswith("sd/")}
    return {"state_dicts": {"tiny": state_dict_from_flax(to_numpy_tree(tiny)),
                            "efficientnet": effnet}, **out}


def _errors(got, ref) -> tuple:
    """(max |got - ref| / max |ref|, relative L2, share of the nonzero
    reference values whose sign `got` keeps)."""
    got, ref = np.asarray(got, np.float32).ravel(), np.asarray(ref, np.float32).ravel()
    diff = got - ref
    kept = np.sign(got) == np.sign(ref)
    return (float(np.abs(diff).max() / np.abs(ref).max()),
            float(np.linalg.norm(diff) / np.linalg.norm(ref)), float(kept[ref != 0].mean()))


def _assert_within_jax_bf16(label: str, port: tuple, jax_: tuple) -> None:
    (p_max, p_l2, p_sign), (j_max, j_l2, j_sign) = port, jax_
    msg = (f"{label}: port bf16 max {p_max:.3e} rel. L2 {p_l2:.3e} signs {p_sign:.4%}; "
           f"JAX bf16 max {j_max:.3e} rel. L2 {j_l2:.3e} signs {j_sign:.4%}")
    assert p_max <= BF16_FACTOR * j_max and p_l2 <= BF16_FACTOR * j_l2, msg
    assert p_sign >= j_sign - SIGN_SLACK, msg


@pytest.mark.parametrize("encoder", ["tiny", "efficientnet"])
def test_bf16_forward_within_jax_bf16(batch, jax_runs, encoder):  # noqa: F811
    cur, src = batch
    ref, jax_bf16 = (jax_runs[encoder, dt].astype(np.float32) for dt in DTYPES)
    net = BDNet(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name=encoder,
                compute_dtype=torch.bfloat16)
    load_state_dict(net, jax_runs["state_dicts"][encoder], TRAIN_ONLY_PREFIXES)
    with torch.no_grad():
        got = net.eval().cast_to_compute_dtype().forward_val(_torch_batch(cur), _torch_batch(src))
    got = got["pred_0"].float().numpy()
    assert got.shape == ref.shape
    _assert_within_jax_bf16(f"forward {encoder}", _errors(got, ref), _errors(jax_bf16, ref))


def _flat(named: dict) -> np.ndarray:
    return np.concatenate([np.asarray(named[k], np.float32).ravel() for k in sorted(named)])


def _named_grads(grads) -> dict:
    return {k: v.numpy() for k, v in state_dict_from_flax({"params": grads}).items()}


def test_bf16_train_step_within_jax_bf16(batch, jax_runs):  # noqa: F811
    cur, src = batch
    (ref_losses, ref_grads), (jax_losses, jax_grads) = (jax_runs["step", dt] for dt in DTYPES)
    net = BDNet(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny",
                compute_dtype=torch.bfloat16)
    load_state_dict(net, jax_runs["state_dicts"]["tiny"])
    opt, sched = state.make_optimizer(net.parameters(), 1e-3, 1e-4)
    got_losses = state.make_bd_train_step(net, opt, sched)((_torch_batch(cur), _torch_batch(src)),
                                                           flip=False)
    assert sorted(got_losses) == sorted(ref_losses)

    def loss_err(losses):
        return max(abs(float(losses[k]) - float(ref_losses[k])) / abs(float(ref_losses[k]))
                   for k in ref_losses)

    p_loss, j_loss = loss_err(got_losses), loss_err(jax_losses)
    assert p_loss <= BF16_FACTOR * j_loss, (p_loss, j_loss)
    ref = _named_grads(ref_grads)
    port = {n: p.grad.numpy() for n, p in net.named_parameters()}
    assert sorted(port) == sorted(ref)
    _assert_within_jax_bf16("train step gradients", _errors(_flat(port), _flat(ref)),
                            _errors(_flat(_named_grads(jax_grads)), _flat(ref)))
