"""The port's bf16 regression step (DepthNet, make_regression_train_step)
against the JAX package's own bf16, as tests/test_torch_bf16.py holds the
BD step.

One regression step of the tiny DepthNet (K=2 source views, 8 planes,
64x96, b=2, train-mode batch norm; the NaN-masked batch of
tests/test_torch_regression_train.py), on SEEDS seeded trees, flip off and
on. The JAX step (net.apply + normals_from_depth + regression_losses under
jax.value_and_grad) runs at f32 and at bf16; the port's step runs at bf16
under autocast. Each side is measured against the JAX f32 step, and the
port's error may be at most BF16_FACTOR times JAX's own bf16 error:

- each loss term (ms, grad, normals, mv, the total and the logged si, abs,
  inv_abs, log_l1): its relative error, as the root mean square over the
  cases. One case alone does not do: the error of a sum of roundings is
  as likely to be small by cancellation on one side as on the other, and
  one case in three reads a ratio past 2 between two draws of the same
  rounding noise;
- in each case, the gradients of all parameters together: max error (of
  the largest reference gradient) and relative L2, and the share of
  nonzero reference gradients whose sign is kept (at least JAX's share
  less SIGN_SLACK).

Measured on the CPU (JAX bf16 / port bf16, each against JAX f32; root
mean square over the 6 cases): ms 3.39e-4 / 3.49e-4, grad 2.68e-4 /
2.81e-4, normals 1.64e-3 / 1.11e-3, mv 2.10e-3 / 8.37e-4, loss 3.31e-4 /
3.61e-4, si 2.32e-4 / 3.46e-4, abs 3.07e-4 / 4.44e-4, inv_abs 7.48e-4 /
1.16e-3, log_l1 5.07e-4 / 7.59e-4; gradients, worst case, max 1.28e-1 /
4.05e-2, rel. L2 7.37e-2 / 7.28e-2, signs 95.32% / 95.19%. No term of the
port's step is past JAX's own bf16 error: the step computes its losses
and the predicted normals in f32 from the f32 cast of the bf16 heads, as
the JAX step does. Computing them inside the forward's bf16 autocast
instead (the losses' blur and Sobel convolutions then run in bf16) fails
here: loss 3.30e-3 against JAX's 3.31e-4, grad 1.15e-2 against 2.68e-4,
and the gradients' signs in 4 of the 6 cases.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_depth_tpu.models.depth_net import DepthNet as JDepthNet
from implicit_depth_tpu.ops import image as jimage
from implicit_depth_tpu.train import losses as jlosses
from implicit_depth_tpu_torch.models.depth_net import DepthNet
from implicit_depth_tpu_torch.train import state
from implicit_depth_tpu_torch.weights import load_state_dict, state_dict_from_flax
from tests.test_torch_bf16 import BF16_FACTOR, SIGN_SLACK, _errors, _flat, _named_grads
from tests.test_torch_regression_train import D_BINS, K, _regression_batch
from tests.torch_parity import seeded_variables, to_numpy_tree

DTYPES = (jnp.float32, jnp.bfloat16)
SEEDS = (21, 22, 23)
CASES = [(seed, flip) for seed in SEEDS for flip in (False, True)]
TERMS = ("loss", "ms_loss", "grad_loss", "normals_loss", "mv_loss", "si_loss", "abs_loss",
         "inv_abs_loss", "log_l1_loss")
LR, WD = 1e-3, 1e-4


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads in this module's process: `pytest -n 6` puts six
    test processes on the host's cores (see tests/test_torch_bf16.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jnet(dt) -> JDepthNet:
    return JDepthNet(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny",
                     compute_dtype=dt, train_bn=True)


def _loss_fn(jnet):
    """The loss function of the JAX make_regression_train_step, over the
    params and batch statistics, with the flip as an argument."""
    def loss_fn(params, batch_stats, cur, src, flip):
        depth_nan = jnp.where(cur["mask"], cur["depth"], jnp.nan)
        cur = dict(cur, normals=jimage.normals_from_depth(jnp.nan_to_num(depth_nan, nan=0.0),
                                                          cur["invK_s0"]))
        out, _ = jnet.apply({"params": params, "batch_stats": batch_stats}, cur, src, flip=flip,
                            mutable=["batch_stats"])
        out = dict(out)
        out["normals_pred"] = jimage.normals_from_depth(out["depth_pred_0"], cur["invK_s0"])
        ls = jlosses.regression_losses(cur, src, out)
        return ls["loss"], ls
    return loss_fn


def _port_step(cur, src, variables, flip) -> tuple:
    """(losses, {name: gradient}) of one port step at bf16 compute."""
    net = DepthNet(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny",
                   compute_dtype=torch.bfloat16)
    load_state_dict(net, state_dict_from_flax(to_numpy_tree(variables)))
    opt, sched = state.make_optimizer(net.parameters(), LR, WD)
    losses = state.make_regression_train_step(net, opt, sched)(
        ({k: torch.tensor(v) for k, v in cur.items()},
         {k: torch.tensor(v) for k, v in src.items()}), flip=flip)
    return ({k: float(v) for k, v in losses.items()},
            {n: p.grad.numpy() for n, p in net.named_parameters()})


def _jax_steps(lowered, trees, cur, src) -> dict:
    """{case: (losses, gradients)} of one compiled JAX program."""
    step = lowered.compile()
    return {(seed, flip): step(trees[seed]["params"], trees[seed]["batch_stats"], cur, src,
                               jnp.asarray(flip)) for seed, flip in CASES}


@pytest.fixture(scope="module")
def runs():
    """{case: {"float32", "bfloat16" (the JAX steps), "port": (losses,
    named gradients)}}. The two JAX programs are traced from the trees'
    shapes, each once for every tree and flip. Tracing holds the GIL while
    XLA's compiler and its programs release it, so each program compiles
    and runs in a thread while the next is traced and the port's steps
    run."""
    cur, src = _regression_batch()
    shapes = jax.eval_shape(lambda key: _jnet(jnp.float32).init({"params": key}, cur, src),
                            jax.random.PRNGKey(0))
    trees = {seed: seeded_variables(lambda key: jax.tree.map(jnp.zeros_like, shapes),
                                    seed=seed) for seed in SEEDS}
    flip_shape = jax.ShapeDtypeStruct((), jnp.bool_)
    with concurrent.futures.ThreadPoolExecutor(len(DTYPES)) as pool:
        stepping = {}
        for dt in DTYPES:
            lowered = jax.jit(jax.value_and_grad(_loss_fn(_jnet(dt)), has_aux=True)).lower(
                shapes["params"], shapes["batch_stats"], cur, src, flip_shape)
            stepping[dt] = pool.submit(_jax_steps, lowered, trees, cur, src)
        out = {(seed, flip): {"port": _port_step(cur, src, trees[seed], flip)}
               for seed, flip in CASES}
        for dt, steps in stepping.items():
            for case, ((_, losses), grads) in steps.result().items():
                out[case][dt.dtype.name] = ({k: float(v) for k, v in losses.items()},
                                            _named_grads(to_numpy_tree(grads)))
    return out


def _rms_rel_err(runs, side: str, term: str) -> float:
    errs = [(r[side][0][term] - r["float32"][0][term]) / r["float32"][0][term]
            for r in runs.values()]
    return float(np.sqrt(np.mean(np.square(errs))))


@pytest.mark.parametrize("term", TERMS)
def test_bf16_regression_loss_within_jax_bf16(runs, term):
    for r in runs.values():
        assert sorted(r["port"][0]) == sorted(r["float32"][0]) == sorted(TERMS)
    port, jax_ = _rms_rel_err(runs, "port", term), _rms_rel_err(runs, "bfloat16", term)
    assert port <= BF16_FACTOR * jax_, (term, port, jax_)


@pytest.mark.parametrize("case", CASES, ids=[f"seed{s}-{'flip' if f else 'noflip'}"
                                             for s, f in CASES])
def test_bf16_regression_gradients_within_jax_bf16(runs, case):
    r = runs[case]
    ref = r["float32"][1]
    assert sorted(r["port"][1]) == sorted(ref)
    (p_max, p_l2, p_sign), (j_max, j_l2, j_sign) = (
        _errors(_flat(r[side][1]), _flat(ref)) for side in ("port", "bfloat16"))
    msg = (f"gradients: port bf16 max {p_max:.3e} rel. L2 {p_l2:.3e} signs {p_sign:.4%}; "
           f"JAX bf16 max {j_max:.3e} rel. L2 {j_l2:.3e} signs {j_sign:.4%}")
    assert p_max <= BF16_FACTOR * j_max and p_l2 <= BF16_FACTOR * j_l2, msg
    assert p_sign >= j_sign - SIGN_SLACK, msg
