"""The port's measurement module and its two probes against the JAX
package, on the CPU in f32.

- utils/profiling.py: StepTimer and force_sync (as tests/test_utils.py
  tests the JAX module), trace (a Chrome trace file is written) and
  compile_log, whose FLOPs and bytes for a small convolution and matrix
  product equal the hand count.
- BDNet.trunk(stop_at=s) for the five values against the JAX trunk (the
  tiny encoder, K=2 source views, 8 planes, 64x96, as
  tests/test_torch_bd_variants.py): every returned tensor within 1e-4 of
  its largest reference value (f32 sums in another order); the port's
  tensors are NCHW where JAX's are NHWC, and the test permutes them.
- make_bd_train_step(forward_only=True): the losses against the JAX
  package's forward_only probe for the same flip, 1e-5 relative (as
  tests/test_torch_train.py's step); equal to the full step's losses for
  the same generator state (with and without the prior, whose draws come
  from the generators too); and every parameter, batch-norm buffer, AdamW
  state and scheduler counter bit-equal after the probe.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from implicit_depth_tpu.models.bd_net import BDNet as JBDNet
from implicit_depth_tpu.train import state as jstate
from implicit_depth_tpu.utils.fixtures import synthetic_bd_batch
from implicit_depth_tpu_torch.models.bd_net import TRAIN_ONLY_PREFIXES, BDNet
from implicit_depth_tpu_torch.train import state
from implicit_depth_tpu_torch.utils import profiling
from implicit_depth_tpu_torch.weights import init_params, load_state_dict, state_dict_from_flax
from tests.torch_parity import assert_close, bridged, seeded_variables, to_numpy_tree

K, D_BINS = 2, 8


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads in this module's process: `pytest -n 6` puts six
    test processes on the host's cores (see tests/test_torch_prior.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _torch(d):
    return {k: torch.tensor(v) for k, v in d.items()}


# ---------------------------------------------------------------- profiling

def test_step_timer_and_force_sync():
    t = profiling.StepTimer(warmup=1)
    for _ in range(4):
        t.start()
        x = torch.ones((64, 64)) * 2.0
        assert t.stop({"x": [x]}) >= 0
    s = t.summary()
    assert s["steps"] == 3 and s["mean_ms"] > 0
    assert s["p50_ms"] <= s["p95_ms"]
    profiling.force_sync({"a": (torch.zeros(2), [torch.ones(1)])})  # CPU tensors: no wait
    assert np.isnan(profiling.StepTimer().mean_ms)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    path = tmp_path / "t" / profiling.TRACE_FILE
    assert path.exists() and '"traceEvents"' in path.read_text()
    assert any("mm" in e.key for e in prof.key_averages())


def test_compile_log_counts_flops_and_bytes():
    """A 3x3 convolution (1x3x8x8 -> 1x4x6x6, no bias), a reshape (a view:
    no traffic) and a (1, 144) x (144, 5) product, in f32."""
    x, w, m = torch.randn(1, 3, 8, 8), torch.randn(4, 3, 3, 3), torch.randn(144, 5)
    info = profiling.compile_log(lambda x, w, m: F.conv2d(x, w).reshape(1, 144) @ m, x, w, m,
                                 name="conv_mm")
    assert info["name"] == "conv_mm" and info["first_call_s"] >= 0
    assert info["flops"] == 2 * (4 * 36 * 27) + 2 * (144 * 5)
    conv_bytes = 4 * (x.numel() + w.numel() + 144)
    mm_bytes = 4 * (144 + m.numel() + 5)
    assert info["bytes_accessed"] == conv_bytes + mm_bytes


def test_card_name_on_the_cpu():
    assert profiling.card_name_and_limit("cpu") == "cpu"


# ------------------------------------------------------------ trunk stop_at

def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


STOPS = ["encoder", "matching", "volume", "cv_encoder", ""]


@pytest.fixture(scope="module")
def trunk_nets():
    cur, src = synthetic_bd_batch(batch=1, num_src=K, height=64, width=96, num_planes=3,
                                  with_train_keys=False, seed=0)
    kw = dict(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny")
    jnet = JBDNet(**kw)
    variables = seeded_variables(
        lambda key, c, s: jnet.init({"params": key}, c, s, method=JBDNet.forward_val),
        cur, src, seed=41)
    net = bridged(BDNet(**kw), variables, TRAIN_ONLY_PREFIXES)
    return jnet, variables, net, cur, src


@pytest.mark.parametrize("stop_at", STOPS, ids=[s or "all" for s in STOPS])
def test_trunk_stop_at_matches_jax(trunk_nets, stop_at):
    jnet, variables, net, cur, src = trunk_nets
    ref = jax.jit(lambda v, c, s: jnet.apply(v, c, s, False, stop_at=stop_at,
                                             method=JBDNet.trunk))(variables, cur, src)
    with torch.no_grad():
        got = net.trunk(_torch(cur), _torch(src), stop_at=stop_at)
    assert sorted(got) == sorted(ref)
    if stop_at == "":
        assert sorted(got["features"]) == sorted(ref["features"])
        pairs = [(_nhwc(got["features"][s]), ref["features"][s]) for s in ref["features"]]
        pairs += [(got["lowest_cost"].numpy(), ref["lowest_cost"]),
                  (got["depth_planes"].numpy(), ref["depth_planes"])]
    else:
        g, r = got["features"], ref["features"]
        assert len(g) == len(r)
        if stop_at == "matching":  # the matching features are NHWC on both sides
            pairs = list(zip([g[0].numpy(), g[1].numpy()], r[:2]))
            pairs += [(_nhwc(a), b) for a, b in zip(g[2:], r[2:])]
        elif stop_at == "volume":  # (b, d, h, w) on both sides
            pairs = [(g[0].numpy(), r[0])] + [(_nhwc(a), b) for a, b in zip(g[1:], r[1:])]
        else:
            pairs = [(_nhwc(a), b) for a, b in zip(g, r)]
    for a, b in pairs:
        assert_close(a, np.asarray(b), 1e-4)


# -------------------------------------------------------- forward-only step

@pytest.fixture(scope="module")
def train_setup():
    cur, src = synthetic_bd_batch(batch=2, num_src=K, height=64, width=96, num_planes=3,
                                  num_rays=64, samples_per_ray=8, seed=0)
    kw = dict(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny")
    jnet = JBDNet(train_bn=True, **kw)
    variables = seeded_variables(lambda key, c, s: jnet.init({"params": key}, c, s, flip=False),
                                 cur, src, seed=42)
    return jnet, variables, kw, cur, src


def _port_net(variables, kw, use_prior=False):
    net = BDNet(use_prior=use_prior, **kw)
    load_state_dict(net, state_dict_from_flax(to_numpy_tree(variables)))
    return net


@pytest.mark.parametrize("seed", [0, 3])
def test_forward_only_matches_jax(train_setup, seed):
    jnet, variables, kw, cur, src = train_setup
    rng = jax.random.PRNGKey(seed)
    flip = bool(jax.random.bernoulli(jax.random.split(rng)[0]))
    st = jstate.create_train_state(variables, jstate.make_optimizer(1e-3, 1e-4, (70000, 80000)))
    jstep = jax.jit(jstate.make_bd_train_step(jnet, forward_only=True))
    st_after, ref = jstep(st, (cur, src), rng)
    ref = to_numpy_tree(ref)
    assert jax.tree.all(jax.tree.map(lambda a, b: bool(jnp.array_equal(a, b)), st_after, st))

    net = _port_net(variables, kw)
    opt, sched = state.make_optimizer(net.parameters(), 1e-3, 1e-4)
    got = state.make_bd_train_step(net, opt, sched, forward_only=True)(
        (_torch(cur), _torch(src)), flip=flip)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert_close(got[k], ref[k], 1e-5)


@pytest.mark.parametrize("use_prior", [False, True], ids=["noprior", "prior"])
def test_forward_only_gives_the_full_steps_losses(train_setup, use_prior):
    """The same generator state draws the same flip and prior noise: the
    probe's losses are the full step's, bit for bit."""
    _, _, kw, cur, src = train_setup
    batch = (_torch(cur), _torch(src))
    losses = []
    for forward_only in (True, False):
        net = BDNet(use_prior=use_prior, **kw)
        init_params(net, torch.Generator().manual_seed(7))
        opt, sched = state.make_optimizer(net.parameters(), 1e-3, 1e-4)
        step = state.make_bd_train_step(net, opt, sched, forward_only=forward_only,
                                        generator=torch.Generator().manual_seed(11))
        losses.append(step(batch))
    assert sorted(losses[0]) == sorted(losses[1])
    for k in losses[0]:
        assert torch.equal(losses[0][k], losses[1][k]), k


def _snapshot(net, opt, sched) -> dict:
    return {"model": {k: v.clone() for k, v in net.state_dict().items()},
            "optimizer": {i: {k: v.clone() if torch.is_tensor(v) else v for k, v in s.items()}
                          for i, s in opt.state_dict()["state"].items()},
            "groups": opt.state_dict()["param_groups"], "scheduler": sched.state_dict()}


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def test_forward_only_leaves_the_state_bit_equal(train_setup):
    """After a full step (so that AdamW holds moments and the scheduler has
    counted), a forward_only call changes no parameter, batch-norm buffer,
    optimizer state or scheduler counter; a second full step then moves
    them again (the probe is not a no-op by accident)."""
    _, variables, kw, cur, src = train_setup
    batch = (_torch(cur), _torch(src))
    net = _port_net(variables, kw)
    opt, sched = state.make_optimizer(net.parameters(), 1e-3, 1e-4)
    full = state.make_bd_train_step(net, opt, sched)
    probe = state.make_bd_train_step(net, opt, sched, forward_only=True)
    full(batch)
    before = _snapshot(net, opt, sched)
    probe(batch)
    assert _same(_snapshot(net, opt, sched), before)
    full(batch)
    after = _snapshot(net, opt, sched)
    assert not _same(after["model"]["matching.bn1.running_mean"],
                     before["model"]["matching.bn1.running_mean"])
    assert after["scheduler"]["last_epoch"] == before["scheduler"]["last_epoch"] + 1

