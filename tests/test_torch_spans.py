"""The port's stage spans (utils/profiling.py::span and SPANS) on the CPU,
on a tiny BD net (the tiny encoder, K=2 source views, 8 planes, 64x96):

- under profiling.trace, an upload and forward_val, then an upload and a
  training step, give each SPANS name the expected number of ranges, each
  inside the span the table of SPANS puts it in, on the calling thread;
- without a profiler, span returns one shared null context and never
  enters record_function;
- the outputs, the losses and the parameters after a step are bit-equal
  with and without a profiler;
- BDNet.trunk(stop_at=s) closes every span it opened before it returns;
- on a tiny DepthNet (the same sizes), an upload and an eval forward, then
  an upload and a regression step, open the trunk's spans inside
  idt.forward, the warp's idt.trunk.warp inside idt.trunk.volume, and the
  step's spans as the BD step does; the regression step's losses and
  parameters are bit-equal with and without a profiler. BD opens no
  idt.trunk.warp: its span sequence is as before.
"""

import contextlib
import copy
import json
import threading
from collections import Counter

import pytest
import torch

from implicit_depth_tpu_torch.models.bd_net import BDNet
from implicit_depth_tpu_torch.models.depth_net import DepthNet
from implicit_depth_tpu_torch.train import state
from implicit_depth_tpu_torch.utils import profiling
from implicit_depth_tpu_torch.utils.device import batch_to_device
from implicit_depth_tpu_torch.utils.fixtures import synthetic_bd_batch
from implicit_depth_tpu_torch.weights import init_params

CPU = torch.device("cpu")
STOPS = ["encoder", "matching", "volume", "cv_encoder"]
TRUNK = ["idt.trunk." + s for s in STOPS + ["decoder"]]
# each span's parent: the innermost span around it (None at the top)
PARENTS = {"idt.upload": {None}, "idt.forward_val": {None}, "idt.step": {None},
           "idt.forward": {"idt.step"}, "idt.step.loss": {"idt.step"},
           "idt.step.backward": {"idt.step"}, "idt.step.optimizer": {"idt.step"},
           "idt.heads": {"idt.forward_val", "idt.forward"},
           **{name: {"idt.forward_val", "idt.forward"} for name in TRUNK}}
# the spans that only DepthNet opens
REGRESSION_ONLY = {"idt.trunk.warp"}
# an upload and forward_val, then an upload and a training step
COUNTS = {"idt.upload": 2, "idt.forward_val": 1, "idt.step": 1, "idt.forward": 1,
          "idt.heads": 2, "idt.step.loss": 1, "idt.step.backward": 1, "idt.step.optimizer": 2,
          **{name: 2 for name in TRUNK}}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads in this module's process: `pytest -n 6` puts six
    test processes on the host's cores (see tests/test_torch_prior.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def host_batch():
    return synthetic_bd_batch(batch=1, num_src=2, height=64, width=96, num_planes=2,
                              num_rays=16, samples_per_ray=4, seed=0)


@pytest.fixture(scope="module")
def seeded_net() -> BDNet:
    return init_params(BDNet(image_encoder_name="tiny", num_src_views=2, num_depth_bins=8),
                       torch.Generator().manual_seed(3))


def _eval_and_step(net: BDNet, host_batch) -> tuple:
    """An upload and forward_val, then an upload and one training step:
    (the eval logits, the step's losses)."""
    with torch.no_grad():
        pred = net.eval().forward_val(*batch_to_device(host_batch, CPU))["pred_0"]
    opt, sched = state.make_optimizer(net.parameters(), 1e-3, 1e-4)
    step = state.make_bd_train_step(net, opt, sched, generator=torch.Generator().manual_seed(5))
    return pred, step(batch_to_device(host_batch, CPU), flip=True)


def _spans(tmp_path, fn) -> list:
    """The idt. spans that profiling.trace records over fn(), by start."""
    with profiling.trace(str(tmp_path)):
        fn()
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())["traceEvents"]
    return sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith("idt.")), key=lambda e: (e["ts"], -e["dur"]))


def _parent(e, spans):
    around = [p for p in spans if p is not e and p["ts"] <= e["ts"]
              and e["ts"] + e["dur"] <= p["ts"] + p["dur"]]
    return max(around, key=lambda p: p["ts"])["name"] if around else None


def test_each_span_is_recorded_where_the_table_puts_it(tmp_path, seeded_net, host_batch):
    net = copy.deepcopy(seeded_net)
    spans = _spans(tmp_path, lambda: _eval_and_step(net, host_batch))
    assert set(profiling.SPANS) == set(COUNTS) | REGRESSION_ONLY
    assert Counter(e["name"] for e in spans) == Counter(COUNTS)
    assert {e["tid"] for e in spans} == {threading.get_native_id()}
    for e in spans:
        assert _parent(e, spans) in PARENTS[e["name"]], e["name"]
    # the trunk's stages in order, inside each forward, before its heads
    for top in ("idt.forward_val", "idt.forward"):
        inside = [e["name"] for e in spans if _parent(e, spans) == top]
        assert inside == TRUNK + ["idt.heads"], top
    step = [e["name"] for e in spans if _parent(e, spans) == "idt.step"]
    assert step == ["idt.forward", "idt.step.loss", "idt.step.optimizer", "idt.step.backward",
                    "idt.step.optimizer"]


def test_without_a_profiler_a_span_is_one_shared_null_context(monkeypatch, seeded_net,
                                                              host_batch):
    assert not torch.autograd._profiler_enabled()
    off = profiling.span("idt.step")
    assert isinstance(off, contextlib.nullcontext)
    assert all(profiling.span(name) is off for name in profiling.SPANS)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _eval_and_step(copy.deepcopy(seeded_net), host_batch)


def test_results_are_bit_equal_with_and_without_a_profiler(tmp_path, seeded_net, host_batch):
    plain_net, traced_net = copy.deepcopy(seeded_net), copy.deepcopy(seeded_net)
    plain = _eval_and_step(plain_net, host_batch)
    with profiling.trace(str(tmp_path)):
        traced = _eval_and_step(traced_net, host_batch)
    assert torch.equal(plain[0], traced[0])
    assert plain[1].keys() == traced[1].keys()
    for k in plain[1]:
        assert torch.equal(plain[1][k], traced[1][k]), k
    for (name, a), (_, b) in zip(plain_net.state_dict().items(),
                                 traced_net.state_dict().items()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("stop_at", STOPS)
def test_an_early_return_closes_every_span(tmp_path, seeded_net, host_batch, stop_at):
    """The trunk's stages up to stop_at, each once, and nothing after it;
    a span opened after the return lies inside none of them."""
    net = copy.deepcopy(seeded_net).eval()
    cur, src = batch_to_device(host_batch, CPU)

    def run():
        with torch.no_grad():
            net.trunk(cur, src, stop_at=stop_at)
        with profiling.span("idt.upload"):
            pass

    spans = _spans(tmp_path, run)
    opened = TRUNK[: STOPS.index(stop_at) + 1]
    assert [e["name"] for e in spans] == opened + ["idt.upload"]
    assert _parent(spans[-1], spans) is None
    assert all(e["ts"] + e["dur"] <= spans[-1]["ts"] for e in spans[:-1])


# DepthNet: an upload and an eval forward, then an upload and a regression step
REG_COUNTS = {"idt.upload": 2, "idt.forward": 2, "idt.trunk.warp": 2, "idt.step": 1,
              "idt.step.loss": 1, "idt.step.backward": 1, "idt.step.optimizer": 2,
              **{name: 2 for name in TRUNK}}
REG_PARENTS = dict(PARENTS, **{"idt.forward": {None, "idt.step"},
                               "idt.trunk.warp": {"idt.trunk.volume"},
                               **{name: {"idt.forward"} for name in TRUNK}})


@pytest.fixture(scope="module")
def seeded_depth_net() -> DepthNet:
    return init_params(DepthNet(image_encoder_name="tiny", num_src_views=2, num_depth_bins=8),
                       torch.Generator().manual_seed(3))


def _reg_eval_and_step(net: DepthNet, host_batch) -> tuple:
    """An upload and DepthNet's eval forward, then an upload and one
    regression step: (the eval depth, the step's losses)."""
    with torch.no_grad():
        depth = net.eval()(*batch_to_device(host_batch, CPU))["depth_pred_0"]
    opt, sched = state.make_optimizer(net.parameters(), 1e-3, 1e-4)
    step = state.make_regression_train_step(net, opt, sched,
                                            generator=torch.Generator().manual_seed(5))
    return depth, step(batch_to_device(host_batch, CPU), flip=True)


def test_regression_spans_nest_as_the_table_says(tmp_path, seeded_depth_net, host_batch):
    net = copy.deepcopy(seeded_depth_net)
    spans = _spans(tmp_path, lambda: _reg_eval_and_step(net, host_batch))
    assert set(REG_COUNTS) <= set(profiling.SPANS)
    assert Counter(e["name"] for e in spans) == Counter(REG_COUNTS)
    assert {e["tid"] for e in spans} == {threading.get_native_id()}
    for e in spans:
        assert _parent(e, spans) in REG_PARENTS[e["name"]], e["name"]
    forwards = [e for e in spans if e["name"] == "idt.forward"]
    assert [_parent(e, spans) for e in forwards] == [None, "idt.step"]
    for top in forwards:
        assert [e["name"] for e in spans if _parent(e, spans) == "idt.forward"
                and top["ts"] <= e["ts"] <= top["ts"] + top["dur"]] == TRUNK
    for volume in (e for e in spans if e["name"] == "idt.trunk.volume"):
        assert [e["name"] for e in spans if _parent(e, spans) == "idt.trunk.volume"
                and volume["ts"] <= e["ts"] <= volume["ts"] + volume["dur"]] == ["idt.trunk.warp"]
    step = [e["name"] for e in spans if _parent(e, spans) == "idt.step"]
    assert step == ["idt.forward", "idt.step.loss", "idt.step.optimizer", "idt.step.backward",
                    "idt.step.optimizer"]


def test_regression_results_are_bit_equal_with_and_without_a_profiler(
        tmp_path, monkeypatch, seeded_depth_net, host_batch):
    """Without a profiler the regression step enters no record_function;
    with one, its answers and the parameters after it are the same bits."""
    plain_net, traced_net = copy.deepcopy(seeded_depth_net), copy.deepcopy(seeded_depth_net)
    with monkeypatch.context() as m:
        def refuse(name):
            raise AssertionError(f"record_function({name!r}) entered without a profiler")

        m.setattr(torch.profiler, "record_function", refuse)
        plain = _reg_eval_and_step(plain_net, host_batch)
    with profiling.trace(str(tmp_path)):
        traced = _reg_eval_and_step(traced_net, host_batch)
    assert torch.equal(plain[0], traced[0])
    assert plain[1].keys() == traced[1].keys()
    for k in plain[1]:
        assert torch.equal(plain[1][k], traced[1][k]), k
    for (name, a), (_, b) in zip(plain_net.state_dict().items(),
                                 traced_net.state_dict().items()):
        assert torch.equal(a, b), name
