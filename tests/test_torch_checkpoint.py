"""The port's checkpoints (train/checkpoint.py) and `fit --resume` on the
CPU, and its converters of the reference's .ckpt state_dicts against the
JAX package's.

- CheckpointManager: top-k on a monitored metric, the `last` link and the
  deferred prune of the in-flight or `last` checkpoint (as
  tests/test_checkpoint.py:154-190 holds the JAX package's), synchronous
  and async.
- The async snapshot: a write held back until the model and the optimizer
  have been changed in place still stores the values of the save.
- save/restore of model, optimizer, scheduler and step: bit-equal, and a
  restored run takes the same next step bit for bit.
- fit --resume on the tiny synthetic config: the resumed run takes the
  same batches as an uninterrupted one (bit-equal) and, with the flip
  pinned (the resumed flip generator starts again from seed + 2, as the
  JAX package's step key), ends with bit-equal parameters and optimizer
  state; the checkpoints' layout (top-k, `last`, meta.json's step).
- The converters: a reference-layout state_dict made from a seeded flax
  tree (tests/torch_parity.py::reference_state_dict_from_flax) through the
  port's convert_reference_{bd,depth}_state_dict loads strictly into the
  port's model, whose eval forward matches the JAX package's on the tree
  within 5e-5 of the largest value (the bound of
  tests/test_torch_bd_net.py); the JAX converters give the tree back.
"""

import hashlib
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from implicit_depth_tpu.models.bd_net import BDNet as JBDNet
from implicit_depth_tpu.models.depth_net import DepthNet as JDepthNet
from implicit_depth_tpu.utils.fixtures import synthetic_bd_batch
from implicit_depth_tpu_torch.models.bd_net import BDNet
from implicit_depth_tpu_torch.models.depth_net import DepthNet
from implicit_depth_tpu_torch.train import checkpoint as ckpt
from implicit_depth_tpu_torch.train import state
from implicit_depth_tpu_torch.weights import load_state_dict
from tests.torch_parity import (assert_close, reference_state_dict_from_flax, seeded_variables,
                                to_numpy_tree)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads in this module's process (see
    tests/test_torch_prior.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _model_and_optimizer(seed=0):
    torch.manual_seed(seed)
    net = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3))
    opt, sched = state.make_optimizer(net.parameters(), lr=1e-2, wd=1e-4, lr_steps=(2, 4))
    return net, opt, sched


def _train(net, opt, sched, steps, seed=1):
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        opt.zero_grad()
        net(torch.randn(5, 4, generator=g)).square().sum().backward()
        opt.step()
        sched.step()


def _assert_same(a, b):
    """Two (nested) state_dicts are equal, tensors bit for bit."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("async_write", [False, True], ids=["sync", "async"])
def test_manager_keeps_top_k_and_last(tmp_path, async_write):
    net, opt, sched = _model_and_optimizer()
    mgr = ckpt.CheckpointManager(str(tmp_path), monitor="iou", mode="max", save_top_k=2,
                                 async_write=async_write)
    for step, iou in enumerate([0.1, 0.5, 0.3, 0.7]):
        mgr.save(net, opt, sched, step=step, metrics={"iou": iou, "step": step})
    assert mgr.best_path().endswith("ckpt_00000003")
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("ckpt_"))
    assert kept == ["ckpt_00000001", "ckpt_00000003"]  # 0.5 and 0.7
    assert os.readlink(tmp_path / "last") == "ckpt_00000003"
    meta = ckpt.load_meta(str(tmp_path / "last"))
    assert meta["step"] == 3 and meta["metrics"] == {"iou": 0.7, "step": 3.0}
    assert ckpt.peek_step(str(tmp_path / "ckpt_00000001")) == 1

    # min mode, top-1: a save whose metric falls outside the top-k is the
    # `last` target (and may be mid-write), so its prune is deferred to the
    # next save
    low = tmp_path / "min"
    mgr = ckpt.CheckpointManager(str(low), monitor="loss", mode="min", save_top_k=1,
                                 async_write=async_write)
    mgr.save(net, opt, sched, step=0, metrics={"loss": 0.1})
    mgr.save(net, opt, sched, step=1, metrics={"loss": 0.9})
    mgr.wait()
    assert sorted(os.listdir(low)) == ["ckpt_00000000", "ckpt_00000001", "last"]
    mgr.save(net, opt, sched, step=2, metrics={"loss": 0.8})
    mgr.wait()
    assert sorted(os.listdir(low)) == ["ckpt_00000000", "ckpt_00000002", "last"]
    assert os.readlink(low / "last") == "ckpt_00000002"
    assert mgr.best_path().endswith("ckpt_00000000")


def test_async_save_keeps_the_values_of_the_save(tmp_path, monkeypatch):
    """The writer thread is held until the model and the optimizer have
    been changed in place (the next optimizer step's updates): the file
    still holds what they were when save returned."""
    net, opt, sched = _model_and_optimizer()
    _train(net, opt, sched, 2)
    expected = ckpt.snapshot(net, opt, sched, step=2)
    go = threading.Event()
    write = ckpt._write_state

    def held_write(*args, **kwargs):
        assert go.wait(timeout=60)
        write(*args, **kwargs)

    monkeypatch.setattr(ckpt, "_write_state", held_write)
    mgr = ckpt.CheckpointManager(str(tmp_path), monitor="m", async_write=True)
    path = mgr.save(net, opt, sched, step=2, metrics={"m": 1.0})
    with torch.no_grad():
        for p in net.parameters():
            p.add_(1.0)
        net[1].running_mean.add_(1.0)
    _train(net, opt, sched, 1)  # moves exp_avg / exp_avg_sq in place
    go.set()
    mgr.wait()
    saved = torch.load(os.path.join(path, "state.pt"), weights_only=True)
    _assert_same(saved, expected)
    assert not torch.equal(saved["model"]["0.weight"], net[0].weight.detach())


def test_async_write_failure_is_raised_by_wait(tmp_path):
    net, opt, sched = _model_and_optimizer()
    (tmp_path / "ckpt_00000000").write_text("a file where the directory goes")
    mgr = ckpt.CheckpointManager(str(tmp_path), async_write=True)
    mgr.save(net, opt, sched, step=0)
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        mgr.wait()


def test_save_restore_is_bit_equal(tmp_path):
    net, opt, sched = _model_and_optimizer()
    _train(net, opt, sched, 3)  # past the first lr step
    path = str(tmp_path / "ck")
    ckpt.save_state(path, net, opt, sched, step=3, config={"lr": 1e-2}, metrics={"loss": 0.5})
    meta = ckpt.load_meta(path)
    assert meta == {"config": {"lr": 1e-2}, "metrics": {"loss": 0.5}, "step": 3}

    fresh, fopt, fsched = _model_and_optimizer(seed=5)
    assert ckpt.restore_state(path, fresh, fopt, fsched) == 3
    _assert_same(ckpt.snapshot(fresh, fopt, fsched, 3), ckpt.snapshot(net, opt, sched, 3))
    _train(net, opt, sched, 2, seed=9)
    _train(fresh, fopt, fsched, 2, seed=9)
    _assert_same(fresh.state_dict(), net.state_dict())
    assert fopt.param_groups[0]["lr"] == opt.param_groups[0]["lr"] == pytest.approx(1e-4)

    # weights only, and the three forms load_weights takes
    ckpt.save_params(str(tmp_path / "w.pt"), net.state_dict(), config={"kind": "x"})
    assert json.load(open(tmp_path / "w.pt.json")) == {"kind": "x"}
    torch.save({"model": net.state_dict(), "step": 5}, tmp_path / "old.pt")
    for source in (path, str(tmp_path / "w.pt"), str(tmp_path / "old.pt")):
        assert set(ckpt.load_weights(source)) == set(net.state_dict())
    _assert_same(ckpt.load_params(str(tmp_path / "w.pt")), net.state_dict())


# ------------------------------------------------------------- fit --resume

_FIT = ["--config_file", "configs/models/implicit_depth.yaml",
        "--data_config_file", "configs/data/synthetic_smoke.yaml",
        "--image_encoder_name", "tiny", "--precision", "32", "--num_workers", "2",
        "--log_interval", "1", "--val_interval", "2", "--val_batches", "1",
        "--synthetic_num_frames", "10", "--lazy_load_weights_from_checkpoint", ""]


def _fit(tmp_path, name, max_steps, extra=()):
    from implicit_depth_tpu_torch.config import parse_config
    from implicit_depth_tpu_torch.train.loop import fit

    cfg, _ = parse_config([os.path.join(REPO, a) if a.startswith("configs/") else a
                           for a in _FIT] + ["--log_dir", str(tmp_path), "--name", name]
                          + list(extra))
    digests = {}

    def on_batch(step, batch):
        h = hashlib.sha256()
        for part in batch:
            for k in sorted(part):
                if k != "frame_id_string":
                    h.update(np.ascontiguousarray(part[k]).tobytes())
        digests[step] = h.hexdigest()

    res = fit(cfg, "bd", device="cpu", max_steps=max_steps, batch_cb=on_batch, train_flip=False)
    return res, digests


def test_fit_resume_takes_the_same_batches_and_ends_bit_equal(tmp_path):
    full, full_batches = _fit(tmp_path, "full", 4)
    ckdir = tmp_path / "full" / "checkpoints"
    assert sorted(os.listdir(ckdir)) == ["ckpt_00000002", "ckpt_00000004", "last"]
    assert os.readlink(ckdir / "last") == "ckpt_00000004"
    assert ckpt.load_meta(str(ckdir / "ckpt_00000002"))["step"] == 2
    assert (tmp_path / "full" / "metrics.jsonl").exists()
    assert (tmp_path / "full" / "code" / "implicit_depth_tpu_torch" / "train" / "loop.py").exists()
    # 10 frames, 2 views back: 8 tuples, 2 batches of 4 an epoch; a new
    # permutation in every epoch
    assert len(set(full_batches.values())) >= 3

    resumed, resumed_batches = _fit(tmp_path, "resumed", 4,
                                    ["--resume", str(ckdir / "ckpt_00000002")])
    assert resumed["step"] == 4 and sorted(resumed_batches) == [3, 4]
    assert resumed_batches == {s: full_batches[s] for s in (3, 4)}
    a = torch.load(os.path.join(full["checkpoint"], "state.pt"), weights_only=True)
    b = torch.load(os.path.join(resumed["checkpoint"], "state.pt"), weights_only=True)
    assert a["step"] == b["step"] == 4
    _assert_same(b["model"], a["model"])
    _assert_same(b["optimizer"], a["optimizer"])
    _assert_same(b["scheduler"], a["scheduler"])
    assert resumed["losses"] == full["losses"]


# ---------------------------------------------------------------- converters

def _jax_tree(jnet, init_kwargs, cur, src):
    return to_numpy_tree(seeded_variables(
        lambda key, c, s: jnet.init({"params": key}, c, s, **init_kwargs), cur, src, seed=13))


@pytest.mark.parametrize("family", ["bd", "depth"])
def test_converted_reference_checkpoint_gives_the_jax_forward(family):
    from implicit_depth_tpu.train import checkpoint as jckpt

    cur, src = synthetic_bd_batch(batch=1, num_src=2, height=64, width=96, num_planes=3,
                                  num_rays=16, samples_per_ray=8, seed=0)
    kw = dict(num_src_views=2, num_depth_bins=8)
    if family == "bd":
        jnet, net = JBDNet(train_bn=True, **kw), BDNet(**kw)
        variables = _jax_tree(jnet, {"flip": False}, cur, src)
        convert, jconvert = (ckpt.convert_reference_bd_state_dict,
                             jckpt.convert_reference_bd_checkpoint)
    else:
        jnet, net = JDepthNet(train_bn=True, **kw), DepthNet(**kw)
        variables = _jax_tree(jnet, {}, cur, src)
        convert, jconvert = (ckpt.convert_reference_depth_state_dict,
                             jckpt.convert_reference_depth_checkpoint)
    ref_sd = reference_state_dict_from_flax(variables)
    params, stats = jconvert(ref_sd)  # the spec: the JAX converter gives the tree back
    jax.tree.map(np.testing.assert_array_equal, {"params": params, "batch_stats": stats},
                 variables)

    load_state_dict(net, convert(ref_sd))  # strict: every tensor of the model
    net.eval()
    torch_cur = {k: torch.tensor(v) for k, v in cur.items()}
    torch_src = {k: torch.tensor(v) for k, v in src.items()}
    jeval = type(jnet)(train_bn=False, **kw)
    with torch.no_grad():
        if family == "bd":
            ref = jax.jit(lambda v, c, s: jeval.apply(v, c, s, method=JBDNet.forward_val))(
                variables, cur, src)
            got = net.forward_val(torch_cur, torch_src)
            keys = ["pred_0"]
        else:
            ref = jax.jit(lambda v, c, s: jeval.apply(v, c, s))(variables, cur, src)
            got = net(torch_cur, torch_src)
            keys = [k for k in ref if k.startswith(("depth_pred_", "log_depth_pred_"))]
    assert keys
    for k in keys:
        assert_close(got[k], ref[k], 5e-5)


def test_convert_checkpoint_cli_writes_a_weights_file(tmp_path):
    """cli/convert_checkpoint.py on a Lightning-style file (state_dict plus
    a pickled options object in hyper_parameters): the kind detected, the
    weights file loads into the port's BDNet, the options in the sidecar."""
    import sys
    import types

    from implicit_depth_tpu_torch.cli import convert_checkpoint

    cur, src = synthetic_bd_batch(batch=1, num_src=2, height=64, width=96, num_planes=3,
                                  num_rays=16, samples_per_ray=8, seed=0)
    variables = _jax_tree(JBDNet(train_bn=True, num_src_views=2, num_depth_bins=8),
                          {"flip": False}, cur, src)
    # the reference's options.Options, pickled by name into the file, then
    # gone: the CLI's shim has to stand in for it
    class Options:
        pass

    Options.__module__, Options.__qualname__ = "options", "Options"
    module = types.ModuleType("options")
    module.Options = Options
    opts = Options()
    opts.name, opts.batch_size, opts.lr_steps, opts.skip = "bd", 12, [1, 2], {"nested": 1}
    sys.modules["options"] = module
    try:
        torch.save({"state_dict": reference_state_dict_from_flax(variables),
                    "hyper_parameters": {"opts": opts}}, tmp_path / "ref.ckpt")
    finally:
        del sys.modules["options"]
    out = str(tmp_path / "bd.pt")
    res = convert_checkpoint.main(["--input", str(tmp_path / "ref.ckpt"), "--output", out])
    assert res["kind"] == "bd"
    load_state_dict(BDNet(num_src_views=2, num_depth_bins=8), ckpt.load_weights(out))
    assert json.load(open(out + ".json")) == {
        "kind": "bd", "hyper_parameters": {"name": "bd", "batch_size": 12, "lr_steps": [1, 2]}}
