"""Data parallelism of the port on the CPU: two spawned ranks in a gloo
process group (tests/torch_ddp_child.py), each on its rows of a global
batch, against the one-process port step on the whole batch and against
the JAX package's one-process step, which is what its multi-host step on a
sharded batch computes (tests/test_multihost.py).

Tiny models (the tiny encoder, K=2, D=8, 64x96), a global batch of 4, two
rows a rank. Tolerances:
- batch norm in train mode (parallel/distributed.py's combination of each
  rank's count, mean and squared deviations): outputs, input gradients and
  the weight gradient 1e-5 of the largest value, running statistics 1e-6
  (f32 sums in another order);
- a train step (BD without and with the flip, BD with the prior drawn by
  the step for the global batch, regression): the two ranks' losses and
  gradients identical (one all-reduce gives both the same bits).
  Against the one-process port step on the whole batch: every loss 1e-5
  relative, the running statistics 1e-5, the gradients' relative L2 error
  1e-3 over all parameters together and 2e-2 per parameter (parameters
  whose gradient is below 1e-6 of the largest skipped: the head biases that
  instance norm cancels, ~1e-10) and the median over parameters of the
  largest error within 1e-3 of the largest value. Relative L2 and not the
  largest element, because the two sum in other orders and a LeakyReLU
  pre-activation within rounding of 0 then takes the other slope: in the
  regression step one such flip moves cv_encoder.conv_2_0.conv1.weight's
  gradient by 5.7e-2 of its largest element (relative L2 9.7e-3), and it
  is the one-process step that is off there (5.7e-2 from the float64 JAX
  step, the two ranks 1.5e-3). Against JAX's one-process step
  differentiated in float64 (as tests/test_torch_prior.py and
  tests/test_torch_regression_train.py), the bounds of
  tests/test_torch_train.py: every loss 1e-5 relative, the batch
  statistics 1e-5, every parameter's gradient within 2e-2 of its largest
  value (+1e-8 for the head biases; 5e-8 for the regression model's, as
  tests/test_torch_regression_train.py) and the median over parameters
  within 1e-3;
- the loader's shards concatenate to the global batch, bit for bit; a
  barrier waits for a rank that arrives late and raises, within its
  timeout, for one that never arrives;
- cli/train_bd.py (fit) over two ranks against one process: the same
  losses and validation IoUs (1e-5 relative), the same parameters after
  two steps (relative L2 1e-4), one checkpoint, written by rank 0;
- cli/test_bd.py over two ranks: rank 0's merged all_scenes_metrics.json
  equals a one-process run's within 1e-6 relative (every score; not the
  model time); its temporal merge gives the one-process temporal score.

Each child has its own timeout and is killed on expiry (the test then
fails), runs torch on one thread, and gets a free port from the OS.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_depth_tpu.core.sampling import grid_sample as jgrid_sample
from implicit_depth_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from implicit_depth_tpu.models.bd_net import BDNet as JBDNet
from implicit_depth_tpu.models.depth_net import DepthNet as JDepthNet
from implicit_depth_tpu.ops import image as jimage
from implicit_depth_tpu.train import losses as jlosses
from implicit_depth_tpu.utils.fixtures import synthetic_bd_batch
from implicit_depth_tpu_torch.data.loader import BatchLoader
from implicit_depth_tpu_torch.data.synthetic import SyntheticDataset
from implicit_depth_tpu_torch.models.bd_net import BDNet, draw_prior_noise, prior_noise_shapes
from implicit_depth_tpu_torch.models.matching import BatchNorm
from implicit_depth_tpu_torch.weights import init_params, state_dict_from_flax
from tests import torch_ddp_child as child
from tests.test_torch_prior import _jax_prior_forward
from tests.torch_parity import assert_close, assert_tree_close, seeded_variables, to_numpy_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, GLOBAL_B = 2, 4
CHILD_TIMEOUT_S = 300
STEP_CASES = list(child.STEP_CASES)
GRAD_ATOL = {"regression": 5e-8}  # else 1e-8


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads in this module's process (see
    tests/test_torch_prior.py); each child runs one."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv_of_rank, timeout_s: int = CHILD_TIMEOUT_S, env=None) -> list:
    """Starts one process per rank (argv_of_rank(r) -> its arguments after
    the interpreter), waits for all, kills every one still running when a
    timeout expires, and returns their CompletedProcess-like results; fails
    unless every rank exits 0."""
    env = dict(os.environ if env is None else env, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable] + argv_of_rank(r), cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"a rank did not finish within {timeout_s} s")
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-3000:]}\n{err[-6000:]}"
    return outs


def _regression_batch():
    cur, src = synthetic_bd_batch(batch=GLOBAL_B, num_src=child.K, height=64, width=96,
                                  num_rays=4, samples_per_ray=2, seed=0)
    depth = cur["depth"]
    depth[0, :5, :7] = np.nan
    depth[3, 20:, 40:] = np.nan
    cur["mask"] = np.isfinite(depth)
    src["depth"][1, 1, :8] = np.nan
    cur = {k: v for k, v in cur.items() if k not in ("gt_depth", "sampled_rays", "sampled_depths")}
    return cur, src


@pytest.fixture(scope="module")
def case_inputs():
    bd = synthetic_bd_batch(batch=GLOBAL_B, num_src=child.K, height=64, width=96, num_planes=3,
                            num_rays=64, samples_per_ray=8, seed=0)
    reg = _regression_batch()
    jnets, variables = {}, {}
    for case, (model, _, use_prior) in child.STEP_CASES.items():
        if model == "bd":
            jnets[case] = JBDNet(num_src_views=child.K, num_depth_bins=child.D_BINS,
                                 image_encoder_name="tiny", train_bn=True, use_prior=use_prior)
            variables[case] = seeded_variables(
                lambda key, c, s, n=jnets[case]: n.init({"params": key, "aug": key}, c, s,
                                                        flip=False), *bd, seed=21)
        else:
            jnets[case] = JDepthNet(num_src_views=child.K, num_depth_bins=child.D_BINS,
                                    image_encoder_name="tiny", train_bn=True)
            variables[case] = seeded_variables(
                lambda key, c, s, n=jnets[case]: n.init({"params": key}, c, s), *reg, seed=21)
    rng = np.random.RandomState(4)
    inputs = {"cases": ["bn"] + STEP_CASES, "seed": 7, "batches": {"bd": bd, "regression": reg},
              "state_dicts": {c: state_dict_from_flax(to_numpy_tree(v))
                              for c, v in variables.items()},
              "bn_x": torch.tensor(rng.randn(GLOBAL_B, 8, 5, 6).astype(np.float32) * 2 + 1),
              "bn_w": torch.tensor(rng.randn(GLOBAL_B, 8, 5, 6).astype(np.float32))}
    return inputs, jnets, variables


@pytest.fixture(scope="module")
def rank_results(case_inputs, tmp_path_factory):
    inputs = case_inputs[0]
    tmp = tmp_path_factory.mktemp("ddp")
    path = str(tmp / "inputs.pt")
    torch.save(inputs, path)
    port = free_port()
    run_ranks(lambda r: [os.path.join(REPO, "tests", "torch_ddp_child.py"), str(r), str(WORLD),
                         str(port), path, str(tmp / f"rank{r}.pt")])
    return [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def one_process(case_inputs):
    inputs = case_inputs[0]
    return {case: child.run_case(case, inputs) for case in inputs["cases"]}


def _cat(results, key):
    return torch.cat([r[key] for r in results])


def test_batch_norm_uses_the_global_batch(case_inputs, rank_results, one_process):
    ranks = [r["bn"] for r in rank_results]
    ref = one_process["bn"]
    assert_close(_cat(ranks, "y"), ref["y"], 1e-5)
    assert_close(_cat(ranks, "x_grad"), ref["x_grad"], 1e-5)
    for r in ranks:
        assert_close(r["weight_grad"], ref["weight_grad"], 1e-5)
        for k in ("running_mean", "running_var"):
            assert_close(r[k], ref[k], 1e-6)
    # rank 0's rows alone normalise otherwise: the check above can fail
    x0 = case_inputs[0]["bn_x"][:GLOBAL_B // WORLD]
    local = BatchNorm(x0.shape[1]).train()(x0).detach()
    assert (local - ranks[0]["y"]).abs().max() > 1e-2


@pytest.mark.parametrize("case", STEP_CASES)
def test_two_rank_step_matches_one_process(rank_results, one_process, case):
    r0, r1 = (r[case] for r in rank_results)
    assert r0["losses"] == r1["losses"]
    assert all(torch.equal(r0["grads"][k], r1["grads"][k]) for k in r0["grads"])
    ref = one_process[case]
    assert sorted(r0["losses"]) == sorted(ref["losses"])
    for k, v in ref["losses"].items():
        assert_close(r0["losses"][k], v, 1e-5)
    child.assert_grads_agree(r0["grads"], ref["grads"])
    for k, v in ref["running"].items():
        assert_close(r0["running"][k], v, 1e-5)


def _f64(tree):
    return jax.tree.map(lambda x: jnp.asarray(
        np.asarray(x, np.float64) if np.asarray(x).dtype == np.float32 else x), tree)


def _jax_step_f64(case, jnet, variables, batch, noise, flip):
    """The JAX package's one-process step on the global batch,
    differentiated in float64: (losses, grads, batch_stats) numpy trees."""
    model = child.STEP_CASES[case][0]

    def loss_fn(params, batch_stats, cur, src, noise):
        v = {"params": params, "batch_stats": batch_stats}
        if model == "regression":
            depth_nan = jnp.where(cur["mask"], cur["depth"], jnp.nan)
            cur = dict(cur, normals=jimage.normals_from_depth(
                jnp.nan_to_num(depth_nan, nan=0.0), cur["invK_s0"]))
            out, mutated = jnet.apply(v, cur, src, flip=flip, mutable=["batch_stats"])
            out = dict(out)
            out["normals_pred"] = jimage.normals_from_depth(out["depth_pred_0"], cur["invK_s0"])
            ls = jlosses.regression_losses(cur, src, out)
            return ls["loss"], (mutated["batch_stats"], ls)
        gt, rays = cur["gt_depth"], cur["sampled_rays"]
        grid = jnp.stack([(rays[..., 0] / gt.shape[2] - 0.5) * 2,
                          (rays[..., 1] / gt.shape[1] - 0.5) * 2], -1)
        edge = jgrid_sample(jimage.get_edge_mask(gt), grid[:, :, None],
                            mode="nearest")[:, :, 0, 0][..., None]
        if noise is None:
            out, mutated = jnet.apply(v, cur, src, flip=flip, mutable=["batch_stats"])
        else:
            out, mutated = jnet.apply(v, cur, src, noise, flip, method=_jax_prior_forward,
                                      mutable=["batch_stats"])
        preds = {k: o for k, o in out.items() if k.startswith("pred_")}
        ls = jlosses.binary_losses(out["query_depth"], out["target_depth"][..., None], preds,
                                   pos_weight=1.0, regularisation_weight=0.5, edge_mask=edge)
        return ls["loss"], (mutated["batch_stats"], ls)

    with jax.enable_x64(True):
        (_, (batch_stats, ls)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            *(_f64(x) for x in (variables["params"], variables["batch_stats"], *batch, noise)))
        return to_numpy_tree(ls), to_numpy_tree(grads), to_numpy_tree(batch_stats)


@pytest.mark.parametrize("case", STEP_CASES)
def test_two_rank_step_matches_jax(case_inputs, rank_results, case):
    inputs, jnets, variables = case_inputs
    model, flip, use_prior = child.STEP_CASES[case]
    batch = inputs["batches"][model]
    noise = None
    if use_prior:  # the draws the step makes for the global batch
        noise = [tuple(u.numpy() for u in pair) for pair in draw_prior_noise(
            batch[0]["sampled_depths"].shape, torch.float32,
            torch.Generator().manual_seed(inputs["seed"] + 1))]
        assert [p[0].shape for p in noise] == prior_noise_shapes(batch[0]["sampled_depths"].shape)
    ref_losses, grads, batch_stats = _jax_step_f64(case, jnets[case], variables[case], batch,
                                                   noise, flip)
    got = rank_results[1][case]
    assert sorted(got["losses"]) == sorted(ref_losses)
    for k in ref_losses:
        assert_close(got["losses"][k], ref_losses[k], 1e-5)
    rel_errs = assert_tree_close(grads, "params", got["grads"], 2e-2, GRAD_ATOL.get(case, 1e-8))
    assert np.median(list(rel_errs.values())) <= 1e-3
    assert_tree_close(batch_stats, "batch_stats", got["running"], 1e-5)


@pytest.mark.parametrize("batch_size", [4, 6])
def test_loader_shards_concatenate_to_the_global_batch(batch_size):
    kw = dict(num_frames=13, num_views=3, split="val", get_bd_info=False, image_height=32,
              image_width=48)
    ds = SyntheticDataset(**kw)
    whole = list(BatchLoader(ds, batch_size, seed=3, num_workers=1, epochs=2))
    shards = [list(BatchLoader(ds, batch_size, seed=3, num_workers=1, epochs=2, shard_id=r,
                               num_shards=WORLD)) for r in range(WORLD)]
    assert len(whole) == len(shards[0]) == len(shards[1]) == 2 * (10 // batch_size)
    for b, (s0, s1) in zip(whole, zip(*shards)):
        for part in (0, 1):
            for k, v in b[part].items():
                if k != "frame_id_string":
                    np.testing.assert_array_equal(np.concatenate([s0[part][k], s1[part][k]]), v)
    # the JAX package's loader shards the same rows
    jds = JSyntheticDataset(**kw)
    from implicit_depth_tpu.data.loader import BatchLoader as JBatchLoader

    jshard = list(JBatchLoader(jds, batch_size, seed=3, num_workers=1, epochs=2, shard_id=1,
                               num_shards=WORLD))
    for a, b in zip(shards[1], jshard):
        np.testing.assert_array_equal(a[0]["image"], b[0]["image"])


def test_barrier_waits_for_a_late_rank_and_times_out(rank_results):
    r0, r1 = (r["barrier"] for r in rank_results)
    assert r0["waited_s"] >= 0.8 * r0["skew_s"]  # rank 0 waited for the late rank 1
    assert r1["waited_s"] < r0["waited_s"]
    msg, after_s = r0["missing_raised"]
    assert "missing" in msg and after_s < 8.0  # raised at its 3 s timeout, not at rank 1's exit
    assert r1["missing_raised"] is None


# ------------------------------------------------------- cli/test_bd.py

_TEST_BD = ["--data_config_file", "configs/data/synthetic_smoke.yaml", "--device", "cpu",
            "--image_encoder_name", "tiny", "--precision", "32", "--split", "val",
            "--val_batch_size", "2"]


def _weights(tmp_path, use_prior: bool) -> str:
    path = str(tmp_path / "weights.pt")
    net = BDNet(num_src_views=2, num_depth_bins=8, image_encoder_name="tiny", use_prior=use_prior)
    torch.save(init_params(net, torch.Generator().manual_seed(0)).state_dict(), path)
    return path


def _test_bd_ranks(flags, out_dir) -> list:
    port = free_port()
    return run_ranks(lambda r: ["-m", "implicit_depth_tpu_torch.cli.test_bd"] + flags + [
        "--output_base_path", out_dir, "--jax_distributed", "--coordinator_address",
        f"127.0.0.1:{port}", "--distributed_num_processes", str(WORLD),
        "--distributed_process_id", str(r)])


def test_test_bd_ranks_merge_as_one_process(tmp_path):
    from implicit_depth_tpu_torch.cli import test_bd

    split = tmp_path / "scans.txt"
    split.write_text("sA\nsB\nsC\nsD\n")
    flags = ["--config_file", "configs/models/implicit_depth.yaml", "--max_frames", "4",
             "--dataset_scan_split_file", str(split),
             "--load_weights_from_checkpoint", _weights(tmp_path, False)] + _TEST_BD
    one = str(tmp_path / "one")
    test_bd.main(flags + ["--output_base_path", one])
    outs = _test_bd_ranks(flags, str(tmp_path / "ranks"))
    assert "iou" in outs[0][0] and outs[1][0].count("model_time") == 0  # rank 0 prints
    scores = tmp_path / "ranks" / "implicit_depth" / "scores"
    assert sorted(os.listdir(scores)) == sorted(
        ["all_scenes_metrics.json"] + [f"s{c}_metrics.json" for c in "ABCD"])
    got = json.load(open(scores / "all_scenes_metrics.json"))["scores"]
    ref = json.load(open(os.path.join(one, "implicit_depth", "scores",
                                      "all_scenes_metrics.json")))["scores"]
    assert sorted(got) == sorted(ref)
    keys = [k for k in ref if k != "model_time"]  # a wall time: not a score
    g, r = np.array([got[k] for k in keys]), np.array([ref[k] for k in keys])
    assert (np.isnan(g) == np.isnan(r)).all()
    ok = ~np.isnan(r)
    np.testing.assert_allclose(g[ok], r[ok], rtol=1e-6, atol=1e-12)


def test_test_bd_ranks_merge_the_temporal_score(tmp_path):
    from implicit_depth_tpu_torch.cli import test_bd

    split = tmp_path / "scans.txt"
    split.write_text("sA\nsB\n")
    flags = ["--config_file", "configs/models/implicit_depth_temporal.yaml", "--temporal_eval",
             "--data_config_file", "configs/data/synthetic_temporal.yaml", "--device", "cpu",
             "--image_encoder_name", "tiny", "--precision", "32", "--image_height", "64",
             "--image_width", "96", "--max_frames", "4", "--model_num_views", "3",
             "--matching_num_depth_bins", "8", "--dataset_scan_split_file", str(split),
             "--load_weights_from_checkpoint", _weights(tmp_path, True)]
    one = test_bd.main(flags + ["--output_base_path", str(tmp_path / "one")])
    outs = _test_bd_ranks(flags, str(tmp_path / "ranks"))
    line = [ln for ln in outs[0][0].splitlines() if ln.startswith("global temporal_score:")]
    assert len(line) == 1 and "over 2 scenes / 2 processes" in line[0]
    assert "global temporal_score" not in outs[1][0]
    got = float(line[0].split()[2])  # printed to 4 decimals
    assert abs(got - one["temporal_score"]) <= 5e-5
    tdir = tmp_path / "ranks" / "implicit_depth_temporal" / "temporal"
    ranks = [json.load(open(tdir / f"rank{r}.json")) for r in range(WORLD)]
    assert [d["n_scenes"] for d in ranks] == [1, 1]
    assert sum(d["total_diffs"] for d in ranks) == one["total_diffs"]


# ------------------------------------------------------------------ fit

def test_fit_over_two_ranks_is_the_one_process_fit(tmp_path):
    """cli/train_bd.py --jax_distributed over two ranks (tiny synthetic
    config, global batch 4, validation of a global batch of 4 at step 2)
    against the same command in one process: the same losses and
    validation IoUs (1e-5 relative: every rank computes the global batch's),
    the same parameters after the two AdamW steps (relative L2 1e-4 over
    all of them; f32 sums in other orders), and only rank 0 logs and
    writes the checkpoint."""
    from implicit_depth_tpu_torch.cli import train_bd
    from implicit_depth_tpu_torch.train import checkpoint as ckpt

    flags = ["--config_file", "configs/models/implicit_depth.yaml",
             "--data_config_file", "configs/data/synthetic_smoke.yaml", "--device", "cpu",
             "--image_encoder_name", "tiny", "--precision", "32", "--max_steps", "2",
             "--num_workers", "1", "--log_interval", "1", "--val_interval", "2",
             "--val_batches", "1", "--synthetic_num_frames", "10",
             "--lazy_load_weights_from_checkpoint", "", "--log_dir", str(tmp_path)]
    one = train_bd.main(flags + ["--name", "one"])
    port = free_port()
    outs = run_ranks(lambda r: ["-m", "implicit_depth_tpu_torch.cli.train_bd"] + flags + [
        "--name", "ranks", "--jax_distributed", "--coordinator_address", f"127.0.0.1:{port}",
        "--distributed_num_processes", str(WORLD), "--distributed_process_id", str(r)])
    scalars = [[json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
               for out, _ in outs]
    assert [s["step"] for s in scalars[0]] == [1, 2, 2]  # train, train, val
    for got, ref in zip(scalars[0], [s for s in scalars[1]]):
        assert {k: v for k, v in got.items() if k.startswith(("train/loss", "val/"))} == \
            {k: v for k, v in ref.items() if k.startswith(("train/loss", "val/"))}
    assert scalars[0][1]["train/loss"] == pytest.approx(one["losses"]["loss"], rel=1e-5)
    for k, v in one["val"].items():
        assert scalars[0][2][k] == pytest.approx(v, rel=1e-5, nan_ok=True)
    assert "checkpoint ckpt_" not in outs[1][0] and "checkpoint None" in outs[1][0]
    got = ckpt.load_weights(str(tmp_path / "ranks" / "checkpoints" / "last"))
    ref = ckpt.load_weights(one["checkpoint"])
    num = sum(float((got[k].double() - v.double()).norm() ** 2) for k, v in ref.items())
    den = sum(float(v.double().norm() ** 2) for v in ref.values())
    assert (num / den) ** 0.5 <= 1e-4
    assert sorted(os.listdir(tmp_path / "ranks" / "checkpoints")) == ["ckpt_00000002", "last"]
