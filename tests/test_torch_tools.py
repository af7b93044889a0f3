"""The port's measurement CLIs and user tools on the CPU.

- cli/profile_eval.py, cli/profile_train.py, cli/bench_train.py and
  cli/roofline.py: each timing function on a tiny BDNet (the tiny encoder,
  K=2, 8 planes, 64x96): every probe timed, no kernel launched on the CPU.
- The roofline's hand count of kernels #1-#4 follows the launches the
  wrappers recorded, so that on the CPU, where the plain versions run
  through aten and the counters see them, nothing is counted twice.
- ops/bounds.py gives PERF.md §6's bounds at its shapes, to its precision.
- The user tools against the JAX package's scripts: print_scores prints the
  same; make_config_and_txt_file writes the same bytes (make_random_checkpoint
  is held to the JAX script in tests/test_torch_random_checkpoint.py: the
  script's op-by-op init takes a minute on an 8-core x86 host, so it has a
  file, and a test worker, of its own); strip_checkpoint keeps the weights and the
  config and drops the optimizer;
  weights_drill on a reference-layout .ckpt gives the scores of
  cli/test_bd.py on the same converted file.
"""

import json
import os

import numpy as np
import pytest
import torch

from implicit_depth_tpu.utils.fixtures import synthetic_bd_batch
from implicit_depth_tpu_torch.cli import (bench_train, make_config_and_txt_file,
                                          print_scores, profile_eval,
                                          profile_train, roofline, strip_checkpoint, test_bd,
                                          weights_drill)
from implicit_depth_tpu_torch.models.bd_net import BDNet
from implicit_depth_tpu_torch.ops import bounds
from implicit_depth_tpu_torch.train import checkpoint as ckpt
from implicit_depth_tpu_torch.train import state
from implicit_depth_tpu_torch.weights import init_params, load_state_dict
from tests.torch_parity import reference_state_dict_from_flax, run_jax_script

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(image_encoder_name="tiny", num_src_views=2, num_depth_bins=8)
SHAPE = dict(num_src=2, height=64, width=96, num_planes=3, num_rays=64, samples_per_ray=8)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads in this module's process (see
    tests/test_torch_prior.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny(volume="mlp_feature_volume"):
    return profile_eval.flagship_net("cpu", volume, **TINY)


@pytest.fixture(scope="module")
def eval_inputs():
    net = _tiny().eval().cast_to_compute_dtype()
    return (net,) + profile_eval.synthetic_batch(1, "cpu", with_train_keys=False, **SHAPE)


@pytest.fixture(scope="module")
def train_batch():
    return profile_eval.synthetic_batch(2, "cpu", with_train_keys=True, **SHAPE)


NO_LAUNCH = (0,) * 6


# ------------------------------------------------------- measurement tools

def test_profile_eval_times_every_probe(eval_inputs):
    res = profile_eval.profile(*eval_inputs, iters=2)
    names = [n for n, _ in profile_eval.SECTIONS] + ["forward_val"]
    assert list(res["ms"]) == names and all(ms > 0 for ms in res["ms"].values())
    assert np.isclose(sum(res["deltas"].values()), res["ms"]["forward_val"])
    assert all(n == NO_LAUNCH for n in res["launches"].values())


def test_profile_train_times_every_probe(train_batch):
    res = profile_train.profile(train_batch, 1, _tiny)
    assert list(res["ms"]) == list(profile_train.PROBES)
    assert all(ms > 0 for ms in res["ms"].values())
    assert all(n == NO_LAUNCH for n in res["launches"].values())
    assert sorted(profile_train.derived(res["ms"])) == sorted(
        ["volume block (f+b)", "bwd + update", "conv stacks (f+b)", "ray head + loss (f+b)"])


def test_trunk_zero_step_trains_the_trunk(train_batch):
    net = _tiny("zero_cost_volume")
    opt, sched = state.make_optimizer(net.parameters(), 1e-3, 1e-4)
    before = net.encoder.state_dict()
    w = {k: v.clone() for k, v in before.items()}
    loss = profile_train.trunk_zero_step(net, opt, sched)(train_batch)["loss"]
    assert torch.isfinite(loss)
    assert any(not torch.equal(w[k], v) for k, v in net.encoder.state_dict().items())
    assert sched.state_dict()["last_epoch"] == 1


def test_bench_train_steps(train_batch):
    res = bench_train.bench(_tiny(), train_batch, 2)
    assert res["ms"] > 0 and res["first_step_s"] > 0 and res["launches"] == NO_LAUNCH
    assert np.isfinite(res["first_loss"]) and res["loss"] != res["first_loss"]


@pytest.mark.parametrize("cli,flag", [(bench_train, "--remat"), (bench_train, "--no_pallas"),
                                      (profile_eval, "--bf16_matmul"),
                                      (profile_train, "--remat")])
def test_unported_flags_are_refused(cli, flag):
    with pytest.raises(SystemExit):
        cli.main([flag, "--device", "cpu"])


def test_roofline_eval_counts_the_plain_volume_once(eval_inputs):
    """On the CPU no kernel launches, the hand count adds nothing, and the
    volume section's FLOPs (the plain version of #1 through aten, plus its
    glue) are #1's functional work once, not twice."""
    net, cur, src = eval_inputs
    res = roofline.eval_roofline(net, cur, src, 1, roofline.peaks_of("cpu"))
    assert [r["section"] for r in res["rows"]] == [n for n, _ in profile_eval.SECTIONS] + [
        "forward_val"]
    assert all(r["kernel_gflop"] == 0 and r["bound"] == "-" and np.isnan(r["bf16_pct"])
               for r in res["rows"])
    assert all(p["launches"] == NO_LAUNCH for p in res["probes"].values())
    volume = {r["section"]: r for r in res["rows"]}["volume"]
    per_launch = res["work"][1]
    assert per_launch == 2.0 * 1 * 8 * 16 * 24 * bounds.volume_fwd_macs(2)
    assert per_launch <= volume["gflop"] * 1e9 <= 1.1 * per_launch


def test_roofline_train_takes_the_rays_from_the_step(train_batch):
    peaks = bounds.CARD_PEAKS["NVIDIA H100 80GB HBM3"]
    res = roofline.train_roofline(train_batch, 1, _tiny, peaks)
    assert [r["section"] for r in res["rows"]] == [
        "conv stacks f+b (trunk)", "ray head + loss f+b", "volume block f+b", "full step"]
    # b=2, N=64 rays, S=8 samples: every (s+1)-th ray at scale s
    rows = [2 * n * 8 for n in (64, 32, 22, 16)]
    assert res["work"][3] == [2.0 * r * bounds.ray_head_fwd_macs() for r in rows]
    assert all(p["kernel_flops"] == (0.0,) * 4 for p in res["probes"].values())
    full = res["rows"][-1]
    assert full["gflop"] > 0 and full["gb"] > 0 and full["bound"] in ("compute", "HBM")
    assert full["bf16_pct"] == pytest.approx(100 * full["tflops"] * 1e12 / peaks["bf16"])


def test_kernel_flops_follow_the_recorded_launches():
    work = bounds.launch_flops(100, 7, [40, 20, 14, 10])
    assert bounds.kernel_flops(NO_LAUNCH, work) == (0.0,) * 4
    got = bounds.kernel_flops((1, 1, 4, 4, 0, 0), work)
    assert got == (200.0 * bounds.volume_fwd_macs(7), 200.0 * bounds.volume_bwd_macs(7),
                   2.0 * 84 * bounds.ray_head_fwd_macs(), 2.0 * 84 * bounds.ray_head_bwd_macs())
    assert bounds.kernel_flops((2, 0, 8, 0, 0, 0), work)[2] == 2 * got[2]
    with pytest.raises(ValueError, match="whole rounds"):
        bounds.kernel_flops((0, 0, 3, 0, 0, 0), work)
    with pytest.raises(ValueError, match="whole rounds"):  # an eval run has no ray rows
        bounds.kernel_flops((1, 0, 4, 0, 0, 0), bounds.launch_flops(100, 7))


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


# PERF.md §6's bounds: (kernel, shape, bound ms), at the kernel table's shapes
PERF_BOUNDS = [("1", 1, 0.0576), ("1", 12, 0.6913), ("2", 1, 0.1655), ("2", 12, 1.9860),
               ("3", 12, 0.1067), ("4", 12, 0.3192), ("5/6", 112, 0.8545)]


@pytest.mark.parametrize("kernel,b,expected", PERF_BOUNDS,
                         ids=[f"{k}-b{b}" for k, b, _ in PERF_BOUNDS])
def test_bounds_give_the_perf_tables_values(kernel, b, expected):
    K, H, W, D, C, F = 7, 96, 128, 64, 16, 128
    points = b * D * H * W
    if kernel in ("1", "2"):  # operands of the volume: features in, (B, D, H, W) f32 out
        io = bounds.nbytes(_meta(b, H, W, C), _meta(b, K, H, W, C),
                           _meta(b, D, H, W, dtype=torch.float32))
        macs = bounds.volume_fwd_macs(K) if kernel == "1" else bounds.volume_bwd_macs(K)
        got = bounds.least_ms(io, 2.0 * points * macs)
    elif kernel in ("3", "4"):  # b=12, N=4096, S=64
        rows = b * 4096 * 64
        io = bounds.nbytes(_meta(b, 4096, F), _meta(b, 4096, 64), _meta(b, 4096, 64))
        macs = bounds.ray_head_fwd_macs() if kernel == "3" else bounds.ray_head_bwd_macs()
        got = bounds.least_ms(io, 2.0 * rows * macs)
    else:  # the warp at the train shape: K'=112 views, read (K', H, W, C), write the planes
        f32 = torch.float32
        io = bounds.nbytes(_meta(b, H, W, C), _meta(b, 3, 3, dtype=f32), _meta(b, 3, dtype=f32),
                           _meta(D, dtype=f32), _meta(b, D, H, W, C))
        # per point: the coordinates, then 4 taps x 16 channels (multiply-add)
        got = bounds.least_ms(io, points * (16 + 4 * 16 * 2), bounds.F32_FLOP_PER_S)
    assert round(got[0], 4) == expected
    assert got[1] == ("bytes" if kernel == "5/6" else "operations")


def test_card_peaks_only_for_known_cards():
    assert bounds.card_peaks("NVIDIA H100 80GB HBM3")["bf16"] == bounds.BF16_FLOP_PER_S
    assert bounds.card_peaks("NVIDIA H100 PCIe") is None


# ------------------------------------------------------------- user tools

def test_print_scores_prints_what_the_jax_script_prints(tmp_path, capsys):
    from implicit_depth_tpu_torch.eval.metrics import ResultsAverager

    ra = ResultsAverager("exp", "scene-averaged")
    rng = np.random.RandomState(0)
    for _ in range(3):
        ra.update_results({**{f"iou_d_{1.5 + 0.5 * i:.1f}": rng.rand() for i in range(8)},
                           "surface_iou_d_2.0": rng.rand(), "model_time": 12.5})
    ra.compute_final_average()
    path = str(tmp_path / "scores.json")
    ra.output_json(path)
    capsys.readouterr()
    run_jax_script("print_scores.py", [path])
    ref = capsys.readouterr().out
    print_scores.main([path])
    assert capsys.readouterr().out == ref and "iou" in ref
    # a depth-metrics file has no per-plane table: both print the metrics only
    ra = ResultsAverager("exp", "depth")
    ra.update_results({"abs_rel": 0.1, "a25": 0.9})
    ra.compute_final_average()
    ra.output_json(path)
    run_jax_script("print_scores.py", [path])
    ref = capsys.readouterr().out
    print_scores.main([path])
    assert capsys.readouterr().out == ref and "abs_rel" in ref


def test_make_config_and_txt_file_writes_the_same_bytes(tmp_path):
    out = str(tmp_path / "generated")
    args = ["--dataset_path", "/data/vdr", "--scan_id", "seq0", "--output_dir", out]
    run_jax_script("make_config_and_txt_file.py", args)
    ref = {f: open(os.path.join(out, f), "rb").read() for f in sorted(os.listdir(out))}
    for f in ref:
        os.remove(os.path.join(out, f))
    make_config_and_txt_file.main(args)
    assert {f: open(os.path.join(out, f), "rb").read() for f in sorted(os.listdir(out))} == ref
    assert sorted(ref) == ["seq0.txt", "seq0.yaml"]


def test_strip_checkpoint_keeps_weights_and_config(tmp_path):
    net = init_params(BDNet(**TINY), torch.Generator().manual_seed(0))
    opt, sched = state.make_optimizer(net.parameters(), 1e-3, 1e-4)
    batch = profile_eval.synthetic_batch(1, "cpu", with_train_keys=True, **SHAPE)
    state.make_bd_train_step(net, opt, sched)(batch)  # AdamW holds moments now
    d = str(tmp_path / "ckpt_00000001")
    ckpt.save_state(d, net, opt, sched, step=1, config={"name": "tiny", "batch_size": 1})
    out = strip_checkpoint.main([d, str(tmp_path / "w.pt")])
    weights = torch.load(out, map_location="cpu", weights_only=True)
    assert set(weights) == set(net.state_dict())  # a bare state_dict: no optimizer
    got = ckpt.load_weights(out)
    assert all(torch.equal(v, got[k]) for k, v in net.state_dict().items())
    fresh = BDNet(**TINY)
    load_state_dict(fresh, got)
    assert json.load(open(out + ".json")) == {"name": "tiny", "batch_size": 1}


def test_weights_drill_gives_test_bds_scores(tmp_path):
    """A reference-layout .ckpt (the flagship's EfficientNetV2-S, K=2, 8
    planes) with its options as hyper-parameters: the drill converts it,
    writes the eval config from them and runs cli/test_bd.py; its scores
    equal test_bd's own run on the converted file and that config, all but
    the model time."""
    from implicit_depth_tpu.models.bd_net import BDNet as JBDNet
    from tests.torch_parity import seeded_variables, to_numpy_tree

    cur, src = synthetic_bd_batch(batch=1, num_src=2, height=64, width=96, num_planes=3,
                                  num_rays=16, samples_per_ray=8, seed=0)
    jnet = JBDNet(train_bn=True, num_src_views=2, num_depth_bins=8)
    variables = to_numpy_tree(seeded_variables(
        lambda key, c, s: jnet.init({"params": key}, c, s, flip=False), cur, src, seed=17))
    hp = {"opts": {"model_num_views": 3, "matching_num_depth_bins": 8, "name": "drill",
                   "image_encoder_name": "efficientnet", "batch_size": 12}}
    path = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": reference_state_dict_from_flax(variables),
                "hyper_parameters": hp}, path)
    wd = str(tmp_path / "drill")
    extra = ["--split", "val", "--device", "cpu", "--precision", "32", "--val_batch_size", "1"]
    weights_drill.main(["--ckpt", path, "--workdir", wd, "--max_frames", "1"] + extra)
    with open(os.path.join(wd, "converted.pt.json")) as f:
        assert json.load(f)["kind"] == "bd"
    test_bd.main(["--config_file", os.path.join(wd, "ckpt_opts.yaml"), "--data_config_file",
                  os.path.join(REPO, "configs/data/synthetic_smoke.yaml"), "--output_base_path",
                  str(tmp_path / "direct"), "--max_frames", "1"] + extra)
    drill_dir = os.path.join(wd, "results", "drill", "scores")
    direct_dir = os.path.join(str(tmp_path / "direct"), "drill", "scores")
    names = sorted(os.listdir(drill_dir))
    assert names == sorted(os.listdir(direct_dir)) and names
    for name in names:
        with open(os.path.join(drill_dir, name)) as a, open(os.path.join(direct_dir, name)) as b:
            got, ref = json.load(a)["scores"], json.load(b)["scores"]
        assert got.pop("model_time") > 0 and ref.pop("model_time") > 0  # wall time: not equal
        np.testing.assert_equal(got, ref)  # NaN (no such pixel) equal to NaN
