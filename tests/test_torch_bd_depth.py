"""Port parity for depth from the binary oracle against the JAX package, on
the CPU in f32: `BDNet.forward_infer_depth` (the 12-step bisection),
`evaluate_scenes(binary_eval_depth=True)` with its prediction cache
(`cache_dir`, utils/caching.py), `cli/test_bd.py --binary_eval_depth
--cache_depths` and the threshold sweep `cli/validate_bd.py`.

Sizes follow tests/test_torch_eval.py: the tiny encoder, K=2 source views,
8 planes, 64x96 images (32x48 depth maps). With seeded random weights the
scale-0 head hardly depends on the query depth, so every pixel's bisection
ends at 0.5 or 8. To make it settle inside the range, the depth row of the
head's first layer is scaled by -20 (the logit then falls with depth) and
the last bias shifted so that the logit crosses the threshold inside
[0.5, 8] for most pixels; the tests assert that it does.

Tolerances. The bisection's output is discontinuous: where a logit sits
within rounding of the threshold, the two sides take the other branch at
that step and end up to that step's half-range apart. So search depths are
held by the share of pixels within 1e-4 of JAX's, at least 99% (measured
99.5-100%, every other pixel within the last step, ~2e-3). The depth
metrics average over ~1500 pixels a frame, so such a pixel moves them by
~1e-6: they are held to 1e-4 relative. The sweep's IoUs come from
predictions ~1e-6 apart (tests/test_torch_eval.py), and the best threshold
of every plane is the same.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_depth_tpu.data.mvs_dataset import collate
from implicit_depth_tpu.data.synthetic import SyntheticDataset
from implicit_depth_tpu.eval import binary_metrics as jbm
from implicit_depth_tpu.eval import occlusion_eval as jocc
from implicit_depth_tpu.models.bd_net import BDNet as JBDNet
from implicit_depth_tpu.utils.fixtures import synthetic_bd_batch
from implicit_depth_tpu_torch.eval import binary_metrics as bm
from implicit_depth_tpu_torch.eval import occlusion_eval as occ
from implicit_depth_tpu_torch.models.bd_net import TRAIN_ONLY_PREFIXES, BDNet
from implicit_depth_tpu_torch.weights import state_dict_from_flax
from tests.torch_parity import bridged, seeded_variables, to_numpy_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, D_BINS = 2, 8
PLANES = np.linspace(1.5, 5.0, 8, dtype=np.float32)
THRESHOLDS = np.asarray([0.5, 0.4] + [0.3] * 6, np.float32)
DEPTH_ATOL, DEPTH_SHARE = 1e-4, 0.99


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads in this module's process: `pytest -n 6` puts six
    test processes on the host's cores (see tests/test_torch_prior.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _torch(d):
    return {k: torch.tensor(v) for k, v in d.items() if k != "frame_id_string"}


def _depth_weights(variables, bias_shift: float):
    """`variables` with the scale-0 head's depth row scaled by -20 and its
    last bias shifted by `bias_shift` (see the module docstring)."""
    v = jax.tree.map(np.array, variables)
    head = v["params"]["binary_mlp"]
    head["s0_fc0"]["kernel"][0] *= -20.0
    head["s0_fc2"]["bias"] += bias_shift
    return v


def _share_close(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return float((np.abs(got - ref) <= DEPTH_ATOL).mean())


@pytest.fixture(scope="module")
def eval_variables():
    ds = SyntheticDataset(num_frames=6, num_views=3, split="test", get_bd_info=True)
    cur, src = collate([ds[0]])
    cur, src = ({k: v for k, v in d.items() if k != "frame_id_string"} for d in (cur, src))
    jnet = JBDNet(image_encoder_name="tiny", num_src_views=K, num_depth_bins=D_BINS)
    return jnet, to_numpy_tree(seeded_variables(
        lambda key, c, s: jnet.init({"params": key}, c, s, method=JBDNet.forward_val),
        cur, src, seed=41))


# (bins, values, bias shift): 0.5 everywhere (measured 99.51% of the pixels
# within DEPTH_ATOL); the test CLI's validation thresholds at the bins of
# Thresholder(PLANES, ...) (99.77%); bins that end at 2 m, so that every mid
# beyond them takes the last threshold, the index clamped as a JAX gather
# clamps it (99.64%)
CASES = {"fixed": (None, None, 1.0),
         "thresholder": (np.append((PLANES[1:] + PLANES[:-1]) / 2, 100.0), THRESHOLDS, 0.0),
         "clamped": (np.linspace(0.6, 2.0, 8, dtype=np.float32), THRESHOLDS, 0.0)}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_infer_depth_matches_jax(eval_variables, case):
    jnet, base = eval_variables
    bins, values, shift = CASES[case]
    variables = _depth_weights(base, shift)
    cur, src = synthetic_bd_batch(batch=2, num_src=K, height=64, width=96, num_planes=1,
                                  with_train_keys=False, seed=0)
    tb, tv = (None, None) if bins is None else (np.asarray(bins, np.float32), values)
    ref = jax.jit(lambda v, c, s: jnet.apply(
        v, c, s, method=JBDNet.forward_infer_depth,
        threshold_bins=None if tb is None else jnp.asarray(tb),
        threshold_values=None if tv is None else jnp.asarray(tv)))(variables, cur, src)
    net = bridged(BDNet(image_encoder_name="tiny", num_src_views=K, num_depth_bins=D_BINS),
                  variables, TRAIN_ONLY_PREFIXES)
    with torch.no_grad():
        got = net.forward_infer_depth(_torch(cur), _torch(src),
                                      None if tb is None else torch.tensor(tb),
                                      None if tv is None else torch.tensor(tv))
    depths = got["search_depths"]
    assert depths.shape == (2, 32, 48) and depths.dtype == torch.float32
    assert (depths >= 0.5).all() and (depths <= 8.0).all()
    inside = ((depths > 0.51) & (depths < 7.99)).float().mean().item()
    assert inside > 0.5, f"only {inside:.3f} of the pixels settle inside (0.5, 8)"
    share = _share_close(depths, ref["search_depths"])
    assert share >= DEPTH_SHARE, f"{share:.4f} of the pixels within {DEPTH_ATOL}"
    np.testing.assert_allclose(got["lowest_cost"].numpy(), np.asarray(ref["lowest_cost"]),
                               rtol=1e-6)


def _eval_dataset():
    return SyntheticDataset(num_frames=6, num_views=3, split="test", get_bd_info=True,
                            pass_frame_id=True)


def test_evaluate_scenes_binary_depth_and_cache_match_jax(eval_variables, tmp_path):
    """batch 3 over 4 tuples: JAX pads the remainder batch and truncates it
    before caching; the port runs it as it is. The metrics and the cache
    files agree one for one."""
    jnet, base = eval_variables
    variables = _depth_weights(base, 1.0)
    net = bridged(BDNet(image_encoder_name="tiny", num_src_views=K, num_depth_bins=D_BINS),
                  variables, TRAIN_ONLY_PREFIXES)
    fixed = (PLANES, np.full(8, 0.5, np.float32))
    got = occ.evaluate_scenes(net, {"scene0": _eval_dataset()}, batch_size=3,
                              thresholder=bm.Thresholder(*fixed), binary_eval_depth=True,
                              cache_dir=str(tmp_path / "port"))
    ref = jocc.evaluate_scenes(jnet, variables, {"scene0": _eval_dataset()}, batch_size=3,
                               thresholder=jbm.Thresholder(*map(jnp.asarray, fixed)),
                               binary_eval_depth=True, cache_dir=str(tmp_path / "jax"))
    g, r = got["all_scene"].final_metrics, ref["all_scene"].final_metrics
    assert sorted(g) == sorted(r)
    assert {"abs_rel", "a25", "rmse"} <= set(g) and not any("iou" in k for k in g)
    assert got["forwards"] == 2 and got["nonfinite_preds"] == 0
    for k in r:
        if k != "model_time":
            assert np.isfinite(r[k]) and abs(g[k] - r[k]) <= 1e-4 * abs(r[k]), (k, g[k], r[k])

    port_dir, jax_dir = tmp_path / "port" / "scene0", tmp_path / "jax" / "scene0"
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names and len(names) == 4
    for name in names:
        with open(port_dir / name, "rb") as f:
            pg = pickle.load(f)
        with open(jax_dir / name, "rb") as f:
            pr = pickle.load(f)
        assert sorted(pg) == sorted(pr) and pg["frame_id"] == pr["frame_id"] == name[:-7]
        depths = pg["search_depths"]
        assert type(depths) is np.ndarray and depths.shape == (1, 32, 48, 1)
        assert _share_close(pg["search_depths"], pr["search_depths"]) >= DEPTH_SHARE
        for k in set(pr) - {"search_depths", "frame_id"}:
            np.testing.assert_array_equal(pg[k], pr[k])


def test_binary_scorer_needs_the_depth_resolution():
    score = occ.make_score_fn(binary_eval_depth=True)
    gt = torch.full((1, 8, 12, 1), 2.0)
    assert set(score(torch.full((1, 8, 12, 1), 2.0), {"depth": gt})) >= {"abs_rel", "a25"}
    with pytest.raises(ValueError, match="pixel by pixel"):
        score(torch.full((1, 16, 24, 1), 2.0), {"depth": gt})


def _checkpoint(tmp_path, variables) -> str:
    path = str(tmp_path / "bd.pt")
    torch.save(state_dict_from_flax(variables), path)
    return path


_CLI = ["--config_file", os.path.join(REPO, "configs/models/implicit_depth.yaml"),
        "--data_config_file", os.path.join(REPO, "configs/data/synthetic_smoke.yaml"),
        "--image_encoder_name", "tiny", "--precision", "32", "--device", "cpu",
        "--synthetic_num_frames", "6", "--val_batch_size", "2", "--name", "port"]


def test_test_bd_cli_binary_eval_depth_and_cache(eval_variables, tmp_path, capsys):
    from implicit_depth_tpu_torch.cli import test_bd

    _, base = eval_variables
    out = tmp_path / "out"
    results = test_bd.main(_CLI + [
        "--load_weights_from_checkpoint", _checkpoint(tmp_path, _depth_weights(base, 1.0)),
        "--split", "test", "--output_base_path", str(out), "--binary_eval_depth",
        "--cache_depths"])
    printed = capsys.readouterr().out
    assert "abs_rel" in printed and "model_time:" in printed and "boundary_iou" not in printed
    assert results["forwards"] == 2 and results["nonfinite_preds"] == 0
    scores = json.loads((out / "port/scores/all_scenes_metrics.json").read_text())["scores"]
    assert np.isfinite(scores["abs_rel"]) and not any("iou" in k for k in scores)
    ids = sorted(_eval_dataset()[i][0]["frame_id_string"] for i in range(4))
    cached = sorted(os.listdir(out / "port/depth_cache/scene0"))
    assert cached == [f"{i}.pickle" for i in ids]


def test_validate_bd_cli_matches_jax_sweep(eval_variables, tmp_path, capsys):
    """cli/validate_bd.main in-process prints the best threshold of each
    plane that JAX's evaluate_scenes, swept over the same tuples, gives."""
    from implicit_depth_tpu import config as jconfig
    from implicit_depth_tpu.train.loop import build_dataset as jbuild_dataset
    from implicit_depth_tpu_torch.cli import validate_bd

    jnet, variables = eval_variables
    out = tmp_path / "out"
    argv = _CLI + ["--load_weights_from_checkpoint", _checkpoint(tmp_path, variables),
                   "--split", "val", "--output_base_path", str(out)]
    results = validate_bd.main(argv)
    printed = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("best per-plane thresholds:")]

    jcfg = jconfig.parse_and_merge([a for a in argv if a not in ("--device", "cpu")])
    thresholds = np.linspace(0.1, 0.9, 17)
    ref = jocc.evaluate_scenes(jnet, variables, {"scene0": jbuild_dataset(jcfg, "val", "bd")},
                               batch_size=jcfg.val_batch_size, thresholds=tuple(thresholds),
                               threshold_decimals=2)["all_scene"].final_metrics
    best = [max((ref[f"iou_{t:.2f}_d_{d:.1f}"], t) for t in thresholds)[1]
            for d in validate_bd.PLANES]
    assert printed == [f"best per-plane thresholds: {[f'{b:.2f}' for b in best]}"]
    assert results["best_thresholds"] == best
    sweep = json.loads((out / "port/val_sweep/all_scenes_metrics.json").read_text())["scores"]
    assert all(f"iou_{t:.2f}_d_{d:.1f}" in sweep for t in thresholds for d in (1.5, 5.0))
