"""Port parity for the dense occlusion-eval slice as a whole: the binary
metrics, the results averager, `evaluate_scenes` against the JAX package's
on the synthetic dataset with bridged weights, and the test_bd CLI.

Tolerances: the metric functions get the same inputs and must agree
exactly (IoUs to 1e-6: counts are exact, the division is f32). For
`evaluate_scenes` the two models' predictions differ by ~1e-6, so a pixel
whose sigmoid sits within that of a threshold may flip; the IoUs must
agree to 1e-3 (one pixel of the ~1500 valid ones per plane moves an IoU by
at most ~7e-4) and were measured equal.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_depth_tpu.data.synthetic import SyntheticDataset
from implicit_depth_tpu.eval import binary_metrics as jbm
from implicit_depth_tpu.eval import metrics as jmetrics
from implicit_depth_tpu.eval import occlusion_eval as jocc
from implicit_depth_tpu.models.bd_net import BDNet as JBDNet
from implicit_depth_tpu.ops import image as jimage
from implicit_depth_tpu_torch.cli import test_bd as cli
from implicit_depth_tpu_torch.eval import binary_metrics as bm
from implicit_depth_tpu_torch.eval import metrics
from implicit_depth_tpu_torch.eval import occlusion_eval as occ
from implicit_depth_tpu_torch.models.bd_net import TRAIN_ONLY_PREFIXES, BDNet
from implicit_depth_tpu_torch.ops import image
from implicit_depth_tpu_torch.weights import state_dict_from_flax
from tests.torch_parity import assert_close, bridged, seeded_variables, t, to_numpy_tree

PLANES = np.linspace(1.5, 5.0, 8, dtype=np.float32)
THRESHOLDS = np.asarray([0.5, 0.4] + [0.3] * 6, np.float32)


def _depth_inputs(seed=0, b=2, h=12, w=16, d=8):
    rng = np.random.RandomState(seed)
    gt = rng.uniform(1.0, 5.5, (b, h, w, 1)).astype(np.float32)
    gt[0, :3, :4] = np.nan
    gt[1, 5, 5] = 0.0
    query = np.broadcast_to(PLANES[:d], (b, h, w, d)).copy()
    query[1, 0, 0, 0] = 0.0
    pred = rng.uniform(0, 1, (b, h, w, d)).astype(np.float32)
    return gt, query, pred


def test_max_pool_dilate():
    x = np.random.RandomState(1).rand(2, 9, 10, 3).astype(np.float32)
    for window in (3, 7):
        assert_close(image.max_pool_dilate(t(x), window), jimage.max_pool_dilate(x, window), 0.0)


def test_boundary_and_surface_masks():
    gt, query, _ = _depth_inputs()
    np.testing.assert_array_equal(bm.get_boundary_mask(t(gt), t(query)).numpy(),
                                  np.asarray(jbm.get_boundary_mask(gt, query)))
    np.testing.assert_array_equal(bm.get_surface_mask(t(gt), t(query)).numpy(),
                                  np.asarray(jbm.get_surface_mask(gt, query)))


def test_thresholder():
    _, query, _ = _depth_inputs()
    query = query + np.random.RandomState(2).uniform(-0.3, 0.3, query.shape).astype(np.float32)
    got = bm.Thresholder(PLANES, THRESHOLDS).get_thresholds(t(query))
    ref = jbm.Thresholder(jnp.asarray(PLANES), jnp.asarray(THRESHOLDS)).get_thresholds(query)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mode", ["scalar", "per_element", "surface", "boundary"])
def test_plane_scores_and_keys(mode):
    gt, query, pred = _depth_inputs(seed=3)
    thr_t, thr_j, extra_t, extra_j = 0.5, 0.5, None, None
    if mode != "scalar":
        thr_t = bm.Thresholder(PLANES, THRESHOLDS).get_thresholds(t(query))
        thr_j = jbm.Thresholder(jnp.asarray(PLANES), jnp.asarray(THRESHOLDS)).get_thresholds(query)
    if mode == "surface":
        extra_t, extra_j = bm.get_surface_mask(t(gt), t(query)), jbm.get_surface_mask(gt, query)
    if mode == "boundary":
        extra_t, extra_j = bm.get_boundary_mask(t(gt), t(query)), jbm.get_boundary_mask(gt, query)
    got = bm.plane_scores(t(query), t(gt), t(pred), thr_t, extra_mask_bhwd=extra_t)
    ref = jbm.plane_scores(query, gt, pred, thr_j, extra_mask_bhwd=extra_j)
    for key in ("iou", "iou_pos", "iou_neg"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=1e-6, atol=1e-7)
    thr_key = 0.5 if mode == "scalar" else None
    gd = bm.scores_to_dict(got, thr_key, tag=mode if mode in ("surface", "boundary") else None)
    rd = jbm.scores_to_dict(ref, thr_key, tag=mode if mode in ("surface", "boundary") else None)
    assert list(gd) == list(rd)


def test_results_averager(tmp_path):
    rng = np.random.RandomState(4)
    elems = [{"iou_d_1.5": rng.rand(), "model_time": rng.rand()} for _ in range(5)]
    elems[2]["iou_d_1.5"] = np.nan
    ours, theirs = metrics.ResultsAverager("x", "frame"), jmetrics.ResultsAverager("x", "frame")
    for e in elems:
        ours.update_results(e)
        theirs.update_results(e)
    for avg in (ours, theirs):
        avg.compute_final_average(ignore_nans=True)
    np.testing.assert_equal(ours.final_metrics, theirs.final_metrics)
    np.testing.assert_equal(ours.running_metrics, theirs.running_metrics)
    ours.output_json(str(tmp_path / "a.json"))
    theirs.output_json(str(tmp_path / "b.json"))
    assert json.loads((tmp_path / "a.json").read_text()) == json.loads((tmp_path / "b.json").read_text())


def test_print_sheets_friendly_prints_what_jax_prints(capsys):
    """The same signature and defaults, and the same stdout for the same
    update_results inputs, with and without the names row and for the
    running and the final metrics; an averager with nothing to print warns
    alike."""
    import inspect

    assert inspect.signature(metrics.ResultsAverager.print_sheets_friendly) == \
        inspect.signature(jmetrics.ResultsAverager.print_sheets_friendly)
    ours, theirs = metrics.ResultsAverager("x", "frame"), jmetrics.ResultsAverager("x", "frame")

    def printed(avg, **kw):
        capsys.readouterr()
        avg.print_sheets_friendly(**kw)
        return capsys.readouterr().out

    assert printed(ours) == printed(theirs) == "WARNING: No valid metrics to print.\n"
    rng = np.random.RandomState(5)
    for _ in range(3):
        e = {"iou_d_1.5": rng.rand(), "abs_rel": 10 * rng.rand(), "model_time": 100 * rng.rand()}
        ours.update_results(e)
        theirs.update_results(e)
    kws = [dict(include_metrics_names=n, print_running_metrics=r, print_exp_name=x)
           for n in (False, True) for r in (True, False) for x in (True, False)]
    # before compute_final_average the final metrics are empty: both warn
    assert printed(ours, print_running_metrics=False) == printed(theirs, print_running_metrics=False)
    for avg in (ours, theirs):
        avg.compute_final_average()
    for kw in kws + [{}]:
        got = printed(ours, **kw)
        assert got == printed(theirs, **kw) and "," in got


@pytest.fixture(scope="module")
def eval_setup():
    """Tiny BD model on the synthetic_smoke sizes (96x64, 3 views, 8 bins)."""
    from implicit_depth_tpu.data.mvs_dataset import collate

    ds = SyntheticDataset(num_frames=6, num_views=3, split="test", get_bd_info=True)
    jnet = JBDNet(image_encoder_name="tiny", num_src_views=2, num_depth_bins=8)
    cur, src = collate([ds[0]])
    variables = seeded_variables(
        lambda key, c, s: jnet.init({"params": key}, c, s, method=JBDNet.forward_val),
        cur, src, seed=5)
    net = bridged(BDNet(image_encoder_name="tiny", num_src_views=2, num_depth_bins=8),
                  variables, TRAIN_ONLY_PREFIXES)
    return ds, jnet, variables, net


@pytest.mark.parametrize("mode", ["thresholder", "sweep"])
def test_evaluate_scenes_matches_jax(eval_setup, mode):
    ds, jnet, variables, net = eval_setup
    if mode == "thresholder":
        kw_t = dict(thresholder=bm.Thresholder(PLANES, THRESHOLDS))
        kw_j = dict(thresholder=jbm.Thresholder(jnp.asarray(PLANES), jnp.asarray(THRESHOLDS)))
    else:
        kw_t = kw_j = dict(thresholds=(0.4, 0.5))
    got = occ.evaluate_scenes(net, {"scene0": ds}, batch_size=2, **kw_t)
    ref = jocc.evaluate_scenes(jnet, variables, {"scene0": ds}, batch_size=2, **kw_j)
    g, r = got["all_scene"].final_metrics, ref["all_scene"].final_metrics
    assert sorted(g) == sorted(r)
    assert got["forwards"] == 2 and got["launches"] == 0 and got["nonfinite_preds"] == 0
    ious = [k for k in r if "iou" in k]
    assert len(ious) == (72 if mode == "thresholder" else 48)
    for k in ious:
        assert np.isnan(g[k]) == np.isnan(r[k]), k
        if not np.isnan(r[k]):
            assert abs(g[k] - r[k]) <= 1e-3, (k, g[k], r[k])
    for scene_avg_g, scene_avg_r in zip(got["scenes"].values(), ref["scenes"].values()):
        assert len(scene_avg_g.elem_metrics_list) == len(scene_avg_r.elem_metrics_list) == 4


def test_test_bd_cli_on_bridged_weights(tmp_path, capsys):
    from implicit_depth_tpu.data.mvs_dataset import collate

    ds = SyntheticDataset(num_frames=5, num_views=3, split="test", get_bd_info=True)
    jnet = JBDNet(image_encoder_name="tiny", num_src_views=2, num_depth_bins=8)
    cur, src = collate([ds[0]])
    variables = seeded_variables(
        lambda key, c, s: jnet.init({"params": key}, c, s, method=JBDNet.forward_val),
        cur, src, seed=6)
    ckpt = tmp_path / "bd.pt"
    torch.save(state_dict_from_flax(to_numpy_tree(variables)), ckpt)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    results = cli.main([
        "--config_file", os.path.join(repo, "configs/models/implicit_depth.yaml"),
        "--data_config_file", os.path.join(repo, "configs/data/synthetic_smoke.yaml"),
        "--load_weights_from_checkpoint", str(ckpt),
        "--image_encoder_name", "tiny", "--precision", "32", "--device", "cpu",
        "--split", "test", "--synthetic_num_frames", "5", "--val_batch_size", "2",
        "--output_base_path", str(tmp_path / "out"), "--name", "port",
    ])
    printed = capsys.readouterr().out
    assert "model_time:" in printed and "boundary_iou" in printed
    assert results["forwards"] == 2 and results["nonfinite_preds"] == 0
    scores = json.loads((tmp_path / "out/port/scores/all_scenes_metrics.json").read_text())
    assert "surface_iou_d_3.0" in scores["scores"]


def test_build_net_refuses_unported_configs():
    """The skip decoder and the FPN matching encoder build now, for both
    kinds; what the port does not have is still refused: an unknown image
    encoder or decoder (ValueError, as the JAX package) and a volume type
    the port lacks (NotImplementedError)."""
    from implicit_depth_tpu.config import Config
    from implicit_depth_tpu_torch.models.decoders import SkipDecoder
    from implicit_depth_tpu_torch.models.depth_net import DepthNet
    from implicit_depth_tpu_torch.models.fpn_matching import FPNMatchingEncoder
    from implicit_depth_tpu_torch.train.loop import build_net

    def cfg(**kw):
        return Config(**{"image_encoder_name": "tiny", "model_num_views": 3,
                         "matching_num_depth_bins": 8, **kw})

    for kind, cls in (("bd", BDNet), ("regression", DepthNet)):
        net = build_net(cfg(depth_decoder_name="skip"), kind)
        assert isinstance(net, cls) and isinstance(net.decoder, SkipDecoder)
        assert net.decoder.regression_heads == (kind == "regression")
        net = build_net(cfg(matching_encoder_type="fpn"), kind)
        assert isinstance(net.matching, FPNMatchingEncoder)
        for field, value, error in (("image_encoder_name", "vgg16", ValueError),
                                    ("depth_decoder_name", "no_such_decoder", ValueError),
                                    ("feature_volume_type", "cost_volume", NotImplementedError)):
            with pytest.raises(error):
                build_net(cfg(**{field: value}), kind)
    net = build_net(Config(image_encoder_name="tiny", model_num_views=3,
                           matching_num_depth_bins=8, precision=32))
    assert net.compute_dtype == torch.float32 and net.volume_mlp.num_src_views == 2
