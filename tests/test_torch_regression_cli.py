"""The depth-regression CLIs of the port on the CPU (--device cpu):
cli/train.py (fit, kind "regression") for two steps on the synthetic
config, and cli/test_reg.py end to end from a bridged checkpoint, its depth
metrics against the JAX DepthNet, compute_depth_metrics_batched and
ResultsAverager on the same tuples: 1e-4 relative (f32 sums in another
order through ~60 layers, then means over frames); an IoU that is NaN
(an empty plane) is NaN on both sides."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_depth_tpu.eval import binary_metrics as jbm
from implicit_depth_tpu.eval import metrics as jmetrics
from implicit_depth_tpu.models.blocks import resize_bilinear as jresize_bilinear
from implicit_depth_tpu.models.depth_net import DepthNet as JDepthNet
from implicit_depth_tpu_torch.weights import state_dict_from_flax
from tests.torch_parity import seeded_variables, to_numpy_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_train_cli_two_steps_on_cpu(tmp_path):
    from implicit_depth_tpu_torch.cli import train

    res = train.main([
        "--config_file", os.path.join(REPO, "configs/models/regression_model.yaml"),
        "--data_config_file", os.path.join(REPO, "configs/data/synthetic_smoke.yaml"),
        "--device", "cpu", "--max_steps", "2", "--image_encoder_name", "tiny",
        "--precision", "32", "--batch_size", "2", "--log_dir", str(tmp_path),
        "--num_workers", "2", "--log_interval", "1", "--val_interval", "2",
        "--val_batches", "1", "--val_batch_size", "2", "--synthetic_num_frames", "8"])
    assert res["step"] == 2 and np.isfinite(res["losses"]["loss"])
    assert set(res["losses"]) == {"loss", "ms_loss", "grad_loss", "normals_loss", "mv_loss",
                                  "si_loss", "abs_loss", "inv_abs_loss", "log_l1_loss"}
    assert np.isfinite(res["val"]["val/loss"])
    ckpt = torch.load(res["checkpoint"], map_location="cpu", weights_only=True)
    assert ckpt["step"] == 2 and "decoder.output_head_0.weight" in ckpt["model"]


@pytest.mark.parametrize("mode", ["depth_res", "high_res", "plane_eval"])
def test_test_reg_cli_on_bridged_weights(tmp_path, capsys, mode):
    """cli/test_reg.py from a bridged checkpoint against the JAX DepthNet,
    compute_depth_metrics_batched, regression_plane_scores and
    ResultsAverager on the same tuples: at depth resolution, at native
    resolution (--high_res_validation) and with the plane IoUs
    (--regression_plane_eval, on the BD dataset's rendered depths)."""
    from implicit_depth_tpu.data.mvs_dataset import collate
    from implicit_depth_tpu.data.synthetic import SyntheticDataset
    from implicit_depth_tpu_torch.cli import test_reg

    high_res, plane_eval = mode == "high_res", mode == "plane_eval"
    ds = SyntheticDataset(num_frames=5, num_views=3, split="test", include_full_res_depth=high_res,
                          get_bd_info=plane_eval)
    jnet = JDepthNet(image_encoder_name="tiny", num_src_views=2, num_depth_bins=8)
    cur, src = collate([ds[0]])
    cur = {k: v for k, v in cur.items() if k != "frame_id_string"}
    src = {k: v for k, v in src.items() if k != "frame_id_string"}
    variables = seeded_variables(lambda key, c, s: jnet.init({"params": key}, c, s), cur, src,
                                 seed=6)
    ckpt = tmp_path / "reg.pt"
    torch.save(state_dict_from_flax(to_numpy_tree(variables)), ckpt)
    args = [
        "--config_file", os.path.join(REPO, "configs/models/regression_model.yaml"),
        "--data_config_file", os.path.join(REPO, "configs/data/synthetic_smoke.yaml"),
        "--load_weights_from_checkpoint", str(ckpt), "--image_encoder_name", "tiny",
        "--precision", "32", "--device", "cpu", "--split", "test",
        "--synthetic_num_frames", "5", "--val_batch_size", "2",
        "--output_base_path", str(tmp_path / "out"), "--name", "port"]
    flag = {"depth_res": [], "high_res": ["--high_res_validation"],
            "plane_eval": ["--regression_plane_eval"]}[mode]
    results = test_reg.main(args + flag)
    printed = capsys.readouterr().out
    assert "model_time:" in printed and "abs_rel" in printed
    assert results["forwards"] == 2 and results["nonfinite_preds"] == 0
    scores = json.loads((tmp_path / "out/port/scores/depth_metrics.json").read_text())["scores"]

    apply = jax.jit(lambda v, c, s: jnet.apply(v, c, s))
    avg = jmetrics.ResultsAverager("jax", "depth metrics")
    for start in range(0, len(ds), 2):
        c, s = collate([ds[i] for i in range(start, min(start + 2, len(ds)))])
        c = {k: jnp.asarray(v) for k, v in c.items() if k != "frame_id_string"}
        s = {k: jnp.asarray(v) for k, v in s.items() if k != "frame_id_string"}
        pred = apply(variables, c, s)["depth_pred_0"]
        gt = c["depth"]
        if high_res:
            gt = c["full_res_depth"]
            pred = jresize_bilinear(pred, gt.shape[1], gt.shape[2])
        b = gt.shape[0]
        m = jmetrics.compute_depth_metrics_batched(
            jnp.nan_to_num(gt, nan=1.0).reshape(b, -1), pred.reshape(b, -1),
            (jnp.nan_to_num(gt, nan=0.0) > 0.5).reshape(b, -1))
        if plane_eval:
            m.update(jbm.scores_to_dict(jbm.regression_plane_scores(c["rendered_depth"], gt, pred)))
        for i in range(b):
            avg.update_results({k: v[i] for k, v in m.items()})
    avg.compute_final_average(ignore_nans=True)
    assert sorted(scores) == sorted(avg.final_metrics)
    assert plane_eval == ("iou_d_3.0" in scores)
    for k, v in avg.final_metrics.items():
        if np.isnan(v):
            assert scores[k] is None or np.isnan(scores[k]), k
        else:
            assert abs(scores[k] - v) <= 1e-4 * max(abs(v), 1.0), k
