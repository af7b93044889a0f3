"""The encoder zoo beyond model (a)'s parity tests: forward_val of the BD
models with the bottleneck encoders (b) `resnext101_64x4d` and (c)
`seresnextaa101d_32x8d`, full depth, ResNet matching and U-Net++, against
the JAX package on the CPU in f32 (1e-4 of the largest logit, as
tests/test_torch_model_variants.py, whose sizes these share); the
reference converter on a `resnet18d` BD checkpoint; and cli/test_bd.py and
cli/train.py on model (a) at 64x96 on the CPU.

The converter: a timm-layout `resnet18d` reference BD state dict
(tests/torch_parity.py::reference_state_dict_from_flax) goes back to the
flax tree through the JAX converter, and through
`convert_reference_bd_state_dict` into a strict load of the port's BDNet,
whose `forward_val` matches the JAX BDNet's on the same tree (5e-5, as
tests/test_torch_checkpoint.py).
"""

import os

import jax
import numpy as np
import pytest
import torch

from implicit_depth_tpu.models.bd_net import BDNet as JBDNet
from implicit_depth_tpu.utils.fixtures import synthetic_bd_batch
from implicit_depth_tpu_torch.models import image_encoders
from implicit_depth_tpu_torch.models.bd_net import BDNet
from implicit_depth_tpu_torch.train import checkpoint as ckpt
from implicit_depth_tpu_torch.weights import init_params, load_state_dict
from tests.test_torch_model_variants import D_BINS, K, MODELS, _torch, check_forward_val
from tests.torch_parity import (assert_close, reference_state_dict_from_flax, seeded_variables,
                                to_numpy_tree)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads in this module's process, as in
    tests/test_torch_model_variants.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("model", ["b", "c"])
def test_bottleneck_forward_val_matches_jax(model):
    check_forward_val(model)


# ------------------------------------------------------------- converter

def test_resnet18d_reference_checkpoint_round_trip():
    from implicit_depth_tpu.train import checkpoint as jckpt

    cur, src = synthetic_bd_batch(batch=1, num_src=K, height=64, width=96, num_planes=3,
                                  num_rays=16, samples_per_ray=8, seed=0)
    kw = dict(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="resnet18d")
    jnet = JBDNet(train_bn=True, **kw)
    variables = seeded_variables(lambda key, c, s: jnet.init({"params": key}, c, s, flip=False),
                                 cur, src, seed=44)
    ref_sd = reference_state_dict_from_flax(to_numpy_tree(variables))
    assert "encoder.conv1.3.weight" in ref_sd and "encoder.layer2.0.downsample.1.weight" in ref_sd
    params, stats = jckpt.convert_reference_bd_checkpoint(ref_sd)
    jax.tree.map(np.testing.assert_array_equal, {"params": params, "batch_stats": stats},
                 to_numpy_tree(variables))

    net = BDNet(**kw)
    load_state_dict(net, ckpt.convert_reference_bd_state_dict(ref_sd))  # strict
    assert isinstance(net.encoder, image_encoders.ResNet18D)
    jeval = JBDNet(**kw)
    ref = jax.jit(lambda v, c, s: jeval.apply(v, c, s, method=JBDNet.forward_val))(
        {"params": params, "batch_stats": stats}, cur, src)
    with torch.no_grad():
        got = net.eval().forward_val(_torch(cur), _torch(src))
    assert_close(got["pred_0"], ref["pred_0"], 5e-5)


# ------------------------------------------------------------------ CLIs

_ZOO_FLAGS = ["--image_encoder_name", "resnet18d", "--matching_encoder_type", "fpn",
              "--depth_decoder_name", "skip", "--device", "cpu", "--precision", "32"]


def test_test_bd_cli_runs_model_a(tmp_path):
    from implicit_depth_tpu_torch.cli import test_bd

    weights = tmp_path / "a.pt"
    net = init_params(BDNet(num_src_views=2, num_depth_bins=8, **MODELS["a"]),
                      torch.Generator().manual_seed(0))
    torch.save(net.state_dict(), weights)
    res = test_bd.main([
        "--config_file", os.path.join(REPO, "configs/models/implicit_depth.yaml"),
        "--data_config_file", os.path.join(REPO, "configs/data/synthetic_smoke.yaml"),
        "--load_weights_from_checkpoint", str(weights), "--split", "test",
        "--synthetic_num_frames", "5", "--val_batch_size", "2",
        "--output_base_path", str(tmp_path / "out"), "--name", "zoo"] + _ZOO_FLAGS)
    assert res["forwards"] == 2 and res["nonfinite_preds"] == 0
    assert (tmp_path / "out/zoo/scores/all_scenes_metrics.json").exists()


def test_train_cli_runs_model_a(tmp_path):
    from implicit_depth_tpu_torch.cli import train

    res = train.main([
        "--config_file", os.path.join(REPO, "configs/models/regression_model.yaml"),
        "--data_config_file", os.path.join(REPO, "configs/data/synthetic_smoke.yaml"),
        "--max_steps", "2", "--batch_size", "2", "--log_dir", str(tmp_path),
        "--num_workers", "2", "--log_interval", "1", "--val_interval", "2",
        "--val_batches", "1", "--val_batch_size", "2", "--synthetic_num_frames", "8"]
        + _ZOO_FLAGS)
    assert res["step"] == 2 and np.isfinite(res["losses"]["loss"])
    model = torch.load(os.path.join(res["checkpoint"], "state.pt"), map_location="cpu",
                       weights_only=True)["model"]
    assert "matching.lateral_0.weight" in model and "decoder.out4_2.weight" in model
