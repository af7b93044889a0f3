"""cli/make_random_checkpoint.py against scripts/make_random_checkpoint.py
on the CPU: for the same config (the flagship's with the tiny encoder, on
the synthetic data config's 64x96 validation items) the port's file holds
the keys and shapes of the JAX script's (through
weights.state_dict_from_flax: every tensor but the training-only query
heads), loads strictly into the net otherwise, and the same --seed gives
the same weights. The JAX script initialises op by op (about a minute on
an 8-core x86 host), so this test has a file of its own.
"""

import os

import torch

from implicit_depth_tpu_torch.cli import make_random_checkpoint
from implicit_depth_tpu_torch.models.bd_net import TRAIN_ONLY_PREFIXES, BDNet
from implicit_depth_tpu_torch.train import checkpoint as ckpt
from implicit_depth_tpu_torch.weights import load_state_dict, state_dict_from_flax
from tests.torch_parity import run_jax_script

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_make_random_checkpoint_matches_the_jax_tree(tmp_path):
    from flax import serialization

    args = ["--config_file", os.path.join(REPO, "configs/models/implicit_depth.yaml"),
            "--data_config_file", os.path.join(REPO, "configs/data/synthetic_smoke.yaml"),
            "--image_encoder_name", "tiny", "--split", "val"]
    run_jax_script("make_random_checkpoint.py", args + ["--output", str(tmp_path / "j.msgpack")])
    with open(tmp_path / "j.msgpack", "rb") as f:
        ref = state_dict_from_flax(serialization.msgpack_restore(f.read()))
    out = make_random_checkpoint.main(args + ["--output", str(tmp_path / "p.pt"), "--seed", "3"])
    got = ckpt.load_weights(out)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    net = BDNet(num_src_views=2, num_depth_bins=8, image_encoder_name="tiny")
    load_state_dict(net, got, optional_prefixes=TRAIN_ONLY_PREFIXES)  # strict otherwise
    again = make_random_checkpoint.main(args + ["--output", str(tmp_path / "q.pt"),
                                                "--seed", "3"])
    assert all(torch.equal(v, ckpt.load_weights(again)[k]) for k, v in got.items())
