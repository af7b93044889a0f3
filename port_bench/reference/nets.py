"""The reference nets of a benchmark configuration, in f32: the frozen
copies of BDNet and DepthNet built with the arguments that the port's
train/loop.py::build_net takes from the same configuration keys."""

from __future__ import annotations

import torch

from port_bench.reference.bd_net import BDNet
from port_bench.reference.depth_net import DepthNet


def build_reference(config: dict):
    """BDNet for kind "bd", DepthNet for kind "regression", compute in f32."""
    common = dict(
        image_encoder_name=config["image_encoder_name"],
        feature_volume_type=config["feature_volume_type"],
        depth_decoder_name=config["depth_decoder_name"],
        matching_encoder_type=config["matching_encoder_type"],
        matching_scale=config.get("matching_scale", 1),
        matching_feature_dims=config.get("matching_feature_dims", 16),
        num_depth_bins=config["matching_num_depth_bins"],
        num_src_views=config["model_num_views"] - 1,
        min_matching_depth=config.get("min_matching_depth", 0.25),
        max_matching_depth=config.get("max_matching_depth", 5.0),
        compute_dtype=torch.float32,
    )
    if config["kind"] == "regression":
        return DepthNet(**common)
    return BDNet(use_prior=config.get("use_prior", False),
                 bd_sigmoid_multiplier=config.get("bd_sigmoid_multiplier", 1.0), **common)
