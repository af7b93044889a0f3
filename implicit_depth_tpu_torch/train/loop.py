"""Model and dataset constructors shared by the entry points, counterpart of
implicit_depth_tpu/train/loop.py::build_net / build_dataset (whose module
imports JAX). `fit` comes with the training slice."""

from __future__ import annotations

import torch

from implicit_depth_tpu.config import Config
from implicit_depth_tpu.data.mvs_dataset import BDSamplingConfig
from implicit_depth_tpu.data.registry import get_dataset
from implicit_depth_tpu_torch.models.bd_net import BDNet


def build_net(cfg: Config) -> BDNet:
    """The BD model of a config, with bf16 compute at precision 16."""
    ported = ("mlp_feature_volume", "unet_pp", "resnet", False)
    if (cfg.feature_volume_type, cfg.depth_decoder_name, cfg.matching_encoder_type,
            cfg.use_prior) != ported:
        raise NotImplementedError(
            "the port runs the metadata volume, the U-Net++ decoder and the ResNet "
            "matching encoder, without the prior")
    return BDNet(
        image_encoder_name=cfg.image_encoder_name,
        matching_scale=cfg.matching_scale,
        matching_feature_dims=cfg.matching_feature_dims,
        num_depth_bins=cfg.matching_num_depth_bins,
        num_src_views=cfg.num_src_views,
        min_matching_depth=cfg.min_matching_depth,
        max_matching_depth=cfg.max_matching_depth,
        compute_dtype=torch.bfloat16 if cfg.precision == 16 else torch.float32,
    )


def build_dataset(cfg: Config, split: str, limit_to_scan_id=None, pass_frame_id: bool = False):
    """The BD dataset of a config (the JAX package's numpy datasets)."""
    cls, _ = get_dataset(cfg.dataset, None, None)
    kwargs = dict(
        pass_frame_id=pass_frame_id,
        split=split,
        image_height=cfg.image_height,
        image_width=cfg.image_width,
        shuffle_tuple=cfg.shuffle_tuple,
        get_bd_info=True,
        full_depth_supervision=cfg.full_depth_supervision,
        bd_config=BDSamplingConfig(
            num_rays=cfg.num_rays,
            samples_per_ray=cfg.samples_per_ray,
            near_surface_ratio=cfg.near_surface_ratio,
            surface_noise_type=cfg.surface_noise_type,
        ),
        include_full_res_depth=cfg.high_res_validation,
    )
    if cfg.dataset == "synthetic":
        return cls(num_views=cfg.model_num_views, num_frames=cfg.synthetic_num_frames, **kwargs)
    if cfg.dataset == "hypersim":
        kwargs["use_min_max_depth"] = cfg.use_min_max_depth
    return cls(dataset_path=cfg.dataset_path,
               mv_tuple_file_suffix=cfg.mv_tuple_file_suffix,
               tuple_info_file_location=cfg.tuple_info_file_location,
               num_images_in_tuple=cfg.num_images_in_tuple or cfg.model_num_views,
               limit_to_scan_id=limit_to_scan_id,
               skip_frames=cfg.skip_frames, **kwargs)
