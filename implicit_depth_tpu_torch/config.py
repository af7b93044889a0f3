"""Typed experiment configuration.

Copy of implicit_depth_tpu/config.py without `parse_and_merge` and its
compile-cache helper (those import JAX): `Config`, `build_parser`,
`load_yaml_options`, `merge_dict`, `_coerce`, `save_config`. `yaml` is
imported where a file is read or written, so that the module imports
without it.

The original replaces the reference's Options dataclass + OptionsHandler (options.py:9-394)
with the same two-file (model config + data config) + CLI layering, but:
- plain-dict YAML (no `!!python/object` tags); reference-style tagged files
  are accepted by stripping the tag,
- unknown keys raise instead of silently setattr-ing
  (options.py:351-357 footgun documented in SURVEY.md §2.1),
- fields that only existed in YAML in the reference
  (binary_loss_positive_weight, consumed at bd_model.py:100) are declared.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass, field
from typing import List, Optional



@dataclass
class Config:
    random_seed: int = 0

    # ---- logs
    name: str = "debug"
    log_dir: str = os.path.join(os.path.expanduser("~"), "tmp/tensorboard")
    notes: str = ""
    log_interval: int = 100
    val_interval: int = 1000
    val_batches: int = 100

    # ---- data
    dataset: str = "scannet"
    dataset_path: str = "/data/scannet"
    num_workers: int = 12
    tuple_info_file_location: str = "data_splits/ScanNetv2/standard_split/"
    mv_tuple_file_suffix: str = "_eight_view_deepvmvs.txt"
    frame_tuple_type: str = "default"
    model_num_views: int = 8
    num_images_in_tuple: Optional[int] = None
    dataset_scan_split_file: str = ""
    split: str = "train"
    image_width: int = 512
    image_height: int = 384
    shuffle_tuple: bool = False
    test_keyframe_buffer_size: int = 30
    full_depth_supervision: bool = True
    # hypersim: mask depth to (min,max) range instead of NaN-only
    # (datasets/hypersim_dataset.py:135-145, configs/data/hypersim_default_test.yaml)
    use_min_max_depth: bool = False

    # ---- hyperparameters
    lr: float = 1e-4
    wd: float = 1e-4
    num_sanity_val_steps: int = 0
    max_steps: int = 110000
    batch_size: int = 16
    val_batch_size: int = 16
    gpus: int = 2  # kept for config compat; device count comes from jax
    precision: int = 16  # 16 => bf16 compute on TPU
    lr_steps: List[int] = field(default_factory=lambda: [70000, 80000])
    near_surface_ratio: float = 0.25
    surface_noise_type: str = "additive"
    bd_regularisation_weight: float = 0.5
    bd_edge_regularision: bool = True
    binary_loss_positive_weight: float = 1.0
    num_rays: int = 4096
    samples_per_ray: int = 64

    # ---- distributed (multi-host, SURVEY §2.6; reference: DDP over any
    # #GPUs, train_bd.py:145-159). On TPU pods the runtime provides the
    # cluster topology and the address/count/id fields stay None.
    jax_distributed: bool = False
    coordinator_address: Optional[str] = None
    distributed_num_processes: Optional[int] = None
    distributed_process_id: Optional[int] = None

    # ---- models
    resume: Optional[str] = None
    load_weights_from_checkpoint: Optional[str] = None
    lazy_load_weights_from_checkpoint: Optional[str] = None
    image_encoder_name: str = "efficientnet"
    depth_decoder_name: str = "unet_pp"
    loss_type: str = "log_l1"
    matching_encoder_type: str = "resnet"
    matching_feature_dims: int = 16
    matching_scale: int = 1
    matching_num_depth_bins: int = 64
    min_matching_depth: float = 0.25
    max_matching_depth: float = 5.0
    cv_encoder_type: str = "multi_scale_encoder"
    feature_volume_type: str = "mlp_feature_volume"
    use_prior: bool = False

    # ---- inference / eval
    output_base_path: str = "outputs/"
    rendered_depth_map_load_dir: Optional[str] = None
    single_debug_scan_id: Optional[str] = None
    skip_frames: Optional[int] = None
    max_frames: Optional[int] = None
    synthetic_num_frames: int = 16  # synthetic fixture sequence length
    mask_pred_depth: bool = False
    cache_depths: bool = False
    high_res_validation: bool = False
    fast_cost_volume: bool = False
    binary_eval_depth: bool = False
    use_validation_thresholds: bool = False
    regression_plane_eval: bool = False
    skinny_cache_dump: bool = False
    temporal_eval: bool = False
    temporal_scan: bool = False  # device-resident lax.scan window loop
    eval_length: int = 15
    eval_frame_multiplier: int = 8
    warmup: int = 2
    bd_sigmoid_multiplier: float = 1.0

    # ---- visualization
    dump_depth_visualization: bool = False

    # ---- TPU-specific (new)
    remat_volume: bool = False  # rematerialise warp+volume in backward
    data_axis: str = "data"
    mesh_shape: Optional[List[int]] = None  # None => all devices on data axis
    compute_dtype: str = "bfloat16"

    # -- derived helpers -----------------------------------------------
    @property
    def matching_height(self) -> int:
        return self.image_height // (2 ** (self.matching_scale + 1))

    @property
    def matching_width(self) -> int:
        return self.image_width // (2 ** (self.matching_scale + 1))

    @property
    def depth_height(self) -> int:
        return self.image_height // 2

    @property
    def depth_width(self) -> int:
        return self.image_width // 2

    @property
    def num_src_views(self) -> int:
        return self.model_num_views - 1


_FIELDS = {f.name: f for f in dataclasses.fields(Config)}


def load_yaml_options(path: str) -> dict:
    """Loads a YAML config, tolerating the reference's python-object tag."""
    import yaml

    with open(path) as f:
        text = f.read()
    text = text.replace("!!python/object:options.Options", "")
    data = yaml.safe_load(text) or {}
    if not isinstance(data, dict):
        raise ValueError(f"Config {path} did not parse to a mapping")
    return data


def merge_dict(cfg: Config, values: dict, source: str = "?") -> Config:
    for k, v in values.items():
        if k not in _FIELDS:
            raise KeyError(f"Unknown config key '{k}' from {source}")
        setattr(cfg, k, v)
    return cfg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="implicit_depth_tpu options")
    p.add_argument("--config_file", type=str, default=None)
    p.add_argument("--data_config_file", type=str, default=None)
    for name, f in _FIELDS.items():
        if f.type == bool or f.type == "bool":
            p.add_argument(f"--{name}", action="store_true", default=None)
        else:
            p.add_argument(f"--{name}", type=str, default=None)
    return p


def _coerce(name: str, raw: str):
    f = _FIELDS[name]
    t = f.type if isinstance(f.type, str) else getattr(f.type, "__name__", str(f.type))
    if "int" in str(t) and "List" not in str(t):
        return int(raw)
    if "float" in str(t):
        return float(raw)
    if "List" in str(t):
        return [int(x) for x in str(raw).replace(",", " ").split()]
    return raw


def parse_config(argv=None) -> tuple[Config, str]:
    """Model config file, then data config file, then CLI flags; later
    wins (the JAX package's parse_and_merge, without its JAX compile
    cache), plus the port's `--device` (default cuda). Returns (config,
    device)."""
    parser = build_parser()
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    cfg = Config()
    for path in (args.config_file, args.data_config_file):
        if path:
            merge_dict(cfg, load_yaml_options(path), source=path)
    for name in _FIELDS:
        raw = getattr(args, name, None)
        if raw is True:
            setattr(cfg, name, True)
        elif isinstance(raw, str):
            setattr(cfg, name, _coerce(name, raw))
    return cfg, args.device


def save_config(cfg: Config, path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f, default_flow_style=False)
