"""Dataset registry (parity: utils/dataset_utils.py:15-151).

Copy of implicit_depth_tpu/data/registry.py with only its imports changed
(the port imports nothing of the JAX package).

get_dataset(name, split_filepath, single_debug_scan_id) -> (class, scans).
Names: scannet, synthetic (new fixture); hypersim, vdr, 7scenes, colmap,
arkit, scanniverse register here as their loaders land.
"""

from __future__ import annotations

from typing import Optional

from implicit_depth_tpu_torch.utils.io import readlines


def get_dataset(name: str, split_filepath: Optional[str] = None,
                single_debug_scan_id: Optional[str] = None):
    name = name.lower()
    if name == "scannet":
        from implicit_depth_tpu_torch.data.scannet import ScanNetDataset
        cls = ScanNetDataset
    elif name == "synthetic":
        from implicit_depth_tpu_torch.data.synthetic import SyntheticDataset
        cls = SyntheticDataset
    elif name == "hypersim":
        from implicit_depth_tpu_torch.data.hypersim import HypersimDataset
        cls = HypersimDataset
    elif name == "vdr":
        from implicit_depth_tpu_torch.data.vdr import VDRDataset
        cls = VDRDataset
    elif name in ("7scenes", "sevenscenes"):
        from implicit_depth_tpu_torch.data.seven_scenes import SevenScenesDataset
        cls = SevenScenesDataset
    elif name == "colmap":
        from implicit_depth_tpu_torch.data.colmap import ColmapDataset
        cls = ColmapDataset
    elif name == "arkit":
        from implicit_depth_tpu_torch.data.arkit import ARKitDataset
        cls = ARKitDataset
    elif name == "scanniverse":
        from implicit_depth_tpu_torch.data.scanniverse import ScanniverseDataset
        cls = ScanniverseDataset
    else:
        raise ValueError(f"Unknown dataset '{name}'")

    scans = None
    if single_debug_scan_id is not None:
        scans = [single_debug_scan_id]
    elif split_filepath:
        scans = [s for s in readlines(split_filepath) if s.strip()]
    return cls, scans
