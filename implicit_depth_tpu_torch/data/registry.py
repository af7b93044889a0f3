"""Dataset registry (parity: utils/dataset_utils.py:15-151).

Copy of implicit_depth_tpu/data/registry.py for the datasets the port has
copies of: scannet and synthetic. The others (hypersim, vdr, 7scenes,
colmap, arkit, scanniverse) import geometry helpers of the JAX package
(`rotx`, `qvec2rotmat` from core/geometry.py) and are not copied yet.

get_dataset(name, split_filepath, single_debug_scan_id) -> (class, scans).
"""

from __future__ import annotations

from typing import Optional

from implicit_depth_tpu_torch.utils.io import readlines

# dataset name -> the JAX package's module that still has to be copied
NOT_PORTED = {
    "hypersim": "implicit_depth_tpu/data/hypersim.py",
    "vdr": "implicit_depth_tpu/data/vdr.py",
    "7scenes": "implicit_depth_tpu/data/seven_scenes.py",
    "sevenscenes": "implicit_depth_tpu/data/seven_scenes.py",
    "colmap": "implicit_depth_tpu/data/colmap.py",
    "arkit": "implicit_depth_tpu/data/arkit.py",
    "scanniverse": "implicit_depth_tpu/data/scanniverse.py",
}


def get_dataset(name: str, split_filepath: Optional[str] = None,
                single_debug_scan_id: Optional[str] = None):
    name = name.lower()
    if name == "scannet":
        from implicit_depth_tpu_torch.data.scannet import ScanNetDataset
        cls = ScanNetDataset
    elif name == "synthetic":
        from implicit_depth_tpu_torch.data.synthetic import SyntheticDataset
        cls = SyntheticDataset
    elif name in NOT_PORTED:
        raise NotImplementedError(
            f"dataset '{name}' is not in the port yet: {NOT_PORTED[name]} has to be copied")
    else:
        raise ValueError(f"Unknown dataset '{name}'")

    scans = None
    if single_debug_scan_id is not None:
        scans = [single_debug_scan_id]
    elif split_filepath:
        scans = [s for s in readlines(split_filepath) if s.strip()]
    return cls, scans
