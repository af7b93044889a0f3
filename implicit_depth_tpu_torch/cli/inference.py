"""Occlusion-matte inference with the PyTorch port (counterpart of
scripts/inference.py; reference: inference/inference.py): the first scan of
the config's split, one sigmoid matte per frame of its dense tuples, saved
as <output_base_path>/<name>/mattes/<scan>/<frame id:05d>.npy.

    python -m implicit_depth_tpu_torch.cli.inference \
        --config_file configs/models/implicit_depth_temporal.yaml \
        --data_config_file configs/data/vdr_dense.yaml \
        --load_weights_from_checkpoint weights.pt \
        [--rendered_depth_map_load_dir renders/] [--bd_sigmoid_multiplier 1.0] \
        [--max_frames N] [--device cuda]

Each frame queries the model with the rendered virtual-asset depth
<rendered_depth_map_load_dir>/<frame id>.npy (holes filled by a 7x7 max
pool), or a 2 m plane without the flag; a config with use_prior feeds each
matte back as the next frame's prior. The checkpoint is loaded as
cli/test_bd.py loads it. The device defaults to cuda; --device cpu runs the
kernel's plain version on the CPU.
"""

from __future__ import annotations

import os

from implicit_depth_tpu_torch.apps.inference import run_inference
from implicit_depth_tpu_torch.cli.test_bd import load_bd_net
from implicit_depth_tpu_torch.config import parse_config
from implicit_depth_tpu_torch.data.registry import get_dataset
from implicit_depth_tpu_torch.train.loop import build_dataset


def main(argv=None) -> dict:
    """Returns {"out_dir", "saved" (the matte paths), "frame_ms" (each
    frame's wall time)}."""
    cfg, device = parse_config(argv)
    net = load_bd_net(cfg, device)
    _, scans = get_dataset(cfg.dataset, cfg.dataset_scan_split_file, cfg.single_debug_scan_id)
    scan = (scans or ["scene0"])[0]
    # pass_frame_id: mattes are saved under the tuple's real frame number
    # (reference inference.py:162), which composite_capture looks up by the
    # padded capture frame name; dataset indices would misalign
    ds = build_dataset(cfg, cfg.split, "bd", limit_to_scan_id=scan, pass_frame_id=True)
    out_dir = os.path.join(cfg.output_base_path, cfg.name, "mattes", scan)
    frame_ms: list = []
    saved = run_inference(
        net, ds, out_dir,
        rendered_depth_load_dir=cfg.rendered_depth_map_load_dir,
        sigmoid_multiplier=cfg.bd_sigmoid_multiplier,
        use_prior=cfg.use_prior,
        max_frames=cfg.max_frames,
        frame_ms=frame_ms,
    )
    print(f"saved {len(saved)} mattes to {out_dir}")
    return {"out_dir": out_dir, "saved": saved, "frame_ms": frame_ms}


if __name__ == "__main__":
    main()
