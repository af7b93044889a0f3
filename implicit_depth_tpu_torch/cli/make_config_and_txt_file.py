"""Writes a per-sequence data config and its scan list for inference
(counterpart of scripts/make_config_and_txt_file.py; reference:
inference/make_config_and_txt_file.py). Host only.

    python -m implicit_depth_tpu_torch.cli.make_config_and_txt_file \
        --dataset_path captures/ --scan_id seq0 [--dataset vdr] \
        [--output_dir configs/data/generated]

Writes <output_dir>/<scan_id>.txt (the scan list) and <output_dir>/
<scan_id>.yaml (a dense-tuple test config of 8 images over that list).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> tuple:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", default="vdr")
    p.add_argument("--dataset_path", required=True)
    p.add_argument("--scan_id", required=True)
    p.add_argument("--output_dir", default="configs/data/generated")
    args = p.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    txt = os.path.join(args.output_dir, f"{args.scan_id}.txt")
    with open(txt, "w") as f:
        f.write(args.scan_id + "\n")
    cfg = os.path.join(args.output_dir, f"{args.scan_id}.yaml")
    with open(cfg, "w") as f:
        f.write(f"dataset: {args.dataset}\n")
        f.write(f"dataset_path: {args.dataset_path}\n")
        f.write(f"dataset_scan_split_file: {txt}\n")
        f.write(f"tuple_info_file_location: {args.output_dir}\n")
        f.write(f"mv_tuple_file_suffix: _{args.scan_id}_dense.txt\n")
        f.write("frame_tuple_type: dense\nsplit: test\nnum_images_in_tuple: 8\n")
    print(f"wrote {cfg} and {txt}")
    return cfg, txt


if __name__ == "__main__":
    main()
