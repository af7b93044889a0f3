"""AR compositing with the PyTorch port (counterpart of scripts/composite.py;
reference: inference/composite.py). Host-side numpy: no device.

Capture mode composites a rendered virtual layer into a raw VDR capture
(capture.json, RGB frames, LiDAR bins) under predicted occlusion mattes
(cli/inference.py's <frame id:05d>.npy), predicted depths or the capture's
own LiDAR depth, and writes each frame and an mp4:

    python -m implicit_depth_tpu_torch.cli.composite --vdr_dir capture/ \
        --predicted_masks_dir outputs/<name>/mattes/<scan> --out_dir composited/

Directory mode blends per-frame RGBA layers into per-frame images:

    python -m implicit_depth_tpu_torch.cli.composite --images_dir rgb/ \
        --virtual_dir layers/ --mattes_dir mattes/ --output composite.mp4
"""

import argparse
import os

import numpy as np

from implicit_depth_tpu_torch.apps.composite import composite_sequence
from implicit_depth_tpu_torch.utils.io import read_image


def main(argv=None) -> str:
    """Returns the path of the mp4 written."""
    p = argparse.ArgumentParser()
    p.add_argument("--vdr_dir", default=None,
                   help="raw VDR capture dir with capture.json; composites "
                        "end-to-end (inference/composite.py main())")
    p.add_argument("--out_dir", default="composited",
                   help="output dir for per-frame composites + mp4 (capture mode)")
    p.add_argument("--predicted_masks_dir", default=None,
                   help="sigma mattes <frame-number>.npy (capture mode, mask matting)")
    p.add_argument("--predicted_depths_dir", default=None,
                   help="predicted depth <frame-number>.npy (capture mode, depth matting)")
    p.add_argument("--renders_dir", default=None,
                   help="rendered virtual layers frame_XXXXX.png/.npy; a flat "
                        "teal 2 m plane when absent")
    p.add_argument("--fadein", action="store_true")
    p.add_argument("--limit_frames", type=int, default=None)
    p.add_argument("--images_dir", default=None, help="captured RGB frames (*.png/jpg)")
    p.add_argument("--virtual_dir", default=None, help="rendered RGBA layers (*.png)")
    p.add_argument("--mattes_dir", default=None, help="predicted occlusion mattes (*.npy)")
    p.add_argument("--real_depth_dir", default=None, help="real depth .npy (depth/lidar modes)")
    p.add_argument("--virtual_depth_dir", default=None, help="virtual depth .npy")
    p.add_argument("--mode", default="mask", choices=["mask", "depth", "lidar"])
    p.add_argument("--output", default="composite.mp4")
    p.add_argument("--fps", type=int, default=30)
    args = p.parse_args(argv)

    if args.vdr_dir:
        from implicit_depth_tpu_torch.apps.composite import composite_capture

        if args.predicted_masks_dir and args.predicted_depths_dir:
            p.error("give either --predicted_masks_dir or --predicted_depths_dir, not both")
        mode = ("mask" if args.predicted_masks_dir
                else "depth" if args.predicted_depths_dir else "lidar")
        mp4 = composite_capture(
            args.vdr_dir, args.out_dir, mode=mode,
            predicted_masks_dir=args.predicted_masks_dir,
            predicted_depths_dir=args.predicted_depths_dir,
            renders_dir=args.renders_dir, fadein=args.fadein,
            limit_frames=args.limit_frames, fps=args.fps,
        )
        print(f"wrote {mp4}")
        return mp4

    if not args.images_dir or not args.virtual_dir:
        p.error("either --vdr_dir or both --images_dir/--virtual_dir are required")
    names = sorted(os.path.splitext(f)[0] for f in os.listdir(args.images_dir)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    images, virtuals, mattes, rdepths, vdepths = [], [], None, None, None
    if args.mode == "mask":
        mattes = []
    else:
        rdepths, vdepths = [], []
    for name in names:
        for ext in (".png", ".jpg", ".jpeg"):
            path = os.path.join(args.images_dir, name + ext)
            if os.path.exists(path):
                images.append(read_image(path))
                break
        virt = read_image(os.path.join(args.virtual_dir, name + ".png"))
        if virt.shape[-1] == 3:  # add full alpha if RGB
            virt = np.concatenate([virt, np.ones_like(virt[..., :1])], -1)
        virtuals.append(virt)
        if args.mode == "mask":
            mattes.append(np.load(os.path.join(args.mattes_dir, name + ".npy")))
        else:
            rdepths.append(np.load(os.path.join(args.real_depth_dir, name + ".npy")))
            vdepths.append(np.load(os.path.join(args.virtual_depth_dir, name + ".npy")))

    composite_sequence(images, virtuals, args.output, mode=args.mode,
                       mattes=mattes, real_depths=rdepths, virtual_depths=vdepths,
                       fps=args.fps)
    print(f"wrote {args.output} ({len(images)} frames)")
    return args.output


if __name__ == "__main__":
    main()
