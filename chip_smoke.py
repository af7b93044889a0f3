#!/usr/bin/env python3
"""Drives the PyTorch port (implicit_depth_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:
1. device:  the card's name and power limit (nvidia-smi).
2. build:   nvcc builds the fused metadata-volume kernel from csrc/.
3. kernel:  the CUDA kernel against its plain PyTorch version on the same
            operands, at the flagship shape (B=1, K=7, C=16, H=96, W=128,
            D=64, F=128) with f32 and bf16 features, and at a ragged shape;
            max error against the stated tolerance, CUDA-event medians.
4. main:    `evaluate_scenes` with the flagship BDNet (EfficientNetV2-S,
            7 source views, 64 planes, 8 query planes, bf16, seeded random
            weights) over 5 synthetic 512x384 tuples at b=1. The kernel's
            launch count must equal the number of forwards; predictions must
            be finite; the score dict must hold all/surface/boundary IoU.
5. model:   `forward_val` of a flagship-width f32 BDNet on one small tuple,
            on the GPU (kernel) against the CPU (plain version).
Then one JSON line with the kernel's results and, last, the device line.

The script imports torch, numpy, the port and the JAX package's numpy-only
data modules; nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

ATOL, RTOL = 2e-3, 1e-3  # kernel vs plain: f32 sums in another order (as the JAX test)
FLAGSHIP = dict(B=1, K=7, H=96, W=128, D=64)
RAGGED = dict(B=2, K=3, H=50, W=70, D=13)
TIMED_RUNS = 20


def cuda_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median CUDA-event time of `fn` in ms, after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_device() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)
    return smi[0]


def phase_build() -> None:
    from implicit_depth_tpu_torch.ops import fused_volume

    t0 = time.perf_counter()
    lib = fused_volume.build()
    log = lib.with_suffix(".log").read_text() if lib.with_suffix(".log").exists() else ""
    ptxas = " | ".join(ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln)
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s; {ptxas}", flush=True)


def volume_operands(B: int, K: int, H: int, W: int, D: int, dtype, seed: int = 0) -> tuple:
    """Seeded kernel operands on the GPU: random features and MLP weights,
    geometry from the synthetic fixture's poses and intrinsics."""
    from implicit_depth_tpu.utils.fixtures import synthetic_bd_batch
    from implicit_depth_tpu_torch.core import geometry
    from implicit_depth_tpu_torch.models.volume_mlp import MetadataVolumeMLP, fused_operands
    from implicit_depth_tpu_torch.weights import init_params

    dev = torch.device("cuda")
    cur_np, src_np = synthetic_bd_batch(batch=B, num_src=K, height=4 * H, width=4 * W,
                                        with_train_keys=False, seed=seed)
    t = {k: torch.tensor(v, device=dev) for k, v in {**cur_np, **{
        "src_" + k: v for k, v in src_np.items()}}.items()}
    src_T_cur = torch.einsum("bkij,bjl->bkil", t["src_cam_T_world"], t["world_T_cam"])
    cur_T_src = torch.einsum("bij,bkjl->bkil", t["cam_T_world"], t["src_world_T_cam"])
    g = torch.Generator().manual_seed(seed)
    mlp = init_params(MetadataVolumeMLP(K, 16), g)
    with torch.no_grad():
        for p in mlp.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    mlp = mlp.to(dev)
    cur = torch.randn((B, H, W, 16), generator=g).to(dev, dtype)
    src = torch.randn((B, K, H, W, 16), generator=g).to(dev, dtype)
    planes = geometry.log_depth_planes(0.25, 5.0, D, device=dev)
    with torch.no_grad():
        return fused_operands(mlp.params_dict(), cur, src, t["src_K_s1"], src_T_cur,
                              t["invK_s1"], cur_T_src, planes, k=K, c=16, hidden=128)


def phase_kernel() -> dict:
    from implicit_depth_tpu_torch.ops.fused_volume import (
        fused_metadata_volume, fused_metadata_volume_reference)

    result = {}
    for label, shape, dtype in (("flagship f32", FLAGSHIP, torch.float32),
                                ("flagship bf16", FLAGSHIP, torch.bfloat16),
                                ("ragged f32", RAGGED, torch.float32),
                                ("ragged bf16", RAGGED, torch.bfloat16)):
        ops = volume_operands(**shape, dtype=dtype)
        with torch.no_grad():
            got = fused_metadata_volume(*ops)
            ref = fused_metadata_volume_reference(*ops)
            torch.cuda.synchronize()
            err = (got - ref).abs()
            bound = ATOL + RTOL * ref.abs()
            if got.shape != ref.shape or not torch.isfinite(got).all() or (err > bound).any():
                raise AssertionError(
                    f"kernel disagrees with its plain version ({label}): max_abs_err "
                    f"{err.max().item():.3e}, worst excess {(err - bound).max().item():.3e}")
            line = (f"kernel {label} {tuple(ref.shape)}: max_abs_err {err.max().item():.3e} "
                    f"(bound {ATOL} + {RTOL}*|ref|, max|ref| {ref.abs().max().item():.3f})")
            if shape is FLAGSHIP:
                ms = cuda_ms(lambda: fused_metadata_volume(*ops))
                plain_ms = cuda_ms(lambda: fused_metadata_volume_reference(*ops))
                line += f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (median of {TIMED_RUNS})"
                result[label] = {"max_abs_err": err.max().item(), "ms": ms, "plain_ms": plain_ms}
            print(line, flush=True)
        del ops
    return result


def flagship_net(dtype, seed: int = 0):
    from implicit_depth_tpu_torch.models.bd_net import BDNet
    from implicit_depth_tpu_torch.weights import init_params

    net = BDNet(num_src_views=7, num_depth_bins=64, compute_dtype=dtype)
    return init_params(net, torch.Generator().manual_seed(seed)).eval()


def phase_main() -> dict:
    from implicit_depth_tpu.data.synthetic import SyntheticDataset
    from implicit_depth_tpu_torch.eval import binary_metrics as bm
    from implicit_depth_tpu_torch.eval.occlusion_eval import evaluate_scenes
    from implicit_depth_tpu_torch.ops.fused_volume import fused_metadata_volume

    ds = SyntheticDataset(num_frames=12, num_views=8, image_height=384, image_width=512,
                          split="test", get_bd_info=True)
    net = flagship_net(torch.bfloat16).cuda().cast_to_compute_dtype()
    thresholder = bm.Thresholder(np.linspace(1.5, 5.0, 8, dtype=np.float32),
                                 np.full(8, 0.5, np.float32))
    fused_metadata_volume.launches = 0
    res = evaluate_scenes(net, {"scene0": ds}, batch_size=1, thresholder=thresholder)
    launches = fused_metadata_volume.launches
    metrics = res["all_scene"].final_metrics
    if res["forwards"] != len(ds) or launches != res["forwards"]:
        raise AssertionError(f"{res['forwards']} forwards over {len(ds)} tuples, "
                             f"{launches} kernel launches")
    if res["nonfinite_preds"]:
        raise AssertionError(f"{res['nonfinite_preds']} non-finite predictions")
    for prefix in ("iou_d_", "surface_iou_d_", "boundary_iou_d_"):
        vals = [v for k, v in metrics.items() if k.startswith(prefix)]
        if len(vals) != 8 or not all(np.isnan(v) or 0.0 <= v <= 1.0 for v in vals):
            raise AssertionError(f"bad {prefix}* scores: {vals}")
    print(f"main: {res['forwards']} forwards of BDNet.forward_val (EfficientNetV2-S, K=7, D=64, "
          f"P=8, bf16, seeded random weights) on 512x384 synthetic tuples, b=1: "
          f"model_time_ms {res['model_time_ms']:.3f}, step_time_ms {res['step_time_ms']:.3f}, "
          f"kernel launches {launches}, iou_d_3.0 {metrics['iou_d_3.0']:.4f}", flush=True)
    return {"launches": launches, "model_time_ms": res["model_time_ms"],
            "step_time_ms": res["step_time_ms"]}


def phase_model() -> None:
    from implicit_depth_tpu.utils.fixtures import synthetic_bd_batch

    net = flagship_net(torch.float32)
    cur, src = synthetic_bd_batch(batch=1, num_src=7, height=128, width=192, num_planes=8,
                                  with_train_keys=False, seed=1)
    with torch.no_grad():
        ref = net.forward_val({k: torch.tensor(v) for k, v in cur.items()},
                              {k: torch.tensor(v) for k, v in src.items()})
        net = net.cuda()
        got = net.forward_val({k: torch.tensor(v).cuda() for k, v in cur.items()},
                              {k: torch.tensor(v).cuda() for k, v in src.items()})
    err = (got["pred_0"].cpu() - ref["pred_0"]).abs().max().item()
    scale = ref["pred_0"].abs().max().item()
    # the same arg-max plane; a plane's depth may differ in the last f32 bit
    same_lowest = torch.isclose(got["lowest_cost"].cpu(), ref["lowest_cost"],
                                rtol=1e-6, atol=0.0).float().mean().item()
    if not err <= 1e-4 * max(scale, 1.0) or same_lowest < 0.99:
        raise AssertionError(f"GPU forward_val disagrees with the CPU one: pred_0 max_abs_err "
                             f"{err:.3e} (max|ref| {scale:.3e}), lowest_cost on the same plane "
                             f"for {same_lowest:.4f} of pixels")
    print(f"model: forward_val f32 128x192, K=7, D=64: GPU (kernel) vs CPU (plain) pred_0 "
          f"max_abs_err {err:.3e} (max|ref| {scale:.3e}, bound 1e-4*max(max|ref|, 1)), "
          f"lowest_cost on the same plane for {same_lowest:.4f} of pixels", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU only",
              file=sys.stderr)
        return 1
    # the comparisons hold f32 against f32: no TF32 in cuDNN convolutions or
    # matmuls anywhere in this run
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_device()
    phase_build()
    kern = phase_kernel()
    main_res = phase_main()
    phase_model()
    print(json.dumps({"kernels": [{
        "name": "fused_metadata_volume",
        "route": "cuda",
        "source": "implicit_depth_tpu_torch/csrc/fused_volume.cu",
        "replaces": "implicit_depth_tpu/ops/fused_volume.py:90",
        "launches": main_res["launches"],
        "max_abs_err": kern["flagship bf16"]["max_abs_err"],
        "ms": kern["flagship bf16"]["ms"],
        "plain_ms": kern["flagship bf16"]["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
