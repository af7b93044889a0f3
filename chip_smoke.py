#!/usr/bin/env python3
"""Drives the PyTorch port (implicit_depth_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

(`--ddp-rank` and its options run one rank of phase 24; the script starts
those processes itself.) Phases, one line each or a few; any failure raises and the script exits
non-zero:
1. device:      the card's name and power limit (nvidia-smi).
2. build:       nvcc builds the four kernel libraries from
                implicit_depth_tpu_torch/csrc/, one process per source, all at
                once; the ptxas register and spill report of each, and the
                count of tensor-core (HMMA) instructions in kernel #2's
                library and in #1's, #3's and #4's bf16 functions, with those
                functions' registers and spills; for the warp transpose
                (#6) its registers, spills, shared memory and tile, and the
                count of global reduction and atomic instructions in its
                SASS, which must be 0 (a gather).
3. kernel:      the fused-volume forward (kernel #1; bf16 on tensor cores,
                f32 on CUDA cores) against its plain PyTorch version, at the
                flagship shape (B=1, K=7, C=16, H=96, W=128, D=64, F=128)
                with f32 and bf16 features, and at a ragged shape; errors
                against the stated tolerances, CUDA-event medians; then the
                bf16 kernel at the train step's b=12, where each block walks
                several work units, against its plain version run one batch
                element at a time, both timed, with the bound.
4. kernel-bwd:  the fused-volume backward (kernel #2; bf16 on tensor cores,
                f32 on CUDA cores) against its plain version (the JAX
                kernel's backward with its bf16 rounding points), at B=1 of
                the flagship shape (f32 and bf16 features) and at the ragged
                shape; per cotangent, the relative L2 error and the share of
                elements outside an elementwise bound; how far the plain
                version itself moves under 1e-5 noise on its input; medians;
                then the bf16 kernel at the train step's b=12, where each
                block walks several tiles, against its plain version run one
                batch element at a time.
5. kernel-ray:  the ray-head forward and backward (kernels #3, #4; in bf16
                both on tensor cores) against their plain versions (bf16:
                the JAX kernel's chain with its rounding points) at b=12,
                N=4096, S=64 (bf16, with and without the prior), at a ragged
                N=100, S=13 (bf16 and f32) and at the BD step's scale-2
                N=1366 (bf16); in bf16 per output the relative L2 error and
                the share of per-row elements outside a few bf16 ulps, and
                how far the plain version itself moves under 1e-5 noise on
                b1; medians, bounds and each kernel's share of its bound.
6. main:        `evaluate_scenes` with the flagship BDNet (EfficientNetV2-S,
                7 source views, 64 planes, 8 query planes, bf16, seeded
                random weights) over 5 synthetic 512x384 tuples at b=1; kernel
                #1 must launch once per forward; one more forward profiled.
7. train:       `make_bd_train_step` on the flagship BDNet (bf16 autocast,
                f32 parameters, seeded random weights) over b=12 synthetic
                512x384 training tuples with N=4096 rays of S=64 samples: 6
                steps on a device-resident batch; kernels #1, #2, #3, #4 must
                launch 1, 1, 4, 4 times per step; losses finite, parameters
                and BN running statistics moved; median step time and peak
                device memory.
8. train-model: one f32 train step of a flagship-width BDNet at 128x192,
                b=1, N=256, S=64, flip on, on the GPU (kernels) and on the
                CPU (plain versions) from the same weights and batch: loss
                and parameter gradients against stated bounds.
9. kernel-warp: the plane-sweep warp (kernel #5) and its transpose (#6)
                against their plain versions at the eval shape (K'=7, D=64,
                96x128, C=16; f32 and bf16), the train shape (K'=112, bf16),
                a ragged shape (K'=3, D=13, 50x70, f32) whose poses put
                samples behind the camera and out of frame, and the eval
                shape with view 0's camera centre on one output point, so
                that a sample at z's clamp lands in frame (f32 and bf16);
                max errors against stated bounds, whether two launches of
                #6 give identical bits (they must), CUDA-event medians of
                the kernels, the plain versions and the library calls
                (F.grid_sample and its backward), and the bound.
10. reg-main:   the cli/test_reg.py path (eval/depth_eval.py::evaluate_depth)
                with the flagship regression DepthNet (regression_model.yaml:
                EfficientNetV2-S, K=7, D=64, bf16, seeded random weights) over
                5 synthetic 512x384 tuples at b=1: depth metrics finite,
                kernel #5 once per forward and #1-#4 never; then one forward
                of the dot-product DepthNet (dot_product_model.yaml).
11. reg-train:  `make_regression_train_step` on the flagship DepthNet at b=16
                (the config's batch), 512x384: 6 steps on a device-resident
                batch; kernels #5, #6 launch once each per step and #1-#4
                never; losses finite, parameters and BN statistics moved;
                median step time, peak device memory, one profiled step.
12. reg-train-model: one f32 regression step of a flagship-width DepthNet at
                128x192, b=1, flip on, GPU against CPU, against stated bounds.
13. temporal-main: `evaluate_temporal` with the flagship temporal BDNet
                (implicit_depth_temporal.yaml: the prior; bf16, seeded random
                weights) over 10 frames of one synthetic 512x384 scene
                (synthetic_temporal.yaml, windows of 5) against its 1M-face
                procedural mesh: frame mode, window mode with device scoring,
                and window mode timed; score finite, #1 once per frame and
                #2-#6 never, the two modes' maps within TEMPORAL_MAP_BOUND and
                their flip counts equal; frame time, forward and raster times,
                host cores.
14. temporal-train: `make_bd_train_step` on the flagship temporal BDNet at
                b=12, N=4096, S=64, bf16 autocast, 6 steps: #1-#4 launch
                1/1/4/4 per step and every #3/#4 launch takes the prior;
                losses finite, parameters and BN statistics moved; step time,
                peak memory, device idle share of one profiled step.
15. temporal-train-model: phase 8 with the temporal BDNet, both devices
                given the same augmentation draws.
16. reg-temporal: the test_reg --temporal_eval path with the flagship
                DepthNet over 5 frames: #5 once per frame.
17. raster-scaling: the C++ z-buffer of the 1M-face mesh at 256x192 in
                subprocesses with OMP_NUM_THREADS 1, 2, 4 and the default.
18. bd-depth:   `evaluate_scenes(binary_eval_depth=True)` (depth from the
                binary oracle, the test_bd --binary_eval_depth path) with the
                flagship BDNet (bf16) over the tuples of phase main at b=1,
                caching every frame's depths (--cache_depths): #1 once per
                forward and #2-#6 never, the cached depths in [0.5, 8],
                abs_rel and a25 finite; model_time_ms; one more forward
                profiled.
19. bd-depth-model: f32 `forward_infer_depth` of a flagship-width BDNet at
                128x192, K=7, D=64, with the test CLI's validation
                thresholds, on the GPU and on the CPU from the same weights,
                the head set so that the logit falls with depth and most
                pixels settle inside (0.5, 8) (at least half must): the share
                of pixels within DEPTH_ATOL against DEPTH_SHARE, and no host
                synchronisation inside the bisection (sync debug mode, 12
                iterations against 0).
20. bd-dot-main: the dot-product BDNet (dot_product_model.yaml, bf16)
                through `evaluate_scenes` over the same tuples: #5 once per
                forward and the others never; IoUs in [0, 1]; model_time_ms;
                one more forward profiled.
21. bd-dot-train: `make_bd_train_step` on the dot-product BDNet at b=12,
                N=4096, S=64, 6 steps: #1-#6 launch 0/0/4/4/1/1 per step;
                losses finite, parameters and BN statistics moved; step time,
                peak memory, device idle share of one profiled step.
22. bd-dot-train-model: phase 8 with the dot-product BDNet.
23. fit-resume: `fit` (train/loop.py) of the flagship BD config
                (implicit_depth.yaml, bf16, the config's b=12, synthetic
                512x384 tuples, flip pinned) for 4 steps, validating one
                batch and saving an async checkpoint every 2 steps, then a
                run resumed from the step-2 checkpoint to step 4: launches
                #1-#4 per step and validation, the resumed run's batches of
                steps 3-4 identical (sha256) to the uninterrupted run's, the
                restored model, optimizer and scheduler bit-equal to the
                checkpoint, the top-k / `last` layout, the losses of steps 3-4
                and the parameter updates within the MODEL_* bounds; then the
                step time with and without an async save in it and the
                save's time on the caller thread.
24. ddp-train:  two ranks on the one card (gloo, passed explicitly: nccl
                refuses two ranks on one card), each on 6 rows of the b=12
                batch, against the one-process b=12 step on the same batch,
                flip off and on: losses and gradients within the MODEL_*
                bounds, #1-#4 1/1/4/4 per step on each rank; each rank's
                step time and peak memory; then `fit --jax_distributed` as
                one nccl process (world size 1).
25. test-bd-ranks: cli/test_bd.py --jax_distributed, two processes on the
                card, 4 synthetic scenes: rank 0's merged
                all_scenes_metrics.json within 1e-6 relative of a one-process
                run's; the temporal merge on 2 scenes within 1e-6 of the
                one-process temporal score.
26. ar-inference: cli/inference.py (the AR demo's matting) with the
                flagship temporal BDNet (implicit_depth_temporal.yaml: the
                prior, bf16, seeded random weights in a port weights file)
                over 10 synthetic 512x384 frames (synthetic_temporal.yaml)
                with rendered depths of a 2 m plane with holes, each matte
                fed back as the next frame's prior on the card: one matte
                per frame id, finite and in [0, 1], #1 once per frame and
                #2-#6 never; the prior changes frames 2-10 against a run
                without it; ar_frame_ms (median wall time of frames 2-10),
                the forward's share of it, peak memory, the CLI's wall
                time; GPU vs CPU mattes of a flagship-width f32 temporal
                BDNet at 128x192 over 3 chained frames (share within
                AR_ATOL against AR_SHARE); each matte composited in mask
                mode against a 2 m layer of alpha 1 equals image*m +
                layer*(1-m); which host image libraries import.
27. zoo-main:   `evaluate_scenes` over the tuples of phase main with three
                BDNets of the encoder zoo (ZOO; bf16, seeded random
                weights): (a) the resnet18d encoder, the FPN matching
                encoder and the skip decoder, (b) resnext101_64x4d and (c)
                seresnextaa101d_32x8d with the ResNet matching encoder and
                U-Net++; #1 once per forward and #2-#6 never;
                model_time_ms, the median of 5 more forwards, peak memory,
                one profiled forward each.
28. zoo-train:  phase 7 with models (a) and (c) (at b=12, else the largest
                of ZOO_TRAIN_BATCHES that fits): #1-#4 1/1/4/4 per step,
                every parameter moved but the FPN's lateral_0, which
                nothing reads and AdamW must step with a zero gradient.
29. zoo-reg:    model (a)'s DepthNet (the skip decoder's regression heads):
                5 forwards through evaluate_depth, #5 once each, and phase
                11's 6 steps at b=16, #5/#6 once each per step.
30. zoo-model:  model (a) at 128x192, flagship width, GPU vs CPU: the f32 BD
                step at phase 8's bounds and the f32 regression step at
                phase 12's, but that a parameter past MODEL_GRAD_LEAF
                passes where the CPU step itself moves it by a third of
                its GPU-CPU gap under 1e-6 image noise (ZOO_NOISE: ReLU
                after batch norm over 24 values a channel).
31. tools:      the measurement tools through their main(): cli/profile_eval.py
                (b=1), cli/profile_train.py --batch 12 --json, cli/bench_train.py
                --batch 12, cli/roofline.py in eval mode and with --train; each
                probe's launches of #1-#4 against EVAL_PROBE_LAUNCHES and
                TRAIN_PROBE_LAUNCHES, no roofline share over 100% of a peak,
                the roofline's hand-counted work per launch equal to the work
                behind the kernel phases' bounds (ops/bounds.py); then
                cli/make_random_checkpoint.py -> a training checkpoint of the
                card's net -> cli/strip_checkpoint.py -> a strict load on the
                card, bit-equal.
Then one JSON line with the six kernels' results (with each kernel's
launches on every path that runs it) and, last, the device line.

The script imports torch, numpy and the port; nothing of JAX and nothing of
the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from implicit_depth_tpu_torch.ops.bounds import (F32_FLOP_PER_S, HIDDEN, MATCHING_DIM,
                                                 launch_counts, least_ms, nbytes,
                                                 ray_head_bwd_macs, ray_head_fwd_macs,
                                                 reset_launch_counts, volume_bwd_macs,
                                                 volume_fwd_macs)

ATOL, RTOL = 2e-3, 1e-3  # kernel vs plain: f32 sums in another order (as the JAX test)
# In bf16 the kernels and their plain versions round the same f32 values to
# bf16 where the JAX kernels round their matrix operands (#1: the warped
# visuals and h1; #2: vis, h1, dh2p, dacc). Where the two sides' f32 values
# differ in their last bits (sums and sample coordinates rounded in another
# order) they round one bf16 ulp (up to 2^-7 of the value) apart, and a
# LeakyReLU pre-activation near 0 may then take the other slope. So #1 in
# bf16 meets ATOL, RTOL at all but a share VOL_FWD_BF16_OUTSIDE of the
# points, and its relative L2 error is bounded.
VOL_FWD_BF16_REL_L2, VOL_FWD_BF16_OUTSIDE = 2e-3, 2e-3
# Volume backward vs its plain version. Both sum in f32, in other orders;
# where a pre-activation lies within rounding of 0 the two take different
# LeakyReLU slopes (1 vs 0.01), which shows as isolated large differences.
# So the bounds are on the relative L2 error of each cotangent and, for the
# per-point cotangents (dsrc, dcur, dbase), on the share of elements outside
# an elementwise bound: the JAX package's gradient bound in f32 (atol 5e-3,
# rtol 5e-3, tests/test_fused_volume.py:170-176), five bf16 ulps in bf16
# (the rounding straddles above, which also make slope flips more common;
# kernel-bwd prints how far the plain version itself moves under 1e-5
# relative noise on `base`). A weight gradient sums over every point, so
# each such tie moves a whole row of it: there only the relative L2 error
# is bounded. {dtype: (relative L2, share outside, atol, rtol)}
VOL_TOL = {torch.float32: (2e-2, 1e-2, 5e-3, 5e-3), torch.bfloat16: (2e-2, 1e-2, 2e-2, 2e-2)}
TRAIN_VOLUME = dict(B=12, K=7, H=96, W=128, D=64)  # the BD train step's volume (b=12)
# Ray head in f32 (#3, #4) against the plain versions: the same f32 math,
# sums in another order: the forward within atol, rtol 1e-5; the backward's
# cotangents within 1e-4 of each cotangent's largest value.
RAY_TOL = (1e-5, 1e-5)
RAY_BWD_REL = 1e-4
# In bf16 both sides round to bf16 at the JAX kernel's rounding points. Where
# their f32 values differ in the last bits (sums in another order, the
# tensor cores' accumulation, the kernels' __expf (ex2.approx, a few f32
# ulps) against the plain versions' correctly rounded exp), a rounding can
# land on the other side: one bf16 ulp, at most 2^-7 of the value. ELU's
# derivative is continuous at 0, so such a straddle moves what depends on it
# by about an ulp, not by ~100% as a LeakyReLU slope flip does in the volume
# kernels. So the per-row elements (the logits, dd, dp and dfp) meet
# RAY_BF16_ULPS bf16 ulps (2^-8 of max(|ref|, rms(ref)): a sum near 0 moves
# by the ulps of its terms) at all but a share RAY_BF16_OUTSIDE, and every
# output and cotangent is within a relative L2 error of RAY_BF16_REL_L2.
# kernel-ray prints how far the plain version itself moves under 1e-5
# relative noise on b1 (kept in f32): a worst relative L2 of 2.3e-4 on the
# H100, against a worst 1.3e-4 and a share outside of at most 1e-6 for
# kernel vs plain over the five bf16 cases; the bounds leave 7x and 1000x of
# that.
RAY_BF16_ULPS, RAY_BF16_OUTSIDE, RAY_BF16_REL_L2 = 4, 1e-3, 1e-3
FLAGSHIP = dict(B=1, K=7, H=96, W=128, D=64)
RAGGED = dict(B=2, K=3, H=50, W=70, D=13)
RAY_FLAGSHIP = dict(b=12, n=4096, s=64)
RAY_RAGGED = dict(b=2, n=100, s=13)
RAY_SCALE2 = dict(b=12, n=1366, s=64)  # the BD step's scale-2 launch
TIMED_RUNS = 20
# a bound is the larger of bytes / HBM and FLOP / the bf16 peak (the kernels'
# work is matrix products; the warp's arithmetic runs on the CUDA cores in f32)
C_, F_ = MATCHING_DIM, HIDDEN


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


def _ptxas_report(log: str, function: str) -> str:
    """The ptxas lines (registers, spills) of the entry functions whose
    mangled name holds `function`."""
    out, keep = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            keep = function in ln
        elif keep and ("registers" in ln or "spill" in ln):
            out.append(ln.strip().replace("ptxas info    : ", ""))
    return " | ".join(out)


def _sass_count(lib, function: str = "", opcodes: tuple = ("HMMA",)) -> int:
    """Instructions of a library's SASS whose opcode (before its first dot)
    is one of `opcodes`, in the functions whose mangled name holds
    `function`. By default the HMMA (tensor-core) instructions."""
    from implicit_depth_tpu_torch.ops import cuda_build

    sass = subprocess.run([cuda_build.cuda_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    count, keep = 0, True
    for ln in sass.splitlines():
        if "Function :" in ln:
            keep = function in ln
            continue
        # "/*0090*/  @P0 REDG.E.ADD.F32 [R2.64], R5 ;  /* 0x... */"
        words = ln.split("*/", 1)[1].split("/*")[0].split() if keep and "*/" in ln else []
        if words and words[0].startswith("@"):  # a predicate
            words = words[1:]
        if words and words[0].split(".")[0] in opcodes:
            count += 1
    return count


# global reductions and atomics in SASS (REDG / ATOMG on sm_90; RED / ATOM are
# the generic-address forms)
GLOBAL_ATOMICS = ("RED", "REDG", "ATOM", "ATOMG")


def phase_build() -> None:
    from implicit_depth_tpu_torch.ops import cuda_build
    from implicit_depth_tpu_torch.ops import fused_volume as fvm
    from implicit_depth_tpu_torch.ops import ray_head as rh
    from implicit_depth_tpu_torch.ops import warp_kernel as wk

    t0 = time.perf_counter()
    libs = cuda_build.build()
    print(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.1f} s (one nvcc per "
          "source, in parallel)", flush=True)
    for source, lib in libs.items():
        log = lib.with_suffix(".log").read_text() if lib.with_suffix(".log").exists() else ""
        ptxas = " | ".join(ln.strip().replace("ptxas info    : ", "") for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln)
        print(f"  {source} -> {lib.name}: {ptxas}", flush=True)
    hmma = _sass_count(libs["fused_volume_bwd.cu"])
    print(f"  fused_volume_bwd.cu: {hmma} HMMA (tensor-core) instructions in its SASS "
          "(cuobjdump -sass)", flush=True)
    if hmma == 0:
        raise AssertionError("the volume backward's library holds no tensor-core instruction")
    fn = "fused_volume_bf16_kernel"
    hmma = _sass_count(libs["fused_volume.cu"], fn)
    lib = cuda_build.load("fused_volume.cu", fvm._SIGNATURES["fused_volume.cu"])
    print(f"  fused_volume.cu {fn}: {hmma} HMMA instructions; ptxas "
          f"{_ptxas_report(libs['fused_volume.cu'].with_suffix('.log').read_text(), fn)}; "
          f"{lib.fused_metadata_volume_smem_bytes(7, 1)} bytes of shared memory a block, work "
          f"units of {lib.fused_metadata_volume_tile()} pixels x "
          f"{lib.fused_metadata_volume_plane_group()} planes", flush=True)
    if hmma == 0:
        raise AssertionError("the volume forward's bf16 function holds no tensor-core instruction")
    lib = cuda_build.load("ray_head.cu", rh._SIGNATURES)
    log = libs["ray_head.cu"].with_suffix(".log").read_text()
    for fn, what, threads, smem in (
            ("ray_head_fwd_bf16_kernel", "forward", lib.ray_head_fwd_threads(1),
             lib.ray_head_fwd_smem_bytes(1)),
            ("ray_head_bwd_bf16_kernel", "backward", lib.ray_head_bwd_threads(1),
             lib.ray_head_bwd_smem_bytes(1))):
        hmma = _sass_count(libs["ray_head.cu"], fn)
        print(f"  ray_head.cu {fn}: {hmma} HMMA instructions; ptxas {_ptxas_report(log, fn)}; "
              f"{threads} threads and {smem} bytes of shared memory a block", flush=True)
        if hmma == 0:
            raise AssertionError(f"the ray-head {what}'s bf16 function holds no tensor-core "
                                 "instruction")
    fn = "warp_planes_bwd_kernel"
    atomics = _sass_count(libs["warp_planes.cu"], fn, GLOBAL_ATOMICS)
    lib = cuda_build.load("warp_planes.cu", wk._SIGNATURES)
    log = libs["warp_planes.cu"].with_suffix(".log").read_text()
    print(f"  warp_planes.cu {fn}: ptxas bf16 {_ptxas_report(log, fn + 'I13__nv_bfloat16')}, "
          f"f32 {_ptxas_report(log, fn + 'If')}; "
          f"{lib.warp_planes_bwd_smem_bytes(1)} / {lib.warp_planes_bwd_smem_bytes(0)} bytes of "
          f"shared memory a block (bf16 / f32), tiles of {lib.warp_planes_bwd_tile_width()}x"
          f"{lib.warp_planes_bwd_tile_height()} texels; {atomics} global reduction or atomic "
          f"instructions ({'/'.join(GLOBAL_ATOMICS)}) in its SASS", flush=True)
    if atomics:
        raise AssertionError("the warp transpose (a gather) holds global atomics")


def volume_operands(B: int, K: int, H: int, W: int, D: int, dtype, seed: int = 0) -> tuple:
    """Seeded kernel operands on the GPU: random features and MLP weights,
    geometry from the synthetic fixture's poses and intrinsics."""
    from implicit_depth_tpu_torch.core import geometry
    from implicit_depth_tpu_torch.models.volume_mlp import MetadataVolumeMLP, fused_operands
    from implicit_depth_tpu_torch.utils.fixtures import synthetic_bd_batch
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
            line = (f"kernel {label} {tuple(ref.shape)}: {check_volume(label, got, ref, dtype)}, "
                    f"max|ref| {ref.abs().max().item():.3f}")
            if shape is FLAGSHIP:
                ms = cuda_ms(lambda: fused_metadata_volume(*ops))
                plain_ms = cuda_ms(lambda: fused_metadata_volume_reference(*ops))
                points = shape["B"] * shape["D"] * shape["H"] * shape["W"]
                flops = 2.0 * points * volume_fwd_macs(shape["K"])
                b_ms, b_by = least_ms(nbytes(*ops, got), flops)
                line += (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (median of {TIMED_RUNS}), "
                         f"bound {b_ms:.4f} ms ({b_by})")
                result[label] = {"max_abs_err": err.max().item(), "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": b_ms, "bound_by": b_by, "flops": flops}
            print(line, flush=True)
        del ops
    result["train bf16"] = _volume_fwd_train_shape()
    return result


VOLUME_PER_BATCH = (0, 1, 2, 3, 4, 5, 7)  # cur, src, A, b, origins, invK, base


def _batch_element(ops, i: int) -> tuple:
    """The operands of batch element i (the planes and weights are shared)."""
    return tuple(x[i:i + 1] if j in VOLUME_PER_BATCH else x for j, x in enumerate(ops))


def volume_reference_by_batch(ops):
    """The plain version of kernel #1 one batch element at a time, in the
    device memory of one, concatenated."""
    from implicit_depth_tpu_torch.ops.fused_volume import fused_metadata_volume_reference

    return torch.cat([fused_metadata_volume_reference(*_batch_element(ops, i))
                      for i in range(ops[0].shape[0])])


def _volume_fwd_train_shape() -> dict:
    """Kernel #1 alone at the BD train step's shape (TRAIN_VOLUME, bf16),
    where a block walks several work units: held against the plain version,
    run one batch element at a time, with the bf16 bounds; both timed."""
    from implicit_depth_tpu_torch.ops.fused_volume import fused_metadata_volume

    shape = TRAIN_VOLUME
    ops = volume_operands(**shape, dtype=torch.bfloat16)
    with torch.no_grad():
        got = fused_metadata_volume(*ops)
        ref = volume_reference_by_batch(ops)
        torch.cuda.synchronize()
        summary = check_volume("train bf16", got, ref, torch.bfloat16)
        err = (got - ref).abs().max().item()
        del ref
        ms = cuda_ms(lambda: fused_metadata_volume(*ops))
        plain_ms = cuda_ms(lambda: volume_reference_by_batch(ops), runs=3)
    flops = 2.0 * shape["B"] * shape["D"] * shape["H"] * shape["W"] * volume_fwd_macs(shape["K"])
    b_ms, b_by = least_ms(nbytes(*ops, got), flops)
    print(f"kernel train bf16 {tuple(got.shape)} (B, D, H, W), K={shape['K']}: {summary}; kernel "
          f"{ms:.3f} ms (median of {TIMED_RUNS}), plain {plain_ms:.3f} ms ({shape['B']} calls of "
          f"one batch element, median of 3), bound {b_ms:.4f} ms ({b_by})", flush=True)
    return {"shape": "B=12 K=7 96x128 D=64 bf16", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "flops": flops}


def check_volume(label: str, got, ref, dtype) -> str:
    """Kernel #1 against its plain version: in f32 every point within ATOL,
    RTOL; in bf16 all but a share VOL_FWD_BF16_OUTSIDE, and the relative L2
    error within VOL_FWD_BF16_REL_L2. Raises; returns a summary."""
    err = (got - ref).abs()
    outside = (err > ATOL + RTOL * ref.abs()).float().mean().item()
    rel_l2 = (err.norm() / ref.norm()).item()
    share, rel = (0.0, float("inf")) if dtype == torch.float32 else (VOL_FWD_BF16_OUTSIDE,
                                                                       VOL_FWD_BF16_REL_L2)
    if got.shape != ref.shape or not torch.isfinite(got).all() or outside > share or rel_l2 > rel:
        raise AssertionError(f"kernel disagrees with its plain version ({label}): max_abs_err "
                             f"{err.max().item():.3e}, {outside:.3e} of the points outside {ATOL} + "
                             f"{RTOL}*|ref| (bound {share}), relative L2 {rel_l2:.3e} (bound {rel})")
    return (f"max_abs_err {err.max().item():.3e}, {outside:.2e} of the points outside {ATOL} + "
            f"{RTOL}*|ref| (bound {share}), relative L2 {rel_l2:.2e}")


def check_cotangents(label: str, got, ref, dtype) -> float:
    """Checks each cotangent of kernel #2 against its plain version with
    the bounds VOL_TOL[dtype]; returns the largest max-abs error."""
    rel_bound, share_bound, atol, rtol = VOL_TOL[dtype]
    worst_l2, worst_out, worst_abs = (0.0, ""), (0.0, ""), 0.0
    for name in got._fields:
        a, r = getattr(got, name).float(), getattr(ref, name).float()
        if a.shape != r.shape or not torch.isfinite(a).all():
            raise AssertionError(f"kernel-bwd {label}: {name} has shape {tuple(a.shape)} vs "
                                 f"{tuple(r.shape)} or non-finite values")
        d = (a - r).abs()
        rel_l2 = (d.norm() / r.norm().clamp_min(1e-30)).item()
        outside = 0.0
        if name in ("dsrc", "dcur", "dbase"):
            outside = (d > atol + rtol * r.abs()).float().mean().item()
        if rel_l2 > rel_bound or outside > share_bound:
            raise AssertionError(f"kernel-bwd {label}: {name} disagrees with the plain version: "
                                 f"relative L2 {rel_l2:.3e} (bound {rel_bound}), {outside:.3e} "
                                 f"of elements outside the elementwise bound (bound {share_bound})")
        worst_l2 = max(worst_l2, (rel_l2, name))
        worst_out = max(worst_out, (outside, name))
        worst_abs = max(worst_abs, d.max().item())
    print(f"kernel-bwd {label}: 10 cotangents; worst relative L2 {worst_l2[0]:.2e} ({worst_l2[1]}, "
          f"bound {rel_bound}), worst share of per-point elements outside atol {atol} + "
          f"rtol {rtol} {worst_out[0]:.2e} ({worst_out[1]}, bound {share_bound}), max_abs_err "
          f"{worst_abs:.3e}", flush=True)
    return worst_abs


def _worst_rel_l2(got, ref) -> tuple:
    return max(((getattr(got, n) - getattr(ref, n)).norm().item()
                / getattr(ref, n).norm().clamp_min(1e-30).item(), n) for n in got._fields)


def phase_kernel_bwd() -> dict:
    from implicit_depth_tpu_torch.ops.fused_volume import (
        bwd_smem_bytes, fused_metadata_volume_bwd, fused_metadata_volume_bwd_reference)

    result = {}
    for label, shape, dtype in (("flagship f32", FLAGSHIP, torch.float32),
                                ("flagship bf16", FLAGSHIP, torch.bfloat16),
                                ("ragged f32", RAGGED, torch.float32),
                                ("ragged bf16", RAGGED, torch.bfloat16)):
        ops = volume_operands(**shape, dtype=dtype)[:14]
        gen = torch.Generator(device="cuda").manual_seed(1)
        ct = torch.randn((shape["B"], shape["D"], shape["H"], shape["W"]), generator=gen,
                         device="cuda")
        got = fused_metadata_volume_bwd(ct, *ops)
        ref = fused_metadata_volume_bwd_reference(ct, *ops)
        torch.cuda.synchronize()
        err = check_cotangents(label, got, ref, dtype)
        if shape is FLAGSHIP:
            # how far the plain version itself moves when its f32 inputs move
            # in the last bits: 1e-5 relative noise on `base`
            noisy = list(ops)
            noisy[7] = ops[7] * (1 + 1e-5 * torch.randn(ops[7].shape, generator=gen, device="cuda"))
            sens = _worst_rel_l2(fused_metadata_volume_bwd_reference(ct, *noisy), ref)
            del noisy
            ms = cuda_ms(lambda: fused_metadata_volume_bwd(ct, *ops))
            plain_ms = cuda_ms(lambda: fused_metadata_volume_bwd_reference(ct, *ops), runs=5)
            flops = (2.0 * shape["B"] * shape["D"] * shape["H"] * shape["W"]
                     * volume_bwd_macs(shape["K"]))
            b_ms, b_by = least_ms(nbytes(ct, *ops) + nbytes(*got), flops)
            print(f"kernel-bwd {label}: the plain version under 1e-5 relative noise on base moves "
                  f"by a worst relative L2 of {sens[0]:.2e} ({sens[1]}); kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms (medians), bound {b_ms:.4f} ms ({b_by}); shared memory "
                  f"{bwd_smem_bytes(shape['K'], dtype)} bytes per block", flush=True)
            result[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": b_ms, "bound_by": b_by, "flops": flops}
        del ops, got, ref
    result["train bf16"] = _volume_bwd_train_shape()
    return result


VOLUME_PER_POINT = ("dsrc", "dcur", "dbase")


def volume_bwd_reference_by_batch(ct, ops):
    """The plain version of kernel #2 one batch element at a time, in the
    device memory of one: the per-point cotangents concatenated, the weight
    gradients summed over the elements."""
    from implicit_depth_tpu_torch.ops.fused_volume import (
        FusedVolumeCotangents, fused_metadata_volume_bwd_reference)

    parts = [fused_metadata_volume_bwd_reference(ct[i:i + 1], *_batch_element(ops, i))
             for i in range(ct.shape[0])]
    return FusedVolumeCotangents(*(
        torch.cat(g) if name in VOLUME_PER_POINT else torch.stack(g).sum(0)
        for name, g in zip(FusedVolumeCotangents._fields, zip(*parts))))


def _volume_bwd_train_shape() -> dict:
    """Kernel #2 alone at the BD train step's shape (TRAIN_VOLUME, bf16),
    where a block walks several tiles: held against the plain version, run
    one batch element at a time, with the bf16 bounds; both timed."""
    from implicit_depth_tpu_torch.ops.fused_volume import fused_metadata_volume_bwd

    shape = TRAIN_VOLUME
    ops = volume_operands(**shape, dtype=torch.bfloat16)[:14]
    gen = torch.Generator(device="cuda").manual_seed(1)
    ct = torch.randn((shape["B"], shape["D"], shape["H"], shape["W"]), generator=gen, device="cuda")
    got = fused_metadata_volume_bwd(ct, *ops)
    ref = volume_bwd_reference_by_batch(ct, ops)
    torch.cuda.synchronize()
    err = check_cotangents("train bf16", got, ref, torch.bfloat16)
    del ref
    ms = cuda_ms(lambda: fused_metadata_volume_bwd(ct, *ops))
    plain_ms = cuda_ms(lambda: volume_bwd_reference_by_batch(ct, ops), runs=3)
    flops = (2.0 * shape["B"] * shape["D"] * shape["H"] * shape["W"]
             * volume_bwd_macs(shape["K"]))
    b_ms, b_by = least_ms(nbytes(ct, *ops) + nbytes(*got), flops)
    print(f"kernel-bwd train bf16 {tuple(ct.shape)} (B, D, H, W), K={shape['K']}: kernel {ms:.3f} ms "
          f"(median of {TIMED_RUNS}), plain {plain_ms:.3f} ms ({shape['B']} calls of one batch "
          f"element, median of 3), bound {b_ms:.4f} ms ({b_by})", flush=True)
    return {"shape": "B=12 K=7 96x128 D=64 bf16", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "flops": flops}


def ray_inputs(b: int, n: int, s: int, prior: bool, dtype, seed: int = 0) -> tuple:
    """Seeded ray-head operands and an output cotangent on the GPU."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    depths = (0.3 + 4.7 * torch.rand((b, n, s), generator=gen, device="cuda")).to(dtype)
    ops = (rnd(b, n, F_, scale=0.5).to(dtype), depths,
           rnd(b, n, s).to(dtype) if prior else None, rnd(F_, scale=0.2),
           rnd(F_, scale=0.2) if prior else None, rnd(F_, F_, scale=0.09), rnd(F_, scale=0.05),
           rnd(F_, 1, scale=0.09), rnd(1))
    return ops, rnd(b, n, s).to(dtype)


def ray_outputs(out, grads) -> dict:
    """{name: tensor} of the ray head's logits and cotangents (None dropped)."""
    res = {"out": out}
    res.update((k, v) for k, v in grads._asdict().items() if v is not None)
    return res


def ray_bf16_errors(got: dict, ref: dict) -> dict:
    """{name: (relative L2 error, share of per-row elements outside
    RAY_BF16_ULPS ulps or 0, max abs error)} of the bf16 ray head."""
    res = {}
    for name, r in ref.items():
        a, r = got[name].float(), r.float()
        if a.shape != r.shape or not torch.isfinite(a).all():
            raise AssertionError(f"kernel-ray: {name} has shape {tuple(a.shape)} vs "
                                 f"{tuple(r.shape)} or non-finite values")
        d = (a - r).abs()
        outside = 0.0
        if name in ("out", "dd", "dp", "dfp"):
            floor = r.square().mean().sqrt()
            ulps = RAY_BF16_ULPS * 2.0 ** -8
            outside = (d > ulps * torch.maximum(r.abs(), floor)).float().mean().item()
        res[name] = ((d.norm() / r.norm().clamp_min(1e-30)).item(), outside, d.max().item())
    return res


def check_ray_bf16(label: str, got: dict, ref: dict) -> tuple:
    """Holds the bf16 ray head to RAY_BF16_*; returns the forward's and the
    backward's largest max-abs error."""
    errs = ray_bf16_errors(got, ref)
    bad = [n for n, (l2, out, _) in errs.items()
           if l2 > RAY_BF16_REL_L2 or out > RAY_BF16_OUTSIDE]
    summary = ", ".join(f"{n} {l2:.2e}/{out:.1e}" for n, (l2, out, _) in errs.items())
    print(f"kernel-ray {label}: relative L2 / share outside {RAY_BF16_ULPS} ulps per output: "
          f"{summary} (bounds {RAY_BF16_REL_L2} / {RAY_BF16_OUTSIDE})", flush=True)
    if bad:
        raise AssertionError(f"kernel-ray {label}: {bad} disagree with the plain version")
    return errs["out"][2], max((e[2] for n, e in errs.items() if n != "out"), default=0.0)


def check_ray_f32(label: str, out, ref, gk, gr) -> tuple:
    """Holds the f32 ray head to RAY_TOL and RAY_BWD_REL; returns the
    forward's and the backward's largest max-abs error."""
    atol, rtol = RAY_TOL
    d = (out - ref).abs()
    if out.shape != ref.shape or not torch.isfinite(out).all() or \
            (d > atol + rtol * ref.abs()).any():
        raise AssertionError(f"kernel-ray {label}: forward disagrees with its plain version: "
                             f"max_abs_err {d.max().item():.3e}")
    bwd_err = 0.0
    for name in gk._fields:
        a, r = getattr(gk, name), getattr(gr, name)
        if a is None and r is None:
            continue
        e = (a.reshape(r.shape) - r).abs().max().item()
        if not e <= RAY_BWD_REL * r.abs().max().item() + 1e-6:
            raise AssertionError(f"kernel-ray {label}: backward {name} disagrees with its "
                                 f"plain version: max_abs_err {e:.3e}")
        bwd_err = max(bwd_err, e)
    print(f"kernel-ray {label}: forward max_abs_err {d.max().item():.3e} (bound {atol} + "
          f"{rtol}*|ref|), backward max_abs_err {bwd_err:.3e} (bound {RAY_BWD_REL}*max|ref|)",
          flush=True)
    return d.max().item(), bwd_err


def phase_kernel_ray() -> dict:
    from implicit_depth_tpu_torch.ops import ray_head as rh

    result = {}
    for label, shape, prior, dtype in (
            ("flagship noprior bf16", RAY_FLAGSHIP, False, torch.bfloat16),
            ("flagship prior bf16", RAY_FLAGSHIP, True, torch.bfloat16),
            ("ragged noprior bf16", RAY_RAGGED, False, torch.bfloat16),
            ("ragged prior bf16", RAY_RAGGED, True, torch.bfloat16),
            ("scale-2 noprior bf16", RAY_SCALE2, False, torch.bfloat16),
            ("ragged noprior f32", RAY_RAGGED, False, torch.float32),
            ("ragged prior f32", RAY_RAGGED, True, torch.float32)):
        label += f" b={shape['b']} N={shape['n']} S={shape['s']}"
        ops, ct = ray_inputs(**shape, prior=prior, dtype=dtype)
        with torch.no_grad():
            out = rh.ray_head_fwd(*ops)
            ref = rh.ray_head_reference(*ops)
        gk = rh.ray_head_bwd(ct, *ops[:-1])
        gr = rh.ray_head_bwd_reference(ct, *ops[:-1])
        torch.cuda.synchronize()
        if dtype == torch.float32:
            fwd_err, bwd_err = check_ray_f32(label, out, ref, gk, gr)
        else:
            fwd_err, bwd_err = check_ray_bf16(label, ray_outputs(out, gk), ray_outputs(ref, gr))
        del gk
        if shape is RAY_FLAGSHIP and not prior:
            # how far the plain version itself moves when an f32 operand moves
            # in its last bits: 1e-5 relative noise on b1 (used unrounded)
            noisy = list(ops)
            gen = torch.Generator(device="cuda").manual_seed(1)
            noisy[6] = ops[6] * (1 + 1e-5 * torch.randn(ops[6].shape, generator=gen, device="cuda"))
            with torch.no_grad():
                ref_n = rh.ray_head_reference(*noisy)
            sens = ray_bf16_errors(ray_outputs(ref_n, rh.ray_head_bwd_reference(ct, *noisy[:-1])),
                                   ray_outputs(ref, gr))
            del noisy, ref_n
            print(f"kernel-ray {label}: the plain version under 1e-5 relative noise on b1 moves "
                  "by (relative L2 / share outside): " + ", ".join(
                      f"{n} {l2:.2e}/{o:.1e}" for n, (l2, o, _) in sens.items()), flush=True)
            del ref, gr
            with torch.no_grad():
                f_ms = cuda_ms(lambda: rh.ray_head_fwd(*ops))
                f_plain = cuda_ms(lambda: rh.ray_head_reference(*ops), runs=5)
            b_ms_k = cuda_ms(lambda: rh.ray_head_bwd(ct, *ops[:-1]))
            b_plain = cuda_ms(lambda: rh.ray_head_bwd_reference(ct, *ops[:-1]), runs=5)
            rows = shape["b"] * shape["n"] * shape["s"]
            grads = rh.ray_head_bwd(ct, *ops[:-1])
            f_flops, b_flops = 2.0 * rows * ray_head_fwd_macs(), 2.0 * rows * ray_head_bwd_macs()
            fb = least_ms(nbytes(*ops, out), f_flops)
            bb = least_ms(nbytes(*ops[:-1], ct) + nbytes(*(t for t in grads if t is not None)),
                          b_flops)
            del grads
            print(f"kernel-ray {label}: forward kernel {f_ms:.3f} ms ({fb[0] / f_ms:.1%} of its "
                  f"bound's rate), plain {f_plain:.3f} ms, bound {fb[0]:.4f} ms ({fb[1]}); "
                  f"backward kernel {b_ms_k:.3f} ms ({bb[0] / b_ms_k:.1%}), plain "
                  f"{b_plain:.3f} ms, bound {bb[0]:.4f} ms ({bb[1]}) (medians)", flush=True)
            result["fwd"] = {"max_abs_err": fwd_err, "ms": f_ms, "plain_ms": f_plain,
                             "bound_ms": fb[0], "bound_by": fb[1], "flops": f_flops}
            result["bwd"] = {"max_abs_err": bwd_err, "ms": b_ms_k, "plain_ms": b_plain,
                             "bound_ms": bb[0], "bound_by": bb[1], "flops": b_flops}
        elif shape is RAY_FLAGSHIP:  # with the prior: the temporal model's variant
            del ref, gr
            with torch.no_grad():
                f_ms = cuda_ms(lambda: rh.ray_head_fwd(*ops))
            b_ms_k = cuda_ms(lambda: rh.ray_head_bwd(ct, *ops[:-1]))
            print(f"kernel-ray {label}: forward kernel {f_ms:.3f} ms, backward kernel "
                  f"{b_ms_k:.3f} ms (medians)", flush=True)
            result["fwd_prior_ms"], result["bwd_prior_ms"] = f_ms, b_ms_k
        elif shape is RAY_SCALE2:
            with torch.no_grad():
                f_ms = cuda_ms(lambda: rh.ray_head_fwd(*ops))
            rows = shape["b"] * shape["n"] * shape["s"]
            fb = least_ms(nbytes(*ops, out), 2.0 * rows * ray_head_fwd_macs())
            print(f"kernel-ray {label}: forward kernel {f_ms:.3f} ms ({fb[0] / f_ms:.1%} of its "
                  f"bound's rate), bound {fb[0]:.4f} ms ({fb[1]}) (median)", flush=True)
        del ops, ct, out
        torch.cuda.empty_cache()
    return result


DOT = "simple_cost_volume"  # dot_product_model.yaml's feature_volume_type


def flagship_net(dtype, seed: int = 0, use_prior: bool = False,
                 feature_volume_type: str = "mlp_feature_volume", **parts):
    """The flagship BDNet (implicit_depth.yaml; with use_prior
    implicit_depth_temporal.yaml; with feature_volume_type DOT
    dot_product_model.yaml; `parts` names other encoders or decoder, as
    ZOO does), seeded random weights, eval mode."""
    from implicit_depth_tpu_torch.models.bd_net import BDNet
    from implicit_depth_tpu_torch.weights import init_params

    net = BDNet(num_src_views=7, num_depth_bins=64, use_prior=use_prior, compute_dtype=dtype,
                feature_volume_type=feature_volume_type, **parts)
    return init_params(net, torch.Generator().manual_seed(seed)).eval()


def eval_dataset(pass_frame_id: bool = False):
    """The synthetic 512x384 test tuples of the eval phases (5 tuples of 8
    views)."""
    from implicit_depth_tpu_torch.data.synthetic import SyntheticDataset

    return SyntheticDataset(num_frames=12, num_views=8, image_height=384, image_width=512,
                            split="test", get_bd_info=True, pass_frame_id=pass_frame_id)


def cli_thresholder(validation: bool = False):
    """cli/test_bd.py's thresholder: 0.5 at the 8 planes, or with
    --use_validation_thresholds 0.5, 0.4, then 0.3."""
    from implicit_depth_tpu_torch.eval import binary_metrics as bm

    thr = [0.5, 0.4] + [0.3] * 6 if validation else [0.5] * 8
    return bm.Thresholder(np.linspace(1.5, 5.0, 8, dtype=np.float32), np.asarray(thr, np.float32))


def _occlusion_eval(label: str, net, ds, expected, **kwargs) -> dict:
    """evaluate_scenes over `ds` at b=1 with the launch counts zeroed just
    before; raises unless every tuple ran one forward, the launches #1-#6
    are expected(forwards) and no prediction is non-finite."""
    from implicit_depth_tpu_torch.eval.occlusion_eval import evaluate_scenes

    reset_launch_counts()
    res = evaluate_scenes(net, {"scene0": ds}, batch_size=1, thresholder=cli_thresholder(),
                          **kwargs)
    counts = launch_counts()
    n = res["forwards"]
    if n != len(ds) or counts != expected(n):
        raise AssertionError(f"{label}: {n} forwards over {len(ds)} tuples, kernel launches "
                             f"#1-#6 {counts}, expected {expected(n)}")
    if res["nonfinite_preds"]:
        raise AssertionError(f"{label}: {res['nonfinite_preds']} non-finite predictions")
    res["counts"] = counts
    return res


def _profile_forward(label: str, net, ds, binary_eval_depth: bool = False) -> None:
    """One more eval forward of the first tuple, as evaluate_scenes runs it,
    under torch.profiler: its wall time, the device time summed over
    kernels, the idle share, and the largest kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    from implicit_depth_tpu_torch.data.mvs_dataset import collate
    from implicit_depth_tpu_torch.eval.occlusion_eval import make_forward_fn

    cur, src = ({k: torch.as_tensor(v).cuda() for k, v in d.items() if k != "frame_id_string"}
                for d in collate([ds[0]]))
    fwd = make_forward_fn(net, binary_eval_depth, cli_thresholder().to("cuda"))
    with torch.inference_mode():
        fwd(cur, src)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fwd(cur, src)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((getattr(ev, "self_device_time_total", 0.0) / 1e3, ev.count, ev.key)
                      for ev in prof.key_averages()
                      if "cuda" in str(getattr(ev, "device_type", "")).lower()), reverse=True)
    device_ms = sum(k[0] for k in kernels)
    print(f"{label} profile (one more forward under torch.profiler): wall {wall_ms:.1f} ms, "
          f"device kernels {device_ms:.1f} ms (device idle {max(0.0, 1 - device_ms / wall_ms):.1%})"
          f", {sum(k[1] for k in kernels)} kernel launches; largest by device time:", flush=True)
    for ms, count, name in kernels[:6]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {name[:110]}", flush=True)


def _check_ious(label: str, metrics: dict) -> None:
    for prefix in ("iou_d_", "surface_iou_d_", "boundary_iou_d_"):
        vals = [v for k, v in metrics.items() if k.startswith(prefix)]
        if len(vals) != 8 or not all(np.isnan(v) or 0.0 <= v <= 1.0 for v in vals):
            raise AssertionError(f"{label}: bad {prefix}* scores: {vals}")


def phase_main() -> dict:
    net = flagship_net(torch.bfloat16).cuda().cast_to_compute_dtype()
    res = _occlusion_eval("main", net, eval_dataset(), lambda n: (n, 0, 0, 0, 0, 0))
    launches = res["counts"][0]
    metrics = res["all_scene"].final_metrics
    _check_ious("main", metrics)
    print(f"main: {res['forwards']} forwards of BDNet.forward_val (EfficientNetV2-S, K=7, D=64, "
          f"P=8, bf16, seeded random weights) on 512x384 synthetic tuples, b=1: "
          f"model_time_ms {res['model_time_ms']:.3f}, step_time_ms {res['step_time_ms']:.3f}, "
          f"kernel launches {launches}, iou_d_3.0 {metrics['iou_d_3.0']:.4f}", flush=True)
    _profile_forward("main", net, eval_dataset())
    return {"launches": launches, "model_time_ms": res["model_time_ms"],
            "step_time_ms": res["step_time_ms"]}


def phase_model() -> None:
    from implicit_depth_tpu_torch.utils.fixtures import synthetic_bd_batch

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


def _prior_launch_counts() -> tuple:
    """The ray head's launches (#3, #4) that took the prior."""
    from implicit_depth_tpu_torch.ops import ray_head as rh

    return rh.ray_head_fwd.prior_launches, rh.ray_head_bwd.prior_launches


TRAIN_STEPS = 6


def _train_run(batch_size: int, use_prior: bool = False,
               feature_volume_type: str = "mlp_feature_volume", parts=None) -> dict:
    """TRAIN_STEPS steps of make_bd_train_step on the flagship BDNet (with
    `parts`, a ZOO model, whose every parameter is watched) at batch_size
    on one device-resident batch, then one profiled step."""
    from implicit_depth_tpu_torch.data.mvs_dataset import BDSamplingConfig, collate
    from implicit_depth_tpu_torch.data.synthetic import SyntheticDataset
    from implicit_depth_tpu_torch.train import state

    t0 = time.perf_counter()
    ds = SyntheticDataset(num_frames=batch_size + 7, num_views=8, image_height=384,
                          image_width=512, split="train", get_bd_info=True,
                          bd_config=BDSamplingConfig(num_rays=4096, samples_per_ray=64))
    cur, src = ({k: torch.as_tensor(v).cuda() for k, v in d.items() if k != "frame_id_string"}
                for d in collate([ds[i] for i in range(batch_size)]))
    data_s = time.perf_counter() - t0
    net = flagship_net(torch.bfloat16, use_prior=use_prior,
                       feature_volume_type=feature_volume_type, **(parts or {})).cuda()
    opt, sched = state.make_optimizer(net.parameters(), lr=1e-4, wd=1e-4)
    step = state.make_bd_train_step(net, opt, sched, generator=torch.Generator().manual_seed(0))
    if parts:
        watched = {k: p for k, p in net.named_parameters() if k not in NO_GRADIENT}
    else:
        watched = {"encoder.conv_stem.weight": net.encoder.conv_stem.weight,
                   "matching.conv1.weight": net.matching.conv1.weight,
                   "binary_mlp.s3_fc1.weight": net.binary_mlp.s3_fc1.weight,
                   "matching.bn1.running_var": net.matching.bn1.running_var,
                   "encoder.s5_b14.bn3.running_mean": net.encoder.s5_b14.bn3.running_mean}
    if hasattr(net, "volume_mlp"):
        watched["volume_mlp.fc0_kernel"] = net.volume_mlp.fc0_kernel
    before = {k: v.detach().clone() for k, v in watched.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = step((cur, src))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        losses.append({k: float(v) for k, v in out.items()})
    launches = launch_counts()
    prior_launches = _prior_launch_counts()
    moved = {k: not torch.equal(before[k], v.detach()) for k, v in watched.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    # a parameter that backward leaves without a gradient steps with a zero one
    stepped = {k: (p.grad is not None and not p.grad.any()
                   and int(opt.state[p]["step"]) == TRAIN_STEPS)
               for k, p in net.named_parameters() if k in NO_GRADIENT}
    return {"b": batch_size, "launches": launches, "prior_launches": prior_launches,
            "times": times, "losses": losses, "moved": moved, "stepped": stepped,
            "peak_gb": peak_gb, "data_s": data_s, "profile": _profile_step(step, (cur, src))}


PORT_KERNELS = ("fused_volume", "ray_head", "warp_planes")  # names of the port's kernels


def _profile_step(step, batch) -> dict:
    """One more steady-state step under torch.profiler: its wall time, the
    device time summed over kernels, and the largest kernels by device time
    with the port's own kernels among them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0 and getattr(ev, "device_type", None) is not None and \
                "cuda" in str(ev.device_type).lower():
            kernels.append((dev_us / 1e3, ev.count, ev.key))
    kernels.sort(reverse=True)
    # the ten largest, then the port's own kernels below them
    ported = [k for k in kernels[10:] if any(n in k[2] for n in PORT_KERNELS)]
    return {"wall_ms": wall_ms, "device_ms": sum(k[0] for k in kernels),
            "top": kernels[:10] + ported}


def _check_train(label: str, res: dict, expected: tuple) -> float:
    """Raises unless a _train_run's launches #1-#6 are `expected`, its losses
    finite and every watched tensor moved; returns the median step time of
    steps 2-6."""
    if res["launches"] != expected:
        raise AssertionError(f"{label}: kernel launches #1-#6 {res['launches']} over "
                             f"{TRAIN_STEPS} steps, expected {expected}")
    if not all(np.isfinite(v) for ls in res["losses"] for v in ls.values()):
        raise AssertionError(f"{label}: non-finite losses {res['losses']}")
    if not all(res["moved"].values()):
        raise AssertionError(f"{label}: parameters or BN statistics did not move: "
                             f"{sorted(k for k, m in res['moved'].items() if not m)}")
    if not all(res["stepped"].values()):
        raise AssertionError(f"{label}: parameters without a gradient skipped by AdamW: "
                             f"{res['stepped']}")
    return float(np.median(res["times"][1:]))


def _print_profile(label: str, prof: dict) -> None:
    print(f"{label} profile (one more step under torch.profiler): wall {prof['wall_ms']:.1f} ms, "
          f"device kernels {prof['device_ms']:.1f} ms (device idle "
          f"{max(0.0, 1 - prof['device_ms'] / prof['wall_ms']):.1%}); largest by device time, then "
          "the port's kernels below them:", flush=True)
    for ms, count, name in prof["top"]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {name[:110]}", flush=True)


def phase_train() -> dict:
    """The training main path: 6 flagship train steps at b=12 (b=6 if 12
    does not fit in device memory)."""
    try:
        res = _train_run(12)
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        print("train: b=12 does not fit in device memory; running b=6", flush=True)
        res = _train_run(6)
    n = TRAIN_STEPS
    step_ms = _check_train("train", res, (n, n, 4 * n, 4 * n, 0, 0))
    print(f"train: {n} steps of make_bd_train_step (EfficientNetV2-S, K=7, D=64, bf16 autocast, "
          f"f32 params, seeded random weights), b={res['b']} synthetic 512x384 tuples, N=4096, "
          f"S=64 (data {res['data_s']:.1f} s): train_step_ms {step_ms:.1f} (median of steps "
          f"2-{n}; all {', '.join(f'{t:.1f}' for t in res['times'])}), peak device memory "
          f"{res['peak_gb']:.2f} GiB, launches #1-#6 {res['launches']}, loss "
          f"{res['losses'][0]['loss']:.4f} -> {res['losses'][-1]['loss']:.4f}, moved "
          f"{sorted(res['moved'])}", flush=True)
    _print_profile("train", res["profile"])
    return {"launches": res["launches"], "train_step_ms": step_ms, "peak_gb": res["peak_gb"],
            "b": res["b"]}


# GPU (kernels) vs CPU (plain versions), one f32 step from the same weights:
# the loss to 1e-4 relative; the gradients to 1e-2 relative L2 over all
# parameters together and, per parameter, max|diff| <= 5e-2 max|ref|,
# skipping parameters whose gradient is below 1e-6 of the largest (biases
# that instance norm cancels: their gradient is rounding noise). Why that
# loose: f32 sums in other orders, and the LeakyReLU slope ties of the
# volume MLP (~25 M pre-activations here), amplified through the backward
# of ~60 layers; on the CPU two f32 implementations of the JAX step differ
# by up to ~8e-3 per parameter and each is ~4e-3 from a float64 run
# (tests/test_torch_train.py). Measured here: 1.2e-3 and 3.2e-2.
MODEL_LOSS_REL, MODEL_GRAD_L2, MODEL_GRAD_LEAF = 1e-4, 1e-2, 5e-2


# zoo-model: ResNet18-D and MNASNet put a ReLU after train-mode batch norm
# at their stride-32 level, 4x6 pixels at 128x192 and b=1: 24 values a
# channel. That makes a few parameters' gradients ill-conditioned, and f32
# rounding in another order moves them past MODEL_GRAD_LEAF (the flagship's
# EfficientNetV2-S has SiLU, which is smooth). So in zoo-model a parameter
# past MODEL_GRAD_LEAF passes only if the CPU step itself moves it by at
# least ZOO_NOISE_SHARE of its GPU-CPU gap when the images take ZOO_NOISE
# relative noise; the relative L2 bound over all parameters stays.
ZOO_NOISE, ZOO_NOISE_SHARE = 1e-6, 1.0 / 3.0


def with_image_noise(batch: dict, seed: int) -> dict:
    """`batch` (numpy) with its images times 1 + ZOO_NOISE N(0, 1)."""
    rng = np.random.RandomState(seed)
    image = batch["image"]
    return dict(batch, image=(image * (1 + ZOO_NOISE * rng.randn(*image.shape))).astype(
        image.dtype))


def _leaves_past_bound(g_gpu: dict, g_cpu: dict, g_noise: dict) -> tuple:
    """([(GPU-CPU error, the CPU's own move under noise, name)] of the
    parameters past MODEL_GRAD_LEAF, both relative to the parameter's
    largest value; the names of those the noise does not explain)."""
    top = max(r.abs().max().item() for r in g_cpu.values())
    past = []
    for k, r in g_cpu.items():
        m = r.abs().max().item()
        err = (g_gpu[k] - r).abs().max().item() / m if m >= 1e-6 * top else 0.0
        if err > MODEL_GRAD_LEAF:
            past.append((err, (g_noise[k] - r).abs().max().item() / m, k))
    return sorted(past, reverse=True), [k for e, n, k in past if n < ZOO_NOISE_SHARE * e]


def _leaf_verdict(leaf: tuple, g_gpu: dict, g_cpu: dict, noise_run) -> tuple:
    """(whether the per-parameter bound holds, a note for the printout):
    the worst parameter within MODEL_GRAD_LEAF or, given the CPU run on
    noisy images (zoo-model), every parameter past it explained by the
    noise (_leaves_past_bound)."""
    if noise_run is None:
        return leaf[0] <= MODEL_GRAD_LEAF, ""
    past, unexplained = _leaves_past_bound(g_gpu, g_cpu, noise_run[1])
    return not unexplained, (
        f"; {len(past)} past it, each with the CPU's own move under {ZOO_NOISE:g} image noise: "
        + ", ".join(f"{k} {e:.2e} vs {n:.2e}" for e, n, k in past[:4])
        + f"; unexplained {unexplained}")


def _grad_agreement(got: dict, ref: dict) -> tuple:
    """(relative L2 over all tensors together, (worst per-tensor max|diff| /
    max|ref|, its name)) of two {name: tensor} dicts, tensors whose largest
    value is below 1e-6 of the overall largest skipped in the second."""
    got = {k: v.double().cpu() for k, v in got.items()}
    ref = {k: v.double().cpu() for k, v in ref.items()}
    if set(got) != set(ref):
        raise AssertionError(f"different tensors: {sorted(set(got) ^ set(ref))[:5]}")
    top = max(r.abs().max().item() for r in ref.values())
    num = sum(((got[k] - r) ** 2).sum().item() for k, r in ref.items())
    den = sum((r ** 2).sum().item() for r in ref.values())
    leaf = max(((got[k] - r).abs().max().item() / r.abs().max().item(), k)
               for k, r in ref.items() if r.abs().max().item() >= 1e-6 * top)
    return (num / den) ** 0.5, leaf


def phase_train_model(use_prior: bool = False,
                      feature_volume_type: str = "mlp_feature_volume", parts=None) -> None:
    """One f32 BD step, GPU against CPU, from the same weights and batch;
    with use_prior (temporal-train-model) the temporal BDNet, both devices
    given the same augmentation draws (drawn once on the GPU); with
    feature_volume_type DOT (bd-dot-train-model) the dot-product BDNet; with
    `parts` (zoo-model) that ZOO model."""
    import copy

    from implicit_depth_tpu_torch.models.bd_net import draw_prior_noise
    from implicit_depth_tpu_torch.ops import image as image_ops
    from implicit_depth_tpu_torch.train import state
    from implicit_depth_tpu_torch.utils.fixtures import synthetic_bd_batch

    label = ("temporal-train-model" if use_prior else
             "bd-dot-train-model" if feature_volume_type == DOT else
             "zoo-model" if parts else "train-model")
    net = flagship_net(torch.float32, use_prior=use_prior, feature_volume_type=feature_volume_type,
                       **(parts or {}))
    cur, src = synthetic_bd_batch(batch=1, num_src=7, height=128, width=192, num_rays=256,
                                  samples_per_ray=64, seed=2)
    noise = (draw_prior_noise(cur["sampled_depths"].shape, torch.float32,
                              torch.Generator(device="cuda").manual_seed(5))
             if use_prior else None)
    runs = {}
    for run in ("cpu", "cuda") + (("cpu+noise",) if parts else ()):
        dev = run.split("+")[0]
        n = copy.deepcopy(net).to(dev)
        opt, sched = state.make_optimizer(n.parameters(), lr=1e-4, wd=1e-4)
        # the edge mask's quantile threshold can flip a pixel between two
        # devices' rounding, which moves the regulariser by a whole ray:
        # compared on its own below
        step = state.make_bd_train_step(n, opt, sched, edge_regularisation=False)
        c, s = (cur, src) if run != "cpu+noise" else (with_image_noise(cur, 7),
                                                      with_image_noise(src, 8))
        batch = ({k: torch.tensor(v, device=dev) for k, v in c.items()},
                 {k: torch.tensor(v, device=dev) for k, v in s.items()})
        losses = step(batch, flip=True, prior_noise=None if noise is None else
                      [tuple(u.to(dev) for u in pair) for pair in noise])
        runs[run] = (float(losses["loss"]),
                     {k: p.grad.detach().double().cpu() for k, p in n.named_parameters()},
                     image_ops.get_edge_mask(batch[0]["gt_depth"]).cpu())
    (l_cpu, g_cpu, e_cpu), (l_gpu, g_gpu, e_gpu) = runs["cpu"], runs["cuda"]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    grad_l2, leaf = _grad_agreement(g_gpu, g_cpu)
    leaves_ok, past_note = _leaf_verdict(leaf, g_gpu, g_cpu, runs.get("cpu+noise"))
    edge_diff = (e_gpu != e_cpu).float().mean().item()
    kind = ("temporal " if use_prior else "dot-product " if feature_volume_type == DOT else
            f"{parts} " if parts else "")
    print(f"{label}: one f32 train step, flagship-width {kind}BDNet at "
          f"128x192, b=1, N=256, S=64, flip on, GPU (kernels) vs CPU (plain versions): loss {l_gpu:.6f} vs {l_cpu:.6f} "
          f"(relative {loss_rel:.2e}, bound {MODEL_LOSS_REL}); gradients relative L2 "
          f"{grad_l2:.2e} (bound {MODEL_GRAD_L2}), worst parameter {leaf[1]} {leaf[0]:.2e} "
          f"(bound {MODEL_GRAD_LEAF}{past_note}); edge mask pixels differing {edge_diff:.2e}",
          flush=True)
    if not (loss_rel <= MODEL_LOSS_REL and grad_l2 <= MODEL_GRAD_L2
            and leaves_ok and edge_diff <= 1e-2):
        raise AssertionError(f"{label}: the GPU train step disagrees with the CPU one")

# ---------------------------------------------------------------- the warp

WARP_EVAL = dict(K=7, H=96, W=128, D=64)     # one frame of the eval path: b=1 x 7 views
WARP_TRAIN = dict(K=112, H=96, W=128, D=64)  # a train step at b=16: 16 x 7 views
WARP_RAGGED = dict(K=3, H=50, W=70, D=13)
WARP_AT_CENTRE = (40, 30, 32)  # (u0, v0, d0): view 0's camera centre on this output point
# #5 and #6 vs plain, (atol, rtol): the JAX package's bounds for its warp
# kernels against the XLA sampler (tests/test_warp_kernel.py). The sample
# coordinates are the same bits on both sides; the bilinear blend rounds in
# another order, and #6 adds a source texel's contributions in another
# (fixed) order than the plain version's autograd: chunk by chunk of planes,
# then by cell, then by pixel. In bf16 one bf16 ulp (at most 2^-7 of the value) on top:
# both round one f32 value to bf16 and may straddle a rounding boundary.
BF16_ULP = 2.0 ** -7
WARP_TOL = {torch.float32: ((2e-4, 1e-4), (3e-4, 1e-3)),
            torch.bfloat16: ((2e-4, 1e-4 + BF16_ULP), (3e-4, 1e-3 + BF16_ULP))}
WARP_CHUNK = 16  # views per call of a plain version at the train shape (device memory)
WARP_POINT_FLOPS = 16 + 4 * 16 * 2  # coordinates, then 4 taps x 16 channels (multiply-add)


def _rot(axis: int, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    i, j = [a for a in range(3) if a != axis]
    R = np.eye(3)
    R[i, i], R[i, j], R[j, i], R[j, j] = c, -s, s, c
    return R


def warp_operands(K: int, H: int, W: int, D: int, dtype, seed: int = 0, device="cuda",
                  extreme: bool = False, at_centre: tuple | None = None) -> tuple:
    """Seeded operands of the warp: source features (K', H, W, 16), the
    homography components A (K', 3, 3), b (K', 3) of views at small random
    rotations and translations around the current one (intrinsics at
    matching resolution), log-spaced planes 0.25-5 m. `extreme` turns every
    other view by ~70 degrees and pushes it back, so that some samples fall
    behind the camera and many out of frame. `at_centre` = (u0, v0, d0)
    puts view 0's camera centre on the ray of output pixel (u0, v0) at plane
    d0: t = -R X with X = planes[d0] K^-1 (u0 + .5, v0 + .5, 1), so
    b = K t = -planes[d0] A (u0 + .5, v0 + .5, 1), evaluated in f32 in the
    kernels' order so that r is exactly 0 there: z sits at its clamp and the
    sample lands at x = y = -0.5, in frame (its tap (1, 1) is texel (0, 0))."""
    from implicit_depth_tpu_torch.core import geometry

    rng = np.random.RandomState(seed)
    Kmat = np.array([[0.9 * W, 0, W / 2], [0, 0.9 * H, H / 2], [0, 0, 1.0]])
    A = np.zeros((K, 3, 3), np.float32)
    b = np.zeros((K, 3), np.float32)
    for k in range(K):
        R = _rot(2, rng.uniform(-0.1, 0.1)) @ _rot(1, rng.uniform(-0.15, 0.15)) \
            @ _rot(0, rng.uniform(-0.1, 0.1))
        t = rng.uniform(-0.3, 0.3, 3)
        if extreme and k % 2:
            R = _rot(1, 1.2) @ R
            t = t + np.array([0.0, 0.0, -1.0])
        A[k] = Kmat @ R @ np.linalg.inv(Kmat)
        b[k] = Kmat @ t
    gen = torch.Generator().manual_seed(seed)
    src = torch.randn((K, H, W, 16), generator=gen).to(device, dtype)
    planes = geometry.log_depth_planes(0.25, 5.0, D, device=device)
    if at_centre is not None:
        u0, v0, d0 = at_centre
        dep, uu, vv = planes[d0].cpu().numpy(), np.float32(u0 + 0.5), np.float32(v0 + 0.5)
        for i in range(3):
            p = (A[0, i, 0] * uu + A[0, i, 1] * vv) + A[0, i, 2]  # f32, as sample_coords
            b[0, i] = -(dep * p)
    return src, torch.tensor(A, device=device), torch.tensor(b, device=device), planes


def _frame_shares(A, b, planes, H: int, W: int) -> tuple:
    """Shares of the sample points behind the camera (z at its clamp) and
    wholly out of frame (no tap inside the image), and the count of clamped
    samples with a tap inside the image."""
    from implicit_depth_tpu_torch.ops import warp_kernel as wk

    x, y, clamped = wk.sample_points(A, b, planes, H, W)
    outside = (x <= -1) | (x >= W) | (y <= -1) | (y >= H)
    return (clamped.float().mean().item(), outside.float().mean().item(),
            int((clamped & ~outside).sum()))


def _in_chunks(fn, K: int, chunk: int):
    """fn(slice) for consecutive slices of the view axis, concatenated."""
    return torch.cat([fn(slice(i, min(i + chunk, K))) for i in range(0, K, chunk)])


def _warp_check(label: str, got, ref, atol: float, rtol: float) -> float:
    err = (got.float() - ref.float()).abs()
    bound = atol + rtol * ref.float().abs()
    if got.shape != ref.shape or got.dtype != ref.dtype or \
            not torch.isfinite(got.float()).all() or (err > bound).any():
        raise AssertionError(f"kernel-warp {label} disagrees with its plain version: "
                             f"max_abs_err {err.max().item():.3e}, worst excess "
                             f"{(err - bound).max().item():.3e}")
    return err.max().item()


def phase_kernel_warp() -> dict:
    from implicit_depth_tpu_torch.ops import warp_kernel as wk

    result = {}
    at_centre = {"at_centre": WARP_AT_CENTRE}
    for label, shape, dtype, geo in (("eval f32", WARP_EVAL, torch.float32, {}),
                                     ("eval bf16", WARP_EVAL, torch.bfloat16, {}),
                                     ("train bf16", WARP_TRAIN, torch.bfloat16, {}),
                                     ("ragged f32", WARP_RAGGED, torch.float32, {"extreme": True}),
                                     ("at-centre f32", WARP_EVAL, torch.float32, at_centre),
                                     ("at-centre bf16", WARP_EVAL, torch.bfloat16, at_centre)):
        K, H, W, D = (shape[x] for x in "KHWD")
        src, A, b, planes = warp_operands(**shape, dtype=dtype, seed=1, **geo)
        gen = torch.Generator(device="cuda").manual_seed(2)
        ct = torch.randn((K, D, H, W, 16), generator=gen, device="cuda").to(dtype)

        def ref_fwd(sl):
            return wk.warp_planes_reference(src[sl], A[sl], b[sl], planes)

        def ref_bwd(sl):
            return wk.warp_planes_bwd_reference(ct[sl], A[sl], b[sl], planes)

        (fa, fr), (ba, br) = WARP_TOL[dtype]
        with torch.no_grad():
            out = wk.warp_planes(src, A, b, planes)
            f_err = _warp_check(f"{label} forward", out, _in_chunks(ref_fwd, K, WARP_CHUNK), fa, fr)
        g = wk.warp_planes_bwd(ct, A, b, planes)
        b_err = _warp_check(f"{label} transpose", g, _in_chunks(ref_bwd, K, WARP_CHUNK), ba, br)
        same_bits = torch.equal(g, wk.warp_planes_bwd(ct, A, b, planes))
        torch.cuda.synchronize()
        behind, outside, clamped_in = _frame_shares(A, b, planes, H, W)
        line = (f"kernel-warp {label} K'={K} D={D} {H}x{W} ({behind:.1%} of the samples behind the "
                f"camera, {outside:.1%} out of frame, {clamped_in} clamped in frame): forward "
                f"max_abs_err {f_err:.3e} (bound {fa} + {fr:.4g}*|ref|), transpose max_abs_err "
                f"{b_err:.3e} (bound {ba} + {br:.4g}*|ref|), two transposes give "
                f"{'identical' if same_bits else 'different'} bits")
        if not same_bits:
            raise AssertionError(f"kernel-warp {label}: two launches of the transpose differ")
        if geo.get("at_centre") and clamped_in == 0:
            raise AssertionError(f"kernel-warp {label}: no clamped sample lands in frame")
        if dtype == torch.bfloat16 and not geo:  # timed at the eval and train shapes
            line += _warp_timings(label, result, src, A, b, planes, ct, out, g, ref_fwd, ref_bwd)
            result[label]["fwd"]["max_abs_err"] = f_err
            result[label]["bwd"]["max_abs_err"] = b_err
        print(line, flush=True)
        del src, ct, out, g
        torch.cuda.empty_cache()
    return result


def _warp_timings(label, result, src, A, b, planes, ct, out, g, ref_fwd, ref_bwd) -> str:
    """Medians of the kernels, the plain versions (in view chunks) and the
    library calls, and the bounds; stored in result[label]."""
    import torch.nn.functional as F

    from implicit_depth_tpu_torch.ops import warp_kernel as wk

    K, H, W, C = src.shape
    D = planes.shape[0]
    with torch.no_grad():
        f_ms = cuda_ms(lambda: wk.warp_planes(src, A, b, planes))
        f_plain = cuda_ms(lambda: _in_chunks(ref_fwd, K, WARP_CHUNK), runs=3)
    b_ms = cuda_ms(lambda: wk.warp_planes_bwd(ct, A, b, planes))
    b_plain = cuda_ms(lambda: _in_chunks(ref_bwd, K, WARP_CHUNK), runs=3)
    # the library yardstick: F.grid_sample on NCHW with a precomputed
    # (K', D*H, W, 2) grid in the features' dtype, and its backward; the
    # layout permutes are outside the timed calls
    x, y = wk.sample_coords(A, b, planes, H, W)
    grid = torch.stack([(2 * x + 1) / W - 1, (2 * y + 1) / H - 1], -1)
    grid = grid.reshape(K, D * H, W, 2).to(src.dtype)
    inp = src.permute(0, 3, 1, 2).contiguous()
    gout = ct.permute(0, 4, 1, 2, 3).reshape(K, C, D * H, W).contiguous()
    del x, y
    with torch.no_grad():
        f_lib = cuda_ms(lambda: F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros",
                                              align_corners=False))
        b_lib = cuda_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
            gout, inp, grid, 0, 0, False, [True, False]))
    del grid, inp, gout
    points = K * D * H * W
    fb = least_ms(nbytes(src, A, b, planes, out), points * WARP_POINT_FLOPS, F32_FLOP_PER_S)
    bb = least_ms(nbytes(ct, A, b, planes, g), points * WARP_POINT_FLOPS, F32_FLOP_PER_S)
    result[label] = {
        "fwd": {"ms": f_ms, "plain_ms": f_plain, "library_ms": f_lib, "bound_ms": fb[0],
                "bound_by": fb[1]},
        "bwd": {"ms": b_ms, "plain_ms": b_plain, "library_ms": b_lib, "bound_ms": bb[0],
                "bound_by": bb[1]}}
    return (f"; forward kernel {f_ms:.3f} ms, plain {f_plain:.3f} ms, grid_sample {f_lib:.3f} ms, "
            f"bound {fb[0]:.4f} ms ({fb[1]}); transpose kernel {b_ms:.3f} ms, plain "
            f"{b_plain:.3f} ms, grid_sampler_2d_backward {b_lib:.3f} ms, bound {bb[0]:.4f} ms "
            f"({bb[1]}) (medians; library calls without the layout permutes)")


# ------------------------------------------------------ the regression slice

def reg_net(dtype, feature_volume_type: str = "mlp_feature_volume", seed: int = 0, **parts):
    """The flagship regression DepthNet (configs/models/regression_model.yaml:
    EfficientNetV2-S, ResNet matching encoder, 7 source views, 64 planes,
    U-Net++ with log-depth heads; `parts` names other encoders or decoder,
    as ZOO does), seeded random weights."""
    from implicit_depth_tpu_torch.models.depth_net import DepthNet
    from implicit_depth_tpu_torch.weights import init_params

    net = DepthNet(feature_volume_type=feature_volume_type, num_src_views=7, num_depth_bins=64,
                   compute_dtype=dtype, **parts)
    return init_params(net, torch.Generator().manual_seed(seed))


def reg_eval_dataset():
    """The synthetic 512x384 test tuples of the regression eval phases."""
    from implicit_depth_tpu_torch.data.synthetic import SyntheticDataset

    return SyntheticDataset(num_frames=12, num_views=8, image_height=384, image_width=512,
                            split="test", get_bd_info=False)


def _reg_eval(label: str, net, ds) -> dict:
    """evaluate_depth over `ds` at b=1 with the launch counts zeroed just
    before; raises unless every tuple ran one forward, #5 launched once a
    forward and the others never, and the metrics are finite."""
    from implicit_depth_tpu_torch.eval.depth_eval import evaluate_depth

    reset_launch_counts()
    res = evaluate_depth(net, {"scene0": ds}, batch_size=1)
    counts = launch_counts()
    n = res["forwards"]
    if n != len(ds) or counts != (0, 0, 0, 0, n, 0):
        raise AssertionError(f"{label}: {n} forwards over {len(ds)} tuples, kernel launches "
                             f"#1-#6 {counts}, expected {(0, 0, 0, 0, n, 0)}")
    metrics = res["all_scene"].final_metrics
    if res["nonfinite_preds"] or not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{label}: {res['nonfinite_preds']} non-finite predictions, "
                             f"metrics {metrics}")
    res["counts"] = counts
    return res


def phase_reg_main() -> dict:
    from implicit_depth_tpu_torch.data.mvs_dataset import collate

    ds = reg_eval_dataset()
    net = reg_net(torch.bfloat16).cuda().eval().cast_to_compute_dtype()
    res = _reg_eval("reg-main", net, ds)
    n, counts, metrics = res["forwards"], res["counts"], res["all_scene"].final_metrics
    print(f"reg-main: {n} forwards of DepthNet (EfficientNetV2-S, K=7, D=64, bf16, seeded random "
          f"weights) through evaluate_depth on 512x384 synthetic tuples, b=1: reg_model_time_ms "
          f"{res['model_time_ms']:.3f}, launches #1-#6 {counts}, abs_rel "
          f"{metrics['abs_rel']:.4f}, a1 {metrics['a1']:.4f}", flush=True)
    del net

    dot = reg_net(torch.bfloat16, "simple_cost_volume").cuda().eval().cast_to_compute_dtype()
    cur, src = ({k: torch.as_tensor(v).cuda() for k, v in d.items() if k != "frame_id_string"}
                for d in collate([ds[0]]))
    reset_launch_counts()
    with torch.inference_mode():
        out = dot(cur, src)
    counts = launch_counts()
    if counts != (0, 0, 0, 0, 1, 0) or not all(torch.isfinite(v).all() for v in out.values()):
        raise AssertionError(f"reg-main dot product: launches #1-#6 {counts}, or non-finite "
                             "outputs")
    print(f"reg-main: one forward of the dot-product DepthNet (dot_product_model.yaml, bf16): "
          f"launches #1-#6 {counts}, depth_pred_0 {tuple(out['depth_pred_0'].shape)} finite",
          flush=True)
    return {"launches": res["forwards"], "reg_model_time_ms": res["model_time_ms"]}


REG_BATCH = 16  # regression_model.yaml's batch_size


def phase_reg_train(label: str = "reg-train", parts=None) -> dict:
    """TRAIN_STEPS steps of make_regression_train_step on the flagship
    DepthNet (with `parts`, a ZOO model, whose every parameter is watched)
    at b=REG_BATCH, then one profiled step."""
    from implicit_depth_tpu_torch.data.mvs_dataset import collate
    from implicit_depth_tpu_torch.data.synthetic import SyntheticDataset
    from implicit_depth_tpu_torch.train import state

    t0 = time.perf_counter()
    ds = SyntheticDataset(num_frames=REG_BATCH + 7, num_views=8, image_height=384,
                          image_width=512, split="train", get_bd_info=False)
    cur, src = ({k: torch.as_tensor(v).cuda() for k, v in d.items() if k != "frame_id_string"}
                for d in collate([ds[i] for i in range(REG_BATCH)]))
    data_s = time.perf_counter() - t0
    net = reg_net(torch.bfloat16, **(parts or {})).cuda()
    opt, sched = state.make_optimizer(net.parameters(), lr=1e-4, wd=1e-4)
    step = state.make_regression_train_step(net, opt, sched,
                                            generator=torch.Generator().manual_seed(0))
    if parts:
        watched = {k: p for k, p in net.named_parameters() if k not in NO_GRADIENT}
    else:
        watched = {"encoder.conv_stem.weight": net.encoder.conv_stem.weight,
                   "matching.conv1.weight": net.matching.conv1.weight,
                   "volume_mlp.fc0_kernel": net.volume_mlp.fc0_kernel,
                   "decoder.output_head_0.weight": net.decoder.output_head_0.weight,
                   "matching.bn1.running_var": net.matching.bn1.running_var,
                   "encoder.s5_b14.bn3.running_mean": net.encoder.s5_b14.bn3.running_mean}
    before = {k: v.detach().clone() for k, v in watched.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = step((cur, src))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        losses.append({k: float(v) for k, v in out.items()})
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    n = TRAIN_STEPS
    if counts != (0, 0, 0, 0, n, n):
        raise AssertionError(f"{label}: kernel launches #1-#6 {counts} over {n} steps, "
                             f"expected {(0, 0, 0, 0, n, n)}")
    if not all(np.isfinite(v) for ls in losses for v in ls.values()):
        raise AssertionError(f"{label}: non-finite losses {losses}")
    moved = {k: not torch.equal(before[k], v.detach()) for k, v in watched.items()}
    if not all(moved.values()):
        raise AssertionError(f"{label}: parameters or BN statistics did not move: "
                             f"{sorted(k for k, m in moved.items() if not m)}")
    step_ms = float(np.median(times[1:]))
    model = f"DepthNet {parts}" if parts else "DepthNet EfficientNetV2-S"
    print(f"{label}: {n} steps of make_regression_train_step ({model}, K=7, "
          f"D=64, bf16 autocast, f32 params, seeded random weights), b={REG_BATCH} synthetic "
          f"512x384 tuples (data {data_s:.1f} s): reg_train_step_ms {step_ms:.1f} (median of "
          f"steps 2-{n}; all {', '.join(f'{t:.1f}' for t in times)}), peak device memory "
          f"{peak_gb:.2f} GiB, launches #1-#6 {counts}, loss {losses[0]['loss']:.4f} -> "
          f"{losses[-1]['loss']:.4f}, moved {len(moved)} watched tensors", flush=True)
    _print_profile(label, _profile_step(step, (cur, src)))
    return {"launches": counts, "reg_train_step_ms": step_ms, "peak_gb": peak_gb}


def phase_reg_train_model(label: str = "reg-train-model", parts=None) -> None:
    """One f32 regression step, GPU against CPU, held to the BD step's
    bounds (MODEL_*): the same causes of spread (f32 sums in other orders,
    LeakyReLU slope ties in the volume MLP, ~60 layers of backward). With
    `parts` the ZOO model's DepthNet."""
    import copy

    from implicit_depth_tpu_torch.train import state
    from implicit_depth_tpu_torch.utils.fixtures import synthetic_bd_batch

    net = reg_net(torch.float32, **(parts or {}))
    cur, src = synthetic_bd_batch(batch=1, num_src=7, height=128, width=192, num_rays=4,
                                  samples_per_ray=2, seed=2)
    cur = {k: v for k, v in cur.items() if k not in ("gt_depth", "sampled_rays", "sampled_depths")}
    runs = {}
    for run in ("cpu", "cuda") + (("cpu+noise",) if parts else ()):
        dev = run.split("+")[0]
        n = copy.deepcopy(net).to(dev)
        opt, sched = state.make_optimizer(n.parameters(), lr=1e-4, wd=1e-4)
        step = state.make_regression_train_step(n, opt, sched)
        c, s = (cur, src) if run != "cpu+noise" else (with_image_noise(cur, 7),
                                                      with_image_noise(src, 8))
        batch = ({k: torch.tensor(v, device=dev) for k, v in c.items()},
                 {k: torch.tensor(v, device=dev) for k, v in s.items()})
        losses = step(batch, flip=True)
        runs[run] = (float(losses["loss"]),
                     {k: p.grad.detach().double().cpu() for k, p in n.named_parameters()})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = runs["cpu"], runs["cuda"]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    grad_l2, leaf = _grad_agreement(g_gpu, g_cpu)
    leaves_ok, past_note = _leaf_verdict(leaf, g_gpu, g_cpu, runs.get("cpu+noise"))
    model = f"DepthNet {parts}" if parts else "DepthNet"
    print(f"{label}: one f32 regression step, flagship-width {model} at 128x192, b=1, "
          f"flip on, GPU (kernels) vs CPU (plain versions): loss {l_gpu:.6f} vs {l_cpu:.6f} "
          f"(relative {loss_rel:.2e}, bound {MODEL_LOSS_REL}); gradients relative L2 "
          f"{grad_l2:.2e} (bound {MODEL_GRAD_L2}), worst parameter {leaf[1]} {leaf[0]:.2e} "
          f"(bound {MODEL_GRAD_LEAF}{past_note})", flush=True)
    if not (loss_rel <= MODEL_LOSS_REL and grad_l2 <= MODEL_GRAD_L2 and leaves_ok):
        raise AssertionError(f"{label}: the GPU regression step disagrees with the CPU one")


# ------------------------------------------------------- the temporal slice

TEMPORAL_FRAMES = 10  # one scene's frames in temporal-main: two plane windows
# synthetic_temporal.yaml: 512x384 images (256x192 maps), 8 views, windows
# of eval_length 5 frames, warmup 1
TEMPORAL = dict(image_height=384, image_width=512, num_views=8, eval_length=5, warmup=1)
# Frame mode and window mode run the same forwards on the same inputs in the
# same order (the window mode only defers the host's reads), so their
# per-frame sigmoid maps agree to this bound (measured equal) and the flips
# counted by the C++ host sampling and by the device scorer are equal.
TEMPORAL_MAP_BOUND = 1e-6


def phase_temporal_main() -> dict:
    """evaluate_temporal with the flagship temporal BDNet (bf16, seeded
    weights, use_prior) over 10 frames of one synthetic scene against its
    1M-face procedural mesh: frame mode (host C++ scoring), window mode with
    device scoring, and window mode again without collecting the maps (its
    times)."""

    from implicit_depth_tpu_torch.data.synthetic import SyntheticDataset
    from implicit_depth_tpu_torch.eval.temporal_driver import evaluate_temporal

    t0 = time.perf_counter()
    ds = SyntheticDataset(num_frames=TEMPORAL_FRAMES + TEMPORAL["num_views"] - 1,
                          num_views=TEMPORAL["num_views"], image_height=TEMPORAL["image_height"],
                          image_width=TEMPORAL["image_width"], split="val", get_bd_info=True)
    # the dataset keeps what it renders: render every frame now, so that no
    # mode pays the synthetic renderer (~100 ms a frame, not a decoder's cost)
    for i in range(ds.num_frames):
        ds.get_frame("scene0", str(i))
    mesh = SyntheticDataset.get_gt_mesh_path("", "val", "scene0")
    setup_s = time.perf_counter() - t0
    net = flagship_net(torch.bfloat16, use_prior=True).cuda().cast_to_compute_dtype()
    kw = dict(eval_length=TEMPORAL["eval_length"], warmup=TEMPORAL["warmup"],
              height=ds.depth_height, width=ds.depth_width)
    runs = {}
    for mode, extra in (("frame", dict(collect_preds=True)),
                        ("window", dict(use_scan=True, device_scoring=True, collect_preds=True)),
                        ("window-timed", dict(use_scan=True))):
        reset_launch_counts()
        res = evaluate_temporal(net, {"scene0": ds}, {"scene0": mesh}, **kw, **extra)
        torch.cuda.synchronize()
        counts = launch_counts()
        n = res["n_frames"]
        if n != TEMPORAL_FRAMES or counts != (n, 0, 0, 0, 0, 0):
            raise AssertionError(f"temporal-main {mode}: {n} frames, kernel launches #1-#6 "
                                 f"{counts}, expected {(TEMPORAL_FRAMES, 0, 0, 0, 0, 0)}")
        if not np.isfinite(res["temporal_score"]) or res["total_verts"] <= 0:
            raise AssertionError(f"temporal-main {mode}: temporal_score "
                                 f"{res['temporal_score']}, {res['total_verts']} vertices")
        runs[mode] = res
    frame, window = runs["frame"], runs["window"]
    diff = max(float(np.abs(a - b).max()) for a, b in zip(frame["preds"], window["preds"]))
    if len(window["preds"]) != TEMPORAL_FRAMES or diff > TEMPORAL_MAP_BOUND or \
            (frame["total_diffs"], frame["total_verts"]) != (window["total_diffs"],
                                                              window["total_verts"]):
        raise AssertionError(f"temporal-main: window mode vs frame mode: maps differ by {diff:.3e} "
                             f"(bound {TEMPORAL_MAP_BOUND}), flips/vertices "
                             f"{window['total_diffs']}/{window['total_verts']} vs "
                             f"{frame['total_diffs']}/{frame['total_verts']}")
    occluded = float(np.mean([(p > 0.5).mean() for p in frame["preds"]]))
    print(f"temporal-main: evaluate_temporal, flagship temporal BDNet (EfficientNetV2-S, K=7, "
          f"D=64, prior, bf16, seeded random weights), {TEMPORAL_FRAMES} frames of one synthetic "
          f"512x384 scene, windows of {TEMPORAL['eval_length']}, 1M-face mesh (data and mesh "
          f"{setup_s:.1f} s): temporal_score {frame['temporal_score']:.4f} "
          f"({frame['total_diffs']:.0f} flips / {frame['total_verts']} vertices, equal in window "
          f"mode with device scoring; maps within {diff:.2e}, share occluded {occluded:.3f}); "
          f"launches #1-#6 per mode {(TEMPORAL_FRAMES, 0, 0, 0, 0, 0)}; host cores "
          f"{os.cpu_count()}", flush=True)
    out = {}
    for mode, res in runs.items():
        ft = np.asarray(res["frame_times"]) * 1e3
        print(f"temporal-main {mode} mode: frame time median {np.median(ft):.2f} ms "
              f"({res['frames_per_sec']:.2f} frames/s; all {', '.join(f'{t:.1f}' for t in ft)}), "
              f"forward {res['forward_ms']:.2f} ms (CUDA events, median), raster "
              f"{res['raster_ms']:.2f} ms and staging {res['stage_ms']:.2f} ms per frame (host, "
              f"medians)", flush=True)
        out[mode] = {"frame_ms": float(np.median(ft)), "forward_ms": res["forward_ms"],
                     "raster_ms": res["raster_ms"], "stage_ms": res["stage_ms"]}
    out["launches"] = TEMPORAL_FRAMES
    return out


def phase_temporal_train() -> dict:
    """6 steps of make_bd_train_step on the flagship temporal BDNet at b=12:
    #1-#4 launch 1/1/4/4 per step, every ray-head launch with the prior."""
    res = _train_run(12, use_prior=True)
    n = TRAIN_STEPS
    step_ms = _check_train("temporal-train", res, (n, n, 4 * n, 4 * n, 0, 0))
    if res["prior_launches"] != (4 * n, 4 * n):
        raise AssertionError(f"temporal-train: #3/#4 launches with the prior "
                             f"{res['prior_launches']} over {n} steps, expected {(4 * n, 4 * n)}")
    print(f"temporal-train: {n} steps of make_bd_train_step, flagship temporal BDNet (prior, "
          f"bf16 autocast, f32 params, seeded random weights), b={res['b']} synthetic 512x384 "
          f"tuples, N=4096, S=64 (data {res['data_s']:.1f} s): train_step_ms {step_ms:.1f} "
          f"(median of steps 2-{n}; all {', '.join(f'{t:.1f}' for t in res['times'])}), peak "
          f"device memory {res['peak_gb']:.2f} GiB, launches #1-#6 {res['launches']}, with the "
          f"prior #3/#4 {res['prior_launches']}, loss {res['losses'][0]['loss']:.4f} -> "
          f"{res['losses'][-1]['loss']:.4f}", flush=True)
    _print_profile("temporal-train", res["profile"])
    return {"launches": res["launches"], "train_step_ms": step_ms, "peak_gb": res["peak_gb"]}


def phase_reg_temporal() -> dict:
    """cli/test_reg.py's temporal path (cli.test_bd.run_temporal with
    regression=True) with the flagship DepthNet, 5 frames of the synthetic
    temporal config: kernel #5 once per frame."""
    from implicit_depth_tpu_torch.cli.test_bd import run_temporal
    from implicit_depth_tpu_torch.config import Config
    from implicit_depth_tpu_torch.data.synthetic import SyntheticDataset
    from implicit_depth_tpu_torch.train.loop import build_dataset

    frames = 5
    cfg = Config(dataset="synthetic", split="val", image_height=TEMPORAL["image_height"],
                 image_width=TEMPORAL["image_width"], model_num_views=TEMPORAL["num_views"],
                 eval_length=TEMPORAL["eval_length"], warmup=TEMPORAL["warmup"],
                 max_frames=frames)
    ds = build_dataset(cfg, cfg.split, "bd", limit_to_scan_id="scene0")
    for i in range(ds.num_frames):  # render before timing, as temporal-main
        ds.get_frame("scene0", str(i))
    net = reg_net(torch.bfloat16).cuda().eval().cast_to_compute_dtype()
    reset_launch_counts()
    res = run_temporal(cfg, net, {"scene0": ds}, SyntheticDataset, regression=True)
    counts = launch_counts()
    if res["n_frames"] != frames or counts != (0, 0, 0, 0, frames, 0) or \
            not np.isfinite(res["temporal_score"]):
        raise AssertionError(f"reg-temporal: {res['n_frames']} frames, launches #1-#6 {counts}, "
                             f"expected {(0, 0, 0, 0, frames, 0)}, temporal_score "
                             f"{res['temporal_score']}")
    ft = np.asarray(res["frame_times"]) * 1e3
    print(f"reg-temporal: the test_reg --temporal_eval path, flagship DepthNet (bf16, seeded "
          f"random weights), {frames} frames: temporal_score {res['temporal_score']:.4f}, frame "
          f"time median {np.median(ft):.2f} ms, forward {res['forward_ms']:.2f} ms, raster "
          f"{res['raster_ms']:.2f} ms per frame, launches #1-#6 {counts}", flush=True)
    return {"launches": frames, "frame_ms": float(np.median(ft)), "forward_ms": res["forward_ms"]}


RASTER_THREADS = (1, 2, 4)
_RASTER_TIMING = r"""
import sys, time
import numpy as np
from implicit_depth_tpu_torch.data.synthetic import SyntheticDataset
from implicit_depth_tpu_torch.eval import rasterizer as ras
ds = SyntheticDataset(num_frames=8, num_views=8, image_height=384, image_width=512, split="val")
frame = ds.get_frame("scene0", 4)
verts, faces = ras.load_ply(sys.argv[1])
args = (verts, faces, frame["cam_T_world"], frame["K_s0"], ds.depth_height, ds.depth_width)
ras.rasterize_mesh_depth(*args)
times = []
for _ in range(7):
    t0 = time.perf_counter()
    ras.rasterize_mesh_depth(*args)
    times.append((time.perf_counter() - t0) * 1e3)
print(np.median(times))
"""


def phase_raster_scaling() -> dict:
    """rasterize_mesh_depth on the 1M-face procedural mesh at 256x192, in
    subprocesses with OMP_NUM_THREADS 1, 2, 4 and the host's default: the
    median of 7 calls each."""

    from implicit_depth_tpu_torch.data.synthetic import SyntheticDataset

    mesh = SyntheticDataset.get_gt_mesh_path("", "val", "scene0")
    out = {}
    for threads in RASTER_THREADS + (None,):
        env = dict(os.environ)
        if threads is None:
            env.pop("OMP_NUM_THREADS", None)
        else:
            env["OMP_NUM_THREADS"] = str(threads)
        proc = subprocess.run([sys.executable, "-c", _RASTER_TIMING, mesh], env=env,
                              capture_output=True, text=True, check=True, timeout=300)
        out[str(threads or f"default ({os.cpu_count()} cores)")] = float(
            proc.stdout.split()[-1])
    print("raster-scaling: rasterize_mesh_depth, 1M-face mesh, 256x192, median of 7 calls: "
          + ", ".join(f"OMP_NUM_THREADS={k} {v:.2f} ms" for k, v in out.items()), flush=True)
    return out


# ----------------------------------- depth from the binary oracle, dot volume

def phase_bd_depth() -> dict:
    """evaluate_scenes(binary_eval_depth=True) with the flagship BDNet (bf16)
    over the tuples of phase main at b=1, the depths cached to a temporary
    directory as --cache_depths caches them: #1 once per forward."""
    import pickle
    import tempfile

    net = flagship_net(torch.bfloat16).cuda().cast_to_compute_dtype()
    ds = eval_dataset(pass_frame_id=True)
    with tempfile.TemporaryDirectory() as cache:
        res = _occlusion_eval("bd-depth", net, ds, lambda n: (n, 0, 0, 0, 0, 0),
                              binary_eval_depth=True, cache_dir=cache)
        depths = []
        for name in sorted(os.listdir(os.path.join(cache, "scene0"))):
            with open(os.path.join(cache, "scene0", name), "rb") as f:
                depths.append(pickle.load(f)["search_depths"])
    depths = np.concatenate(depths)
    n, metrics = res["forwards"], res["all_scene"].final_metrics
    if len(depths) != n or depths.shape[1:] != (192, 256, 1) or \
            not (np.isfinite(depths).all() and depths.min() >= 0.5 and depths.max() <= 8.0):
        raise AssertionError(f"bd-depth: cached depths {depths.shape} over {n} forwards, range "
                             f"[{depths.min()}, {depths.max()}], expected within [0.5, 8]")
    if not (np.isfinite(metrics["abs_rel"]) and np.isfinite(metrics["a25"])):
        raise AssertionError(f"bd-depth: abs_rel {metrics['abs_rel']}, a25 {metrics['a25']}")
    inside = float(((depths > 0.51) & (depths < 7.99)).mean())
    print(f"bd-depth: {n} forwards of BDNet.forward_infer_depth (the trunk, then 12 scale-0 head "
          f"passes; EfficientNetV2-S, K=7, D=64, bf16, seeded random weights) through "
          f"evaluate_scenes(binary_eval_depth=True) on 512x384 synthetic tuples, b=1, cached: "
          f"model_time_ms {res['model_time_ms']:.3f}, step_time_ms {res['step_time_ms']:.3f}, "
          f"launches #1-#6 {res['counts']}, depths in [{depths.min():.4f}, {depths.max():.4f}] "
          f"({inside:.3f} of the pixels inside (0.51, 7.99)), abs_rel {metrics['abs_rel']:.4f}, "
          f"a25 {metrics['a25']:.4f}", flush=True)
    _profile_forward("bd-depth", net, ds, binary_eval_depth=True)
    return {"launches": n, "model_time_ms": res["model_time_ms"]}


# GPU against CPU, f32 bisection: the depths agree within DEPTH_ATOL at all but
# the pixels where a logit sits within the devices' rounding of its threshold
# at some step (the output jumps there by up to that step's half-range); the
# CPU tests hold the port to the JAX package at the same share.
DEPTH_ATOL, DEPTH_SHARE = 1e-4, 0.99


def _host_syncs(fn) -> int:
    """The synchronising CUDA calls `fn` makes (torch's sync debug mode)."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


def phase_bd_depth_model() -> None:
    """f32 forward_infer_depth of a flagship-width BDNet at 128x192 with the
    validation thresholds, GPU against CPU from the same weights. Seeded
    random weights would send every pixel's bisection to 0.5 or 8: the
    head's depth input is scaled by 20 and its output negated, so that the
    logit falls with depth, and its last bias set so that the median pixel's
    logit is 0 at 3 m; the bisection then settles inside the range for most
    pixels."""
    from implicit_depth_tpu_torch.utils.fixtures import synthetic_bd_batch

    net = flagship_net(torch.float32)
    cur, src = synthetic_bd_batch(batch=1, num_src=7, height=128, width=192, num_planes=1,
                                  with_train_keys=False, seed=1)
    thr = cli_thresholder(validation=True)
    head = net.binary_mlp
    with torch.no_grad():
        head.s0_fc0.weight[:, 0] *= 20.0
        cpu = ({k: torch.tensor(v) for k, v in cur.items()},
               {k: torch.tensor(v) for k, v in src.items()})
        feats = net.trunk(*cpu)["features"]

        def median_logit(depth: float):
            at = torch.full(cpu[0]["rendered_depth"][..., :1].shape, depth)
            return net.run_mlp_val(cpu[0], feats, at).median()

        if median_logit(4.0) > median_logit(3.0):
            head.s0_fc2.weight.neg_()
            head.s0_fc2.bias.neg_()
        head.s0_fc2.bias -= median_logit(3.0)
    depths = {}
    for dev in ("cpu", "cuda"):
        net = net.to(dev)
        batch = ({k: torch.tensor(v, device=dev) for k, v in cur.items()},
                 {k: torch.tensor(v, device=dev) for k, v in src.items()})
        t = thr.to(dev)
        with torch.no_grad():
            depths[dev] = net.forward_infer_depth(*batch, t.bins, t.thresholds)["search_depths"]
    with torch.no_grad():
        syncs = [_host_syncs(lambda i=i: net.forward_infer_depth(*batch, t.bins, t.thresholds,
                                                                 num_iters=i))
                 for i in (0, 12)]
    probe = _host_syncs(lambda: torch.ones(1, device="cuda").sum().item())
    got, ref = depths["cuda"].cpu(), depths["cpu"]
    share = ((got - ref).abs() <= DEPTH_ATOL).float().mean().item()
    inside = ((ref > 0.51) & (ref < 7.99)).float().mean().item()
    print(f"bd-depth-model: forward_infer_depth f32 128x192, K=7, D=64, validation thresholds: "
          f"GPU (kernel) vs CPU (plain) {share:.4%} of the pixels within {DEPTH_ATOL} (bound "
          f"{DEPTH_SHARE:.0%}), max_abs_err {(got - ref).abs().max().item():.3e}; {inside:.3f} of "
          f"the pixels inside (0.51, 7.99); host synchronisations (sync debug mode, {probe} for "
          f"one .item()) with 0 and 12 iterations {syncs[0]} and {syncs[1]}", flush=True)
    if got.shape != (1, 64, 96) or share < DEPTH_SHARE or inside < 0.5 or probe < 1 or \
            syncs[1] != syncs[0]:
        raise AssertionError("bd-depth-model: the GPU bisection disagrees with the CPU one, "
                             "settles inside the range for too few pixels, or synchronises with "
                             "the host inside the loop")


def phase_bd_dot_main() -> dict:
    """The dot-product BDNet through evaluate_scenes: #5 once per forward."""
    net = flagship_net(torch.bfloat16, feature_volume_type=DOT).cuda().cast_to_compute_dtype()
    res = _occlusion_eval("bd-dot-main", net, eval_dataset(), lambda n: (0, 0, 0, 0, n, 0))
    metrics = res["all_scene"].final_metrics
    _check_ious("bd-dot-main", metrics)
    print(f"bd-dot-main: {res['forwards']} forwards of the dot-product BDNet.forward_val "
          f"(dot_product_model.yaml: EfficientNetV2-S, K=7, D=64, P=8, bf16, seeded random "
          f"weights) on 512x384 synthetic tuples, b=1: model_time_ms {res['model_time_ms']:.3f}, "
          f"step_time_ms {res['step_time_ms']:.3f}, launches #1-#6 {res['counts']}, iou_d_3.0 "
          f"{metrics['iou_d_3.0']:.4f}", flush=True)
    _profile_forward("bd-dot-main", net, eval_dataset())
    return {"launches": res["forwards"], "model_time_ms": res["model_time_ms"]}


def phase_bd_dot_train() -> dict:
    """6 steps of make_bd_train_step on the dot-product BDNet at b=12: #3/#4
    four times a step, #5/#6 once, #1/#2 never."""
    res = _train_run(12, feature_volume_type=DOT)
    n = TRAIN_STEPS
    step_ms = _check_train("bd-dot-train", res, (0, 0, 4 * n, 4 * n, n, n))
    print(f"bd-dot-train: {n} steps of make_bd_train_step, dot-product BDNet "
          f"(dot_product_model.yaml, bf16 autocast, f32 params, seeded random weights), "
          f"b={res['b']} synthetic 512x384 tuples, N=4096, S=64 (data {res['data_s']:.1f} s): "
          f"train_step_ms {step_ms:.1f} (median of steps 2-{n}; all "
          f"{', '.join(f'{t:.1f}' for t in res['times'])}), peak device memory "
          f"{res['peak_gb']:.2f} GiB, launches #1-#6 {res['launches']}, loss "
          f"{res['losses'][0]['loss']:.4f} -> {res['losses'][-1]['loss']:.4f}, moved "
          f"{sorted(res['moved'])}", flush=True)
    _print_profile("bd-dot-train", res["profile"])
    return {"launches": res["launches"], "train_step_ms": step_ms, "peak_gb": res["peak_gb"]}


# ------------------------------------------------- training infrastructure

REPO = os.path.dirname(os.path.abspath(__file__))
FIT_STEPS = 4  # fit-resume: the uninterrupted run; the resumed one starts at step 2
# the flagship BD config on synthetic 512x384 tuples at the config's b=12:
# 24 tuples, two batches an epoch; one validation batch of 4 every 2 steps
FIT_FLAGS = ["--config_file", "configs/models/implicit_depth.yaml",
             "--data_config_file", "configs/data/synthetic_smoke.yaml",
             "--image_height", "384", "--image_width", "512", "--model_num_views", "8",
             "--matching_num_depth_bins", "64", "--num_rays", "4096", "--samples_per_ray", "64",
             "--batch_size", "12", "--val_batch_size", "4", "--val_batches", "1",
             "--val_interval", "2", "--log_interval", "1", "--synthetic_num_frames", "31",
             "--num_workers", "8", "--lazy_load_weights_from_checkpoint", ""]
SAVE_ROUNDS = 3
# Two runs of the same bf16 steps from the same state differ on the card: its
# backward sums in no fixed order (atomics), and AdamW's normalised update
# amplifies the difference where a gradient is small (e.g. a batch-norm
# shift before a residual sum): on an H100 two resumed runs' updates of
# steps 3-4 differed by 7.6e-2 relative L2 and 1.4 in the worst parameter,
# far past the f32 MODEL_* bounds. The resumed run is held to that spread,
# measured in the same run, times RESUME_SPREAD.
RESUME_SPREAD = 3.0
# The loss of step 4, one scalar, is a poor measure of that spread: over
# four pairs of such runs on an H100 it moved by 2.6e-5 to 2.7e-4 relative.
# It is held to RESUME_LOSS_REL instead.
RESUME_LOSS_REL = 1e-3


def _repo_paths(args) -> list:
    return [os.path.join(REPO, a) if a.startswith("configs/") else a for a in args]


def _flagship_cfg(*extra):
    from implicit_depth_tpu_torch.config import parse_config

    return parse_config(_repo_paths(FIT_FLAGS) + list(extra))[0]


def _batch_digest(batch) -> str:
    h = hashlib.sha256()
    for part in batch:
        for k in sorted(part):
            if k != "frame_id_string":
                h.update(np.ascontiguousarray(part[k]).tobytes())
    return h.hexdigest()


def _tree_diff(a, b, path: str = "") -> str:
    """'' when two nested state_dicts are equal, tensors bit for bit; else
    the first path that differs."""
    if isinstance(a, torch.Tensor):
        same = isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b.to(a.device))
        return "" if same else path
    if isinstance(a, dict):
        if set(a) != set(b):
            return f"{path} (keys)"
        return next((d for k in a if (d := _tree_diff(a[k], b[k], f"{path}/{k}"))), "")
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return f"{path} (length)"
        return next((d for i, (x, y) in enumerate(zip(a, b))
                     if (d := _tree_diff(x, y, f"{path}/{i}"))), "")
    return "" if a == b else path


def phase_fit_resume() -> dict:
    """fit on the card, 4 steps of the flagship BD config at b=12 (flip
    pinned), then a run resumed from its step-2 checkpoint to step 4: the
    same batches, the restored state bit-equal to the saved one, the
    checkpoints' layout, and the two runs' steps 3-4 and parameters within
    the MODEL_* bounds; then the step time with and without an async save
    in it, and the save's time on the caller thread."""
    import shutil
    import tempfile

    from implicit_depth_tpu_torch.data.mvs_dataset import collate
    from implicit_depth_tpu_torch.train import checkpoint as ckpt_lib
    from implicit_depth_tpu_torch.train import state
    from implicit_depth_tpu_torch.train.loop import batch_to_device, build_dataset, build_net, fit

    tmp = tempfile.mkdtemp(prefix="fit_resume_")
    try:
        full_ckpts = os.path.join(tmp, "full", "checkpoints")
        runs, launches = {}, {}
        resume = ("--resume", os.path.join(full_ckpts, "ckpt_00000002"))
        expected = {"full": (FIT_STEPS + 2, FIT_STEPS, 4 * FIT_STEPS, 4 * FIT_STEPS, 0, 0),
                    "resumed": (2 + 1, 2, 8, 8, 0, 0),  # steps + validations for #1
                    "again": (2 + 1, 2, 8, 8, 0, 0)}
        for name, extra in (("full", ()), ("resumed", resume), ("again", resume)):
            cfg = _flagship_cfg("--log_dir", tmp, "--name", name, *extra)
            digests, losses = {}, {}

            def on_batch(step, batch, digests=digests):
                digests[step] = _batch_digest(batch)

            def on_log(step, scalars, losses=losses):
                if "train/loss" in scalars:
                    losses[step] = scalars["train/loss"]

            reset_launch_counts()
            t0 = time.perf_counter()
            res = fit(cfg, "bd", device="cuda", max_steps=FIT_STEPS, log_cb=on_log,
                      batch_cb=on_batch, train_flip=False)
            wall = time.perf_counter() - t0
            launches[name] = launch_counts()
            if launches[name] != expected[name]:
                raise AssertionError(f"fit-resume {name}: launches #1-#6 {launches[name]}, "
                                     f"expected {expected[name]}")
            runs[name] = dict(res=res, digests=digests, losses=losses, wall=wall)
            torch.cuda.empty_cache()
        full, resumed = runs["full"], runs["resumed"]

        if sorted(resumed["digests"]) != [3, 4] or any(
                resumed["digests"][s] != full["digests"][s] for s in (3, 4)):
            raise AssertionError("fit-resume: the resumed run took other batches at steps 3-4")
        layout = sorted(os.listdir(full_ckpts))
        metas = [ckpt_lib.load_meta(os.path.join(full_ckpts, d))["step"] for d in layout[:2]]
        if (layout != ["ckpt_00000002", "ckpt_00000004", "last"] or metas != [2, 4]
                or os.readlink(os.path.join(full_ckpts, "last")) != "ckpt_00000004"
                or not os.path.exists(os.path.join(tmp, "full", "metrics.jsonl"))):
            raise AssertionError(f"fit-resume: checkpoint layout {layout}, steps {metas}")

        # the restored model, optimizer and scheduler equal what was saved
        ck2 = os.path.join(full_ckpts, "ckpt_00000002")
        net = build_net(_flagship_cfg()).cuda()
        opt, sched = state.make_optimizer(net.parameters(), 1e-4, 1e-4, (18000, 36000))
        step = ckpt_lib.restore_state(ck2, net, opt, sched)
        saved = torch.load(os.path.join(ck2, "state.pt"), map_location="cpu", weights_only=True)
        diff = _tree_diff(saved, ckpt_lib.snapshot(net, opt, sched, step))
        if step != 2 or diff:
            raise AssertionError(f"fit-resume: the restored state differs at {diff or 'step'}")
        params = [n for n, _ in net.named_parameters()]
        del net, opt, sched
        torch.cuda.empty_cache()

        # step 3 starts from the restored state: its forward is the
        # uninterrupted run's. From its backward on, the card's sums in no
        # fixed order (atomics) part the runs: the parameter updates are held
        # to the spread of two resumed runs ("again") times RESUME_SPREAD
        again = runs["again"]
        loss3_rel = abs(resumed["losses"][3] - full["losses"][3]) / abs(full["losses"][3])
        loss4 = [abs(a["losses"][4] - b["losses"][4]) / abs(b["losses"][4])
                 for a, b in ((resumed, full), (again, resumed))]
        finals = {k: torch.load(os.path.join(r["res"]["checkpoint"], "state.pt"),
                                map_location="cpu", weights_only=True)["model"]
                  for k, r in runs.items()}
        final_l2, _ = _grad_agreement({n: finals["resumed"][n] for n in params},
                                      {n: finals["full"][n] for n in params})
        moved = {k: {n: finals[k][n] - saved["model"][n] for n in params} for k in finals}
        upd = _grad_agreement(moved["resumed"], moved["full"])
        spread = _grad_agreement(moved["again"], moved["resumed"])
        print(f"fit-resume: fit of the flagship BDNet (implicit_depth.yaml, bf16, b=12, "
              f"synthetic 512x384, flip pinned): {FIT_STEPS} steps in {full['wall']:.1f} s, "
              f"launches #1-#6 {launches['full']}; resumed from ckpt_00000002 to step "
              f"{resumed['res']['step']} in {resumed['wall']:.1f} s, launches "
              f"{launches['resumed']}, and again; batches of steps 3-4 identical (sha256); "
              f"restored model, optimizer and scheduler bit-equal to state.pt; layout {layout}; "
              f"step-3 loss relative {loss3_rel:.2e} (bound {MODEL_LOSS_REL}); final parameters "
              f"relative L2 {final_l2:.2e} (bound {MODEL_GRAD_L2}); resumed vs uninterrupted / "
              f"the two resumed runs: step-4 loss relative {loss4[0]:.2e} / {loss4[1]:.2e} (bound "
              f"{RESUME_LOSS_REL} for both), parameter updates "
              f"of steps 3-4 relative L2 {upd[0]:.2e} / {spread[0]:.2e}, worst parameter "
              f"{upd[1][0]:.2e} ({upd[1][1]}) / {spread[1][0]:.2e} ({spread[1][1]}) (bound: "
              f"{RESUME_SPREAD}x the second, at least the MODEL_* bound)", flush=True)
        if not (loss3_rel <= MODEL_LOSS_REL and final_l2 <= MODEL_GRAD_L2
                and max(loss4) <= RESUME_LOSS_REL
                and upd[0] <= max(MODEL_GRAD_L2, RESUME_SPREAD * spread[0])
                and upd[1][0] <= max(MODEL_GRAD_LEAF, RESUME_SPREAD * spread[1][0])):
            raise AssertionError("fit-resume: the resumed run disagrees with the uninterrupted one")

        # the step with and without an async save in it
        cfg = _flagship_cfg()
        ds = build_dataset(cfg, "train")
        batch = batch_to_device(collate([ds[i] for i in range(cfg.batch_size)]),
                                torch.device("cuda"))
        net = flagship_net(torch.bfloat16).cuda()
        opt, sched = state.make_optimizer(net.parameters(), 1e-4, 1e-4)
        train_step = state.make_bd_train_step(net, opt, sched,
                                              generator=torch.Generator().manual_seed(0))
        mgr = ckpt_lib.CheckpointManager(os.path.join(tmp, "timing"), monitor="m", mode="max",
                                         async_write=True)
        plain, with_save, caller, written = [], [], [], []
        for i in range(2 + SAVE_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(batch)
            torch.cuda.synchronize()
            if i >= 2:
                plain.append((time.perf_counter() - t0) * 1e3)
        for i in range(SAVE_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(net, opt, sched, step=i, metrics={"m": float(i)})
            t1 = time.perf_counter()
            train_step(batch)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            mgr.wait()
            t3 = time.perf_counter()
            caller.append((t1 - t0) * 1e3)
            with_save.append((t2 - t0) * 1e3)
            written.append((t3 - t0) * 1e3)
        nbytes_state = os.path.getsize(os.path.join(mgr.best_path(), "state.pt"))
        out = {"step_ms": float(np.median(plain)), "step_with_save_ms": float(np.median(with_save)),
               "save_caller_ms": float(np.median(caller)),
               "save_written_ms": float(np.median(written)), "state_bytes": nbytes_state,
               "launches": tuple(a + b for a, b in zip(launches["full"], launches["resumed"]))}
        print(f"fit-resume: flagship train step at b=12 {out['step_ms']:.1f} ms without a save "
              f"(median of {SAVE_ROUNDS}; {', '.join(f'{t:.1f}' for t in plain)}), "
              f"{out['step_with_save_ms']:.1f} ms with an async CheckpointManager.save at its "
              f"start ({', '.join(f'{t:.1f}' for t in with_save)}); the save on the caller "
              f"thread (host copies of parameters, BN statistics, AdamW moments) "
              f"{out['save_caller_ms']:.1f} ms ({', '.join(f'{t:.1f}' for t in caller)}), "
              f"written {out['save_written_ms']:.1f} ms after the save began "
              f"(state.pt {nbytes_state / 2**20:.1f} MiB)", flush=True)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


DDP_WORLD, DDP_TIMED_STEPS = 2, 4


def _ddp_batch():
    """The b=12 batch of the ddp-train phase (numpy), the same in every
    process: the first 12 training tuples of a fresh synthetic dataset."""
    from implicit_depth_tpu_torch.data.mvs_dataset import BDSamplingConfig, collate
    from implicit_depth_tpu_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset(num_frames=12 + 7, num_views=8, image_height=384, image_width=512,
                          split="train", get_bd_info=True,
                          bd_config=BDSamplingConfig(num_rays=4096, samples_per_ray=64))
    return collate([ds[i] for i in range(12)])


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_procs(cmds: list, timeout_s: int, env=None) -> list:
    """Runs the commands at once from the repository root; kills them all
    when one outlives timeout_s; raises unless all exit 0. Returns their
    standard outputs."""
    env = dict(os.environ if env is None else env, PYTHONPATH=REPO)
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"a process outlived {timeout_s} s: {cmds}")
    for c, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"{c[:4]}... exited {p.returncode}:\n{out[-2000:]}\n{err[-4000:]}")
    return [o for o, _ in outs]


def ddp_rank_main(rank: int, world: int, port: int, out_dir: str) -> None:
    """One rank of ddp-train (chip_smoke.py --ddp-rank ...): the flagship
    step on rows [6 rank, 6 rank + 6) of the b=12 batch, on the one card,
    gloo: one f32 step from the initial weights with the flip off and one
    with it on (rank 0 saves the averaged gradients), then DDP_TIMED_STEPS
    timed bf16 steps (the config's precision); its losses, launches, step
    times and peak memory to rank{rank}.json."""
    import torch.distributed as dist

    from implicit_depth_tpu_torch.parallel import distributed
    from implicit_depth_tpu_torch.train import state

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo", device="cuda")
    dev = distributed.local_device("cuda")
    cur, src = ({k: distributed.rank_rows(torch.as_tensor(v)).to(dev) for k, v in d.items()
                 if k != "frame_id_string"} for d in _ddp_batch())
    result = {"backend": dist.get_backend(), "rows": int(cur["image"].shape[0])}
    for flip in (False, True):
        net = flagship_net(torch.float32).to(dev)
        opt, sched = state.make_optimizer(net.parameters(), lr=1e-4, wd=1e-4)
        step = state.make_bd_train_step(net, opt, sched, generator=torch.Generator().manual_seed(0))
        reset_launch_counts()
        losses = step((cur, src), flip=flip)
        result[f"flip{int(flip)}"] = {"losses": {k: float(v) for k, v in losses.items()},
                                      "launches": launch_counts()}
        if rank == 0:
            torch.save({n: p.grad.detach().cpu() for n, p in net.named_parameters()
                        if p.grad is not None}, os.path.join(out_dir, f"grads_flip{int(flip)}.pt"))
        del net, opt, sched, step
    net = flagship_net(torch.bfloat16).to(dev)
    opt, sched = state.make_optimizer(net.parameters(), lr=1e-4, wd=1e-4)
    step = state.make_bd_train_step(net, opt, sched, generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times = []
    for _ in range(DDP_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step((cur, src))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    result.update(times=times, launches=launch_counts(),
                  peak_gb=torch.cuda.max_memory_allocated() / 2**30)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    distributed.shutdown()


_NCCL_FIT = r"""
import sys
import torch
import torch.distributed as dist
from implicit_depth_tpu_torch.config import parse_config
from implicit_depth_tpu_torch.train.loop import fit
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
cfg, device = parse_config(sys.argv[1:])
res = fit(cfg, "bd", device=device)
x = torch.ones(1, device="cuda")
dist.all_reduce(x)  # the communicator of the nccl group, made at its first collective
print("nccl-fit", dist.get_backend(), dist.get_world_size(), res["step"], float(x),
      res["checkpoint"] is not None)
dist.destroy_process_group()
"""


def phase_ddp_train() -> dict:
    """The two-rank step on the one card (gloo) against the one-process
    b=12 step on the same batch, flip off and on, in f32 (the MODEL_*
    bounds are f32 bounds: in bf16 the two differ by rounding in other
    orders, ~1e-3 in the loss); each rank's bf16 step time and peak memory;
    then fit --jax_distributed as one nccl process."""
    import shutil
    import tempfile

    from implicit_depth_tpu_torch.train import state

    batch = tuple({k: torch.as_tensor(v).cuda() for k, v in d.items() if k != "frame_id_string"}
                  for d in _ddp_batch())
    ref = {}
    for flip in (False, True):
        net = flagship_net(torch.float32).cuda()
        opt, sched = state.make_optimizer(net.parameters(), lr=1e-4, wd=1e-4)
        step = state.make_bd_train_step(net, opt, sched, generator=torch.Generator().manual_seed(0))
        losses = step(batch, flip=flip)
        ref[flip] = ({k: float(v) for k, v in losses.items()},
                     {n: p.grad.detach().cpu() for n, p in net.named_parameters()
                      if p.grad is not None})
        del net, opt, sched, step
    del batch
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="ddp_train_")
    try:
        port = _free_port()
        _run_procs([[sys.executable, os.path.abspath(__file__), "--ddp-rank", str(r),
                     "--ddp-world", str(DDP_WORLD), "--ddp-port", str(port), "--ddp-out", tmp]
                    for r in range(DDP_WORLD)], timeout_s=600)
        ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(DDP_WORLD)]
        lines = []
        for flip in (False, True):
            key = f"flip{int(flip)}"
            if ranks[0][key]["losses"] != ranks[1][key]["losses"]:
                raise AssertionError(f"ddp-train: the ranks' losses differ ({key})")
            for r in ranks:
                if tuple(r[key]["launches"]) != (1, 1, 4, 4, 0, 0):
                    raise AssertionError(f"ddp-train: launches #1-#6 {r[key]['launches']} in one "
                                         "step of a rank, expected (1, 1, 4, 4, 0, 0)")
            ref_losses, ref_grads = ref[flip]
            loss_rel = max(abs(ranks[0][key]["losses"][k] - v) / abs(v)
                           for k, v in ref_losses.items() if v != 0)
            grads = torch.load(os.path.join(tmp, f"grads_{key}.pt"), weights_only=True)
            grad_l2, leaf = _grad_agreement(grads, ref_grads)
            lines.append(f"flip {'on' if flip else 'off'}: loss {ranks[0][key]['losses']['loss']:.6f} "
                         f"vs {ref_losses['loss']:.6f}, worst loss relative {loss_rel:.2e} (bound "
                         f"{MODEL_LOSS_REL}), gradients relative L2 {grad_l2:.2e} (bound "
                         f"{MODEL_GRAD_L2}), worst parameter {leaf[1]} {leaf[0]:.2e} (bound "
                         f"{MODEL_GRAD_LEAF})")
            if not (loss_rel <= MODEL_LOSS_REL and grad_l2 <= MODEL_GRAD_L2
                    and leaf[0] <= MODEL_GRAD_LEAF):
                raise AssertionError("ddp-train: the two-rank step disagrees with the one-process "
                                     "step: " + lines[-1])
        n = DDP_TIMED_STEPS
        for r in ranks:
            if tuple(r["launches"]) != (n, n, 4 * n, 4 * n, 0, 0):
                raise AssertionError(f"ddp-train: launches #1-#6 {r['launches']} over {n} steps")
        print(f"ddp-train: {DDP_WORLD} ranks on the one card, backend {ranks[0]['backend']} "
              f"(passed explicitly: nccl refuses two ranks on one card), {ranks[0]['rows']} rows "
              f"each of the b=12 flagship batch, one f32 step against the one-process f32 b=12 "
              f"step: " + "; ".join(lines), flush=True)
        for r, res in enumerate(ranks):
            print(f"ddp-train: rank {r}: bf16 step {np.median(res['times'][1:]):.1f} ms (median of "
                  f"steps 2-{n}; all {', '.join(f'{t:.1f}' for t in res['times'])}), peak device "
                  f"memory {res['peak_gb']:.2f} GiB, launches #1-#6 over {n} steps "
                  f"{tuple(res['launches'])}", flush=True)

        port = _free_port()
        out = _run_procs([[sys.executable, "-c", _NCCL_FIT] + _repo_paths(FIT_FLAGS) + [
            "--max_steps", "1", "--val_interval", "1", "--synthetic_num_frames", "19",
            "--log_dir", tmp, "--name", "nccl",
            "--jax_distributed", "--coordinator_address", f"127.0.0.1:{port}",
            "--distributed_num_processes", "1", "--distributed_process_id", "0"]],
            timeout_s=600)[0]
        line = [ln for ln in out.splitlines() if ln.startswith("nccl-fit ")]
        if not line or line[0].split()[1:] != ["nccl", "1", "1", "1.0", "True"]:
            raise AssertionError(f"ddp-train: fit --jax_distributed over nccl: {out[-2000:]}")
        print("ddp-train: fit --jax_distributed as one process over nccl (world size 1): 1 step, "
              "1 validation, 1 checkpoint, and one nccl all-reduce", flush=True)
        return {"launches": tuple(ranks[0]["launches"]),
                "step_ms": [float(np.median(r["times"][1:])) for r in ranks],
                "peak_gb": [r["peak_gb"] for r in ranks]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


TEST_BD_FLAGS = ["--config_file", "configs/models/implicit_depth.yaml",
                 "--data_config_file", "configs/data/synthetic_smoke.yaml", "--split", "test",
                 "--image_height", "384", "--image_width", "512", "--model_num_views", "8",
                 "--matching_num_depth_bins", "64", "--val_batch_size", "1", "--max_frames", "2"]
TEMPORAL_FLAGS = ["--config_file", "configs/models/implicit_depth_temporal.yaml",
                  "--data_config_file", "configs/data/synthetic_temporal.yaml",
                  "--temporal_eval", "--max_frames", "5"]


def _test_bd_ranks(flags: list, out_dir: str) -> list:
    port = _free_port()
    return _run_procs([[sys.executable, "-m", "implicit_depth_tpu_torch.cli.test_bd"] + flags + [
        "--output_base_path", out_dir, "--jax_distributed", "--coordinator_address",
        f"127.0.0.1:{port}", "--distributed_num_processes", str(DDP_WORLD),
        "--distributed_process_id", str(r)] for r in range(DDP_WORLD)], timeout_s=600)


def phase_test_bd_ranks() -> dict:
    """cli/test_bd.py --jax_distributed, two processes on the card, over 4
    synthetic scenes: rank 0's merged all_scenes_metrics.json against a
    one-process run's; then the temporal merge on 2 scenes."""
    import shutil
    import tempfile

    from implicit_depth_tpu_torch.cli import test_bd

    tmp = tempfile.mkdtemp(prefix="test_bd_ranks_")
    try:
        with open(os.path.join(tmp, "scans4.txt"), "w") as f:
            f.write("sA\nsB\nsC\nsD\n")
        with open(os.path.join(tmp, "scans2.txt"), "w") as f:
            f.write("sA\nsB\n")
        weights = {}
        for name, prior in (("bd", False), ("temporal", True)):
            weights[name] = os.path.join(tmp, f"{name}.pt")
            torch.save(flagship_net(torch.float32, use_prior=prior).state_dict(), weights[name])

        flags = _repo_paths(TEST_BD_FLAGS) + [
            "--dataset_scan_split_file", os.path.join(tmp, "scans4.txt"),
            "--load_weights_from_checkpoint", weights["bd"]]
        t0 = time.perf_counter()
        test_bd.main(flags + ["--output_base_path", os.path.join(tmp, "one")])
        one_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        outs = _test_bd_ranks(flags, os.path.join(tmp, "ranks"))
        ranks_s = time.perf_counter() - t0
        scores = os.path.join(tmp, "ranks", "implicit_depth", "scores")
        files = sorted(os.listdir(scores))
        got = json.load(open(os.path.join(scores, "all_scenes_metrics.json")))["scores"]
        ref = json.load(open(os.path.join(tmp, "one", "implicit_depth", "scores",
                                          "all_scenes_metrics.json")))["scores"]
        keys = [k for k in ref if k != "model_time"]  # a wall time, not a score
        g, r = np.array([got.get(k, np.nan) for k in keys]), np.array([ref[k] for k in keys])
        finite = np.isfinite(r)
        worst = float(np.max(np.abs(g[finite] - r[finite]) / np.maximum(np.abs(r[finite]), 1e-12)))
        if (sorted(got) != sorted(ref) or (np.isnan(g) != np.isnan(r)).any() or worst > 1e-6
                or files != ["all_scenes_metrics.json"] + [f"s{c}_metrics.json" for c in "ABCD"]
                or "model_time" not in outs[0] or "model_time" in outs[1]):
            raise AssertionError(f"test-bd-ranks: the merge of 2 ranks differs from one process: "
                                 f"worst relative {worst:.2e}, files {files}")
        print(f"test-bd-ranks: cli/test_bd.py --jax_distributed, {DDP_WORLD} processes on the "
              f"card (flagship BDNet, bf16, 512x384), 4 synthetic scenes of 2 frames, scenes "
              f"[r::2] per rank: rank 0's merged all_scenes_metrics.json vs one process: "
              f"{len(keys)} scores, worst relative {worst:.2e} (bound 1e-6), iou_d_3.0 "
              f"{got['iou_d_3.0']:.4f}; {ranks_s:.1f} s with 2 processes, {one_s:.1f} s in one",
              flush=True)

        tflags = _repo_paths(TEMPORAL_FLAGS) + [
            "--dataset_scan_split_file", os.path.join(tmp, "scans2.txt"),
            "--load_weights_from_checkpoint", weights["temporal"]]
        one = test_bd.main(tflags + ["--output_base_path", os.path.join(tmp, "one")])
        torch.cuda.empty_cache()
        outs = _test_bd_ranks(tflags, os.path.join(tmp, "ranks"))
        tdir = os.path.join(tmp, "ranks", "implicit_depth_temporal", "temporal")
        parts = [json.load(open(os.path.join(tdir, f"rank{r}.json"))) for r in range(DDP_WORLD)]
        from implicit_depth_tpu_torch.config import parse_config

        cfg = parse_config(_repo_paths(TEMPORAL_FLAGS))[0]
        denom = ((cfg.eval_length - cfg.warmup) * cfg.eval_frame_multiplier
                 * sum(p["n_scenes"] for p in parts))
        merged = sum(p["total_diffs"] for p in parts) / max(denom, 1)
        rel = abs(merged - one["temporal_score"]) / max(abs(one["temporal_score"]), 1e-12)
        printed = [ln for ln in outs[0].splitlines() if ln.startswith("global temporal_score:")]
        if rel > 1e-6 or len(printed) != 1 or [p["n_scenes"] for p in parts] != [1, 1]:
            raise AssertionError(f"test-bd-ranks: temporal merge {merged} vs one process "
                                 f"{one['temporal_score']}, printed {printed}")
        print(f"test-bd-ranks: temporal merge, 2 scenes of 5 frames (temporal BDNet, bf16): "
              f"{printed[0]}; one process {one['temporal_score']:.6f} ({one['total_diffs']:.0f} "
              f"flips), merged {merged:.6f}, relative {rel:.2e} (bound 1e-6)", flush=True)
        return {"worst_rel": worst, "temporal_rel": rel}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


AR_FRAMES = 10  # frames of the ar-inference CLI run (--max_frames)
# cli/inference.py on the flagship temporal BDNet: synthetic_temporal.yaml
# (512x384, val split, 8 views), one more frame than its 16 so that the 8-view
# tuples give AR_FRAMES frames
AR_FLAGS = ["--config_file", "configs/models/implicit_depth_temporal.yaml",
            "--data_config_file", "configs/data/synthetic_temporal.yaml",
            "--synthetic_num_frames", str(AR_FRAMES + 7), "--max_frames", str(AR_FRAMES)]
AR_VIRTUAL_DEPTH = 2.0  # the virtual asset's plane, as the reference's default
# GPU (kernel #1) against CPU (its plain version) over chained frames, f32:
# the logits agree to f32 sums in another order, but each frame's prior is
# the previous matte sampled nearest through the rendered depth, and a pixel
# whose sample point lies within rounding of a texel edge takes the
# neighbouring texel on one device and not on the other (tests/
# test_torch_prior.py: up to 1e-3 of the pixels of one warp). So the bound is
# a share of the matte pixels within AR_ATOL, as DEPTH_SHARE in
# bd-depth-model.
AR_ATOL, AR_SHARE = 1e-4, 0.99
AR_COMPOSITE_ATOL = 1e-6


def write_rendered_depths(root: str, frame_ids, h: int, w: int, seed: int = 0) -> str:
    """The virtual asset's depth for run_inference, <frame id>.npy per frame:
    a plane at AR_VIRTUAL_DEPTH with holes of zeros, scattered pixels (which
    the 7x7 max pool fills) and an h/4 x w/4 block whose middle stays empty."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for fid in frame_ids:
        depth = np.full((h, w), AR_VIRTUAL_DEPTH, np.float32)
        depth[rng.rand(h, w) < 0.03] = 0.0
        depth[h // 8: h // 8 + h // 4, w // 2: w // 2 + w // 4] = 0.0
        np.save(os.path.join(root, f"{fid}.npy"), depth)
    return root


def ar_gpu_vs_cpu(net, ds, renders: str, out_dir: str, frames: int) -> dict:
    """run_inference with the prior over `frames` chained frames of `ds`, on
    the CPU (plain versions) and then on the card (kernel #1) with the same
    net: the share of matte pixels within AR_ATOL, the largest difference,
    and #1's launches on the card."""
    from implicit_depth_tpu_torch.apps.inference import run_inference
    from implicit_depth_tpu_torch.ops.fused_volume import fused_metadata_volume

    kw = dict(rendered_depth_load_dir=renders, use_prior=True, max_frames=frames)
    ref = [np.load(p) for p in run_inference(net.cpu(), ds, os.path.join(out_dir, "cpu"), **kw)]
    before = fused_metadata_volume.launches
    got = [np.load(p) for p in run_inference(net.cuda(), ds, os.path.join(out_dir, "gpu"), **kw)]
    diff = np.abs(np.stack(got) - np.stack(ref))
    return {"share": float((diff <= AR_ATOL).mean()), "max_abs_err": float(diff.max()),
            "frame_shares": [float((d <= AR_ATOL).mean()) for d in diff],
            "launches": fused_metadata_volume.launches - before}


def _host_libraries() -> str:
    import importlib

    found = []
    for name in ("PIL", "cv2", "h5py", "pandas"):
        try:
            importlib.import_module(name)
            found.append(f"{name} yes")
        except ImportError:
            found.append(f"{name} no")
    return ", ".join(found)


def phase_ar_inference(card: str) -> dict:
    """cli/inference.py (the AR demo's matting) with the flagship temporal
    BDNet (bf16, seeded weights saved as a port weights file) over 10
    synthetic 512x384 frames with rendered depths and the prior fed back;
    then, on frames rendered beforehand, run_inference with and without the
    prior, one forward timed, the GPU against the CPU at 128x192 in f32, and
    each matte composited in numpy."""
    import shutil
    import tempfile

    from implicit_depth_tpu_torch.apps.composite import DEFAULT_VIRTUAL_RGB, composite_frame
    from implicit_depth_tpu_torch.apps.inference import load_rendered_depth, run_inference
    from implicit_depth_tpu_torch.cli import inference as cli_inference
    from implicit_depth_tpu_torch.cli.test_bd import load_bd_net
    from implicit_depth_tpu_torch.config import parse_config
    from implicit_depth_tpu_torch.data.mvs_dataset import collate, reverse_imagenet_normalize
    from implicit_depth_tpu_torch.data.synthetic import SyntheticDataset
    from implicit_depth_tpu_torch.train.loop import build_dataset

    print(f"ar-inference: host libraries of the AR path's image and capture I/O: "
          f"{_host_libraries()}", flush=True)
    tmp = tempfile.mkdtemp(prefix="ar_inference_")
    try:
        weights = os.path.join(tmp, "temporal.pt")
        torch.save(flagship_net(torch.float32, use_prior=True).state_dict(), weights)
        renders = os.path.join(tmp, "renders")
        flags = _repo_paths(AR_FLAGS) + ["--load_weights_from_checkpoint", weights,
                                         "--rendered_depth_map_load_dir", renders,
                                         "--output_base_path", os.path.join(tmp, "out")]
        cfg = parse_config(flags)[0]
        ds = build_dataset(cfg, cfg.split, "bd", pass_frame_id=True)
        ids = [t.split(" ")[1] for t in ds.frame_tuples[:AR_FRAMES]]
        write_rendered_depths(renders, ids, ds.depth_height, ds.depth_width)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = cli_inference.main(flags)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        counts = launch_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        names = [os.path.basename(p) for p in res["saved"]]
        expected = (AR_FRAMES, 0, 0, 0, 0, 0)
        if names != [f"{int(i):05d}.npy" for i in ids] or counts != expected:
            raise AssertionError(f"ar-inference: mattes {names} for frames {ids}, kernel launches "
                                 f"#1-#6 {counts}, expected {expected}")
        mattes = [np.load(p) for p in res["saved"]]
        for m in mattes:
            if m.shape != (ds.depth_height, ds.depth_width) or not np.isfinite(m).all() or \
                    m.min() < 0.0 or m.max() > 1.0:
                raise AssertionError(f"ar-inference: a matte of shape {m.shape}, range "
                                     f"[{np.nanmin(m)}, {np.nanmax(m)}]")
        frame_ms = np.asarray(res["frame_ms"])

        # the same frames rendered beforehand (the synthetic renderer is no
        # capture's cost): with and without the prior on the CLI's weights
        for i in range(ds.num_frames):
            ds.get_frame("scene0", str(i))
        net = load_bd_net(cfg, "cuda")
        kw = dict(rendered_depth_load_dir=renders, sigmoid_multiplier=cfg.bd_sigmoid_multiplier,
                  max_frames=AR_FRAMES)
        pre_ms: list = []
        prior = [np.load(p) for p in run_inference(net, ds, os.path.join(tmp, "prior"),
                                                   use_prior=True, frame_ms=pre_ms, **kw)]
        plain = [np.load(p) for p in run_inference(net, ds, os.path.join(tmp, "noprior"), **kw)]
        item_ms = []  # the dataset item and collate of a frame, on the host
        for i in range(1, AR_FRAMES):
            t0 = time.perf_counter()
            collate([ds[i]])
            item_ms.append((time.perf_counter() - t0) * 1e3)
        effect = [float(np.abs(a - b).max()) for a, b in zip(prior, plain)]
        same_as_cli = max(float(np.abs(a - b).max()) for a, b in zip(prior, mattes))
        if min(effect[1:]) <= 1e-3:
            raise AssertionError(f"ar-inference: the prior did not change the mattes of frames "
                                 f"2-{AR_FRAMES}: max differences {effect}")

        # one forward of frame 2 with frame 1's matte as its prior
        cur, src = ({k: torch.as_tensor(v).cuda() for k, v in d.items() if k != "frame_id_string"}
                    for d in collate([ds[1]]))
        cur["rendered_depth"] = torch.from_numpy(load_rendered_depth(
            renders, ids[1], ds.depth_height, ds.depth_width))[None].cuda()
        cur["prior_prediction"] = torch.from_numpy(prior[0])[None, ..., None].cuda()
        cur["prior_cam_T_world"] = torch.as_tensor(collate([ds[0]])[0]["cam_T_world"]).cuda()
        fwd_ms = []
        with torch.inference_mode():
            for _ in range(12):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = net.forward_val(cur, src)
                torch.sigmoid(out["pred_0"].float()).cpu()
                fwd_ms.append((time.perf_counter() - t0) * 1e3)
        forward_ms = float(np.median(fwd_ms[2:]))
        del net, cur, src, out
        torch.cuda.empty_cache()

        # GPU against CPU, f32, 128x192, 3 chained frames
        small = SyntheticDataset(num_frames=3 + 7, num_views=8, image_height=128, image_width=192,
                                 split="val", get_bd_info=True, pass_frame_id=True)
        small_ids = [t.split(" ")[1] for t in small.frame_tuples[:3]]
        small_renders = write_rendered_depths(os.path.join(tmp, "small_renders"), small_ids,
                                              small.depth_height, small.depth_width, seed=1)
        model = ar_gpu_vs_cpu(flagship_net(torch.float32, use_prior=True), small, small_renders,
                              os.path.join(tmp, "small"), 3)
        if model["share"] < AR_SHARE or model["launches"] != 3:
            raise AssertionError(f"ar-inference: GPU vs CPU chained mattes: {model}")

        # each matte composited in mask mode against the 2 m virtual layer
        layer = np.empty((ds.depth_height, ds.depth_width, 4), np.float32)
        layer[..., :3] = DEFAULT_VIRTUAL_RGB
        layer[..., 3] = 1.0
        worst = 0.0
        for i, m in enumerate(mattes):
            image = np.clip(reverse_imagenet_normalize(ds[i][0]["image"][::2, ::2]), 0.0, 1.0)
            out = composite_frame(image, layer, mode="mask", occlusion_matte=m)
            ref = image * m[..., None] + layer[..., :3] * (1.0 - m[..., None])
            worst = max(worst, float(np.abs(out - ref).max()))
        if worst > AR_COMPOSITE_ATOL:
            raise AssertionError(f"ar-inference: composite differs from image*m + layer*(1-m) "
                                 f"by {worst:.3e}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    ar_frame_ms = float(np.median(frame_ms[1:]))
    pre_frame_ms = float(np.median(pre_ms[1:]))
    occluded = float(np.mean([(m > 0.5).mean() for m in mattes]))
    print(f"ar-inference: cli/inference.py, flagship temporal BDNet (EfficientNetV2-S, K=7, D=64, "
          f"prior, bf16, seeded random weights), {AR_FRAMES} synthetic 512x384 frames, rendered "
          f"depths with holes, the prior fed back on the card: launches #1-#6 {counts}; mattes "
          f"{ds.depth_width}x{ds.depth_height} in [0, 1], share > 0.5 {occluded:.3f}; the prior "
          f"moves frames 2-{AR_FRAMES} by {min(effect[1:]):.3f}-{max(effect[1:]):.3f} (frame 1: "
          f"{effect[0]:.1e}); the run on frames rendered beforehand within {same_as_cli:.1e} of "
          f"the CLI's", flush=True)
    print(f"ar-inference: ar_frame_ms {ar_frame_ms:.2f} (median of frames 2-{AR_FRAMES}, wall time "
          f"to the matte's readback, the synthetic renderer's ~2 renders a new frame included; "
          f"all {', '.join(f'{t:.1f}' for t in frame_ms)}); {pre_frame_ms:.2f} ms on frames "
          f"rendered beforehand; forward_val + sigmoid + readback {forward_ms:.2f} ms (median, "
          f"synchronised): {forward_ms / ar_frame_ms:.1%} of ar_frame_ms, "
          f"{forward_ms / pre_frame_ms:.1%} of the pre-rendered frame, whose dataset item and "
          f"collate take {np.median(item_ms):.2f} ms (host, median); peak device memory "
          f"{peak_gib:.2f} GiB; CLI wall time {cli_s:.1f} s; on {card}", flush=True)
    print(f"ar-inference: GPU (kernel) vs CPU (plain), f32 flagship-width temporal BDNet at "
          f"128x192, 3 chained frames: {model['share']:.4%} of the matte pixels within {AR_ATOL} "
          f"(bound {AR_SHARE:.0%}; per frame {', '.join(f'{x:.4%}' for x in model['frame_shares'])}"
          f"), max abs err {model['max_abs_err']:.3e}; composite in mask mode against the 2 m "
          f"layer within {worst:.1e} of image*m + layer*(1-m) (bound {AR_COMPOSITE_ATOL})",
          flush=True)
    return {"launches": counts[0], "ar_frame_ms": ar_frame_ms, "pre_frame_ms": pre_frame_ms,
            "forward_ms": forward_ms, "item_ms": float(np.median(item_ms)), "peak_gib": peak_gib,
            "cli_s": cli_s}



# ---------------------------------------------------------- the encoder zoo

# The zoo's models (BDNet and DepthNet keyword arguments): the reference's
# alternatives to the flagship's encoders and decoder.
ZOO = {
    "a": dict(image_encoder_name="resnet18d", matching_encoder_type="fpn",
              depth_decoder_name="skip"),
    "b": dict(image_encoder_name="resnext101_64x4d"),
    "c": dict(image_encoder_name="seresnextaa101d_32x8d"),
}
# The FPN's level-0 lateral conv feeds a pyramid level that nothing reads:
# backward leaves it no gradient and the train steps give it zeros. AdamW
# then decays it by lr * wd = 1e-8 of its value a step, below f32
# resolution, so its value stays put (in the JAX package's f32 step too);
# the train phases check that AdamW stepped it with a zero gradient.
NO_GRADIENT = ("matching.lateral_0.weight", "matching.lateral_0.bias")
ZOO_TRAIN_BATCHES = (12, 8, 6, 4)  # b=12, else the largest of these that fits


def _forward_ms(net, ds, runs: int = 5) -> float:
    """The median wall time of `runs` more forwards of the first tuple, as
    evaluate_scenes runs them (synchronised after each)."""
    from implicit_depth_tpu_torch.data.mvs_dataset import collate
    from implicit_depth_tpu_torch.eval.occlusion_eval import make_forward_fn

    cur, src = ({k: torch.as_tensor(v).cuda() for k, v in d.items() if k != "frame_id_string"}
                for d in collate([ds[0]]))
    fwd = make_forward_fn(net, False, cli_thresholder().to("cuda"))
    times = []
    with torch.inference_mode():
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fwd(cur, src)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_zoo_main() -> dict:
    """evaluate_scenes with each ZOO BDNet (bf16, seeded random weights) over
    the 5 tuples of phase main: #1 once per forward; model_time_ms, the
    median of 5 more forwards, peak memory, one profiled forward."""
    ds = eval_dataset()
    out = {}
    for name, parts in ZOO.items():
        label = f"zoo-main-{name}"
        net = flagship_net(torch.bfloat16, **parts).cuda().cast_to_compute_dtype()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = _occlusion_eval(label, net, ds, lambda n: (n, 0, 0, 0, 0, 0))
        metrics = res["all_scene"].final_metrics
        _check_ious(label, metrics)
        median_ms = _forward_ms(net, ds)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        print(f"{label}: {res['forwards']} forwards of BDNet.forward_val ({parts}, K=7, D=64, "
              f"P=8, bf16, seeded random weights) on 512x384 synthetic tuples, b=1: "
              f"model_time_ms {res['model_time_ms']:.3f}, median of 5 more forwards "
              f"{median_ms:.3f} ms, step_time_ms {res['step_time_ms']:.3f}, peak device memory "
              f"{peak_gib:.2f} GiB, launches #1-#6 {res['counts']}, iou_d_3.0 "
              f"{metrics['iou_d_3.0']:.4f}", flush=True)
        _profile_forward(label, net, ds)
        out[name] = {"launches": res["counts"][0], "model_time_ms": res["model_time_ms"],
                     "median_ms": median_ms, "peak_gib": peak_gib}
        del net
        torch.cuda.empty_cache()
    return out


def phase_zoo_train() -> dict:
    """TRAIN_STEPS steps of make_bd_train_step on ZOO models (a) and (c) at
    b=12 (else the largest of ZOO_TRAIN_BATCHES that fits), 512x384, N=4096,
    S=64: #1-#4 1/1/4/4 per step, losses finite, every parameter moved (the
    FPN's lateral_0 stepped with a zero gradient); step time, peak memory,
    one profiled step."""
    n = TRAIN_STEPS
    out = {}
    for name in ("a", "c"):
        label = f"zoo-train-{name}"
        for b in ZOO_TRAIN_BATCHES:
            try:
                res = _train_run(b, parts=ZOO[name])
            except torch.cuda.OutOfMemoryError:
                res = None
            if res is not None:
                break
            torch.cuda.empty_cache()
            print(f"{label}: b={b} does not fit in device memory", flush=True)
        if res is None:
            raise AssertionError(f"{label}: no batch of {ZOO_TRAIN_BATCHES} fits")
        step_ms = _check_train(label, res, (n, n, 4 * n, 4 * n, 0, 0))
        print(f"{label}: {n} steps of make_bd_train_step ({ZOO[name]}, K=7, D=64, bf16 "
              f"autocast, f32 params, seeded random weights), b={res['b']} synthetic 512x384 "
              f"tuples, N=4096, S=64 (data {res['data_s']:.1f} s): train_step_ms {step_ms:.1f} "
              f"(median of steps 2-{n}; all {', '.join(f'{t:.1f}' for t in res['times'])}), "
              f"peak device memory {res['peak_gb']:.2f} GiB, launches #1-#6 {res['launches']}, "
              f"loss {res['losses'][0]['loss']:.4f} -> {res['losses'][-1]['loss']:.4f}, "
              f"{len(res['moved'])} parameters moved, stepped with a zero gradient "
              f"{sorted(res['stepped'])}", flush=True)
        _print_profile(label, res["profile"])
        out[name] = {"launches": res["launches"], "train_step_ms": step_ms,
                     "peak_gb": res["peak_gb"], "b": res["b"]}
        torch.cuda.empty_cache()
    return out


def phase_zoo_reg() -> dict:
    """The regression DepthNet of ZOO model (a) (its skip decoder with the
    regression heads): 5 forwards through evaluate_depth, #5 once each, and
    TRAIN_STEPS steps at b=REG_BATCH, #5 and #6 once each a step."""
    parts = ZOO["a"]
    net = reg_net(torch.bfloat16, **parts).cuda().eval().cast_to_compute_dtype()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = _reg_eval("zoo-reg", net, reg_eval_dataset())
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    metrics = res["all_scene"].final_metrics
    print(f"zoo-reg: {res['forwards']} forwards of DepthNet ({parts}, K=7, D=64, bf16, seeded "
          f"random weights) through evaluate_depth on 512x384 synthetic tuples, b=1: "
          f"reg_model_time_ms {res['model_time_ms']:.3f}, peak device memory {peak_gib:.2f} "
          f"GiB, launches #1-#6 {res['counts']}, abs_rel {metrics['abs_rel']:.4f}", flush=True)
    del net
    torch.cuda.empty_cache()
    train = phase_reg_train("zoo-reg-train", parts)
    torch.cuda.empty_cache()
    return {"launches": res["forwards"], "reg_model_time_ms": res["model_time_ms"],
            "peak_gib": peak_gib, "train": train}


def phase_zoo_model() -> None:
    """ZOO model (a), GPU (kernels) against CPU (plain versions) from the
    same weights and batch at 128x192, flagship width: one f32 BD step
    (the bounds of train-model) and one f32 regression step of its
    DepthNet (the bounds of reg-train-model)."""
    phase_train_model(parts=ZOO["a"])
    phase_reg_train_model("zoo-model-reg", ZOO["a"])


# ------------------------------------------------------------------ the tools

TOOLS_ITERS = 3  # timed calls of each eval probe; train probes take 2 steps
ROOFLINE_ROUNDS = (10, 4)  # rounds of cli/roofline.py, eval and --train
# launches of kernels #1-#4 per call of each probe of the measurement tools
EVAL_PROBE_LAUNCHES = {"encoder": (0, 0, 0, 0), "matching": (0, 0, 0, 0),
                       "volume": (1, 0, 0, 0), "cv_encoder": (1, 0, 0, 0),
                       "trunk(decoder)": (1, 0, 0, 0), "forward_val": (1, 0, 0, 0)}
TRAIN_PROBE_LAUNCHES = {"full": (1, 1, 4, 4), "fwd_only": (1, 0, 4, 0),
                        "zero_volume": (0, 0, 4, 4), "trunk_zero": (0, 0, 0, 0)}


def _check_probe_launches(label: str, launches: dict, calls: int, expected: dict) -> None:
    """Raises unless each probe launched #1-#4 `calls` times its row of
    `expected`, and #5/#6 never."""
    for probe, per_call in expected.items():
        want = tuple(n * calls for n in per_call) + (0, 0)
        if tuple(launches[probe]) != want:
            raise AssertionError(f"{label}: probe {probe} launched #1-#6 {launches[probe]} over "
                                 f"{calls} calls, expected {want}")


def _check_roofline(label: str, res: dict, expected: dict) -> None:
    """Raises where a probe's counted call launched other than `expected`
    once, or where a section reads over 100% of a peak."""
    _check_probe_launches(label, {p: r["launches"] for p, r in res["probes"].items()}, 1,
                          {p: e for p, e in expected.items() if p in res["probes"]})
    over = [(r["section"], r["bf16_pct"], r["hbm_pct"]) for r in res["rows"]
            if r["bf16_pct"] > 100 or r["hbm_pct"] > 100]
    if over:
        raise AssertionError(f"{label}: sections over 100% of a peak: {over}")


def _check_work(label: str, got: float, want: float) -> None:
    if got != want:
        raise AssertionError(f"{label}: the roofline counts {got:.6e} FLOP a launch, the "
                             f"kernel's bound {want:.6e}")


def phase_tools(kern: dict, kern_bwd: dict, kern_ray: dict) -> dict:
    """The measurement tools on the card (cli/profile_eval.py at b=1,
    cli/profile_train.py --batch 12 --json, cli/bench_train.py --batch 12,
    cli/roofline.py in eval and --train), each probe's launches against
    EVAL_PROBE_LAUNCHES / TRAIN_PROBE_LAUNCHES, no roofline share over 100%,
    the roofline's work per launch equal to the work behind the kernel
    phases' bounds; then make_random_checkpoint -> a training checkpoint ->
    strip_checkpoint -> a strict load on the card, bit-equal."""
    import tempfile

    from implicit_depth_tpu_torch.cli import (bench_train, make_random_checkpoint, profile_eval,
                                              profile_train, roofline, strip_checkpoint)
    from implicit_depth_tpu_torch.models.bd_net import TRAIN_ONLY_PREFIXES, BDNet
    from implicit_depth_tpu_torch.train import checkpoint as ckpt_lib
    from implicit_depth_tpu_torch.train import state
    from implicit_depth_tpu_torch.weights import load_state_dict

    t0 = time.perf_counter()
    ev = profile_eval.main(["--batch", "1", "--iters", str(TOOLS_ITERS)])
    _check_probe_launches("profile-eval", ev["launches"], TOOLS_ITERS, EVAL_PROBE_LAUNCHES)
    torch.cuda.empty_cache()
    tr = profile_train.main(["--batch", "12", "--iters", "2", "--json"])
    _check_probe_launches("profile-train", tr["launches"], 2, TRAIN_PROBE_LAUNCHES)
    bench = bench_train.main(["--batch", "12", "--iters", str(TOOLS_ITERS)])
    _check_probe_launches("bench-train", {"full": bench["launches"]}, TOOLS_ITERS,
                          {"full": TRAIN_PROBE_LAUNCHES["full"]})
    if not (np.isfinite(bench["first_loss"]) and np.isfinite(bench["loss"])):
        raise AssertionError(f"bench-train: non-finite losses {bench}")
    torch.cuda.empty_cache()
    rf_eval = roofline.main(["--iters", str(ROOFLINE_ROUNDS[0]), "--json"])
    _check_roofline("roofline", rf_eval, EVAL_PROBE_LAUNCHES)
    rf_train = roofline.main(["--train", "--iters", str(ROOFLINE_ROUNDS[1]), "--json"])
    _check_roofline("roofline --train", rf_train, TRAIN_PROBE_LAUNCHES)
    # the roofline reads the work that the kernels' bounds read
    _check_work("#1 at b=1", rf_eval["work"][1], kern["flagship bf16"]["flops"])
    _check_work("#1 at b=12", rf_train["work"][1], kern["train bf16"]["flops"])
    _check_work("#2 at b=12", rf_train["work"][2], kern_bwd["train bf16"]["flops"])
    _check_work("#3 at scale 0", rf_train["work"][3][0], kern_ray["fwd"]["flops"])
    _check_work("#4 at scale 0", rf_train["work"][4][0], kern_ray["bwd"]["flops"])
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        weights = make_random_checkpoint.main(
            ["--config_file", os.path.join(REPO, "configs/models/implicit_depth.yaml"),
             "--output", os.path.join(tmp, "random.pt"), "--seed", "0"])
        net = BDNet(compute_dtype=torch.bfloat16)
        load_state_dict(net, ckpt_lib.load_weights(weights), optional_prefixes=TRAIN_ONLY_PREFIXES)
        net = net.cuda()
        opt, sched = state.make_optimizer(net.parameters())
        ckpt_lib.save_state(os.path.join(tmp, "ckpt_00000000"), net, opt, sched, step=0,
                            config={"name": "random"})
        stripped = strip_checkpoint.main([os.path.join(tmp, "ckpt_00000000"),
                                          os.path.join(tmp, "stripped.pt")])
        fresh = BDNet(compute_dtype=torch.bfloat16).cuda()
        load_state_dict(fresh, {k: v.cuda() for k, v in ckpt_lib.load_weights(stripped).items()})
        same = all(torch.equal(v, fresh.state_dict()[k]) for k, v in net.state_dict().items())
        if not same:
            raise AssertionError("tools: the stripped checkpoint's weights differ from the net's")
    del net, fresh, opt
    torch.cuda.empty_cache()
    wall_s = time.perf_counter() - t0
    print(f"tools: profile-eval forward_val {ev['ms']['forward_val']:.3f} ms, profile-train full "
          f"{tr['ms']['full']:.1f} ms, bench-train {bench['ms']:.1f} ms/step at b=12; launches "
          "as the probe tables; no roofline share over 100%; the roofline's work per launch is "
          "the bounds'; random -> checkpoint -> stripped weights load strictly, bit-equal; "
          f"phase wall {wall_s:.1f} s", flush=True)
    # each kernel's launches on each tool's run (the timed or counted calls)
    paths = {"profile-eval": tuple(map(sum, zip(*ev["launches"].values()))),
             "profile-train": tuple(map(sum, zip(*tr["launches"].values()))),
             "bench-train": bench["launches"],
             "roofline": tuple(map(sum, zip(*[r["launches"] for res in (rf_eval, rf_train)
                                              for r in res["probes"].values()])))}
    return {"paths": paths, "wall_s": wall_s}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drives the PyTorch port on one NVIDIA GPU.")
    ap.add_argument("--ddp-rank", type=int, help="run one rank of ddp-train (internal)")
    ap.add_argument("--ddp-world", type=int, default=DDP_WORLD)
    ap.add_argument("--ddp-port", type=int)
    ap.add_argument("--ddp-out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU only",
              file=sys.stderr)
        return 1
    # the comparisons hold f32 against f32: no TF32 in cuDNN convolutions or
    # matmuls anywhere in this run
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.ddp_rank is not None:
        ddp_rank_main(args.ddp_rank, args.ddp_world, args.ddp_port, args.ddp_out)
        return 0
    card = phase_device()
    phase_build()
    kern = phase_kernel()
    kern_bwd = phase_kernel_bwd()
    kern_ray = phase_kernel_ray()
    phase_main()
    phase_model()
    train_res = phase_train()
    phase_train_model()
    kern_warp = phase_kernel_warp()
    phase_reg_main()
    reg_res = phase_reg_train()
    phase_reg_train_model()
    temporal_res = phase_temporal_main()
    temporal_train_res = phase_temporal_train()
    phase_train_model(use_prior=True)
    reg_temporal_res = phase_reg_temporal()
    phase_raster_scaling()
    depth_res = phase_bd_depth()
    phase_bd_depth_model()
    dot_main_res = phase_bd_dot_main()
    dot_train_res = phase_bd_dot_train()
    phase_train_model(feature_volume_type=DOT)
    fit_res = phase_fit_resume()
    ddp_res = phase_ddp_train()
    phase_test_bd_ranks()
    ar_res = phase_ar_inference(card)
    zoo_main = phase_zoo_main()
    zoo_train = phase_zoo_train()
    zoo_reg = phase_zoo_reg()
    phase_zoo_model()
    tools = phase_tools(kern, kern_bwd, kern_ray)
    csrc, tpu = "implicit_depth_tpu_torch/csrc/", "implicit_depth_tpu/ops/"
    rows = (("fused_metadata_volume", "fused_volume.cu", "fused_volume.py:90",
             kern["flagship bf16"], train_res["launches"][0]),
            ("fused_metadata_volume_bwd", "fused_volume_bwd.cu", "fused_volume.py:349",
             kern_bwd["flagship bf16"], train_res["launches"][1]),
            ("ray_head_fwd", "ray_head.cu", "ray_head.py:142", kern_ray["fwd"],
             train_res["launches"][2]),
            ("ray_head_bwd", "ray_head.cu", "ray_head.py:161", kern_ray["bwd"],
             train_res["launches"][3]),
            ("warp_planes", "warp_planes.cu", "warp_kernel.py:44", kern_warp["train bf16"]["fwd"],
             reg_res["launches"][4]),
            ("warp_planes_bwd", "warp_planes.cu", "warp_kernel.py:199",
             kern_warp["train bf16"]["bwd"], reg_res["launches"][5]))
    kernels = [{
        "name": name, "route": "cuda", "source": csrc + source, "replaces": tpu + replaces,
        "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r.get("library_ms")} for name, source, replaces, r, launches in rows]
    kernels[0]["train_shape"] = kern["train bf16"]  # #1 at the train step's b=12
    kernels[1]["train_shape"] = kern_bwd["train bf16"]  # #2 at the train step's b=12
    # launches on each main path that runs the kernel
    for i, row in enumerate(kernels[:4]):
        row["paths"] = {"train": train_res["launches"][i],
                        "temporal-train": temporal_train_res["launches"][i]}
    kernels[0]["paths"]["temporal-main"] = temporal_res["launches"]
    kernels[0]["paths"]["bd-depth"] = depth_res["launches"]
    kernels[0]["paths"]["ar-inference"] = ar_res["launches"]
    for i in (2, 3):
        kernels[i]["paths"]["bd-dot-train"] = dot_train_res["launches"][i]
    for i, row in enumerate(kernels[:4]):
        row["paths"]["fit-resume"] = fit_res["launches"][i]  # both fits, validations included
        row["paths"]["ddp-train"] = ddp_res["launches"][i]  # rank 0, its timed steps
    kernels[2]["prior_ms"] = kern_ray["fwd_prior_ms"]  # the variant with the prior
    kernels[3]["prior_ms"] = kern_ray["bwd_prior_ms"]
    kernels[4]["paths"] = {"reg-train": reg_res["launches"][4],
                           "reg-temporal": reg_temporal_res["launches"],
                           "bd-dot-main": dot_main_res["launches"],
                           "bd-dot-train": dot_train_res["launches"][4]}
    kernels[5]["paths"] = {"reg-train": reg_res["launches"][5],
                           "bd-dot-train": dot_train_res["launches"][5]}
    for name, r in zoo_main.items():
        kernels[0]["paths"][f"zoo-main-{name}"] = r["launches"]
    for name, r in zoo_train.items():
        for i, row in enumerate(kernels[:4]):
            row["paths"][f"zoo-train-{name}"] = r["launches"][i]
    kernels[4]["paths"]["zoo-reg"] = zoo_reg["launches"]
    for i in (4, 5):
        kernels[i]["paths"]["zoo-reg-train"] = zoo_reg["train"]["launches"][i]
    for i, row in enumerate(kernels[:4]):
        row["paths"].update({tool: n[i] for tool, n in tools["paths"].items()})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
