#!/usr/bin/env python3
"""Drives the PyTorch port (implicit_depth_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each or a few; any failure raises and the script exits
non-zero:
1. device:      the card's name and power limit (nvidia-smi).
2. build:       nvcc builds the four kernel libraries from
                implicit_depth_tpu_torch/csrc/, one process per source, all at
                once; the ptxas register and spill report of each, and the
                count of tensor-core (HMMA) instructions in kernel #2's.
3. kernel:      the fused-volume forward (kernel #1) against its plain
                PyTorch version, at the flagship shape (B=1, K=7, C=16, H=96,
                W=128, D=64, F=128) with f32 and bf16 features, and at a
                ragged shape; errors against the stated tolerances,
                CUDA-event medians.
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
5. kernel-ray:  the ray-head forward and backward (kernels #3, #4) against
                their plain versions at b=12, N=4096, S=64 (bf16, with and
                without the prior) and at a ragged N=100, S=13 (f32).
6. main:        `evaluate_scenes` with the flagship BDNet (EfficientNetV2-S,
                7 source views, 64 planes, 8 query planes, bf16, seeded
                random weights) over 5 synthetic 512x384 tuples at b=1; kernel
                #1 must launch once per forward.
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
                96x128, C=16; f32 and bf16), the train shape (K'=112, bf16)
                and a ragged shape (K'=3, D=13, 50x70, f32) whose poses put
                samples behind the camera and out of frame; max errors
                against stated bounds, CUDA-event medians of the kernels,
                the plain versions and the library calls (F.grid_sample and
                its backward), and the bound.
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
Then one JSON line with the six kernels' results and, last, the device line.

The script imports torch, numpy and the port; nothing of JAX and nothing of
the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

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
# Ray head: the forward's output takes fp's dtype; bf16 rounds the f32
# result, so two ulps of bf16 (rtol 1e-2). The backward's cotangents are f32
# from the same f32 math: 1e-4 of each cotangent's largest value.
RAY_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-3, 1e-2)}
RAY_BWD_REL = 1e-4
FLAGSHIP = dict(B=1, K=7, H=96, W=128, D=64)
RAGGED = dict(B=2, K=3, H=50, W=70, D=13)
RAY_FLAGSHIP = dict(b=12, n=4096, s=64)
RAY_RAGGED = dict(b=2, n=100, s=13)
TIMED_RUNS = 20
# the card's published peaks (H100 SXM data sheet, 700 W): HBM bytes/s and
# dense bf16 tensor-core FLOP/s; a bound is the larger of bytes / HBM and
# FLOP / the bf16 peak (the kernels' work is matrix products)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12  # CUDA cores, outside the tensor cores (the warp's arithmetic)
C_, F_ = 16, 128


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
    from implicit_depth_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    libs = cuda_build.build()
    print(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.1f} s (one nvcc per "
          "source, in parallel)", flush=True)
    for source, lib in libs.items():
        log = lib.with_suffix(".log").read_text() if lib.with_suffix(".log").exists() else ""
        ptxas = " | ".join(ln.strip().replace("ptxas info    : ", "") for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln)
        print(f"  {source} -> {lib.name}: {ptxas}", flush=True)
    sass = subprocess.run([cuda_build.cuda_tool("cuobjdump"), "-sass",
                           str(libs["fused_volume_bwd.cu"])],
                          capture_output=True, text=True, check=True).stdout
    hmma = sum("HMMA" in ln for ln in sass.splitlines())
    print(f"  fused_volume_bwd.cu: {hmma} HMMA (tensor-core) instructions in its SASS "
          "(cuobjdump -sass)", flush=True)
    if hmma == 0:
        raise AssertionError("the volume backward's library holds no tensor-core instruction")


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
                b_ms, b_by = least_ms(nbytes(*ops, got), 2.0 * points * volume_fwd_macs(shape["K"]))
                line += (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (median of {TIMED_RUNS}), "
                         f"bound {b_ms:.4f} ms ({b_by})")
                result[label] = {"max_abs_err": err.max().item(), "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": b_ms, "bound_by": b_by}
            print(line, flush=True)
        del ops
    return result


def least_ms(nbytes: float, flops: float, flop_rate: float = BF16_FLOP_PER_S) -> tuple:
    """(least ms, "bytes" or "operations") for the given work on this card."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def volume_fwd_macs(K: int) -> int:
    """Multiply-adds per (b, d, v, u) point of kernel #1: fc0 over the
    K*(C+6) live inputs, fc1, fc2."""
    return K * (C_ + 6) * F_ + F_ * F_ + F_


def volume_bwd_macs(K: int) -> int:
    """Kernel #2 per point: the forward again, dh1 and dW_fc1T (2 F^2),
    dvis and dW_visT (2 K C F), dW_metaT (6 K F), ddot (K F), fc2 (F)."""
    return volume_fwd_macs(K) + 2 * F_ * F_ + 2 * K * C_ * F_ + 7 * K * F_ + F_


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
            points = shape["B"] * shape["D"] * shape["H"] * shape["W"]
            b_ms, b_by = least_ms(nbytes(ct, *ops) + nbytes(*got),
                               2.0 * points * volume_bwd_macs(shape["K"]))
            print(f"kernel-bwd {label}: the plain version under 1e-5 relative noise on base moves "
                  f"by a worst relative L2 of {sens[0]:.2e} ({sens[1]}); kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms (medians), bound {b_ms:.4f} ms ({b_by}); shared memory "
                  f"{bwd_smem_bytes(shape['K'], dtype)} bytes per block", flush=True)
            result[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": b_ms, "bound_by": b_by}
        del ops, got, ref
    result["train bf16"] = _volume_bwd_train_shape()
    return result


VOLUME_PER_BATCH = (0, 1, 2, 3, 4, 5, 7)  # cur, src, A, b, origins, invK, base
VOLUME_PER_POINT = ("dsrc", "dcur", "dbase")


def volume_bwd_reference_by_batch(ct, ops):
    """The plain version of kernel #2 one batch element at a time, in the
    device memory of one: the per-point cotangents concatenated, the weight
    gradients summed over the elements."""
    from implicit_depth_tpu_torch.ops.fused_volume import (
        FusedVolumeCotangents, fused_metadata_volume_bwd_reference)

    parts = [fused_metadata_volume_bwd_reference(
        ct[i:i + 1], *(x[i:i + 1] if j in VOLUME_PER_BATCH else x for j, x in enumerate(ops)))
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
    points = shape["B"] * shape["D"] * shape["H"] * shape["W"]
    b_ms, b_by = least_ms(nbytes(ct, *ops) + nbytes(*got), 2.0 * points * volume_bwd_macs(shape["K"]))
    print(f"kernel-bwd train bf16 {tuple(ct.shape)} (B, D, H, W), K={shape['K']}: kernel {ms:.3f} ms "
          f"(median of {TIMED_RUNS}), plain {plain_ms:.3f} ms ({shape['B']} calls of one batch "
          f"element, median of 3), bound {b_ms:.4f} ms ({b_by})", flush=True)
    return {"shape": "B=12 K=7 96x128 D=64 bf16", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}


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


def phase_kernel_ray() -> dict:
    from implicit_depth_tpu_torch.ops import ray_head as rh

    result = {}
    for label, shape, prior, dtype in (
            ("flagship noprior bf16", RAY_FLAGSHIP, False, torch.bfloat16),
            ("flagship prior bf16", RAY_FLAGSHIP, True, torch.bfloat16),
            ("ragged noprior f32", RAY_RAGGED, False, torch.float32),
            ("ragged prior f32", RAY_RAGGED, True, torch.float32)):
        ops, ct = ray_inputs(**shape, prior=prior, dtype=dtype)
        with torch.no_grad():
            out = rh.ray_head_fwd(*ops)
            ref = rh.ray_head_reference(*ops)
        gk = rh.ray_head_bwd(ct, *ops[:-1])
        gr = rh.ray_head_bwd_reference(ct, *ops[:-1])
        torch.cuda.synchronize()
        atol, rtol = RAY_TOL[dtype]
        d = (out.float() - ref.float()).abs()
        if out.shape != ref.shape or not torch.isfinite(out.float()).all() or \
                (d > atol + rtol * ref.float().abs()).any():
            raise AssertionError(f"kernel-ray {label}: forward disagrees with its plain version: "
                                 f"max_abs_err {d.max().item():.3e}")
        fwd_err, bwd_err = d.max().item(), 0.0
        for name in gk._fields:
            a, r = getattr(gk, name), getattr(gr, name)
            if a is None and r is None:
                continue
            e = (a.reshape(r.shape) - r).abs().max().item()
            if not e <= RAY_BWD_REL * r.abs().max().item() + 1e-6:
                raise AssertionError(f"kernel-ray {label}: backward {name} disagrees with its "
                                     f"plain version: max_abs_err {e:.3e}")
            bwd_err = max(bwd_err, e)
        line = (f"kernel-ray {label} b={shape['b']} N={shape['n']} S={shape['s']}: forward "
                f"max_abs_err {fwd_err:.3e} (bound {atol} + {rtol}*|ref|), backward "
                f"max_abs_err {bwd_err:.3e} (bound {RAY_BWD_REL}*max|ref|)")
        if shape is RAY_FLAGSHIP and not prior:
            with torch.no_grad():
                f_ms = cuda_ms(lambda: rh.ray_head_fwd(*ops))
                f_plain = cuda_ms(lambda: rh.ray_head_reference(*ops), runs=5)
            b_ms_k = cuda_ms(lambda: rh.ray_head_bwd(ct, *ops[:-1]))
            b_plain = cuda_ms(lambda: rh.ray_head_bwd_reference(ct, *ops[:-1]), runs=5)
            rows = shape["b"] * shape["n"] * shape["s"]
            fb = least_ms(nbytes(*ops, out), 2.0 * rows * (F_ * F_ + 3 * F_))
            bb = least_ms(nbytes(*ops[:-1], ct) + nbytes(*(t for t in gk if t is not None)),
                       2.0 * rows * (3 * F_ * F_ + 8 * F_))
            line += (f"; forward kernel {f_ms:.3f} ms, plain {f_plain:.3f} ms, bound "
                     f"{fb[0]:.4f} ms ({fb[1]}); backward kernel {b_ms_k:.3f} ms, plain "
                     f"{b_plain:.3f} ms, bound {bb[0]:.4f} ms ({bb[1]})")
            result["fwd"] = {"max_abs_err": fwd_err, "ms": f_ms, "plain_ms": f_plain,
                             "bound_ms": fb[0], "bound_by": fb[1]}
            result["bwd"] = {"max_abs_err": bwd_err, "ms": b_ms_k, "plain_ms": b_plain,
                             "bound_ms": bb[0], "bound_by": bb[1]}
        print(line, flush=True)
        del ops, ct, out, ref, gk, gr
    return result


def flagship_net(dtype, seed: int = 0):
    from implicit_depth_tpu_torch.models.bd_net import BDNet
    from implicit_depth_tpu_torch.weights import init_params

    net = BDNet(num_src_views=7, num_depth_bins=64, compute_dtype=dtype)
    return init_params(net, torch.Generator().manual_seed(seed)).eval()


def phase_main() -> dict:
    from implicit_depth_tpu_torch.data.synthetic import SyntheticDataset
    from implicit_depth_tpu_torch.eval import binary_metrics as bm
    from implicit_depth_tpu_torch.eval.occlusion_eval import evaluate_scenes

    ds = SyntheticDataset(num_frames=12, num_views=8, image_height=384, image_width=512,
                          split="test", get_bd_info=True)
    net = flagship_net(torch.bfloat16).cuda().cast_to_compute_dtype()
    thresholder = bm.Thresholder(np.linspace(1.5, 5.0, 8, dtype=np.float32),
                                 np.full(8, 0.5, np.float32))
    _zero_launch_counts()
    res = evaluate_scenes(net, {"scene0": ds}, batch_size=1, thresholder=thresholder)
    counts = _launch_counts()
    launches = counts[0]
    metrics = res["all_scene"].final_metrics
    if res["forwards"] != len(ds) or counts != (res["forwards"], 0, 0, 0, 0, 0):
        raise AssertionError(f"{res['forwards']} forwards over {len(ds)} tuples, "
                             f"kernel launches #1-#6 {counts}")
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


def _wrappers() -> tuple:
    """The six kernel wrappers, #1 to #6."""
    from implicit_depth_tpu_torch.ops import fused_volume as fvm
    from implicit_depth_tpu_torch.ops import ray_head as rh
    from implicit_depth_tpu_torch.ops import warp_kernel as wk

    return (fvm.fused_metadata_volume, fvm.fused_metadata_volume_bwd, rh.ray_head_fwd,
            rh.ray_head_bwd, wk.warp_planes, wk.warp_planes_bwd)


def _launch_counts() -> tuple:
    return tuple(fn.launches for fn in _wrappers())


def _zero_launch_counts() -> None:
    for fn in _wrappers():
        fn.launches = 0


TRAIN_STEPS = 6


def _train_run(batch_size: int) -> dict:
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
    net = flagship_net(torch.bfloat16).cuda()
    opt, sched = state.make_optimizer(net.parameters(), lr=1e-4, wd=1e-4)
    step = state.make_bd_train_step(net, opt, sched, generator=torch.Generator().manual_seed(0))
    watched = {"encoder.conv_stem.weight": net.encoder.conv_stem.weight,
               "volume_mlp.fc0_kernel": net.volume_mlp.fc0_kernel,
               "binary_mlp.s3_fc1.weight": net.binary_mlp.s3_fc1.weight,
               "matching.bn1.running_var": net.matching.bn1.running_var,
               "encoder.s5_b14.bn3.running_mean": net.encoder.s5_b14.bn3.running_mean}
    before = {k: v.detach().clone() for k, v in watched.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = step((cur, src))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        losses.append({k: float(v) for k, v in out.items()})
    launches = _launch_counts()
    moved = {k: not torch.equal(before[k], v.detach()) for k, v in watched.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    return {"b": batch_size, "launches": launches, "times": times, "losses": losses,
            "moved": moved, "peak_gb": peak_gb, "data_s": data_s,
            "profile": _profile_step(step, (cur, src))}


def _profile_step(step, batch) -> dict:
    """One more steady-state step under torch.profiler: its wall time, the
    device time summed over kernels, and the largest kernels by device time."""
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
    return {"wall_ms": wall_ms, "device_ms": sum(k[0] for k in kernels), "top": kernels[:10]}


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
    if res["launches"] != (n, n, 4 * n, 4 * n, 0, 0):
        raise AssertionError(f"train: kernel launches #1-#6 {res['launches']} over {n} "
                             f"steps, expected {(n, n, 4 * n, 4 * n, 0, 0)}")
    if not all(np.isfinite(v) for ls in res["losses"] for v in ls.values()):
        raise AssertionError(f"train: non-finite losses {res['losses']}")
    if not all(res["moved"].values()):
        raise AssertionError(f"train: parameters or BN statistics did not move: {res['moved']}")
    step_ms = float(np.median(res["times"][1:]))
    print(f"train: {n} steps of make_bd_train_step (EfficientNetV2-S, K=7, D=64, bf16 autocast, "
          f"f32 params, seeded random weights), b={res['b']} synthetic 512x384 tuples, N=4096, "
          f"S=64 (data {res['data_s']:.1f} s): train_step_ms {step_ms:.1f} (median of steps "
          f"2-{n}; all {', '.join(f'{t:.1f}' for t in res['times'])}), peak device memory "
          f"{res['peak_gb']:.2f} GiB, launches #1-#6 {res['launches']}, loss "
          f"{res['losses'][0]['loss']:.4f} -> {res['losses'][-1]['loss']:.4f}, moved "
          f"{sorted(res['moved'])}", flush=True)
    prof = res["profile"]
    print(f"train profile (one more step under torch.profiler): wall {prof['wall_ms']:.1f} ms, "
          f"device kernels {prof['device_ms']:.1f} ms (device idle "
          f"{max(0.0, 1 - prof['device_ms'] / prof['wall_ms']):.1%}); largest by device time:",
          flush=True)
    for ms, count, name in prof["top"]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {name[:110]}", flush=True)
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


def phase_train_model() -> None:
    import copy

    from implicit_depth_tpu_torch.ops import image as image_ops
    from implicit_depth_tpu_torch.train import state
    from implicit_depth_tpu_torch.utils.fixtures import synthetic_bd_batch

    net = flagship_net(torch.float32)
    cur, src = synthetic_bd_batch(batch=1, num_src=7, height=128, width=192, num_rays=256,
                                  samples_per_ray=64, seed=2)
    runs = {}
    for dev in ("cpu", "cuda"):
        n = copy.deepcopy(net).to(dev)
        opt, sched = state.make_optimizer(n.parameters(), lr=1e-4, wd=1e-4)
        # the edge mask's quantile threshold can flip a pixel between two
        # devices' rounding, which moves the regulariser by a whole ray:
        # compared on its own below
        step = state.make_bd_train_step(n, opt, sched, edge_regularisation=False)
        batch = ({k: torch.tensor(v, device=dev) for k, v in cur.items()},
                 {k: torch.tensor(v, device=dev) for k, v in src.items()})
        losses = step(batch, flip=True)
        runs[dev] = (float(losses["loss"]),
                     {k: p.grad.detach().double().cpu() for k, p in n.named_parameters()},
                     image_ops.get_edge_mask(batch[0]["gt_depth"]).cpu())
    (l_cpu, g_cpu, e_cpu), (l_gpu, g_gpu, e_gpu) = runs["cpu"], runs["cuda"]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    gmax = max(g.abs().max().item() for g in g_cpu.values())
    num = sum(((g_gpu[k] - g_cpu[k]) ** 2).sum().item() for k in g_cpu)
    den = sum((g ** 2).sum().item() for g in g_cpu.values())
    grad_l2 = (num / den) ** 0.5
    leaf = max(((g_gpu[k] - g).abs().max().item() / g.abs().max().item(), k)
               for k, g in g_cpu.items() if g.abs().max().item() >= 1e-6 * gmax)
    edge_diff = (e_gpu != e_cpu).float().mean().item()
    print(f"train-model: one f32 train step, flagship-width BDNet at 128x192, b=1, N=256, S=64, "
          f"flip on, GPU (kernels) vs CPU (plain versions): loss {l_gpu:.6f} vs {l_cpu:.6f} "
          f"(relative {loss_rel:.2e}, bound {MODEL_LOSS_REL}); gradients relative L2 "
          f"{grad_l2:.2e} (bound {MODEL_GRAD_L2}), worst parameter {leaf[1]} {leaf[0]:.2e} "
          f"(bound {MODEL_GRAD_LEAF}); edge mask pixels differing {edge_diff:.2e}", flush=True)
    if not (loss_rel <= MODEL_LOSS_REL and grad_l2 <= MODEL_GRAD_L2
            and leaf[0] <= MODEL_GRAD_LEAF and edge_diff <= 1e-2):
        raise AssertionError("train-model: the GPU train step disagrees with the CPU one")

# ---------------------------------------------------------------- the warp

WARP_EVAL = dict(K=7, H=96, W=128, D=64)     # one frame of the eval path: b=1 x 7 views
WARP_TRAIN = dict(K=112, H=96, W=128, D=64)  # a train step at b=16: 16 x 7 views
WARP_RAGGED = dict(K=3, H=50, W=70, D=13)
# #5 and #6 vs plain, (atol, rtol): the JAX package's bounds for its warp
# kernels against the XLA sampler (tests/test_warp_kernel.py). The sample
# coordinates are the same bits on both sides; the bilinear blend rounds in
# another order, and #6's float atomics add a source pixel's contributions in
# an order that changes from run to run. In bf16 one bf16 ulp (at most 2^-7
# of the value) on top: both round one f32 value to bf16 and may straddle a
# rounding boundary.
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
                  extreme: bool = False) -> tuple:
    """Seeded operands of the warp: source features (K', H, W, 16), the
    homography components A (K', 3, 3), b (K', 3) of views at small random
    rotations and translations around the current one (intrinsics at
    matching resolution), log-spaced planes 0.25-5 m. `extreme` turns every
    other view by ~70 degrees and pushes it back, so that some samples fall
    behind the camera and many out of frame."""
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
    return src, torch.tensor(A, device=device), torch.tensor(b, device=device), planes


def _frame_shares(A, b, planes, H: int, W: int) -> tuple:
    """Shares of the sample points behind the camera (z at its clamp) and
    wholly out of frame (no tap inside the image)."""
    from implicit_depth_tpu_torch.core import geometry
    from implicit_depth_tpu_torch.ops import warp_kernel as wk

    x, y = wk.sample_coords(A, b, planes, H, W)
    r2 = planes[None, :, None, None] * torch.einsum(
        "kj,hwj->khw", A[:, 2], geometry.pixel_grid(H, W, device=A.device))[:, None]
    behind = (r2 + b[:, 2, None, None, None] <= 1e-5).float().mean().item()
    outside = ((x <= -1) | (x >= W) | (y <= -1) | (y >= H)).float().mean().item()
    return behind, outside


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
    for label, shape, dtype, extreme in (("eval f32", WARP_EVAL, torch.float32, False),
                                         ("eval bf16", WARP_EVAL, torch.bfloat16, False),
                                         ("train bf16", WARP_TRAIN, torch.bfloat16, False),
                                         ("ragged f32", WARP_RAGGED, torch.float32, True)):
        K, H, W, D = (shape[x] for x in "KHWD")
        src, A, b, planes = warp_operands(**shape, dtype=dtype, seed=1, extreme=extreme)
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
        torch.cuda.synchronize()
        behind, outside = _frame_shares(A, b, planes, H, W)
        line = (f"kernel-warp {label} K'={K} D={D} {H}x{W} ({behind:.1%} of the samples behind the "
                f"camera, {outside:.1%} out of frame): forward max_abs_err {f_err:.3e} "
                f"(bound {fa} + {fr:.4g}*|ref|), transpose max_abs_err {b_err:.3e} (bound {ba} + "
                f"{br:.4g}*|ref|)")
        if dtype == torch.bfloat16:
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

def reg_net(dtype, feature_volume_type: str = "mlp_feature_volume", seed: int = 0):
    """The flagship regression DepthNet (configs/models/regression_model.yaml:
    EfficientNetV2-S, ResNet matching encoder, 7 source views, 64 planes,
    U-Net++ with log-depth heads), seeded random weights."""
    from implicit_depth_tpu_torch.models.depth_net import DepthNet
    from implicit_depth_tpu_torch.weights import init_params

    net = DepthNet(feature_volume_type=feature_volume_type, num_src_views=7, num_depth_bins=64,
                   compute_dtype=dtype)
    return init_params(net, torch.Generator().manual_seed(seed))


def phase_reg_main() -> dict:
    from implicit_depth_tpu_torch.data.mvs_dataset import collate
    from implicit_depth_tpu_torch.data.synthetic import SyntheticDataset
    from implicit_depth_tpu_torch.eval.depth_eval import evaluate_depth

    ds = SyntheticDataset(num_frames=12, num_views=8, image_height=384, image_width=512,
                          split="test", get_bd_info=False)
    net = reg_net(torch.bfloat16).cuda().eval().cast_to_compute_dtype()
    _zero_launch_counts()
    res = evaluate_depth(net, {"scene0": ds}, batch_size=1)
    counts = _launch_counts()
    n = res["forwards"]
    if n != len(ds) or counts != (0, 0, 0, 0, n, 0):
        raise AssertionError(f"reg-main: {n} forwards over {len(ds)} tuples, kernel launches "
                             f"#1-#6 {counts}, expected {(0, 0, 0, 0, n, 0)}")
    metrics = res["all_scene"].final_metrics
    if res["nonfinite_preds"] or not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"reg-main: {res['nonfinite_preds']} non-finite predictions, "
                             f"metrics {metrics}")
    print(f"reg-main: {n} forwards of DepthNet (EfficientNetV2-S, K=7, D=64, bf16, seeded random "
          f"weights) through evaluate_depth on 512x384 synthetic tuples, b=1: reg_model_time_ms "
          f"{res['model_time_ms']:.3f}, launches #1-#6 {counts}, abs_rel "
          f"{metrics['abs_rel']:.4f}, a1 {metrics['a1']:.4f}", flush=True)
    del net

    dot = reg_net(torch.bfloat16, "simple_cost_volume").cuda().eval().cast_to_compute_dtype()
    cur, src = ({k: torch.as_tensor(v).cuda() for k, v in d.items() if k != "frame_id_string"}
                for d in collate([ds[0]]))
    _zero_launch_counts()
    with torch.inference_mode():
        out = dot(cur, src)
    counts = _launch_counts()
    if counts != (0, 0, 0, 0, 1, 0) or not all(torch.isfinite(v).all() for v in out.values()):
        raise AssertionError(f"reg-main dot product: launches #1-#6 {counts}, or non-finite "
                             "outputs")
    print(f"reg-main: one forward of the dot-product DepthNet (dot_product_model.yaml, bf16): "
          f"launches #1-#6 {counts}, depth_pred_0 {tuple(out['depth_pred_0'].shape)} finite",
          flush=True)
    return {"launches": res["forwards"], "reg_model_time_ms": res["model_time_ms"]}


REG_BATCH = 16  # regression_model.yaml's batch_size


def phase_reg_train() -> dict:
    from implicit_depth_tpu_torch.data.mvs_dataset import collate
    from implicit_depth_tpu_torch.data.synthetic import SyntheticDataset
    from implicit_depth_tpu_torch.train import state

    t0 = time.perf_counter()
    ds = SyntheticDataset(num_frames=REG_BATCH + 7, num_views=8, image_height=384,
                          image_width=512, split="train", get_bd_info=False)
    cur, src = ({k: torch.as_tensor(v).cuda() for k, v in d.items() if k != "frame_id_string"}
                for d in collate([ds[i] for i in range(REG_BATCH)]))
    data_s = time.perf_counter() - t0
    net = reg_net(torch.bfloat16).cuda()
    opt, sched = state.make_optimizer(net.parameters(), lr=1e-4, wd=1e-4)
    step = state.make_regression_train_step(net, opt, sched,
                                            generator=torch.Generator().manual_seed(0))
    watched = {"encoder.conv_stem.weight": net.encoder.conv_stem.weight,
               "matching.conv1.weight": net.matching.conv1.weight,
               "volume_mlp.fc0_kernel": net.volume_mlp.fc0_kernel,
               "decoder.output_head_0.weight": net.decoder.output_head_0.weight,
               "matching.bn1.running_var": net.matching.bn1.running_var,
               "encoder.s5_b14.bn3.running_mean": net.encoder.s5_b14.bn3.running_mean}
    before = {k: v.detach().clone() for k, v in watched.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = step((cur, src))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        losses.append({k: float(v) for k, v in out.items()})
    counts = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    n = TRAIN_STEPS
    if counts != (0, 0, 0, 0, n, n):
        raise AssertionError(f"reg-train: kernel launches #1-#6 {counts} over {n} steps, "
                             f"expected {(0, 0, 0, 0, n, n)}")
    if not all(np.isfinite(v) for ls in losses for v in ls.values()):
        raise AssertionError(f"reg-train: non-finite losses {losses}")
    moved = {k: not torch.equal(before[k], v.detach()) for k, v in watched.items()}
    if not all(moved.values()):
        raise AssertionError(f"reg-train: parameters or BN statistics did not move: {moved}")
    step_ms = float(np.median(times[1:]))
    print(f"reg-train: {n} steps of make_regression_train_step (DepthNet EfficientNetV2-S, K=7, "
          f"D=64, bf16 autocast, f32 params, seeded random weights), b={REG_BATCH} synthetic "
          f"512x384 tuples (data {data_s:.1f} s): reg_train_step_ms {step_ms:.1f} (median of "
          f"steps 2-{n}; all {', '.join(f'{t:.1f}' for t in times)}), peak device memory "
          f"{peak_gb:.2f} GiB, launches #1-#6 {counts}, loss {losses[0]['loss']:.4f} -> "
          f"{losses[-1]['loss']:.4f}, moved {sorted(moved)}", flush=True)
    prof = _profile_step(step, (cur, src))
    print(f"reg-train profile (one more step under torch.profiler): wall {prof['wall_ms']:.1f} ms, "
          f"device kernels {prof['device_ms']:.1f} ms (device idle "
          f"{max(0.0, 1 - prof['device_ms'] / prof['wall_ms']):.1%}); largest by device time:",
          flush=True)
    for ms, count, name in prof["top"]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {name[:110]}", flush=True)
    return {"launches": counts, "reg_train_step_ms": step_ms, "peak_gb": peak_gb}


def phase_reg_train_model() -> None:
    """One f32 regression step, GPU against CPU, held to the BD step's
    bounds (MODEL_*): the same causes of spread (f32 sums in other orders,
    LeakyReLU slope ties in the volume MLP, ~60 layers of backward) plus the
    transpose's atomics, whose order varies from run to run."""
    import copy

    from implicit_depth_tpu_torch.train import state
    from implicit_depth_tpu_torch.utils.fixtures import synthetic_bd_batch

    net = reg_net(torch.float32)
    cur, src = synthetic_bd_batch(batch=1, num_src=7, height=128, width=192, num_rays=4,
                                  samples_per_ray=2, seed=2)
    cur = {k: v for k, v in cur.items() if k not in ("gt_depth", "sampled_rays", "sampled_depths")}
    runs = {}
    for dev in ("cpu", "cuda"):
        n = copy.deepcopy(net).to(dev)
        opt, sched = state.make_optimizer(n.parameters(), lr=1e-4, wd=1e-4)
        step = state.make_regression_train_step(n, opt, sched)
        batch = ({k: torch.tensor(v, device=dev) for k, v in cur.items()},
                 {k: torch.tensor(v, device=dev) for k, v in src.items()})
        losses = step(batch, flip=True)
        runs[dev] = (float(losses["loss"]),
                     {k: p.grad.detach().double().cpu() for k, p in n.named_parameters()})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = runs["cpu"], runs["cuda"]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    gmax = max(g.abs().max().item() for g in g_cpu.values())
    num = sum(((g_gpu[k] - g_cpu[k]) ** 2).sum().item() for k in g_cpu)
    den = sum((g ** 2).sum().item() for g in g_cpu.values())
    grad_l2 = (num / den) ** 0.5
    leaf = max(((g_gpu[k] - g).abs().max().item() / g.abs().max().item(), k)
               for k, g in g_cpu.items() if g.abs().max().item() >= 1e-6 * gmax)
    print(f"reg-train-model: one f32 regression step, flagship-width DepthNet at 128x192, b=1, "
          f"flip on, GPU (kernels) vs CPU (plain versions): loss {l_gpu:.6f} vs {l_cpu:.6f} "
          f"(relative {loss_rel:.2e}, bound {MODEL_LOSS_REL}); gradients relative L2 "
          f"{grad_l2:.2e} (bound {MODEL_GRAD_L2}), worst parameter {leaf[1]} {leaf[0]:.2e} "
          f"(bound {MODEL_GRAD_LEAF})", flush=True)
    if not (loss_rel <= MODEL_LOSS_REL and grad_l2 <= MODEL_GRAD_L2 and leaf[0] <= MODEL_GRAD_LEAF):
        raise AssertionError("reg-train-model: the GPU regression step disagrees with the CPU one")


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
    kernels[1]["train_shape"] = kern_bwd["train bf16"]  # #2 at the train step's b=12
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
