"""The CUDA kernels against their plain PyTorch versions, on the card: the
fused metadata volume forward (#1) and backward (#2), the ray-head forward
(#3) and backward (#4), the plane-sweep warp (#5) and its transpose (#6).
The kernels are CUDA C++ for sm_90a and have no CPU mode, so these tests
skip without an NVIDIA GPU; chip_smoke.py runs the same comparisons at the
main path's shapes.

Tolerances: #1 atol 2e-3, rtol 1e-3 (f32 sums in another order; the JAX
package holds its TPU kernel to the same bound). In bf16 both sides of #1
and #2 round the same f32 values to bf16 where the JAX kernels round their
matrix operands; where the two f32 values differ in their last bits (sums
in another order) they can round one bf16 ulp apart, and a LeakyReLU
pre-activation near 0 can then take the other slope. So #1 in bf16 meets
its bound at all but a share of 2e-3 of the points, with a relative L2
error of at most 2e-3 (chip_smoke.check_volume, VOL_FWD_BF16_OUTSIDE and
VOL_FWD_BF16_REL_L2). #2 is held to
chip_smoke.check_cotangents, per cotangent: relative L2 error 2e-2 and a
share of 1e-2 of the per-point elements outside atol 5e-3 + rtol 5e-3
(f32; tests/test_fused_volume.py:170-176) or 2e-2 + 2e-2 (bf16: five bf16
ulps); at the small shape, where no pre-activation sits within rounding
of 0, also elementwise to atol 5e-3, rtol 5e-3 in both dtypes (measured
~1e-6 in f32, 2.5e-4 in bf16). Its "multitile7" shape has more tiles than
the card has SMs, so that a block walks several tiles and carries its
slab and column sums from one to the next, as in a BD train step. #3 atol
1e-5, rtol 1e-5 in f32; #4 1e-4 of
each cotangent's largest value (f32 sums in another order). #5 and #6 are
held to the JAX package's bounds for its warp kernels against the XLA
sampler (tests/test_warp_kernel.py): #5 atol 2e-4, rtol 1e-4, #6 atol
3e-4, rtol 1e-3. The sample coordinates are the same bits on both sides
(the kernels round them step by step, as the plain version does); the
bilinear blend rounds in another order, and #6's float atomics add a
source pixel's contributions in an order that changes from run to run. In
bf16 one bf16 ulp (at most 2^-7 of the value) on top: both versions round
one f32 value to bf16, and the two may straddle a rounding boundary.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

SHAPES = {
    "small": dict(B=1, K=2, H=16, W=24, D=8),
    "ragged": dict(B=2, K=3, H=13, W=37, D=5),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused volume kernel is CUDA C++ with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_matches_plain_version(cuda, shape, dtype):
    import chip_smoke
    from implicit_depth_tpu_torch.ops.fused_volume import (
        fused_metadata_volume, fused_metadata_volume_reference)

    ops = chip_smoke.volume_operands(**SHAPES[shape], dtype=dtype, seed=3)
    before = fused_metadata_volume.launches
    with torch.no_grad():
        got = fused_metadata_volume(*ops)
        ref = fused_metadata_volume_reference(*ops)
    torch.cuda.synchronize()
    assert fused_metadata_volume.launches == before + 1
    chip_smoke.check_volume(f"{shape} {dtype}", got, ref, dtype)


def test_forward_val_gpu_matches_cpu(cuda):
    """Tiny BDNet: the GPU forward (kernel) against the CPU forward (plain
    version), f32 with TF32 off."""
    from implicit_depth_tpu_torch.utils.fixtures import synthetic_bd_batch
    from implicit_depth_tpu_torch.models.bd_net import BDNet
    from implicit_depth_tpu_torch.ops.fused_volume import fused_metadata_volume
    from implicit_depth_tpu_torch.weights import init_params

    net = init_params(BDNet(image_encoder_name="tiny", num_src_views=2, num_depth_bins=8),
                      torch.Generator().manual_seed(0)).eval()
    cur, src = synthetic_bd_batch(batch=1, num_src=2, height=64, width=96, num_planes=3,
                                  with_train_keys=False)
    with torch.no_grad():
        ref = net.forward_val({k: torch.tensor(v) for k, v in cur.items()},
                              {k: torch.tensor(v) for k, v in src.items()})
        before = fused_metadata_volume.launches
        got = net.to(cuda).forward_val({k: torch.tensor(v, device=cuda) for k, v in cur.items()},
                                       {k: torch.tensor(v, device=cuda) for k, v in src.items()})
    assert fused_metadata_volume.launches == before + 1
    np.testing.assert_allclose(got["pred_0"].cpu().numpy(), ref["pred_0"].numpy(),
                               atol=1e-4, rtol=1e-4)


VOLUME_BWD_SHAPES = {
    "small": dict(B=1, K=2, H=8, W=12, D=5),
    "ragged7": dict(B=2, K=7, H=13, W=37, D=5),
    # 278 tiles of 128 pixels (555 of 64): two or more a block on 132 SMs
    "multitile7": dict(B=6, K=7, H=61, W=97, D=3),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(VOLUME_BWD_SHAPES))
def test_volume_backward_matches_plain_version(cuda, shape, dtype):
    import chip_smoke
    from implicit_depth_tpu_torch.ops import fused_volume as fvm

    dims = VOLUME_BWD_SHAPES[shape]
    ops = chip_smoke.volume_operands(**dims, dtype=dtype, seed=3)[:14]
    ct = torch.randn((dims["B"], dims["D"], dims["H"], dims["W"]),
                     generator=torch.Generator().manual_seed(0)).to(cuda)
    before = fvm.fused_metadata_volume_bwd.launches
    got = fvm.fused_metadata_volume_bwd(ct, *ops)
    ref = fvm.fused_metadata_volume_bwd_reference(ct, *ops)
    torch.cuda.synchronize()
    assert fvm.fused_metadata_volume_bwd.launches == before + 1
    chip_smoke.check_cotangents(f"{shape} {dtype}", got, ref, dtype)
    if shape == "multitile7":
        assert -(-dims["B"] * dims["H"] * dims["W"] // 128) > 2 * torch.cuda.get_device_properties(
            cuda).multi_processor_count
    if shape == "small":
        for name in fvm.FusedVolumeCotangents._fields:
            np.testing.assert_allclose(getattr(got, name).cpu().numpy(),
                                       getattr(ref, name).cpu().numpy(),
                                       atol=5e-3, rtol=5e-3, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_volume_backward_smem_budget_of_the_flagship(cuda, dtype):
    """Seven source views fit the shared-memory budget of each backward
    kernel, the f32 CUDA-core one and the bf16 tensor-core one; eight fit
    neither, and the wrapper refuses them before a launch."""
    import chip_smoke
    from implicit_depth_tpu_torch.ops import fused_volume as fvm

    assert fvm.bwd_smem_bytes(7, dtype) <= fvm.SMEM_LIMIT < fvm.bwd_smem_bytes(8, dtype)
    ops = chip_smoke.volume_operands(B=1, K=8, H=8, W=12, D=2, dtype=dtype, seed=3)[:14]
    before = fvm.fused_metadata_volume_bwd.launches
    with pytest.raises(ValueError):
        fvm.fused_metadata_volume_bwd(torch.zeros((1, 2, 8, 12), device=cuda), *ops)
    assert fvm.fused_metadata_volume_bwd.launches == before


@pytest.mark.parametrize("prior", [False, True], ids=["noprior", "prior"])
def test_ray_head_kernels_match_plain_versions(cuda, prior):
    import chip_smoke
    from implicit_depth_tpu_torch.ops import ray_head as rh

    ops, ct = chip_smoke.ray_inputs(b=2, n=100, s=13, prior=prior, dtype=torch.float32, seed=5)
    before = rh.ray_head_fwd.launches, rh.ray_head_bwd.launches
    with torch.no_grad():
        out = rh.ray_head_fwd(*ops)
        ref = rh.ray_head_reference(*ops)
    gk = rh.ray_head_bwd(ct, *ops[:-1])
    gr = rh.ray_head_bwd_reference(ct, *ops[:-1])
    torch.cuda.synchronize()
    assert (rh.ray_head_fwd.launches, rh.ray_head_bwd.launches) == (before[0] + 1, before[1] + 1)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=1e-5, rtol=1e-5)
    for name in gk._fields:
        a, r = getattr(gk, name), getattr(gr, name)
        if r is None:
            assert a is None
            continue
        err = (a.reshape(r.shape) - r).abs().max().item()
        assert err <= 1e-4 * r.abs().max().item() + 1e-6, name


WARP_SHAPES = {
    "small": dict(K=2, H=16, W=24, D=8),
    "ragged": dict(K=3, H=13, W=37, D=5),
}
BF16_ULP = 2.0 ** -7  # one bf16 ulp is at most 2^-7 of the value


def _warp_inputs(K, H, W, D, dtype, device, seed=0):
    """Source features, geometry with some samples behind the camera and
    out of frame (chip_smoke.warp_operands), and a cotangent."""
    import chip_smoke

    src, A, b, planes = chip_smoke.warp_operands(K, H, W, D, dtype, seed=seed, device=device)
    gen = torch.Generator().manual_seed(seed + 1)
    ct = torch.randn((K, D, H, W, 16), generator=gen).to(device, dtype)
    return src, A, b, planes, ct


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(WARP_SHAPES))
def test_warp_kernels_match_plain_versions(cuda, shape, dtype):
    from implicit_depth_tpu_torch.ops import warp_kernel as wk

    src, A, b, planes, ct = _warp_inputs(**WARP_SHAPES[shape], dtype=dtype, device=cuda)
    before = wk.warp_planes.launches, wk.warp_planes_bwd.launches
    out = wk.warp_planes(src, A, b, planes)
    ref = wk.warp_planes_reference(src, A, b, planes)
    g = wk.warp_planes_bwd(ct, A, b, planes)
    gref = wk.warp_planes_bwd_reference(ct, A, b, planes)
    torch.cuda.synchronize()
    assert (wk.warp_planes.launches, wk.warp_planes_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert out.dtype == dtype and g.dtype == dtype
    r, rg = ref.float().cpu().numpy(), gref.float().cpu().numpy()
    ulp = 0.0 if dtype == torch.float32 else BF16_ULP
    np.testing.assert_allclose(out.float().cpu().numpy(), r, atol=2e-4, rtol=1e-4 + ulp)
    np.testing.assert_allclose(g.float().cpu().numpy(), rg, atol=3e-4, rtol=1e-3 + ulp)


def test_warp_kernels_refuse_what_they_do_not_take(cuda):
    from implicit_depth_tpu_torch.ops import warp_kernel as wk

    src, A, b, planes, _ = _warp_inputs(2, 8, 12, 3, torch.float32, cuda)
    with pytest.raises(ValueError):
        wk.warp_planes(src[..., :8].contiguous(), A, b, planes)  # 8 channels
    with pytest.raises(ValueError):
        wk.warp_planes(src, A.cpu(), b, planes)


def test_plain_fused_volumes_run_no_warp_kernel(cuda):
    """The plain versions of kernels #1 and #2 are built on the gather
    sampler: running them launches neither warp kernel."""
    import chip_smoke
    from implicit_depth_tpu_torch.ops import fused_volume as fvm
    from implicit_depth_tpu_torch.ops import warp_kernel as wk

    ops = chip_smoke.volume_operands(B=1, K=2, H=8, W=12, D=5, dtype=torch.float32, seed=3)
    ct = torch.randn((1, 5, 8, 12), generator=torch.Generator().manual_seed(0)).to(cuda)
    before = wk.warp_planes.launches, wk.warp_planes_bwd.launches
    with torch.no_grad():
        fvm.fused_metadata_volume_reference(*ops)
    fvm.fused_metadata_volume_bwd_reference(ct, *ops[:14])
    torch.cuda.synchronize()
    assert (wk.warp_planes.launches, wk.warp_planes_bwd.launches) == before


def _tiny_depth_net():
    from implicit_depth_tpu_torch.models.depth_net import DepthNet
    from implicit_depth_tpu_torch.weights import init_params

    return init_params(DepthNet(image_encoder_name="tiny", num_src_views=2, num_depth_bins=8),
                       torch.Generator().manual_seed(0))


def _regression_batch(device, seed=0):
    from implicit_depth_tpu_torch.utils.fixtures import synthetic_bd_batch

    cur, src = synthetic_bd_batch(batch=2, num_src=2, height=64, width=96, num_rays=4,
                                  samples_per_ray=2, seed=seed)
    return ({k: torch.tensor(v, device=device) for k, v in cur.items()},
            {k: torch.tensor(v, device=device) for k, v in src.items()})


def test_depth_net_gpu_matches_cpu(cuda):
    """Tiny DepthNet, eval forward: the GPU (kernel #5) against the CPU
    (plain version), f32 with TF32 off; 1e-4 of the largest value."""
    from implicit_depth_tpu_torch.ops import warp_kernel as wk

    net = _tiny_depth_net().eval()
    with torch.no_grad():
        ref = net(*_regression_batch("cpu"))
        before = wk.warp_planes.launches
        got = net.to(cuda)(*_regression_batch(cuda))
    assert wk.warp_planes.launches == before + 1
    for key, r in ref.items():
        err = (got[key].cpu() - r).abs().max().item()
        assert err <= 1e-4 * r.abs().max().item(), key


def test_regression_train_step_gpu_matches_cpu(cuda):
    """One f32 regression train step of the tiny DepthNet, flip on: GPU
    (kernels #5, #6) against CPU (plain versions), held to chip_smoke.py's
    bounds for the same comparison at flagship width (MODEL_LOSS_REL,
    MODEL_GRAD_L2: f32 sums in other orders, LeakyReLU slope ties and the
    transpose's atomics, through the backward of ~40 layers; on the CPU the
    JAX package's own f32 step is 4e-2 per parameter from float64,
    tests/test_torch_regression_train.py)."""
    import copy

    import chip_smoke

    from implicit_depth_tpu_torch.ops import warp_kernel as wk
    from implicit_depth_tpu_torch.train import state

    net = _tiny_depth_net()
    runs = {}
    for dev in ("cpu", cuda):
        n = copy.deepcopy(net).to(dev)
        opt, sched = state.make_optimizer(n.parameters(), lr=1e-4, wd=1e-4)
        step = state.make_regression_train_step(n, opt, sched)
        before = wk.warp_planes.launches, wk.warp_planes_bwd.launches
        losses = step(_regression_batch(dev), flip=True)
        launched = (wk.warp_planes.launches - before[0], wk.warp_planes_bwd.launches - before[1])
        runs[str(dev)] = (float(losses["loss"]), launched,
                          {k: p.grad.detach().double().cpu() for k, p in n.named_parameters()})
    (l_cpu, n_cpu, g_cpu), (l_gpu, n_gpu, g_gpu) = runs["cpu"], runs[str(cuda)]
    assert n_cpu == (0, 0) and n_gpu == (1, 1)
    assert abs(l_gpu - l_cpu) <= chip_smoke.MODEL_LOSS_REL * abs(l_cpu)
    num = sum(((g_gpu[k] - g_cpu[k]) ** 2).sum().item() for k in g_cpu)
    den = sum((g ** 2).sum().item() for g in g_cpu.values())
    assert (num / den) ** 0.5 <= chip_smoke.MODEL_GRAD_L2, (num / den) ** 0.5
