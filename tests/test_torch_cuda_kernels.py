"""The CUDA kernels against their plain PyTorch versions, on the card: the
fused metadata volume forward (#1) and backward (#2), the ray-head forward
(#3) and backward (#4), the plane-sweep warp (#5) and its transpose (#6).
The kernels are CUDA C++ for sm_90a and have no CPU mode, so these tests
skip without an NVIDIA GPU; chip_smoke.py runs the same comparisons at the
main path's shapes.

Tolerances: #1 atol 2e-3, rtol 1e-3 (f32 sums in another order; the JAX
package holds its TPU kernel to the same bound). The bf16 #1 runs on the
tensor cores in work units of (128 pixels, 8 planes); its shapes here cover
fewer views than its shared-memory layout holds, tiles that cross from one
image into the next, and more units than twice the SMs, so that a block
walks several. In bf16 both sides of #1
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
each cotangent's largest value (f32 sums in another order). In bf16 #3 and
#4 and their plain versions round where the JAX kernel rounds; a straddled
rounding moves an element by about one bf16 ulp (ELU's derivative is
continuous), so they are held to chip_smoke.check_ray_bf16: at most 1e-3 of
the per-row elements outside four bf16 ulps, relative L2 1e-3 per output.
Its "multitile" shape has more tiles than twice the SMs, so that a block of
#4 carries dW1 in registers across tiles. #5 and #6 are
held to the JAX package's bounds for its warp kernels against the XLA
sampler (tests/test_warp_kernel.py): #5 atol 2e-4, rtol 1e-4, #6 atol
3e-4, rtol 1e-3. The sample coordinates are the same bits on both sides
(the kernels round them step by step, as the plain version does); the
bilinear blend rounds in another order, and #6 (a gather: one block owns
each source texel) adds a texel's contributions in another fixed order,
chunk by chunk of planes, then by cell and pixel. In bf16 one bf16 ulp (at most 2^-7 of the value) on
top: both versions round one f32 value to bf16, and the two may straddle a
rounding boundary. The warp cases include the eval shape with view 0's
camera centre on one output point (a sample at z's clamp lands in frame,
outside what the inverse homography reaches) and the extreme poses at
96x128, whose candidate boxes outgrow one stage of #6 on some planes.
The temporal slice (tiny models): the device vertex scorer on the card
equals the C++ sampling; the temporal eval's window loop with device
scoring gives the frame loop's maps and flips on the card, its maps within
1e-4 of the CPU's; a train step with the prior (#3/#4 with the prior)
against the CPU, held to chip_smoke.py's MODEL_* bounds.
The training infrastructure (tiny models): two ranks on the one card
(gloo, tests/torch_ddp_child.py) against one process on the card, batch
norm to 1e-5 and the BD and regression steps to the CPU test's bounds; fit on
the card resumed from its step-2 checkpoint against the uninterrupted run:
the same batches, and chip_smoke.py's fit-resume bounds.
The AR demo path (a tiny temporal model): run_inference with the prior fed
back on the card against the CPU, at chip_smoke.py's ar-inference bound.
The encoder zoo (`-k zoo`): forward_val of the BDNet with the resnet18d
encoder, the FPN matching encoder and the skip decoder (K=2, D=8, 64x96,
f32) on the card against the CPU, #1 once, within 1e-4 as the tiny BDNet.
The profilers' forward-only step (`-k forward_only`): its losses on the
card against the CPU at chip_smoke.py's MODEL_LOSS_REL, #1 once and #3
four times, the state bit-equal after it.
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


VOLUME_FWD_BF16_SHAPES = {
    "k3": dict(B=1, K=3, H=40, W=52, D=9),  # fewer views than the layout holds
    # 481 pixels an image: tiles of 128 cross from one image into the next
    "ragged7": dict(B=2, K=7, H=13, W=37, D=5),
    # 139 tiles x 3 plane groups (8, 8, 1) = 417 work units: more than two a
    # block on 132 SMs; the last tile and the last group are partial
    "multiunit7": dict(B=3, K=7, H=61, W=97, D=17),
}


@pytest.mark.parametrize("shape", sorted(VOLUME_FWD_BF16_SHAPES))
def test_volume_forward_bf16_matches_plain_version(cuda, shape):
    """The tensor-core forward (bf16) against its plain version, held to
    chip_smoke.check_volume's bf16 bounds."""
    import chip_smoke
    from implicit_depth_tpu_torch.ops import fused_volume as fvm

    dims = VOLUME_FWD_BF16_SHAPES[shape]
    ops = chip_smoke.volume_operands(**dims, dtype=torch.bfloat16, seed=3)
    before = fvm.fused_metadata_volume.launches
    with torch.no_grad():
        got = fvm.fused_metadata_volume(*ops)
        ref = fvm.fused_metadata_volume_reference(*ops)
    torch.cuda.synchronize()
    assert fvm.fused_metadata_volume.launches == before + 1
    chip_smoke.check_volume(f"{shape} bf16", got, ref, torch.bfloat16)
    if shape == "multiunit7":
        lib = fvm._library("fused_volume.cu")
        tiles = -(-dims["B"] * dims["H"] * dims["W"] // lib.fused_metadata_volume_tile())
        units = tiles * -(-dims["D"] // lib.fused_metadata_volume_plane_group())
        assert units > 2 * torch.cuda.get_device_properties(cuda).multi_processor_count


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_volume_forward_smem_budget_of_the_flagship(cuda, dtype):
    """Seven source views fit the shared-memory budget of each forward
    kernel, the f32 CUDA-core one and the bf16 tensor-core one; eight are
    more than either takes (the tensor-core layout holds seven, as the
    backward does), and the wrapper refuses them before a launch."""
    import chip_smoke
    from implicit_depth_tpu_torch.ops import fused_volume as fvm

    assert fvm.fwd_smem_bytes(7, dtype) <= fvm.SMEM_LIMIT
    ops = chip_smoke.volume_operands(B=1, K=8, H=8, W=12, D=2, dtype=dtype, seed=3)
    before = fvm.fused_metadata_volume.launches
    with pytest.raises(ValueError), torch.no_grad():
        fvm.fused_metadata_volume(*ops)
    assert fvm.fused_metadata_volume.launches == before


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


def test_zoo_forward_val_gpu_matches_cpu(cuda):
    from implicit_depth_tpu_torch.utils.fixtures import synthetic_bd_batch
    from implicit_depth_tpu_torch.models.bd_net import BDNet
    from implicit_depth_tpu_torch.ops.fused_volume import fused_metadata_volume
    from implicit_depth_tpu_torch.weights import init_params

    net = init_params(BDNet(image_encoder_name="resnet18d", matching_encoder_type="fpn",
                            depth_decoder_name="skip", num_src_views=2, num_depth_bins=8),
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


RAY_BF16_SHAPES = {
    "ragged": dict(b=2, n=100, s=13),  # 9 rays (117 rows) a tile: 11 pad rows in each
    # 450 tiles of 2 rays: more than two a block on 132 SMs, so that a block
    # carries dW1 and its column sums from one tile to the next
    "multitile": dict(b=3, n=300, s=64),
    # the BD step's scale-2 launch: 8,196 of the forward's 128-row tiles on
    # its 2 x 132 blocks
    "scale2": dict(b=12, n=1366, s=64),
    # the forward's 128-row tiles (and some warps' 16 rows) split rays; 394
    # tiles, so some of its 264 blocks walk two
    "splitrays": dict(b=3, n=700, s=24),
}


@pytest.mark.parametrize("prior", [False, True], ids=["noprior", "prior"])
@pytest.mark.parametrize("shape", sorted(RAY_BF16_SHAPES))
def test_ray_head_bf16_kernels_match_plain_versions(cuda, shape, prior):
    """bf16: #3 and the tensor-core #4 against the plain versions, which
    round where the JAX kernel rounds (chip_smoke.check_ray_bf16)."""
    import chip_smoke
    from implicit_depth_tpu_torch.ops import cuda_build
    from implicit_depth_tpu_torch.ops import ray_head as rh

    dims = RAY_BF16_SHAPES[shape]
    ops, ct = chip_smoke.ray_inputs(**dims, prior=prior, dtype=torch.bfloat16, seed=5)
    before = rh.ray_head_fwd.launches, rh.ray_head_bwd.launches
    with torch.no_grad():
        out = rh.ray_head_fwd(*ops)
        ref = rh.ray_head_reference(*ops)
    gk = rh.ray_head_bwd(ct, *ops[:-1])
    gr = rh.ray_head_bwd_reference(ct, *ops[:-1])
    torch.cuda.synchronize()
    assert (rh.ray_head_fwd.launches, rh.ray_head_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert out.dtype == torch.bfloat16 and (gk.dp is None) == (not prior)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if shape == "multitile":
        assert dims["b"] * dims["n"] // (128 // dims["s"]) > 2 * sms
    if shape in ("scale2", "splitrays"):  # the forward's blocks walk more than one tile
        rows = dims["b"] * dims["n"] * dims["s"]
        blocks = cuda_build.load("ray_head.cu", rh._SIGNATURES).ray_head_fwd_blocks(rows, sms, 1)
        assert rows // 128 > blocks == 2 * sms
    chip_smoke.check_ray_bf16(f"{shape} {prior}", chip_smoke.ray_outputs(out, gk),
                              chip_smoke.ray_outputs(ref, gr))


@pytest.mark.parametrize("prior", [False, True], ids=["noprior", "prior"])
def test_ray_head_bf16_forward_takes_long_rays(cuda, prior):
    """The tensor-core forward walks flat rows, so it takes S > 128, held to
    the forward's bounds of check_ray_bf16; the backward refuses that S."""
    import chip_smoke
    from implicit_depth_tpu_torch.ops import ray_head as rh

    ops, ct = chip_smoke.ray_inputs(b=1, n=7, s=200, prior=prior, dtype=torch.bfloat16, seed=5)
    before = rh.ray_head_fwd.launches, rh.ray_head_bwd.launches
    with torch.no_grad():
        out = rh.ray_head_fwd(*ops)
        ref = rh.ray_head_reference(*ops)
    torch.cuda.synchronize()
    chip_smoke.check_ray_bf16(f"S=200 {prior}", {"out": out}, {"out": ref})
    with pytest.raises(ValueError):
        rh.ray_head_bwd(ct, *ops[:-1])
    assert (rh.ray_head_fwd.launches, rh.ray_head_bwd.launches) == (before[0] + 1, before[1])


@pytest.mark.parametrize("shape", ["ragged", "splitrays"])
def test_ray_head_bf16_forward_gives_the_same_bits_twice(cuda, shape):
    import chip_smoke
    from implicit_depth_tpu_torch.ops import ray_head as rh

    ops, _ = chip_smoke.ray_inputs(**RAY_BF16_SHAPES[shape], prior=True, dtype=torch.bfloat16,
                                   seed=5)
    with torch.no_grad():
        a = rh.ray_head_fwd(*ops)
        b = rh.ray_head_fwd(*ops)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ray_head_backward_refuses_long_rays(cuda, dtype):
    """A backward tile holds 128 rows of whole rays: S = 129 is refused
    before a launch."""
    import chip_smoke
    from implicit_depth_tpu_torch.ops import ray_head as rh

    ops, ct = chip_smoke.ray_inputs(b=1, n=3, s=129, prior=False, dtype=dtype, seed=5)
    before = rh.ray_head_bwd.launches
    with pytest.raises(ValueError):
        rh.ray_head_bwd(ct, *ops[:-1])
    assert rh.ray_head_bwd.launches == before


WARP_SHAPES = {
    "small": dict(K=2, H=16, W=24, D=8),
    "ragged": dict(K=3, H=13, W=37, D=5),
    # view 0's camera centre on output point (u0, v0) at plane d0: z at its
    # clamp there, the sample in frame at (-0.5, -0.5)
    "at_centre": dict(K=2, H=40, W=56, D=8, at_centre=(20, 13, 4)),
    # turned views: on some planes a tile's candidate box outgrows one stage
    "extreme96x128": dict(K=3, H=96, W=128, D=8, extreme=True),
    # more planes than #6 computes boxes for at once (64)
    "manyplanes": dict(K=2, H=16, W=24, D=130),
}
BF16_ULP = 2.0 ** -7  # one bf16 ulp is at most 2^-7 of the value


def _warp_inputs(K, H, W, D, dtype, device, seed=0, **geo):
    """Source features, geometry with some samples behind the camera and
    out of frame (chip_smoke.warp_operands), and a cotangent."""
    import chip_smoke

    src, A, b, planes = chip_smoke.warp_operands(K, H, W, D, dtype, seed=seed, device=device,
                                                 **geo)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_warp_transpose_gives_the_same_bits_twice(cuda, dtype):
    """Each source texel is summed by one block in an order fixed by
    (chunk of planes, cell, pixel), so two launches agree bit for bit."""
    from implicit_depth_tpu_torch.ops import warp_kernel as wk

    for shape in ("at_centre", "extreme96x128"):
        _, A, b, planes, ct = _warp_inputs(**WARP_SHAPES[shape], dtype=dtype, device=cuda)
        first = wk.warp_planes_bwd(ct, A, b, planes)
        assert torch.equal(first, wk.warp_planes_bwd(ct, A, b, planes))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_warp_transpose_walks_wide_boxes_in_bands(cuda, dtype):
    """A homography that shrinks 1400 output columns into 14 source texels:
    the first tile's candidate box is wider than a chunk holds, so #6
    walks it in column bands."""
    from implicit_depth_tpu_torch.ops import warp_kernel as wk

    K, D, H, W = 1, 2, 4, 1400
    A = torch.diag(torch.tensor([0.01, 0.01, 1.0]))[None].to(cuda)
    b = torch.zeros((K, 3), device=cuda)
    planes = torch.tensor([1.0, 1.5], device=cuda)
    ct = torch.randn((K, D, H, W, 16), generator=torch.Generator().manual_seed(5)).to(cuda, dtype)
    g, gref = wk.warp_planes_bwd(ct, A, b, planes), wk.warp_planes_bwd_reference(ct, A, b, planes)
    ulp = 0.0 if dtype == torch.float32 else BF16_ULP
    assert float(gref.float().abs().max()) > 1.0  # the texels near x = 0 gather many pixels
    np.testing.assert_allclose(g.float().cpu().numpy(), gref.float().cpu().numpy(), atol=3e-4,
                               rtol=1e-3 + ulp)


def test_warp_transpose_layout_matches_the_mirror(cuda):
    """The tile of ops/warp_kernel.py::candidate_boxes (the mirror the CPU
    coverage test holds) is the kernel's, and its shared memory fits a block."""
    from implicit_depth_tpu_torch.ops import cuda_build
    from implicit_depth_tpu_torch.ops import warp_kernel as wk

    lib = cuda_build.load("warp_planes.cu", wk._SIGNATURES)
    assert (lib.warp_planes_bwd_tile_width(), lib.warp_planes_bwd_tile_height()) == wk.BWD_TILE
    assert 0 < lib.warp_planes_bwd_smem_bytes(1) <= cuda_build.SMEM_LIMIT
    assert 0 < lib.warp_planes_bwd_smem_bytes(0) <= cuda_build.SMEM_LIMIT


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
    MODEL_GRAD_L2: f32 sums in other orders and LeakyReLU slope ties,
    through the backward of ~40 layers; on the CPU the
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


# ------------------------------------------------------- the temporal slice

def _temporal_scene(tmp_path):
    from implicit_depth_tpu_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset(num_frames=9, num_views=3, split="val", get_bd_info=True,
                          image_height=64, image_width=96)
    return ds, SyntheticDataset.get_gt_mesh_path(str(tmp_path), "val", "scene0",
                                                 target_faces=20000)


def test_device_vertex_scorer_on_the_card_matches_cpp(cuda, tmp_path):
    """The scorer's per-frame values on the card equal the fused C++
    sampling (f32 elementwise ops in its order, IEEE division)."""
    from implicit_depth_tpu_torch.eval import rasterizer as ras
    from implicit_depth_tpu_torch.eval.vertex_scorer import DeviceVertexScorer

    ds, mesh = _temporal_scene(tmp_path)
    verts, faces = ras.load_ply(mesh)
    h, w = ds.depth_height, ds.depth_width
    scorer = DeviceVertexScorer(verts, h, w, cuda)
    rng = np.random.RandomState(0)
    for i in range(3):
        frame = ds.get_frame("scene0", i)
        T, K = frame["cam_T_world"], frame["K_s0"]
        pred = rng.rand(h, w).astype(np.float32)
        zbuf = ras.rasterize_mesh_depth(verts, faces, T, K, h, w)
        got = scorer.frame_values(*(torch.tensor(x, device=cuda) for x in (pred, zbuf, T, K)))
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      ras.sample_vertex_predictions(verts, faces, T, K, pred))


def test_temporal_eval_on_the_card(cuda, tmp_path):
    """Tiny temporal BDNet, 7 frames in windows of 3: on the card the window
    loop with device scoring gives the frame loop's maps (equal: the same
    forwards in the same order) and flips; #1 launches once a frame; the
    card's maps are within 1e-4 of the CPU's (plain versions)."""
    from implicit_depth_tpu_torch.eval.temporal_driver import evaluate_temporal
    from implicit_depth_tpu_torch.models.bd_net import BDNet
    from implicit_depth_tpu_torch.ops.fused_volume import fused_metadata_volume
    from implicit_depth_tpu_torch.weights import init_params

    ds, mesh = _temporal_scene(tmp_path)
    net = init_params(BDNet(image_encoder_name="tiny", num_src_views=2, num_depth_bins=8,
                            use_prior=True), torch.Generator().manual_seed(0)).eval()
    kw = dict(eval_length=3, warmup=1, frame_multiplier=2, height=ds.depth_height,
              width=ds.depth_width, max_frames_per_scene=7, collect_preds=True)
    cpu = evaluate_temporal(net, {"scene0": ds}, {"scene0": mesh}, **kw)
    net = net.to(cuda)
    before = fused_metadata_volume.launches
    frame = evaluate_temporal(net, {"scene0": ds}, {"scene0": mesh}, **kw)
    assert fused_metadata_volume.launches == before + 7
    window = evaluate_temporal(net, {"scene0": ds}, {"scene0": mesh}, use_scan=True,
                               device_scoring=True, **kw)
    for a, b, c in zip(window["preds"], frame["preds"], cpu["preds"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(b, c, rtol=0, atol=1e-4)
    assert (window["total_diffs"], window["total_verts"]) == (frame["total_diffs"],
                                                              frame["total_verts"])
    assert np.isfinite(frame["temporal_score"]) and frame["total_verts"] > 0


def test_prior_train_step_gpu_matches_cpu(cuda):
    """One f32 BD step of the tiny temporal BDNet, flip on, the same
    augmentation draws on both devices: the GPU (#1-#4, #3/#4 with the
    prior) against the CPU, held to chip_smoke.py's MODEL_* bounds."""
    import copy

    import chip_smoke

    from implicit_depth_tpu_torch.models.bd_net import BDNet, draw_prior_noise
    from implicit_depth_tpu_torch.ops import ray_head as rh
    from implicit_depth_tpu_torch.train import state
    from implicit_depth_tpu_torch.utils.fixtures import synthetic_bd_batch
    from implicit_depth_tpu_torch.weights import init_params

    net = init_params(BDNet(image_encoder_name="tiny", num_src_views=2, num_depth_bins=8,
                            use_prior=True), torch.Generator().manual_seed(0))
    cur, src = synthetic_bd_batch(batch=2, num_src=2, height=64, width=96, num_rays=64,
                                  samples_per_ray=8, seed=1)
    noise = draw_prior_noise(cur["sampled_depths"].shape, torch.float32,
                             torch.Generator(device=cuda).manual_seed(2))
    runs = {}
    for dev in ("cpu", cuda):
        n = copy.deepcopy(net).to(dev)
        opt, sched = state.make_optimizer(n.parameters(), lr=1e-4, wd=1e-4)
        step = state.make_bd_train_step(n, opt, sched)
        before = rh.ray_head_fwd.prior_launches, rh.ray_head_bwd.prior_launches
        losses = step(({k: torch.tensor(v, device=dev) for k, v in cur.items()},
                       {k: torch.tensor(v, device=dev) for k, v in src.items()}), flip=True,
                      prior_noise=[tuple(u.to(dev) for u in pair) for pair in noise])
        launched = (rh.ray_head_fwd.prior_launches - before[0],
                    rh.ray_head_bwd.prior_launches - before[1])
        runs[str(dev)] = (float(losses["loss"]), launched,
                          {k: p.grad.detach().double().cpu() for k, p in n.named_parameters()})
    (l_cpu, n_cpu, g_cpu), (l_gpu, n_gpu, g_gpu) = runs["cpu"], runs[str(cuda)]
    assert n_cpu == (0, 0) and n_gpu == (4, 4)
    assert abs(l_gpu - l_cpu) <= chip_smoke.MODEL_LOSS_REL * abs(l_cpu)
    num = sum(((g_gpu[k] - g_cpu[k]) ** 2).sum().item() for k in g_cpu)
    den = sum((g ** 2).sum().item() for g in g_cpu.values())
    assert (num / den) ** 0.5 <= chip_smoke.MODEL_GRAD_L2, (num / den) ** 0.5


def test_forward_only_probe_on_the_card_matches_cpu(cuda):
    """make_bd_train_step(forward_only=True) of the tiny BDNet in f32, flip
    on: the losses on the card (#1 once, #3 four times, no backward
    kernel) against the CPU, held to chip_smoke.py's MODEL_LOSS_REL, and
    the card's net and AdamW state bit-equal after the probe."""
    import copy

    import chip_smoke

    from implicit_depth_tpu_torch.models.bd_net import BDNet
    from implicit_depth_tpu_torch.ops.bounds import launch_counts
    from implicit_depth_tpu_torch.train import state
    from implicit_depth_tpu_torch.utils.fixtures import synthetic_bd_batch
    from implicit_depth_tpu_torch.weights import init_params

    net = init_params(BDNet(image_encoder_name="tiny", num_src_views=2, num_depth_bins=8),
                      torch.Generator().manual_seed(0))
    cur, src = synthetic_bd_batch(batch=2, num_src=2, height=64, width=96, num_rays=64,
                                  samples_per_ray=8, seed=1)
    losses = {}
    for dev in ("cpu", cuda):
        n = copy.deepcopy(net).to(dev)
        opt, sched = state.make_optimizer(n.parameters(), lr=1e-4, wd=1e-4)
        batch = ({k: torch.tensor(v, device=dev) for k, v in cur.items()},
                 {k: torch.tensor(v, device=dev) for k, v in src.items()})
        state.make_bd_train_step(n, opt, sched)(batch)  # AdamW holds moments now
        before = {k: v.clone() for k, v in n.state_dict().items()}
        opt_before = copy.deepcopy(opt.state_dict())
        launched = launch_counts()
        losses[str(dev)] = state.make_bd_train_step(n, opt, sched, forward_only=True)(
            batch, flip=True)
        launched = tuple(b - a for a, b in zip(launched, launch_counts()))
        assert launched == ((1, 0, 4, 0, 0, 0) if dev == cuda else (0,) * 6)
        assert all(torch.equal(v, n.state_dict()[k]) for k, v in before.items())
        after = opt.state_dict()["state"]
        assert all(torch.equal(v, after[i][k]) for i, st in opt_before["state"].items()
                   for k, v in st.items())
    for k, ref in losses["cpu"].items():
        got = losses[str(cuda)][k].cpu()
        assert abs(got - ref) <= chip_smoke.MODEL_LOSS_REL * abs(ref) + 1e-7, (k, got, ref)


def _ddp_child():
    """tests/torch_ddp_child.py, loaded by its path (another package named
    `tests` may come first on the path)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_ddp_child.py")
    spec = importlib.util.spec_from_file_location("torch_ddp_child", path)
    child = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(child)
    return child


def _ddp_inputs(child):
    """Global batch of 4 and seeded tiny models for tests/torch_ddp_child.py,
    made with the port alone (the card's machine has no JAX)."""
    from implicit_depth_tpu_torch.models.bd_net import BDNet
    from implicit_depth_tpu_torch.models.depth_net import DepthNet
    from implicit_depth_tpu_torch.utils.fixtures import synthetic_bd_batch
    from implicit_depth_tpu_torch.weights import init_params

    bd = synthetic_bd_batch(batch=4, num_src=child.K, height=64, width=96, num_planes=3,
                            num_rays=64, samples_per_ray=8, seed=0)
    cur, src = synthetic_bd_batch(batch=4, num_src=child.K, height=64, width=96, num_rays=4,
                                  samples_per_ray=2, seed=0)
    cur["depth"][0, :5, :7] = np.nan
    cur["mask"] = np.isfinite(cur["depth"])
    reg = ({k: v for k, v in cur.items()
            if k not in ("gt_depth", "sampled_rays", "sampled_depths")}, src)
    state_dicts = {}
    for case, (model, _, prior) in child.STEP_CASES.items():
        net = (BDNet(num_src_views=child.K, num_depth_bins=child.D_BINS, image_encoder_name="tiny",
                     use_prior=prior) if model == "bd" else
               DepthNet(num_src_views=child.K, num_depth_bins=child.D_BINS,
                        image_encoder_name="tiny"))
        state_dicts[case] = init_params(net, torch.Generator().manual_seed(3)).state_dict()
    rng = np.random.RandomState(4)
    return {"cases": ["bn"] + list(child.STEP_CASES), "seed": 7,
            "batches": {"bd": bd, "regression": reg}, "state_dicts": state_dicts,
            "bn_x": torch.tensor(rng.randn(4, 8, 5, 6).astype(np.float32) * 2 + 1),
            "bn_w": torch.tensor(rng.randn(4, 8, 5, 6).astype(np.float32))}


def test_two_rank_step_on_the_card_matches_one_process(cuda, tmp_path):
    """Two ranks on the one card (gloo), each on 2 rows of a global batch of
    4, against one process on the card on the whole batch: batch norm's
    outputs 1e-5 of the largest value; BD steps (flip off and on, and with
    the prior drawn for the global batch) and a regression step: losses
    within chip_smoke.py's MODEL_LOSS_REL, gradients to the bounds of the
    CPU test (torch_ddp_child.assert_grads_agree; kernels #1-#6 on both
    sides)."""
    import os
    import socket
    import subprocess
    import sys

    import chip_smoke

    child = _ddp_child()
    inputs = _ddp_inputs(child)
    path = str(tmp_path / "inputs.pt")
    torch.save(inputs, path)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, os.path.join(repo, "tests", "torch_ddp_child.py"),
                               str(r), "2", str(port), path, str(tmp_path / f"r{r}.pt"), "cuda"],
                              cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        errs = [p.communicate(timeout=600)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], errs
    ranks = [torch.load(str(tmp_path / f"r{r}.pt"), weights_only=False) for r in range(2)]
    one = {case: child.run_case(case, inputs, "cuda") for case in inputs["cases"]}
    y = torch.cat([r["bn"]["y"] for r in ranks])
    assert (y - one["bn"]["y"]).abs().max() <= 1e-5 * one["bn"]["y"].abs().max()
    for case in child.STEP_CASES:
        got, ref = ranks[0][case], one[case]
        assert got["losses"] == ranks[1][case]["losses"]
        for k, v in ref["losses"].items():
            assert abs(got["losses"][k] - v) <= chip_smoke.MODEL_LOSS_REL * abs(v), (case, k)
        child.assert_grads_agree(got["grads"], ref["grads"])


def test_fit_resume_on_the_card(cuda, tmp_path):
    """fit on the card (tiny synthetic config, flip pinned) for 4 steps, then
    twice resumed from its step-2 checkpoint: the same batches at steps 3-4,
    the step-3 loss within chip_smoke.py's MODEL_LOSS_REL, the final
    parameters within MODEL_GRAD_L2, and the parameter updates of steps 3-4
    within the two resumed runs' spread times chip_smoke.RESUME_SPREAD (the
    card's backward sums in no fixed order; bit-equal on the CPU,
    tests/test_torch_checkpoint.py)."""
    import hashlib
    import os

    import chip_smoke

    from implicit_depth_tpu_torch.config import parse_config
    from implicit_depth_tpu_torch.train.loop import fit

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    flags = ["--config_file", os.path.join(repo, "configs/models/implicit_depth.yaml"),
             "--data_config_file", os.path.join(repo, "configs/data/synthetic_smoke.yaml"),
             "--image_encoder_name", "tiny", "--precision", "32", "--num_workers", "2",
             "--log_interval", "1", "--val_interval", "2", "--val_batches", "1",
             "--synthetic_num_frames", "10", "--lazy_load_weights_from_checkpoint", "",
             "--log_dir", str(tmp_path)]
    runs = {}
    ck2 = str(tmp_path / "full" / "checkpoints" / "ckpt_00000002")
    for name, extra in (("full", []), ("resumed", ["--resume", ck2]), ("again", ["--resume", ck2])):
        digests, losses = {}, {}

        def on_batch(step, batch, digests=digests):
            digests[step] = hashlib.sha256(b"".join(
                np.ascontiguousarray(part[k]).tobytes() for part in batch for k in sorted(part)
                if k != "frame_id_string")).hexdigest()

        def on_log(step, scalars, losses=losses):
            if "train/loss" in scalars:
                losses[step] = scalars["train/loss"]

        cfg, _ = parse_config(flags + ["--name", name] + extra)
        res = fit(cfg, "bd", device="cuda", max_steps=4, log_cb=on_log, batch_cb=on_batch,
                  train_flip=False)
        runs[name] = (res, digests, losses)
    (full, fd, fl), (resumed, rd, rl) = runs["full"], runs["resumed"]
    assert sorted(rd) == [3, 4] and all(rd[s] == fd[s] for s in (3, 4))
    assert abs(rl[3] - fl[3]) <= chip_smoke.MODEL_LOSS_REL * abs(fl[3])
    models = [torch.load(os.path.join(p, "state.pt"), weights_only=True)["model"]
              for p in [ck2] + [runs[k][0]["checkpoint"] for k in ("full", "resumed", "again")]]
    names = [k for k, v in models[0].items() if v.is_floating_point()]
    final_l2, _ = chip_smoke._grad_agreement({k: models[2][k] for k in names},
                                             {k: models[1][k] for k in names})
    assert final_l2 <= chip_smoke.MODEL_GRAD_L2
    upd = [{k: m[k].double() - models[0][k].double() for k in names} for m in models[1:]]
    upd = [{k: v for k, v in u.items() if upd[0][k].abs().max() > 0} for u in upd]
    got, spread = (chip_smoke._grad_agreement(upd[1], upd[0]),
                   chip_smoke._grad_agreement(upd[2], upd[1]))
    k = chip_smoke.RESUME_SPREAD
    assert got[0] <= max(chip_smoke.MODEL_GRAD_L2, k * spread[0]), (got, spread)
    assert got[1][0] <= max(chip_smoke.MODEL_GRAD_LEAF, k * spread[1][0]), (got, spread)


def test_ar_inference_with_the_prior_on_the_card_matches_cpu(cuda, tmp_path):
    """Tiny temporal BDNet, run_inference with the prior over 3 chained
    frames with hole-filled rendered depths: #1 launches once per frame on
    the card, and the card's mattes match the CPU's (plain versions) at
    chip_smoke.py's AR_SHARE of the pixels within AR_ATOL (the prior is
    sampled nearest; see there)."""
    import chip_smoke
    from implicit_depth_tpu_torch.data.synthetic import SyntheticDataset
    from implicit_depth_tpu_torch.models.bd_net import BDNet
    from implicit_depth_tpu_torch.weights import init_params

    ds = SyntheticDataset(num_frames=5, num_views=3, split="val", get_bd_info=True,
                          image_height=64, image_width=96, pass_frame_id=True)
    renders = chip_smoke.write_rendered_depths(str(tmp_path / "renders"), ["2", "3", "4"],
                                               ds.depth_height, ds.depth_width)
    net = init_params(BDNet(image_encoder_name="tiny", num_src_views=2, num_depth_bins=8,
                            use_prior=True), torch.Generator().manual_seed(0)).eval()
    res = chip_smoke.ar_gpu_vs_cpu(net, ds, renders, str(tmp_path / "out"), 3)
    assert res["launches"] == 3
    assert res["share"] >= chip_smoke.AR_SHARE, res
