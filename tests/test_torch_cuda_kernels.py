"""The CUDA kernels against their plain PyTorch versions, on the card: the
fused metadata volume forward (#1) and backward (#2), the ray-head forward
(#3) and backward (#4). The kernels are CUDA C++ for sm_90a and have no CPU
mode, so these tests skip without an NVIDIA GPU; chip_smoke.py runs the
same comparisons at the flagship shapes.

Tolerances: #1 atol 2e-3, rtol 1e-3 (f32 sums in another order; the JAX
package holds its TPU kernel to the same bound). #2 at a small ragged shape
atol 5e-3, rtol 5e-3 elementwise (tests/test_fused_volume.py:170-176;
measured ~1e-6: the shape is small enough that no LeakyReLU pre-activation
sits within rounding of 0). #3 atol 1e-5, rtol 1e-5 in f32; #4 1e-4 of
each cotangent's largest value (f32 sums in another order).
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
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=2e-3, rtol=1e-3)


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


def test_volume_backward_matches_plain_version(cuda):
    import chip_smoke
    from implicit_depth_tpu_torch.ops import fused_volume as fvm

    ops = chip_smoke.volume_operands(B=1, K=2, H=8, W=12, D=5, dtype=torch.float32, seed=3)[:14]
    ct = torch.randn((1, 5, 8, 12), generator=torch.Generator().manual_seed(0)).to(cuda)
    before = fvm.fused_metadata_volume_bwd.launches
    got = fvm.fused_metadata_volume_bwd(ct, *ops)
    ref = fvm.fused_metadata_volume_bwd_reference(ct, *ops)
    torch.cuda.synchronize()
    assert fvm.fused_metadata_volume_bwd.launches == before + 1
    for name in fvm.FusedVolumeCotangents._fields:
        np.testing.assert_allclose(getattr(got, name).cpu().numpy(), getattr(ref, name).cpu().numpy(),
                                   atol=5e-3, rtol=5e-3, err_msg=name)


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
