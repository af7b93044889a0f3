"""The fused metadata-volume CUDA kernel against its plain PyTorch version,
on the card. The kernel is CUDA C++ for sm_90a and has no CPU mode, so
these tests skip without an NVIDIA GPU; chip_smoke.py runs the same
comparison at the flagship shape.

Tolerance: atol 2e-3, rtol 1e-3 (f32 sums in another order; the JAX
package holds its TPU kernel to the same bound).
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
    from implicit_depth_tpu.utils.fixtures import synthetic_bd_batch
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
