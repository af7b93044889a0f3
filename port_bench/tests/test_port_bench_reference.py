"""The benchmark's f32 reference against the port on the CPU, at a tiny
size and on the same seeded weights: both run plain PyTorch there (the
port's kernels dispatch CPU tensors to their plain versions), so the eval
answers and the training records agree to f32 rounding, as far as
AdamW's normalised steps let rounding stay small."""

import json

import pytest
import torch

from port_bench import harness, program

SMALL = dict(image_height=64, image_width=96, num_rays=32, samples_per_ray=8, precision=32)
SEED = 2**31 + 7


def regression_config() -> dict:
    return json.loads((harness.BENCH_DIR / "configs" / "regression.json").read_text())


@pytest.mark.parametrize("config", [{}, "regression"])
def test_eval_answers_match_the_port(config):
    """The eval driver on the BD model and on DepthNet (whose cells wait
    for a later benchmark entry: PERF.md section 7)."""
    config = regression_config() if config == "regression" else {}
    cell = harness.Cell("bd_eval_ar", config_overrides=dict(config, **SMALL),
                        mix_overrides=dict(ring=2, warmup_rings=0))
    drv = cell.driver().Driver(cell, SEED, torch.device("cpu"))
    drv.setup()
    drv.window(0.0)
    drv.release()
    gaps = drv.numbers(drv.reference_answers())
    assert gaps["max_gap"] < 1e-5, gaps


@pytest.mark.parametrize("config", [{}, "regression"])
def test_training_record_matches_the_port(config):
    """The training driver on the BD step and on the regression step."""
    config = regression_config() if config == "regression" else {}
    cell = harness.Cell("bd_train_b12", config_overrides=dict(config, **SMALL),
                        mix_overrides=dict(batch=2, ring=3))
    drv = cell.driver().Driver(cell, SEED, torch.device("cpu"))
    drv.setup()
    drv.release()
    ref = drv.reference_answers()
    gaps = drv.numbers(ref)
    # the first step's loss to f32 rounding; later steps move by Adam's
    # normalised update of gradients that differ in their last bits (the
    # port's written-out volume backward, autograd here)
    assert gaps["loss1_gap"] < 1e-5 and gaps["loss_gap"] < 1e-3, gaps
    assert gaps["grad_gap"] < 1e-3 and gaps["change_gap"] < 2e-2, gaps
    assert len(ref.losses) == 3 and len(ref.grad_norms) == len(ref.change_norms)


def test_weights_are_the_same_for_both_nets():
    from port_bench.reference.nets import build_reference

    cfg = harness.Cell("bd_eval_ar").config
    port, ref = program.build_net(cfg), build_reference(cfg)
    harness.init_weights(port, 5)
    harness.init_weights(ref, 5)
    a, b = port.state_dict(), ref.state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    harness.init_weights(ref, 6)
    assert not torch.equal(a["encoder.conv_stem.weight"], ref.state_dict()["encoder.conv_stem.weight"])


def test_fp8_control_rounds_products_only():
    from port_bench.reference.fp8 import Fp8Products, round_fp8

    x = torch.linspace(-3, 3, 101)
    q = round_fp8(x)
    assert 0 < (q - x).abs().max() <= 3 / 8 and float(q.abs().max()) == pytest.approx(3.0)
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    with Fp8Products():
        low = a @ b
        same = a + 1.0
    assert not torch.equal(low, a @ b) and torch.equal(same, a + 1.0)
    assert torch.allclose(low, round_fp8(a) @ round_fp8(b))
