"""The eval batch norm's cached scale and shift (models/matching.py::BatchNorm).

With grad disabled, eval BN takes its per-channel scale and shift from a
one-entry cache; with grad enabled it computes them as it always did. The
two must give the same tensors bit for bit, the cache must follow every
change of the weights, the grad path must still reach weight and bias, and
a warm call must dispatch only the two operations on the activation (the
frame's launch count rests on it). BN_EVAL_AFFINE counts hits and misses.
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from implicit_depth_tpu_torch.models.image_encoders import EfficientNetV2S
from implicit_depth_tpu_torch.models.matching import BatchNorm, ResnetMatchingEncoder
from implicit_depth_tpu_torch.utils.profiling import BN_EVAL_AFFINE

C = 24


def _randomize_bn(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Draws every BatchNorm's weight, bias and running statistics, so that
    the affine is no identity."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.numel()
                m.weight.copy_(torch.rand(n, generator=g) + 0.5)
                m.bias.copy_(torch.randn(n, generator=g))
                m.running_mean.copy_(torch.randn(n, generator=g))
                m.running_var.copy_(torch.rand(n, generator=g) * 2.0 + 0.1)
    return module


class _Encoders(torch.nn.Module):
    """The AR frame's two BN stacks on one image."""

    def __init__(self):
        super().__init__()
        self.encoder = EfficientNetV2S()
        self.matching = ResnetMatchingEncoder()

    def forward(self, x):
        return list(self.encoder(x)) + [self.matching(x)]


def _build(kind: str, dtype: torch.dtype) -> tuple:
    g = torch.Generator().manual_seed(3)
    if kind == "bn":
        module, x = BatchNorm(C), torch.randn(2, C, 5, 7, generator=g)
    else:
        module, x = _Encoders(), torch.randn(1, 3, 32, 48, generator=g)
    module = _randomize_bn(module, seed=4).eval().to(dtype)
    return module, x.to(dtype)


def _n_bn(module: torch.nn.Module) -> int:
    return sum(isinstance(m, BatchNorm) for m in module.modules())


def _outputs(out) -> list:
    return [t.detach() for t in (out if isinstance(out, list) else [out])]


def _uncached(module, x) -> list:
    """Eval with grad enabled: the path that computes the affine each call."""
    with torch.enable_grad():
        return _outputs(module(x))


def _cached(module, x) -> list:
    with torch.inference_mode():
        return _outputs(module(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["bn", "encoders"])
def test_warm_cache_gives_the_uncached_output(kind, dtype):
    module, x = _build(kind, dtype)
    n = _n_bn(module)
    ref = _uncached(module, x)
    before = dict(BN_EVAL_AFFINE)
    cold = _cached(module, x)
    assert BN_EVAL_AFFINE["misses"] - before["misses"] == n
    warm = _cached(module, x)
    assert BN_EVAL_AFFINE["hits"] - before["hits"] == n
    assert BN_EVAL_AFFINE["misses"] - before["misses"] == n
    for r, c, w in zip(ref, cold, warm, strict=True):
        assert r.dtype == dtype
        assert torch.equal(c, r)
        assert torch.equal(w, r)


def _adamw_step(bn, x):
    opt = torch.optim.AdamW(bn.parameters(), lr=0.1)
    with torch.enable_grad():
        bn(x).square().sum().backward()
    opt.step()
    return x


def _load_state_dict(bn, x):
    bn.load_state_dict(_randomize_bn(BatchNorm(C), seed=9).state_dict())
    return x


def _train_forward(bn, x):
    bn.train()
    bn(x * 2.0 + 1.0)
    bn.eval()
    return x


def _to_bf16(bn, x):
    bn.to(torch.bfloat16)
    return x.to(torch.bfloat16)


CHANGES = {"adamw_step": _adamw_step, "load_state_dict": _load_state_dict,
           "train_forward": _train_forward, "to_bf16": _to_bf16}


@pytest.mark.parametrize("change", list(CHANGES))
def test_cache_is_rebuilt_after_the_weights_change(change):
    bn, x = _build("bn", torch.float32)
    _cached(bn, x)
    (stale,) = _cached(bn, x)
    x = CHANGES[change](bn, x)
    before = dict(BN_EVAL_AFFINE)
    (got,) = _cached(bn, x)
    assert BN_EVAL_AFFINE["misses"] - before["misses"] == 1
    assert BN_EVAL_AFFINE["hits"] == before["hits"]
    (ref,) = _uncached(bn, x)
    assert torch.equal(got, ref)
    assert not torch.equal(got.float(), stale)
    (again,) = _cached(bn, x)
    assert BN_EVAL_AFFINE["hits"] - before["hits"] == 1
    assert torch.equal(again, ref)


def test_eval_with_grad_reaches_weight_and_bias():
    bn, x = _build("bn", torch.float32)
    _cached(bn, x)
    before = dict(BN_EVAL_AFFINE)
    bn(x).square().sum().backward()
    assert BN_EVAL_AFFINE == before
    for p in (bn.weight, bn.bias):
        assert p.grad is not None
        assert p.grad.abs().sum() > 0


def test_counter_counts_a_miss_then_hits():
    bn, x = _build("bn", torch.float32)
    before = dict(BN_EVAL_AFFINE)
    with torch.no_grad():
        bn(x)
    assert (BN_EVAL_AFFINE["misses"] - before["misses"], BN_EVAL_AFFINE["hits"] - before["hits"]) \
        == (1, 0)
    for _ in range(3):
        _cached(bn, x)
    assert (BN_EVAL_AFFINE["misses"] - before["misses"], BN_EVAL_AFFINE["hits"] - before["hits"]) \
        == (1, 3)


def test_inference_tensor_weights_take_the_uncached_path():
    """Inference tensors have no version counter: no cache, no count."""
    with torch.inference_mode():
        bn, x = _build("bn", torch.float32)
        before = dict(BN_EVAL_AFFINE)
        first, second = bn(x), bn(x)
    assert BN_EVAL_AFFINE == before
    with torch.no_grad():
        ref = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        ref = x * ref[:, None, None] + (bn.bias - bn.running_mean * ref)[:, None, None]
    assert torch.equal(first, second)
    torch.testing.assert_close(first, ref)


class _Ops(TorchDispatchMode):
    """Names the aten operations dispatched inside it that are no views."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.names.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_warm_call_dispatches_only_the_two_activation_ops(dtype):
    bn, x = _build("bn", dtype)
    _cached(bn, x)
    with torch.inference_mode(), _Ops() as ops:
        bn(x)
    assert ops.names == ["mul", "add"]
