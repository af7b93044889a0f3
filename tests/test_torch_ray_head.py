"""Port parity: the ray-head MLP (ops/ray_head.py) and
BinaryMLPNetwork.factored.

- bf16, excess precision off: the plain versions against the JAX package's
  `ray_head_mlp(..., interpret=True)` and `jax.grad`, run in a subprocess
  under XLA_FLAGS=--xla_allow_excess_precision=false (XLA reads the flag
  when its CPU backend starts, and this process has started it). Under the
  default flag XLA drops some of the kernel's bf16 roundings, differently
  per consumer, so no faithful port can match it there. With the flag off
  the rounding points decide the match: the logits and dd equal the
  kernel's, dp but for one element in 3200 one bf16 ulp off (an f32 sum in
  another order straddles a rounding), so the bound is 1e-3 of the elements
  off, by one ulp at most; dfp (after its bf16 cast) and the weight
  gradients are within 1e-4 relative L2 (measured <= 4.4e-5). The all-f32
  chain misses every bound (4e-3 to 1e-2 relative L2, every logit off).
- bf16, default flags: the same comparison in this process, bounded at what
  is measured (logits atol 2e-2, measured 1.6e-2, one bf16 ulp at 2-4;
  gradients 1.5e-2 of each gradient's largest value, measured <= 9.2e-3).
- The plain version against the JAX XLA chain in f32: 1e-5 of the largest
  value (f32 sums in another order). The written-out f32 backward against
  autograd of the f32 forward: 1e-5.
- `factored` against the JAX package's BinaryMLPNetwork.factored
  (use_pallas=False) in f32, at 1e-5.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_depth_tpu.models.decoders import BinaryMLPNetwork as JBinaryMLP
from implicit_depth_tpu.ops import ray_head as jrh
from implicit_depth_tpu_torch.models.decoders import BinaryMLPNetwork
from implicit_depth_tpu_torch.ops import ray_head
from tests.torch_parity import assert_close, bridged, seeded_variables

F = 128
NAMES = ("fp", "depths", "prior", "k0d", "k0p", "w1", "b1", "w2", "b2")


def make_inputs(b, n, s, seed=0):
    rng = np.random.RandomState(seed)
    return dict(fp=rng.randn(b, n, F).astype(np.float32), depths=(rng.rand(b, n, s) * 5).astype(np.float32),
                prior=rng.rand(b, n, s).astype(np.float32),
                k0d=(rng.randn(F) * 0.1).astype(np.float32), k0p=(rng.randn(F) * 0.1).astype(np.float32),
                w1=(rng.randn(F, F) * 0.1).astype(np.float32), b1=(rng.randn(F) * 0.1).astype(np.float32),
                w2=(rng.randn(F, 1) * 0.1).astype(np.float32), b2=np.asarray([0.3], np.float32))


def xla_chain(fp, d, p, k0d, k0p, w1, b1, w2, b2):
    h = fp[:, :, None, :] + d[..., None] * k0d
    if p is not None:
        h = h + p[..., None] * k0p
    h = jax.nn.elu(h)
    h = jax.nn.elu(h @ w1 + b1)
    return (h @ w2 + b2)[..., 0]


def torch_args(x, use_prior, dtype=torch.float32):
    """Leaf tensors of the inputs, fp/depths/prior in `dtype`."""
    args = {k: torch.tensor(v).to(dtype if k in LOW else torch.float32).requires_grad_(True)
            for k, v in x.items()}
    if not use_prior:
        args["prior"] = args["k0p"] = None
    return args


def weights(ct):
    return np.cos(np.arange(ct.size, dtype=np.float32)).reshape(ct.shape)


LOW = ("fp", "depths", "prior")  # the operands that take the compute dtype
BF16_ULP = 2.0 ** -7  # one bf16 ulp is at most 2^-7 of the value
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The JAX kernel and jax.grad of it with bf16 operands, in a fresh process
# under the XLA flags it is given: argv[1] holds the inputs and ct, argv[2]
# receives "{prior|noprior}/{out|name}" in f32.
_JAX_BF16 = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from implicit_depth_tpu.ops import ray_head as jrh

NAMES = ("fp", "depths", "prior", "k0d", "k0p", "w1", "b1", "w2", "b2")
x = dict(np.load(sys.argv[1]))
ct = x.pop("ct")
res = {}
for use_prior in (True, False):
    tag = "prior" if use_prior else "noprior"
    j = {k: jnp.asarray(v).astype(jnp.bfloat16 if k in ("fp", "depths", "prior") else v.dtype)
         for k, v in x.items()}
    if not use_prior:
        j["prior"] = j["k0p"] = None
    diff = ["fp", "depths", "k0d", "w1", "b1", "w2", "b2"] + (["prior", "k0p"] if use_prior else [])

    def loss(d):
        a = dict(j, **d)
        out = jrh.ray_head_mlp(*(a[k] for k in NAMES), interpret=True)
        return jnp.sum(out.astype(jnp.float32) * ct)

    res[tag + "/out"] = np.asarray(jrh.ray_head_mlp(*(j[k] for k in NAMES), interpret=True),
                                   np.float32)
    for k, g in jax.grad(loss)({k: j[k] for k in diff}).items():
        res[f"{tag}/{k}"] = np.asarray(g, np.float32)
np.savez(sys.argv[2], **res)
"""


@pytest.fixture(scope="module")
def strict_jax_bf16(tmp_path_factory):
    """(inputs, ct, JAX results) with excess precision off."""
    d = tmp_path_factory.mktemp("ray_head_bf16")
    x = make_inputs(2, 100, 16, seed=1)
    ct = weights(np.zeros((2, 100, 16), np.float32))
    np.savez(d / "in.npz", ct=ct, **x)
    flags = os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false"
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags.strip())
    proc = subprocess.run([sys.executable, "-c", _JAX_BF16, str(d / "in.npz"), str(d / "out.npz")],
                          env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return x, ct, dict(np.load(d / "out.npz"))


def port_bf16(x, ct, use_prior, dtype):
    """The plain forward and backward on fp/depths/prior rounded to bf16
    and computed in `dtype` (bf16: the rounding chain; f32: the f32 chain
    on the same values): {name: f32 array} keyed as the JAX results,
    cotangents of fp/depths/prior cast to `dtype` as the autograd Function
    does."""
    args = torch_args(x, use_prior, torch.bfloat16)
    args = {k: None if v is None else v.detach().to(dtype if k in LOW else torch.float32)
            for k, v in args.items()}
    out = ray_head.ray_head_reference(*(args[k] for k in NAMES))
    g = ray_head.ray_head_bwd_reference(torch.tensor(ct).bfloat16().to(dtype),
                                        *(args[k] for k in NAMES[:-1]))
    res = {"out": out, "fp": g.dfp.to(dtype), "depths": g.dd.to(dtype), "k0d": g.dk0d,
           "w1": g.dw1, "b1": g.db1, "w2": g.dw2, "b2": g.db2}
    if use_prior:
        res.update(prior=g.dp.to(dtype), k0p=g.dk0p)
    return {k: v.float().numpy() for k, v in res.items()}


def strict_misses(got, ref) -> list:
    """The names where `got` misses the excess-precision-off bounds: the
    logits, dd and dp equal but for at most 1e-3 of the elements, each
    within one bf16 ulp; dfp and the weight gradients within 1e-4 relative
    L2."""
    misses = []
    for k, r in ref.items():
        a = got[k].reshape(r.shape)
        if k in ("out", "depths", "prior"):
            d = np.abs(a - r)
            ok = (d <= BF16_ULP * np.abs(r)).all() and (d > 0).mean() <= 1e-3
        else:
            ok = np.linalg.norm(a - r) <= 1e-4 * np.linalg.norm(r)
        if not ok:
            misses.append(k)
    return misses


@pytest.mark.parametrize("use_prior", [True, False], ids=["prior", "noprior"])
def test_bf16_plain_versions_match_jax_kernel_without_excess_precision(strict_jax_bf16,
                                                                        use_prior):
    x, ct, jax_res = strict_jax_bf16
    tag = "prior" if use_prior else "noprior"
    ref = {k.split("/")[1]: v for k, v in jax_res.items() if k.startswith(tag + "/")}
    got = port_bf16(x, ct, use_prior, torch.bfloat16)
    assert strict_misses(got, ref) == []
    # the f32 chain on the same bf16 values misses every bound but db2's
    # (a plain sum of the cotangent)
    assert sorted(strict_misses(port_bf16(x, ct, use_prior, torch.float32), ref)) == sorted(
        k for k in ref if k != "b2")


@pytest.mark.parametrize("use_prior", [True, False], ids=["prior", "noprior"])
def test_plain_version_matches_jax_kernel(use_prior):
    """bf16 under the default XLA flags, in this process."""
    x = make_inputs(2, 100, 16, seed=1)
    ct = weights(np.zeros((2, 100, 16), np.float32))
    args = torch_args(x, use_prior, torch.bfloat16)
    got = ray_head.ray_head_mlp(*(args[k] for k in NAMES))
    (got.float() * torch.tensor(ct)).sum().backward()

    jargs = {k: jnp.asarray(v).astype(jnp.bfloat16 if k in LOW else jnp.float32)
             for k, v in x.items()}
    if not use_prior:
        jargs["prior"] = jargs["k0p"] = None
    ref = jrh.ray_head_mlp(*(jargs[k] for k in NAMES), interpret=True)
    assert got.shape == ref.shape == (2, 100, 16) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(ref, np.float32),
                               atol=2e-2)

    diff = ["fp", "depths", "k0d", "w1", "b1", "w2", "b2"] + (["prior", "k0p"] if use_prior else [])

    def loss(d):
        a = dict(jargs, **d)
        return jnp.sum(jrh.ray_head_mlp(*(a[k] for k in NAMES), interpret=True).astype(jnp.float32) * ct)

    jg = jax.grad(loss)({k: jargs[k] for k in diff})
    for k in diff:
        assert_close(args[k].grad.float(), np.asarray(jg[k], np.float32), 1.5e-2)


@pytest.mark.parametrize("use_prior", [True, False], ids=["prior", "noprior"])
@pytest.mark.parametrize("b,n,s", [(1, 7, 200), (2, 37, 13)], ids=["s200", "ragged"])
def test_plain_forward_matches_jax_kernel_at_card_shapes(b, n, s, use_prior):
    """The bf16 plain forward, the oracle of the card tests, against the JAX
    kernel at S > 128 (the tensor-core forward takes any S; the backward
    refuses it) and at a ragged b * N * S = 962 rows, not a multiple of the
    forward's 128-row tiles. The tolerance of test_plain_version_matches_jax_kernel."""
    x = make_inputs(b, n, s, seed=7)
    args = {k: v.detach() if v is not None else None
            for k, v in torch_args(x, use_prior, torch.bfloat16).items()}
    got = ray_head.ray_head_fwd(*(args[k] for k in NAMES))
    jargs = {k: jnp.asarray(v).astype(jnp.bfloat16 if k in LOW else jnp.float32)
             for k, v in x.items()}
    if not use_prior:
        jargs["prior"] = jargs["k0p"] = None
    ref = jrh.ray_head_mlp(*(jargs[k] for k in NAMES), interpret=True)
    assert got.shape == ref.shape == (b, n, s) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=2e-2)


@pytest.mark.parametrize("use_prior", [True, False], ids=["prior", "noprior"])
def test_plain_version_matches_xla_chain_f32(use_prior):
    x = make_inputs(2, 37, 13, seed=2)
    args = torch_args(x, use_prior)
    got = ray_head.ray_head_mlp(*(args[k] for k in NAMES))
    ct = weights(np.zeros(got.shape, np.float32))
    (got * torch.tensor(ct)).sum().backward()
    jargs = {k: jnp.asarray(v) for k, v in x.items()}
    if not use_prior:
        jargs["prior"] = jargs["k0p"] = None
    assert_close(got, xla_chain(*(jargs[k] for k in NAMES)), 1e-5)
    diff = ["fp", "depths", "k0d", "w1", "b1", "w2", "b2"] + (["prior", "k0p"] if use_prior else [])

    def loss(d):
        a = dict(jargs, **d)
        return jnp.sum(xla_chain(*(a[k] for k in NAMES)) * ct)

    jg = jax.grad(loss)({k: jargs[k] for k in diff})
    for k in diff:
        assert_close(args[k].grad, jg[k], 1e-5)


@pytest.mark.parametrize("use_prior", [True, False], ids=["prior", "noprior"])
def test_written_out_backward_matches_autograd_f32(use_prior):
    x = make_inputs(2, 23, 7, seed=6)
    args = torch_args(x, use_prior)
    out = ray_head.ray_head_reference(*(args[k] for k in NAMES))
    ct = torch.tensor(weights(np.zeros(out.shape, np.float32)))
    (out * ct).sum().backward()
    g = ray_head.ray_head_bwd_reference(ct, *(args[k].detach() if args[k] is not None else None
                                              for k in NAMES[:-1]))
    grads = {"fp": g.dfp, "depths": g.dd, "prior": g.dp, "k0d": g.dk0d, "k0p": g.dk0p,
             "w1": g.dw1, "b1": g.db1, "w2": g.dw2, "b2": g.db2}
    for k, v in grads.items():
        if args[k] is None:
            assert v is None
            continue
        assert v.dtype == torch.float32
        assert_close(v, args[k].grad.numpy(), 1e-5)


def test_wrappers_take_plain_path_on_cpu():
    x = make_inputs(1, 9, 5)
    args = {k: torch.tensor(v) for k, v in x.items()}
    before = ray_head.ray_head_fwd.launches, ray_head.ray_head_bwd.launches
    out = ray_head.ray_head_fwd(*(args[k] for k in NAMES))
    g = ray_head.ray_head_bwd(torch.ones_like(out), *(args[k] for k in NAMES[:-1]))
    assert (ray_head.ray_head_fwd.launches, ray_head.ray_head_bwd.launches) == before
    assert g.dfp.shape == (1, 9, F) and g.dw1.shape == (F, F) and g.db2.shape == (1,)
    np.testing.assert_allclose(g.db2.numpy(), [45.0], rtol=1e-6)  # d out / d b2 = 1 per row


def test_wrapper_rejects_bad_operands():
    x = make_inputs(1, 9, 5)
    args = {k: torch.tensor(v) for k, v in x.items()}
    bad = dict(args, w1=args["w1"].double())
    with pytest.raises(TypeError):
        ray_head.ray_head_fwd(*(bad[k] for k in NAMES))
    bad = dict(args, depths=args["depths"][:, :, :4])
    with pytest.raises(ValueError):
        ray_head.ray_head_fwd(*(bad[k] for k in NAMES))
    bad = dict(args, w1=args["w1"].t())
    with pytest.raises(ValueError):
        ray_head.ray_head_fwd(*(bad[k] for k in NAMES))
    bad = dict(args, prior=None)
    with pytest.raises(ValueError):
        ray_head.ray_head_fwd(*(bad[k] for k in NAMES))


def test_factored_matches_jax():
    rng = np.random.RandomState(3)
    b, n, s = 2, 30, 8
    chans = (64, 64, 128, 256)
    feats = [rng.randn(b, -(-n // (i + 1)), c).astype(np.float32) for i, c in enumerate(chans)]
    depths = [(rng.rand(b, f.shape[1], s) * 5).astype(np.float32) for f in feats]
    inputs = [np.concatenate([d[..., None], np.broadcast_to(f[:, :, None, :], d.shape + (f.shape[-1],))],
                             axis=-1) for f, d in zip(feats, depths)]
    jnet = JBinaryMLP()
    variables = seeded_variables(jnet.init, inputs, seed=4)
    ref = jnet.apply(variables, feats, depths, None, False, method=JBinaryMLP.factored)
    net = bridged(BinaryMLPNetwork([c + 1 for c in chans]), variables)
    got = net.factored([torch.tensor(f) for f in feats], [torch.tensor(d) for d in depths])
    for k in ref:
        assert_close(got[k], np.asarray(ref[k])[..., 0], 1e-5)
