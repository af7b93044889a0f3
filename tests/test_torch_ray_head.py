"""Port parity: the ray-head MLP (ops/ray_head.py) and
BinaryMLPNetwork.factored.

- The plain ray_head_mlp and its autograd gradients against the JAX
  package's `ray_head_mlp(..., interpret=True)` and `jax.grad`, with and
  without the prior, at a ragged N=100 and S=16. The JAX kernel computes its
  chain in bf16, so the bound is atol 3e-2 (tests/test_ray_head.py) on the
  logits and 3e-2 of each gradient's largest value on the gradients.
- The plain version against the JAX XLA chain in f32: 1e-5 of the largest
  value (f32 sums in another order).
- `factored` against the JAX package's BinaryMLPNetwork.factored
  (use_pallas=False) in f32, at 1e-5.
"""

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


def torch_args(x, use_prior):
    args = {k: torch.tensor(v, requires_grad=True) for k, v in x.items()}
    if not use_prior:
        args["prior"] = args["k0p"] = None
    return args


def weights(ct):
    return np.cos(np.arange(ct.size, dtype=np.float32)).reshape(ct.shape)


@pytest.mark.parametrize("use_prior", [True, False], ids=["prior", "noprior"])
def test_plain_version_matches_jax_kernel(use_prior):
    x = make_inputs(2, 100, 16, seed=1)
    ct = weights(np.zeros((2, 100, 16), np.float32))
    args = torch_args(x, use_prior)
    got = ray_head.ray_head_mlp(*(args[k] for k in NAMES))
    (got * torch.tensor(ct)).sum().backward()

    jargs = {k: jnp.asarray(v) for k, v in x.items()}
    if not use_prior:
        jargs["prior"] = jargs["k0p"] = None
    ref = jrh.ray_head_mlp(*(jargs[k] for k in NAMES), interpret=True)
    assert got.shape == ref.shape == (2, 100, 16)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref, np.float32), atol=3e-2)

    diff = ["fp", "depths", "k0d", "w1", "b1", "w2", "b2"] + (["prior", "k0p"] if use_prior else [])

    def loss(d):
        a = dict(jargs, **d)
        return jnp.sum(jrh.ray_head_mlp(*(a[k] for k in NAMES), interpret=True).astype(jnp.float32) * ct)

    jg = jax.grad(loss)({k: jargs[k] for k in diff})
    for k in diff:
        assert_close(args[k].grad, np.asarray(jg[k], np.float32), 3e-2)


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
