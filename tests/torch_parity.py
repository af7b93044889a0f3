"""Helpers for the parity tests of the PyTorch port against the JAX package.

Inputs and parameter noise are made with numpy from a seed and handed to
both frameworks; JAX runs on the CPU in f32, the port on the CPU in f32.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from implicit_depth_tpu_torch.weights import load_state_dict, state_dict_from_flax


def to_numpy_tree(variables) -> dict:
    return jax.tree.map(np.asarray, jax.device_get(variables))


def seeded_variables(init_fn, *args, seed: int = 0) -> dict:
    """A flax variable tree with the structure of `init_fn(key, *args)` and
    seeded values: kernels ~ N(0, 1/fan_in), biases, BN shifts and means
    ~ 0.05 N(0, 1), BN scales 1 + 0.05 N(0, 1), BN variances exp(0.2 N(0, 1)).
    Flax's own init would leave BN an identity and biases zero, which hides
    a bad mapping; the tree comes from `jax.eval_shape`, so nothing is
    computed (initialising EfficientNetV2-S costs ~20 s on the CPU)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args)

    def value(path, s):
        name = getattr(path[-1], "key", None)
        n = rng.randn(*s.shape).astype(np.float32)
        if name in ("kernel", "fc0_kernel"):
            v = n / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.05 * n
        elif name == "var":
            v = np.exp(0.2 * n)
        else:
            v = 0.05 * n
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(value, shapes)


def bridged(module: torch.nn.Module, variables, optional_prefixes=()) -> torch.nn.Module:
    """Loads flax variables into `module` through the weight bridge."""
    load_state_dict(module, state_dict_from_flax(to_numpy_tree(variables)), optional_prefixes)
    return module.eval()


def t(x, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype)


def nchw(x_nhwc) -> torch.Tensor:
    return t(x_nhwc).permute(0, 3, 1, 2).contiguous()


def nhwc(x_nchw: torch.Tensor) -> np.ndarray:
    return x_nchw.detach().permute(0, 2, 3, 1).numpy()


def assert_close(got, ref, rel: float, atol: float = 0.0) -> None:
    """max |got - ref| <= rel * max|ref| + atol."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() if ref.size else 0.0
    bound = rel * np.abs(ref).max() + atol
    assert err <= bound, f"max abs err {err:.3e} > {bound:.3e} (max|ref| {np.abs(ref).max():.3e})"


def assert_tree_close(flax_tree, collection: str, got: dict, rel: float, atol: float = 0.0) -> None:
    """Compares a flax tree of one collection ("params" or "batch_stats",
    e.g. a gradient tree) with the port's tensors `got` {state_dict name:
    tensor}, leaf by leaf through the weight bridge's name and layout map.
    Each leaf must satisfy max|got - ref| <= rel * max|ref| + atol; the
    message names every leaf that does not. Returns {name: max|got - ref| /
    max|ref|}."""
    ref = state_dict_from_flax({collection: to_numpy_tree(flax_tree)})
    missing = sorted(set(ref) - set(got))
    failures = [f"{name}: not in the port" for name in missing]
    rel_errs = {}
    for name, r in ref.items():
        if name in missing:
            continue
        g = got[name]
        if g is None:
            failures.append(f"{name}: no value (None)")
            continue
        g = g.detach().double().numpy()
        r = r.double().numpy()
        if g.shape != r.shape:
            failures.append(f"{name}: shape {g.shape} != {r.shape}")
            continue
        err = float(np.abs(g - r).max()) if r.size else 0.0
        rel_errs[name] = err / max(float(np.abs(r).max()), 1e-30)
        bound = rel * float(np.abs(r).max()) + atol
        if not err <= bound:
            failures.append(f"{name}: max abs err {err:.3e} > {bound:.3e} "
                            f"(max|ref| {float(np.abs(r).max()):.3e})")
    assert not failures, f"{len(failures)} of {len(ref)} leaves differ:\n" + "\n".join(failures)
    return rel_errs


def assert_grad_tree_close(grads, module: torch.nn.Module, rel: float, atol: float = 0.0) -> None:
    """A flax gradient tree (of "params") against the `.grad` of every
    parameter of `module`, flax path by flax path."""
    got = {name: p.grad for name, p in module.named_parameters()}
    return assert_tree_close(grads, "params", got, rel, atol)


def flax_tree_from_port(template, collection: str, tensors: dict):
    """The inverse of the bridge: a flax tree shaped like `template` (one
    collection) holding the port's tensors {state_dict name: tensor}, with
    conv kernels back to HWIO and dense kernels back to (in, out)."""
    def leaf(path, x):
        keys = [str(getattr(k, "key", k)) for k in path]
        nested = np.asarray(x)
        for k in reversed(keys):
            nested = {k: nested}
        (name,) = state_dict_from_flax({collection: nested})
        v = tensors[name].detach().numpy()
        if keys[-1] == "kernel" and v.ndim == 4:
            v = v.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif keys[-1] == "kernel" and v.ndim == 2:
            v = v.T
        return np.ascontiguousarray(v, dtype=np.float32)

    return jax.tree_util.tree_map_with_path(leaf, template)
