"""Faults planted under the benchmark, to show that its comparison fails
them: the tests run a cell on the CPU with each, and calibrate.py reads
what they give on the card. Each is a context manager that wraps the
program's entries in port_bench/program.py; none is used by a run."""

from __future__ import annotations

import contextlib
import importlib

from port_bench import program


@contextlib.contextmanager
def _patched(name: str, wrap):
    original = getattr(program, name)
    setattr(program, name, wrap(original))
    try:
        yield
    finally:
        setattr(program, name, original)


def _half(batch):
    return tuple({k: v[: max(1, v.shape[0] // 2)] for k, v in d.items()} for d in batch)


def half_batch():
    """The training step sees the first half of each batch: its mean is
    taken over the rest."""
    def wrap(train_step):
        def patched(net, config, seed):
            step, opt = train_step(net, config, seed)
            return (lambda batch, flip: step(_half(batch), flip)), opt
        return patched
    return _patched("train_step", wrap)


def frozen_state():
    """The training step returns its state unchanged: AdamW never steps."""
    def wrap(train_step):
        def patched(net, config, seed):
            step, opt = train_step(net, config, seed)
            opt.step = lambda *args, **kwargs: None
            return step, opt
        return patched
    return _patched("train_step", wrap)


def altered_answer():
    """An answer altered where it is produced: the eval forward's first
    value moves by a quarter of the answer's largest magnitude; the
    training step's loss by a tenth."""
    def wrap_eval(eval_forward):
        def patched(net, config):
            forward = eval_forward(net, config)

            def altered(cur, src):
                out = forward(cur, src).clone()
                out.view(-1)[0] += 0.25 * out.abs().max()
                return out
            return altered
        return patched

    def wrap_train(train_step):
        def patched(net, config, seed):
            step, opt = train_step(net, config, seed)

            def altered(batch, flip):
                losses = dict(step(batch, flip))
                losses["loss"] = losses["loss"] * 1.1
                return losses
            return altered, opt
        return patched

    stack = contextlib.ExitStack()
    stack.enter_context(_patched("eval_forward", wrap_eval))
    stack.enter_context(_patched("train_step", wrap_train))
    return stack


@contextlib.contextmanager
def _scaled_cotangent(module: str, name: str, factor: float):
    """The program's kernel backward `module.name(ct, ...)` called with its
    cotangent scaled by `factor`: every gradient that kernel gives back is
    `factor` times too large."""
    mod = importlib.import_module(module)
    original = getattr(mod, name)

    def scaled(ct, *args):
        return original(ct * factor, *args)
    scaled.__dict__.update(original.__dict__)  # the launch counters the wrapper bumps by name
    setattr(mod, name, scaled)
    try:
        yield
    finally:
        setattr(mod, name, original)


def volume_bwd_doubled():
    """Kernel #2 (the fused volume's backward) gives gradients twice too large."""
    return _scaled_cotangent("implicit_depth_tpu_torch.ops.fused_volume",
                             "fused_metadata_volume_bwd", 2.0)


def ray_head_bwd_doubled():
    """Kernel #4 (the query head's backward) gives gradients twice too large."""
    return _scaled_cotangent("implicit_depth_tpu_torch.ops.ray_head", "ray_head_bwd", 2.0)

