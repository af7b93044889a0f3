"""The comparisons that decide `correct`: the numbers computed from the
program's outputs and the reference's, each held to its limit in the
cell's traffic mix (`limits`)."""

from __future__ import annotations

import numpy as np


def eval_gaps(got: list, ref: list) -> dict:
    """Per-pixel answers of every ring tuple, program against reference:
    the widest gap over all of them (`max_gap`) and the mean gap
    (`mean_gap`), both relative to the reference's largest magnitude."""
    scale = max(float(np.abs(r).max()) for r in ref)
    diffs = [np.abs(np.asarray(g, np.float64) - np.asarray(r, np.float64)) for g, r in zip(got, ref)]
    return {"max_gap": max(float(d.max()) for d in diffs) / scale,
            "mean_gap": float(np.mean([d.mean() for d in diffs])) / scale}


def leaf_gaps(got: dict, ref: dict, leaves) -> np.ndarray:
    """Each leaf's gap between the program's norm and the reference's,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    med = float(np.median([ref[k] for k in leaves])) if leaves else 0.0
    return np.array([abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves])


def counted_leaves(ref_grad_norms: dict, share: float = 1e-3) -> list:
    """Leaves whose reference gradient is not nought to rounding: at least
    `share` of the median leaf's gradient norm. (A key's bias under
    softmax, or a bias that a norm cancels, moves under Adam by round-off
    alone.)"""
    med = float(np.median(list(ref_grad_norms.values())))
    return sorted(k for k, v in ref_grad_norms.items() if v >= share * med)


def train_gaps(got, ref, groups=None) -> dict:
    """TrainRecords of the program and the reference over the same first
    steps: the worst step's relative loss gap (`loss_gap`), the first
    step's (`loss1_gap`), and of the first gradient's norm and of the
    change after the steps, and of each batch-norm running statistic's
    change, the worst leaf's gap (`grad_gap`, `change_gap`, `stats_gap`)
    and the median leaf's (`*_gap_median`). `groups` {name: [prefix, ...]}
    adds each group's worst leaf of the first gradient (`<name>_grad_gap`):
    the leaves whose names start with one of its prefixes."""
    leaves = counted_leaves(ref.grad_norms)
    loss = [abs(g - r) / max(abs(r), 1e-30) for g, r in zip(got.losses, ref.losses)]
    out = {"loss_gap": max(loss), "loss1_gap": loss[0]}
    stats = sorted(ref.stat_norms)
    grad = leaf_gaps(got.grad_norms, ref.grad_norms, leaves)
    for name, gaps in (("grad", grad),
                       ("change", leaf_gaps(got.change_norms, ref.change_norms, leaves)),
                       ("stats", leaf_gaps(got.stat_norms, ref.stat_norms, stats))):
        out[f"{name}_gap"] = float(gaps.max())
        out[f"{name}_gap_median"] = float(np.median(gaps))
    for name, prefixes in (groups or {}).items():
        sel = [g for k, g in zip(leaves, grad) if k.startswith(tuple(prefixes))]
        out[f"{name}_grad_gap"] = float(max(sel)) if sel else float("nan")
        out[f"{name}_grad_gap_median"] = float(np.median(sel)) if sel else float("nan")
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): every number at or under its limit and finite;
    checks {name: {"value", "limit"}} in the limits' order."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        checks[name] = {"value": value, "limit": limit}
        ok = ok and bool(np.isfinite(value)) and value <= limit
    return ok, checks
