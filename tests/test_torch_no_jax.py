"""The port runs where JAX is not installed and imports nothing of the JAX
package: every module of implicit_depth_tpu_torch and chip_smoke.py import
with `jax`, `flax` and `implicit_depth_tpu` blocked, and afterwards no
implicit_depth_tpu.* module is loaded (chip_smoke.py's path, the AR demo
path and the capture loaders also without yaml and PIL); chip_smoke.py
refuses to run without a CUDA device or outside the repository."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
for blocked in ("jax", "flax", "implicit_depth_tpu"):
    sys.modules[blocked] = None
import implicit_depth_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
import chip_smoke
assert callable(chip_smoke.main)
leaked = [m for m in sys.modules if m.startswith("implicit_depth_tpu.")]
assert not leaked, leaked
print(len(names))
"""


# what chip_smoke.py's phases import: the card's machine may also lack
# yaml and PIL
_IMPORT_CHIP_SMOKE = r"""
import importlib, sys
for blocked in ("jax", "flax", "yaml", "PIL", "implicit_depth_tpu"):
    sys.modules[blocked] = None
for name in ("chip_smoke", "implicit_depth_tpu_torch.data.synthetic",
             "implicit_depth_tpu_torch.data.loader", "implicit_depth_tpu_torch.utils.fixtures",
             "implicit_depth_tpu_torch.eval.occlusion_eval", "implicit_depth_tpu_torch.models.bd_net",
             "implicit_depth_tpu_torch.train.state", "implicit_depth_tpu_torch.ops.ray_head",
             "implicit_depth_tpu_torch.ops.fused_volume", "implicit_depth_tpu_torch.weights",
             "implicit_depth_tpu_torch.models.depth_net", "implicit_depth_tpu_torch.ops.warp_kernel",
             "implicit_depth_tpu_torch.models.resnets", "implicit_depth_tpu_torch.models.fpn_matching",
             "implicit_depth_tpu_torch.eval.depth_eval",
             "implicit_depth_tpu_torch.eval.temporal_driver", "implicit_depth_tpu_torch.cli.test_reg",
             "implicit_depth_tpu_torch.cli.validate_bd", "implicit_depth_tpu_torch.utils.caching",
             "implicit_depth_tpu_torch.train.loop", "implicit_depth_tpu_torch.train.checkpoint",
             "implicit_depth_tpu_torch.train.logging", "implicit_depth_tpu_torch.parallel.distributed",
             "implicit_depth_tpu_torch.cli.test_bd", "implicit_depth_tpu_torch.cli.train_bd",
             "implicit_depth_tpu_torch.cli.convert_checkpoint",
             # the AR demo path and the capture loaders
             "implicit_depth_tpu_torch.apps.inference", "implicit_depth_tpu_torch.apps.composite",
             "implicit_depth_tpu_torch.apps.vdr_sequence", "implicit_depth_tpu_torch.cli.inference",
             "implicit_depth_tpu_torch.cli.composite", "implicit_depth_tpu_torch.data.registry",
             "implicit_depth_tpu_torch.data.hypersim", "implicit_depth_tpu_torch.data.vdr",
             "implicit_depth_tpu_torch.data.seven_scenes", "implicit_depth_tpu_torch.data.colmap",
             "implicit_depth_tpu_torch.data.arkit", "implicit_depth_tpu_torch.data.scanniverse",
             "implicit_depth_tpu_torch.data.tuples", "implicit_depth_tpu_torch.data.samplers"):
    importlib.import_module(name)
assert not [m for m in sys.modules if m.startswith("implicit_depth_tpu.")]
print("ok")
"""


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO if cwd == REPO else "")
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_port_imports_without_jax():
    proc = _run(["-c", _IMPORT_ALL], REPO)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 79  # every module of the port was imported


def test_chip_smoke_imports_without_yaml_or_pil():
    proc = _run(["-c", _IMPORT_CHIP_SMOKE], REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


def test_chip_smoke_needs_a_cuda_device():
    """Without a card the script exits non-zero and prints no result."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run the port")
    proc = _run(["chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
