"""No module that the benchmark or its reference loads is JAX, jaxlib,
flax, optax or the JAX package `implicit_depth_tpu` (top-level names
compared whole: the port's `implicit_depth_tpu_torch` begins with it), and
the reference loads nothing of the port."""

import subprocess
import sys

from port_bench import harness

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted(sys.modules)))
"""


def loaded(imports: str) -> list:
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(harness.ROOT),
                                                             imports=imports)],
                         capture_output=True, text=True, timeout=300, check=True)
    import json
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_loads_nothing_of_the_port_or_jax():
    mods = loaded("import port_bench.reference.nets, port_bench.reference.steps, "
                  "port_bench.reference.fp8, port_bench.compare, port_bench.traffic, "
                  "port_bench.work.bounds, port_bench.work.count_flops")
    tops = {m.split(".")[0] for m in mods}
    assert "implicit_depth_tpu_torch" not in tops
    assert not harness.forbidden_loaded(mods)


def test_a_whole_cpu_run_loads_no_jax():
    mods = loaded("""
import argparse, torch
from port_bench import harness
import port_bench.run as run
small = dict(image_height=64, image_width=96, num_rays=32, samples_per_ray=8)
for name, mix in (("bd_eval_ar", dict(ring=2, warmup_rings=0)), ("bd_train_b12", dict(batch=2, ring=3))):
    cell = harness.Cell(name, config_overrides=small, mix_overrides=mix)
    args = argparse.Namespace(workload=name, seed=3, seconds=0.0, trace=1)
    run.run(args, device=torch.device("cpu"), cell=cell)
""")
    tops = {m.split(".")[0] for m in mods}
    assert "implicit_depth_tpu_torch" in tops
    assert not harness.forbidden_loaded(mods)


def test_the_guard_compares_whole_top_level_names():
    assert harness.forbidden_loaded(["implicit_depth_tpu_torch.models", "numpy"]) == []
    assert harness.forbidden_loaded(["implicit_depth_tpu.models"]) == ["implicit_depth_tpu"]
    assert harness.forbidden_loaded(["jax", "jaxlib.xla", "flax.linen", "optax"]) == [
        "flax", "jax", "jaxlib", "optax"]
    assert harness.forbidden_loaded(["jaxtyping"]) == []
