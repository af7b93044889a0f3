"""The port covers the JAX package name by name.

For every module of implicit_depth_tpu/, each public top-level function or
class and each public method of a public top-level class needs a
counterpart of the same name in implicit_depth_tpu_torch/: in the module of
the same path, or anywhere in the port (a method as `Class.method`).
Otherwise the name has an entry in COVERED_ELSEWHERE (the port name that
covers it) or in DO_NOT_PORT (why the port has none). Both tables are
checked too: a port name they give exists, and an entry whose JAX name is
gone or now has a same-name counterpart fails as stale.

The test parses the sources with `ast` and imports nothing of either
package.
"""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = REPO / "implicit_depth_tpu", REPO / "implicit_depth_tpu_torch"

# JAX name -> (the port name that covers it, why it is not a same-name copy)
COVERED_ELSEWHERE = {
    "config.py::parse_and_merge": (
        "config.py::parse_config",
        "the same file and flag layering, plus --device; the JAX one also turns on "
        "JAX's compile cache"),
    "train/checkpoint.py::lazy_load_params": (
        "weights.py::lazy_load_state_dict",
        "copies the tensors whose name and shape match into a torch module"),
    "models/decoders.py::BDDecoderPP": (
        "models/decoders.py::DecoderPP",
        "DecoderPP(head_channels=0): flax subclasses that only set a field"),
    "models/decoders.py::DepthDecoderPP": (
        "models/decoders.py::DecoderPP",
        "DecoderPP(head_channels=1): flax subclasses that only set a field"),
    "models/bd_net.py::maybe_flip": (
        "models/bd_net.py::BDNet.trunk",
        "a traced-bool jnp.where; the port's flip is a Python bool and Tensor.flip"),
    "train/state.py::TrainState": (
        "train/state.py::make_optimizer",
        "torch.optim.AdamW and its LambdaLR hold the optimizer state"),
    "train/state.py::TrainState.apply_gradients": (
        "train/state.py::make_bd_train_step",
        "optimizer.step() after backward, inside the step"),
    "train/state.py::create_train_state": (
        "train/state.py::make_optimizer",
        "the module holds its parameters; make_optimizer builds AdamW over them"),
    "models/bd_net.py::BDNet.setup": (
        "models/bd_net.py::BDNet.__init__", "flax's setup is the torch constructor"),
    "models/depth_net.py::DepthNet.setup": (
        "models/depth_net.py::DepthNet.__init__", "flax's setup is the torch constructor"),
    "models/volume_mlp.py::MetadataVolumeMLP.setup": (
        "models/volume_mlp.py::MetadataVolumeMLP.__init__",
        "flax's setup is the torch constructor"),
}

_MESH = ("places arrays on a jax.sharding mesh; the port runs one process per card "
         "(parallel/distributed.py) and places nothing")
_PALLAS_PARTITION = ("exists because a pallas_call cannot be auto-partitioned over chips; "
                     "the port's warp is kernel #5 on one card")
DO_NOT_PORT = {
    "parallel/distributed.py::global_batch": (
        "assembles the processes' rows into one sharded jax.Array; each rank of the port "
        "keeps its rows and reduces losses, batch norm and gradients over the ranks"),
    "parallel/mesh.py::make_mesh": _MESH,
    "parallel/mesh.py::batch_sharding": _MESH,
    "parallel/mesh.py::replicated": _MESH,
    "parallel/mesh.py::replicate": _MESH,
    "parallel/mesh.py::shard_batch": _MESH,
    "parallel/mesh.py::view_sharding": (
        "the mesh's model axis, which splits the views of the Pallas warp over chips"),
    "parallel/sharded_warp.py::sharded_warp": _PALLAS_PARTITION,
    "parallel/sharded_warp.py::warp_planes_xla": _PALLAS_PARTITION,
}


def _names(pkg: pathlib.Path, public: bool) -> dict:
    """{module path: set of "name" and "Class.method"} of every module."""
    out = {}
    for path in sorted(pkg.rglob("*.py")):
        names = set()
        for node in ast.parse(path.read_text()).body:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            if public and node.name.startswith("_"):
                continue
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names.update(f"{node.name}.{m.name}" for m in node.body
                             if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                             and not (public and m.name.startswith("_")))
        out[path.relative_to(pkg).as_posix()] = names
    return out


JAX_NAMES = _names(JAX_PKG, public=True)
PORT_NAMES = _names(PORT_PKG, public=False)
PORT_ANYWHERE = set().union(*PORT_NAMES.values())


def _uncovered() -> set:
    """The JAX names, as "path::name", with no same-name counterpart."""
    return {f"{path}::{name}" for path, names in JAX_NAMES.items() for name in names
            if name not in PORT_ANYWHERE}


def _group(path: str) -> str:
    return path.split("/")[0] if "/" in path else "."


GROUPS = sorted({_group(p) for p in JAX_NAMES})


def test_the_tables_are_disjoint():
    assert not set(COVERED_ELSEWHERE) & set(DO_NOT_PORT)
    assert len(GROUPS) >= 10 and sum(map(len, JAX_NAMES.values())) > 300


@pytest.mark.parametrize("group", GROUPS)
def test_every_jax_name_has_a_port_counterpart(group):
    missing = sorted(k for k in _uncovered() if _group(k.split("::")[0]) == group
                     and k not in COVERED_ELSEWHERE and k not in DO_NOT_PORT)
    assert not missing, "JAX names with no port counterpart and no table entry:\n" + \
        "\n".join(missing)


def test_table_entries_are_not_stale():
    """Each entry names a public JAX name that exists and has no same-name
    counterpart in the port."""
    uncovered = _uncovered()
    stale = sorted(k for k in list(COVERED_ELSEWHERE) + list(DO_NOT_PORT) if k not in uncovered)
    assert not stale, "table entries whose JAX name is gone or now ported by name:\n" + \
        "\n".join(stale)


def test_covering_port_names_exist():
    for jax_name, (port_name, reason) in COVERED_ELSEWHERE.items():
        path, name = port_name.split("::")
        assert name in PORT_NAMES.get(path, ()), (jax_name, port_name)
        assert reason
    assert all(DO_NOT_PORT.values())
