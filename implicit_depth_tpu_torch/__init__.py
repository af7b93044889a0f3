"""implicit_depth_tpu_torch — the PyTorch / CUDA port of implicit_depth_tpu.

The package mirrors the JAX package's module paths and names so that each
counterpart is easy to find (`core/geometry.py`, `models/bd_net.py::
BDNet.forward_val`, ...). It imports `torch` and never `jax` or `flax`.

Layouts: the functions the tests hold against the JAX package (geometry,
sampling, the volume, `BDNet.forward_val`, the metrics) take the JAX
package's NHWC tensors; the conv stacks inside the models run in NCHW.

Host-side numpy code of the JAX package is reused, not ported:
`implicit_depth_tpu.data.{synthetic,mvs_dataset,loader,registry}` and
`implicit_depth_tpu.utils.fixtures` import no JAX.

The one hand-written kernel of the dense eval path is
`ops/fused_volume.py::fused_metadata_volume` (CUDA C++ in
`csrc/fused_volume.cu`, built with nvcc at its first CUDA call).
"""

__version__ = "0.1.0"
