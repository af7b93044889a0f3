"""implicit_depth_tpu_torch — the PyTorch / CUDA port of implicit_depth_tpu.

The package mirrors the JAX package's module paths and names so that each
counterpart is easy to find (`core/geometry.py`, `models/bd_net.py::
BDNet.forward_val`, ...). It imports `torch` and never `jax` or `flax`.

Layouts: the functions the tests hold against the JAX package (geometry,
sampling, the volume, `BDNet.forward_val`, the metrics) take the JAX
package's NHWC tensors; the conv stacks inside the models run in NCHW.

The port imports nothing of the JAX package. The host-side numpy modules
it needs are copies with only their imports changed (`config`, `data/`,
`utils/`), each naming its original.

Paths: the dense occlusion eval (`BDNet.forward_val`, `cli/test_bd.py`) and
BD training (`BDNet.forward`, `train/state.py`, `train/loop.py::fit`,
`cli/train_bd.py`). Their hand-written CUDA kernels (csrc/, built with nvcc
by ops/cuda_build.py at the first CUDA call): the fused metadata volume
forward and backward (`ops/fused_volume.py`) and the ray-head MLP forward
and backward (`ops/ray_head.py`).
"""

__version__ = "0.1.0"
