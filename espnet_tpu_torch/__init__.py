"""PyTorch and CUDA port of espnet_tpu, served on an NVIDIA H100.

Module names mirror the JAX package (`espnet_tpu_torch/models/conformer.py`
is the port of `espnet_tpu/models/conformer.py`). The port imports torch,
numpy and the standard library (and scipy for some audio formats), never
jax, espnet_tpu, PyYAML or msgpack; its tests compare it with the JAX
package on the CPU. The command-line entry points are `bin/asr_train.py`
and `bin/asr_inference.py`. Hand-written CUDA kernels live in
`csrc/` and are built with nvcc on first use (`ops/cuda_build.py`).
"""

from espnet_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
