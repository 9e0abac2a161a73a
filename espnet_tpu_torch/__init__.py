"""PyTorch and CUDA port of espnet_tpu, served on an NVIDIA H100.

Module names mirror the JAX package (`espnet_tpu_torch/models/conformer.py`
is the port of `espnet_tpu/models/conformer.py`). The port imports torch,
numpy and the standard library (and scipy for some audio formats), never
jax, espnet_tpu, PyYAML or msgpack; its tests compare it with the JAX
package on the CPU. The command-line entry points are `bin/asr_train.py`,
`bin/asr_inference.py`, the staged recipe `bin/run.py` (`recipe.py`) and
the data CLIs it runs (`bin/make_synth_data.py`, `bin/build_token_list.py`,
`bin/pack.py`, `bin/prep_librispeech.py`). Hand-written CUDA kernels live in
`csrc/` and are built with nvcc on first use (`ops/cuda_build.py`).

Importing the package imports no torch: the data CLIs that need none (the
recipe runs each as a subprocess) start without it.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from espnet_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(
        f"module 'espnet_tpu_torch' has no attribute {name!r}")
