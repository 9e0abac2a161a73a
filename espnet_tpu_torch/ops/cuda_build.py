"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every `csrc/*.cu` exposes a plain C interface and includes no PyTorch
header, so one `nvcc -shared` call compiles all of them into one shared
library in seconds (PyTorch's `cpp_extension.load` takes minutes for a file
that includes its headers, and waits forever on a stale lock file). The
library goes to `espnet_tpu_torch/_build/<hash>/`, keyed by the sources, the
flags and the nvcc binary, and is built on first use: nothing is built when a
module is imported. Writes go to a temporary name that is renamed into place,
so two processes building at once need no lock.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libespnet_tpu_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their signatures (see the extern "C" blocks in csrc/)
_SIGNATURES = {
    "espnet_relpos_attention_fwd": (_P,) * 8 + (_I,) * 5 + (_P,),
    "espnet_prenorm_ffn_fwd": (_P,) * 8 + (_I,) * 3 + (_F, _I, _I, _P),
}


def find_nvcc() -> str:
    """nvcc from CUDA_HOME / CUDA_PATH, torch's CUDA_HOME, then PATH."""
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")]
    from torch.utils import cpp_extension

    homes += [cpp_extension.CUDA_HOME, "/usr/local/cuda"]
    for home in homes:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME to the CUDA toolkit to build the "
        "port's kernels"
    )


def _sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def _build_key(nvcc: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(str(Path(nvcc).resolve()).encode())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def build_library() -> Tuple[Path, str]:
    """Compile csrc/*.cu into one shared library, unless already built.

    Returns (library path, nvcc's output): the `-Xptxas -v` lines give each
    kernel's registers, shared memory and spills.
    """
    nvcc = find_nvcc()
    out_dir = BUILD_DIR / _build_key(nvcc)
    lib = out_dir / LIB_NAME
    log = out_dir / "nvcc.log"
    if lib.is_file() and log.is_file():
        return lib, log.read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    output = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{output}")
    tmp_log = out_dir / f".nvcc.log.{os.getpid()}.tmp"
    tmp_log.write_text(output)
    os.replace(tmp, lib)
    os.replace(tmp_log, log)
    return lib, output


@functools.lru_cache(maxsize=None)
def kernel_library() -> ctypes.CDLL:
    """The built library with the argument types of every entry point set."""
    path, _ = build_library()
    lib = ctypes.CDLL(str(path))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    lib.espnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.espnet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(name: str, code: int) -> None:
    """Raise if a C entry point reported a failed launch."""
    if code != 0:
        msg = kernel_library().espnet_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: kernel launch failed ({code}: {msg})")
