"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every `csrc/*.cu` exposes a plain C interface and includes no PyTorch
header, so nvcc compiles each in seconds (PyTorch's `cpp_extension.load`
takes minutes for a file that includes its headers, and waits forever on a
stale lock file). One nvcc per source runs at once, all started together,
and one more links the objects into a shared library. The library goes to
`espnet_tpu_torch/_build/<hash>/`, keyed by the sources, the flags and the
nvcc binary, and is built on first use: nothing is built when a module is
imported. Writes go to names of this process that are renamed into place,
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their signatures (see the extern "C" blocks in csrc/)
_SIGNATURES = {
    "espnet_relpos_attention_fwd": (_P,) * 9 + (_I,) * 4 + (_F, _I, _P),
    "espnet_relpos_attention_bwd": (_P,) * 15 + (_I,) * 4 + (_F, _I, _P),
    "espnet_relpos_attention_slab_rows": (_I,),
    "espnet_prenorm_ffn_fwd": ((_P,) * 8 + (_I,) * 3 + (_F, _I, _I, _F)
                               + (_I,) * 3 + (_P,)),
    "espnet_prenorm_ffn_bwd": ((_P,) * 14 + (_I,) * 4 + (_F, _I, _I, _F)
                               + (_I,) * 3 + (_P,)),
    "espnet_prenorm_ffn_bwd_rows_per_block": (),
    "espnet_ffn_fwd": (_P,) * 6 + (_I,) * 5 + (_F, _I, _I, _P),
    "espnet_ffn_bwd": (_P,) * 10 + (_I,) * 6 + (_F, _I, _I, _P),
    "espnet_flash_attention_fwd": (_P,) * 5 + (_I,) * 4 + (_F, _I, _P),
    "espnet_ctc_alphas": (_P,) * 5 + (_I,) * 3 + (_P,),
    "espnet_ctc_gamma": (_P,) * 6 + (_I,) * 3 + (_P,),
    "espnet_ctc_max_states": (),
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
    """Compile csrc/*.cu (one nvcc per source, in parallel) and link them
    into one shared library, unless already built.

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
    pid = os.getpid()
    objs = [out_dir / f".{src.stem}.{pid}.o" for src in _sources()]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(_sources(), objs)]
    outputs = [proc.communicate()[0] for proc in procs]
    output = "".join(outputs)
    tmp = out_dir / f".{LIB_NAME}.{pid}.tmp"
    if all(proc.returncode == 0 for proc in procs):
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True)
        output += link.stdout + link.stderr
        failed = link.returncode
    else:
        failed = next(proc.returncode for proc in procs if proc.returncode)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed}):\n{output}")
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
