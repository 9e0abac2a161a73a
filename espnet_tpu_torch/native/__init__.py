"""Native (C++) helpers of the port, built on demand with the system g++.

Port of espnet_tpu/native/__init__.py `load_library`, with one difference:
the shared library is built from the port's own copy of the source into the
git-ignored `espnet_tpu_torch/_build/`, never next to the source, and a
prebuilt library of the JAX package is never loaded. Without a compiler the
callers fall back to pure Python, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

logger = logging.getLogger("espnet_tpu")

_DIR = Path(__file__).parent
BUILD_DIR = _DIR.parent / "_build"
_LOCK = threading.Lock()
_LIBS = {}


def load_library(name: str, sources) -> Optional[ctypes.CDLL]:
    """Build (if needed) and dlopen `_build/lib<name>.so` from the C++
    sources in this directory; None where it cannot be built."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        so = BUILD_DIR / f"lib{name}.so"
        srcs = [_DIR / s for s in sources]
        try:
            if not so.exists() or any(
                    s.stat().st_mtime > so.stat().st_mtime for s in srcs):
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                # a name of this process and thread: workers may race
                tmp = so.with_suffix(
                    f".{os.getpid()}.{threading.get_ident()}.tmp")
                cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                       "-o", str(tmp)] + [str(s) for s in srcs]
                subprocess.run(cmd, check=True, capture_output=True)
                tmp.replace(so)
                logger.info("built native library %s", so)
            lib = ctypes.CDLL(str(so))
        except Exception as e:  # no compiler / build failure -> fallback
            logger.warning("native %s unavailable (%s); using python "
                           "fallback", name, e)
            lib = None
        _LIBS[name] = lib
        return lib
