"""The launch counters of the port's kernel wrappers, by name.

Each kernel wrapper counts its own launches in its `launches` attribute
(one per kernel call on the card, none for its plain version). `wrappers()`
names them, `reset()` sets every count to 0 and `counts()` reads them.

A CLI that runs the model (`bin.asr_train`, `bin.asr_inference`) calls
`log_at_exit()`: when the environment variable `LAUNCH_LOG_ENV` names a
file, the process appends one JSON line {"cli": ..., "argv": [...],
"launches": {kernel: count}} to it at exit, so whoever runs the recipe's
subprocesses (`chip_smoke.py`'s recipe phase) can read what each one
launched. Without the variable nothing is written.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
from typing import Callable, Dict

LAUNCH_LOG_ENV = "ESPNET_TPU_TORCH_LAUNCH_LOG"


def wrappers() -> Dict[str, Callable]:
    """Every kernel wrapper, by the kernel's name."""
    from espnet_tpu_torch.ops import (conv_glu, conv_module, ctc_lattice, ffn,
                                      flash_attention, prenorm_ffn,
                                      relpos_attention, transducer_lattice)

    return {
        "relpos_attention": relpos_attention.relpos_attention,
        "relpos_attention_bwd": relpos_attention.relpos_attention_bwd,
        "prenorm_ffn": prenorm_ffn.prenorm_ffn,
        "prenorm_ffn_bwd": prenorm_ffn.prenorm_ffn_bwd,
        "ctc_alphas": ctc_lattice.ctc_alphas,
        "ctc_gamma": ctc_lattice.ctc_gamma,
        "fused_ffn": ffn.fused_ffn,
        "fused_ffn_bwd": ffn.fused_ffn_bwd,
        "flash_attention": flash_attention.flash_attention,
        "prenorm_glu": conv_glu.prenorm_glu,
        "prenorm_glu_bwd": conv_glu.prenorm_glu_bwd,
        "postnorm_proj": conv_glu.postnorm_proj,
        "postnorm_proj_bwd": conv_glu.postnorm_proj_bwd,
        "conv_module": conv_module.conv_module,
        "conv_module_bwd": conv_module.conv_module_bwd,
        "transducer_alphas": transducer_lattice.transducer_alphas,
        "transducer_occupancy": transducer_lattice.transducer_occupancy,
    }


def reset() -> Dict[str, Callable]:
    """Set every count to 0; returns the wrappers by name."""
    found = wrappers()
    for fn in found.values():
        fn.launches = 0
    return found


def counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}


def log_at_exit(cli: str) -> None:
    """Append this process's launch counts to the file named by
    `LAUNCH_LOG_ENV` at exit (nothing when it is unset)."""
    path = os.environ.get(LAUNCH_LOG_ENV)
    if not path:
        return

    def write():
        with open(path, "a") as f:
            f.write(json.dumps({"cli": cli, "argv": sys.argv[1:],
                                "launches": counts()}) + "\n")

    atexit.register(write)
