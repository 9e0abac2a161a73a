"""Where the port runs: on the CUDA card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = "cuda") -> torch.device:
    """The device an entry point runs on.

    `None` and "cuda" mean the CUDA card, and raise when there is none:
    the port never falls back to the CPU on its own. Pass "cpu" (as the
    tests do) to run the plain PyTorch versions of the kernels there.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
