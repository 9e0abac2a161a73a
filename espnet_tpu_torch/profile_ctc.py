"""Device time of the CTC lattice pair and of the CTC loss around it, on the
CUDA card, at chip_smoke.py's CTC case (B=64, T=469, U=40, V=5000).

    python -m espnet_tpu_torch.profile_ctc [--states S]

Prints the card's name and power limit and, for `ctc_alphas`, `ctc_gamma`
and `ctc_loss_from_logits` forward and backward (bf16 logits; left out with
`--states`), chip_smoke.py's `device_ms` (torch.profiler, the call's
kernels summed, mean of 10 calls) and `time_ms` (CUDA events, mean of 20
calls after 2 warm-up calls). `--states` cuts the lattice to its first S
states, with labels of S // 2 symbols. The inputs are chip_smoke.py's
`ctc_case`, the helpers come from the chip_smoke.py of this file's
checkout, and only the port's entry points are timed, so the same file
times an earlier tree of the port: `PYTHONPATH=<tree> python3
espnet_tpu_torch/profile_ctc.py`. Needs a card; raises without one.
"""

from __future__ import annotations

import argparse
import importlib.util
from pathlib import Path

import numpy as np
import torch

B, T, U, V = 64, 469, 40, 5000  # the bench's CTC shape
SEED = 6


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--states", type=int, default=None)
    s = ap.parse_args().states
    smoke = _chip_smoke()
    smoke.phase_device(torch)

    from espnet_tpu_torch.ops import ctc as tctc
    from espnet_tpu_torch.ops import ctc_lattice as tlat

    u = U if s is None else s // 2
    logits, labels, in_lens, lab_lens, emit, skip = smoke.ctc_case(
        torch, np, B, T, u, V, SEED, s=s)
    alphas, _ = tlat.ctc_alphas(emit, skip, in_lens)
    calls = {
        "ctc_alphas": lambda: tlat.ctc_alphas(emit, skip, in_lens),
        "ctc_gamma": lambda: tlat.ctc_gamma(emit, skip, in_lens, lab_lens,
                                            alphas),
    }
    if s is None:
        xb = logits.bfloat16().requires_grad_(True)
        calls["ctc_loss_from_logits fwd+bwd (bf16 logits)"] = (
            lambda: torch.autograd.grad(tctc.ctc_loss(
                xb, labels, in_lens, lab_lens, reduction="sum"), xb))
    shape = f"B={B} T={T} S={emit.shape[2]} V={V}"
    for name, fn in calls.items():
        print(f"{name} {shape}: device {smoke.device_ms(torch, fn):.4f} ms, "
              f"events {smoke.time_ms(torch, fn):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
