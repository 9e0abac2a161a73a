"""Where the time of one train step goes, on the CUDA card.

    python -m espnet_tpu_torch.profile_train [--batch 64] [--secs 15]
        [--encoder conformer|transformer|e_branchformer]

Builds the bench model (full width and depth, bf16 compute, dropout 0.1,
SpecAug, random weights from a seed) with the encoder of the chosen
configuration of `espnet_tpu_torch.configs`; runs one warm-up train step
through
`make_train_step`, then one step under `torch.profiler` and one step timed
by the host clock alone. Prints the card's name and power limit, the step's
wall time, the device time summed over all kernels (and so the device's idle
share of the wall), and the kernels with the most device time, grouped by
name. Needs a card; raises without one.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from espnet_tpu_torch.configs import ENCODERS, bench_config
from espnet_tpu_torch.models.asr import ASRModel, init_random_
from espnet_tpu_torch.train.optim import build_optimizer
from espnet_tpu_torch.train.steps import TrainState, make_train_step


def _batch(b: int, secs: float, u: int, vocab: int, device):
    rng = np.random.RandomState(0)
    n = int(secs * 16000)
    batch = {
        "speech": 0.1 * rng.randn(b, n).astype(np.float32),
        "speech_lengths": np.full((b,), n, np.int32),
        "text": rng.randint(1, vocab - 1, (b, u)).astype(np.int32),
        "text_lengths": np.full((b,), u, np.int32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--secs", type=float, default=15.0)
    ap.add_argument("--labels", type=int, default=40)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--encoder", default="conformer", choices=sorted(ENCODERS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    cfg = bench_config(torch.bfloat16, args.encoder)
    model = init_random_(ASRModel(cfg), torch.Generator().manual_seed(0))
    tx = build_optimizer("fused_adam", lr=2e-3, schedule="warmuplr",
                         warmup_steps=25000, d_model=cfg.d_model)
    step = make_train_step(model, tx, device="cuda")
    state = TrainState.create(model, tx)
    batch = _batch(args.batch, args.secs, args.labels, cfg.vocab_size,
                   "cuda")
    gen = torch.Generator().manual_seed(0)
    state, _ = step(state, batch, gen)  # warm-up: builds the kernels
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
    t = time.perf_counter()
    state, stats = step(state, batch, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t

    averages = prof.key_averages()
    events = [e for e in averages if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA]
    if not events:  # kernels folded into their operators' entries
        events = [e for e in averages if e.self_device_time_total > 0]
    rows = sorted(events, key=lambda e: e.self_device_time_total,
                  reverse=True)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"{args.encoder} train step B={args.batch} x {args.secs} s: "
          f"wall {wall * 1e3:.1f} "
          f"ms (host clock, unprofiled), loss {float(stats['loss']):.4f}; "
          f"device time of the profiled step {device_ms:.1f} ms (idle share "
          f"of the wall {max(0.0, 1 - device_ms / 1e3 / wall):.3f})",
          flush=True)
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  kernel", flush=True)
    for e in rows[:args.top]:
        ms = e.self_device_time_total / 1e3
        print(f"{ms:10.3f} {ms / device_ms:6.3f} {e.count:6d}  "
              f"{e.key[:110]}", flush=True)


if __name__ == "__main__":
    main()
