# Copy of espnet_tpu/train/reporter.py (the port imports nothing of
# espnet_tpu); its imports point at the port's modules.
"""Metrics reporter.

Behavioral spec: reference `espnet2/train/reporter.py` (`Reporter:275` /
`SubReporter:113`): per-epoch registration of weighted stats, aggregation,
best-epoch tracking per (phase, metric), early-stop check, state_dict for
checkpointing, and phase timing via `measure_time`.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple


class SubReporter:
    """Accumulates weighted stats for one (epoch, phase)."""

    def __init__(self, phase: str, epoch: int):
        self.phase = phase
        self.epoch = epoch
        self._sum: Dict[str, float] = defaultdict(float)
        self._weight: Dict[str, float] = defaultdict(float)
        self.count = 0

    def register(self, stats: Dict[str, float], weight: float = 1.0) -> None:
        self.count += 1
        for k, v in stats.items():
            if v is None:
                continue
            v = float(v)
            if v != v:  # nan — skip but keep key visible
                continue
            self._sum[k] += v * weight
            self._weight[k] += weight

    @contextmanager
    def measure_time(self, name: str):
        t0 = time.perf_counter()
        yield
        self.register({name: time.perf_counter() - t0})

    def mean(self) -> Dict[str, float]:
        return {
            k: self._sum[k] / self._weight[k]
            for k in self._sum
            if self._weight[k] > 0
        }

    def log_message(self, idx: Optional[int] = None, total: Optional[int] = None) -> str:
        head = f"{self.epoch}epoch:{self.phase}"
        if idx is not None:
            head += f":{idx}/{total}batch"
        body = ", ".join(f"{k}={v:.4g}" for k, v in sorted(self.mean().items()))
        return f"{head}: {body}"


class Reporter:
    """Cross-epoch store with best-epoch queries and early stopping."""

    def __init__(self):
        self.epochs: Dict[int, Dict[str, Dict[str, float]]] = {}
        self.epoch = 0

    def start_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.epochs.setdefault(epoch, {})

    def finish_phase(self, sub: SubReporter) -> Dict[str, float]:
        mean = sub.mean()
        self.epochs.setdefault(sub.epoch, {})[sub.phase] = mean
        return mean

    def get(self, epoch: int, phase: str, key: str) -> Optional[float]:
        return self.epochs.get(epoch, {}).get(phase, {}).get(key)

    def sort_epochs(self, phase: str, key: str, mode: str = "min") -> List[Tuple[int, float]]:
        vals = [
            (e, d[phase][key])
            for e, d in self.epochs.items()
            if phase in d and key in d[phase]
        ]
        return sorted(vals, key=lambda x: x[1], reverse=(mode == "max"))

    def best_epoch(self, phase: str, key: str, mode: str = "min") -> Optional[int]:
        s = self.sort_epochs(phase, key, mode)
        return s[0][0] if s else None

    def check_early_stopping(
        self, patience: int, phase: str, key: str, mode: str = "min"
    ) -> bool:
        best = self.best_epoch(phase, key, mode)
        if best is None:
            return False
        return (self.epoch - best) > patience

    def state_dict(self) -> dict:
        return {"epochs": {str(k): v for k, v in self.epochs.items()},
                "epoch": self.epoch}

    def load_state_dict(self, state: dict) -> None:
        self.epochs = {int(k): v for k, v in state["epochs"].items()}
        self.epoch = state["epoch"]


def matplotlib_plot(reporter: "Reporter", out_dir) -> None:
    """Write per-metric training curves (reference
    `espnet2/train/reporter.py:492` Reporter.matplotlib_plot)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from pathlib import Path

    out = Path(out_dir) / "images"
    out.mkdir(parents=True, exist_ok=True)
    keys = sorted({
        k for d in reporter.epochs.values()
        for stats in d.values() for k in stats
    })
    for key in keys:
        fig, ax = plt.subplots(figsize=(6, 4))
        plotted = False
        for phase in sorted({p for d in reporter.epochs.values() for p in d}):
            xs = sorted(e for e, d in reporter.epochs.items()
                        if key in d.get(phase, {}))
            if not xs:
                continue
            ys = [reporter.epochs[e][phase][key] for e in xs]
            ax.plot(xs, ys, marker="x", label=phase)
            plotted = True
        if not plotted:
            plt.close(fig)
            continue
        ax.set_xlabel("epoch")
        ax.set_title(key)
        ax.grid(True)
        ax.legend()
        fig.savefig(out / f"{key}.png", bbox_inches="tight")
        plt.close(fig)


class TensorboardLogger:
    """Per-epoch scalar logging (reference `espnet2/train/trainer.py:255-265`
    TensorBoard emit); no-op when tensorboardX is unavailable."""

    def __init__(self, out_dir):
        try:
            from tensorboardX import SummaryWriter

            from pathlib import Path

            self.writer = SummaryWriter(str(Path(out_dir) / "tensorboard"))
        except Exception:
            self.writer = None

    def log_epoch(self, epoch: int, phase: str, stats: Dict[str, float]):
        if self.writer is None:
            return
        for k, v in stats.items():
            self.writer.add_scalar(f"{phase}/{k}", v, epoch)
        self.writer.flush()

    def close(self):
        if self.writer is not None:
            self.writer.close()


class WandbLogger:
    """Per-epoch Weights & Biases logging (reference
    `espnet2/train/trainer.py` wandb emit, enabled by --use_wandb at
    `espnet2/tasks/abs_task.py:1305`); no-op when wandb is unavailable
    (it is not baked into this image — gated import, never a hard dep)."""

    def __init__(self, enabled: bool, project: str = "", name: str = "",
                 config: dict = None):
        self.run = None
        if not enabled:
            return
        try:
            import wandb

            self.run = wandb.init(
                project=project or "espnet-tpu", name=name or None,
                config=config or {}, resume="allow",
            )
        except Exception as e:  # pragma: no cover - wandb not installed
            import logging

            logging.getLogger("espnet_tpu").warning(
                "wandb unavailable, disabling: %s", e)

    def log_epoch(self, epoch: int, phase: str, stats: Dict[str, float]):
        if self.run is None:
            return
        self.run.log({f"{phase}/{k}": v for k, v in stats.items()},
                     step=epoch)

    def close(self):
        if self.run is not None:
            self.run.finish()
