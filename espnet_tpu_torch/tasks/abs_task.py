"""Generic task runner (port of espnet_tpu/tasks/abs_task.py).

A task is sections of dataclass config + builders + a run(). The sections,
fields and defaults are the JAX package's, and `config.yaml` is written and
read with the port's YAML codec (`utils/config.py`), so each package reads
the other's experiment directory. The device is not part of the config:
`main` takes `--device cuda|cpu` (default cuda: the card, raising without
one) out of argv before the config is parsed, and never writes it to
`config.yaml`.
"""

from __future__ import annotations

import dataclasses
import logging
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Type

from espnet_tpu_torch.utils.config import (
    dataclass_from_dict, dataclass_to_dict, dump_yaml, dumps_yaml, load_yaml,
    merge_dicts, parse_cli_overrides,
)

logger = logging.getLogger("espnet_tpu")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    output_dir: str = "exp"
    max_epoch: int = 40
    seed: int = 0
    patience: Optional[int] = None
    keep_nbest: int = 10
    best_metric: str = "valid.acc.max"  # phase.key.mode
    log_interval: int = 50
    resume: bool = True
    collect_stats: bool = True
    # micro-batch gradient accumulation inside the step
    accum_grad: int = 1
    # build tokenizer/stats then exit
    stats_only: bool = False
    # comma-separated init_param specs "path:src:dst:excludes"
    init_param: str = ""
    # per-epoch attention heat maps (train/plot.py)
    plot_attention: bool = False
    use_wandb: bool = False
    wandb_project: str = ""
    # torch.profiler trace of N steady-state steps of the first epoch
    profile_steps: int = 0
    # the JAX package's field and default, kept so that both packages read
    # the same config.yaml; unused by the port
    ngpu_note: str = "unused — device parallelism is via jax mesh"


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    name: str = "adam"
    lr: float = 2e-3
    schedule: str = "warmuplr"
    warmup_steps: int = 25000
    weight_decay: float = 0.0
    grad_clip: float = 5.0
    b1: float = 0.9
    b2: float = 0.98
    eps: float = 1.0e-9


def pop_device(argv: List[str]) -> Tuple[str, List[str]]:
    """("cuda" or the value of --device, argv without it)."""
    out, device, i = [], "cuda", 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--device":
            if i + 1 >= len(argv):
                raise ValueError("missing value for --device")
            device = argv[i + 1]
            i += 2
            continue
        if arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            out.append(arg)
        i += 1
    return device, out


class AbsTask:
    """Subclasses define `sections` (name -> dataclass) and `run(cfg)`."""

    name = "abs"
    sections: Dict[str, Type] = {"run": RunConfig, "optim": OptimConfig}

    @classmethod
    def parse_config(cls, argv) -> Dict[str, Any]:
        overrides = parse_cli_overrides(list(argv))
        base: Dict[str, Any] = {}
        if "config" in overrides:
            base = load_yaml(overrides.pop("config"))
        raw = merge_dicts(base, overrides)
        print_and_exit = bool(raw.pop("print_config", False))
        cfg = {}
        for sec, klass in cls.sections.items():
            cfg[sec] = dataclass_from_dict(klass, raw.pop(sec, {}))
        if raw:
            raise KeyError(
                f"unknown config sections {sorted(raw)}; "
                f"valid: {sorted(cls.sections)}"
            )
        if print_and_exit:
            sys.stdout.write(dumps_yaml(
                {s: dataclass_to_dict(v) for s, v in cfg.items()}))
            raise SystemExit(0)
        return cfg

    @classmethod
    def dump_config(cls, cfg: Dict[str, Any], output_dir) -> None:
        dump_yaml(
            {s: dataclass_to_dict(v) for s, v in cfg.items()},
            Path(output_dir) / "config.yaml",
        )

    @classmethod
    def load_config(cls, output_dir_or_yaml) -> Dict[str, Any]:
        p = Path(output_dir_or_yaml)
        if p.is_dir():
            p = p / "config.yaml"
        raw = load_yaml(p)
        return {
            sec: dataclass_from_dict(klass, raw.get(sec, {}))
            for sec, klass in cls.sections.items()
        }

    @classmethod
    def main(cls, argv=None):
        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s %(levelname)s %(message)s",
        )
        device, argv = pop_device(
            list(argv if argv is not None else sys.argv[1:]))
        cfg = cls.parse_config(argv)
        return cls.run(cfg, device=device)

    @classmethod
    def run(cls, cfg: Dict[str, Any], device="cuda"):
        raise NotImplementedError
