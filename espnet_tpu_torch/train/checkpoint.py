"""Checkpoints (port of espnet_tpu/train/checkpoint.py).

The experiment directory holds the JAX package's files under the same names
and layouts, so either package reads the other's:

* `ep<N>.params.msgpack`: the epoch's parameters as the JAX param tree
  (`convert.model_params`: stacked for a scan_encoder_layers conformer), in
  flax's msgpack (`train/msgpack_io.py`);
* `<phase>.<key>.best.params.msgpack`: a symlink to the best epoch's file;
* `<phase>.<key>.ave.params.msgpack`: the float64 mean of the n best
  epochs' files, written as float32 (non-float leaves from the first);
* `checkpoint.meta.json`: the last epoch and the reporter's state.

The resume state is the port's own, `checkpoint.pt` (torch.save of the step,
the flat parameters, the optimizer state and the step generator's state):
the JAX `checkpoint.msgpack` holds Adam's moments in `ravel_pytree`'s
order, which is not the port's flat order, so resuming across packages is
not ported (ROADMAP.md queue 1 item 3) and `load_state` raises for a
directory that has only the JAX file.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from espnet_tpu_torch.convert import model_params
from espnet_tpu_torch.train.msgpack_io import load_tree, save_tree


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


class CheckpointManager:
    """Manages <out>/checkpoint.pt (resume), <out>/ep<N>.params.msgpack,
    best-epoch links, n-best pruning and averaging."""

    def __init__(self, out_dir, keep_nbest: int = 10):
        self.out = Path(out_dir)
        self.out.mkdir(parents=True, exist_ok=True)
        self.keep_nbest = keep_nbest

    # --- full training state (resume) ---
    def save_state(self, state, epoch: int, reporter_state: dict,
                   generator_state: Optional[torch.Tensor] = None) -> None:
        """`state`: the train step's TrainState (flat params, optimizer
        state); written before the meta file, which names the epoch."""
        blob = {"step": int(state.step),
                "params": state.params.detach().cpu(),
                "opt_state": {k: v.detach().cpu()
                              for k, v in state.opt_state.items()},
                "generator": generator_state}
        tmp = self.out / "checkpoint.pt.tmp"
        torch.save(blob, tmp)
        tmp.replace(self.out / "checkpoint.pt")
        meta = {"epoch": epoch, "reporter": reporter_state}
        (self.out / "checkpoint.meta.json").write_text(json.dumps(meta))

    def has_checkpoint(self) -> bool:
        """True where the port can resume; raises where only the JAX
        package's resume state is there."""
        if (self.out / "checkpoint.pt").exists():
            return True
        if (self.out / "checkpoint.msgpack").exists():
            raise RuntimeError(
                f"{self.out} holds the JAX package's checkpoint.msgpack and "
                "no checkpoint.pt: resuming a JAX run in the port is not "
                "ported (ROADMAP.md queue 1 item 3, cross-package resume; "
                "the two order Adam's moments differently). Pass --run.resume "
                "false to start afresh, or resume with the JAX package.")
        return False

    def load_state(self, state) -> Tuple[object, int, dict,
                                         Optional[torch.Tensor]]:
        """Load checkpoint.pt into `state` in place; returns (state, last
        epoch, reporter state, generator state)."""
        blob = torch.load(self.out / "checkpoint.pt", map_location="cpu",
                          weights_only=True)
        if blob["params"].shape != state.params.shape:
            raise ValueError(
                f"checkpoint.pt holds {blob['params'].numel()} parameters, "
                f"the model {state.params.numel()}")
        with torch.no_grad():
            state.params.copy_(blob["params"])
            for k, v in blob["opt_state"].items():
                state.opt_state[k].copy_(v)
        state.step = blob["step"]
        meta = json.loads((self.out / "checkpoint.meta.json").read_text())
        return state, meta["epoch"], meta["reporter"], blob["generator"]

    # --- per-epoch params ---
    def params_path(self, epoch: int) -> Path:
        return self.out / f"ep{epoch}.params.msgpack"

    def save_epoch_params(self, model: torch.nn.Module, epoch: int) -> None:
        save_tree(self.params_path(epoch), model_params(model))

    def link_best(self, epoch: int, tag: str) -> None:
        """tag like 'valid.acc.best' -> symlink to epoch params."""
        link = self.out / f"{tag}.params.msgpack"
        if link.is_symlink() or link.exists():
            link.unlink()
        link.symlink_to(self.params_path(epoch).name)

    def prune(self, keep_epochs: List[int]) -> None:
        """Remove ep*.params files not in keep_epochs."""
        keep = {self.params_path(e).name for e in keep_epochs}
        for p in self.out.glob("ep*.params.msgpack"):
            if p.name not in keep:
                p.unlink()

    def average_nbest(self, epochs: List[int], tag: str) -> Dict:
        """Average the params of `epochs` in float64, save as
        <tag>.ave.params.msgpack (float leaves as float32, others from the
        first epoch); returns the averaged tree."""
        trees = [load_tree(self.params_path(e)) for e in epochs]
        acc = _tree_map(lambda *xs: sum(np.asarray(x, np.float64)
                                        for x in xs), *trees)
        n = len(trees)
        ave = _tree_map(
            lambda a, f: (a / n).astype(np.float32)
            if np.issubdtype(np.asarray(f).dtype, np.floating) else f,
            acc, trees[0])
        save_tree(self.out / f"{tag}.ave.params.msgpack", ave)
        return ave
