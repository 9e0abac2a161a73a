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
the flat parameters, the optimizer state and the step generator's state).
Where a directory holds only the JAX package's `checkpoint.msgpack` (an optax
chain of clip and the optimizer: {step, params, opt_state, extra_vars}),
`load_state` resumes from it: the parameters and the optimizer's slots
(Adam's `mu` and `nu`, SGD's `trace`, Adadelta's `e_g` and `e_x`: optax's
names, which the port's flat optimizers share), trees shaped like the
parameters, each go through the converter that maps the parameters
(`convert.jax_params_to_state_dict`) and then into the port's flat order,
leaf by leaf; the optax counts must agree and become the port's one count,
and the global-MVN statistics of `extra_vars` go to the model's buffers.
JAX's dropout key has no torch counterpart: such a resumed run seeds its
generator as a fresh run does.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from espnet_tpu_torch.convert import jax_params_to_state_dict, model_params
from espnet_tpu_torch.train.msgpack_io import load_tree, save_tree


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def average_trees(trees: List[Dict]) -> Dict:
    """The leafwise mean of param trees: float leaves summed in float64 and
    written as float32, other leaves from the first tree."""
    acc = _tree_map(lambda *xs: sum(np.asarray(x, np.float64) for x in xs),
                    *trees)
    n = len(trees)
    return _tree_map(
        lambda a, f: (a / n).astype(np.float32)
        if np.issubdtype(np.asarray(f).dtype, np.floating) else f,
        acc, trees[0])


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
        """True where a resume state of either package is there."""
        return ((self.out / "checkpoint.pt").exists()
                or (self.out / "checkpoint.msgpack").exists())

    def load_state(self, state, model: Optional[torch.nn.Module] = None
                   ) -> Tuple[object, int, dict, Optional[torch.Tensor]]:
        """Load the resume state into `state` in place; returns (state, last
        epoch, reporter state, generator state or None). `model` (whose
        parameters view `state.params`) is needed for a JAX
        checkpoint.msgpack, to place its leaves in the flat order."""
        meta = json.loads((self.out / "checkpoint.meta.json").read_text())
        if not (self.out / "checkpoint.pt").exists():
            if model is None:
                raise ValueError("resuming a JAX checkpoint.msgpack needs "
                                 "the model")
            load_jax_state(self.out / "checkpoint.msgpack", state, model)
            return state, meta["epoch"], meta["reporter"], None
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
        ave = average_trees([load_tree(self.params_path(e))
                             for e in epochs])
        save_tree(self.out / f"{tag}.ave.params.msgpack", ave)
        return ave


def _find_slots(tree, slots) -> Optional[Dict]:
    """The first node of an optax state tree that holds all of `slots`."""
    if not isinstance(tree, dict):
        return None
    if set(slots) <= set(tree):
        return tree
    for key in sorted(tree):
        hit = _find_slots(tree[key], slots)
        if hit is not None:
            return hit
    return None


def _counts(tree) -> List[int]:
    """Every `count` leaf of an optax state tree."""
    if not isinstance(tree, dict):
        return []
    out = [int(np.asarray(tree["count"]))] if "count" in tree else []
    for key in sorted(tree):
        out += _counts(tree[key]) if key != "count" else []
    return out


def _flat(tree, model: torch.nn.Module) -> torch.Tensor:
    """A tree shaped like the JAX params as one float32 vector in the
    order of `model.parameters()` (the port's flat order)."""
    sd = jax_params_to_state_dict(tree)
    names = [n for n, _ in model.named_parameters()]
    missing = sorted(set(names) - set(sd))
    if missing or len(sd) != len(names):
        raise KeyError(f"the JAX tree does not match the model: missing "
                       f"{missing[:5]}, {len(sd)} leaves for {len(names)}")
    return torch.cat([sd[n].reshape(-1) for n in names])


def load_jax_state(path, state, model: torch.nn.Module):
    """Load the JAX package's resume state `path` (checkpoint.msgpack)
    into the port's TrainState `state` and `model`'s MVN buffers, in
    place; returns `state`."""
    blob = load_tree(path)
    if not isinstance(blob.get("params"), dict):
        raise ValueError(f"{path}: flat JAX parameters (flat_optimizer) "
                         "are not read by the port")
    slots = sorted(set(state.opt_state) - {"count"})
    node = _find_slots(blob["opt_state"], slots)
    if node is None or not all(isinstance(node[k], dict) for k in slots):
        raise ValueError(f"{path}: no optimizer state with the trees "
                         f"{slots} of this run's optimizer in opt_state")
    counts = set(_counts(blob["opt_state"]))
    if len(counts) != 1:
        raise ValueError(f"{path}: the optimizer's counts disagree: "
                         f"{sorted(counts)}")
    with torch.no_grad():
        for name, tree in [("params", blob["params"])] + [
                (k, node[k]) for k in slots]:
            flat = _flat(tree, model)
            if flat.numel() != state.params.numel():
                raise ValueError(f"{path}: {name} holds {flat.numel()} "
                                 f"values, the model {state.params.numel()}")
            dst = state.params if name == "params" else state.opt_state[name]
            dst.copy_(flat)
        state.opt_state["count"].fill_(counts.pop())
        mvn = blob.get("extra_vars", {}).get("mvn")
        if mvn and hasattr(model, "mvn"):
            for key, t in jax_params_to_state_dict(
                    {"params": {}, "mvn": mvn}).items():
                model.get_buffer(key).copy_(t)
    state.step = int(np.asarray(blob["step"]))
    return state
