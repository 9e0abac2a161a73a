"""Train and eval steps (port of espnet_tpu/train/steps.py).

`make_train_step(model, optimizer, device)` returns
`train_step(state, batch, generator) -> (state, stats)`: forward, backward,
then the flat optimizer's update (clip by global norm, NaN-skip, then Adam,
AdamW, SGD or Adadelta: `train/optim.py`). The model's parameters are views
of `state.params`, one float32 vector that the update changes in place.
`accum_steps > 1` splits the batch into equal micro-batches
(the largest divisor of B not above accum_steps), runs forward and backward
on each in turn, and averages their gradients and stats before one update,
as the JAX package's micro-batch scan does. All randomness (dropout, SpecAug,
the FFN kernels' seeds) comes from `generator`. `batch_keys` names the
batch fields that the model takes, in order (the ASR models' `BATCH_KEYS`
by default; the JAX steps' `batch_arg_names`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
from torch import nn

from espnet_tpu_torch.device import resolve_device
from espnet_tpu_torch.train.optim import (FlatOptimizer, flat_grads,
                                          flatten_parameters_)

BATCH_KEYS = ("speech", "speech_lengths", "text", "text_lengths")


@dataclasses.dataclass
class TrainState:
    step: int
    params: torch.Tensor  # flat float32; the model's parameters view it
    opt_state: Dict[str, torch.Tensor]

    @classmethod
    def create(cls, model: nn.Module,
               optimizer: FlatOptimizer) -> "TrainState":
        """Flatten `model`'s parameters in place (on their device) and
        initialise the optimizer state."""
        flat = flatten_parameters_(model)
        return cls(step=0, params=flat, opt_state=optimizer.init(flat))


def _to_device(batch, device, keys=BATCH_KEYS) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(batch[k]).to(device, non_blocking=True)
            for k in keys}


def make_train_step(model: nn.Module, optimizer: FlatOptimizer,
                    device="cuda", accum_steps: int = 1,
                    batch_keys: Tuple[str, ...] = BATCH_KEYS) -> Callable:
    """Move `model` to `device` (the CUDA card unless "cpu" is asked for;
    raises without a card) and return its train step. Create the state with
    `TrainState.create(model, optimizer)` afterwards."""
    if not (callable(getattr(optimizer, "init", None))
            and callable(getattr(optimizer, "apply_", None))):
        raise TypeError("the port's train step takes a flat optimizer "
                        "(init, apply_: train/optim.py FlatOptimizer)")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    model.to(dev)

    def train_step(state: TrainState, batch, generator: torch.Generator
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.params.device != dev:
            raise ValueError(f"state on {state.params.device}, step on {dev}")
        model.train()
        data = _to_device(batch, dev, batch_keys)
        b = data[batch_keys[0]].shape[0]
        n_micro = max(1, min(accum_steps, b))
        while b % n_micro:
            n_micro -= 1
        size = b // n_micro
        for p in model.parameters():
            p.grad = None
        totals: Dict[str, torch.Tensor] = {}
        for i in range(n_micro):
            mb = [data[k][i * size:(i + 1) * size] for k in batch_keys]
            loss, stats = model(*mb, generator=generator)
            loss.backward()
            for k, v in stats.items():
                v = v.detach().float()
                totals[k] = totals[k] + v if k in totals else v
        grads = flat_grads(model)
        if n_micro > 1:
            grads = grads * (1.0 / n_micro)
        for p in model.parameters():
            p.grad = None
        stats = {k: v / n_micro for k, v in totals.items()}
        stats["grad_norm"], stats["skipped"] = optimizer.apply_(
            state.params, grads, state.opt_state)
        state.step += 1
        return state, stats

    return train_step


def make_eval_step(model: nn.Module, device="cuda",
                   batch_keys: Tuple[str, ...] = BATCH_KEYS) -> Callable:
    """eval_step(state, batch) -> stats of the deterministic forward (no
    dropout, no SpecAug, no gradient)."""
    dev = resolve_device(device)
    model.to(dev)

    @torch.no_grad()
    def eval_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            data = _to_device(batch, dev, batch_keys)
            _, stats = model(*(data[k] for k in batch_keys))
        finally:
            model.train(was_training)
        return {k: v.float() for k, v in stats.items()}

    return eval_step
