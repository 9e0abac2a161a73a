"""Optimizers over the model's parameters as one float32 vector (port of
espnet_tpu/train/optim.py and of the updates in espnet_tpu/train/steps.py).

Every optimizer here is a `FlatOptimizer`: `init(flat_params)` gives its
state (a dict of tensors with the int32 step `count`), and
`apply_(params, grads, state)` updates the parameters and the state in
place and returns (grad_norm, skipped). Each clips by global norm, then
skips a step whose gradient norm is not finite: the parameters, the state
and the count stay as they were, as the JAX train step's NaN-skip keeps
them. The rate is `sched(count)` with the count before its increment.

`build_optimizer` takes the JAX package's names:

* `fused_adam` and `adam`: `FlatAdam`, the same math as optax's
  chain(clip_by_global_norm, adam) plus the NaN-skip in one pass;
* `adamw`: optax `adamw`, Adam plus decoupled weight decay added to the
  update before it is scaled by the schedule's rate;
* `sgd`: optax `sgd` with momentum 0.9, no Nesterov;
* `adadelta`: optax `adadelta` with its defaults (rho 0.9, eps 1e-6).

The optax updates are written in optax's order of operations, so float32
results agree with it to rounding. These are PyTorch ops, not kernels: the
JAX package runs them as optax under XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
from torch import nn

from espnet_tpu_torch.train.schedulers import build_schedule


def flatten_parameters_(model: nn.Module) -> torch.Tensor:
    """Move every parameter of `model` into one contiguous float32 vector
    and make each parameter a view of it, in place; returns the vector."""
    params = list(model.parameters())
    if any(p.dtype != torch.float32 for p in params):
        raise TypeError("flat parameters must all be float32")
    device = params[0].device
    flat = torch.empty(sum(p.numel() for p in params), dtype=torch.float32,
                       device=device)
    off = 0
    with torch.no_grad():
        for p in params:
            n = p.numel()
            flat[off:off + n].copy_(p.reshape(-1))
            p.data = flat[off:off + n].view_as(p)
            off += n
    return flat


def flat_grads(model: nn.Module) -> torch.Tensor:
    """The parameters' gradients as one float32 vector (zeros where a
    parameter got none), in `flatten_parameters_`'s order."""
    return torch.cat([
        (p.grad if p.grad is not None else torch.zeros_like(p))
        .reshape(-1).float() for p in model.parameters()])


class FlatOptimizer:
    """The interface of the port's optimizers (see the module docstring).
    Subclasses set `sched` and `grad_clip` and define `init` and
    `apply_`."""

    sched: Callable
    grad_clip: float

    def init(self, flat_params: torch.Tensor) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def apply_(self, params: torch.Tensor, grads: torch.Tensor,
               state: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError


def _check_flat(flat_params: torch.Tensor) -> None:
    if flat_params.ndim != 1:
        raise ValueError("a flat optimizer needs a flat parameter vector")


def _count(flat_params: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=flat_params.device)


@dataclasses.dataclass(frozen=True)
class FlatAdam(FlatOptimizer):
    """Clip + NaN-skip + Adam over a flat float32 parameter vector."""

    sched: Callable
    b1: float = 0.9
    b2: float = 0.98
    eps: float = 1e-9
    grad_clip: float = 5.0

    def init(self, flat_params: torch.Tensor) -> Dict[str, torch.Tensor]:
        _check_flat(flat_params)
        z = torch.zeros_like(flat_params, dtype=torch.float32)
        return {"count": _count(flat_params), "mu": z, "nu": z.clone()}

    @torch.no_grad()
    def apply_(self, params: torch.Tensor, grads: torch.Tensor,
               state: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Update `params` and `state` in place; returns (grad_norm,
        skipped) as float32 tensors."""
        g = grads.float()
        gnorm = torch.sqrt(torch.sum(g * g))
        finite = torch.isfinite(gnorm)
        if self.grad_clip and self.grad_clip > 0:
            scale = torch.clamp(self.grad_clip / gnorm.clamp(min=1e-12),
                                max=1.0)
        else:
            scale = torch.ones((), device=g.device)
        gs = torch.where(finite, g * scale, torch.zeros_like(g))
        count = state["count"]
        cnt = count + finite.to(torch.int32)
        lr = self.sched(count)
        bc1 = 1.0 - torch.pow(self.b1, cnt.float())
        bc2 = 1.0 - torch.pow(self.b2, cnt.float())
        mu = self.b1 * state["mu"] + (1.0 - self.b1) * gs
        nu = self.b2 * state["nu"] + (1.0 - self.b2) * gs * gs
        p2 = params - lr * (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
        params.copy_(torch.where(finite, p2, params))
        state["mu"].copy_(torch.where(finite, mu, state["mu"]))
        state["nu"].copy_(torch.where(finite, nu, state["nu"]))
        state["count"].copy_(cnt)
        return gnorm, 1.0 - finite.float()


class _ClipChain(FlatOptimizer):
    """optax chain(clip_by_global_norm, <update>) under the JAX train
    step's NaN-skip; subclasses give the update (`_update`) and the names
    of their state vectors (`slots`)."""

    slots: Tuple[str, ...] = ()

    def init(self, flat_params: torch.Tensor) -> Dict[str, torch.Tensor]:
        _check_flat(flat_params)
        state = {"count": _count(flat_params)}
        for name in self.slots:
            state[name] = torch.zeros_like(flat_params, dtype=torch.float32)
        return state

    def _update(self, g, params, state, count):
        """(the step's update before the rate, new slot vectors)."""
        raise NotImplementedError

    @torch.no_grad()
    def apply_(self, params: torch.Tensor, grads: torch.Tensor,
               state: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        g = grads.float()
        gnorm = torch.sqrt(torch.sum(g * g))
        finite = torch.isfinite(gnorm)
        if self.grad_clip and self.grad_clip > 0:
            # optax clip_by_global_norm: select(norm < max, g, g / norm * max)
            g = torch.where(gnorm < self.grad_clip, g,
                            (g / gnorm) * self.grad_clip)
        count = state["count"]
        u, slots = self._update(g, params, state, count)
        # optax scale_by_learning_rate: the update times -sched(count)
        lr = -self.sched(count)
        p2 = params + lr.to(u.dtype) * u
        params.copy_(torch.where(finite, p2, params))
        for name, value in slots.items():
            state[name].copy_(torch.where(finite, value, state[name]))
        state["count"].copy_(count + finite.to(torch.int32))
        return gnorm, 1.0 - finite.float()


@dataclasses.dataclass(frozen=True)
class FlatAdamW(_ClipChain):
    """optax adamw: scale_by_adam, add_decayed_weights, then the rate."""

    sched: Callable
    b1: float = 0.9
    b2: float = 0.98
    eps: float = 1e-9
    weight_decay: float = 1e-4
    grad_clip: float = 5.0
    slots = ("mu", "nu")

    def _update(self, g, params, state, count):
        mu = (1 - self.b1) * g + self.b1 * state["mu"]
        nu = (1 - self.b2) * (g * g) + self.b2 * state["nu"]
        cnt = (count + 1).float()
        mu_hat = mu / (1 - torch.pow(self.b1, cnt))
        nu_hat = nu / (1 - torch.pow(self.b2, cnt))
        u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        u = u + self.weight_decay * params
        return u, {"mu": mu, "nu": nu}


@dataclasses.dataclass(frozen=True)
class FlatSGD(_ClipChain):
    """optax sgd with momentum (trace, no Nesterov), then the rate."""

    sched: Callable
    momentum: float = 0.9
    grad_clip: float = 5.0
    slots = ("trace",)

    def _update(self, g, params, state, count):
        trace = g + self.momentum * state["trace"]
        return trace, {"trace": trace}


@dataclasses.dataclass(frozen=True)
class FlatAdadelta(_ClipChain):
    """optax adadelta: scale_by_adadelta(rho, eps), then the rate (its
    weight decay is 0, as build_optimizer leaves it)."""

    sched: Callable
    rho: float = 0.9
    eps: float = 1e-6
    grad_clip: float = 5.0
    slots = ("e_g", "e_x")

    def _update(self, g, params, state, count):
        e_g = (1 - self.rho) * (g * g) + self.rho * state["e_g"]
        u = (torch.sqrt(state["e_x"] + self.eps)
             / torch.sqrt(e_g + self.eps)) * g
        e_x = (1 - self.rho) * (u * u) + self.rho * state["e_x"]
        return u, {"e_g": e_g, "e_x": e_x}


def build_optimizer(name: str = "adam", lr: float = 1e-3,
                    schedule: str = "warmuplr", warmup_steps: int = 25000,
                    d_model: int = 256, weight_decay: float = 0.0,
                    betas=(0.9, 0.98), eps: float = 1e-9,
                    grad_clip: float = 5.0, momentum: float = 0.9
                    ) -> FlatOptimizer:
    """The JAX package's `build_optimizer` (same arguments in the same
    order, without its optax-only `flatten`), each as a flat optimizer."""
    sched = build_schedule(schedule, lr, warmup_steps=warmup_steps,
                           d_model=d_model)
    clip = grad_clip or 0.0
    if name in ("fused_adam", "adam"):
        return FlatAdam(sched=sched, b1=betas[0], b2=betas[1], eps=eps,
                        grad_clip=clip)
    if name == "adamw":
        return FlatAdamW(sched=sched, b1=betas[0], b2=betas[1], eps=eps,
                         weight_decay=weight_decay, grad_clip=clip)
    if name == "sgd":
        return FlatSGD(sched=sched, momentum=momentum, grad_clip=clip)
    if name == "adadelta":
        return FlatAdadelta(sched=sched, grad_clip=clip)
    raise ValueError(f"unknown optimizer {name}")
