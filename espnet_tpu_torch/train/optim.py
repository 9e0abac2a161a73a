"""The fused flat Adam update (port of `FlatAdam` in
espnet_tpu/train/optim.py and its update in espnet_tpu/train/steps.py).

One pass over the model's parameters as one float32 vector: clip by global
norm, NaN-skip and Adam. Semantics as the JAX package's: lr = sched(count)
with the count *before* its increment, bias correction with the count
*after* it, and a step whose gradient norm is not finite leaves the
parameters, mu, nu and the count untouched. The parameters, mu and nu are
updated in place (the JAX package returns new arrays).
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


@dataclasses.dataclass(frozen=True)
class FlatAdam:
    """Clip + NaN-skip + Adam over a flat float32 parameter vector."""

    sched: Callable
    b1: float = 0.9
    b2: float = 0.98
    eps: float = 1e-9
    grad_clip: float = 5.0

    def init(self, flat_params: torch.Tensor) -> Dict[str, torch.Tensor]:
        if flat_params.ndim != 1:
            raise ValueError("FlatAdam requires a flat parameter vector")
        z = torch.zeros_like(flat_params, dtype=torch.float32)
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=flat_params.device),
                "mu": z, "nu": z.clone()}

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


def build_optimizer(name: str = "fused_adam", lr: float = 1e-3,
                    schedule: str = "warmuplr", warmup_steps: int = 25000,
                    d_model: int = 256, betas=(0.9, 0.98), eps: float = 1e-9,
                    grad_clip: float = 5.0) -> FlatAdam:
    """The optimizer of this slice: "fused_adam" (FlatAdam) only."""
    if name != "fused_adam":
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (only fused_adam)")
    sched = build_schedule(schedule, lr, warmup_steps=warmup_steps,
                           d_model=d_model)
    return FlatAdam(sched=sched, b1=betas[0], b2=betas[1], eps=eps,
                    grad_clip=grad_clip or 0.0)
