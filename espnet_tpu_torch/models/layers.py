"""Float32 parameters, computation in the model's dtype.

The JAX package keeps parameters in float32 and casts them to the compute
dtype (bfloat16 for the bench model) inside each flax layer; these layers
(Dense, Conv1d, LayerNorm) do the same. LayerNorm normalises in float32 with eps 1e-6 (flax's
default, not torch's 1e-5) and returns the compute dtype.

`KernelRouted` is the base of the port's models: one switch between the
CUDA kernels and their plain versions. `LSTMCell` is flax's `OptimizedLSTMCell` written out, shared by the
transducer's prediction network, the v1 RNN encoder and decoder and the
beamformer's mask estimator: per gate an input kernel without bias (`ii`,
`if`, `ig`, `io`) and a recurrent kernel with bias (`hi`, ...), gate order
i, f, g, o, sigmoid gates, tanh candidate, no forget-bias offset, carry
(c, h). Its pre-activations are formed in the compute dtype (as flax
does), the gates and the carry in float32; a cell built with float32 is
the flax cell without a `dtype`, which promotes a bfloat16 input to the
float32 of its parameters. `lstm_sequence` runs a cell over a padded
(B, T, D) batch as flax's `nn.RNN` does without `seq_lengths`: every step
of the padded length, the reversed direction starting at the padding.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

LN_EPS = 1e-6


class KernelRouted(nn.Module):
    """A model whose kernel wrappers can all take their plain versions:
    `use_kernels` (True by default) routes its losses, `set_use_kernels`
    also every submodule with a `use_kernel` switch (chip_smoke.py holds
    the two routes against each other on the card)."""

    use_kernels = True

    def set_use_kernels(self, enabled: bool) -> None:
        self.use_kernels = enabled
        for module in self.modules():
            if hasattr(module, "use_kernel"):
                module.use_kernel = enabled


class Dense(nn.Linear):
    """nn.Linear whose input, weight and bias are cast to `dtype`."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 dtype=torch.float32):
        super().__init__(d_in, d_out, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return nn.functional.linear(x.to(dt), self.weight.to(dt), b)


class Conv1d(nn.Conv1d):
    """flax `nn.Conv` over channel-last (N, L, C) input, computed in
    `dtype`, "SAME" padding (odd kernels: symmetric, also dilated)."""

    def __init__(self, c_in: int, c_out: int, kernel: int, groups: int = 1,
                 bias: bool = True, dtype=torch.float32, dilation: int = 1):
        super().__init__(c_in, c_out, kernel,
                         padding=(kernel - 1) * dilation // 2,
                         dilation=dilation, groups=groups, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        y = nn.functional.conv1d(x.to(dt).transpose(1, 2),
                                 self.weight.to(dt), b,
                                 padding=self.padding, dilation=self.dilation,
                                 groups=self.groups)
        return y.transpose(1, 2)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm with eps 1e-6, computed in float32, returned in `dtype`."""

    def __init__(self, d: int, dtype=torch.float32):
        super().__init__(d, eps=LN_EPS)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = nn.functional.layer_norm(x.float(), self.normalized_shape,
                                     self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm` over the last axis of (..., C), in float32 with
    eps 1e-5 and momentum 0.9: in training mode it normalises with the
    batch's statistics over every other axis (padding included; the
    variance E[x^2] - E[x]^2, biased, floored at 0) and updates the running
    buffers `mean` and `var` (the JAX `batch_stats` collection) in place as
    flax does, new = 0.9 old + 0.1 batch; in eval mode it uses them.
    `torch.nn.BatchNorm1d` keeps the unbiased variance, hence this module.
    The output is in the input's dtype."""

    def __init__(self, c: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            dims = tuple(range(xf.ndim - 1))
            mean = xf.mean(dims)
            var = ((xf * xf).mean(dims) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_((1.0 - m) * mean.detach())
                self.var.mul_(m).add_((1.0 - m) * var.detach())
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias  # flax's order: the scale folds into the rsqrt
        return y.to(x.dtype)


def batch_stat_buffers(model: nn.Module):
    """Every BatchNorm running buffer of `model` (the JAX `batch_stats`)."""
    return [b for m in model.modules() if isinstance(m, BatchNorm)
            for b in (m.mean, m.var)]


GATES = ("i", "f", "g", "o")


class LSTMCell(nn.Module):
    """flax `OptimizedLSTMCell`: i = sigmoid(W_ii x + W_hi h + b_hi), f, o
    alike, g = tanh(...), c' = f c + i g, h' = o tanh(c')."""

    def __init__(self, d_in: int, hidden: int, dtype=torch.float32):
        super().__init__()
        self.hidden = hidden
        self.dtype = dtype
        for g in GATES:
            self.add_module(f"i{g}", Dense(d_in, hidden, bias=False,
                                           dtype=dtype))
            self.add_module(f"h{g}", Dense(hidden, hidden, dtype=dtype))

    def input_proj(self, x):
        """(..., d_in) -> (..., 4H): the four input kernels at once."""
        w = torch.cat([getattr(self, f"i{g}").weight for g in GATES])
        return nn.functional.linear(x.to(self.dtype), w.to(self.dtype))

    def recurrent(self):
        """(W (4H, H), bias (4H,)) of the four hidden kernels at once, in
        the compute dtype: formed once for a sequence, not once a step."""
        dt = self.dtype
        w = torch.cat([getattr(self, f"h{g}").weight for g in GATES])
        bias = torch.cat([getattr(self, f"h{g}").bias for g in GATES])
        return w.to(dt), bias.to(dt)

    def step(self, carry, x_proj, rec=None):
        """carry (c, h) float32 (B, H), x_proj (B, 4H) -> new carry; `rec`
        is `recurrent()` when the caller holds it."""
        c, h = carry
        w, bias = self.recurrent() if rec is None else rec
        pre = (nn.functional.linear(h.to(self.dtype), w, bias)
               + x_proj).float()
        i, f, g, o = pre.chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return new_c, new_h

    def zero_carry(self, batch: int, device=None):
        z = torch.zeros(batch, self.hidden, device=device)
        return z, z


def lstm_sequence(cell: LSTMCell, x: torch.Tensor, reverse: bool = False,
                  carry: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Run `cell` over every step of x (B, T, D) from `carry` (zeros when
    None), last step first when `reverse`; returns (outputs (B, T, H)
    float32 in the input's time order, the final carry)."""
    b, t, _ = x.shape
    # unbind: one backward for all steps (indexing a step at a time would
    # materialise and add a full (B, T, 4H) gradient a step)
    proj = cell.input_proj(x).unbind(1)  # T x (B, 4H)
    rec = cell.recurrent()
    if carry is None:
        carry = cell.zero_carry(b, x.device)
    outs = [None] * t
    for k in (range(t - 1, -1, -1) if reverse else range(t)):
        carry = cell.step(carry, proj[k], rec)
        outs[k] = carry[1]
    if t == 0:
        return x.new_zeros(b, 0, cell.hidden, dtype=torch.float32), carry
    return torch.stack(outs, 1), carry
