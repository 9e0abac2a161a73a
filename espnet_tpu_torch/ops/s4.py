"""S4D: a diagonal state-space sequence layer (port of espnet_tpu/ops/s4.py).

Two modes over the same parameters, as in the JAX package:
* convolution (teacher forcing): y = causal_conv(u, K) + D u, with
  K[h, l] = 2 Re sum_n c[h, n] bbar[h, n] abar[h, n]^l, the powers taken
  as exp(log(abar) l) (the JAX formula);
* recurrence (decoding): x_t = abar x_{t-1} + bbar u_t,
  y_t = 2 Re(c . x_t) + D u_t.

abar = exp(dt A) and bbar = (abar - 1) / A (zero-order hold, B = 1) are
complex64; the kernel and the state are never taken to bfloat16 (torch has
no bfloat16 complex). The kernel is rounded to the compute dtype, as JAX
casts it, and the convolution runs in float32; every complex product is a
sum of elementwise products, so no matrix unit (TF32) touches it.
`s4d_init` draws log dt from numpy's RandomState(seed), as JAX does.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def s4d_init(h: int, n: int, dt_min=1e-3, dt_max=1e-1, seed: int = 0):
    """S4D-Lin initialisation: A = -1/2 + i pi k, log-uniform dt."""
    rng = np.random.RandomState(seed)
    a_re = -0.5 * np.ones((h, n // 2), np.float32)
    a_im = np.pi * np.arange(n // 2, dtype=np.float32)[None, :].repeat(h, 0)
    log_dt = rng.uniform(np.log(dt_min), np.log(dt_max), (h,)).astype(
        np.float32)
    return a_re, a_im, log_dt


class S4DLayer(nn.Module):
    """Per-channel diagonal SSM along time: (B, T, H) -> (B, T, H)."""

    def __init__(self, d_model: int, state_dim: int = 64, dt_min=1e-3,
                 dt_max=1e-1, dtype=torch.float32):
        super().__init__()
        self.d_model = d_model
        self.state_dim = state_dim
        self.dtype = dtype
        n2 = state_dim // 2
        a_re, a_im, log_dt = s4d_init(d_model, state_dim, dt_min, dt_max)
        # log-parameterised negative real part keeps the system stable
        self.log_neg_a_re = nn.Parameter(torch.from_numpy(np.log(-a_re)))
        self.a_im = nn.Parameter(torch.from_numpy(a_im))
        self.log_dt = nn.Parameter(torch.from_numpy(log_dt))
        self.c_re = nn.Parameter(torch.zeros(d_model, n2))
        self.c_im = nn.Parameter(torch.zeros(d_model, n2))
        self.d = nn.Parameter(torch.ones(d_model))

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> None:
        """The JAX initialisers: c ~ N(0, 0.5^2), D = 1, A and dt from
        `s4d_init`."""
        for p in (self.c_re, self.c_im):
            p.copy_(0.5 * torch.randn(p.shape, generator=generator))
        a_re, a_im, log_dt = s4d_init(self.d_model, self.state_dim)
        self.log_neg_a_re.copy_(torch.from_numpy(np.log(-a_re)))
        self.a_im.copy_(torch.from_numpy(a_im))
        self.log_dt.copy_(torch.from_numpy(log_dt))
        self.d.fill_(1.0)

    def discretize(self):
        dt = torch.exp(self.log_dt)[:, None]
        a = torch.complex(-torch.exp(self.log_neg_a_re), self.a_im)
        abar = torch.exp(dt * a)
        bbar = (abar - 1.0) / a
        return abar, bbar, torch.complex(self.c_re, self.c_im)

    def kernel(self, length: int) -> torch.Tensor:
        """(H, L) causal kernel, rounded to the compute dtype."""
        abar, bbar, c = self.discretize()
        steps = torch.arange(length, device=abar.device, dtype=torch.float32)
        powers = torch.exp(torch.log(abar)[:, :, None] * steps)  # (H, N2, L)
        k = 2.0 * ((c * bbar)[:, :, None] * powers).sum(dim=1).real
        return k.to(self.dtype)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        t = u.shape[1]
        k = self.kernel(t).float()
        # grouped conv; torch cross-correlates, so the kernel is reversed
        y = nn.functional.conv1d(
            nn.functional.pad(u.float().transpose(1, 2), (t - 1, 0)),
            k.flip(-1)[:, None, :], groups=self.d_model).transpose(1, 2)
        return y.to(u.dtype) + u * self.d

    def init_state(self, batch: int, device=None):
        return torch.zeros(batch, self.d_model, self.state_dim // 2,
                           dtype=torch.complex64, device=device)

    def step(self, state, u_t):
        """state (B, H, N2) complex64; u_t (B, H) -> (y_t, new state)."""
        abar, bbar, c = self.discretize()
        new_state = state * abar + bbar * u_t.float()[..., None]
        y = 2.0 * (new_state * c).sum(dim=-1).real
        return y.to(u_t.dtype) + u_t * self.d, new_state
