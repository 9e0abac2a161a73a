"""Float32 parameters, computation in the model's dtype.

The JAX package keeps parameters in float32 and casts them to the compute
dtype (bfloat16 for the bench model) inside each flax layer; these two
layers do the same. LayerNorm normalises in float32 with eps 1e-6 (flax's
default, not torch's 1e-5) and returns the compute dtype.
"""

from __future__ import annotations

import torch
from torch import nn

LN_EPS = 1e-6


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


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm with eps 1e-6, computed in float32, returned in `dtype`."""

    def __init__(self, d: int, dtype=torch.float32):
        super().__init__(d, eps=LN_EPS)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = nn.functional.layer_norm(x.float(), self.normalized_shape,
                                     self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)
