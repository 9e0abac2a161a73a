"""FastDropout (port of espnet_tpu/ops/dropout.py) and flax's standard
dropout rule.

The drop rate is quantised to 1/256 steps, q = clamp(round(rate * 256), 1,
255) (0.1 -> 26/256); an element is kept when a random byte is >= q and kept
values are scaled by 256 / (256 - q). The bytes come from a device
`torch.Generator` seeded from the caller's generator; the backward draws the
same bytes again from that seed instead of storing the mask, as the JAX
package regenerates its mask from the key.

`Dropout` is flax `nn.Dropout`'s rule, which the branchformer layers use:
keep with probability 1 - rate, scale kept values by 1 / (1 - rate); its
uniform draws come from a device generator seeded the same way.

Every random draw of the port goes through `draw_seeds` from an explicit
`torch.Generator` (a CPU generator keeps the draw off the card's stream).
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from espnet_tpu_torch.ops.prenorm_ffn import quantize_rate


def draw_seeds(generator: torch.Generator, n: int) -> List[int]:
    """n int32 seeds (as Python ints) from `generator`."""
    return torch.randint(-2 ** 31, 2 ** 31, (n,), generator=generator,
                         device=generator.device).tolist()


def bernoulli(shape, p: float, generator: torch.Generator,
              device) -> torch.Tensor:
    """Bool (shape) on `device`, True with probability p, drawn from a
    device generator seeded from `generator`."""
    g = torch.Generator(device=device)
    g.manual_seed(draw_seeds(generator, 1)[0] & 0x7FFFFFFFFFFFFFFF)
    return torch.rand(shape, generator=g, device=device) < p


def _keep_bytes(shape, device, seed: int) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(seed & 0x7FFFFFFFFFFFFFFF)
    return torch.randint(0, 256, shape, generator=g, device=device,
                         dtype=torch.uint8)


class _MaskedScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed: int, q: int):
        ctx.seed, ctx.q = seed, q
        keep = _keep_bytes(x.shape, x.device, seed) >= q
        return torch.where(keep, x * (256.0 / (256 - q)), torch.zeros_like(x))

    @staticmethod
    def backward(ctx, g):
        keep = _keep_bytes(g.shape, g.device, ctx.seed) >= ctx.q
        scale = 256.0 / (256 - ctx.q)
        return torch.where(keep, g * scale, torch.zeros_like(g)), None, None


def fast_dropout(x: torch.Tensor, rate: float,
                 generator: torch.Generator) -> torch.Tensor:
    """Dropout with the 1/256-quantised keep rule; rate 0 is the identity."""
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    return _MaskedScale.apply(x, draw_seeds(generator, 1)[0],
                              quantize_rate(rate))


class FastDropout(nn.Module):
    """`fast_dropout` while the module is training and given a generator,
    else the identity (the randomness of every module of the port comes from
    the caller's generator; without one a module is deterministic)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator=None):
        if not self.training or self.rate == 0.0 or generator is None:
            return x
        return fast_dropout(x, self.rate, generator)


class Dropout(nn.Module):
    """flax `nn.Dropout`'s rule while the module is training and given a
    generator, else the identity."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator=None):
        if not self.training or self.rate == 0.0 or generator is None:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        g = torch.Generator(device=x.device)
        g.manual_seed(draw_seeds(generator, 1)[0] & 0x7FFFFFFFFFFFFFFF)
        keep = torch.rand(x.shape, generator=g, device=x.device) >= self.rate
        return torch.where(keep, x * (1.0 / (1.0 - self.rate)),
                           torch.zeros_like(x))
