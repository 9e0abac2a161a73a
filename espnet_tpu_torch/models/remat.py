"""Per-block activation rematerialisation (the JAX encoders' `remat`,
`nn.remat` of each block, as `torch.utils.checkpoint`).

    out = checkpoint_block(layer, generator, x, pos_emb, bias, pad_mask)

runs `layer(x, pos_emb, bias, pad_mask, generator)` under
`torch.utils.checkpoint` (`use_reentrant=False`): the block's activations
are dropped after the forward and recomputed in the backward pass.

Every dropout seed of the port (the FFN and conv kernels' hash seeds, and
FastDropout's) is drawn from the caller's explicit `torch.Generator`, and
checkpoint's `preserve_rng_state` restores only the global generators. A
recompute that drew from the caller's generator again would draw other
seeds, build other masks in the backward pass than the forward used, and
move the generator twice. So the block runs on a copy of the generator
taken before the call, the recompute on another copy of the same state, and
the caller's generator is then set to where the forward left its copy: a
remat step gives a plain step's gradients and leaves the generator where a
plain step leaves it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint


def checkpoint_block(block, generator: Optional[torch.Generator], *args):
    """`block(*args, generator)`, its activations recomputed in the
    backward pass. Without autograd (inference) the block runs plainly."""
    if not torch.is_grad_enabled():
        return block(*args, generator)
    if generator is None:
        return checkpoint(block, *args, None, use_reentrant=False)
    start = generator.get_state()
    end = []

    def run(*a):
        g = torch.Generator(device=generator.device)
        g.set_state(start)
        out = block(*a, g)
        if not end:  # the forward; the recompute replays the same draws
            end.append(g.get_state())
        return out

    out = checkpoint(run, *args, use_reentrant=False)
    generator.set_state(end[0])
    return out
