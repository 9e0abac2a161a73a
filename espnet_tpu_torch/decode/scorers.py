"""Weighted full scorers for the batched beam search (port of the parts of
espnet_tpu/decode/scorers.py that `Speech2Text` uses without an LM).

A scorer is a pair of functions over fixed-shape caches:

  ``init_cache(n, steps, device) -> cache``  (every tensor leading dim n)
  ``score_step(tokens (N,), pos, cache) -> (logp (N, V), cache)``

`combine_scorers` folds weighted scorers into the search's single extra
slot: their weighted sum, with a tuple of their caches as its cache.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass
class Scorer:
    """One weighted full scorer."""

    weight: float
    init_cache: Callable[[int, int, torch.device], Any]
    score_step: Callable[[torch.Tensor, int, Any], Tuple[torch.Tensor, Any]]
    name: str = "scorer"


def combine_scorers(scorers: Sequence[Scorer], n: int, steps: int,
                    device=None) -> Tuple[Optional[Callable], Any]:
    """(score_fn, cache) computing sum_i w_i * logp_i, or (None, None) when
    no scorer has a non-zero weight."""
    live = [s for s in scorers if s.weight != 0.0]
    if not live:
        return None, None
    caches = tuple(s.init_cache(n, steps, device) for s in live)

    def score_fn(tokens, pos, cache):
        total = 0.0
        new = []
        for s, c in zip(live, cache):
            lp, nc = s.score_step(tokens, pos, c)
            total = total + s.weight * lp
            new.append(nc)
        return total, tuple(new)

    return score_fn, caches


def length_bonus_scorer(vocab_size: int, weight: float) -> Scorer:
    """A constant bonus per emitted token (reference
    `espnet/nets/scorers/length_bonus.py`)."""

    def init_cache(n, steps, device):
        return torch.zeros(n, 1, device=device)

    def score_step(tokens, pos, cache):
        return torch.ones(tokens.shape[0], vocab_size,
                          device=tokens.device), cache

    return Scorer(weight, init_cache, score_step, name="length_bonus")
