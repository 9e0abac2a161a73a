"""Weighted full scorers for the batched beam search (port of
espnet_tpu/decode/scorers.py).

A scorer is a pair of functions over fixed-shape caches:

  ``init_cache(n, steps, device) -> cache``  (every tensor leading dim n)
  ``score_step(tokens (N,), pos, cache) -> (logp (N, V), cache)``

`combine_scorers` folds weighted scorers into the search's single extra
slot: their weighted sum, with a tuple of their caches as its cache.
`lm_scorer` makes a neural LM (`models/lm.py`) one of them,
`ngram_scorer_adapter` an n-gram's dense tables (`lm/ngram.py`).
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


def lm_scorer(lm_model, weight: float) -> Scorer:
    """A neural LM (`models/lm.py` `TransformerLM` or `RNNLM`: its
    `init_cache` and `score_step`) as a weighted scorer."""

    def init_cache(n, steps, device):
        return lm_model.init_cache(n, steps, device=device)

    def score_step(tokens, pos, cache):
        return lm_model.score_step(tokens, pos, cache)

    return Scorer(weight, init_cache, score_step, name="lm")


def ngram_scorer_adapter(ngram, weight: float) -> Scorer:
    """A `lm.ngram.DenseNgramScorer` as a weighted scorer: its cache is a
    context id a hypothesis, its tables on the cache's device."""

    def init_cache(n, steps, device):
        return ngram.init_cache(n, device)

    def score_step(tokens, pos, cache):
        return ngram.make_score_fn(cache.device)(tokens, pos, cache)

    return Scorer(weight, init_cache, score_step, name="ngram")


def length_bonus_scorer(vocab_size: int, weight: float) -> Scorer:
    """A constant bonus per emitted token (reference
    `espnet/nets/scorers/length_bonus.py`)."""

    def init_cache(n, steps, device):
        return torch.zeros(n, 1, device=device)

    def score_step(tokens, pos, cache):
        return torch.ones(tokens.shape[0], vocab_size,
                          device=tokens.device), cache

    return Scorer(weight, init_cache, score_step, name="length_bonus")
