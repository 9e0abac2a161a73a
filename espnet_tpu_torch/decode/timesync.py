"""Time-synchronous (frame-synchronous) CTC prefix beam search (port of
espnet_tpu/decode/timesync.py).

Behavioral spec: reference `espnet/nets/beam_search_timesync.py:1`
(BeamSearchTimeSync). As in JAX, the encoder and the CTC log-posteriors
come off the device in one call (`Speech2TextTimeSync.posteriors`, on the
CUDA card unless the caller asks for the CPU) and the prefix search
(`ctc_prefix_beam_search`, copied from the JAX package) is a host loop over
dicts, whose tie order is numpy's and Python's.

An n-gram (`lm/ngram.py` `DenseNgramScorer`) joins the search with
`ngram_weight` > 0 through its `prefix_scorer` (one an utterance): token c
after a prefix is scored from the dense tables, walking `next_ctx` from `start_ctx` over the
prefix and reading `scores[ctx, c]`, the step that the label-synchronous
search takes token by token. The JAX `Speech2TextTimeSync` calls a
`score_step` that `DenseNgramScorer` does not have and raises
AttributeError there (ROADMAP.md queue 3). The text of a hypothesis is
the tokenizer's, where JAX joins the tokens (queue 3 too).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch

NEG_INF = -float("inf")


def _logsumexp(*xs: float) -> float:
    m = max(xs)
    if m == NEG_INF:
        return NEG_INF
    return m + math.log(sum(math.exp(x - m) for x in xs))


def ctc_prefix_beam_search(
    log_probs: np.ndarray,       # (T, V) CTC log-posteriors, one utterance
    beam_size: int = 10,
    blank_id: int = 0,
    pruning_width: int = 30,
    lm_score=None,               # callable(prefix tuple, next token) -> float
    lm_weight: float = 0.0,
) -> List[Tuple[Tuple[int, ...], float]]:
    """Classic CTC prefix beam search (Hannun et al.; the DP of
    `beam_search_timesync.py`). Returns the n-best [(prefix, log score)].
    """
    t_max, v = log_probs.shape
    # beam: prefix -> (p_blank, p_nonblank)
    beam: Dict[Tuple[int, ...], Tuple[float, float]] = {
        (): (0.0, NEG_INF)
    }
    for t in range(t_max):
        frame = log_probs[t]
        # prune candidate tokens per frame (pre-beam of the reference)
        cand = np.argsort(frame)[::-1][:pruning_width]
        new: Dict[Tuple[int, ...], List[float]] = defaultdict(
            lambda: [NEG_INF, NEG_INF]
        )
        for prefix, (p_b, p_nb) in beam.items():
            p_tot = _logsumexp(p_b, p_nb)
            last = prefix[-1] if prefix else None
            for c in cand:
                p_c = float(frame[c])
                if c == blank_id:
                    e = new[prefix]
                    e[0] = _logsumexp(e[0], p_c + p_tot)
                elif c == last:
                    # repeat without blank extends p_nb of the SAME prefix
                    e = new[prefix]
                    e[1] = _logsumexp(e[1], p_c + p_nb)
                    # with an intervening blank it starts a new symbol
                    np_prefix = prefix + (int(c),)
                    e2 = new[np_prefix]
                    add = p_c + p_b
                    if lm_score is not None and lm_weight > 0:
                        add += lm_weight * lm_score(prefix, int(c))
                    e2[1] = _logsumexp(e2[1], add)
                else:
                    np_prefix = prefix + (int(c),)
                    e2 = new[np_prefix]
                    add = p_c + p_tot
                    if lm_score is not None and lm_weight > 0:
                        add += lm_weight * lm_score(prefix, int(c))
                    e2[1] = _logsumexp(e2[1], add)
        # keep the best beam_size prefixes by total probability
        scored = sorted(
            new.items(), key=lambda kv: -_logsumexp(kv[1][0], kv[1][1])
        )[:beam_size]
        beam = {k: (v[0], v[1]) for k, v in scored}
    out = [
        (prefix, _logsumexp(p_b, p_nb))
        for prefix, (p_b, p_nb) in beam.items()
    ]
    out.sort(key=lambda kv: -kv[1])
    return out


class _Result:
    __slots__ = ("key", "text", "score", "nbest")

    def __init__(self, key, text, score, nbest):
        self.key, self.text, self.score, self.nbest = key, text, score, nbest


class Speech2TextTimeSync:
    """Frame-synchronous CTC decoding front-end, drop-in for the decode
    loop of `bin/asr_inference.py` (`--search timesync`). The text is the
    tokenizer's rendering of the best tokens, as in the label-synchronous
    search; without a tokenizer the tokens are joined and "▁" turned into
    spaces, as JAX's are (which leaves a character model's "<space>"
    tokens in its text: ROADMAP.md queue 3)."""

    def __init__(self, model, tokenizer=None, converter=None,
                 beam_size: int = 10, ngram_scorer=None,
                 ngram_weight: float = 0.0, device="cuda"):
        from espnet_tpu_torch.device import resolve_device

        if getattr(model, "ctc_head", None) is None:
            raise ValueError("the time-synchronous search needs a CTC head, "
                             "and the model has none (trained with "
                             "ctc_weight 0.0)")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.converter = converter
        self.beam_size = beam_size
        self.ngram_scorer = ngram_scorer
        self.ngram_weight = ngram_weight

    @torch.no_grad()
    def posteriors(self, speech, speech_lengths):
        """(CTC log-posteriors (B, T', V), encoder lengths (B,)) as numpy:
        the encode and the CTC head on the device, one copy to the host."""
        speech = torch.as_tensor(np.asarray(speech, np.float32)).to(
            self.device)
        lengths = torch.as_tensor(np.asarray(speech_lengths, np.int64)).to(
            self.device)
        enc, elens = self.model.encode(speech, lengths)
        lp = self.model.ctc_log_probs(enc)
        return lp.cpu().numpy(), elens.cpu().numpy()

    def __call__(self, speech, speech_lengths, keys, nbest: int = 1):
        lp, elens = self.posteriors(speech, speech_lengths)
        fuse = self.ngram_scorer is not None and self.ngram_weight > 0
        out = []
        for i, key in enumerate(keys):
            lm_fn = self.ngram_scorer.prefix_scorer() if fuse else None
            hyps = ctc_prefix_beam_search(
                lp[i, : int(elens[i])], self.beam_size,
                lm_score=lm_fn, lm_weight=self.ngram_weight,
            )[:nbest]
            ids = list(hyps[0][0])
            toks = self.converter.ids2tokens(ids) if self.converter else ids
            if self.converter and self.tokenizer:
                text = self.tokenizer.tokens2text(toks)
            elif self.converter:
                text = "".join(toks).replace("▁", " ").strip()
            else:
                text = " ".join(map(str, ids))
            out.append(_Result(
                key, text, float(hyps[0][1]),
                [(list(h[0]), float(h[1])) for h in hyps],
            ))
        return out
