"""Speech2Text: batched ASR inference (port of
espnet_tpu/decode/asr_inference.py).

Encodes a padded batch of raw waveforms with the model's `encode`, then runs
the joint CTC/attention batched beam search over all utterances at once and
returns each utterance's n-best token ids and scores, and, given a tokenizer
and a token converter, the best hypothesis's tokens and text. Runs on the
CUDA card unless the caller passes device="cpu"; it never falls back on its
own. Shallow fusion, in JAX's order: a neural LM (`lm_model`, `models/lm.py`)
with `lm_weight` > 0, then an n-gram (`ngram_scorer`, `lm/ngram.py`
`DenseNgramScorer`) with `ngram_weight` > 0, then any `extra_scorers` (the
word LMs of `decode/extlm.py`). Not ported: the JAX `mesh` option.

The model is any one with `encode`, `decoder_init_cache` and
`decoder_score_step` (and `ctc_log_probs` for a CTC weight > 0): the ASR
models, ST (`models/st.py`) and MT (`models/mt.py`), whose input is a padded
batch of source token ids; an integer input array stays integer.

The search needs the model's attention decoder, and its CTC head unless
`ctc_weight` is 0: a CTC-only model (`ctc_weight` 1.0 in training) or a
`ctc_weight` > 0 on an attention-only model raises a ValueError that says
so, where the JAX `Speech2Text` fails with an AttributeError. A CTC-only
model decodes with `decode.ctc_greedy.ctc_greedy_decode` on
`model.ctc_log_probs` of its encoder output.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from espnet_tpu_torch.decode.beam_search import (BeamSearchConfig,
                                                 batched_beam_search)
from espnet_tpu_torch.decode.scorers import (Scorer, combine_scorers,
                                             lm_scorer, ngram_scorer_adapter)
from espnet_tpu_torch.device import resolve_device


@dataclasses.dataclass
class DecodeResult:
    key: str
    token_ids: List[int]
    tokens: List[str]
    text: str
    score: float
    nbest: List[Tuple[List[int], float]]


class Speech2Text:
    """Batched beam-search decoder over an ASR, ST or MT model."""

    def __init__(self, model, device="cuda", beam_size: int = 10,
                 ctc_weight: float = 0.3, penalty: float = 0.0,
                 maxlenratio: float = 0.0, minlenratio: float = 0.0,
                 max_steps: int = 0,
                 extra_scorers: Optional[Sequence[Scorer]] = None,
                 tokenizer=None, converter=None, lm_model=None,
                 lm_weight: float = 0.0, ngram_scorer=None,
                 ngram_weight: float = 0.0):
        """`device`: "cuda" (the default; None means the same) or "cpu";
        `model` is moved there. `tokenizer` and `converter`
        (`data/tokenizer.py`) turn the best token ids into tokens and text.
        `max_steps` > 0 caps the label length on top of the encoder length.
        `extra_scorers`: weighted full scorers added to the search.
        `lm_model`: a neural LM over the same token list (its parameters
        loaded), fused with `lm_weight` when that is > 0; it is moved to
        `device` too. `ngram_scorer`: a `lm.ngram.DenseNgramScorer` over the
        same token list, fused with `ngram_weight` when that is > 0."""
        if getattr(model, "decoder", None) is None:
            raise ValueError(
                "the model has no attention decoder (trained with ctc_weight "
                "1.0): the joint CTC/attention beam search needs one; decode "
                "a CTC-only model with decode.ctc_greedy.ctc_greedy_decode")
        if ctc_weight > 0.0 and getattr(model, "ctc_head", None) is None:
            raise ValueError(
                f"ctc_weight {ctc_weight} needs a CTC head, and the model has "
                "none (trained with ctc_weight 0.0): decode it with "
                "ctc_weight 0")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        cfg = model.config
        self.cfg = BeamSearchConfig(
            beam_size=beam_size, att_weight=1.0 - ctc_weight,
            ctc_weight=ctc_weight, penalty=penalty, maxlenratio=maxlenratio,
            minlenratio=minlenratio, blank_id=getattr(cfg, "blank_id", 0))
        self.max_steps = max_steps
        self.tokenizer = tokenizer
        self.converter = converter
        self.extra_scorers = list(extra_scorers or ())
        self.lm_model = (lm_model.to(self.device).eval()
                         if lm_model is not None else None)
        self.lm_weight = lm_weight
        self.ngram_scorer = ngram_scorer
        self.ngram_weight = ngram_weight
        self.sos = cfg.sos_id
        self.eos = cfg.eos_id
        self.vocab_size = cfg.vocab_size

    @torch.no_grad()
    def decode_batch(self, speech: torch.Tensor, speech_lengths: torch.Tensor):
        """(B, N) waveforms (MT: (B, L) source token ids) on the device ->
        (yseq (B, W, L), ylen (B, W), score (B, W)), the finished pool
        sorted by score."""
        enc, enc_lens = self.model.encode(speech, speech_lengths)
        return self.search_from_memory(enc, enc_lens)

    @torch.no_grad()
    def search_from_memory(self, enc: torch.Tensor, enc_lens: torch.Tensor,
                           ctc_lp: Optional[torch.Tensor] = None):
        """Beam search over encoder memory (B, T, D); `ctc_lp`, the CTC
        log-probs of that memory when the caller has them (the v1 streaming
        recognisers accumulate them chunk by chunk)."""
        model = self.model
        b, w = enc.shape[0], self.cfg.beam_size
        # label budget: the encoder length (maxlenratio 0), capped by
        # max_steps when it is set
        steps = enc.shape[1]
        if self.cfg.maxlenratio > 0:
            steps = max(1, int(math.ceil(self.cfg.maxlenratio * steps)))
        if self.max_steps:
            steps = min(steps, self.max_steps)
        # a decoder with a position table (Whisper's) scores that many steps
        cap = getattr(model, "decoder_max_steps", None)
        if cap is not None:
            steps = min(steps, cap)
        if self.cfg.ctc_weight <= 0:
            ctc_lp = None
        elif ctc_lp is None:
            ctc_lp = model.ctc_log_probs(enc)
        mem = enc.repeat_interleave(w, dim=0)
        mem_lens = enc_lens.repeat_interleave(w, dim=0)
        att_cache = model.decoder_init_cache(b * w, steps + 1, mem, mem_lens)

        def att_score_fn(tokens, pos, cache):
            return model.decoder_score_step(tokens, pos, mem, mem_lens, cache)

        slot = []
        if self.lm_model is not None and self.lm_weight > 0:
            slot.append(lm_scorer(self.lm_model, self.lm_weight))
        if self.ngram_scorer is not None and self.ngram_weight > 0:
            slot.append(ngram_scorer_adapter(self.ngram_scorer,
                                             self.ngram_weight))
        slot.extend(self.extra_scorers)
        lm_score_fn, lm_cache = combine_scorers(slot, b * w, steps + 1,
                                                enc.device)
        # the scorers' weights apply inside the combined fn
        cfg = dataclasses.replace(
            self.cfg, lm_weight=1.0 if lm_score_fn is not None else 0.0)
        return batched_beam_search(
            cfg, self.sos, self.eos, self.vocab_size, enc_lens, att_score_fn,
            att_cache, ctc_log_probs=ctc_lp, lm_score_fn=lm_score_fn,
            lm_cache_init=lm_cache, max_steps=steps)

    def __call__(self, speech, speech_lengths,
                 keys: Optional[Sequence[str]] = None,
                 nbest: int = 1) -> List[DecodeResult]:
        """Decode a padded batch: speech (B, N) float (MT: (B, L) integer
        source token ids), speech_lengths (B,)."""
        speech = np.asarray(speech)
        speech = torch.as_tensor(
            speech.astype(np.int64) if speech.dtype.kind in "iu"
            else speech.astype(np.float32)).to(self.device)
        lengths = torch.as_tensor(np.asarray(speech_lengths, np.int64)).to(
            self.device)
        yseq, ylen, score = (t.cpu().numpy()
                             for t in self.decode_batch(speech, lengths))
        results = []
        for bi in range(yseq.shape[0]):
            hyps = [(yseq[bi, wi, :ylen[bi, wi]].tolist(), float(score[bi, wi]))
                    for wi in range(yseq.shape[1])]
            ids, sc = hyps[0]
            tokens = self.converter.ids2tokens(ids) if self.converter else []
            text = self.tokenizer.tokens2text(tokens) if self.tokenizer else ""
            results.append(DecodeResult(
                key=keys[bi] if keys else str(bi), token_ids=ids,
                tokens=tokens, text=text, score=sc, nbest=hyps[:nbest]))
        return results
