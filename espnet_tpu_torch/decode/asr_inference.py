"""Speech2Text: batched ASR inference (port of
espnet_tpu/decode/asr_inference.py).

Encodes a padded batch of raw waveforms with `ASRModel.encode`, then runs the
joint CTC/attention batched beam search over all utterances at once and
returns each utterance's n-best token ids and scores. Runs on the CUDA card
unless the caller passes device="cpu"; it never falls back on its own. Not in
this slice: language models, n-gram scorers, tokenizers and meshes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from espnet_tpu_torch.decode.beam_search import (BeamSearchConfig,
                                                 batched_beam_search)
from espnet_tpu_torch.decode.scorers import Scorer, combine_scorers
from espnet_tpu_torch.device import resolve_device
from espnet_tpu_torch.models.asr import ASRModel


@dataclasses.dataclass
class DecodeResult:
    key: str
    token_ids: List[int]
    score: float
    nbest: List[Tuple[List[int], float]]


class Speech2Text:
    """Batched beam-search decoder over an `ASRModel`."""

    def __init__(self, model: ASRModel, device="cuda", beam_size: int = 10,
                 ctc_weight: float = 0.3, penalty: float = 0.0,
                 maxlenratio: float = 0.0, minlenratio: float = 0.0,
                 max_steps: int = 0,
                 extra_scorers: Optional[Sequence[Scorer]] = None):
        """`device`: "cuda" (the default; None means the same) or "cpu";
        `model` is moved there.
        `max_steps` > 0 caps the label length on top of the encoder length.
        `extra_scorers`: weighted full scorers added to the search."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        cfg = model.config
        self.cfg = BeamSearchConfig(
            beam_size=beam_size, att_weight=1.0 - ctc_weight,
            ctc_weight=ctc_weight, penalty=penalty, maxlenratio=maxlenratio,
            minlenratio=minlenratio, blank_id=cfg.blank_id)
        self.max_steps = max_steps
        self.extra_scorers = list(extra_scorers or ())
        self.sos = cfg.sos_id
        self.eos = cfg.eos_id
        self.vocab_size = cfg.vocab_size

    @torch.no_grad()
    def decode_batch(self, speech: torch.Tensor, speech_lengths: torch.Tensor):
        """(B, N) waveforms on the device -> (yseq (B, W, L), ylen (B, W),
        score (B, W)), the finished pool sorted by score."""
        enc, enc_lens = self.model.encode(speech, speech_lengths)
        return self.search_from_memory(enc, enc_lens)

    @torch.no_grad()
    def search_from_memory(self, enc: torch.Tensor, enc_lens: torch.Tensor):
        """Beam search over encoder memory (B, T, D)."""
        model = self.model
        b, w = enc.shape[0], self.cfg.beam_size
        # label budget: the encoder length (maxlenratio 0), capped by
        # max_steps when it is set
        steps = enc.shape[1]
        if self.cfg.maxlenratio > 0:
            steps = max(1, int(math.ceil(self.cfg.maxlenratio * steps)))
        if self.max_steps:
            steps = min(steps, self.max_steps)
        ctc_lp = model.ctc_log_probs(enc) if self.cfg.ctc_weight > 0 else None
        mem = enc.repeat_interleave(w, dim=0)
        mem_lens = enc_lens.repeat_interleave(w, dim=0)
        att_cache = model.decoder_init_cache(b * w, steps + 1, enc.device)

        def att_score_fn(tokens, pos, cache):
            return model.decoder_score_step(tokens, pos, mem, mem_lens, cache)

        lm_score_fn, lm_cache = combine_scorers(self.extra_scorers, b * w,
                                                steps + 1, enc.device)
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
        """Decode a padded batch: speech (B, N) float, speech_lengths (B,)."""
        speech = torch.as_tensor(np.asarray(speech, np.float32)).to(self.device)
        lengths = torch.as_tensor(np.asarray(speech_lengths, np.int64)).to(
            self.device)
        yseq, ylen, score = (t.cpu().numpy()
                             for t in self.decode_batch(speech, lengths))
        results = []
        for bi in range(yseq.shape[0]):
            hyps = [(yseq[bi, wi, :ylen[bi, wi]].tolist(), float(score[bi, wi]))
                    for wi in range(yseq.shape[1])]
            ids, sc = hyps[0]
            results.append(DecodeResult(
                key=keys[bi] if keys else str(bi), token_ids=ids, score=sc,
                nbest=hyps[:nbest]))
        return results
