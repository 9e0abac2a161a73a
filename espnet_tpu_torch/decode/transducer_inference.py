"""Speech2TextTransducer: batched transducer inference (port of
espnet_tpu/decode/transducer_inference.py).

Encodes a padded batch once, then runs one of the searches over all its
utterances: `search` "maes" (`TransducerASRModel.beam_search`), "nsc",
"tsd", "alsd" (u_max 50) or "greedy" (3 labels a frame at most, scores 0);
a `beam_size` <= 1 means greedy. Returns one `DecodeResult` an utterance
with the best hypothesis as its only n-best entry. Runs eagerly on the CUDA
card unless the caller passes device="cpu" (the JAX class jits the whole
batch decode).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from espnet_tpu_torch.decode.asr_inference import DecodeResult
from espnet_tpu_torch.device import resolve_device
from espnet_tpu_torch.models.transducer import TransducerASRModel

SEARCHES = ("maes", "nsc", "tsd", "alsd", "greedy")
ALSD_U_MAX = 50


class Speech2TextTransducer:
    def __init__(self, model: TransducerASRModel, device="cuda",
                 tokenizer=None, converter=None, beam_size: int = 5,
                 max_expansions: int = 3, max_tokens: int = 256,
                 score_norm: bool = True, search: str = "maes"):
        """`device`: "cuda" (the default) or "cpu"; `model` is moved there
        and set to eval mode. `max_expansions` is mAES's and TSD's labels a
        frame and NSC's steps."""
        if search not in SEARCHES:
            raise ValueError(f"search {search!r} not in {SEARCHES}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.converter = converter
        self.beam_size = beam_size
        self.max_expansions = max_expansions
        self.max_tokens = max_tokens
        self.score_norm = score_norm
        self.search = "greedy" if beam_size <= 1 else search

    @torch.no_grad()
    def decode_batch(self, speech, speech_lengths):
        """(tokens (B, max_tokens), lengths (B,), scores (B,)) tensors."""
        m = self.model
        enc, elen = m.encode(speech, speech_lengths)
        if self.search == "greedy":
            toks, lens = m.greedy_search(enc, elen, self.max_tokens)
            return toks, lens, torch.zeros(enc.shape[0], device=enc.device)
        if self.search == "alsd":
            return m.alsd_search(enc, elen, self.beam_size, self.max_tokens,
                                 ALSD_U_MAX, self.score_norm)
        if self.search == "tsd":
            return m.tsd_search(enc, elen, self.beam_size,
                                self.max_expansions, self.max_tokens,
                                self.score_norm)
        if self.search == "nsc":
            return m.nsc_search(enc, elen, self.beam_size,
                                self.max_expansions, self.max_tokens,
                                self.score_norm)
        return m.beam_search(enc, elen, self.beam_size, self.max_expansions,
                             self.max_tokens, self.score_norm)

    def __call__(self, speech, speech_lengths,
                 keys: Optional[Sequence[str]] = None) -> List[DecodeResult]:
        sp = torch.as_tensor(np.asarray(speech)).to(self.device)
        ln = torch.as_tensor(np.asarray(speech_lengths)).to(self.device)
        toks, lens, scores = (x.cpu().numpy() for x in
                              self.decode_batch(sp, ln))
        results = []
        for bi in range(toks.shape[0]):
            ids = toks[bi, : int(lens[bi])].tolist()
            tokens = self.converter.ids2tokens(ids) if self.converter else []
            text = self.tokenizer.tokens2text(tokens) if self.tokenizer else ""
            results.append(DecodeResult(
                key=keys[bi] if keys else str(bi), token_ids=ids,
                tokens=tokens, text=text, score=float(scores[bi]),
                nbest=[(ids, float(scores[bi]))]))
        return results
