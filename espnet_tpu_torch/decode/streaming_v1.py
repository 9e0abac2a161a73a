"""v1 chunk-streaming recognisers: window and segment (port of
espnet_tpu/decode/streaming_v1.py).

Both feed audio chunks through `ASRModel.encode_chunk` (the frontend and
the unidirectional VGG-LSTM encoder of `encoder_type vgg_lstm`, resuming
from the carried LSTM state) and the CTC head, one call a chunk.
`WindowStreamingASR` (reference `streaming/window.py`) accumulates the
encoder states and CTC posteriors and runs the attention decode offline at
the end; `SegmentStreamingASR` (`streaming/segment.py`) gates on the CTC
argmax: it starts a segment at the first non-blank frame (re-encoding the
onset margin from a zero state), and decodes the segment once
`min_blank_dur` trailing blank frames are seen, carrying an onset-margin
tail over. The endpointing is a host loop over each chunk's argmax, as in
JAX; each segment is decoded by `Speech2Text.search_from_memory`, the
offline search.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from espnet_tpu_torch.decode.asr_inference import Speech2Text


class _ChunkEncoder:
    """The chunked encode shared by both recognisers."""

    def __init__(self, s2t: Speech2Text):
        if s2t.model.config.encoder_type != "vgg_lstm":
            raise ValueError("streaming wrappers need encoder_type=vgg_lstm "
                             "(unidirectional, chunk-carryable)")
        self.s2t = s2t
        self.model = s2t.model
        self.device = s2t.device
        self.carry = self.model.encoder_carry(1, self.device)

    @torch.no_grad()
    def encode_chunk(self, samples: np.ndarray):
        """samples (N,) -> (enc (t, D), CTC log-probs (t, V)) as numpy,
        advancing the carried LSTM state."""
        speech = torch.as_tensor(np.asarray(samples, np.float32),
                                 device=self.device)[None]
        lengths = torch.tensor([samples.shape[0]], device=self.device)
        enc, elens, self.carry = self.model.encode_chunk(speech, lengths,
                                                         self.carry)
        lp = self.model.ctc_log_probs(enc)
        t = int(elens[0])
        return enc[0, :t].float().cpu().numpy(), lp[0, :t].cpu().numpy()

    def reset_carry(self):
        self.carry = [tuple(torch.zeros_like(x) for x in c)
                      for c in self.carry]

    @torch.no_grad()
    def decode_memory(self, enc: np.ndarray, ctc_lp: np.ndarray):
        """Beam-search one stretch of encoder memory and its CTC
        log-probs: [(ids, score), ...] n-best."""
        mem = torch.from_numpy(enc).to(self.device)[None]
        lens = torch.tensor([enc.shape[0]], device=self.device)
        yseq, ylen, score = (x.cpu().numpy() for x in
                             self.s2t.search_from_memory(
                                 mem.to(self.model.config.dtype), lens,
                                 torch.from_numpy(ctc_lp).to(
                                     self.device)[None]))
        return [(yseq[0, wi, :ylen[0, wi]].tolist(), float(score[0, wi]))
                for wi in range(yseq.shape[1])]

    def ids_to_text(self, ids: List[int]) -> str:
        s2t = self.s2t
        tokens = s2t.converter.ids2tokens(ids) if s2t.converter else []
        return s2t.tokenizer.tokens2text(tokens) if s2t.tokenizer else ""


class WindowStreamingASR:
    """Half-streaming: the encoder and CTC online per window, the attention
    decode offline over everything accepted."""

    def __init__(self, s2t: Speech2Text):
        if s2t.cfg.ctc_weight <= 0.0:
            raise ValueError("WindowStreamingASR works only with joint "
                             "CTC/attention")
        self._enc = _ChunkEncoder(s2t)
        self._encoder_states: List[np.ndarray] = []
        self._ctc_posteriors: List[np.ndarray] = []

    def accept_input(self, samples: np.ndarray) -> None:
        """Call once per incoming audio window."""
        enc, lp = self._enc.encode_chunk(samples)
        self._encoder_states.append(enc)
        self._ctc_posteriors.append(lp)

    def decode_with_attention_offline(self):
        """[(ids, score), ...] n-best over all accepted audio."""
        return self._enc.decode_memory(
            np.concatenate(self._encoder_states, axis=0),
            np.concatenate(self._ctc_posteriors, axis=0))

    def hypothesis_text(self) -> str:
        return self._enc.ids_to_text(self.decode_with_attention_offline()[0][0])


class SegmentStreamingASR:
    """Fully online: CTC-argmax endpointing emits the n-best of each
    detected speech segment."""

    def __init__(self, s2t: Speech2Text, min_blank_dur: int = 4,
                 onset_margin: int = 8, offset_margin: int = 2,
                 blank_id: int = 0):
        self._enc = _ChunkEncoder(s2t)
        self.min_blank_dur = min_blank_dur
        self.onset_margin = onset_margin
        self.offset_margin = offset_margin
        self.blank_id = blank_id
        self._activated = False
        self._blank_dur = 0
        self._encoder_states: List[np.ndarray] = []
        self._ctc_posteriors: List[np.ndarray] = []
        self._prev_samples = np.zeros((0,), np.float32)
        # samples per encoder frame: hop x VGG2L's subsampling (4)
        self._samples_per_frame = s2t.model.config.hop_length * 4

    def accept_input(self, samples: np.ndarray) -> Optional[list]:
        """Feed a chunk; the n-best [(ids, score), ...] when a segment's
        endpoint fires, else None."""
        samples = np.asarray(samples, np.float32)
        self._prev_samples = np.concatenate([self._prev_samples, samples])
        enc, lp = self._enc.encode_chunk(samples)
        z = lp.argmax(axis=-1)
        if not self._activated and (z != self.blank_id).any():
            # onset: re-encode the tail from a zero state
            self._activated = True
            tail = self._samples_per_frame * (self.onset_margin + 1)
            self._enc.reset_carry()
            enc, lp = self._enc.encode_chunk(self._prev_samples[-tail:])
        hyp = None
        if self._activated:
            self._encoder_states.append(enc)
            self._ctc_posteriors.append(lp)
            zcat = np.concatenate([p.argmax(-1)
                                   for p in self._ctc_posteriors])
            run = 0
            for v in zcat[::-1]:
                if v != self.blank_id:
                    break
                run += 1
            self._blank_dur = run
            if self._blank_dur >= self.min_blank_dur:
                enc_all = np.concatenate(self._encoder_states, axis=0)
                lp_all = np.concatenate(self._ctc_posteriors, axis=0)
                seg_len = enc_all.shape[0] - self._blank_dur \
                    + self.offset_margin
                if seg_len > 0:
                    hyp = self._enc.decode_memory(enc_all[:seg_len],
                                                  lp_all[:seg_len])
                self._activated = False
                self._blank_dur = 0
                self._encoder_states = []
                self._ctc_posteriors = []
                tail = self._samples_per_frame * self.onset_margin
                self._prev_samples = (self._prev_samples[-tail:] if tail
                                      else np.zeros((0,), np.float32))
        return hyp

    def ids_to_text(self, ids: List[int]) -> str:
        return self._enc.ids_to_text(ids)
