"""Speech2TextStreaming: incremental ASR over audio chunks, the `host`
engine (port of espnet_tpu/decode/streaming_inference.py).

Each call appends the chunk to the samples seen so far, recomputes the
frontend over them and keeps only the *stable* STFT frames (those whose
window no future sample can change) until `is_final`; the contextual-block
encoder then runs every block that has become complete
(`ContextualBlockConformerEncoder.one_block`, the computation of the
training program), and the block's finished output frames feed either

* `search="greedy"`: incremental CTC greedy decoding, whose final
  hypothesis is the offline CTC greedy one; or
* `search="beam"`: the block-synchronous beam search of
  `decode/online_beam_search.py` over a `t_max`-frame encoder and CTC
  buffer; the final block runs the offline search from the committed state.

An utterance of at most one block takes the offline short path (one
`ASRModel.encode` of the whole signal), as the encoder's own short branch
does. Runs on the card unless `device="cpu"` is given. `decode/
streaming_device.py` is the engine that keeps its rolling state on the
device and advances one fixed audio quantum a call.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from espnet_tpu_torch.decode.beam_search import BeamSearchConfig
from espnet_tpu_torch.decode.online_beam_search import (init_online_state,
                                                        process_block)
from espnet_tpu_torch.device import resolve_device
from espnet_tpu_torch.models.asr import ASRModel
from espnet_tpu_torch.models.streaming import chunk_bias
from espnet_tpu_torch.models.subsampling import min_input_frames

SEARCHES = ("greedy", "beam")


def check_streaming_model(model: ASRModel, search: str) -> None:
    """Raise for a model or search the streaming engines cannot serve."""
    cfg = model.config
    if cfg.encoder_type != "contextual_block_conformer":
        raise ValueError("streaming inference needs encoder_type="
                         "contextual_block_conformer")
    if cfg.normalize == "utterance_mvn":
        raise ValueError("utterance_mvn is non-causal; use global_mvn or "
                         "none for streaming")
    if search not in SEARCHES:
        raise ValueError(f"search {search!r} not in {SEARCHES}")


def beam_config(beam_size: int, ctc_weight: float, penalty: float,
                blank_id: int) -> BeamSearchConfig:
    """The streaming searches' configuration: maxlen = the frames so far."""
    return BeamSearchConfig(beam_size=beam_size, att_weight=1.0 - ctc_weight,
                            ctc_weight=ctc_weight, penalty=penalty,
                            maxlenratio=0.0, blank_id=blank_id)


def last_block_pad(frames_pe, count: int):
    """Zero the slots past the utterance's end in a block's frames after
    their positions were added, as the encoder's parallel path pads its
    windows (the JAX engines leave positions there, which the chunk
    attention then reads: their output departs from the offline encoder's
    in the last block of an utterance that ends inside it)."""
    if count >= frames_pe.shape[1]:
        return frames_pe
    keep = torch.arange(frames_pe.shape[1], device=frames_pe.device) < count
    return frames_pe * keep[None, :, None].to(frames_pe.dtype)


def block_is_safe(bi: int, hop: int, bs: int, s_avail: int) -> bool:
    """Whether block bi may run before the utterance's end is known: its
    frames are all there and one more, so it is not the last block (the
    last block emits every frame to the end, which is known only then; the
    JAX engines run it as soon as its frames are there, and lose the frames
    after its hop where the utterance ends exactly with it)."""
    return bi * hop + bs < s_avail


def greedy_collapse(toks, ids: List[int], prev: int, blank: int) -> int:
    """Append the CTC greedy tokens of `toks` to `ids` (blanks and repeats
    of `prev` dropped); returns the last token."""
    for t in toks:
        t = int(t)
        if t != blank and t != prev:
            ids.append(t)
        prev = t
    return prev


class Speech2TextStreaming:
    """Chunked streaming recognizer; `__call__(chunk, is_final)` returns
    {"token_ids", "tokens", "text", "is_final"} of the current hypothesis.
    `model` is moved to `device` ("cuda" unless "cpu" is asked for)."""

    def __init__(self, model: ASRModel, tokenizer=None, converter=None,
                 search: str = "greedy", beam_size: int = 10,
                 ctc_weight: float = 0.3, penalty: float = 0.0,
                 max_steps: int = 64, t_max: int = 512, device="cuda"):
        check_streaming_model(model, search)
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.converter = converter
        self.search = search
        self.max_steps = max_steps
        self.t_max = t_max
        if search == "beam":
            self.bs_cfg = beam_config(beam_size, ctc_weight, penalty,
                                      model.config.blank_id)
        self.reset()

    def reset(self):
        self._samples = np.zeros((0,), np.float32)
        self._ctx: Optional[List[torch.Tensor]] = None
        self._prev_addin = None
        self._next_block = 0
        self._prev_tok = self.model.config.blank_id
        self._ids: List[int] = []
        self._beam_state = None
        self._enc_buf = None
        self._lp_buf = None
        self._enc_len = 0
        self._beam_finalized = False

    def _tensor(self, a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a)).to(self.device, dtype)

    # --- model subroutines ------------------------------------------------
    def _features(self, samples: np.ndarray, stable_only: bool):
        """Raw samples -> subsampled encoder-input frames (1, S, D), or
        None before the first frame."""
        c = self.model.config
        n = len(samples)
        if stable_only:
            # frame i spans samples [i*hop - n_fft/2, i*hop + n_fft/2)
            n_frames = max(0, (n - c.n_fft // 2) // c.hop_length + 1)
        else:
            n_frames = n // c.hop_length + 1
        if n_frames <= 0:
            return None
        enc = self.model.encoder
        if n_frames < min_input_frames(c.subsampling_factor):
            return torch.zeros(1, 0, c.d_model, device=self.device,
                               dtype=enc.dtype)
        feats, _ = self.model.frontend(
            self._tensor(samples[None]),
            self._tensor([n], torch.long))
        x, _ = enc.embed(feats[:, :n_frames],
                         self._tensor([n_frames], torch.long))
        return x

    def _run_block(self, x, bi: int, t_total: int):
        """Encoder block bi over the subsampled frames x (1, S, D)."""
        e = self.model.encoder
        bs, hop = e.block_size, e.hop_size
        start = bi * hop
        count = min(t_total - start, bs) if t_total else bs
        frames = x[:, start:start + bs]
        if frames.shape[1] < bs:
            frames = torch.nn.functional.pad(
                frames, (0, 0, 0, bs - frames.shape[1]))
        if e.init_average:
            addin = frames[:, :count].sum(dim=1) / max(count, 1)
        else:
            addin = frames[:, :count].max(dim=1).values
        if e.ctx_pos_enc:
            addin = e.pos_enc(addin[:, None], start=bi)[:, 0]
        chunk, new_ctx = e.one_block(
            last_block_pad(e.pos_enc(frames, start=start), count), addin,
            self._prev_addin, self._ctx, chunk_bias(bs, x.device))
        return chunk, new_ctx, addin

    def _emit(self, chunk, bi: int, nblk: Optional[int], t_total: int):
        """The slots of block bi that become final output frames."""
        e = self.model.encoder
        bs, hop, la = e.block_size, e.hop_size, e.look_ahead
        if bi == 0:
            lo, hi = 1, bs - la + 1
        else:
            lo = bs - la - hop + 1
            hi = lo + hop
        if nblk is not None and bi == nblk - 1:
            hi = t_total - bi * hop + 1  # the last block: to the end
        return e.after_norm(chunk[:, lo:hi])

    def _greedy_update(self, enc_frames):
        c = self.model.config
        toks = self.model.ctc_log_probs(enc_frames).argmax(dim=-1)[0]
        self._prev_tok = greedy_collapse(toks.tolist(), self._ids,
                                         self._prev_tok, c.blank_id)

    def _beam_update(self, enc_frames, is_final: bool):
        """Feed newly finished encoder frames to the online search."""
        c = self.model.config
        w = self.bs_cfg.beam_size
        if self._enc_buf is None:
            d = enc_frames.shape[-1]
            self._enc_buf = torch.zeros(1, self.t_max, d, device=self.device)
            self._lp_buf = torch.zeros(1, self.t_max, c.vocab_size,
                                       device=self.device)
        old = self._enc_len
        new = min(old + enc_frames.shape[1], self.t_max)
        self._enc_buf[:, old:new] = enc_frames[:, :new - old].float()
        if self.bs_cfg.ctc_weight > 0 and new > old:
            self._lp_buf[:, old:new] = self.model.ctc_log_probs(
                enc_frames[:, :new - old])
        self._enc_len = new
        if self._beam_state is None:
            self._beam_state = init_online_state(
                self.bs_cfg, c.sos_id, c.eos_id, 1, self.t_max,
                self.max_steps, self.model.decoder_init_cache(
                    w, self.max_steps + 1,
                    self._enc_buf.repeat_interleave(w, dim=0),
                    torch.zeros(w, dtype=torch.long, device=self.device)),
                vocab_size=c.vocab_size, device=self.device)
        mem = self._enc_buf.repeat_interleave(w, dim=0)
        mem_lens = torch.full((w,), new, dtype=torch.long, device=self.device)

        def att_score_fn(tokens, pos, cache):
            return self.model.decoder_score_step(tokens, pos, mem, mem_lens,
                                                 cache)

        self._beam_state, yseq, ylen, _ = process_block(
            self.bs_cfg, c.sos_id, c.eos_id, c.vocab_size, self._beam_state,
            self._lp_buf, self._tensor([old], torch.long),
            self._tensor([new], torch.long), att_score_fn,
            is_final=is_final, max_steps=self.max_steps)
        if is_final:
            self._beam_finalized = True
        self._ids = yseq[0, 0, :int(ylen[0, 0])].tolist()

    # --- public API -------------------------------------------------------
    @torch.no_grad()
    def __call__(self, chunk: np.ndarray, is_final: bool = False):
        e = self.model.encoder
        self._samples = np.concatenate(
            [self._samples, np.asarray(chunk, np.float32).reshape(-1)])
        x = self._features(self._samples, stable_only=not is_final)
        if x is not None:
            s_avail = x.shape[1]
            bs, hop = e.block_size, e.hop_size
            if is_final and s_avail <= bs and self._next_block == 0:
                # the short path: the whole utterance in one encode
                n = len(self._samples)
                enc, _ = self.model.encode(self._tensor(self._samples[None]),
                                           self._tensor([n], torch.long))
                self._update(enc[:, :s_avail], True)
            else:
                nblk = None
                if is_final:
                    past = bs - hop - e.look_ahead
                    nblk = max(1, math.ceil(
                        float(s_avail - past - e.look_ahead) / hop))
                while True:
                    bi = self._next_block
                    if (not block_is_safe(bi, hop, bs, s_avail)
                            if nblk is None else bi >= nblk):
                        break
                    out, new_ctx, addin = self._run_block(
                        x, bi, s_avail if is_final else 0)
                    emit = self._emit(out, bi, nblk, s_avail)
                    self._update(emit, nblk is not None and bi == nblk - 1)
                    # the context for the next block
                    self._ctx = new_ctx
                    self._prev_addin = addin
                    self._next_block = bi + 1
        if (is_final and self.search == "beam"
                and self._beam_state is not None
                and not self._beam_finalized):
            # every block was consumed by earlier calls: the final search
            # from the committed state
            self._beam_update(self._enc_buf[:, :0], is_final=True)
        return self._result(is_final)

    def _update(self, enc_frames, final_block: bool):
        if self.search == "beam":
            self._beam_update(enc_frames, is_final=final_block)
        else:
            self._greedy_update(enc_frames)

    def _result(self, is_final: bool) -> dict:
        ids = list(self._ids)
        tokens = self.converter.ids2tokens(ids) if self.converter else []
        text = self.tokenizer.tokens2text(tokens) if self.tokenizer else ""
        if is_final:
            self.reset()
        return {"token_ids": ids, "tokens": tokens, "text": text,
                "is_final": is_final}
