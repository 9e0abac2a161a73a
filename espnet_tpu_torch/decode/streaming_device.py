"""Device-resident streaming ASR, the `device` engine (port of
espnet_tpu/decode/streaming_device.py).

All rolling state lives in float32 tensors on the engine's device (as in
JAX), allocated once per utterance: the sample tail, the feature tail, the
ring of subsampled frames, the per-layer context vectors, the encoder and
CTC buffers and the beam state. The state advances one fixed audio
quantum a step:

    quantum = subsampling 4 x stream_hop_size feature frames
            = one encoder-block hop (0.512 s at block 40, hop 16 and a
              128-sample frame hop at 16 kHz)

A steady step runs the frontend over the new samples only (the carried
sample tail supplies the STFT context), the conv subsampling over the new
frames (the carried feature tail supplies the convs' overlap), rolls the new
subsampled frames into the ring, and, when a block boundary is crossed,
which the host knows from the sample count alone, runs that contextual block
(`ContextualBlockConformerEncoder.one_block` on the ring), after_norm and
the CTC head over the block's finished frames, and the search: CTC greedy,
or the block-synchronous beam search of `decode/online_beam_search.py` on
the device buffers. Host traffic per step: the chunk up and the hypothesis
down. Utterances of at most one block take the offline short path (one
`ASRModel.encode` of the retained signal), as the encoder's own short
branch does.

The JAX engine compiles each kind of step once and donates the state; this
one runs the same fixed-shape steps eagerly (no CUDA graph of the quantum).
The result dicts are those of `decode/streaming_inference.py`.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from espnet_tpu_torch.decode.beam_search import batched_beam_search
from espnet_tpu_torch.decode.online_beam_search import (init_online_state,
                                                        process_block)
from espnet_tpu_torch.decode.streaming_inference import (
    beam_config, block_is_safe, check_streaming_model, greedy_collapse,
    last_block_pad)
from espnet_tpu_torch.device import resolve_device
from espnet_tpu_torch.models.asr import ASRModel
from espnet_tpu_torch.models.streaming import chunk_bias
from espnet_tpu_torch.ops.stft import (_dft_bases, _padded_window, log_mel,
                                       power_spectrum)

_FAR = 1 << 30  # "no utterance end in sight" for t_total


def _subsampled_count(nf: int) -> int:
    """Fully determined subsampled frames of nf feature frames (two VALID
    k=3 s=2 convs)."""
    return max(0, ((nf - 1) // 2 - 1) // 2)


class DeviceStreamingRecognizer:
    """Fixed-shape, device-resident streaming recognizer; takes chunks of
    any size (audio advances in fixed quanta inside). `model` is moved to
    `device` ("cuda" unless "cpu" is asked for)."""

    def __init__(self, model: ASRModel, tokenizer=None, converter=None,
                 search: str = "greedy", beam_size: int = 10,
                 ctc_weight: float = 0.3, penalty: float = 0.0,
                 max_steps: int = 64, t_max: int = 512, device="cuda"):
        check_streaming_model(model, search)
        cfg = model.config
        if cfg.subsampling_factor != 4:
            raise ValueError("device streaming supports subsampling 4")
        if (cfg.n_fft // 2) % cfg.hop_length != 0:
            raise ValueError("n_fft/2 must be a hop multiple")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.converter = converter
        self.search = search
        self.max_steps = max_steps
        self.t_max = t_max

        enc = model.encoder
        self.hop = cfg.hop_length
        self.n_fft = cfg.n_fft
        self.bs = enc.block_size
        self.hb = enc.hop_size
        self.la = enc.look_ahead
        self.d = cfg.d_model
        self.P = self.n_fft // (2 * self.hop)     # centre pad, in hops
        self.F = 4 * self.hb                      # feature frames a quantum
        self.Q = self.F * self.hop                # samples a quantum
        # stable frames after m quanta: m*F - P + 1; the first step gives
        # F1 = F - P + 1 frames, a steady one F. Frame f starts at sample
        # f*hop - n_fft/2, so the carried sample tail is (2P-1) hops.
        self.F1 = self.F - self.P + 1
        self.TAIL = (2 * self.P - 1) * self.hop
        # the convs' overlap: features [4*s_avail, nf) are fed again; nf
        # mod 4 is the same at every steady step
        self.OV = self.F1 - 4 * _subsampled_count(self.F1)
        self.XBUF = max(128, 2 * self.bs + 2 * self.hb)  # frame ring
        self.ZPAD = self.bs + self.hb             # zero slots past the ring
        # emit window of a block's (bs+2) slots: [1, bs-la+1) for block 0,
        # [lo, lo+hb) after it, at most to the end for the last block
        self.lo = self.bs - self.la - self.hb + 1
        self.EMIT_W = max(self.bs - self.la, self.hb,
                          self.bs + 2 - self.lo) + 1
        win = _padded_window(cfg.win_length or self.n_fft, self.n_fft)
        cos_b, sin_b = _dft_bases(self.n_fft)
        self._window = torch.from_numpy(win).to(self.device)
        self._cos = torch.from_numpy(cos_b).to(self.device)
        self._sin = torch.from_numpy(sin_b).to(self.device)
        self._bias = chunk_bias(self.bs, self.device)
        if search == "beam":
            self.bs_cfg = beam_config(beam_size, ctc_weight, penalty,
                                      cfg.blank_id)
        self.reset()

    # ------------------------------------------------------------------
    def reset(self):
        c = self.model.config
        d, dev = self.d, self.device
        self._pending = np.zeros((0,), np.float32)
        self._chunks: List[np.ndarray] = []  # kept for the short path
        self._nsteps = 0            # quanta consumed
        self._nf = 0                # stable feature frames so far
        self._n_samples = 0
        self._enc_committed = 0     # frames in the encoder/CTC buffers
        self._next_block = 0
        self._prev_tok = c.blank_id
        self._ids: List[int] = []
        self._dev: Dict[str, object] = {
            "stail": torch.zeros(1, self.TAIL, device=dev),
            "ftail": torch.zeros(1, self.OV, c.n_mels, device=dev),
            "xbuf": torch.zeros(1, self.XBUF, d, device=dev),
            "ctx": torch.zeros(c.num_encoder_layers, 1, d, device=dev),
            "prev_addin": torch.zeros(1, d, device=dev),
        }
        if self.search == "beam":
            n = self.t_max + self.EMIT_W
            w = self.bs_cfg.beam_size
            self._dev["enc_buf"] = torch.zeros(1, n, d, device=dev)
            self._dev["lp_buf"] = torch.zeros(1, n, c.vocab_size, device=dev)
            self._dev["beam"] = init_online_state(
                self.bs_cfg, c.sos_id, c.eos_id, 1, n, self.max_steps,
                self.model.decoder_init_cache(
                    w, self.max_steps + 1, torch.zeros(w, n, d, device=dev),
                    torch.zeros(w, dtype=torch.long, device=dev)),
                vocab_size=c.vocab_size, device=dev)

    # ------------------------------------------------------------------
    def _mel_of_frames(self, frames):
        """(1, nf, n_fft) sample frames -> (1, nf, n_mels) normalised."""
        c = self.model.config
        fr = frames * self._window
        feats = log_mel(power_spectrum(fr @ self._cos, fr @ self._sin),
                        c.fs, self.n_fft, c.n_mels)
        if c.normalize == "global_mvn":
            nf = feats.shape[1]
            feats = self.model.mvn(feats, torch.full(
                (1,), nf, dtype=torch.long, device=self.device))
        return feats

    def _frames_of_window(self, window, n_frames: int):
        idx = (torch.arange(n_frames, device=self.device)[:, None] * self.hop
               + torch.arange(self.n_fft, device=self.device)[None, :])
        return window[:, idx]

    def _features(self, chunk, kind: str, r_valid: int):
        """The feature part of a step: (new subsampled frames (1, S, d),
        how many of them are new)."""
        dev = self._dev
        if kind == "first":
            # frames [0, F1): reflect pad n_fft/2 on the left
            window = torch.nn.functional.pad(
                chunk[:, None], (self.n_fft // 2, 0), mode="reflect")[:, 0]
            conv_in = self._mel_of_frames(
                self._frames_of_window(window, self.F1))
            count_s = _subsampled_count(self.F1)
            dev["stail"].copy_(chunk[:, -self.TAIL:])
            dev["ftail"].copy_(conv_in[:, -self.OV:])
        elif kind == "steady":
            window = torch.cat([dev["stail"], chunk], dim=1)
            feats = self._mel_of_frames(
                self._frames_of_window(window, self.F))
            conv_in = torch.cat([dev["ftail"], feats], dim=1)
            count_s = self.hb
            dev["stail"].copy_(window[:, -self.TAIL:])
            dev["ftail"].copy_(conv_in[:, -self.OV:])
        else:  # flush: the last, partial quantum
            slots = self.F + self.P
            window = torch.cat([dev["stail"], chunk, torch.zeros(
                1, (self.P + 2) * self.hop, device=self.device)], dim=1)
            n_valid = self.TAIL + r_valid
            idx = (torch.arange(slots, device=self.device)[:, None]
                   * self.hop
                   + torch.arange(self.n_fft, device=self.device)[None, :])
            # right reflect pad at the utterance end
            idx = torch.where(idx >= n_valid, 2 * n_valid - 2 - idx, idx)
            idx = idx.clamp(0, window.shape[1] - 1)
            feats = self._mel_of_frames(window[0][idx][None])
            cf = r_valid // self.hop + self.P  # valid frames this flush
            keep = torch.arange(slots, device=self.device)[None, :, None] < cf
            feats = feats * keep.to(feats.dtype)
            conv_in = torch.cat([dev["ftail"], feats], dim=1)
            count_s = max((self.OV + cf - 3) // 4, 0)
        nf = conv_in.shape[1]
        new_x, _ = self.model.encoder.embed(conv_in, torch.full(
            (1,), nf, dtype=torch.long, device=self.device))
        return new_x, count_s

    def _roll_in(self, new_x, count: int) -> None:
        """The `count` leading frames of new_x into the ring's right end."""
        xbuf = self._dev["xbuf"]
        if count:
            xbuf.copy_(torch.cat([xbuf[:, count:],
                                  new_x[:, :count].to(xbuf.dtype)], dim=1))

    def _block(self, bi: int, s_avail: int, t_total: int, emit_start: int,
               emit_count: int):
        """Contextual block `bi` from the ring: the block's finished frames
        (1, EMIT_W, d) after after_norm, zero past emit_count."""
        dev = self._dev
        e = self.model.encoder
        bs, d = self.bs, self.d
        ring = torch.cat([dev["xbuf"], torch.zeros(
            1, self.ZPAD, d, device=self.device, dtype=dev["xbuf"].dtype)],
            dim=1)
        start = bi * self.hb
        rel = self.XBUF - (s_avail - start)
        frames = ring[:, rel:rel + bs]
        count = min(max(t_total - start, 1), bs)
        if e.init_average:
            addin = frames.sum(dim=1) / count
        else:
            addin = frames.max(dim=1).values
        if e.ctx_pos_enc:
            addin = e.pos_enc(addin[:, None], start=bi)[:, 0]
        first = bi == 0
        ctx = None if first else list(dev["ctx"])
        h, new_ctx = e.one_block(
            last_block_pad(e.pos_enc(frames, start=start), count), addin,
            dev["prev_addin"], ctx, self._bias)
        dev["ctx"].copy_(torch.stack(new_ctx, dim=0))
        dev["prev_addin"].copy_(addin)
        h = torch.nn.functional.pad(h, (0, 0, 0, self.EMIT_W))
        emit = e.after_norm(h[:, emit_start:emit_start + self.EMIT_W])
        keep = (torch.arange(self.EMIT_W, device=self.device)[None, :, None]
                < emit_count)
        return torch.where(keep, emit, torch.zeros((), dtype=emit.dtype,
                                                   device=emit.device))

    def _search(self, emit, emit_count: int, old_len: int,
                is_final_block: bool) -> None:
        """The CTC head on the finished frames; greedy or beam onwards."""
        c = self.model.config
        lp = self.model.ctc_log_probs(emit)
        if self.search == "greedy":
            toks = lp[0].argmax(dim=-1)[:emit_count].tolist()
            self._prev_tok = greedy_collapse(toks, self._ids, self._prev_tok,
                                             c.blank_id)
            return
        dev = self._dev
        dev["enc_buf"][:, old_len:old_len + self.EMIT_W] = emit.float()
        dev["lp_buf"][:, old_len:old_len + self.EMIT_W] = lp
        new_len = min(old_len + emit_count, self.t_max)
        w = self.bs_cfg.beam_size
        mem = dev["enc_buf"].repeat_interleave(w, dim=0)
        mem_lens = torch.full((w,), new_len, dtype=torch.long,
                              device=self.device)

        def att_score_fn(tokens, pos, cache):
            return self.model.decoder_score_step(tokens, pos, mem, mem_lens,
                                                 cache)

        lengths = (torch.full((1,), old_len, dtype=torch.long,
                              device=self.device),
                   torch.full((1,), new_len, dtype=torch.long,
                              device=self.device))
        dev["beam"], yseq, ylen, _ = process_block(
            self.bs_cfg, c.sos_id, c.eos_id, c.vocab_size, dev["beam"],
            dev["lp_buf"], *lengths, att_score_fn,
            is_final=is_final_block, max_steps=self.max_steps)
        self._ids = yseq[0, 0, :int(ylen[0, 0])].tolist()

    # ------------------------------------------------------------------
    def _emit_params(self, bi: int, nblk: Optional[int], t_total_s: int):
        """(emit_start, emit_count) of block bi."""
        if bi == 0:
            start, count = 1, self.bs - self.la
        else:
            start, count = self.lo, self.hb
        if nblk is not None and bi == nblk - 1:
            count = t_total_s - bi * self.hb + 1 - start
        return start, max(0, min(count, self.EMIT_W))

    def _run_block(self, bi, s_avail, t_total_s, nblk) -> None:
        emit_start, emit_count = self._emit_params(bi, nblk, t_total_s)
        final = nblk is not None and bi == nblk - 1
        emit = self._block(bi, s_avail,
                           t_total_s if t_total_s is not None else _FAR,
                           emit_start, emit_count)
        self._search(emit, emit_count, self._enc_committed, final)
        self._next_block = bi + 1
        self._enc_committed = min(self._enc_committed + emit_count,
                                  self.t_max)

    def _advance(self, chunk_np: np.ndarray, kind: str, r_valid: int,
                 t_total_s: Optional[int], nblk: Optional[int]) -> None:
        """One step; the host decides the block schedule from the sample
        count alone."""
        s_old = _subsampled_count(self._nf)
        if kind == "first":
            nf_new = self._nf + self.F1
        elif kind == "steady":
            nf_new = self._nf + self.F
        else:
            nf_new = self._nf + r_valid // self.hop + self.P
        chunk = torch.from_numpy(chunk_np[None]).to(self.device)
        new_x, count_s = self._features(chunk, kind, r_valid)
        self._roll_in(new_x, count_s)
        self._nf = nf_new
        bi = self._next_block
        if nblk is None:
            ready = block_is_safe(bi, self.hb, self.bs,
                                  _subsampled_count(nf_new))
        else:
            ready = bi < nblk
        if ready:
            self._run_block(bi, s_old + count_s, t_total_s, nblk)

    def _offline_final(self, n: int, t_s: int) -> None:
        """The short path: one offline encode of the retained signal."""
        c = self.model.config
        sig = (np.concatenate(self._chunks) if self._chunks
               else np.zeros((0,), np.float32))[:n]
        enc, _ = self.model.encode(
            torch.from_numpy(sig[None]).to(self.device),
            torch.full((1,), n, dtype=torch.long, device=self.device))
        enc = enc[:, :t_s]
        lp = self.model.ctc_log_probs(enc)
        if self.search == "greedy":
            self._prev_tok = greedy_collapse(lp[0].argmax(dim=-1).tolist(),
                                             self._ids, self._prev_tok,
                                             c.blank_id)
            return
        w = self.bs_cfg.beam_size
        mem = enc.repeat_interleave(w, dim=0)
        mem_lens = torch.full((w,), t_s, dtype=torch.long, device=self.device)

        def att_score_fn(tokens, pos, cache):
            return self.model.decoder_score_step(tokens, pos, mem, mem_lens,
                                                 cache)

        yseq, ylen, _ = batched_beam_search(
            self.bs_cfg, c.sos_id, c.eos_id, c.vocab_size,
            torch.full((1,), t_s, dtype=torch.long, device=self.device),
            att_score_fn,
            self.model.decoder_init_cache(w, self.max_steps + 1, mem,
                                          mem_lens),
            ctc_log_probs=lp if self.bs_cfg.ctc_weight > 0 else None,
            max_steps=self.max_steps)
        self._ids = yseq[0, 0, :int(ylen[0, 0])].tolist()

    # ------------------------------------------------------------------
    @torch.no_grad()
    def __call__(self, chunk: np.ndarray, is_final: bool = False):
        arr = np.asarray(chunk, np.float32).reshape(-1)
        self._pending = np.concatenate([self._pending, arr])
        self._n_samples += len(arr)
        # the host copy of the audio is kept only while the utterance could
        # still take the short path
        if _subsampled_count(self._n_samples // self.hop + 1) <= self.bs:
            self._chunks.append(arr)
        else:
            self._chunks.clear()
        while len(self._pending) >= self.Q:
            q = self._pending[:self.Q]
            self._pending = self._pending[self.Q:]
            self._advance(q, "first" if self._nsteps == 0 else "steady", 0,
                          None, None)
            self._nsteps += 1
        if is_final:
            n = self._n_samples
            t_s = _subsampled_count(n // self.hop + 1)
            if self._nsteps == 0 or t_s <= self.bs:
                self._offline_final(n, t_s)
            else:
                past = self.bs - self.hb - self.la
                nblk = max(1, math.ceil(
                    float(t_s - past - self.la) / self.hb))
                r = len(self._pending)
                qpad = np.zeros(self.Q, np.float32)
                qpad[:r] = self._pending
                self._pending = np.zeros((0,), np.float32)
                self._advance(qpad, "flush", r, t_s, nblk)
                while self._next_block < nblk:
                    self._run_block(self._next_block,
                                    _subsampled_count(self._nf), t_s, nblk)
        ids = list(self._ids)
        tokens = self.converter.ids2tokens(ids) if self.converter else []
        text = self.tokenizer.tokens2text(tokens) if self.tokenizer else ""
        if is_final:
            self.reset()
        return {"token_ids": ids, "tokens": tokens, "text": text,
                "is_final": is_final}
