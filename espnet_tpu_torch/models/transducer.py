"""Transducer (RNN-T) ASR model: encoder + prediction network + joint
network (port of espnet_tpu/models/transducer.py).

A frontend (log-mel of raw 16 kHz input, or features passed through; SpecAug
in training; utterance MVN or nothing), the conformer or transformer encoder
of the ASR model, an LSTM prediction network over the label history (blank
as BOS) and the joint tanh(W_enc h_t + W_dec g_u) -> vocab. `forward` is the
training loss: the RNN-T loss (`ops/transducer.py`, its lattice on the
card's kernel pair), plus, when configured, aux CTC on the encoder output,
the aux transducer on intermediate encoder layers through the frozen joint
(with a symmetric KL between the main and aux posteriors) and a next-label
LM loss on the prediction network. `greedy_search` and the four beam
searches (`decode/transducer_search.py`) serve inference.

As in the JAX package, `normalize="global_mvn"` normalises nothing: the
model has no global-MVN statistics, so such a model trains and decodes on
unnormalised features (the JAX task collects stats and passes them in a
collection that this model never reads; the port's task writes the stats
and leaves them out, and its converter drops that collection). An
`encoder_type` other than conformer and transformer raises a ValueError
(the JAX model builds a transformer for any other value).

Parameters are float32; `TransducerConfig.dtype` is the compute dtype. The
LSTM cell is flax's `OptimizedLSTMCell` written out (`models.layers.
LSTMCell`, importable from here too), from a zero carry (c, h). Dropout
and SpecAug draw from the caller's `torch.Generator` in training, as in the
ASR model.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from espnet_tpu_torch.models.asr import ASRBase
from espnet_tpu_torch.models.conformer import ConformerEncoder
from espnet_tpu_torch.models.layers import Dense, LSTMCell, lstm_sequence
from espnet_tpu_torch.models.transformer import TransformerEncoder
from espnet_tpu_torch.ops.ctc import ctc_loss
from espnet_tpu_torch.ops.dropout import Dropout
from espnet_tpu_torch.ops.normalize import utterance_mvn
from espnet_tpu_torch.ops.specaug import specaug
from espnet_tpu_torch.ops.stft import log_mel_spectrogram
from espnet_tpu_torch.ops.transducer import transducer_loss


@dataclasses.dataclass(frozen=True)
class TransducerConfig:
    """Every field of the JAX `TransducerConfig`, with its default."""

    vocab_size: int
    input_type: str = "raw"
    fs: int = 16000
    n_fft: int = 512
    hop_length: int = 128
    n_mels: int = 80
    use_specaug: bool = True
    normalize: str = "utterance_mvn"
    encoder_type: str = "conformer"
    d_model: int = 256
    num_heads: int = 4
    d_ff: int = 2048
    num_encoder_layers: int = 12
    subsampling_factor: int = 4
    conformer_kernel_size: int = 31
    # prediction network
    decoder_embed_dim: int = 256
    decoder_hidden: int = 256
    decoder_layers: int = 1
    joint_dim: int = 320
    dropout_rate: float = 0.1
    ctc_weight: float = 0.0  # aux CTC on the encoder
    # auxiliary losses: the aux transducer on intermediate encoder layers
    # (1-based `aux_layers`) with an optional symmetric KL between the main
    # and aux joint posteriors, and a next-label LM loss
    aux_transducer_weight: float = 0.0
    symm_kl_weight: float = 0.0
    lm_loss_weight: float = 0.0
    aux_layers: tuple = ()
    dtype: torch.dtype = torch.float32

    @property
    def blank_id(self) -> int:
        return 0


ENCODER_TYPES = ("conformer", "transformer")
class PredictionNetwork(nn.Module):
    """LSTM label-history encoder (`asr_transducer/decoder/rnn_decoder.py`):
    embedding, flax-rule dropout on it (training), `layers` LSTM cells."""

    def __init__(self, vocab_size: int, embed_dim: int = 256,
                 hidden: int = 256, layers: int = 1,
                 dropout_rate: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.hidden = hidden
        self.num_layers = layers
        self.dtype = dtype
        self.embed = nn.Embedding(vocab_size, embed_dim)
        for i in range(layers):
            self.add_module(f"lstm{i}", LSTMCell(
                embed_dim if i == 0 else hidden, hidden, dtype))
        self.dropout = Dropout(dropout_rate)

    def cells(self):
        return [getattr(self, f"lstm{i}") for i in range(self.num_layers)]

    def _embed(self, tokens):
        return nn.functional.embedding(tokens.long(),
                                       self.embed.weight.to(self.dtype))

    def init_state(self, batch: int, device=None):
        """((c, h), ...) per layer: zeros (B, H) float32."""
        dev = device if device is not None else self.embed.weight.device
        z = torch.zeros(batch, self.hidden, device=dev)
        return tuple((z, z) for _ in range(self.num_layers))

    def step(self, state, token):
        """token (B,) -> (out (B, H) in the compute dtype, new state)."""
        x = self._embed(token)
        new_state = []
        for cell, st in zip(self.cells(), state):
            st = cell.step(st, cell.input_proj(x))
            new_state.append(st)
            x = st[1].to(self.dtype)
        return x, tuple(new_state)

    def forward(self, tokens, generator=None):
        """tokens (B, U) -> outputs (B, U+1, H) for histories of 0..U labels
        (blank as BOS)."""
        b, u = tokens.shape
        start = torch.zeros((b, 1), dtype=torch.long, device=tokens.device)
        x = self.dropout(self._embed(torch.cat([start, tokens.long()], 1)),
                         generator)
        for cell in self.cells():
            x = lstm_sequence(cell, x)[0].to(self.dtype)
        return x


class JointNetwork(nn.Module):
    """tanh(W_enc h_t + W_dec g_u) -> vocab (`joint_network.py`)."""

    def __init__(self, d_enc: int, d_dec: int, vocab_size: int,
                 joint_dim: int = 320, dtype=torch.float32):
        super().__init__()
        self.lin_enc = Dense(d_enc, joint_dim, dtype=dtype)
        self.lin_dec = Dense(d_dec, joint_dim, dtype=dtype)
        self.lin_out = Dense(joint_dim, vocab_size, dtype=dtype)

    def forward(self, enc, dec, frozen: bool = False):
        """enc (..., D_e), dec (..., D_d), broadcastable after the
        projections -> logits (..., V). `frozen`: the weights take no
        gradient (the aux transducer's `stop_gradient` on the joint)."""
        if not frozen:
            h = self.lin_enc(enc) + self.lin_dec(dec)
            return self.lin_out(torch.tanh(h))

        def dense(layer, x):
            dt = layer.compute_dtype
            return nn.functional.linear(x.to(dt), layer.weight.detach().to(dt),
                                        layer.bias.detach().to(dt))

        h = dense(self.lin_enc, enc) + dense(self.lin_dec, dec)
        return dense(self.lin_out, torch.tanh(h))


class TransducerASRModel(ASRBase):
    """Frontend + encoder + prediction network + joint (+ ctc_head with
    ctc_weight > 0, aux_mlp with aux_transducer_weight > 0, lm_head with
    lm_loss_weight > 0), with the JAX model's parameter names.
    `encoder_options` go to the encoder (the conformer's conv routes)."""

    def __init__(self, config: TransducerConfig,
                 encoder_options: Optional[Dict] = None):
        super().__init__()
        c = config
        if c.encoder_type not in ENCODER_TYPES:
            raise ValueError(f"encoder_type {c.encoder_type!r} not in "
                             f"{ENCODER_TYPES}")
        if c.aux_transducer_weight > 0 and not (
                c.aux_layers and all(isinstance(i, int)
                                     and 1 <= i <= c.num_encoder_layers
                                     for i in c.aux_layers)):
            # the JAX model captures nothing for an empty or out-of-range
            # list, or the CLI's string "6", and drops the aux loss
            raise ValueError(
                f"aux_layers {c.aux_layers!r}: give 1-based layer numbers up "
                f"to {c.num_encoder_layers} as a list (--model.aux_layers "
                "[6] or 6, in YAML [6]) for aux_transducer_weight > 0")
        self.config = c
        opts = dict(encoder_options or {})
        capture = tuple(c.aux_layers) if c.aux_transducer_weight > 0 else ()
        if c.encoder_type == "conformer":
            self.encoder = ConformerEncoder(
                c.n_mels, c.d_model, c.num_heads, c.d_ff,
                c.num_encoder_layers, c.conformer_kernel_size,
                c.subsampling_factor, c.dtype, c.dropout_rate,
                capture_layers=capture, **opts)
        else:
            self.encoder = TransformerEncoder(
                c.n_mels, c.d_model, c.num_heads, c.d_ff,
                c.num_encoder_layers, c.subsampling_factor, c.dtype,
                c.dropout_rate, capture_layers=capture, **opts)
        self.decoder = PredictionNetwork(
            c.vocab_size, c.decoder_embed_dim, c.decoder_hidden,
            c.decoder_layers, c.dropout_rate, c.dtype)
        self.joint = JointNetwork(c.d_model, c.decoder_hidden, c.vocab_size,
                                  c.joint_dim, c.dtype)
        self.ctc_head = (Dense(c.d_model, c.vocab_size, dtype=c.dtype)
                         if c.ctc_weight > 0 else None)
        self.aux_mlp = (Dense(c.d_model, c.d_model, dtype=c.dtype)
                        if c.aux_transducer_weight > 0 else None)
        self.lm_head = (Dense(c.decoder_hidden, c.vocab_size, dtype=c.dtype)
                        if c.lm_loss_weight > 0 else None)

    def frontend(self, speech, speech_lengths, generator=None):
        c = self.config
        if c.input_type == "raw":
            feats, lens = log_mel_spectrogram(
                speech, speech_lengths, c.fs, c.n_fft, c.hop_length, None,
                c.n_mels)
        else:
            feats, lens = speech, speech_lengths
        if c.use_specaug and self.training and generator is not None:
            feats = specaug(generator, feats, lens)
        if c.normalize == "utterance_mvn":
            feats = utterance_mvn(feats, lens)
        return feats, lens

    def encode_with_intermediates(self, speech, speech_lengths,
                                  generator=None):
        feats, lens = self.frontend(speech, speech_lengths, generator)
        out = self.encoder(feats, lens, generator)
        if len(out) == 3:
            return out
        return out[0], out[1], []

    def encode(self, speech, speech_lengths, generator=None):
        """(B, N) waveforms (or features) -> (encoder out (B, T', D),
        output lengths)."""
        out = self.encode_with_intermediates(speech, speech_lengths,
                                             generator)
        return out[0], out[1]

    def forward(self, speech, speech_lengths, text, text_lengths,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Training loss: (loss, stats) with the JAX model's stats
        loss_rnnt, loss_ctc, loss_aux_trans, loss_symm_kl, loss_lm (as
        configured) and loss. text (B, U) padded with 0 past text_lengths.
        In training mode `generator` drives dropout and SpecAug and is
        required when either is configured."""
        c = self.config
        self.require_generator(generator)
        enc, enc_lengths, inters = self.encode_with_intermediates(
            speech, speech_lengths, generator)
        text = text.long()
        text_lengths = text_lengths.long()
        dec = self.decoder(text, generator)  # (B, U+1, H)
        logits = self.joint(enc[:, :, None, :], dec[:, None, :, :])
        loss_rnnt = transducer_loss(logits, text, enc_lengths, text_lengths,
                                    c.blank_id, use_kernels=self.use_kernels)
        stats = {"loss_rnnt": loss_rnnt}
        loss = loss_rnnt
        if self.ctc_head is not None:
            loss_ctc = ctc_loss(self.ctc_head(enc), text, enc_lengths,
                                text_lengths, c.blank_id,
                                use_kernels=self.use_kernels)
            stats["loss_ctc"] = loss_ctc
            loss = (1 - c.ctc_weight) * loss + c.ctc_weight * loss_ctc
        if self.aux_mlp is not None and inters:
            # aux transducer on intermediate layers through the frozen joint
            # (gradients reach aux_mlp and the encoder, never the joint),
            # and the symmetric KL between the main and aux posteriors
            # (`transducer_tasks.py:203-286`)
            loss_aux = loss_kl = 0.0
            denom = float(logits.shape[0] * logits.shape[1]
                          * logits.shape[2])
            for _, h_aux in inters:
                aux_logits = self.joint(self.aux_mlp(h_aux)[:, :, None, :],
                                        dec[:, None, :, :], frozen=True)
                loss_aux = loss_aux + transducer_loss(
                    aux_logits, text, enc_lengths, text_lengths, c.blank_id,
                    use_kernels=self.use_kernels)
                if c.symm_kl_weight > 0:
                    p_main = torch.log_softmax(logits.float(), dim=-1)
                    p_aux = torch.log_softmax(aux_logits.float(), dim=-1)
                    kl_ma = (torch.exp(p_aux) * (p_aux - p_main)).sum() / denom
                    kl_am = (torch.exp(p_main) * (p_main - p_aux)).sum() / denom
                    loss_kl = loss_kl + kl_ma + kl_am
            loss_aux = loss_aux / len(inters)
            stats["loss_aux_trans"] = loss_aux
            loss = loss + c.aux_transducer_weight * loss_aux
            if c.symm_kl_weight > 0:
                loss_kl = loss_kl / len(inters)
                stats["loss_symm_kl"] = loss_kl
                loss = loss + c.symm_kl_weight * loss_kl
        if self.lm_head is not None:
            # next-label prediction on the prediction network's outputs
            # (`transducer_tasks.py:286-307`): dec[:, u] predicts text[:, u]
            lp = torch.log_softmax(self.lm_head(dec[:, :-1]).float(), dim=-1)
            picked = lp.gather(2, text[..., None])[..., 0]
            valid = (torch.arange(text.shape[1], device=text.device)[None, :]
                     < text_lengths[:, None]).float()
            ce = -(picked * valid).sum() / valid.sum().clamp(min=1.0)
            stats["loss_lm"] = ce
            loss = loss + c.lm_loss_weight * ce
        stats["loss"] = loss
        return loss, stats

    # --- inference -------------------------------------------------------
    def dec_init(self, n: int):
        """(out (N, H), state) after the blank BOS."""
        dev = self.decoder.embed.weight.device
        state = self.decoder.init_state(n, dev)
        return self.decoder.step(
            state, torch.full((n,), self.config.blank_id, dtype=torch.long,
                              device=dev))

    def search_fns(self) -> dict:
        """The callbacks of the batched searches (`decode/
        transducer_search.py`): joint_fn, dec_init, dec_step."""
        return {"joint_fn": self.joint, "dec_init": self.dec_init,
                "dec_step": self.decoder.step}

    @torch.no_grad()
    def greedy_search(self, enc, enc_lengths, max_tokens: int = 128,
                      max_symbols_per_frame: int = 3):
        """Batched greedy decode: per frame, emit the joint's argmax while it
        is not blank, at most `max_symbols_per_frame` labels. The JAX
        `lax.while_loop` as a Python loop with its stop rule. Returns
        (tokens (B, max_tokens), lengths (B,))."""
        c = self.config
        b, t_max, d = enc.shape
        dev = enc.device
        enc_lengths = enc_lengths.long()
        bi = torch.arange(b, device=dev)
        pos = torch.arange(max_tokens, device=dev)[None]
        t = torch.zeros(b, dtype=torch.long, device=dev)
        u = torch.zeros_like(t)
        sym = torch.zeros_like(t)
        out = torch.zeros(b, max_tokens, dtype=torch.long, device=dev)
        dec_out, dec_state = self.dec_init(b)
        while bool(((t < enc_lengths) & (u < max_tokens)).any()):
            enc_t = enc[bi, t.clamp(max=t_max - 1)]
            pred = self.joint(enc_t, dec_out).argmax(-1)
            active = t < enc_lengths
            is_blank = (pred == c.blank_id) | (sym >= max_symbols_per_frame)
            emit = active & ~is_blank & (u < max_tokens)
            out = torch.where((pos == u[:, None]) & emit[:, None],
                              pred[:, None], out)
            new_out, new_state = self.decoder.step(dec_state, pred)
            dec_out = torch.where(emit[:, None], new_out, dec_out)
            dec_state = tuple(
                tuple(torch.where(emit[:, None], n, o) for n, o in zip(nl, ol))
                for nl, ol in zip(new_state, dec_state))
            sym = torch.where(emit, sym + 1, sym)
            adv = active & (is_blank | (u >= max_tokens))
            u = u + emit.long()
            t = t + adv.long()
            sym = torch.where(adv, torch.zeros_like(sym), sym)
        return out, u

    def _search(self, fn_name, enc, enc_lengths, **kw):
        from espnet_tpu_torch.decode import transducer_search as ts

        with torch.no_grad():
            return getattr(ts, fn_name)(enc, enc_lengths, **self.search_fns(),
                                        **kw)

    def beam_search(self, enc, enc_lengths, beam_size: int = 5,
                    max_expansions: int = 3, max_tokens: int = 256,
                    score_norm: bool = True):
        """Batched mAES-style search; (tokens, lengths, scores)."""
        from espnet_tpu_torch.decode.transducer_search import \
            TransducerSearchConfig

        return self._search(
            "batched_transducer_beam_search", enc, enc_lengths,
            config=TransducerSearchConfig(
                beam_size=beam_size, max_expansions=max_expansions,
                blank_id=self.config.blank_id, max_tokens=max_tokens,
                score_norm=score_norm))

    def nsc_search(self, enc, enc_lengths, beam_size: int = 5,
                   nstep: int = 2, max_tokens: int = 256,
                   score_norm: bool = True):
        """Batched N-step constrained search with prefix merging."""
        from espnet_tpu_torch.decode.transducer_search import \
            TransducerSearchConfig

        return self._search(
            "batched_transducer_nsc", enc, enc_lengths,
            config=TransducerSearchConfig(
                beam_size=beam_size, max_expansions=nstep,
                blank_id=self.config.blank_id, max_tokens=max_tokens,
                score_norm=score_norm))

    def alsd_search(self, enc, enc_lengths, beam_size: int = 5,
                    max_tokens: int = 256, u_max: int = 50,
                    score_norm: bool = True):
        """Batched alignment-length synchronous search."""
        from espnet_tpu_torch.decode.transducer_search import \
            TransducerSearchConfig

        return self._search(
            "batched_transducer_alsd", enc, enc_lengths,
            config=TransducerSearchConfig(
                beam_size=beam_size, blank_id=self.config.blank_id,
                max_tokens=max_tokens, score_norm=score_norm),
            u_max=u_max)

    def tsd_search(self, enc, enc_lengths, beam_size: int = 5,
                   max_sym_exp: int = 3, max_tokens: int = 256,
                   score_norm: bool = True):
        """Batched time-synchronous search with logaddexp prefix merging;
        `max_sym_exp` counts joint levels, so max_expansions =
        max(max_sym_exp - 1, 1)."""
        from espnet_tpu_torch.decode.transducer_search import \
            TransducerSearchConfig

        return self._search(
            "batched_transducer_tsd", enc, enc_lengths,
            config=TransducerSearchConfig(
                beam_size=beam_size, max_expansions=max(max_sym_exp - 1, 1),
                blank_id=self.config.blank_id, max_tokens=max_tokens,
                score_norm=score_norm))
