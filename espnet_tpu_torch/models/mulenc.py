"""Multi-encoder ASR (mulenc): E parallel encoders fused by a hierarchical
attention gate in the decoder (port of espnet_tpu/models/mulenc.py).

Every stream's frontend and encoder run over the same padded sample axis,
so the encoder outputs stack to (B, E, T', D) with lengths (B, E). The
decoder is a transformer whose cross-attention runs per stream
(`src_attn{e}`) and whose HAN gate (`han_gate`) is a softmax over the E
stream contexts, computed in float32 and cast to the contexts' dtype before
the weighted sum, as in JAX; its FFN takes the `fused_ffn` route (JAX's
`PositionwiseFeedForward` with the auto rule, which the port applies at
every row count). The cross-attentions have Tq != Tk and never reach flash
attention; the transformer encoders' self-attention does.

Training mixes the per-stream CTC losses (`ctc_loss_from_log_probs` on each
stream's log-softmax, on the CTC lattice kernels) with `weights_ctc_train`;
decoding fuses the streams log-linearly at the frame level with
`weights_ctc_dec` (sum_e w_e log p_e, renormalised), as the JAX model does
(ESPnet sums per-stream prefix scores instead). `share_ctc` gives every
stream the one head `ctc_head0`. Every stream is a waveform: `input_type`
is inert, as in the JAX model.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from espnet_tpu_torch.models.asr import ASRBase, add_sos_eos
from espnet_tpu_torch.models.attention import MultiHeadAttention
from espnet_tpu_torch.models.conformer import ConformerEncoder
from espnet_tpu_torch.models.layers import Dense, LayerNorm
from espnet_tpu_torch.models.transformer import (PositionwiseFeedForward,
                                                 TokenStack,
                                                 TransformerEncoder)
from espnet_tpu_torch.ops.ctc import ctc_loss_from_log_probs
from espnet_tpu_torch.ops.dropout import Dropout
from espnet_tpu_torch.ops.losses import label_smoothing_loss, token_accuracy
from espnet_tpu_torch.ops.masks import attention_bias, make_valid_mask


def parse_weights(spec: str, n: int) -> Tuple[float, ...]:
    """"0.5,0.5" -> normalised tuple; empty -> uniform (the reference
    normalises with np.sum, `e2e_asr_mulenc.py:388`)."""
    if not spec:
        return tuple(1.0 / n for _ in range(n))
    vals = [float(x) for x in spec.split(",")]
    if len(vals) != n:
        raise ValueError(f"need {n} ctc weights, got {spec!r}")
    s = sum(vals)
    return tuple(v / s for v in vals)


@dataclasses.dataclass(frozen=True)
class MulEncConfig:
    """The JAX `MulEncConfig`, field for field, with its defaults."""

    vocab_size: int
    num_encoders: int = 2
    encoder_type: str = "transformer"   # transformer | conformer
    input_type: str = "raw"
    fs: int = 16000
    n_fft: int = 512
    hop_length: int = 128
    n_mels: int = 80
    use_specaug: bool = True
    normalize: str = "utterance_mvn"
    d_model: int = 256
    num_heads: int = 4
    d_ff: int = 1024
    num_encoder_layers: int = 4
    subsampling_factor: int = 4
    conformer_kernel_size: int = 15
    num_decoder_layers: int = 4
    decoder_d_ff: int = 1024
    ctc_weight: float = 0.3
    share_ctc: bool = False
    weights_ctc_train: str = ""   # comma floats, normalised; "" = uniform
    weights_ctc_dec: str = ""
    lsm_weight: float = 0.1
    dropout_rate: float = 0.1
    dtype: torch.dtype = torch.float32

    @property
    def sos_id(self) -> int:
        return self.vocab_size - 1

    @property
    def eos_id(self) -> int:
        return self.vocab_size - 1

    @property
    def blank_id(self) -> int:
        return 0


class MulEncDecoderLayer(nn.Module):
    """Decoder layer with per-stream cross-attention and the HAN gate."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 num_encoders: int, dropout_rate: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        self.num_encoders = num_encoders
        self.norm1 = LayerNorm(d_model, dtype)
        self.self_attn = MultiHeadAttention(num_heads, d_model, dtype)
        self.norm2 = LayerNorm(d_model, dtype)
        for e in range(num_encoders):
            self.add_module(f"src_attn{e}",
                            MultiHeadAttention(num_heads, d_model, dtype))
        self.han_gate = Dense(d_model, num_encoders, dtype=dtype)
        self.norm3 = LayerNorm(d_model, dtype)
        self.ff = PositionwiseFeedForward(d_model, d_ff, "relu", dtype,
                                          dropout_rate, fused=True)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x, self_bias, memory, memory_bias, cache=None,
                cache_index=None, generator=None):
        """memory (B, E, T, D); memory_bias (B, E, 1, 1, T)."""
        drop = self.dropout
        h = self.norm1(x)
        new_cache = None
        if cache is not None:
            h, new_cache = self.self_attn(h, h, h, self_bias, cache,
                                          cache_index)
        else:
            h = self.self_attn(h, h, h, self_bias)
        x = x + drop(h, generator)
        h = self.norm2(x)
        ctx = torch.stack([
            getattr(self, f"src_attn{e}")(h, memory[:, e], memory[:, e],
                                          memory_bias[:, e])
            for e in range(self.num_encoders)], dim=2)  # (B, U, E, D)
        gate = torch.softmax(self.han_gate(h).float(), dim=-1).to(ctx.dtype)
        fused = torch.einsum("buec,bue->buc", ctx, gate)
        x = x + drop(fused, generator)
        x = x + drop(self.ff(self.norm3(x), generator), generator)
        if cache is not None:
            return x, new_cache
        return x


class MulEncTransformerDecoder(TokenStack):
    """Transformer decoder over the stacked multi-encoder memory."""

    def __init__(self, vocab_size: int, num_encoders: int,
                 d_model: int = 256, num_heads: int = 4, d_ff: int = 1024,
                 num_layers: int = 4, dropout_rate: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.dtype = dtype
        self.embed = nn.Embedding(vocab_size, d_model)
        for i in range(num_layers):
            self.add_module(f"layer{i}", MulEncDecoderLayer(
                d_model, num_heads, d_ff, num_encoders, dropout_rate, dtype))
        self.final_norm = LayerNorm(d_model, dtype)
        self.out_proj = Dense(d_model, vocab_size, dtype=dtype)
        self.dropout = Dropout(dropout_rate)

    @staticmethod
    def memory_bias(memory, memory_lengths):
        """memory (B, E, T, D), lengths (B, E) -> (B, E, 1, 1, T)."""
        b, e, t = memory.shape[:3]
        mask = make_valid_mask(memory_lengths.reshape(-1), t).reshape(b, e, t)
        return attention_bias(mask[:, :, None, None, :])

    def forward(self, tokens, token_lengths, memory, memory_lengths,
                generator=None):
        x = self._embed_sequence(tokens, generator)
        self_bias = self._causal_bias(token_lengths, tokens.shape[1])
        mem_bias = self.memory_bias(memory, memory_lengths)
        for layer in self.layers():
            x = layer(x, self_bias, memory, mem_bias, generator=generator)
        return self.out_proj(self.final_norm(x))

    def score_step(self, tokens_step, pos: int, memory, memory_lengths,
                   cache):
        x = self._embed_step(tokens_step, pos, cache)
        mem_bias = self.memory_bias(memory, memory_lengths)
        new_caches = []
        for layer, layer_cache in zip(self.layers(), cache):
            x, nc = layer(x, None, memory, mem_bias, layer_cache, pos)
            new_caches.append(nc)
        return self._step_log_probs(x), new_caches


class ASRMulEncModel(ASRBase):
    """Multi-encoder joint CTC/attention ASR: `encoder{e}`, `ctc_head{i}`
    (one with share_ctc) and, when ctc_weight < 1, `decoder`."""

    def __init__(self, config: MulEncConfig):
        super().__init__()
        c = config
        if c.encoder_type not in ("transformer", "conformer"):
            # the JAX model builds a transformer for any other value
            raise ValueError(f"encoder_type {c.encoder_type!r} not in "
                             "('transformer', 'conformer')")
        self.config = c
        for e in range(c.num_encoders):
            if c.encoder_type == "conformer":
                enc = ConformerEncoder(
                    c.n_mels, c.d_model, c.num_heads, c.d_ff,
                    c.num_encoder_layers, c.conformer_kernel_size,
                    c.subsampling_factor, c.dtype, c.dropout_rate)
            else:
                enc = TransformerEncoder(
                    c.n_mels, c.d_model, c.num_heads, c.d_ff,
                    c.num_encoder_layers, c.subsampling_factor, c.dtype,
                    c.dropout_rate)
            self.add_module(f"encoder{e}", enc)
        for i in range(1 if c.share_ctc else c.num_encoders):
            self.add_module(f"ctc_head{i}",
                            Dense(c.d_model, c.vocab_size, dtype=c.dtype))
        self.decoder = (MulEncTransformerDecoder(
            c.vocab_size, c.num_encoders, c.d_model, c.num_heads,
            c.decoder_d_ff, c.num_decoder_layers, c.dropout_rate, c.dtype)
            if c.ctc_weight < 1.0 else None)

    def encode(self, speech, speech_lengths, generator=None):
        """speech (B, N, E) per-stream waveforms on a shared padded sample
        axis, speech_lengths (B, E) -> ((B, E, T', D), (B, E))."""
        outs, lens = [], []
        for e in range(self.config.num_encoders):
            feats, flens = self.task_frontend(speech[:, :, e],
                                              speech_lengths[:, e], generator)
            enc, elens = getattr(self, f"encoder{e}")(feats, flens,
                                                      generator)
            outs.append(enc)
            lens.append(elens)
        return torch.stack(outs, dim=1), torch.stack(lens, dim=1)

    def _ctc_head(self, e: int):
        return getattr(self, f"ctc_head{0 if self.config.share_ctc else e}")

    def ctc_log_probs_each(self, enc_stack):
        """(B, E, T, D) -> (B, E, T, V) per-stream CTC log-posteriors."""
        return torch.stack([
            torch.log_softmax(self._ctc_head(e)(enc_stack[:, e]).float(), -1)
            for e in range(self.config.num_encoders)], dim=1)

    def ctc_log_probs(self, enc_stack):
        """Decode-time log-linear stream fusion with `weights_ctc_dec`."""
        c = self.config
        w = parse_weights(c.weights_ctc_dec, c.num_encoders)
        lp = self.ctc_log_probs_each(enc_stack)
        fused = sum(w[e] * lp[:, e] for e in range(c.num_encoders))
        return torch.log_softmax(fused, dim=-1)

    def decoder_score_step(self, tokens_step, pos, memory, memory_lengths,
                           cache):
        return self.decoder.score_step(tokens_step, pos, memory,
                                       memory_lengths, cache)

    def decoder_init_cache(self, batch, max_len, memory=None,
                           memory_lengths=None):
        device = (memory.device if memory is not None
                  else next(self.parameters()).device)
        return self.decoder.init_cache(batch, max_len, device=device)

    def forward(self, speech, speech_lengths, text, text_lengths,
                generator: Optional[torch.Generator] = None):
        """(loss, stats {loss_ctc{e}, loss_ctc, loss_att, acc, loss});
        speech_lengths (B, E)."""
        c = self.config
        self.require_generator(generator)
        enc, elens = self.encode(speech, speech_lengths, generator)
        lp = self.ctc_log_probs_each(enc)
        text = text.long()
        text_lengths = text_lengths.long()
        w_train = parse_weights(c.weights_ctc_train, c.num_encoders)
        stats: Dict[str, torch.Tensor] = {}
        loss_ctc = 0.0
        for e in range(c.num_encoders):
            l_e = ctc_loss_from_log_probs(
                lp[:, e], text, elens[:, e], text_lengths, c.blank_id,
                use_kernels=self.use_kernels).mean()
            stats[f"loss_ctc{e + 1}"] = l_e
            loss_ctc = loss_ctc + w_train[e] * l_e
        stats["loss_ctc"] = loss_ctc
        loss_att = 0.0
        if self.decoder is not None:
            ys_in, ys_out, ys_lens = add_sos_eos(text, text_lengths,
                                                 c.sos_id, c.eos_id)
            logits = self.decoder(ys_in, ys_lens, enc, elens, generator)
            valid = make_valid_mask(ys_lens, ys_in.shape[1])
            loss_att = label_smoothing_loss(logits, ys_out, valid,
                                            c.lsm_weight)
            stats["loss_att"] = loss_att
            stats["acc"] = token_accuracy(logits, ys_out, valid)
        loss = c.ctc_weight * loss_ctc + (1.0 - c.ctc_weight) * loss_att
        stats["loss"] = loss
        return loss, stats
