"""Mask-CTC: hybrid CTC / masked-LM non-autoregressive ASR (port of
espnet_tpu/models/maskctc.py).

`MaskCTCModel` is a conformer or transformer encoder built from the
`ASRConfig` widths alone (no InterCTC, remat or scan layout, as in JAX), a
CTC head and `MLMDecoder`, a bidirectional transformer decoder over a
vocabulary with `<mask>` appended (mask_token = vocab_size). Its frontend is
the JAX model's `_frontend`: log-mel for raw input, SpecAug with its default
masks while training, and utterance MVN when `normalize` says so; it reads
no global-MVN statistics, so a model with the inherited default
`normalize="global_mvn"` runs unnormalised, as in JAX.

The loss is ctc_weight * CTC + (1 - ctc_weight) * the label-smoothed MLM
cross-entropy over the masked positions. Training masks as the JAX model
does (mask_uniform): per utterance a rate U{1..len}/len, each valid position
masked with that probability, and the first position where none was; the
draws come from the caller's `torch.Generator`, or from a generator seeded
with 0 without one (JAX uses the fixed key PRNGKey(0) then). `masked`
injects the positions instead (the tests hold the port against JAX's draws
so).

The self-attention of the MLM decoder has a key-padding bias only, so it
takes `MultiHeadAttention`'s flash route; its cross-attention (Tq != Tk) and
FFN are plain, as in the ASR decoder.

`MaskCTCInference` is the JAX class: greedy CTC, low-confidence tokens
masked, then iterative MLM infilling. Its loop stays on the host in numpy
(`np.argsort` and the per-round count over the whole batch), so ties resolve
as in JAX; only the model calls run in torch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from espnet_tpu_torch.device import resolve_device
from espnet_tpu_torch.models.asr import ASRBase, ASRConfig
from espnet_tpu_torch.models.conformer import ConformerEncoder
from espnet_tpu_torch.models.layers import Dense, LayerNorm
from espnet_tpu_torch.models.transformer import (TokenStack,
                                                 TransformerDecoderLayer,
                                                 TransformerEncoder)
from espnet_tpu_torch.ops.ctc import ctc_loss
from espnet_tpu_torch.ops.dropout import Dropout
from espnet_tpu_torch.ops.losses import label_smoothing_loss, token_accuracy
from espnet_tpu_torch.ops.masks import attention_bias, make_valid_mask

ENCODERS = ("conformer", "transformer")


@dataclasses.dataclass(frozen=True)
class MaskCTCConfig(ASRConfig):
    """vocab_size excludes <mask>; mask_token = vocab_size."""

    @property
    def mask_token(self) -> int:
        return self.vocab_size


class MLMDecoder(TokenStack):
    """Non-causal conditional masked-LM decoder: embedding + positions, the
    ASR decoder's layers under a key-padding bias, final LayerNorm and
    output projection (vocab_size includes <mask>)."""

    def __init__(self, vocab_size: int, d_model: int = 256,
                 num_heads: int = 4, d_ff: int = 2048, num_layers: int = 6,
                 dropout_rate: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.dtype = dtype
        self.embed = nn.Embedding(vocab_size, d_model)
        self.dropout = Dropout(dropout_rate)
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerDecoderLayer(
                d_model, num_heads, d_ff, dtype, dropout_rate))
        self.final_norm = LayerNorm(d_model, dtype)
        self.out_proj = Dense(d_model, vocab_size, dtype=dtype)

    def forward(self, tokens, token_lengths, memory, memory_lengths,
                generator=None):
        x = self._embed_sequence(tokens, generator)
        valid = make_valid_mask(token_lengths, tokens.shape[1])
        self_bias = attention_bias(valid[:, None, None, :])  # not causal
        mem_bias = attention_bias(
            make_valid_mask(memory_lengths, memory.shape[1])[:, None, None, :])
        for layer in self.layers():
            x = layer(x, self_bias, memory, mem_bias, generator=generator)
        return self.out_proj(self.final_norm(x))


def draw_mask(generator: torch.Generator, text_lengths, u: int):
    """mask_uniform's positions (B, U) bool: per utterance a count k drawn
    uniformly from 1..len, each valid position masked with probability
    k / len, and the first position where the draw masked none."""
    lens = text_lengths.long().cpu()
    b = lens.shape[0]
    high = lens.clamp(min=1)
    num_mask = (torch.rand(b, generator=generator) * high).long() + 1
    num_mask = torch.minimum(num_mask, high)
    rate = num_mask.float() / high.float()
    valid = make_valid_mask(lens, u)
    masked = (torch.rand(b, u, generator=generator) < rate[:, None]) & valid
    first = torch.zeros(b, u, dtype=torch.bool)
    first[:, 0] = True
    masked = torch.where(masked.any(dim=1, keepdim=True), masked,
                         first & valid)
    return masked.to(text_lengths.device)


class MaskCTCModel(ASRBase):
    """Encoder + CTC head + MLM decoder. `encoder_options` go to the
    conformer (its conv routes), as in `models.asr.build_encoder`."""

    def __init__(self, config: MaskCTCConfig,
                 encoder_options: Optional[Dict] = None):
        super().__init__()
        c = config
        if c.encoder_type not in ENCODERS:
            # the JAX model builds a transformer for any other value
            raise ValueError(f"encoder_type {c.encoder_type!r} not in "
                             f"{ENCODERS}")
        if c.input_type not in ("raw", "feats"):
            raise ValueError(f"input_type {c.input_type!r}: Mask-CTC takes "
                             "raw waveforms or features")
        self.config = c
        opts = dict(encoder_options or {})
        if c.encoder_type == "conformer":
            self.encoder = ConformerEncoder(
                c.n_mels, c.d_model, c.num_heads, c.d_ff,
                c.num_encoder_layers, c.conformer_kernel_size,
                c.subsampling_factor, c.dtype, c.dropout_rate, **opts)
        else:
            self.encoder = TransformerEncoder(
                c.n_mels, c.d_model, c.num_heads, c.d_ff,
                c.num_encoder_layers, c.subsampling_factor, c.dtype,
                c.dropout_rate, **opts)
        self.ctc_head = Dense(c.d_model, c.vocab_size, dtype=c.dtype)
        self.decoder = MLMDecoder(c.vocab_size + 1, c.d_model, c.num_heads,
                                  c.decoder_d_ff, c.num_decoder_layers,
                                  c.dropout_rate, c.dtype)

    def encode(self, speech, speech_lengths, generator=None):
        c = self.config
        feats, flens = self.task_frontend(speech, speech_lengths, generator,
                                          c.win_length, c.input_type != "raw")
        return self.encoder(feats, flens, generator)

    def mlm_logits(self, tokens, token_lengths, enc, enc_lengths,
                   generator=None):
        return self.decoder(tokens, token_lengths, enc, enc_lengths,
                            generator)

    def forward(self, speech, speech_lengths, text, text_lengths,
                generator: Optional[torch.Generator] = None,
                masked: Optional[torch.Tensor] = None):
        """(loss, stats {loss_ctc, loss_mlm, acc_mlm, loss}). `masked`
        (B, U) bool: the positions to mask, in place of the draw."""
        c = self.config
        self.require_generator(generator)
        enc, enc_lengths = self.encode(speech, speech_lengths, generator)
        text = text.long()
        text_lengths = text_lengths.long()
        loss_ctc = ctc_loss(self.ctc_head(enc), text, enc_lengths,
                            text_lengths, c.blank_id,
                            use_kernels=self.use_kernels)
        stats = {"loss_ctc": loss_ctc}
        if masked is None:
            gen = (generator if self.training and generator is not None
                   else torch.Generator().manual_seed(0))
            masked = draw_mask(gen, text_lengths, text.shape[1])
        masked = masked.bool()
        ys_in = torch.where(masked, c.mask_token, text)
        logits = self.decoder(ys_in, text_lengths, enc, enc_lengths,
                              generator)
        loss_mlm = label_smoothing_loss(logits, text, masked, c.lsm_weight)
        stats["loss_mlm"] = loss_mlm
        stats["acc_mlm"] = token_accuracy(logits, text, masked)
        loss = c.ctc_weight * loss_ctc + (1.0 - c.ctc_weight) * loss_mlm
        stats["loss"] = loss
        return loss, stats


class MaskCTCInference:
    """Batched non-autoregressive Mask-CTC inference; runs on the card
    unless device="cpu"."""

    def __init__(self, model: MaskCTCModel, device="cuda",
                 n_iterations: int = 10, threshold_probability: float = 0.99,
                 max_tokens: int = 128):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.k = n_iterations
        self.thresh = threshold_probability
        self.max_tokens = max_tokens

    def _mlm(self, y_in, lens, enc, elens) -> np.ndarray:
        logits = self.model.mlm_logits(
            torch.from_numpy(y_in).to(self.device),
            torch.from_numpy(lens).to(self.device), enc, elens)
        lp = torch.log_softmax(logits.float(), dim=-1)
        lp[..., self.model.config.mask_token] = -float("inf")
        return lp.cpu().numpy()

    @torch.no_grad()
    def __call__(self, speech, speech_lengths) -> List[List[int]]:
        c = self.model.config
        enc, elens = self.model.encode(
            torch.as_tensor(np.asarray(speech, np.float32)).to(self.device),
            torch.as_tensor(np.asarray(speech_lengths, np.int64)).to(
                self.device))
        lp = self.model.ctc_log_probs(enc).cpu().numpy()
        probs = np.exp(lp.max(-1))
        ids = lp.argmax(-1)
        elens_np = elens.cpu().numpy()
        b = ids.shape[0]
        y_list, conf_list = [], []
        for i in range(b):
            seq, confs = [], []
            prev = -1
            for t in range(int(elens_np[i])):
                tok = int(ids[i, t])
                if tok == prev:
                    confs[-1] = max(confs[-1], float(probs[i, t]))
                else:
                    seq.append(tok)
                    confs.append(float(probs[i, t]))
                    prev = tok
            keep = [(s, cf) for s, cf in zip(seq, confs) if s != c.blank_id]
            y_list.append([s for s, _ in keep][: self.max_tokens])
            conf_list.append([cf for _, cf in keep][: self.max_tokens])

        umax = max(1, max(len(y) for y in y_list))
        y_in = np.zeros((b, umax), np.int32)
        lens = np.asarray([len(y) for y in y_list], np.int32)
        mask_pos = np.zeros((b, umax), bool)
        for i, (y, cf) in enumerate(zip(y_list, conf_list)):
            for j, (tok, p) in enumerate(zip(y, cf)):
                if p < self.thresh:
                    y_in[i, j] = c.mask_token
                    mask_pos[i, j] = True
                else:
                    y_in[i, j] = tok

        total_masks = int(mask_pos.sum())
        if total_masks > 0:
            num_iter = min(self.k, max(1, total_masks)) if self.k > 0 else 1
            # one count for the whole batch, as in JAX
            per_round = max(1, total_masks // num_iter)
            for _ in range(num_iter - 1):
                if not mask_pos.any():
                    break
                pred = self._mlm(y_in, lens, enc, elens)
                score = pred.max(-1)
                tok = pred.argmax(-1)
                flat_scores = np.where(mask_pos, score, -np.inf).reshape(-1)
                order = np.argsort(-flat_scores)[:per_round]
                for o in order:
                    if flat_scores[o] == -np.inf:
                        continue
                    i, j = divmod(int(o), umax)
                    y_in[i, j] = int(tok[i, j])
                    mask_pos[i, j] = False
            if mask_pos.any():
                tok = self._mlm(y_in, lens, enc, elens).argmax(-1)
                y_in[mask_pos] = tok[mask_pos]
        return [y_in[i, : int(lens[i])].tolist() for i in range(b)]
