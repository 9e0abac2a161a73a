"""Multi-speaker (mixture) ASR with permutation-invariant training (port of
espnet_tpu/models/asr_mix.py).

`MixEncoder` is a Conv2d subsampling, `num_shared_layers` conformer blocks,
then `num_spk` branches of `num_branch_layers` blocks each, all on one
relative position encoding; its output stacks to (B, S, T', D). The loss
computes the S x S matrix of CTC losses (branch i against speaker j's
transcript, `ctc_loss_from_log_probs` on the CTC lattice kernels: S^2 pairs
a step), takes the permutation of least mean loss (the first of equal ones,
as `jnp.argmin`), and trains the shared transformer decoder on each branch
with the transcript that permutation gives it. `text` is (B, S, U), or the
collate's (B, U, S), which is recognised as JAX recognises it (the second
axis not S, the third S) and transposed.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional

import torch
from torch import nn

from espnet_tpu_torch.models.asr import ASRBase, add_sos_eos
from espnet_tpu_torch.models.conformer import ConformerBlock
from espnet_tpu_torch.models.embedding import rel_position_encoding
from espnet_tpu_torch.models.layers import Dense
from espnet_tpu_torch.models.subsampling import Conv2dSubsampling
from espnet_tpu_torch.models.transformer import TransformerDecoder
from espnet_tpu_torch.ops.ctc import ctc_loss_from_log_probs
from espnet_tpu_torch.ops.losses import label_smoothing_loss, token_accuracy
from espnet_tpu_torch.ops.masks import attention_bias, make_valid_mask


@dataclasses.dataclass(frozen=True)
class ASRMixConfig:
    """The JAX `ASRMixConfig`, field for field, with its defaults."""

    vocab_size: int
    num_spk: int = 2
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
    num_shared_layers: int = 4    # encoder_sd in the reference
    num_branch_layers: int = 4    # per-speaker recognition layers
    subsampling_factor: int = 4
    conformer_kernel_size: int = 15
    num_decoder_layers: int = 4
    decoder_d_ff: int = 1024
    ctc_weight: float = 0.5
    lsm_weight: float = 0.1
    dropout_rate: float = 0.1
    dtype: torch.dtype = torch.float32

    @property
    def sos_id(self) -> int:
        return self.vocab_size - 1

    @property
    def eos_id(self) -> int:
        return self.vocab_size - 1


class MixEncoder(nn.Module):
    """Shared conformer front + per-speaker branches (`embed`, `shared{i}`,
    `spk{s}_layer{i}`)."""

    def __init__(self, config: ASRMixConfig):
        super().__init__()
        c = config
        self.config = c
        self.embed = Conv2dSubsampling(c.d_model, c.n_mels,
                                       c.subsampling_factor, dtype=c.dtype)

        def block():
            return ConformerBlock(c.d_model, c.num_heads, c.d_ff,
                                  c.conformer_kernel_size, c.dtype,
                                  c.dropout_rate)

        for i in range(c.num_shared_layers):
            self.add_module(f"shared{i}", block())
        for s in range(c.num_spk):
            for i in range(c.num_branch_layers):
                self.add_module(f"spk{s}_layer{i}", block())

    def forward(self, feats, lengths, generator=None):
        c = self.config
        x, olens = self.embed(feats, lengths)
        x = x * c.d_model ** 0.5
        t = x.shape[1]
        pos_emb = rel_position_encoding(t, c.d_model, c.dtype, x.device)
        pad_mask = make_valid_mask(olens, t)
        bias = attention_bias(pad_mask[:, None, None, :])
        for i in range(c.num_shared_layers):
            x = getattr(self, f"shared{i}")(x, pos_emb, bias, pad_mask,
                                            generator)
        branches = []
        for s in range(c.num_spk):
            h = x
            for i in range(c.num_branch_layers):
                h = getattr(self, f"spk{s}_layer{i}")(h, pos_emb, bias,
                                                      pad_mask, generator)
            branches.append(h)
        return torch.stack(branches, dim=1), olens  # (B, S, T', D)


class ASRMixModel(ASRBase):
    """Mixture ASR: `encoder`, `ctc_head` and, when ctc_weight < 1, the
    transformer `decoder` shared by the branches."""

    def __init__(self, config: ASRMixConfig):
        super().__init__()
        c = config
        self.config = c
        self.encoder = MixEncoder(c)
        self.ctc_head = Dense(c.d_model, c.vocab_size, dtype=c.dtype)
        self.decoder = (TransformerDecoder(
            c.vocab_size, c.d_model, c.num_heads, c.decoder_d_ff,
            c.num_decoder_layers, c.dtype, c.dropout_rate)
            if c.ctc_weight < 1.0 else None)

    def encode(self, speech, speech_lengths, generator=None):
        """(B, N) mixtures -> ((B, S, T', D), lengths (B,))."""
        feats, flens = self.task_frontend(speech, speech_lengths, generator)
        return self.encoder(feats, flens, generator)

    def forward(self, speech, speech_lengths, text, text_lengths,
                generator: Optional[torch.Generator] = None):
        """(loss, stats {loss_ctc, loss_att, acc, loss}); text (B, S, U)
        or (B, U, S), text_lengths (B, S)."""
        c = self.config
        self.require_generator(generator)
        if (text.ndim == 3 and text.shape[1] != c.num_spk
                and text.shape[2] == c.num_spk):
            text = text.transpose(1, 2)
        text = text.long()
        text_lengths = text_lengths.long()
        enc, elens = self.encode(speech, speech_lengths, generator)
        b, s_spk, t, _ = enc.shape
        log_probs = self.ctc_log_probs(
            enc.reshape(b * s_spk, t, -1)).reshape(b, s_spk, t, -1)
        # the (branch, target) CTC loss matrix (B, S, S)
        pair = torch.stack([torch.stack([
            ctc_loss_from_log_probs(log_probs[:, i], text[:, j], elens,
                                    text_lengths[:, j], 0,
                                    use_kernels=self.use_kernels)
            for j in range(s_spk)], dim=1) for i in range(s_spk)], dim=1)
        perms = list(itertools.permutations(range(s_spk)))
        perm_losses = torch.stack(
            [sum(pair[:, i, p[i]] for i in range(s_spk)) / s_spk
             for p in perms], dim=1)  # (B, P)
        best = torch.argmin(perm_losses.detach(), dim=1)  # the first minimum
        loss_ctc = perm_losses.gather(1, best[:, None])[:, 0].mean()
        # perm_mat[b, i]: the speaker whose transcript branch i decodes
        perm_mat = torch.tensor(perms, device=text.device)[best]
        stats: Dict[str, torch.Tensor] = {"loss_ctc": loss_ctc}
        loss_att = 0.0
        if self.decoder is not None:
            text_p = text.gather(1, perm_mat[:, :, None].expand(
                -1, -1, text.shape[2]))
            tlen_p = text_lengths.gather(1, perm_mat)
            att_losses, accs = [], []
            for i in range(s_spk):
                ys_in, ys_out, ys_lens = add_sos_eos(
                    text_p[:, i], tlen_p[:, i], c.sos_id, c.eos_id)
                logits = self.decoder(ys_in, ys_lens, enc[:, i], elens,
                                      generator)
                valid = make_valid_mask(ys_lens, ys_in.shape[1])
                att_losses.append(label_smoothing_loss(
                    logits, ys_out, valid, c.lsm_weight))
                accs.append(token_accuracy(logits, ys_out, valid))
            loss_att = sum(att_losses) / s_spk
            stats["loss_att"] = loss_att
            stats["acc"] = sum(accs) / s_spk
        loss = c.ctc_weight * loss_ctc + (1.0 - c.ctc_weight) * loss_att
        stats["loss"] = loss
        return loss, stats
