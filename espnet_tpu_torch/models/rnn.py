"""v1 RNN stack: VGG-BLSTM encoder and attention LSTM decoder (port of
espnet_tpu/models/rnn.py).

`VGG2L` is two 3x3-conv/max-pool blocks (64 and 128 channels) whose output
is flattened freq-major, (B, T, F, C) -> F·C as flax lays it out, then
projected; the lengths are `lengths // 4` whatever the pooled length.
`VGGRNNEncoder` stacks LSTMs (both directions for vgg_blstm, each over the
whole padded length as the JAX `nn.RNN` calls without `seq_lengths` do)
with a tanh projection and flax-rule dropout after each. Its cells have no
`dtype` in JAX, so they run in float32 even in a bfloat16 model; the
projections use the model dtype. The JAX tree names them
`OptimizedLSTMCell_{k}` in creation order (forward then backward per
layer), and so does the port. A unidirectional encoder (vgg_lstm) takes
and returns a carry, one (c, h) per layer: the chunk-streaming path of
`decode/streaming_v1.py`.

`RNNDecoder` is the v1 decoder: an embedding, an attention of the zoo
(`models/rnn_attentions.py`) over the encoder output with the first
cell's hidden state as query, LSTM cells in the model dtype fed
[embedding, context], flax-rule dropout and an output projection over
[top hidden, context]. Teacher forcing runs the cells step by step; with
`sampling_probability` > 0 in training, one coin a step for the whole
batch (drawn from the caller's generator, or given as `coins`) replaces
the ground-truth input by the previous step's argmax from the second step
on. `score_memory_cache` and `score_step` are the beam search's interface,
the cache {"h", "c": (N, L, H), "att": the attention's state}.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from espnet_tpu_torch.models.layers import Dense, LSTMCell, lstm_sequence
from espnet_tpu_torch.models.rnn_attentions import make_attention
from espnet_tpu_torch.ops.dropout import Dropout
from espnet_tpu_torch.ops.masks import make_valid_mask

VGG_CHANNELS = (64, 128)


class Conv2d(nn.Conv2d):
    """nn.Conv2d over NCHW computed in `dtype` (flax `nn.Conv(dtype=...)`),
    "SAME" padding for odd kernels."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 3,
                 dtype=torch.float32):
        super().__init__(c_in, c_out, kernel, padding=kernel // 2)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return nn.functional.conv2d(x.to(dt), self.weight.to(dt),
                                    self.bias.to(dt), padding=self.padding)


class VGG2L(nn.Module):
    """Two conv/pool blocks, freq collapsed (`encoders.py:24`)."""

    def __init__(self, n_feats: int, out_dim: int, dtype=torch.float32):
        super().__init__()
        c_in = 1
        for i, ch in enumerate(VGG_CHANNELS):
            self.add_module(f"conv{i}_1", Conv2d(c_in, ch, dtype=dtype))
            self.add_module(f"conv{i}_2", Conv2d(ch, ch, dtype=dtype))
            c_in = ch
        self.out = Dense((n_feats // 2 // 2) * c_in, out_dim, dtype=dtype)

    def forward(self, feats, lengths):
        x = feats[:, None]  # (B, 1, T, F)
        for i in range(len(VGG_CHANNELS)):
            x = torch.relu(getattr(self, f"conv{i}_1")(x))
            x = torch.relu(getattr(self, f"conv{i}_2")(x))
            x = nn.functional.max_pool2d(x, 2, 2)
        b, c, t, f = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, t, f * c)
        return self.out(x), torch.div(lengths, 4, rounding_mode="floor")


class VGGRNNEncoder(nn.Module):
    """VGG2L + stacked (B)LSTM with projection (VGG2L+RNNP). Returns (out,
    lengths), or (out, lengths, new carry) with `return_carry`."""

    def __init__(self, n_feats: int, d_model: int = 256, hidden: int = 256,
                 num_layers: int = 3, bidirectional: bool = True,
                 dropout_rate: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.hidden = hidden
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        self.vgg = VGG2L(n_feats, d_model, dtype)
        dirs = 2 if bidirectional else 1
        for i in range(num_layers):
            for k in range(dirs):
                # the JAX cells have no dtype: float32
                self.add_module(f"OptimizedLSTMCell_{dirs * i + k}",
                                LSTMCell(d_model, hidden))
            self.add_module(f"proj{i}", Dense(dirs * hidden, d_model,
                                              dtype=dtype))
        self.dropout = Dropout(dropout_rate)

    def cells(self, layer: int) -> List[LSTMCell]:
        dirs = 2 if self.bidirectional else 1
        return [getattr(self, f"OptimizedLSTMCell_{dirs * layer + k}")
                for k in range(dirs)]

    def forward(self, feats, lengths, generator=None,
                carry: Optional[Sequence] = None, return_carry: bool = False):
        if (carry is not None or return_carry) and self.bidirectional:
            raise ValueError("chunk-carry streaming needs a unidirectional "
                             "encoder (vgg_lstm)")
        x, olens = self.vgg(feats, lengths)
        new_carry = []
        for i in range(self.num_layers):
            cells = self.cells(i)
            fwd, c_i = lstm_sequence(cells[0], x, carry=(
                None if carry is None else carry[i]))
            new_carry.append(c_i)
            if self.bidirectional:
                bwd, _ = lstm_sequence(cells[1], x, reverse=True)
                fwd = torch.cat([fwd, bwd], dim=-1)
            x = torch.tanh(getattr(self, f"proj{i}")(fwd))
            x = self.dropout(x, generator)
        mask = make_valid_mask(olens, x.shape[1])[:, :, None]
        out = x * mask.to(x.dtype)
        if return_carry:
            return out, olens, new_carry
        return out, olens

    def init_carry(self, batch: int, device=None):
        """Zero LSTM carries, one (c, h) pair per layer."""
        z = torch.zeros(batch, self.hidden, device=device)
        return [(z, z) for _ in range(self.num_layers)]


class RNNDecoder(nn.Module):
    """LSTM attention decoder (`decoders.py:44`) over the v1 attention zoo
    (`att_type`) with scheduled sampling (`sampling_probability`)."""

    def __init__(self, vocab_size: int, encoder_dim: int = 256,
                 embed_dim: int = 256, hidden: int = 256, num_layers: int = 1,
                 att_type: str = "location", att_dim: int = 320,
                 att_conv_channels: int = 10, att_conv_kernel: int = 100,
                 att_heads: int = 4, att_win: int = 5,
                 sampling_probability: float = 0.0,
                 dropout_rate: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.num_layers = num_layers
        self.sampling_probability = sampling_probability
        self.dtype = dtype
        self.embed = nn.Embedding(vocab_size, embed_dim)
        for i in range(num_layers):
            self.add_module(f"lstm{i}", LSTMCell(
                embed_dim + encoder_dim if i == 0 else hidden, hidden, dtype))
        self.att = make_attention(
            att_type, encoder_dim, hidden, att_dim=att_dim,
            conv_channels=att_conv_channels, conv_kernel=att_conv_kernel,
            heads=att_heads, att_win=att_win, out_dim=encoder_dim,
            dtype=dtype)
        self.output = Dense(hidden + encoder_dim, vocab_size, dtype=dtype)
        self.dropout = Dropout(dropout_rate)

    def cells(self) -> List[LSTMCell]:
        return [getattr(self, f"lstm{i}") for i in range(self.num_layers)]

    def _step(self, token, state, enc, enc_mask, generator=None):
        """One decode step; state = {"h": [..], "c": [..], "att": dict}."""
        ey = nn.functional.embedding(token.long(),
                                     self.embed.weight.to(self.dtype))
        context, _, att_state = self.att(enc, enc_mask, state["h"][0],
                                         state["att"])
        x = torch.cat([ey, context.to(ey.dtype)], dim=-1)
        hs, cs = [], []
        for li, cell in enumerate(self.cells()):
            c_new, h_new = cell.step((state["c"][li], state["h"][li]),
                                     cell.input_proj(x))
            hs.append(h_new)
            cs.append(c_new)
            x = h_new
        x = self.dropout(x, generator)
        logits = self.output(torch.cat([x.to(self.dtype),
                                        context.to(self.dtype)], dim=-1))
        return logits, {"h": hs, "c": cs, "att": att_state}

    def init_state(self, batch: int, t_max: int, enc_mask):
        z = torch.zeros(batch, self.hidden, device=enc_mask.device)
        return {"h": [z] * self.num_layers, "c": [z] * self.num_layers,
                "att": self.att.init_state(batch, t_max, enc_mask)}

    def forward(self, tokens, token_lengths, memory, memory_lengths,
                generator=None, coins: Optional[Sequence[bool]] = None):
        """Teacher-forced: tokens (B, U) -> logits (B, U, V). `coins` (one
        bool a step) replaces the scheduled-sampling draws."""
        b, u = tokens.shape
        enc_mask = make_valid_mask(memory_lengths, memory.shape[1])
        state = self.init_state(b, memory.shape[1], enc_mask)
        sample = (self.sampling_probability > 0.0 and self.training
                  and (generator is not None or coins is not None))
        if sample and coins is None:
            coins = (torch.rand(u, generator=generator,
                                device=generator.device)
                     < self.sampling_probability).tolist()
        logits, prev = [], None
        for i in range(u):
            tok = tokens[:, i]
            if sample and coins[i] and i > 0:
                tok = prev.argmax(dim=-1).to(tok.dtype)
            prev, state = self._step(tok, state, memory, enc_mask, generator)
            logits.append(prev)
        return torch.stack(logits, dim=1)

    # --- the beam search's interface -------------------------------------
    def score_memory_cache(self, batch: int, memory, memory_lengths):
        enc_mask = make_valid_mask(memory_lengths, memory.shape[1])
        state = self.init_state(batch, memory.shape[1], enc_mask)
        return {"h": torch.stack(state["h"], 1),
                "c": torch.stack(state["c"], 1), "att": state["att"]}

    def score_step(self, tokens_step, pos, memory, memory_lengths, cache):
        enc_mask = make_valid_mask(memory_lengths, memory.shape[1])
        state = {"h": [cache["h"][:, i] for i in range(self.num_layers)],
                 "c": [cache["c"][:, i] for i in range(self.num_layers)],
                 "att": cache["att"]}
        logits, new = self._step(tokens_step, state, memory, enc_mask)
        new_cache = {"h": torch.stack(new["h"], 1),
                     "c": torch.stack(new["c"], 1), "att": new["att"]}
        return torch.log_softmax(logits.float(), dim=-1), new_cache
