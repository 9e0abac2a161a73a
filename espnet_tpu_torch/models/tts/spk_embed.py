"""Speaker and language conditioning and the x-vector-role extractor (port
of espnet_tpu/models/tts/spk_embed.py).

`SpeakerConditioner` follows the reference integration order
(`espnet2/tts/tacotron2/tacotron2.py:400-408`): a sid embedding added, a
lid embedding added, then the L2-normalised speaker embedding either
projected and added ("add") or tiled along T and concatenated ("concat",
growing the width by spk_embed_dim). `SpeakerEmbeddingExtractor` is the
TDNN + masked mean/std pooling embedder that `bin/spk_embed_extract`
trains on a corpus's utt2spk labels.
"""

from __future__ import annotations

import torch
from torch import nn

from espnet_tpu_torch.models.layers import Conv1d, Dense, LayerNorm
from espnet_tpu_torch.ops.masks import make_valid_mask


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12):
    return x / torch.linalg.norm(x, dim=dim, keepdim=True).clamp(min=eps)


class SpeakerConditioner(nn.Module):
    """Condition (B, T, units) states on sids / lids / spembs."""

    def __init__(self, spks: int = 0, langs: int = 0, spk_embed_dim: int = 0,
                 integration_type: str = "add", units: int = 0,
                 dtype=torch.float32):
        super().__init__()
        if spk_embed_dim > 0 and integration_type not in ("add", "concat"):
            raise ValueError(f"unknown integration {integration_type!r} "
                             "(support only add or concat)")
        self.spks, self.langs = spks, langs
        self.spk_embed_dim = spk_embed_dim
        self.integration_type = integration_type
        self.units = units
        self.dtype = dtype
        if spks > 1:
            self.sid_emb = nn.Embedding(spks, units)
        if langs > 1:
            self.lid_emb = nn.Embedding(langs, units)
        if spk_embed_dim > 0 and integration_type == "add":
            self.projection = Dense(spk_embed_dim, units, dtype=dtype)

    @property
    def out_dim(self) -> int:
        if self.spk_embed_dim > 0 and self.integration_type == "concat":
            return self.units + self.spk_embed_dim
        return self.units

    def forward(self, hs, sids=None, lids=None, spembs=None):
        dt = self.dtype
        if self.spks > 1:
            if sids is None:
                raise ValueError("spks > 1 but sids not provided")
            hs = hs + self.sid_emb(sids.reshape(-1)).to(dt)[:, None]
        if self.langs > 1:
            if lids is None:
                raise ValueError("langs > 1 but lids not provided")
            hs = hs + self.lid_emb(lids.reshape(-1)).to(dt)[:, None]
        if self.spk_embed_dim > 0:
            if spembs is None:
                raise ValueError("spk_embed_dim > 0 but spembs not provided")
            se = l2_normalize(spembs.float()).to(hs.dtype)
            if self.integration_type == "add":
                hs = hs + self.projection(se)[:, None]
            else:
                tiled = se[:, None].expand(hs.shape[0], hs.shape[1],
                                           se.shape[-1])
                hs = torch.cat([hs, tiled.to(hs.dtype)], dim=-1)
        return hs


TDNN = ((5, 1), (3, 2), (3, 3), (1, 1))  # (kernel, dilation) per layer


class SpeakerEmbeddingExtractor(nn.Module):
    """feats (B, T, F) -> dilated TDNN (conv, LayerNorm, relu, masked) ->
    masked mean + std pooling -> embedding (B, embed_dim); `logits=True`
    also returns the speaker classifier's logits."""

    def __init__(self, n_feats: int, n_spk: int = 0, embed_dim: int = 192,
                 channels: int = 256, dtype=torch.float32):
        super().__init__()
        for i, (k, dil) in enumerate(TDNN):
            self.add_module(f"tdnn{i}", Conv1d(
                n_feats if i == 0 else channels, channels, k, dtype=dtype,
                dilation=dil))
            self.add_module(f"norm{i}", LayerNorm(channels, dtype))
        self.embed = Dense(2 * channels, embed_dim, dtype=dtype)
        if n_spk > 0:
            self.classifier = Dense(embed_dim, n_spk, dtype=dtype)

    def forward(self, feats, lengths, logits: bool = False):
        mask = make_valid_mask(lengths, feats.shape[1])[..., None]
        h = feats * mask.to(feats.dtype)
        for i in range(len(TDNN)):
            h = getattr(self, f"tdnn{i}")(h)
            h = torch.relu(getattr(self, f"norm{i}")(h))
            h = h * mask.to(h.dtype)
        m = mask.float()
        denom = m.sum(1).clamp(min=1.0)
        mean = h.sum(1) / denom
        var = ((h - mean[:, None]) ** 2 * m).sum(1) / denom
        std = torch.sqrt(var + 1e-8)
        emb = self.embed(torch.cat([mean, std], dim=-1))
        if not logits:
            return emb
        return emb, self.classifier(torch.relu(emb))
