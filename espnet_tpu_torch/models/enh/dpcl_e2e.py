"""DPCL-E2E separator: deep clustering, soft k-means and an enhancement
BLSTM (port of espnet_tpu/models/enh/dpcl_e2e.py).

The soft k-means runs JAX's fixed `kmeans_iters` steps (its `lax.scan`)
as a loop with the same 1e-8 denominators and the squared Euclidean
distance; the last step's responsibilities are the cluster masks.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from espnet_tpu_torch.models.enh.layers import add_cells, bilstm
from espnet_tpu_torch.models.layers import Dense

F32 = torch.float32
ACTS = {"sigmoid": torch.sigmoid, "relu": torch.relu, "tanh": torch.tanh}


class DPCLE2ESeparator(nn.Module):
    """(B, T, N) features (N = 2F real || imag pairs with `complex_pairs`)
    -> (masked (B, n_spk, T, N), lengths, {mask_spk<i>})."""

    def __init__(self, input_dim: int, num_spk: int = 2,
                 predict_noise: bool = False, nonlinear: str = "tanh",
                 layers: int = 2, unit: int = 512, emb_dim: int = 40,
                 alpha: float = 5.0, kmeans_iters: int = 10,
                 complex_pairs: bool = False, dtype=F32):
        super().__init__()
        self.num_spk, self.predict_noise = num_spk, predict_noise
        self.nonlinear, self.layers, self.emb_dim = nonlinear, layers, emb_dim
        self.alpha, self.kmeans_iters = alpha, kmeans_iters
        self.complex_pairs = complex_pairs
        f = self.f = input_dim // 2 if complex_pairs else input_dim
        k = num_spk + 1 if predict_noise else num_spk
        specs = []
        for li in range(layers):
            specs += [(f if li == 0 else unit, unit, dtype)] * 2
        specs += [(k * f + f, unit, dtype)] * 2
        add_cells(self, specs)
        for li in range(layers):
            self.add_module(f"blstm{li}_proj", Dense(2 * unit, unit,
                                                     dtype=dtype))
        self.emb = Dense(unit, f * emb_dim, dtype=dtype)
        self.enh_blstm0_proj = Dense(2 * unit, unit, dtype=dtype)
        self.enh_out = Dense(unit, f * k, dtype=dtype)

    def _blstm(self, x, first_cell, n_layers, name):
        for li in range(n_layers):
            h = bilstm(self, first_cell + 2 * li, x)
            x = torch.tanh(getattr(self, f"{name}{li}_proj")(h))
        return x

    def forward(self, feat, lengths, generator=None):
        b, t, n = feat.shape
        f = self.f
        if self.complex_pairs:
            re, im = feat[..., :f], feat[..., f:]
            feature = torch.sqrt(re ** 2 + im ** 2 + 1e-8)
        else:
            feature = feat
        k = self.num_spk + 1 if self.predict_noise else self.num_spk
        x = self._blstm(feature, 0, self.layers, "blstm")
        v = ACTS[self.nonlinear](self.emb(x)).reshape(b, t * f, self.emb_dim)
        centers = v[:, :k, :]
        gamma = None
        for _ in range(self.kmeans_iters):
            d = ((v[:, :, None, :] - centers[:, None, :, :]) ** 2).sum(-1)
            gamma = torch.softmax(-self.alpha * d, dim=-1)
            w = gamma.sum(1)[:, :, None]
            centers = torch.einsum("bnk,bnd->bkd", gamma, v) / (w + 1e-8)
        masks = gamma.reshape(b, t, f, k)
        masked_feats = feature[..., None] * masks
        cat = torch.cat([masked_feats.transpose(2, 3).reshape(b, t, k * f),
                         feature], -1)
        h = self._blstm(cat, 2 * self.layers, 1, "enh_blstm")
        enh_masks = torch.softmax(self.enh_out(h).reshape(b, t, f, k), -1)

        def apply_mask(m):
            if self.complex_pairs:
                return torch.cat([re * m, im * m], -1)
            return feature * m

        outs = [apply_mask(enh_masks[..., i]) for i in range(k)]
        others: Dict[str, torch.Tensor] = {
            f"mask_spk{i + 1}": enh_masks[..., i]
            for i in range(self.num_spk)}
        if self.predict_noise:
            others["noise1"] = outs[-1]
            outs = outs[:self.num_spk]
        return torch.stack(outs, 1), lengths, others
