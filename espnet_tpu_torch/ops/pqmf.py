"""Pseudo-QMF filterbank for multi-band vocoders (port of
espnet_tpu/ops/pqmf.py).

Behavioral spec: reference `espnet2/gan_tts/melgan/pqmf.py`: a
Kaiser-windowed prototype lowpass, cosine-modulated analysis and synthesis
banks, analysis as a conv then decimation, synthesis as zero-stuffing then
a conv. Used by multi-band MelGAN and the StyleMelGAN discriminator.

The filter design is the JAX package's numpy, copied: with cutoff_ratio <=
0 the cutoff is the grid point (81 points over 0.6-1.6 times the band
centre) of least impulse reconstruction error, searched once per (subbands,
taps, beta) and cached. Analysis and synthesis are plain strided convs
(`torch.nn.functional.conv1d`), as the JAX package runs them as XLA convs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch.nn import functional as F


def design_prototype_filter(taps: int = 62, cutoff_ratio: float = 0.142,
                            beta: float = 9.0) -> np.ndarray:
    """Kaiser-windowed ideal lowpass (`pqmf.py:design_prototype_filter`)."""
    assert taps % 2 == 0
    omega_c = np.pi * cutoff_ratio
    n = np.arange(taps + 1) - 0.5 * taps
    with np.errstate(invalid="ignore", divide="ignore"):
        h_i = np.sin(omega_c * n) / (np.pi * n)
    h_i[taps // 2] = omega_c / np.pi
    return h_i * np.kaiser(taps + 1, beta)


def pqmf_banks(subbands: int = 4, taps: int = 62, cutoff_ratio: float = 0.0,
               beta: float = 9.0) -> Tuple[np.ndarray, np.ndarray]:
    """Cosine-modulated (analysis, synthesis) banks, each (subbands,
    taps+1) float32; cutoff_ratio <= 0 searches the optimum."""
    if cutoff_ratio <= 0.0:
        cutoff_ratio = _optimal_cutoff(subbands, taps, beta)
    h = design_prototype_filter(taps, cutoff_ratio, beta)
    m = subbands
    ana = np.zeros((m, taps + 1))
    syn = np.zeros((m, taps + 1))
    n = np.arange(taps + 1)
    for k in range(m):
        arg = (2 * k + 1) * (np.pi / (2 * m)) * (n - taps / 2)
        phi = (-1) ** k * np.pi / 4
        ana[k] = 2 * h * np.cos(arg + phi)
        syn[k] = 2 * h * np.cos(arg - phi)
    return ana.astype(np.float32), syn.astype(np.float32)


def _np_reconstruction_error(subbands: int, taps: int, beta: float,
                             cutoff: float) -> float:
    """Impulse-response reconstruction error of analysis -> decimation ->
    zero-stuffing -> synthesis (numpy, for the cutoff search only)."""
    h = design_prototype_filter(taps, cutoff, beta)
    m = subbands
    n = np.arange(taps + 1)
    impulse = np.zeros(8 * (taps + 1))
    impulse[len(impulse) // 2] = 1.0
    out = np.zeros(len(impulse))
    for k in range(m):
        arg = (2 * k + 1) * (np.pi / (2 * m)) * (n - taps / 2)
        phi = (-1) ** k * np.pi / 4
        ana = 2 * h * np.cos(arg + phi)
        syn = 2 * h * np.cos(arg - phi)
        band = np.convolve(impulse, ana)[taps // 2:][: len(impulse)]
        dec = np.zeros_like(band)
        dec[::m] = band[::m] * m
        out += np.convolve(dec, syn)[taps // 2:][: len(impulse)]
    ideal = np.zeros_like(out)
    ideal[len(impulse) // 2] = 1.0
    return float(np.sum((out - ideal) ** 2))


_CUTOFF_CACHE = {}


def _optimal_cutoff(subbands: int, taps: int, beta: float) -> float:
    key = (subbands, taps, beta)
    if key not in _CUTOFF_CACHE:
        centre = 0.5 / subbands
        grid = np.linspace(0.6 * centre, 1.6 * centre, 81)
        errs = [_np_reconstruction_error(subbands, taps, beta, c)
                for c in grid]
        _CUTOFF_CACHE[key] = float(grid[int(np.argmin(errs))])
    return _CUTOFF_CACHE[key]


def pqmf_analysis(x: torch.Tensor, subbands: int = 4, taps: int = 62,
                  cutoff_ratio: float = 0.0, beta: float = 9.0
                  ) -> torch.Tensor:
    """(B, T) or (B, T, 1) -> (B, ceil(T / subbands), subbands): the
    analysis bank as a conv of stride `subbands`, padded taps/2 each side."""
    if x.ndim == 3:
        x = x[..., 0]
    ana, _ = pqmf_banks(subbands, taps, cutoff_ratio, beta)
    w = torch.from_numpy(ana[:, None, :]).to(x.device, x.dtype)
    y = F.conv1d(x[:, None, :], w, stride=subbands, padding=taps // 2)
    return y.transpose(1, 2)


def pqmf_synthesis(y: torch.Tensor, subbands: int = 4, taps: int = 62,
                   cutoff_ratio: float = 0.0, beta: float = 9.0
                   ) -> torch.Tensor:
    """(B, T', subbands) -> (B, T' * subbands): each band zero-stuffed by
    `subbands` (gain `subbands`), filtered by the synthesis bank, summed."""
    b, t, m = y.shape
    assert m == subbands
    up = y.new_zeros(b, m, t * m)
    up[:, :, ::m] = y.transpose(1, 2) * m
    _, syn = pqmf_banks(subbands, taps, cutoff_ratio, beta)
    w = torch.from_numpy(syn[None]).to(y.device, y.dtype)
    return F.conv1d(up, w, padding=taps // 2)[:, 0]
