"""Complex multichannel ops: WPE dereverberation, PSD matrices, MVDR
beamforming, GCC-PHAT and delay-and-sum (port of
espnet_tpu/ops/beamformer.py).

Y is (B, F, C, T) complex64, as in the JAX package and the reference
(`espnet2/enh/layers/{wpe,beamformer}.py`). Every per-frequency C x C (or
CK x CK) system is solved in one batched `torch.linalg.solve` with
diagonal loading; no loop over frequencies.
"""

from __future__ import annotations

import torch


def _trace(mat: torch.Tensor) -> torch.Tensor:
    return mat.diagonal(dim1=-2, dim2=-1).sum(-1)


def _loaded(mat: torch.Tensor, eps: float) -> torch.Tensor:
    """mat + (eps * Re tr(mat) / n + 1e-10) I."""
    n = mat.shape[-1]
    tr = _trace(mat).real[..., None, None]
    eye = torch.eye(n, dtype=mat.dtype, device=mat.device)
    return mat + (eps * tr / n + 1e-10) * eye


def signal_framing(y: torch.Tensor, taps: int, delay: int) -> torch.Tensor:
    """(B, F, C, T) -> (B, F, C * taps, T), tap k holding
    Y[..., t - delay - k]."""
    t = y.shape[-1]
    outs = [torch.nn.functional.pad(y, (delay + k, 0))[..., :t]
            for k in range(taps)]
    return torch.cat(outs, dim=-2)


def wpe_one_iteration(y: torch.Tensor, power: torch.Tensor, taps: int = 5,
                      delay: int = 3, eps: float = 1e-6) -> torch.Tensor:
    """One WPE step given the power estimate: y (B, F, C, T) complex, power
    (B, F, T) real -> dereverberated (B, F, C, T)."""
    inv_p = 1.0 / power.clamp(min=eps)
    ytilde = signal_framing(y, taps, delay)  # (B, F, CK, T)
    yw = ytilde * inv_p[..., None, :].to(ytilde.dtype)
    r_mat = torch.einsum("...it,...jt->...ij", yw, ytilde.conj())
    p_mat = torch.einsum("...it,...jt->...ij", yw, y.conj())
    g = torch.linalg.solve(_loaded(r_mat, eps), p_mat)  # (B, F, CK, C)
    tail = torch.einsum("...ki,...kt->...it", g.conj(), ytilde)
    return y - tail


def wpe(y: torch.Tensor, taps: int = 5, delay: int = 3, iterations: int = 3,
        eps: float = 1e-6) -> torch.Tensor:
    """Blind iterative WPE: the power from the current estimate, then the
    filter solve, `iterations` times."""
    x = y
    for _ in range(iterations):
        power = (x.abs() ** 2).mean(dim=-2)
        x = wpe_one_iteration(y, power, taps, delay, eps)
    return x


def psd_matrix(y: torch.Tensor, mask: torch.Tensor, normalize: bool = True,
               eps: float = 1e-6) -> torch.Tensor:
    """Mask-weighted cross-channel PSD: y (B, F, C, T), mask (B, F, T) ->
    (B, F, C, C)."""
    m = mask[..., None, :].to(y.dtype)
    psd = torch.einsum("...it,...jt->...ij", y * m, y.conj())
    if normalize:
        denom = mask.sum(dim=-1)[..., None, None]
        psd = psd / denom.clamp(min=eps).to(psd.dtype)
    return psd


def mvdr_weights(psd_speech: torch.Tensor, psd_noise: torch.Tensor,
                 reference_vector: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Souden MVDR: w = (Phi_n^-1 Phi_s / tr(Phi_n^-1 Phi_s)) u; psd_*
    (B, F, C, C), reference_vector (B, C) -> w (B, F, C)."""
    numerator = torch.linalg.solve(_loaded(psd_noise, eps), psd_speech)
    ws = numerator / (_trace(numerator)[..., None, None] + 1e-10)
    u = reference_vector[:, None, :, None].to(ws.dtype)
    return (ws @ u)[..., 0]


def apply_beamformer(w: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """w (B, F, C), y (B, F, C, T) -> w^H y (B, F, T)."""
    return torch.einsum("...c,...ct->...t", w.conj(), y)


def gcc_phat_tdoa(ref: torch.Tensor, sig: torch.Tensor,
                  max_delay: int = 800) -> torch.Tensor:
    """GCC-PHAT delay of `sig` against `ref` in samples (positive: `sig`
    lags): the phase-only cross spectrum's inverse, argmax within
    +-max_delay."""
    n = ref.shape[-1]
    nfft = 1
    while nfft < 2 * n:
        nfft *= 2
    cross = torch.fft.rfft(ref, nfft) * torch.fft.rfft(sig, nfft).conj()
    cross = cross / cross.abs().clamp(min=1e-12)
    cc = torch.fft.irfft(cross, nfft)
    cc = torch.cat([cc[..., -max_delay:], cc[..., :max_delay + 1]], dim=-1)
    return max_delay - cc.argmax(dim=-1)


def delay_and_sum(y: torch.Tensor, ref_channel: int = 0,
                  max_delay: int = 800, weighted: bool = True) -> torch.Tensor:
    """Delay-and-sum over (C, N) signals: each channel's GCC-PHAT delay
    against the reference undone by a roll, then summed with weights from
    the aligned channels' non-negative normalised correlation with the
    reference (`weighted`) or averaged. Returns (N,)."""
    c = y.shape[0]
    ref = y[ref_channel]
    tdoas = [int(gcc_phat_tdoa(ref, y[i], max_delay)) for i in range(c)]
    aligned = torch.stack([torch.roll(y[i], -tdoas[i]) for i in range(c)])
    if not weighted:
        return aligned.mean(dim=0)
    rn = ref / torch.linalg.norm(ref).clamp(min=1e-12)
    an = aligned / torch.linalg.norm(aligned, dim=-1,
                                     keepdim=True).clamp(min=1e-12)
    xcorr = (an @ rn).clamp(min=0.0)
    w = xcorr / xcorr.sum().clamp(min=1e-12)
    return (aligned * w[:, None]).sum(dim=0)
