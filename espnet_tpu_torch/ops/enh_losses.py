"""Enhancement criterions and permutation-invariant training (port of
espnet_tpu/ops/enh_losses.py).

Each criterion returns a per-utterance loss (B,) and honours lengths with
masked moments, as the JAX functions do. `pit_solve` forms the
(B, n_ref, n_est) pairwise matrix and scores every permutation in
`itertools.permutations` order; the first minimum wins (`jnp.argmin`'s
rule, which `torch.argmin` does not promise), and so for `mixit_solve`'s
assignments in `itertools.product` order. `ci_sdr_loss` solves its
(L, L) Toeplitz system in float32 (the caller keeps TF32 off on the card).
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

EPS = 1.0e-8


def _mask(x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    if lengths is None:
        return torch.ones_like(x)
    n = x.shape[-1]
    valid = torch.arange(n, device=x.device)[None, :] < lengths[:, None]
    return valid.to(x.dtype)


def _frame_mask(ref: torch.Tensor, lengths: Optional[torch.Tensor]):
    if lengths is None:
        return ref.new_ones(ref.shape[:2])
    t = ref.shape[1]
    return (torch.arange(t, device=ref.device)[None, :]
            < lengths[:, None]).to(ref.dtype)


def si_snr_loss(ref, est, lengths=None, zero_mean: bool = True,
                clamp_db: Optional[float] = None) -> torch.Tensor:
    """Negative SI-SNR per utterance of (B, n) signals."""
    mask = _mask(ref, lengths)
    cnt = mask.sum(-1, keepdim=True).clamp(min=1.0)
    if zero_mean:
        ref = (ref - (ref * mask).sum(-1, keepdim=True) / cnt) * mask
        est = (est - (est * mask).sum(-1, keepdim=True) / cnt) * mask
    else:
        ref = ref * mask
        est = est * mask
    dot = (ref * est).sum(-1, keepdim=True)
    ref_pow = (ref ** 2).sum(-1, keepdim=True)
    s_target = dot / (ref_pow + EPS) * ref
    e_noise = est - s_target
    ratio = (s_target ** 2).sum(-1) / ((e_noise ** 2).sum(-1) + EPS)
    si_snr = 10.0 * torch.log10(ratio + EPS)
    if clamp_db is not None:
        si_snr = si_snr.clamp(-clamp_db, clamp_db)
    return -si_snr


def snr_loss(ref, est, lengths=None) -> torch.Tensor:
    """Negative plain SNR per utterance."""
    mask = _mask(ref, lengths)
    ref = ref * mask
    est = est * mask
    noise = ref - est
    ratio = (ref ** 2).sum(-1) / ((noise ** 2).sum(-1) + EPS)
    return -10.0 * torch.log10(ratio + EPS)


def time_mse_loss(ref, est, lengths=None) -> torch.Tensor:
    mask = _mask(ref, lengths)
    cnt = mask.sum(-1).clamp(min=1.0)
    return (((ref - est) * mask) ** 2).sum(-1) / cnt


def spectral_l1_loss(ref, est, lengths=None) -> torch.Tensor:
    """Masked L1 over the TF bins of (B, T, F) magnitudes."""
    m = _frame_mask(ref, lengths)
    cnt = (m.sum(-1) * ref.shape[-1]).clamp(min=1.0)
    return ((ref - est).abs() * m[..., None]).sum(dim=(1, 2)) / cnt


def tf_mse_loss(ref, est, lengths=None) -> torch.Tensor:
    """Masked MSE over the TF bins of (B, T, F)."""
    m = _frame_mask(ref, lengths)
    cnt = (m.sum(-1) * ref.shape[-1]).clamp(min=1.0)
    return (((ref - est) ** 2) * m[..., None]).sum(dim=(1, 2)) / cnt


def first_argmin(losses: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum of each row of (B, P), as `np.argmin`
    and `jnp.argmin` choose it (NaN counts as the minimum, as in both)."""
    p = losses.shape[1]
    nan = torch.isnan(losses)
    lowest = torch.where(nan.any(1, keepdim=True),
                         nan, losses == losses.min(1, keepdim=True).values)
    order = torch.arange(p, 0, -1, device=losses.device)
    return (lowest.long() * order).argmax(1)


def pit_solve(loss_fn: Callable, refs: torch.Tensor, ests: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Permutation-invariant loss. loss_fn(ref (B, ...), est (B, ...)) ->
    (B,). Returns (best mean-over-speakers loss (B,), best permutation
    (B, n_spk): est slot j -> ref slot perm[j])."""
    n_spk = refs.shape[1]
    pair = torch.stack([torch.stack([loss_fn(refs[:, r], ests[:, e])
                                     for e in range(n_spk)], 1)
                        for r in range(n_spk)], 1)       # (B, n_ref, n_est)
    perms = list(itertools.permutations(range(n_spk)))
    cols = torch.arange(n_spk, device=pair.device)
    losses = torch.stack(
        [pair[:, torch.as_tensor(p, device=pair.device), cols].mean(1)
         for p in perms], 1)                              # (B, P)
    best = first_argmin(losses.detach())
    best_loss = losses.gather(1, best[:, None])[:, 0]
    perm_arr = torch.as_tensor(perms, device=pair.device)
    return best_loss, perm_arr[best]


def ci_sdr_loss(ref, est, lengths=None, filter_length: int = 512
                ) -> torch.Tensor:
    """Negative CI-SDR per utterance: SDR against the reference through
    the optimal length-L FIR filter, h* = R^-1 p with R the (L, L) Toeplitz
    autocorrelation of ref and p the ref/est cross-correlation (by FFT)."""
    mask = _mask(ref, lengths)
    ref = (ref * mask).float()
    est = (est * mask).float()
    n = ref.shape[-1]
    lf = min(filter_length, n)
    n_fft = int(2 ** np.ceil(np.log2(n + lf)))
    rf = torch.fft.rfft(ref, n_fft)
    ef = torch.fft.rfft(est, n_fft)
    acorr = torch.fft.irfft(rf * rf.conj(), n_fft)[:, :lf]
    xcorr = torch.fft.irfft(ef * rf.conj(), n_fft)[:, :lf]
    ar = torch.arange(lf, device=ref.device)
    idx = (ar[:, None] - ar[None, :]).abs()
    r_mat = acorr[:, idx] + EPS * torch.eye(lf, device=ref.device)[None]
    h = torch.linalg.solve(r_mat, xcorr[..., None])[..., 0]
    filt = torch.fft.irfft(rf * torch.fft.rfft(h, n_fft), n_fft)[:, :n]
    err = est - filt
    ratio = (filt ** 2).sum(-1) / ((err ** 2).sum(-1) + EPS)
    return -10.0 * torch.log10(ratio + EPS)


def mask_label(mix_real, mix_imag, ref_real, ref_imag,
               mask_type: str = "IAM") -> torch.Tensor:
    """Ideal mask targets over the TF bins of (B, T, F): IBM, IRM, IAM, PSM
    (clipped to [0, 1]) or NPSM (clipped at 0 only)."""
    mix_mag = torch.sqrt(mix_real ** 2 + mix_imag ** 2 + EPS)
    ref_mag = torch.sqrt(ref_real ** 2 + ref_imag ** 2 + EPS)
    mask_type = mask_type.upper()
    if mask_type in ("IBM", "IRM"):
        noise_mag = torch.sqrt((mix_real - ref_real) ** 2
                               + (mix_imag - ref_imag) ** 2 + EPS)
        if mask_type == "IBM":
            return (ref_mag >= noise_mag).to(mix_real.dtype)
        return ref_mag / (ref_mag + noise_mag + EPS)
    if mask_type == "IAM":
        return (ref_mag / (mix_mag + EPS)).clamp(0.0, 1.0)
    if mask_type in ("PSM", "NPSM"):
        cos = (ref_real * mix_real + ref_imag * mix_imag) / (
            ref_mag * mix_mag + EPS)
        psm = ref_mag / (mix_mag + EPS) * cos
        return psm.clamp(0.0, 1.0) if mask_type == "PSM" \
            else psm.clamp(min=0.0)
    raise ValueError(f"unsupported mask type {mask_type}")


def dpcl_loss(embedding, ref_masks) -> torch.Tensor:
    """Deep-clustering affinity loss ||V V^T - Y Y^T||_F^2 per utterance,
    expanded so no (TF, TF) Gram matrix is formed. embedding (B, TF, D),
    ref_masks (B, TF, n_spk)."""
    vtv = torch.einsum("bnd,bne->bde", embedding, embedding)
    vty = torch.einsum("bnd,bns->bds", embedding, ref_masks)
    yty = torch.einsum("bns,bnt->bst", ref_masks, ref_masks)
    return ((vtv ** 2).sum((1, 2)) - 2.0 * (vty ** 2).sum((1, 2))
            + (yty ** 2).sum((1, 2)))


def mixit_solve(loss_fn: Callable, refs: torch.Tensor, ests: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixture-invariant training: each of the n_est estimates goes to one
    of the n_ref mixtures; the assigned sums are scored against the
    mixtures and the best assignment kept. Returns (best mean loss (B,),
    best assignment (B, n_est) -> mixture index)."""
    n_ref, n_est = refs.shape[1], ests.shape[1]
    assignments = list(itertools.product(range(n_ref), repeat=n_est))
    losses = []
    for asm in assignments:
        mat = torch.from_numpy(
            np.eye(n_ref, dtype=np.float32)[np.asarray(asm)].T
        ).to(ests.device, ests.dtype)
        mixed = torch.einsum("ri,bin->brn", mat, ests)
        per_ref = torch.stack([loss_fn(refs[:, r], mixed[:, r])
                               for r in range(n_ref)], 1)
        losses.append(per_ref.mean(1))
    losses = torch.stack(losses, 1)
    best = first_argmin(losses.detach())
    best_loss = losses.gather(1, best[:, None])[:, 0]
    return best_loss, torch.as_tensor(assignments, device=ests.device)[best]
