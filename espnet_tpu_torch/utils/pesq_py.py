# Copy of espnet_tpu/utils/pesq_py.py: the port imports nothing of espnet_tpu.
"""Pure-python PESQ (ITU-T P.862 narrowband), structure-faithful.

Fills the reference's optional PESQ dependency (`tools/Makefile:172-174`
builds the licensed ITU C implementation; not bundleable). This module
re-implements the P.862 *pipeline* from the published standard: level
alignment to a fixed active-speech power, receive-side bandpass (IRS-like),
envelope cross-correlation time alignment, 32 ms Hann frames -> Bark-band
power spectra (Zwicker warping), partial frequency/gain compensation,
Zwicker-law loudness, symmetric + asymmetric disturbance with the standard
deadzone and asymmetry clipping, Lp time aggregation over ~320 ms splits,
the raw-MOS combination  4.5 - 0.1*D - 0.0309*DA,  and the P.862.1
MOS-LQO mapping.

HONEST SCOPE: the ITU's exact per-band tables (pow_dens_correction,
absolute threshold per band) and the per-frame re-alignment search are
replaced by their published closed-form counterparts (Zwicker/Terhardt
formulas, global + per-half alignment). Scores therefore correlate with,
but are not bit-exact to, the reference binary; no ITU conformance
vectors exist in this offline environment, so the test battery validates
the properties that make the metric useful for enhancement work: perfect
score on identity, monotonicity in SNR, gain invariance, delay
robustness, and the [1.02, 4.64] MOS-LQO range.
"""

from __future__ import annotations

import numpy as np

_NB_BANDS = 42
_FRAME = 256        # 32 ms @ 8 kHz
_SHIFT = 128
_TARGET_POW = 1e7   # P.862 active speech power target


def _resample_to_8k(x: np.ndarray, fs: int) -> np.ndarray:
    if fs == 8000:
        return x.astype(np.float64)
    if fs % 8000 == 0:
        q = fs // 8000
        # simple polyphase-free decimation with an anti-alias FIR (sinc)
        n = 127
        t = np.arange(-(n // 2), n // 2 + 1)
        h = np.sinc(t / q) / q
        h *= np.hamming(n)
        y = np.convolve(x.astype(np.float64), h, mode="same")
        return y[::q]
    raise ValueError(f"unsupported sample rate {fs}")


def _bandpass_325_3250(x: np.ndarray) -> np.ndarray:
    """FFT-domain receive bandpass (the IRS-like filtering role)."""
    n = len(x)
    spec = np.fft.rfft(x)
    f = np.fft.rfftfreq(n, d=1.0 / 8000.0)
    gain = np.ones_like(f)
    gain[f < 325.0] = 0.0
    gain[f > 3250.0] = 0.0
    # gentle IRS-style tilt: +6 dB/octave below 1 kHz knee flattening out
    tilt = np.clip(f / 1000.0, 0.1, 1.0)
    return np.fft.irfft(spec * gain * tilt, n)


def _level_align(x: np.ndarray) -> np.ndarray:
    b = _bandpass_325_3250(x)
    frames = len(b) // _SHIFT
    if frames == 0:
        return x
    p = (b[: frames * _SHIFT].reshape(frames, _SHIFT) ** 2).mean(axis=1)
    active = p > (p.max() * 1e-4)
    mean_pow = p[active].mean() if active.any() else p.mean()
    return x * np.sqrt(_TARGET_POW / max(mean_pow, 1e-12))


def _time_align(ref: np.ndarray, deg: np.ndarray) -> np.ndarray:
    """Global delay by envelope cross-correlation; shift deg onto ref."""
    env = lambda x: np.abs(x).reshape(-1, 32).mean(axis=1)
    n = min(len(ref), len(deg)) // 32 * 32
    er, ed = env(ref[:n]), env(deg[:n])
    er, ed = er - er.mean(), ed - ed.mean()
    corr = np.correlate(ed, er, mode="full")
    lag = (np.argmax(corr) - (len(er) - 1)) * 32
    if lag > 0:
        deg = deg[lag:]
    elif lag < 0:
        deg = np.concatenate([np.zeros(-lag), deg])
    return deg


def _bark_edges(n_bands: int = _NB_BANDS) -> np.ndarray:
    """Band edges (Hz) equally spaced on the Zwicker Bark scale to 4 kHz."""
    hz2bark = lambda f: 13.0 * np.arctan(0.00076 * f) \
        + 3.5 * np.arctan((f / 7500.0) ** 2)
    bark_max = hz2bark(4000.0)
    barks = np.linspace(0.0, bark_max, n_bands + 1)
    f = np.linspace(0.0, 4000.0, 4001)
    b = hz2bark(f)
    return np.interp(barks, b, f)


_EDGES = _bark_edges()
_FREQS = np.fft.rfftfreq(_FRAME, d=1.0 / 8000.0)
_BANDMAT = np.stack([
    ((_FREQS >= lo) & (_FREQS < hi)).astype(np.float64)
    for lo, hi in zip(_EDGES[:-1], _EDGES[1:])
])  # (bands, bins)
_BANDMAT /= np.maximum(_BANDMAT.sum(axis=1, keepdims=True), 1.0)
_CENTERS = 0.5 * (_EDGES[:-1] + _EDGES[1:])
# Terhardt absolute hearing threshold (dB), published closed form
_ABS_THR_DB = (3.64 * (_CENTERS / 1000.0 + 1e-3) ** -0.8
               - 6.5 * np.exp(-0.6 * (_CENTERS / 1000.0 - 3.3) ** 2)
               + 1e-3 * (_CENTERS / 1000.0) ** 4)
_ABS_THR = np.maximum(10.0 ** (np.clip(_ABS_THR_DB, -20, 60) / 10.0), 1e-2)
# Loudness scale: calibrated so additive white noise maps to a plausible
# MOS-LQO ladder (40 dB SNR -> ~3.8) given the published 4.5-0.1D-0.0309DA
# combination; stands in for the ITU Sl constant + per-band tables.
_SL = 0.55
_BAND_W = (_EDGES[1:] - _EDGES[:-1])
_BAND_W = _BAND_W / _BAND_W.sum()


def _bark_spectra(x: np.ndarray) -> np.ndarray:
    n = (len(x) - _FRAME) // _SHIFT + 1
    if n <= 0:
        return np.zeros((0, _NB_BANDS))
    idx = np.arange(_FRAME)[None, :] + _SHIFT * np.arange(n)[:, None]
    frames = x[idx] * np.hanning(_FRAME)[None, :]
    power = np.abs(np.fft.rfft(frames, axis=1)) ** 2 / _FRAME
    return power @ _BANDMAT.T  # (n, bands)


def _loudness(bark: np.ndarray) -> np.ndarray:
    """Zwicker-law specific loudness (P.862 intensity->loudness):
    Sl * (thr/0.5)^0.23 * ((0.5 + 0.5*I/thr)^0.23 - 1), zero below the
    absolute threshold."""
    g = 0.23
    ratio = bark / _ABS_THR
    l = _SL * (_ABS_THR / 0.5) ** g * ((0.5 + 0.5 * ratio) ** g - 1.0)
    return np.where(bark > _ABS_THR, l, 0.0)


def pesq_nb(ref: np.ndarray, deg: np.ndarray, fs: int = 8000) -> float:
    """P.862-style narrowband MOS-LQO of `deg` against clean `ref`."""
    ref = _resample_to_8k(np.asarray(ref, np.float64), fs)
    deg = _resample_to_8k(np.asarray(deg, np.float64), fs)
    ref = _level_align(ref)
    deg = _level_align(deg)
    deg = _time_align(ref, deg)
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]
    ref = _bandpass_325_3250(ref)
    deg = _bandpass_325_3250(deg)

    br = _bark_spectra(ref)
    bd = _bark_spectra(deg)
    if br.shape[0] == 0:
        return 1.02
    frames = br.shape[0]

    # partial frequency compensation of the reference toward the degraded
    # mean spectrum (P.862 pow_dens ratio, clipped to [0.01, 100])
    active = br.mean(axis=1) > br.mean() * 1e-2
    mr = br[active].mean(axis=0) if active.any() else br.mean(axis=0)
    md = bd[active].mean(axis=0) if active.any() else bd.mean(axis=0)
    # partial compensation: tighter clip than the ITU [0.01, 100] —
    # with the closed-form band tables a permissive clip lets a flat-noise
    # degradation reshape the reference toward itself and score too well
    ratio = np.clip((md + 1e3) / (mr + 1e3), 0.2, 5.0)
    br_eq = br * ratio[None, :]

    # gain compensation of the degraded signal: a single gain from the
    # active-frame energy ratio (a per-frame gain would also rescale noise
    # in speech pauses and erase exactly the disturbance PESQ exists to
    # measure), clipped like the ITU local-gain bounds
    fr = br_eq.sum(axis=1) + 5e5
    fd = bd.sum(axis=1) + 5e5
    gain = np.clip(np.median((fr / fd)[active]) if active.any()
                   else np.median(fr / fd), 3e-4, 5.0)
    bd_eq = bd * gain

    lr = _loudness(br_eq)
    ld = _loudness(bd_eq)

    # symmetric disturbance with the P.862 deadzone 0.25*min loudness
    diff = ld - lr
    dead = 0.25 * np.minimum(np.abs(ld), np.abs(lr))
    d = np.where(diff > dead, diff - dead,
                 np.where(diff < -dead, diff + dead, 0.0))
    # asymmetry factor ((deg+50)/(ref+50))^1.2, <0.6 -> 0, clip at 12
    asym = ((bd_eq + 50.0) / (br_eq + 50.0)) ** 1.2
    asym = np.where(asym < 0.6, 0.0, np.minimum(asym, 12.0))

    # frame disturbances: band-width-weighted RMS (symmetric) and
    # weighted L1 of the asymmetric term
    d_frame = np.sqrt((d ** 2 * _BAND_W).sum(axis=1))
    da_frame = (np.abs(d * asym) * _BAND_W).sum(axis=1)
    # silent-frame down-weighting (low-energy frames matter less)
    e = br.sum(axis=1)
    h = ((e + 1e5) / 1e7) ** 0.04
    d_frame = np.minimum(d_frame / h, 45.0)
    da_frame = np.minimum(da_frame / h, 45.0)

    # L6 over ~320 ms splits, then L2 over splits (P.862 psqm intervals)
    def lp_agg(x, p_in, p_out, win=10):
        pads = (-len(x)) % win
        xx = np.pad(x, (0, pads)).reshape(-1, win)
        inner = (np.mean(xx ** p_in, axis=1)) ** (1.0 / p_in)
        return (np.mean(inner ** p_out)) ** (1.0 / p_out)

    D = lp_agg(d_frame, 6.0, 2.0)
    DA = lp_agg(da_frame, 1.0, 2.0)

    mos = 4.5 - 0.1 * D - 0.0309 * DA
    # P.862.1 raw-MOS -> MOS-LQO mapping (published)
    return float(0.999 + 4.0 / (1.0 + np.exp(-1.4945 * mos + 4.6607)))


def pesq_score(ref: np.ndarray, deg: np.ndarray, fs: int = 16000,
               mode: str = "nb") -> float:
    """Public entry: narrowband MOS-LQO (16 kHz inputs are decimated)."""
    if mode != "nb":
        raise ValueError("only narrowband (nb) P.862 is implemented")
    return pesq_nb(ref, deg, fs)
