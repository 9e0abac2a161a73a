# Copy of espnet_tpu/utils/se_metrics.py: the port imports nothing of
# espnet_tpu. Its import of pesq_py points at the port's copy.
"""Speech-enhancement scoring metrics.

Behavioral spec: reference `espnet2/bin/enh_scoring.py:1` scores separated
audio with {STOI, ESTOI, SI-SNR, SDR} (+ optional PESQ via the `pesq` C
extension, which is not in this image — callers get a clear error for it
rather than a silent stub; everything else is self-contained numpy here).

STOI follows Taal et al. 2011 ("A short-time objective intelligibility
measure..."): 10 kHz resample, energy VAD (40 dB), 512/256 Hann STFT,
15 one-third-octave bands from 150 Hz, 30-frame segments, clipped
normalized correlation. ESTOI (Jensen & Taal 2016) replaces the band
correlation with spectrogram-normalized segment correlation.
"""

from __future__ import annotations

import numpy as np

FS_STOI = 10000
N_FRAME = 256      # 25.6 ms at 10 kHz (VAD framing)
N_FFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0
SEG = 30           # analysis segment length in frames (384 ms)
BETA = -15.0       # clipping SDR bound (dB)
DYN_RANGE = 40.0   # VAD dynamic range (dB)


def _resample(x: np.ndarray, fs: int, target: int) -> np.ndarray:
    if fs == target:
        return x
    from scipy.signal import resample_poly
    from math import gcd

    g = gcd(fs, target)
    return resample_poly(x, target // g, fs // g)


def _remove_silent_frames(x, y, dyn_range, framelen, hop):
    w = np.hanning(framelen + 2)[1:-1]
    n = (len(x) - framelen) // hop + 1
    if n < 1:
        return x, y
    frames = np.stack([x[i * hop: i * hop + framelen] * w for i in range(n)])
    energies = 20 * np.log10(np.linalg.norm(frames, axis=1) + 1e-12)
    mask = energies > (np.max(energies) - dyn_range)
    if not np.any(mask):
        return x, y

    def rebuild(sig):
        out = np.zeros(int(np.sum(mask)) * hop + framelen - hop)
        pos = 0
        for i in range(n):
            if mask[i]:
                out[pos: pos + framelen] += sig[i * hop: i * hop + framelen] * w
                pos += hop
        return out

    return rebuild(x), rebuild(y)


def _stft(x, framelen, nfft, hop):
    w = np.hanning(framelen + 2)[1:-1]
    n = (len(x) - framelen) // hop + 1
    if n < 1:
        return np.zeros((0, nfft // 2 + 1))
    frames = np.stack([x[i * hop: i * hop + framelen] * w for i in range(n)])
    return np.fft.rfft(frames, nfft, axis=1)


def _third_octave_bands(fs, nfft, num_bands, min_freq):
    f = np.linspace(0, fs / 2, nfft // 2 + 1)
    k = np.arange(num_bands)
    cf = min_freq * (2.0 ** (k / 3.0))
    lo = cf * 2 ** (-1.0 / 6)
    hi = cf * 2 ** (1.0 / 6)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo_i = np.argmin((f - lo[i]) ** 2)
        hi_i = np.argmin((f - hi[i]) ** 2)
        obm[i, lo_i:hi_i] = 1.0
    return obm


def stoi(ref: np.ndarray, est: np.ndarray, fs: int = 16000,
         extended: bool = False) -> float:
    """Short-time objective intelligibility in [~0, 1]."""
    ref = np.asarray(ref, np.float64)
    est = np.asarray(est, np.float64)
    n = min(len(ref), len(est))
    ref, est = ref[:n], est[:n]
    x = _resample(ref, fs, FS_STOI)
    y = _resample(est, fs, FS_STOI)
    hop = N_FRAME // 2
    x, y = _remove_silent_frames(x, y, DYN_RANGE, N_FRAME, hop)
    X = _stft(x, N_FRAME, N_FFT, hop)
    Y = _stft(y, N_FRAME, N_FFT, hop)
    if X.shape[0] < SEG:
        return float("nan")
    obm = _third_octave_bands(FS_STOI, N_FFT, NUM_BANDS, MIN_FREQ)
    Xb = np.sqrt(obm @ (np.abs(X) ** 2).T)  # (bands, frames)
    Yb = np.sqrt(obm @ (np.abs(Y) ** 2).T)

    scores = []
    for m in range(SEG, Xb.shape[1] + 1):
        Xs = Xb[:, m - SEG: m]  # (bands, SEG)
        Ys = Yb[:, m - SEG: m]
        if extended:
            # ESTOI: row+column normalized spectrogram correlation
            Xs = Xs - Xs.mean(axis=1, keepdims=True)
            Ys = Ys - Ys.mean(axis=1, keepdims=True)
            Xs = Xs / (np.linalg.norm(Xs, axis=1, keepdims=True) + 1e-12)
            Ys = Ys / (np.linalg.norm(Ys, axis=1, keepdims=True) + 1e-12)
            Xs = Xs - Xs.mean(axis=0, keepdims=True)
            Ys = Ys - Ys.mean(axis=0, keepdims=True)
            Xs = Xs / (np.linalg.norm(Xs, axis=0, keepdims=True) + 1e-12)
            Ys = Ys / (np.linalg.norm(Ys, axis=0, keepdims=True) + 1e-12)
            scores.append(np.sum(Xs * Ys) / NUM_BANDS)
        else:
            # scale + clip (Taal eq. 3-5), then per-band correlation
            alpha = np.linalg.norm(Xs, axis=1, keepdims=True) / (
                np.linalg.norm(Ys, axis=1, keepdims=True) + 1e-12)
            Ysc = Ys * alpha
            clip = Xs * (1 + 10 ** (-BETA / 20.0))
            Ysc = np.minimum(Ysc, clip)
            xm = Xs - Xs.mean(axis=1, keepdims=True)
            ym = Ysc - Ysc.mean(axis=1, keepdims=True)
            corr = np.sum(xm * ym, axis=1) / (
                np.linalg.norm(xm, axis=1) * np.linalg.norm(ym, axis=1)
                + 1e-12)
            scores.append(np.mean(corr))
    return float(np.mean(scores))


def estoi(ref, est, fs: int = 16000) -> float:
    return stoi(ref, est, fs, extended=True)


def si_snr(ref: np.ndarray, est: np.ndarray) -> float:
    """Scale-invariant SNR in dB (`espnet2/enh/loss/criterions/
    time_domain.py` SISNRLoss, as a scoring metric)."""
    ref = np.asarray(ref, np.float64)
    est = np.asarray(est, np.float64)
    n = min(len(ref), len(est))
    ref, est = ref[:n] - ref[:n].mean(), est[:n] - est[:n].mean()
    s = np.dot(est, ref) / (np.dot(ref, ref) + 1e-12) * ref
    e = est - s
    return float(10 * np.log10((np.dot(s, s) + 1e-12) / (np.dot(e, e) + 1e-12)))


def sdr(ref: np.ndarray, est: np.ndarray) -> float:
    """Plain (scale-variant) signal-to-distortion ratio in dB."""
    ref = np.asarray(ref, np.float64)
    est = np.asarray(est, np.float64)
    n = min(len(ref), len(est))
    ref, est = ref[:n], est[:n]
    err = est - ref
    return float(10 * np.log10((np.dot(ref, ref) + 1e-12)
                               / (np.dot(err, err) + 1e-12)))


def pesq_approx(ref: np.ndarray, est: np.ndarray, fs: int = 16000) -> float:
    """Narrowband PESQ-style MOS-LQO (pure-python P.862-STRUCTURE
    implementation, `utils/pesq_py.py`; fills the reference's optional
    licensed PESQ dep, `tools/Makefile:172-174`).

    NOT ITU-conformant: structure-faithful but not bit-exact to the ITU
    binary (closed-form Zwicker tables, no conformance vectors) — scores
    correlate with but are NOT comparable to published P.862 numbers.
    Deliberately named `pesq_approx` (and reported as `pesq_py`) so the
    approximation can never be mistaken for ITU PESQ. See the pesq_py
    module docstring for the honest scope."""
    from espnet_tpu_torch.utils.pesq_py import pesq_score

    return pesq_score(np.asarray(ref), np.asarray(est), fs=fs)


# Historical alias; prefer pesq_approx. Kept so older call sites fail loudly
# in review rather than silently (the name makes the caveat visible).
pesq_py = pesq_approx
