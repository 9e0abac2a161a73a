# Copy of espnet_tpu/data/synth.py (the port imports nothing of
# espnet_tpu); its imports point at the port's modules.
"""Synthetic smoke corpus generator (mini_an4 stand-in).

The reference ships a 100-utterance an4 subset as its universal CPU smoke
fixture (`egs/mini_an4/`, SURVEY §4). We cannot ship corpora, so tests and
the smoke recipe synthesise one: each "word" is a fixed tone chord, an
utterance is a sequence of words, so the mapping audio->text is learnable
by a tiny model in a few epochs.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from espnet_tpu_torch.data.fileio import DatadirWriter, write_wav

WORDS = ["ichi", "ni", "san", "yon", "go", "roku", "nana", "hachi"]


def synth_utterance(
    word_ids: List[int], fs: int = 16000, word_dur: float = 0.40,
    rng: np.random.RandomState = None, pitch_scale: float = 1.0,
) -> np.ndarray:
    # word_dur must keep CTC feasible: a word of <=5 chars + space needs
    # ~6 encoder frames = 24 feature frames = 0.19 s at hop 128/16k; 0.40 s
    # gives a comfortable margin (the reference recipes likewise filter
    # too-short utterances at stage 4, egs2/TEMPLATE/asr1/asr.sh:652).
    rng = rng or np.random.RandomState(0)
    n = int(word_dur * fs)
    t = np.arange(n) / fs
    segs = []
    for w in word_ids:
        f0 = (200.0 + 120.0 * w) * pitch_scale
        seg = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.2 * np.sin(2 * np.pi * 2.1 * f0 * t)
        env = np.minimum(1.0, np.minimum(np.arange(n), n - np.arange(n)) / (0.01 * fs))
        segs.append(seg * env)
    wav = np.concatenate(segs) + 0.01 * rng.randn(n * len(word_ids))
    return wav.astype(np.float32)


def generate_corpus(
    out_dir, n_utts: int = 60, min_words: int = 2, max_words: int = 6,
    fs: int = 16000, seed: int = 0, n_spk: int = 1,
) -> Tuple[Path, Dict[str, str]]:
    """Writes wav/ + wav.scp + text (+ utt2spk/spk2utt when n_spk > 1;
    synthetic speakers differ by a global pitch scale so a speaker
    embedder has something to learn). Returns (dir, texts)."""
    out = Path(out_dir)
    (out / "wav").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    texts: Dict[str, str] = {}
    spk2utt: Dict[str, List[str]] = {}
    with DatadirWriter(out) as w:
        for i in range(n_utts):
            spk = i % max(n_spk, 1)
            uid = f"spk{spk}-utt{i:04d}" if n_spk > 1 else f"utt{i:04d}"
            nw = rng.randint(min_words, max_words + 1)
            word_ids = rng.randint(0, len(WORDS), nw)
            scale = 1.0 + 0.35 * (spk - (n_spk - 1) / 2.0) if n_spk > 1 \
                else 1.0
            wav = synth_utterance(list(word_ids), fs, rng=rng,
                                  pitch_scale=scale)
            path = out / "wav" / f"{uid}.wav"
            write_wav(path, wav, fs)
            w["wav.scp"][uid] = str(path)
            text = " ".join(WORDS[j] for j in word_ids)
            w["text"][uid] = text
            texts[uid] = text
            if n_spk > 1:
                w["utt2spk"][uid] = f"spk{spk}"
                spk2utt.setdefault(f"spk{spk}", []).append(uid)
    if n_spk > 1:
        (out / "spk2utt").write_text("".join(
            f"{s_} {' '.join(us)}\n" for s_, us in sorted(spk2utt.items())))
    return out, texts


# ---------------------------------------------------------------------------
# Hard synthetic ASR corpus (round-5 head-to-head)
#
# The tone-chord corpus above is linearly separable — every system converges
# to WER 0 (VERDICT r4 weak #4), so it cannot DISTINGUISH two ASR systems.
# This corpus is built so a competent end-to-end model lands at a nonzero,
# comparable WER, driven by the same difficulty axes as real speech:
#   * confusable vocabulary: words are CV-syllable strings over a shared
#     consonant/vowel inventory (minimal pairs differ in one formant target
#     or burst spectrum only);
#   * speaker variation: per-utterance f0 (90-250 Hz) and vocal-tract
#     (formant-scale) draws from a continuous space — test "speakers" are
#     unseen by construction;
#   * tempo variation: per-utterance syllable duration + per-syllable jitter;
#   * additive noise at a drawn SNR (white + pink mixture);
#   * a random channel (one-pole lowpass tilt + gain).
# ---------------------------------------------------------------------------

# consonant -> (burst center Hz, voiced). Pairs (b,p), (d,t), (g,k) share a
# burst spectrum and differ only in the voice bar -> confusable under noise.
_HARD_CONSONANTS = {
    "b": (600.0, True), "p": (600.0, False),
    "d": (1800.0, True), "t": (1800.0, False),
    "g": (3000.0, True), "k": (3000.0, False),
}
# vowel -> (F1, F2) Hz. o/u and e/i are close pairs.
_HARD_VOWELS = {
    "a": (800.0, 1250.0), "e": (480.0, 1900.0), "i": (320.0, 2350.0),
    "o": (500.0, 950.0), "u": (360.0, 780.0),
}


def hard_vocab(n_words: int = 40, seed: int = 1234) -> List[str]:
    """Deterministic vocabulary of 2-syllable CV words ("badi", "kugo"...).

    Sampled without replacement from the 30x30 syllable-pair space; the
    shared syllable inventory guarantees confusable near-neighbours."""
    rng = np.random.RandomState(seed)
    sylls = [c + v for c in _HARD_CONSONANTS for v in _HARD_VOWELS]
    words: List[str] = []
    seen = set()
    while len(words) < n_words:
        w = sylls[rng.randint(len(sylls))] + sylls[rng.randint(len(sylls))]
        if w not in seen:
            seen.add(w)
            words.append(w)
    return words


def _bandpass_noise(n: int, center: float, width: float, fs: int,
                    rng: np.random.RandomState) -> np.ndarray:
    """White noise shaped by a Gaussian band in the frequency domain."""
    x = rng.randn(n)
    spec = np.fft.rfft(x)
    f = np.fft.rfftfreq(n, 1.0 / fs)
    spec *= np.exp(-0.5 * ((f - center) / max(width, 1.0)) ** 2)
    y = np.fft.irfft(spec, n)
    peak = max(1e-8, np.max(np.abs(y)))
    return (y / peak).astype(np.float64)


def synth_hard_utterance(
    words: List[str], fs: int = 16000, *,
    rng: np.random.RandomState,
    f0: float = 120.0, formant_scale: float = 1.0,
    syl_dur: float = 0.17, snr_db: float = 10.0,
    channel_a: float = 0.0, gain: float = 0.3,
    reverb_rt: float = 0.0,
) -> np.ndarray:
    """Render a word sequence with a crude source-filter model.

    Vowels: harmonics of f0 weighted by two Gaussian formant bumps at
    (F1, F2) * formant_scale. Consonants: a 45 ms band-passed noise burst
    (+ a voice bar when voiced). Words separated by 30-90 ms silence; the
    whole utterance gets additive white+pink noise at `snr_db` and a
    one-pole lowpass channel with coefficient `channel_a`."""
    segs = []
    sil = np.zeros(int(rng.uniform(0.05, 0.10) * fs))
    segs.append(np.zeros(int(0.08 * fs)))
    for word in words:
        for ci in range(0, len(word), 2):
            c, v = word[ci], word[ci + 1]
            burst_c, voiced = _HARD_CONSONANTS[c]
            f1, f2 = _HARD_VOWELS[v]
            dur = syl_dur * rng.uniform(0.85, 1.2)
            n_c = int(0.045 * fs)
            n_v = max(int(dur * fs) - n_c, int(0.06 * fs))
            # consonant burst
            cseg = 0.5 * _bandpass_noise(n_c, burst_c * formant_scale,
                                         350.0, fs, rng)
            if voiced:
                t = np.arange(n_c) / fs
                cseg = cseg + 0.25 * np.sin(2 * np.pi * f0 * t)
            # vowel: harmonic stack under a two-formant envelope
            t = np.arange(n_v) / fs
            vseg = np.zeros(n_v)
            k = 1
            while k * f0 < 3800.0:
                fk = k * f0
                amp = (np.exp(-0.5 * ((fk - f1 * formant_scale) / 130.0) ** 2)
                       + 0.7 * np.exp(-0.5 * ((fk - f2 * formant_scale)
                                              / 220.0) ** 2)
                       + 0.08 / k)
                vseg += amp * np.sin(2 * np.pi * fk * t
                                     + rng.uniform(0, 2 * np.pi))
                k += 1
            vseg *= 0.5 / max(1e-6, np.max(np.abs(vseg)))
            env = np.minimum(1.0, np.minimum(np.arange(n_v),
                                             n_v - np.arange(n_v))
                             / (0.012 * fs))
            segs.append(cseg)
            segs.append(vseg * env)
        segs.append(sil)
    segs.append(np.zeros(int(0.08 * fs)))
    sig = np.concatenate(segs)
    # reverberation: sparse exponentially-decaying synthetic RIR
    # (smears the consonant bursts — the realistic hard part)
    if reverb_rt > 1e-3:
        n_taps = 24
        delays = np.sort(rng.randint(int(0.004 * fs),
                                     int(reverb_rt * fs), n_taps))
        amps = (rng.randn(n_taps)
                * np.exp(-3.0 * delays / (reverb_rt * fs)) * 0.5)
        rir = np.zeros(int(reverb_rt * fs) + 1)
        rir[0] = 1.0
        rir[delays] += amps
        n = len(sig)
        m = n + len(rir) - 1
        sig = np.fft.irfft(np.fft.rfft(sig, m) * np.fft.rfft(rir, m),
                           m)[:n]
    # channel: one-pole lowpass tilt via FFT (vectorized equivalent of
    # y[t] = a*y[t-1] + (1-a)*x[t])
    if channel_a > 1e-3:
        n = len(sig)
        h = (1 - channel_a) / (1 - channel_a
                               * np.exp(-2j * np.pi * np.fft.rfftfreq(n)))
        sig = np.fft.irfft(np.fft.rfft(sig) * h, n)
    # additive noise at snr_db: white + pink mixture
    n = len(sig)
    white = rng.randn(n)
    spec = np.fft.rfft(rng.randn(n))
    f = np.maximum(np.fft.rfftfreq(n, 1.0 / fs), 20.0)
    pink = np.fft.irfft(spec / np.sqrt(f / 20.0), n)
    noise = white + pink / max(1e-8, pink.std())
    sp = np.mean(sig ** 2)
    npow = np.mean(noise ** 2)
    noise *= np.sqrt(sp / max(npow, 1e-12) / 10 ** (snr_db / 10.0))
    out = gain * (sig + noise)
    peak = max(1e-6, np.max(np.abs(out)))
    if peak > 0.95:
        out *= 0.95 / peak
    return out.astype(np.float32)


def generate_hard_corpus(
    out_dir, n_utts: int = 300, *, vocab_size: int = 60,
    min_words: int = 3, max_words: int = 7, fs: int = 16000,
    seed: int = 0, snr_lo: float = -12.0, snr_hi: float = 2.0,
    syl_lo: float = 0.10, syl_hi: float = 0.16,
    reverb_p: float = 0.85, reverb_rt_max: float = 0.35,
    vocab_seed: int = 1234,
) -> Tuple[Path, Dict[str, str]]:
    """Hard synthetic ASR corpus (see module comment above).

    Distinct `seed`s give disjoint utterances AND disjoint speaker draws,
    so dev/test are unseen-speaker sets. Same `vocab_seed` must be used
    for every split."""
    out = Path(out_dir)
    (out / "wav").mkdir(parents=True, exist_ok=True)
    vocab = hard_vocab(vocab_size, vocab_seed)
    rng = np.random.RandomState(seed)
    texts: Dict[str, str] = {}
    with DatadirWriter(out) as w:
        for i in range(n_utts):
            uid = f"h{seed:02d}-{i:05d}"
            nw = rng.randint(min_words, max_words + 1)
            words = [vocab[j] for j in rng.randint(0, len(vocab), nw)]
            wav = synth_hard_utterance(
                words, fs, rng=rng,
                f0=rng.uniform(90.0, 250.0),
                formant_scale=rng.uniform(0.85, 1.2),
                syl_dur=rng.uniform(syl_lo, syl_hi),
                snr_db=rng.uniform(snr_lo, snr_hi),
                channel_a=rng.uniform(0.0, 0.55),
                gain=10 ** (rng.uniform(-12.0, 0.0) / 20.0) * 0.5,
                reverb_rt=(rng.uniform(0.06, reverb_rt_max)
                           if rng.rand() < reverb_p else 0.0),
            )
            path = out / "wav" / f"{uid}.wav"
            write_wav(path, wav, fs)
            w["wav.scp"][uid] = str(path)
            text = " ".join(words)
            w["text"][uid] = text
            texts[uid] = text
    return out, texts


def generate_mixture_corpus(
    out_dir, n_utts: int = 30, num_spk: int = 2, fs: int = 16000,
    min_words: int = 2, max_words: int = 4, seed: int = 0,
):
    """Two-speaker synthetic mixtures: wav.scp (mix) + spk<i>.scp (refs).

    Data-dir layout of the reference enh recipes (egs2/TEMPLATE/enh1)."""
    out = Path(out_dir)
    (out / "wav").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    with DatadirWriter(out) as w:
        for i in range(n_utts):
            uid = f"utt{i:04d}"
            nw = rng.randint(min_words, max_words + 1)
            srcs = []
            for s in range(num_spk):
                word_ids = rng.randint(0, len(WORDS), nw)
                wav = synth_utterance(
                    list(word_ids), fs, word_dur=0.30 + 0.12 * s, rng=rng
                )
                srcs.append(wav)
            n = max(len(x) for x in srcs)
            srcs = [np.pad(x, (0, n - len(x))) for x in srcs]
            gains = 10 ** (rng.uniform(-2.5, 2.5, num_spk) / 20.0)
            srcs = [g * x for g, x in zip(gains, srcs)]
            mix = np.sum(srcs, axis=0) + 0.005 * rng.randn(n).astype(np.float32)
            peak = max(1e-6, np.max(np.abs(mix)))
            scale = min(1.0, 0.95 / peak)
            mix = (mix * scale).astype(np.float32)
            mpath = out / "wav" / f"{uid}_mix.wav"
            write_wav(mpath, mix, fs)
            w["wav.scp"][uid] = str(mpath)
            for s in range(num_spk):
                spath = out / "wav" / f"{uid}_s{s + 1}.wav"
                write_wav(spath, (srcs[s] * scale).astype(np.float32), fs)
                w[f"spk{s + 1}.scp"][uid] = str(spath)
    return out


def generate_st_corpus(
    out_dir, n_utts: int = 30, min_words: int = 2, max_words: int = 4,
    fs: int = 16000, seed: int = 0,
):
    """ST toy corpus: wav.scp + src_text (spoken words) + text (the
    "translation": reversed word order — deterministic, learnable)."""
    out, texts = generate_corpus(out_dir, n_utts, min_words, max_words, fs, seed)
    src = {k: v for k, v in texts.items()}
    tgt = {k: " ".join(reversed(v.split())) for k, v in texts.items()}
    from espnet_tpu_torch.data.fileio import write_2column_text

    write_2column_text(Path(out_dir) / "src_text", src)
    write_2column_text(Path(out_dir) / "text", tgt)
    return out


def generate_mt_corpus(
    out_dir, n_utts: int = 200, min_words: int = 2, max_words: int = 6,
    seed: int = 0,
):
    """MT toy corpus: src_text + text (reversed word order)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    src, tgt = {}, {}
    for i in range(n_utts):
        uid = f"utt{i:04d}"
        nw = rng.randint(min_words, max_words + 1)
        words = [WORDS[j] for j in rng.randint(0, len(WORDS), nw)]
        src[uid] = " ".join(words)
        tgt[uid] = " ".join(reversed(words))
    from espnet_tpu_torch.data.fileio import write_2column_text

    write_2column_text(out / "src_text", src)
    write_2column_text(out / "text", tgt)
    return out


def generate_diar_corpus(
    out_dir, n_utts: int = 20, num_spk: int = 2, fs: int = 16000,
    dur: float = 3.0, seed: int = 0,
):
    """Diarization toy corpus: mixtures with alternating speaker activity,
    labels in RTTM (reference `espnet2/fileio/rttm.py` format)."""
    out = Path(out_dir)
    (out / "wav").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    n = int(dur * fs)
    t = np.arange(n) / fs
    rttm_lines = []
    with DatadirWriter(out) as w:
        for i in range(n_utts):
            uid = f"utt{i:04d}"
            mix = 0.01 * rng.randn(n).astype(np.float32)
            for s in range(num_spk):
                f0 = 220.0 * (s + 1) + 40.0 * rng.rand()
                src = 0.4 * np.sin(2 * np.pi * f0 * t).astype(np.float32)
                # 1-3 active segments per speaker
                n_seg = rng.randint(1, 4)
                for _ in range(n_seg):
                    beg = rng.uniform(0, dur - 0.5)
                    seg_dur = rng.uniform(0.4, min(1.5, dur - beg))
                    b, e = int(beg * fs), int((beg + seg_dur) * fs)
                    mix[b:e] += src[b:e]
                    rttm_lines.append(
                        f"SPEAKER {uid} 1 {beg:.3f} {seg_dur:.3f} "
                        f"<NA> <NA> spk{s + 1} <NA>"
                    )
            peak = max(1e-6, np.max(np.abs(mix)))
            mix = mix * min(1.0, 0.95 / peak)
            path = out / "wav" / f"{uid}.wav"
            write_wav(path, mix, fs)
            w["wav.scp"][uid] = str(path)
    (out / "rttm").write_text("\n".join(rttm_lines) + "\n")
    return out


def generate_vc_corpus(
    out_dir, n_utts: int = 10, fs: int = 16000, min_words: int = 2,
    max_words: int = 3, seed: int = 0,
):
    """Parallel VC toy corpus: target = source pitch-shifted (speed-perturbed
    without length change via resample-and-pad)."""
    from espnet_tpu_torch.ops.perturb import speed_perturb

    out = Path(out_dir)
    (out / "wav").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    with DatadirWriter(out) as w:
        for i in range(n_utts):
            uid = f"utt{i:04d}"
            nw = rng.randint(min_words, max_words + 1)
            word_ids = rng.randint(0, len(WORDS), nw)
            src = synth_utterance(list(word_ids), fs, rng=rng)
            shifted = speed_perturb(src, 1.25)  # pitch+tempo shift
            tgt = np.zeros_like(src)
            tgt[: len(shifted)] = shifted[: len(src)]
            sp = out / "wav" / f"{uid}_src.wav"
            tp = out / "wav" / f"{uid}_tgt.wav"
            write_wav(sp, src, fs)
            write_wav(tp, tgt, fs)
            w["wav.scp"][uid] = str(sp)
            w["tgt_wav.scp"][uid] = str(tp)
    return out


def generate_tse_corpus(
    out_dir, n_utts: int = 30, fs: int = 16000,
    min_words: int = 2, max_words: int = 4, seed: int = 0,
):
    """Target-speaker-extraction corpus: wav.scp (2-spk mixture),
    spk1.scp (target source), enroll_spk1.scp (a DIFFERENT utterance of
    the target speaker). Layout of the reference enh_tse recipes
    (`egs2/TEMPLATE/tse1`, `espnet2/train/preprocessor.py` TSEPreprocessor).

    Speaker identity is the word duration (timbre proxy) used by
    synth_utterance, so the enrollment carries usable speaker cues."""
    out = Path(out_dir)
    (out / "wav").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    durs = (0.30, 0.42)  # two "speakers"
    with DatadirWriter(out) as w:
        for i in range(n_utts):
            uid = f"utt{i:04d}"
            target_spk = rng.randint(2)
            srcs = []
            for s, dur in enumerate((durs[target_spk],
                                     durs[1 - target_spk])):
                nw = rng.randint(min_words, max_words + 1)
                word_ids = rng.randint(0, len(WORDS), nw)
                srcs.append(synth_utterance(list(word_ids), fs,
                                            word_dur=dur, rng=rng))
            n = max(len(x) for x in srcs)
            srcs = [np.pad(x, (0, n - len(x))) for x in srcs]
            mix = srcs[0] + srcs[1] + 0.005 * rng.randn(n).astype(np.float32)
            peak = max(1e-6, np.max(np.abs(mix)))
            scale = min(1.0, 0.95 / peak)
            mix = (mix * scale).astype(np.float32)
            # enrollment: another utterance of the target speaker
            word_ids = rng.randint(0, len(WORDS), rng.randint(2, 4))
            enroll = synth_utterance(list(word_ids), fs,
                                     word_dur=durs[target_spk], rng=rng)
            mpath = out / "wav" / f"{uid}_mix.wav"
            write_wav(mpath, mix, fs)
            w["wav.scp"][uid] = str(mpath)
            spath = out / "wav" / f"{uid}_target.wav"
            write_wav(spath, (srcs[0] * scale).astype(np.float32), fs)
            w["spk1.scp"][uid] = str(spath)
            epath = out / "wav" / f"{uid}_enroll.wav"
            write_wav(epath, enroll.astype(np.float32), fs)
            w["enroll_spk1.scp"][uid] = str(epath)
    return out


def generate_svs_corpus(
    out_dir, n_utts: int = 20, fs: int = 16000, hop_length: int = 128,
    min_notes: int = 3, max_notes: int = 6, seed: int = 0,
):
    """Score-based synthetic singing corpus: wav.scp + label (phones per
    note) + midi (MIDI id per note) + durations (frames per note).

    Layout mirrors the reference SVS data streams (label / midi /
    duration_phn, `espnet2/svs/espnet_model.py:85`). The waveform is a
    harmonic tone at each note's MIDI frequency so the mel target is
    score-consistent."""
    out = Path(out_dir)
    (out / "wav").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    phones = ["a", "i", "u", "e", "o", "ka", "ki", "ku"]
    with DatadirWriter(out) as w:
        for i in range(n_utts):
            uid = f"song{i:04d}"
            n_notes = rng.randint(min_notes, max_notes + 1)
            midis = rng.randint(60, 73, n_notes)
            frames = rng.randint(20, 45, n_notes)
            labels = [phones[rng.randint(len(phones))]
                      for _ in range(n_notes)]
            segs = []
            for m, fr, ph in zip(midis, frames, labels):
                n = int(fr) * hop_length
                f0 = 440.0 * 2 ** ((m - 69) / 12.0)
                t = np.arange(n) / fs
                # phone identity as harmonic balance
                h2 = 0.1 + 0.05 * (hash(ph) % 7)
                seg = 0.4 * np.sin(2 * np.pi * f0 * t) \
                    + h2 * np.sin(2 * np.pi * 2 * f0 * t)
                env = np.minimum(
                    1.0,
                    np.minimum(np.arange(n), n - np.arange(n))
                    / (0.01 * fs),
                )
                segs.append(seg * env)
            wav = np.concatenate(segs).astype(np.float32)
            wav += 0.005 * rng.randn(len(wav)).astype(np.float32)
            path = out / "wav" / f"{uid}.wav"
            write_wav(path, wav, fs)
            w["wav.scp"][uid] = str(path)
            w["label"][uid] = " ".join(labels)
            w["midi"][uid] = " ".join(str(int(m)) for m in midis)
            w["durations"][uid] = " ".join(str(int(f)) for f in frames)
    return out


def generate_asr_mix_corpus(
    out_dir, n_utts: int = 30, num_spk: int = 2, fs: int = 16000,
    min_words: int = 2, max_words: int = 4, seed: int = 0,
):
    """Multi-speaker ASR corpus: wav.scp (mixture) + text_spk<i>
    (per-speaker transcripts), the data layout of the reference mix
    recipes (`espnet/nets/pytorch_backend/e2e_asr_mix.py` docstring)."""
    out = Path(out_dir)
    (out / "wav").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    with DatadirWriter(out) as w:
        for i in range(n_utts):
            uid = f"utt{i:04d}"
            srcs, txts = [], []
            for s in range(num_spk):
                nw = rng.randint(min_words, max_words + 1)
                word_ids = rng.randint(0, len(WORDS), nw)
                srcs.append(synth_utterance(
                    list(word_ids), fs, word_dur=0.30 + 0.12 * s, rng=rng
                ))
                txts.append(" ".join(WORDS[j] for j in word_ids))
            n = max(len(x) for x in srcs)
            srcs = [np.pad(x, (0, n - len(x))) for x in srcs]
            mix = np.sum(srcs, axis=0) + 0.005 * rng.randn(n).astype(
                np.float32)
            peak = max(1e-6, np.max(np.abs(mix)))
            mix = (mix * min(1.0, 0.95 / peak)).astype(np.float32)
            path = out / "wav" / f"{uid}.wav"
            write_wav(path, mix, fs)
            w["wav.scp"][uid] = str(path)
            for s in range(num_spk):
                w[f"text_spk{s + 1}"][uid] = txts[s]
    return out


def generate_mulenc_corpus(
    out_dir, n_utts: int = 30, num_encoders: int = 2, fs: int = 16000,
    min_words: int = 2, max_words: int = 4, seed: int = 0,
):
    """Multi-encoder ASR corpus: wav_enc<i>.scp per input stream + text.

    Stream 1 is the clean utterance; further streams are degraded copies
    (noise + a one-pole lowpass) of the SAME utterance, emulating the
    reference mulenc recipes' parallel microphone/feature streams
    (`e2e_asr_mulenc.py` num_encs inputs)."""
    out = Path(out_dir)
    (out / "wav").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    with DatadirWriter(out) as w:
        for i in range(n_utts):
            uid = f"utt{i:04d}"
            nw = rng.randint(min_words, max_words + 1)
            word_ids = rng.randint(0, len(WORDS), nw)
            clean = synth_utterance(list(word_ids), fs, rng=rng)
            w["text"][uid] = " ".join(WORDS[j] for j in word_ids)
            for e in range(num_encoders):
                if e == 0:
                    wav = clean
                else:
                    # degraded stream: lowpass + additive noise
                    a = 0.5
                    lp = np.empty_like(clean)
                    acc = 0.0
                    for t_i in range(len(clean)):
                        acc = a * acc + (1 - a) * clean[t_i]
                        lp[t_i] = acc
                    wav = (lp + 0.02 * rng.randn(len(clean))).astype(
                        np.float32)
                path = out / "wav" / f"{uid}_enc{e + 1}.wav"
                write_wav(path, wav.astype(np.float32), fs)
                w[f"wav_enc{e + 1}.scp"][uid] = str(path)
    return out


def generate_multichannel_corpus(
    out_dir, n_utts: int = 30, num_channels: int = 2, fs: int = 16000,
    min_words: int = 2, max_words: int = 4, seed: int = 0,
):
    """Multichannel ASR corpus: stereo/multich wav.scp + text. Channel 0
    is the near-field signal; further channels are delayed, attenuated,
    reverberant copies plus noise — the setup the WPE/MVDR front-end
    (reference `--use-frontend`) is meant to undo."""
    out = Path(out_dir)
    (out / "wav").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    with DatadirWriter(out) as w:
        for i in range(n_utts):
            uid = f"utt{i:04d}"
            nw = rng.randint(min_words, max_words + 1)
            word_ids = rng.randint(0, len(WORDS), nw)
            clean = synth_utterance(list(word_ids), fs, rng=rng)
            n = len(clean)
            chans = [clean]
            for c in range(1, num_channels):
                d = rng.randint(8, 40)          # inter-mic delay (samples)
                echo_d = rng.randint(300, 900)  # a single late reflection
                x = np.zeros(n, np.float32)
                x[d:] = 0.8 * clean[:n - d]
                x[echo_d:] += 0.3 * clean[:n - echo_d]
                x += 0.02 * rng.randn(n).astype(np.float32)
                chans.append(x)
            wav = np.stack(chans, axis=1)  # (N, C)
            path = out / "wav" / f"{uid}.wav"
            write_wav(path, wav, fs)
            w["wav.scp"][uid] = str(path)
            w["text"][uid] = " ".join(WORDS[j] for j in word_ids)
    return out
