# Copy of espnet_tpu/data/fileio.py (the port imports nothing of
# espnet_tpu); its imports point at the port's modules.
"""Kaldi-style data-dir IO, dependency-free.

Behavioral spec: reference `espnet2/fileio/` (`SoundScpReader`,
`read_2columns_text`, `NpyScpReader`, `DatadirWriter`) — a data dir is a set
of 2-column text maps (wav.scp, text, utt2spk, spk2utt, *_shape) keyed by
utterance id. Audio decoding uses the stdlib `wave`/scipy instead of
libsndfile (PCM16/PCM32/float wav; other codecs must be converted host-side,
as the reference's recipes do with ffmpeg/sox at data-prep time).
"""

from __future__ import annotations

import os
import wave as wave_mod
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import numpy as np


def read_2column_text(path) -> Dict[str, str]:
    """'<key> <value with spaces>' lines -> dict (espnet2/fileio/read_text.py)."""
    out: Dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split(maxsplit=1)
            if len(parts) == 1:
                key, value = parts[0], ""
            else:
                key, value = parts
            if key in out:
                raise ValueError(f"{path}:{ln}: duplicate key {key}")
            out[key] = value
    return out


def write_2column_text(path, mapping: Dict[str, str]) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for k, v in mapping.items():
            f.write(f"{k} {v}\n")


def read_shape_file(path) -> Dict[str, Tuple[int, ...]]:
    """'<key> 123,80' shape files (collect-stats output format)."""
    return {
        k: tuple(int(x) for x in v.split(","))
        for k, v in read_2column_text(path).items()
    }


def write_shape_file(path, shapes: Dict[str, Tuple[int, ...]]) -> None:
    write_2column_text(
        path, {k: ",".join(str(int(x)) for x in v) for k, v in shapes.items()}
    )


def wav_duration(path) -> float:
    """Duration in seconds from the header (no sample decode).

    Handles RIFF WAV via the stdlib and NIST SPHERE via its ASCII header
    (sample_count/sample_rate fields), so recipe duration filtering works
    on LDC-style .sph data dirs too."""
    with open(path, "rb") as fh:
        magic = fh.read(8)
    if magic[:4] == b"fLaC":
        from espnet_tpu_torch.data.flac import flac_info

        sr, _, _, total = flac_info(path)
        return total / float(sr)
    if magic.startswith(b"NIST_1A"):
        with open(path, "rb") as fh:
            fh.readline()
            header_size = int(fh.readline().strip())
            fh.seek(0)
            header = fh.read(header_size).decode("ascii", errors="replace")
        fields = {}
        # scan every header line (not just from line 3): some writers put
        # fields immediately after the NIST_1A magic
        for line in header.splitlines()[1:]:
            parts = line.split(None, 2)
            if len(parts) == 3 and parts[1].startswith("-"):
                fields[parts[0]] = parts[2]
        for need in ("sample_count", "sample_rate"):
            if need not in fields:
                raise ValueError(
                    f"malformed NIST SPHERE header in {path}: missing "
                    f"'{need}' field (found: {sorted(fields) or 'none'})")
        return int(fields["sample_count"]) / float(fields["sample_rate"])
    import wave

    with wave.open(str(path), "rb") as f:
        return f.getnframes() / float(f.getframerate())


def read_sphere(path) -> Tuple[np.ndarray, int]:
    """Read a NIST SPHERE (.sph) file -> (float32 in [-1, 1], rate).

    Self-contained sph2pipe replacement (SURVEY §2.6: the reference recipes
    shell out to sph2pipe for LDC corpora). Supports uncompressed PCM
    (8/16-bit, either byte order, ulaw) — 'embedded-shorten' compression is
    rejected with a clear error (the shorten codec is proprietary-era; LDC
    ships uncompressed variants).
    """
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"NIST_1A"):
            raise ValueError(f"{path}: not a NIST SPHERE file")
        header_size = int(f.readline().strip())
        f.seek(0)
        header = f.read(header_size).decode("ascii", errors="replace")
        fields = {}
        for line in header.splitlines()[2:]:
            parts = line.split(None, 2)
            if len(parts) == 3 and parts[1].startswith("-"):
                fields[parts[0]] = parts[2]
            elif line.strip() == "end_head":
                break
        coding = fields.get("sample_coding", "pcm")
        if "shorten" in coding:
            raise ValueError(
                f"{path}: embedded-shorten SPHERE is not supported; "
                "convert once with `sph2pipe -f rif` upstream"
            )
        n_bytes = int(fields.get("sample_n_bytes", 2))
        channels = int(fields.get("channel_count", 1))
        rate = int(fields.get("sample_rate", 16000))
        byte_fmt = fields.get("sample_byte_format", "01")
        f.seek(header_size)
        raw = f.read()
    if coding.startswith("ulaw") or coding.startswith("mu-law"):
        u = np.frombuffer(raw, np.uint8).astype(np.int16)
        u = ~u & 0xFF
        sign = u & 0x80
        exp = (u >> 4) & 0x07
        mant = u & 0x0F
        mag = ((mant << 3) + 0x84) << exp
        data = np.where(sign, 0x84 - mag, mag - 0x84).astype(np.float32)
        data /= 32768.0
    elif n_bytes == 2:
        dt = np.dtype(np.int16).newbyteorder(
            "<" if byte_fmt == "01" else ">")
        data = np.frombuffer(raw, dt).astype(np.float32) / 32768.0
    elif n_bytes == 1:
        data = np.frombuffer(raw, np.int8).astype(np.float32) / 128.0
    else:
        raise ValueError(f"{path}: unsupported sample_n_bytes={n_bytes}")
    if channels > 1:
        data = data.reshape(-1, channels)
    return data, rate


def read_wav(path) -> Tuple[np.ndarray, int]:
    """Read a PCM/float WAV file -> (float32 array in [-1, 1], sample_rate).

    Stdlib-only replacement for soundfile.read (reference
    `espnet2/fileio/sound_scp.py`); handles PCM16/PCM32/PCM8 and IEEE float,
    plus NIST SPHERE via `read_sphere` (dispatch on magic bytes).
    """
    from scipy.io import wavfile

    with open(path, "rb") as f:
        magic = f.read(7)
    if magic == b"NIST_1A":
        return read_sphere(path)
    if magic[:4] == b"fLaC":
        from espnet_tpu_torch.data.flac import read_flac

        return read_flac(path)
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return data, sr


def write_wav(path, data: np.ndarray, sr: int) -> None:
    from scipy.io import wavfile

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    data = np.clip(data, -1.0, 1.0)
    wavfile.write(path, sr, (data * 32767.0).astype(np.int16))


class SoundScpReader:
    """wav.scp reader: key -> (wave float32, rate). Lazy per-file read."""

    def __init__(self, scp_path):
        self.data = read_2column_text(scp_path)

    def keys(self):
        return self.data.keys()

    def __len__(self):
        return len(self.data)

    def __contains__(self, key):
        return key in self.data

    def __getitem__(self, key) -> Tuple[np.ndarray, int]:
        wav, sr = read_wav(self.data[key])
        return wav, sr


class NpyScpReader:
    """feats.scp pointing at .npy files: key -> ndarray."""

    def __init__(self, scp_path):
        self.data = read_2column_text(scp_path)

    def keys(self):
        return self.data.keys()

    def __len__(self):
        return len(self.data)

    def __getitem__(self, key) -> np.ndarray:
        return np.load(self.data[key])


class DatadirWriter:
    """Nested writer for Kaldi-style output dirs
    (`espnet2/fileio/datadir_writer.py`): writer["wav.scp"][uid] = path."""

    def __init__(self, root):
        self.root = Path(root)
        self._files: Dict[str, Dict[str, str]] = {}

    def __getitem__(self, name) -> Dict[str, str]:
        return self._files.setdefault(name, {})

    def close(self) -> None:
        for name, mapping in self._files.items():
            write_2column_text(self.root / name, mapping)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_rttm(path) -> Dict[str, List[Tuple[str, float, float]]]:
    """RTTM -> {utt: [(spk, tbeg, tdur), ...]} (reference
    `espnet2/fileio/rttm.py` SPEAKER line format)."""
    out: Dict[str, List[Tuple[str, float, float]]] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0] != "SPEAKER":
                continue
            utt, tbeg, tdur, spk = parts[1], float(parts[3]), float(parts[4]), parts[7]
            out.setdefault(utt, []).append((spk, tbeg, tdur))
    return out


def write_rttm(path, segments: Dict[str, List[Tuple[str, float, float]]]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for utt, segs in segments.items():
            for spk, tbeg, tdur in segs:
                f.write(
                    f"SPEAKER {utt} 1 {tbeg:.3f} {tdur:.3f} "
                    f"<NA> <NA> {spk} <NA>\n"
                )
