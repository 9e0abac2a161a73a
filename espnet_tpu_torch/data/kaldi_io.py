# Copy of espnet_tpu/data/kaldi_io.py (the port imports nothing of
# espnet_tpu); its imports point at the port's modules.
"""Kaldi binary ark/scp and HDF5 feature IO (dependency-free).

Behavioral spec: reference data loading through `kaldiio`
(`espnet/utils/io_utils.py:461` _get_from_loader types "mat"/"scp",
`espnet2/train/dataset.py` kaldi_ark loader) and HDF5
(`io_utils.py:561` SoundHDF5File, `dataset.py:88` H5FileWrapper).

Supported Kaldi formats: binary float/double matrices ("FM"/"DM") and
vectors ("FV"/"DV") with the standard "\\0B" marker and
"\\x04"+int32 dimension tokens — the formats Kaldi's copy-feats writes by
default. Compressed matrices ("CM*") are intentionally not parsed (run
copy-feats without --compress); the error says so explicitly instead of
mis-decoding.

scp lines use Kaldi's `key path.ark:offset` syntax; HDF5 uses
`key path.h5:dataset` (the espnet2 convention).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Iterator, Tuple

import numpy as np

from espnet_tpu_torch.data.fileio import read_2column_text


def _read_token(f) -> str:
    tok = b""
    while True:
        c = f.read(1)
        if not c or c == b" ":
            break
        tok += c
    return tok.decode()


def _read_basic_int(f) -> int:
    size = f.read(1)[0]
    if size != 4:
        raise ValueError(f"unexpected int size byte {size}")
    return struct.unpack("<i", f.read(4))[0]


def read_kaldi_mat(f) -> np.ndarray:
    """Read one matrix/vector at the current position (after the key)."""
    marker = f.read(2)
    if marker != b"\0B":
        raise ValueError(
            "text-format ark not supported here (missing \\0B marker)"
        )
    tok = _read_token(f)
    if tok.startswith("CM"):
        raise ValueError(
            "compressed Kaldi matrices (CM*) are not supported; re-run "
            "copy-feats without --compress"
        )
    if tok in ("FM", "DM"):
        rows = _read_basic_int(f)
        cols = _read_basic_int(f)
        dtype = np.float32 if tok == "FM" else np.float64
        data = np.frombuffer(f.read(rows * cols * dtype().itemsize), dtype)
        return data.reshape(rows, cols).astype(np.float32)
    if tok in ("FV", "DV"):
        n = _read_basic_int(f)
        dtype = np.float32 if tok == "FV" else np.float64
        return np.frombuffer(f.read(n * dtype().itemsize), dtype).astype(
            np.float32
        )
    raise ValueError(f"unsupported Kaldi binary token {tok!r}")


def write_kaldi_mat(f, mat: np.ndarray) -> None:
    mat = np.asarray(mat, np.float32)
    f.write(b"\0B")
    if mat.ndim == 2:
        f.write(b"FM ")
        f.write(b"\x04" + struct.pack("<i", mat.shape[0]))
        f.write(b"\x04" + struct.pack("<i", mat.shape[1]))
    elif mat.ndim == 1:
        f.write(b"FV ")
        f.write(b"\x04" + struct.pack("<i", mat.shape[0]))
    else:
        raise ValueError("only 1-D/2-D arrays")
    f.write(mat.tobytes())


class KaldiScpReader:
    """feats.scp with `key ark:offset` entries -> float32 ndarray."""

    def __init__(self, scp_path):
        self.data = read_2column_text(scp_path)

    def keys(self):
        return self.data.keys()

    def __len__(self):
        return len(self.data)

    def __contains__(self, key):
        return key in self.data

    def __getitem__(self, key) -> np.ndarray:
        entry = self.data[key]
        path, _, offset = entry.rpartition(":")
        with open(path, "rb") as f:
            f.seek(int(offset))
            return read_kaldi_mat(f)


def read_kaldi_ark(path) -> Iterator[Tuple[str, np.ndarray]]:
    """Stream (key, matrix) pairs from a binary ark file."""
    with open(path, "rb") as f:
        while True:
            key = b""
            while True:
                c = f.read(1)
                if not c:
                    return
                if c == b" ":
                    break
                key += c
            yield key.decode(), read_kaldi_mat(f)


def write_kaldi_ark_scp(
    mats: Dict[str, np.ndarray], ark_path, scp_path=None
) -> Dict[str, str]:
    """Write a binary ark (+ scp with offsets). Returns the scp mapping."""
    ark_path = Path(ark_path)
    ark_path.parent.mkdir(parents=True, exist_ok=True)
    scp: Dict[str, str] = {}
    with open(ark_path, "wb") as f:
        for key, mat in mats.items():
            f.write(key.encode() + b" ")
            scp[key] = f"{ark_path}:{f.tell()}"
            write_kaldi_mat(f, mat)
    if scp_path:
        from espnet_tpu_torch.data.fileio import write_2column_text

        write_2column_text(scp_path, scp)
    return scp


class H5ScpReader:
    """feats.scp with `key file.h5:dataset` entries (espnet2 hdf5 type)."""

    def __init__(self, scp_path):
        self.data = read_2column_text(scp_path)
        self._files: Dict[str, "object"] = {}

    def keys(self):
        return self.data.keys()

    def __len__(self):
        return len(self.data)

    def __contains__(self, key):
        return key in self.data

    def _file(self, path):
        if path not in self._files:
            import h5py

            self._files[path] = h5py.File(path, "r")
        return self._files[path]

    def __getitem__(self, key) -> np.ndarray:
        entry = self.data[key]
        path, _, dset = entry.rpartition(":")
        return np.asarray(self._file(path)[dset], np.float32)


def open_feats_scp(scp_path):
    """Dispatch on the scp's entry style: `.npy` paths -> NpyScpReader,
    `ark:offset` -> KaldiScpReader, `.h5:key` -> H5ScpReader."""
    from espnet_tpu_torch.data.fileio import NpyScpReader

    first = next(iter(read_2column_text(scp_path).values()), "")
    if first.endswith(".npy"):
        return NpyScpReader(scp_path)
    path = first.rpartition(":")[0]
    if path.endswith((".h5", ".hdf5")):
        return H5ScpReader(scp_path)
    if ":" in first:
        return KaldiScpReader(scp_path)
    return NpyScpReader(scp_path)
