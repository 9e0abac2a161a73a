# Copy of espnet_tpu/data/flac.py (the port imports nothing of
# espnet_tpu); its imports point at the port's modules.
"""Native FLAC reader/writer (no external deps).

LibriSpeech ships FLAC-compressed audio; the reference decodes it with the
`flac` binary at data-prep time (`egs2/librispeech_100/asr1/local/
data_prep.sh:17`) or sox/soundfile at load time. Neither binary nor any
python audio package is in this image, so this module implements the
subset of the FLAC format (RFC 9639) that real LibriSpeech files use —
which is in fact the full mono/stereo 8/16/24-bit decode path:

* STREAMINFO parsing (sample rate / channels / bits / total samples) —
  used by `fileio.wav_duration` for recipe duration filtering without
  decoding;
* frame decoding with all four subframe types (CONSTANT, VERBATIM,
  FIXED order 0-4, LPC order 1-32), Rice/Rice2 residual coding incl.
  escape partitions, wasted bits, and all stereo decorrelation modes
  (independent, left/side, right/side, mid/side).

The encoder writes VERBATIM subframes only (a valid, if uncompressed,
FLAC stream) — enough to fabricate miniature LibriSpeech layouts for
dry-run tests (`tests/test_prep_librispeech.py`).

Performance note: this is a readiness/correctness implementation in
python + numpy (bit plumbing is per-sample). Production ingestion of a
real 100h corpus should route through the format stage once (decode to
wav/ark), which the recipe's format stage does anyway — decode speed is
then a one-off prep cost, not a training-loop cost.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Tuple

import numpy as np


class _BitReader:
    """MSB-first bit reader over a bytes buffer."""

    __slots__ = ("data", "pos", "bit")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos          # byte position
        self.bit = 0            # bit position within byte (0 = MSB)

    def read(self, n: int) -> int:
        """Read n bits as an unsigned int."""
        out = 0
        data, pos, bit = self.data, self.pos, self.bit
        while n > 0:
            avail = 8 - bit
            take = min(n, avail)
            byte = data[pos]
            out = (out << take) | ((byte >> (avail - take)) & ((1 << take) - 1))
            bit += take
            n -= take
            if bit == 8:
                bit = 0
                pos += 1
        self.pos, self.bit = pos, bit
        return out

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        if v >= 1 << (n - 1):
            v -= 1 << n
        return v

    def read_unary(self) -> int:
        """Count 0 bits until the terminating 1 bit."""
        count = 0
        data, pos, bit = self.data, self.pos, self.bit
        while True:
            byte = data[pos]
            rest = byte & ((1 << (8 - bit)) - 1)
            if rest == 0:
                count += 8 - bit
                pos += 1
                bit = 0
                continue
            # highest set bit within the remaining bits
            top = rest.bit_length() - 1          # bit index from LSB
            zeros = (8 - bit - 1) - top
            count += zeros
            bit += zeros + 1
            if bit == 8:
                bit = 0
                pos += 1
            self.pos, self.bit = pos, bit
            return count

    def align(self):
        if self.bit:
            self.bit = 0
            self.pos += 1


def _read_utf8_number(br: _BitReader) -> int:
    """FLAC frame-header UTF-8-style coded number (up to 36 bits)."""
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n = 0
    mask = 0x40
    while b0 & mask:
        n += 1
        mask >>= 1
    v = b0 & (mask - 1)
    for _ in range(n):
        v = (v << 6) | (br.read(8) & 0x3F)
    return v


_BLOCKSIZE_CODES = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
    13: 8192, 14: 16384, 15: 32768,
}
_RATE_CODES = {
    1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
    7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000,
}
_SIZE_CODES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

_FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def _decode_residual(br: _BitReader, n: int, order: int) -> np.ndarray:
    method = br.read(2)
    if method not in (0, 1):
        raise ValueError(f"unsupported residual method {method}")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    porder = br.read(4)
    nparts = 1 << porder
    out = np.empty(n - order, np.int64)
    idx = 0
    psize = n >> porder
    for p in range(nparts):
        cnt = psize - order if p == 0 else psize
        param = br.read(plen)
        if param == escape:
            bits = br.read(5)
            if bits == 0:
                out[idx: idx + cnt] = 0
            else:
                for i in range(cnt):
                    out[idx + i] = br.read_signed(bits)
        else:
            for i in range(cnt):
                q = br.read_unary()
                r = br.read(param) if param else 0
                v = (q << param) | r
                out[idx + i] = (v >> 1) ^ -(v & 1)  # zigzag
        idx += cnt
    return out


def _decode_subframe(br: _BitReader, n: int, bps: int) -> np.ndarray:
    if br.read(1) != 0:
        raise ValueError("invalid subframe padding bit")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.read_unary()
        bps -= wasted
    if stype == 0:            # CONSTANT
        v = br.read_signed(bps)
        out = np.full(n, v, np.int64)
    elif stype == 1:          # VERBATIM
        out = np.empty(n, np.int64)
        for i in range(n):
            out[i] = br.read_signed(bps)
    elif 8 <= stype <= 12:    # FIXED order 0-4
        order = stype - 8
        warm = [br.read_signed(bps) for _ in range(order)]
        res = _decode_residual(br, n, order)
        out = np.empty(n, np.int64)
        out[:order] = warm
        coefs = _FIXED_COEFFS[order]
        for i in range(order, n):
            pred = 0
            for j, c in enumerate(coefs):
                pred += c * out[i - 1 - j]
            out[i] = res[i - order] + pred
    elif stype >= 32:         # LPC order 1-32
        order = (stype & 31) + 1
        warm = [br.read_signed(bps) for _ in range(order)]
        prec = br.read(4) + 1
        if prec == 16:
            raise ValueError("invalid LPC precision escape")
        shift = br.read_signed(5)
        coefs = [br.read_signed(prec) for _ in range(order)]
        res = _decode_residual(br, n, order)
        out = np.empty(n, np.int64)
        out[:order] = warm
        for i in range(order, n):
            pred = 0
            for j in range(order):
                pred += coefs[j] * out[i - 1 - j]
            out[i] = res[i - order] + (pred >> shift)
    else:
        raise ValueError(f"reserved subframe type {stype}")
    if wasted:
        out <<= wasted
    return out


def read_flac(path) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file -> (float32 array in [-1, 1] (N,) or (N, C), sr)."""
    data = Path(path).read_bytes()
    if data[:4] != b"fLaC":
        raise ValueError(f"{path}: not a FLAC stream")
    pos = 4
    sr = channels = bps = total = None
    while True:
        hdr = data[pos]
        last = hdr & 0x80
        btype = hdr & 0x7F
        blen = int.from_bytes(data[pos + 1: pos + 4], "big")
        body = data[pos + 4: pos + 4 + blen]
        if btype == 0:  # STREAMINFO
            br = _BitReader(body)
            br.read(16)  # min blocksize
            br.read(16)  # max blocksize
            br.read(24)
            br.read(24)
            sr = br.read(20)
            channels = br.read(3) + 1
            bps = br.read(5) + 1
            total = br.read(36)
        pos += 4 + blen
        if last:
            break
    if sr is None:
        raise ValueError(f"{path}: missing STREAMINFO")

    chans = [np.empty(0, np.int64) for _ in range(channels)]
    parts = [[] for _ in range(channels)]
    while pos < len(data) - 2:
        br = _BitReader(data, pos)
        sync = br.read(14)
        if sync != 0b11111111111110:
            raise ValueError(f"{path}: lost frame sync at byte {pos}")
        br.read(1)   # reserved
        br.read(1)   # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        ch_code = br.read(4)
        sz_code = br.read(3)
        br.read(1)   # reserved
        _read_utf8_number(br)
        if bs_code == 6:
            blocksize = br.read(8) + 1
        elif bs_code == 7:
            blocksize = br.read(16) + 1
        else:
            blocksize = _BLOCKSIZE_CODES[bs_code]
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        frame_bps = _SIZE_CODES.get(sz_code, bps)
        br.read(8)   # header CRC
        if ch_code < 8:
            nch = ch_code + 1
            subs = [_decode_subframe(br, blocksize, frame_bps)
                    for _ in range(nch)]
        elif ch_code == 8:    # left/side
            left = _decode_subframe(br, blocksize, frame_bps)
            side = _decode_subframe(br, blocksize, frame_bps + 1)
            subs = [left, left - side]
        elif ch_code == 9:    # right/side
            side = _decode_subframe(br, blocksize, frame_bps + 1)
            right = _decode_subframe(br, blocksize, frame_bps)
            subs = [right + side, right]
        elif ch_code == 10:   # mid/side
            mid = _decode_subframe(br, blocksize, frame_bps)
            side = _decode_subframe(br, blocksize, frame_bps + 1)
            m2 = (mid << 1) | (side & 1)
            subs = [(m2 + side) >> 1, (m2 - side) >> 1]
        else:
            raise ValueError(f"reserved channel assignment {ch_code}")
        for c in range(channels):
            parts[c].append(subs[c])
        br.align()
        pos = br.pos + 2  # skip frame CRC-16

    chans = [np.concatenate(p) if p else np.empty(0, np.int64)
             for p in parts]
    out = np.stack(chans, axis=-1) if channels > 1 else chans[0]
    if total:
        out = out[:total]
    scale = float(1 << (bps - 1))
    wav = (out.astype(np.float32) / scale)
    return wav, sr


def flac_info(path) -> Tuple[int, int, int, int]:
    """(sample_rate, channels, bits_per_sample, total_samples) from
    STREAMINFO only — no decode (duration filtering)."""
    with open(path, "rb") as fh:
        if fh.read(4) != b"fLaC":
            raise ValueError(f"{path}: not a FLAC stream")
        while True:
            hdr = fh.read(4)
            last = hdr[0] & 0x80
            btype = hdr[0] & 0x7F
            blen = int.from_bytes(hdr[1:4], "big")
            body = fh.read(blen)
            if btype == 0:
                br = _BitReader(body)
                br.read(16 + 16 + 24 + 24)
                sr = br.read(20)
                ch = br.read(3) + 1
                bps = br.read(5) + 1
                total = br.read(36)
                return sr, ch, bps, total
            if last:
                break
    raise ValueError(f"{path}: missing STREAMINFO")


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, n: int):
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def align(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)


_CRC8_POLY = 0x07
_CRC16_POLY = 0x8005


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ _CRC8_POLY) & 0xFF if crc & 0x80 \
                else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ _CRC16_POLY) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
    return crc


def _write_rice_residual(bw: "_BitWriter", res: np.ndarray) -> None:
    """Residual coding method 0 (4-bit Rice), partition order 0."""
    bw.write(0, 2)
    bw.write(0, 4)  # partition order 0
    zz = (np.abs(res.astype(np.int64)) << 1) - (res < 0).astype(np.int64)
    mean = max(float(np.mean(zz)), 1.0)
    param = min(14, max(0, int(np.log2(mean + 1))))
    bw.write(param, 4)
    for v in zz:
        q = int(v) >> param
        bw.write(0, q) if q else None
        bw.write(1, 1)
        if param:
            bw.write(int(v) & ((1 << param) - 1), param)


def write_flac(path, wav: np.ndarray, sr: int = 16000,
               block: int = 4096, mode: str = "verbatim") -> None:
    """Write a FLAC stream; 16-bit samples.

    mode="verbatim": uncompressed VERBATIM subframes.
    mode="fixed": FIXED order-2 predictor + Rice residuals (exercises the
    decoder's predictor/Rice path and actually compresses).
    wav: float array in [-1, 1], (N,) or (N, C)."""
    wav = np.asarray(wav)
    if wav.ndim == 1:
        wav = wav[:, None]
    n, ch = wav.shape
    pcm = np.clip(np.round(wav * 32767.0), -32768, 32767).astype(np.int32)

    out = bytearray(b"fLaC")
    si = _BitWriter()
    si.write(block, 16)
    si.write(block, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(sr, 20)
    si.write(ch - 1, 3)
    si.write(15, 5)  # 16 bps - 1
    si.write(n, 36)
    si.align()
    body = bytes(si.buf) + b"\x00" * 16  # zero MD5 (unverified, legal)
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body

    frame_idx = 0
    for start in range(0, n, block):
        bs = min(block, n - start)
        hw = _BitWriter()
        hw.write(0b11111111111110, 14)
        hw.write(0, 1)
        hw.write(0, 1)   # fixed blocksize strategy
        hw.write(7, 4)   # blocksize: 16-bit at end of header
        hw.write(5 if sr == 16000 else 0, 4)
        hw.write(ch - 1, 4)
        hw.write(4, 3)   # 16 bps
        hw.write(0, 1)
        # UTF-8 frame number
        fi = frame_idx
        if fi < 0x80:
            hw.write(fi, 8)
        else:
            hw.write(0xC0 | (fi >> 6), 8)
            hw.write(0x80 | (fi & 0x3F), 8)
        hw.write(bs - 1, 16)
        hw.align()
        hdr = bytes(hw.buf)
        hdr += bytes([_crc8(hdr)])

        bw = _BitWriter()
        for c in range(ch):
            seg = pcm[start: start + bs, c].astype(np.int64)
            bw.write(0, 1)
            if mode == "fixed" and bs > 2:
                bw.write(8 + 2, 6)   # FIXED order 2
                bw.write(0, 1)
                bw.write(int(seg[0]), 16)
                bw.write(int(seg[1]), 16)
                res = seg[2:] - (2 * seg[1:-1] - seg[:-2])
                _write_rice_residual(bw, res)
            else:
                bw.write(1, 6)   # VERBATIM
                bw.write(0, 1)
                for i in range(bs):
                    bw.write(int(seg[i]), 16)
        bw.align()
        frame = hdr + bytes(bw.buf)
        frame += struct.pack(">H", _crc16(frame))
        out += frame
        frame_idx += 1

    Path(path).write_bytes(bytes(out))
