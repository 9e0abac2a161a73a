# Copy of espnet_tpu/utils/typecheck.py (the port imports nothing of
# espnet_tpu); its imports point at the port's modules.
"""Batch schema validation — the reference's typeguard layer
(`espnet2/utils/types.py` + @typechecked task APIs, and the
assert_scipy_wav_style checks in `espnet2/fileio`) re-targeted at the one
boundary that matters in this framework: the host->device batch dict.

Inside jit everything is shape-checked by XLA at trace time; what XLA
can NOT diagnose helpfully is a malformed batch (wrong dtype silently
upcasting, lengths longer than the padded axis, non-contiguous object
arrays from a broken collate). `check_batch` validates those and raises
with the offending key, and is cheap enough to run on every batch
(numpy metadata only — no data pass except the lengths max).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def check_batch(batch: Dict, names: Sequence[str] = ()) -> None:
    """Validate a collated batch dict. Rules:

    - every value is a numpy/JAX array (no object dtype, no lists)
    - all leading (batch) dimensions agree
    - every `<name>_lengths` is int32/int64, rank 1 (one length per item)
      or rank 2 (per-stream/per-speaker lengths, (B, n_streams) — asr_mix
      collates `text_spk_lengths` as (B, n_spk) and mulenc collates
      `speech_stream_lengths` as (B, n_enc), mirroring the reference's
      CustomConverter in `espnet/asr/pytorch_backend/asr_mix.py`), and its
      max does not exceed the padded axis of `<name>`
    - floating payloads are float32/bfloat16/float16 (a float64 batch means
      a collate bug and would silently double every transfer)
    """
    b = None
    for k, v in batch.items():
        if k == "keys":
            continue
        if not hasattr(v, "shape") or not hasattr(v, "dtype"):
            raise TypeError(f"batch[{k!r}] is {type(v).__name__}, not an array")
        if v.dtype == object:
            raise TypeError(f"batch[{k!r}] has object dtype (ragged collate?)")
        if v.ndim == 0:
            raise TypeError(f"batch[{k!r}] is a scalar; batches are (B, ...)")
        if b is None:
            b = v.shape[0]
        elif v.shape[0] != b:
            raise ValueError(
                f"batch[{k!r}] batch dim {v.shape[0]} != {b} of other keys")
        if np.issubdtype(v.dtype, np.floating) and v.dtype.itemsize > 4:
            raise TypeError(
                f"batch[{k!r}] is {v.dtype}; float64 batches double every "
                "host->device transfer — cast in the dataset/collate")
    for k, v in batch.items():
        if not k.endswith("_lengths"):
            continue
        if not np.issubdtype(np.asarray(v).dtype, np.integer):
            raise TypeError(f"batch[{k!r}] must be integer, got {v.dtype}")
        if v.ndim not in (1, 2):
            raise ValueError(
                f"batch[{k!r}] must be rank 1 (per-item) or rank 2 "
                f"(per-stream, (B, n)), got {v.shape}")
        base = k[: -len("_lengths")]
        # rank-1 lengths pad along payload axis 1; rank-2 (per-stream)
        # lengths pad along the payload's time axis, which is also axis 1
        # for the (B, T, n_streams) layouts used here — only validate when
        # the payload has such an axis.
        if base in batch and batch[base].ndim >= v.ndim + 1:
            mx = int(np.max(np.asarray(v))) if v.size else 0
            t = batch[base].shape[1]
            if mx > t:
                raise ValueError(
                    f"batch[{k!r}] max {mx} exceeds padded axis "
                    f"{base}.shape[1] = {t}")
    if names:
        missing = [n for n in names if n not in batch]
        if missing:
            raise KeyError(f"batch missing required keys {missing}; "
                           f"has {sorted(batch)}")
