# Copy of espnet_tpu/data/sampler.py (the port imports nothing of
# espnet_tpu); its imports point at the port's modules.
"""Length-bucketed batch samplers.

Behavioral spec: reference `espnet2/samplers/` (`NumElementsBatchSampler`
≈ batch_bins semantics of v1 `batchfy_by_bin` `espnet/utils/training/
batchfy.py:88`: sort by length, grow the batch while
(max_len_in_batch) * batch_size <= batch_bins; `SortedBatchSampler`,
`UnsortedBatchSampler`, `FoldedBatchSampler`) and the per-epoch seeded
shuffle of `espnet2/iterators/sequence_iter_factory.py:34`.

TPU addition: batches also carry *quantized* pad shapes so that jit
recompilation is bounded — max lengths are rounded up to the next bucket
edge (multiples of `length_quantum`), giving a small closed set of compiled
shapes per dataset.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


def quantize_length(n: int, quantum: int) -> int:
    return ((int(n) + quantum - 1) // quantum) * quantum


@dataclasses.dataclass
class Batch:
    """A batch: utterance keys + static padded shapes for each field."""

    keys: List[str]
    pad_shapes: Dict[str, int]  # field -> padded length


def build_batches(
    shapes: Dict[str, Dict[str, int]],
    batch_bins: int = 0,
    batch_size: int = 0,
    sort_in_batch: str = "descending",
    length_quantum: int = 128,
    text_quantum: int = 8,
    min_batch_size: int = 1,
    input_field: str = "speech",
    drop_oversized: bool = False,
    size_multiple: int = 1,
) -> List[Batch]:
    """shapes: field -> {key -> length}. One of batch_bins (dynamic batch
    size via numel bound over *all* fields, NumElementsBatchSampler
    semantics) or batch_size (fixed #utts) must be set.

    ``size_multiple > 1`` guarantees every batch size divides it (needed to
    shard the batch axis over a device mesh without padding): each batch is
    trimmed to the largest multiple, trimmed utterances are re-batched in a
    second pass, and a final sub-multiple remainder is dropped — at most
    size_multiple-1 utterances per epoch, the standard drop-remainder trade.
    """
    fields = list(shapes)
    keys = sorted(shapes[input_field], key=lambda k: shapes[input_field][k])
    if sort_in_batch == "descending":
        keys = keys[::-1]

    batches: List[Batch] = []
    cur: List[str] = []

    def flush():
        if not cur:
            return
        pad = {
            f: quantize_length(
                max(shapes[f][k] for k in cur),
                length_quantum if f == input_field else text_quantum,
            )
            for f in fields
        }
        batches.append(Batch(list(cur), pad))
        cur.clear()

    if batch_size:
        for k in keys:
            cur.append(k)
            if len(cur) >= batch_size:
                flush()
        flush()
    else:
        if not batch_bins:
            raise ValueError("set batch_bins or batch_size")
        for k in keys:
            cand = cur + [k]
            numel = sum(
                max(shapes[f][kk] for kk in cand) * len(cand) for f in fields
            )
            if cur and numel > batch_bins and len(cur) >= min_batch_size:
                flush()
                cand = [k]
            cur[:] = cand
        flush()
    if drop_oversized:
        batches = [b for b in batches if len(b.keys) >= min_batch_size]
    if size_multiple > 1:
        leftovers: List[str] = []
        trimmed: List[Batch] = []
        for bt in batches:
            keep = (len(bt.keys) // size_multiple) * size_multiple
            leftovers.extend(bt.keys[keep:])
            if keep:
                pad = {
                    f: quantize_length(
                        max(shapes[f][k] for k in bt.keys[:keep]),
                        length_quantum if f == input_field else text_quantum,
                    )
                    for f in fields
                }
                trimmed.append(Batch(bt.keys[:keep], pad))
        # second pass over the trimmings, grouped by length again
        for i in range(0, (len(leftovers) // size_multiple) * size_multiple,
                       size_multiple):
            grp = sorted(
                leftovers[i : i + size_multiple],
                key=lambda k: -shapes[input_field][k],
            )
            pad = {
                f: quantize_length(
                    max(shapes[f][k] for k in grp),
                    length_quantum if f == input_field else text_quantum,
                )
                for f in fields
            }
            trimmed.append(Batch(grp, pad))
        dropped = len(leftovers) % size_multiple
        if dropped:
            import logging

            logging.getLogger("espnet_tpu").info(
                "sampler: dropped %d tail utterance(s) to keep batch sizes "
                "divisible by %d", dropped, size_multiple,
            )
        batches = trimmed
    return batches


def shuffle_batches(batches: List[Batch], seed: int, epoch: int) -> List[Batch]:
    """Reproducible per-epoch batch-order shuffle (SequenceIterFactory)."""
    rng = np.random.RandomState((seed + epoch) % (2 ** 31))
    order = rng.permutation(len(batches))
    return [batches[i] for i in order]


def shard_batches(batches: List[Batch], num_shards: int) -> List[Batch]:
    """Pad the batch list to a multiple of num_shards by recycling batches
    so every data-parallel host sees the same number of steps (replaces the
    iterator-stop all-reduce of `espnet2/train/trainer.py:516`)."""
    if num_shards <= 1:
        return batches
    rem = len(batches) % num_shards
    if rem:
        batches = batches + batches[: num_shards - rem]
    return batches


def build_batches_folded(
    shapes: Dict[str, Dict[str, int]],
    batch_size: int,
    fold_lengths: Dict[str, int],
    min_batch_size: int = 1,
    length_quantum: int = 128,
    text_quantum: int = 8,
    input_field: str = "speech",
    sort_in_batch: str = "descending",
) -> List[Batch]:
    """FoldedBatchSampler semantics (`espnet2/samplers/folded_batch_sampler.py:9`):
    utterances sorted ascending by length; each batch's size is
    batch_size / (1 + max_f(len_f / fold_length_f)) — long utterances get
    proportionally smaller batches so padded numel stays bounded."""
    fields = list(shapes)
    keys = sorted(shapes[input_field], key=lambda k: shapes[input_field][k])
    batches: List[Batch] = []
    start = 0
    while start < len(keys):
        k = keys[start]
        factor = max(
            shapes[f][k] // max(fold_lengths.get(f, 1 << 30), 1)
            for f in fields
        )
        bs = max(min_batch_size, batch_size // (1 + factor))
        grp = keys[start : start + bs]
        if sort_in_batch == "descending":
            grp = grp[::-1]
        pad = {
            f: quantize_length(
                max(shapes[f][kk] for kk in grp),
                length_quantum if f == input_field else text_quantum,
            )
            for f in fields
        }
        batches.append(Batch(grp, pad))
        start += bs
    return batches


def build_batches_length(
    shapes: Dict[str, Dict[str, int]],
    batch_bins: int,
    min_batch_size: int = 1,
    padding: bool = True,
    length_quantum: int = 128,
    text_quantum: int = 8,
    input_field: str = "speech",
    sort_in_batch: str = "descending",
) -> List[Batch]:
    """LengthBatchSampler semantics (`length_batch_sampler.py:9`): grow the
    batch while the length budget holds — padding=True counts
    batch_size * max_len per field (padded bins), padding=False the raw sum
    of lengths."""
    fields = list(shapes)
    keys = sorted(shapes[input_field], key=lambda k: shapes[input_field][k])
    batches: List[Batch] = []
    cur: List[str] = []

    def flush():
        if not cur:
            return
        grp = cur[::-1] if sort_in_batch == "descending" else list(cur)
        pad = {
            f: quantize_length(
                max(shapes[f][k] for k in grp),
                length_quantum if f == input_field else text_quantum,
            )
            for f in fields
        }
        batches.append(Batch(grp, pad))
        cur.clear()

    for k in keys:
        cand = cur + [k]
        if padding:
            bins = sum(
                len(cand) * max(shapes[f][kk] for kk in cand) for f in fields
            )
        else:
            bins = sum(shapes[f][kk] for kk in cand for f in fields)
        if cur and bins > batch_bins and len(cur) >= min_batch_size:
            flush()
        cur.append(k)
    flush()
    return batches


def build_batches_unsorted(
    shapes: Dict[str, Dict[str, int]],
    batch_size: int,
    length_quantum: int = 128,
    text_quantum: int = 8,
    input_field: str = "speech",
) -> List[Batch]:
    """UnsortedBatchSampler (`unsorted_batch_sampler.py`): fixed-size
    batches in corpus order (no length sorting — the v1 "seq" batching)."""
    fields = list(shapes)
    keys = list(shapes[input_field])
    batches = []
    for i in range(0, len(keys), batch_size):
        grp = keys[i : i + batch_size]
        pad = {
            f: quantize_length(
                max(shapes[f][k] for k in grp),
                length_quantum if f == input_field else text_quantum,
            )
            for f in fields
        }
        batches.append(Batch(grp, pad))
    return batches
