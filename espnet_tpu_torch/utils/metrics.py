# Copy of espnet_tpu/utils/metrics.py; the native scorer is the port's own
# copy of the C++ source (espnet_tpu_torch/native/edit_distance.cpp).
"""Error-rate scoring (WER/CER) with sclite-style aggregate reports.

Behavioral spec: the reference scores with SCTK sclite in recipes
(`egs/mini_an4/asr1/run.sh:307`) and computes training-time CER/WER with
`espnet/nets/e2e_asr_common.py:100` (ErrorCalculator: editdistance over
token sequences). Pure-python Levenshtein with S/D/I breakdown.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple


@dataclasses.dataclass
class EditStats:
    hits: int = 0
    substitutions: int = 0
    deletions: int = 0
    insertions: int = 0

    @property
    def ref_len(self) -> int:
        return self.hits + self.substitutions + self.deletions

    @property
    def errors(self) -> int:
        return self.substitutions + self.deletions + self.insertions

    @property
    def error_rate(self) -> float:
        return self.errors / max(self.ref_len, 1)

    def __add__(self, o: "EditStats") -> "EditStats":
        return EditStats(
            self.hits + o.hits,
            self.substitutions + o.substitutions,
            self.deletions + o.deletions,
            self.insertions + o.insertions,
        )


def _native_lib():
    from espnet_tpu_torch.native import load_library

    lib = load_library("editdist", ["edit_distance.cpp"])
    if lib is not None and not getattr(lib, "_sigs_set", False):
        import ctypes

        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.edit_distance_batch.argtypes = [
            i32p, i32p, i32p, i32p, ctypes.c_int32, i32p,
        ]
        lib.edit_distance_batch.restype = None
        lib._sigs_set = True
    return lib


def batch_edit_stats(
    refs: List[Sequence], hyps: List[Sequence]
) -> List[EditStats]:
    """Score many (ref, hyp) pairs at once — native C++ kernel
    (`native/edit_distance.cpp`, the sclite/sctk replacement) with a
    pure-python fallback."""
    lib = _native_lib()
    if lib is None:
        return [edit_distance(r, h) for r, h in zip(refs, hyps)]
    import ctypes

    import numpy as np

    vocab: Dict = {}

    def ids(seq):
        return [vocab.setdefault(tok, len(vocab)) for tok in seq]

    ref_ids = [ids(r) for r in refs]
    hyp_ids = [ids(h) for h in hyps]
    ref_flat = np.asarray(sum(ref_ids, []), np.int32)
    hyp_flat = np.asarray(sum(hyp_ids, []), np.int32)
    ref_off = np.cumsum([0] + [len(r) for r in ref_ids]).astype(np.int32)
    hyp_off = np.cumsum([0] + [len(h) for h in hyp_ids]).astype(np.int32)
    counts = np.zeros((len(refs), 4), np.int32)
    p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    # guard: numpy arrays of size 0 still expose a valid pointer
    ref_flat = np.ascontiguousarray(ref_flat) if ref_flat.size else np.zeros(1, np.int32)
    hyp_flat = np.ascontiguousarray(hyp_flat) if hyp_flat.size else np.zeros(1, np.int32)
    lib.edit_distance_batch(
        p(ref_flat), p(ref_off), p(hyp_flat), p(hyp_off),
        np.int32(len(refs)), p(counts),
    )
    return [EditStats(int(h), int(s), int(d), int(i))
            for h, s, d, i in counts]


def edit_distance(ref: Sequence, hyp: Sequence) -> EditStats:
    """Levenshtein alignment with S/D/I counts (DP over (len_ref, len_hyp))."""
    n, m = len(ref), len(hyp)
    # dp[i][j] = (cost, hits, subs, dels, ins)
    prev = [(j, 0, 0, 0, j) for j in range(m + 1)]
    for i in range(1, n + 1):
        cur = [(i, 0, 0, i, 0)]
        for j in range(1, m + 1):
            if ref[i - 1] == hyp[j - 1]:
                c, h, s, d, ins = prev[j - 1]
                best = (c, h + 1, s, d, ins)
            else:
                c, h, s, d, ins = prev[j - 1]
                best = (c + 1, h, s + 1, d, ins)
            c, h, s, d, ins = prev[j]
            cand = (c + 1, h, s, d + 1, ins)
            if cand[0] < best[0]:
                best = cand
            c, h, s, d, ins = cur[j - 1]
            cand = (c + 1, h, s, d, ins + 1)
            if cand[0] < best[0]:
                best = cand
            cur.append(best)
        prev = cur
    _, h, s, d, ins = prev[m]
    return EditStats(h, s, d, ins)


def corpus_error_rate(
    refs: Dict[str, Sequence], hyps: Dict[str, Sequence]
) -> Tuple[float, EditStats]:
    keys = list(refs)
    stats = batch_edit_stats(
        [refs[k] for k in keys], [hyps.get(k, []) for k in keys]
    )
    total = EditStats()
    for s in stats:
        total = total + s
    return total.error_rate, total


def sclite_report(refs: Dict[str, Sequence], hyps: Dict[str, Sequence]) -> str:
    """Aggregate report in the spirit of sclite's SYSTEM SUMMARY table."""
    keys = list(refs)
    per_utt = batch_edit_stats(
        [refs[k] for k in keys], [hyps.get(k, []) for k in keys]
    )
    t = EditStats()
    for s in per_utt:
        t = t + s
    rate = t.error_rate
    n_sent = len(refs)
    err_sent = sum(1 for s in per_utt if s.errors > 0)
    return (
        f"| # Snt {n_sent} | # Wrd {t.ref_len} | "
        f"Corr {100 * t.hits / max(t.ref_len, 1):.1f} | "
        f"Sub {100 * t.substitutions / max(t.ref_len, 1):.1f} | "
        f"Del {100 * t.deletions / max(t.ref_len, 1):.1f} | "
        f"Ins {100 * t.insertions / max(t.ref_len, 1):.1f} | "
        f"Err {100 * rate:.1f} | "
        f"S.Err {100 * err_sent / max(n_sent, 1):.1f} |"
    )
