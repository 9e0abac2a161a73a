"""Score separated or enhanced audio against references (port of
espnet_tpu/bin/enh_scoring.py; reference `espnet2/bin/enh_scoring.py`).

Per utterance, the speaker permutation with the best mean SI-SNR (the
first strictly greater one in `itertools.permutations` order, as in JAX),
then STOI, ESTOI, SI-SNR, SDR and pesq_py (the P.862-structured
approximation, not ITU PESQ) under it; one file per metric (`STOI`,
`ESTOI`, `SI_SNR`, `SDR`, `PESQ_PY`: "<key> <score>") and their means in
`RESULTS`, as the JAX CLI writes them. numpy only (`utils/se_metrics.py`).

    python -m espnet_tpu_torch.bin.enh_scoring --output_dir score \
        --ref_scp data/spk1.scp --ref_scp data/spk2.scp \
        --inf_scp sep/spk1.scp --inf_scp sep/spk2.scp
"""

from __future__ import annotations

import argparse
import itertools
import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger("espnet_tpu")

METRICS = ("stoi", "estoi", "si_snr", "sdr", "pesq_py")


def _read_scp(path):
    out = {}
    for line in Path(path).read_text().splitlines():
        if line.strip():
            k, v = line.split(maxsplit=1)
            out[k] = v
    return out


def score_utterance(refs, infs, fs):
    """Best-permutation mean scores: ({metric: value}, perm)."""
    from espnet_tpu_torch.utils import se_metrics as M

    n = len(refs)
    best = None
    for perm in itertools.permutations(range(n)):
        si = np.mean([M.si_snr(refs[i], infs[perm[i]]) for i in range(n)])
        if best is None or si > best[0]:
            best = (si, perm)
    perm = best[1]
    out = {}
    for m in METRICS:
        fn = getattr(M, m)
        vals = []
        for i in range(n):
            if m in ("stoi", "estoi", "pesq_py"):
                vals.append(fn(refs[i], infs[perm[i]], fs))
            else:
                vals.append(fn(refs[i], infs[perm[i]]))
        out[m] = float(np.mean(vals))
    return out, perm


def main(argv=None) -> None:
    from espnet_tpu_torch.data.fileio import read_wav

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--ref_scp", action="append", required=True)
    p.add_argument("--inf_scp", action="append", required=True)
    p.add_argument("--fs", type=int, default=16000)
    args = p.parse_args(argv)
    if len(args.ref_scp) != len(args.inf_scp):
        p.error("need as many --inf_scp as --ref_scp")

    refs = [_read_scp(s) for s in args.ref_scp]
    infs = [_read_scp(s) for s in args.inf_scp]
    keys = sorted(set(refs[0]) & set(infs[0]))
    if not keys:
        raise SystemExit("no common utterance keys between ref and inf scps")

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    per_metric = {m: {} for m in METRICS}
    for key in keys:
        r = [read_wav(s[key])[0].astype(np.float64) for s in refs]
        i = [read_wav(s[key])[0].astype(np.float64) for s in infs]
        scores, _ = score_utterance(r, i, args.fs)
        for m, v in scores.items():
            per_metric[m][key] = v
    lines = []
    for m in METRICS:
        with open(out / f"{m.upper()}", "w") as f:
            for key in keys:
                f.write(f"{key} {per_metric[m][key]:.4f}\n")
        vals = [v for v in per_metric[m].values() if np.isfinite(v)]
        mean = float(np.mean(vals)) if vals else float("nan")
        lines.append(f"{m.upper()}: {mean:.4f}")
        logger.info("%s mean: %.4f over %d utts", m.upper(), mean, len(vals))
    (out / "RESULTS").write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
