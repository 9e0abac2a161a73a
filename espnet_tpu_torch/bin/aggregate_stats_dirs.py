"""Merge per-split collect-stats outputs (port of
espnet_tpu/bin/aggregate_stats_dirs.py).

    python -m espnet_tpu_torch.bin.aggregate_stats_dirs \
        --input_dirs exp/stats.1 exp/stats.2 --output_dir exp/stats
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_dirs", nargs="+", required=True)
    p.add_argument("--output_dir", required=True)
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    count = 0
    total = None
    total_sq = None
    for d in args.input_dirs:
        with np.load(Path(d) / "feats_stats.npz") as z:
            count += int(z["count"])
            s = z["sum"]
            sq = z["sum_square"]
        total = s if total is None else total + s
        total_sq = sq if total_sq is None else total_sq + sq
    np.savez(out / "feats_stats.npz", count=np.asarray(count),
             sum=total, sum_square=total_sq)
    return out


if __name__ == "__main__":
    main()
