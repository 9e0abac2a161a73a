"""Split scp-style files into N shards, line j to shard j mod N (port of
espnet_tpu/bin/split_scps.py).

    python -m espnet_tpu_torch.bin.split_scps --scps data/test/wav.scp \
        --num_splits 4 --output_dir exp/split
"""

from __future__ import annotations

import argparse
from pathlib import Path


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scps", nargs="+", required=True)
    p.add_argument("--num_splits", type=int, required=True)
    p.add_argument("--output_dir", required=True)
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)
    out = Path(args.output_dir)
    n = args.num_splits
    for scp in args.scps:
        lines = Path(scp).read_text(encoding="utf-8").splitlines()
        name = Path(scp).name
        for i in range(n):
            d = out / f"split.{i}"
            d.mkdir(parents=True, exist_ok=True)
            shard = [ln for j, ln in enumerate(lines) if j % n == i]
            (d / name).write_text("\n".join(shard) + "\n", encoding="utf-8")
    (out / "num_splits").write_text(str(n) + "\n")
    return out


if __name__ == "__main__":
    main()
