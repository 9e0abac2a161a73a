"""Pack a trained experiment into a portable zip, or unpack one (port of
espnet_tpu/bin/pack.py; `espnet2/bin/pack.py`). The zip holds the files
either package reads: config, token list, BPE model, params and the
feature statistics.

    python -m espnet_tpu_torch.bin.pack --exp_dir exp/asr --output model.zip
    python -m espnet_tpu_torch.bin.pack --unpack model.zip \
        --output_dir exp/asr2
"""

from __future__ import annotations

import argparse
import zipfile
from pathlib import Path

PACK_GLOBS = ("config.yaml", "tokens.txt", "src_tokens.txt", "bpe.json",
              "*.params.msgpack", "*.msgpack", "stats/feats_stats.npz",
              "km_centroids.npy")


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--exp_dir")
    p.add_argument("--output")
    p.add_argument("--unpack")
    p.add_argument("--output_dir")
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.unpack:
        out = Path(args.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        with zipfile.ZipFile(args.unpack) as z:
            z.extractall(out)
        return out
    exp = Path(args.exp_dir)
    files = []
    for pat in PACK_GLOBS:
        files.extend(exp.glob(pat))
    files = sorted(set(files))
    with zipfile.ZipFile(args.output, "w", zipfile.ZIP_DEFLATED) as z:
        for f in files:
            z.write(f, f.relative_to(exp))
    return Path(args.output)


if __name__ == "__main__":
    main()
