"""Generate the synthetic smoke corpus as a Kaldi-style data dir (port of
espnet_tpu/bin/make_synth_data.py).

Recipe stage-1 stand-in for a corpus's download and prep: tone-coded words
with deterministic wav/text pairs (`espnet_tpu_torch/data/synth.py`, a copy
of the JAX package's generator: the same seed gives the same files).

    python -m espnet_tpu_torch.bin.make_synth_data --output_dir data/train \
        --n_utts 24
"""

from __future__ import annotations

import argparse
import logging


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--n_utts", type=int, default=24)
    p.add_argument("--min_words", type=int, default=2)
    p.add_argument("--max_words", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fs", type=int, default=16000)
    p.add_argument("--n_spk", type=int, default=1,
                   help="synthetic speakers (utt2spk written when > 1)")
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = get_parser().parse_args(argv)
    from espnet_tpu_torch.data.synth import generate_corpus

    out = generate_corpus(
        args.output_dir, n_utts=args.n_utts, min_words=args.min_words,
        max_words=args.max_words, seed=args.seed, fs=args.fs,
        n_spk=args.n_spk,
    )
    logging.getLogger("espnet_tpu").info("synth corpus -> %s", out)
    return out


if __name__ == "__main__":
    main()
