"""Train a back-off n-gram LM on a data dir's text into an ARPA file (port
of espnet_tpu/bin/ngram_train.py; the recipe's stage 7, `asr.sh` stage 9
of the reference). Usage:

    python -m espnet_tpu_torch.bin.ngram_train --data_dir data/train \
        --exp_dir exp/asr --output exp/ngram.arpa --order 3

The tokens are those of the ASR experiment `--exp_dir` (its tokenizer), or
of `--token_type` (char, word or bpe with `--bpe_model`) without one. Same
flags and the same ARPA file, byte for byte, as the JAX package's CLI; the
host does all the work (no `--device`).
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

logger = logging.getLogger("espnet_tpu")


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--exp_dir", default=None,
                   help="ASR exp dir providing tokenizer + token list")
    p.add_argument("--token_type", default=None,
                   help="tokenize directly (char/word/bpe) without an exp dir")
    p.add_argument("--bpe_model", default=None)
    p.add_argument("--output", required=True)
    p.add_argument("--order", type=int, default=3)
    p.add_argument("--add_k", type=float, default=0.1)
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = get_parser().parse_args(argv)
    from espnet_tpu_torch.data.fileio import read_2column_text
    from espnet_tpu_torch.lm.ngram import NgramModel
    from espnet_tpu_torch.tasks.asr import ASRTask

    if args.token_type:
        from espnet_tpu_torch.data.tokenizer import build_tokenizer

        tokenizer = build_tokenizer(args.token_type, args.bpe_model)
    else:
        exp = Path(args.exp_dir)
        cfg = ASRTask.load_config(exp)
        tokenizer = ASRTask.build_tokenizer(cfg["data"], exp)
    texts = read_2column_text(Path(args.data_dir) / "text")
    sents = [tokenizer.text2tokens(t) for t in texts.values()]
    model = NgramModel.train(sents, order=args.order, add_k=args.add_k)
    model.save_arpa(args.output)
    logger.info("ngram (order %d) -> %s: %s", args.order, args.output,
                ", ".join(f"{len(t)} {n+1}-grams"
                          for n, t in enumerate(model.tables)))
    return args.output


if __name__ == "__main__":
    main()
