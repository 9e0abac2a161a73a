"""Build the token list (and BPE model) from a training text (port of
espnet_tpu/bin/build_token_list.py).

Recipe stage 5 (`egs2/TEMPLATE/asr1/asr.sh:730-790`). Writes
`<output_dir>/tokens.txt` (and `bpe.json` for token_type bpe, which needs
the HF `tokenizers` package: without it the CLI raises an ImportError that
says so).

    python -m espnet_tpu_torch.bin.build_token_list \
        --text data/train/text --output_dir exp/tokens --token_type char
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

logger = logging.getLogger("espnet_tpu")


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--text", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--token_type", default="char",
                   choices=["char", "word", "bpe"])
    p.add_argument("--bpe_vocab_size", type=int, default=300)
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = get_parser().parse_args(argv)
    from espnet_tpu_torch.data.fileio import read_2column_text
    from espnet_tpu_torch.data.tokenizer import (TokenIDConverter,
                                                 build_token_list,
                                                 build_tokenizer)

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    texts = list(read_2column_text(Path(args.text)).values())
    if args.token_type == "bpe":
        try:
            import tokenizers  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "--token_type bpe needs the HF `tokenizers` package, which "
                "is not installed; use --token_type char or word") from e
        from espnet_tpu_torch.data.tokenizer import BpeTokenizer

        model_path = out / "bpe.json"
        if not model_path.exists():
            BpeTokenizer.train(texts, args.bpe_vocab_size, str(model_path))
        tokenizer = build_tokenizer("bpe", str(model_path))
    else:
        tokenizer = build_tokenizer(args.token_type)
    conv = TokenIDConverter(build_token_list(texts, tokenizer))
    conv.save(out / "tokens.txt")
    logger.info("token list (%d tokens) -> %s", len(conv), out / "tokens.txt")
    return out / "tokens.txt"


if __name__ == "__main__":
    main()
