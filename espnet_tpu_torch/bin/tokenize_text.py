"""Tokenize a text file (port of espnet_tpu/bin/tokenize_text.py).

    python -m espnet_tpu_torch.bin.tokenize_text --input text \
        --output tokens.txt --token_type char [--bpe_model bpe.json] \
        [--field 2-] [--cleaner moses|nkf]
"""

from __future__ import annotations

import argparse
import sys


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", "-i", required=True, help="'-' for stdin")
    p.add_argument("--output", "-o", required=True, help="'-' for stdout")
    p.add_argument("--token_type", "-t", default="char",
                   choices=["char", "word", "bpe"])
    p.add_argument("--bpe_model", default=None)
    p.add_argument("--field", default=None,
                   help="e.g. '2-' to keep the utt-id column untouched")
    p.add_argument("--delimiter", default=" ")
    p.add_argument("--cleaner", default=None,
                   choices=[None, "moses", "nkf"],
                   help="text normalization before tokenizing: 'moses' "
                        "(the Moses tokenizer's role) or 'nkf' (charset "
                        "normalization); see data/text_norm.py")
    p.add_argument("--lang", default="en", help="language for --cleaner moses")
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)
    from espnet_tpu_torch.data.text_norm import (moses_tokenize,
                                                 normalize_charset)
    from espnet_tpu_torch.data.tokenizer import build_tokenizer

    if args.field and not args.field.endswith("-"):
        raise ValueError(f"--field {args.field!r}: only 'N-' is supported")
    tok = build_tokenizer(args.token_type, args.bpe_model)
    if args.cleaner == "moses":
        def clean(t):
            return " ".join(moses_tokenize(normalize_charset(t), args.lang))
    elif args.cleaner == "nkf":
        clean = normalize_charset
    else:
        def clean(t):
            return t
    fin = sys.stdin if args.input == "-" else open(args.input,
                                                   encoding="utf-8")
    fout = (sys.stdout if args.output == "-"
            else open(args.output, "w", encoding="utf-8"))
    with fin, fout:
        for line in fin:
            line = line.rstrip("\n")
            if args.field:
                n = int(args.field[:-1]) - 1
                parts = line.split(args.delimiter)
                head, text = parts[:n], args.delimiter.join(parts[n:])
                toks = tok.text2tokens(clean(text))
                fout.write(args.delimiter.join(head + toks) + "\n")
            else:
                fout.write(
                    args.delimiter.join(tok.text2tokens(clean(line))) + "\n")


if __name__ == "__main__":
    main()
