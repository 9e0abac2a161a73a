# Copy of espnet_tpu/data/tokenizer.py (the port imports nothing of
# espnet_tpu); its imports point at the port's modules.
"""Tokenizers + token<->id conversion.

Behavioral spec: reference `espnet2/text/` (`CharTokenizer`,
`WordTokenizer`, `SentencepiecesTokenizer`, `TokenIDConverter`,
`build_tokenizer`). BPE is backed by the HF `tokenizers` native library
(sentencepiece is not in this image); char/word are pure python.

Token-list convention (matches `espnet2/tasks/asr.py` vocabulary layout):
index 0 = <blank>, last index = <sos/eos>, <unk> present; the token list
file is one token per line.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, List, Optional, Sequence

BLANK = "<blank>"
UNK = "<unk>"
SOS_EOS = "<sos/eos>"
SPACE = "<space>"


class CharTokenizer:
    """Character tokenizer (`espnet2/text/char_tokenizer.py`):
    space -> <space>, non-linguistic symbols preserved."""

    def __init__(self, space_symbol: str = SPACE,
                 non_linguistic_symbols: Sequence[str] = ()):
        self.space_symbol = space_symbol
        self.nls = tuple(non_linguistic_symbols)

    def text2tokens(self, line: str) -> List[str]:
        tokens: List[str] = []
        i = 0
        while i < len(line):
            matched = False
            for sym in self.nls:
                if line.startswith(sym, i):
                    tokens.append(sym)
                    i += len(sym)
                    matched = True
                    break
            if matched:
                continue
            ch = line[i]
            tokens.append(self.space_symbol if ch == " " else ch)
            i += 1
        return tokens

    def tokens2text(self, tokens: Iterable[str]) -> str:
        return "".join(" " if t == self.space_symbol else t for t in tokens)


class WordTokenizer:
    def __init__(self, delimiter: Optional[str] = None):
        self.delimiter = delimiter

    def text2tokens(self, line: str) -> List[str]:
        return line.split(self.delimiter)

    def tokens2text(self, tokens: Iterable[str]) -> str:
        return (self.delimiter or " ").join(tokens)


class BpeTokenizer:
    """BPE via the HF `tokenizers` native library (replaces sentencepiece,
    `espnet2/text/sentencepiece_tokenizer.py`). Uses the sentencepiece-style
    whitespace marker '▁'."""

    def __init__(self, model_path):
        from tokenizers import Tokenizer

        self.tok = Tokenizer.from_file(str(model_path))

    def text2tokens(self, line: str) -> List[str]:
        return self.tok.encode(line).tokens

    def tokens2text(self, tokens: Iterable[str]) -> str:
        return "".join(tokens).replace("▁", " ").strip()

    @staticmethod
    def train(
        sentences: Iterable[str], vocab_size: int, save_path,
        character_coverage: float = 1.0,
    ) -> "BpeTokenizer":
        from tokenizers import Tokenizer, models, pre_tokenizers, trainers

        tok = Tokenizer(models.BPE(unk_token=UNK))
        tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁")
        trainer = trainers.BpeTrainer(
            vocab_size=vocab_size, special_tokens=[UNK], show_progress=False
        )
        tok.train_from_iterator(sentences, trainer)
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        tok.save(str(save_path))
        return BpeTokenizer(save_path)


def build_tokenizer(token_type: str, model_path=None, **kw):
    """`espnet2/text/build_tokenizer.py` equivalent."""
    if token_type == "char":
        return CharTokenizer(**kw)
    if token_type == "word":
        return WordTokenizer(**kw)
    if token_type == "bpe":
        return BpeTokenizer(model_path)
    if token_type == "phn":
        from espnet_tpu_torch.data.phoneme import PhonemeTokenizer

        return PhonemeTokenizer(lexicon=model_path, **kw)
    raise ValueError(f"unknown token_type {token_type}")


class TokenIDConverter:
    """token list <-> ids (`espnet2/text/token_id_converter.py`).
    Unknown tokens map to <unk>."""

    def __init__(self, token_list: Sequence[str]):
        self.token_list = list(token_list)
        self.token2id = {t: i for i, t in enumerate(self.token_list)}
        if len(self.token2id) != len(self.token_list):
            raise ValueError("duplicated tokens in token list")
        self.unk_id = self.token2id.get(UNK)

    @classmethod
    def from_file(cls, path) -> "TokenIDConverter":
        with open(path, encoding="utf-8") as f:
            return cls([ln.rstrip("\n") for ln in f if ln.rstrip("\n")])

    def save(self, path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            for t in self.token_list:
                f.write(t + "\n")

    def __len__(self):
        return len(self.token_list)

    def tokens2ids(self, tokens: Iterable[str]) -> List[int]:
        if self.unk_id is None:
            return [self.token2id[t] for t in tokens]
        return [self.token2id.get(t, self.unk_id) for t in tokens]

    def ids2tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.token_list[int(i)] for i in ids]


def build_token_list(
    texts: Iterable[str], tokenizer, extra_symbols: Sequence[str] = ()
) -> List[str]:
    """Assemble the vocabulary: <blank>, <unk>, corpus tokens (sorted),
    extras, <sos/eos> last (matches the recipe token-list layout,
    `egs2/TEMPLATE/asr1/asr.sh` stage 5)."""
    seen = set()
    for line in texts:
        seen.update(tokenizer.text2tokens(line))
    toks = sorted(seen - {BLANK, UNK, SOS_EOS})
    return [BLANK, UNK, *toks, *extra_symbols, SOS_EOS]
