# Copy of espnet_tpu/data/phoneme.py (the port imports nothing of
# espnet_tpu); its imports point at the port's modules.
"""Phoneme tokenizer + text cleaners (self-contained).

Behavioral spec: reference `espnet2/text/phoneme_tokenizer.py:1`
(PhonemeTokenizer wrapping a g2p backend; word -> phoneme sequence with a
separator-free join for scoring) and `espnet2/text/cleaner.py:1`
(TextCleaner applying named cleaner pipelines before tokenization —
"tacotron" = uppercase + abbreviation expansion + punctuation removal).

The reference delegates G2P to external models (g2p_en, pyopenjtalk ...);
this build ships a dependency-free backend: a user-supplied lexicon
(CMU-dict format "WORD PH1 PH2 ...") merged over a built-in table covering
the synthetic smoke corpus, with a deterministic letter-spelling fallback
for OOV words — the structure (lexicon + fallback) is what recipe-grade
g2p needs; swap the lexicon file for a real CMUdict to scale up.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

# --- cleaners -------------------------------------------------------------

_ABBREVIATIONS = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"),
        ("st", "saint"), ("co", "company"), ("jr", "junior"),
        ("maj", "major"), ("gen", "general"), ("drs", "doctors"),
        ("rev", "reverend"), ("lt", "lieutenant"), ("hon", "honorable"),
        ("sgt", "sergeant"), ("capt", "captain"), ("esq", "esquire"),
        ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
    ]
]
_WHITESPACE_RE = re.compile(r"\s+")


def tacotron_clean(text: str) -> str:
    """Tacotron-style english cleaner (uppercase output like the reference's
    `tacotron_cleaner.cleaners.custom_english_cleaners`)."""
    for pat, repl in _ABBREVIATIONS:
        text = pat.sub(repl, text)
    text = text.replace("&", " and ")
    text = re.sub(r"[\(\)\[\]\{\}\"“”]", " ", text)
    # clause-ending punctuation -> ", " (the reference cleaner keeps commas)
    text = re.sub(r"\s*[,;\.\!\?]\s*", ", ", text)
    text = re.sub(r"[:\-–—_/]", " ", text)
    text = _WHITESPACE_RE.sub(" ", text).strip()
    text = re.sub(r"(, )+", ", ", text).rstrip(" ,")
    return text.upper()


def basic_clean(text: str) -> str:
    """Lowercase + collapse whitespace + strip punctuation."""
    text = re.sub(r"[^\w\s']", " ", text)
    return _WHITESPACE_RE.sub(" ", text).strip().lower()


class TextCleaner:
    """Named cleaner pipeline (reference `espnet2/text/cleaner.py:20`)."""

    _REGISTRY = {
        "tacotron": tacotron_clean,
        "basic": basic_clean,
        None: lambda s: s,
    }

    def __init__(self, cleaner_types=None):
        if cleaner_types is None:
            cleaner_types = []
        elif isinstance(cleaner_types, str):
            cleaner_types = [cleaner_types]
        for c in cleaner_types:
            if c not in self._REGISTRY:
                raise ValueError(f"unknown cleaner: {c}")
        self.cleaners = [self._REGISTRY[c] for c in cleaner_types]

    def __call__(self, text: str) -> str:
        for fn in self.cleaners:
            text = fn(text)
        return text


# --- g2p ------------------------------------------------------------------

# the synthetic smoke corpus vocabulary (data/synth.py WORDS)
_BUILTIN_LEXICON = {
    "ichi": ["IY", "CH", "IY"],
    "ni": ["N", "IY"],
    "san": ["S", "AA", "N"],
    "yon": ["Y", "OW", "N"],
    "go": ["G", "OW"],
    "roku": ["R", "OW", "K", "UW"],
    "nana": ["N", "AA", "N", "AA"],
    "hachi": ["HH", "AA", "CH", "IY"],
}

# deterministic letter -> phone fallback for OOV words
_LETTER_PHONES = {
    "a": "AA", "b": "B", "c": "K", "d": "D", "e": "EH", "f": "F",
    "g": "G", "h": "HH", "i": "IY", "j": "JH", "k": "K", "l": "L",
    "m": "M", "n": "N", "o": "OW", "p": "P", "q": "K", "r": "R",
    "s": "S", "t": "T", "u": "UW", "v": "V", "w": "W", "x": "K",
    "y": "Y", "z": "Z",
}


def load_lexicon(path) -> Dict[str, List[str]]:
    """CMU-dict style file: 'word PH1 PH2 ...' per line."""
    lex = {}
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if len(parts) >= 2 and not parts[0].startswith(";"):
            lex[parts[0].lower()] = parts[1:]
    return lex


class PhonemeTokenizer:
    """Word -> phoneme tokenizer (reference phoneme_tokenizer.py).

    Tokens include an explicit word-separator symbol (the reference keeps
    "<space>" so tokens2text can invert), phonemes come from the lexicon
    with a letter-spelling fallback for OOV.
    """

    def __init__(
        self,
        lexicon: Optional[str] = None,
        separator: str = "<space>",
        cleaner: Optional[str] = None,
    ):
        self.lex = dict(_BUILTIN_LEXICON)
        if lexicon:
            self.lex.update(load_lexicon(lexicon))
        self.separator = separator
        self.cleaner = TextCleaner(cleaner) if cleaner else None
        self._inverse = {tuple(v): k for k, v in self.lex.items()}

    def g2p(self, word: str) -> List[str]:
        w = word.lower()
        if w in self.lex:
            return list(self.lex[w])
        return [_LETTER_PHONES[ch] for ch in w if ch in _LETTER_PHONES]

    def text2tokens(self, line: str) -> List[str]:
        if self.cleaner:
            line = self.cleaner(line)
        out: List[str] = []
        for i, word in enumerate(line.split()):
            if i > 0:
                out.append(self.separator)
            out.extend(self.g2p(word))
        return out

    def tokens2text(self, tokens: Iterable[str]) -> str:
        words: List[List[str]] = [[]]
        for t in tokens:
            if t == self.separator:
                words.append([])
            else:
                words[-1].append(t)
        out = []
        for phones in words:
            if not phones:
                continue
            out.append(self._inverse.get(tuple(phones), "".join(phones)))
        return " ".join(out)
