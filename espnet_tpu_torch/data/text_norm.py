"""Host-side text normalization: Moses-style tokenizer/detokenizer and
charset normalization (the nkf role). A copy of
espnet_tpu/data/text_norm.py, which imports no JAX: the port imports nothing
of the JAX package.

The reference's MT/ST recipes shell out to external native tools for text
preprocessing: the Moses `tokenizer.perl`/`detokenizer.perl` scripts and
`nkf` for Japanese charset normalization (built by `tools/Makefile:131,160`,
used from e.g. `egs/iwslt16/mt1/local/train_and_qsub.sh`-style recipe
steps). SURVEY.md §2.6 tracks both as native deps needing equivalents.
These are pure-CPU, recipe-side text utilities, so
they ship as dependency-free Python.

`moses_tokenize`/`moses_detokenize` implement the behavioral core of the
Moses scripts (punctuation splitting with number/abbreviation protection,
language-aware apostrophe handling, detokenizer quote/punct reattachment).
`normalize_charset` covers the common nkf invocation (`nkf -Z`-style
full-width→ASCII plus NFKC compatibility mapping).
"""

from __future__ import annotations

import re
import unicodedata
from typing import Iterable, List

# Minimal nonbreaking-prefix list (Moses ships per-language files; these are
# the high-frequency entries from the English one).
_NONBREAKING_PREFIXES = {
    "Mr", "Mrs", "Ms", "Dr", "Prof", "Rev", "Hon", "St", "Sgt", "Capt",
    "Lt", "Col", "Gen", "Jr", "Sr", "vs", "etc", "i.e", "e.g", "al", "Inc",
    "Ltd", "Co", "Corp", "No", "Nos", "Vol", "pp", "Fig", "Figs", "Eq",
    "cf", "approx",
}

# Contractions the English tokenizer splits as <word> <'suffix>.
_EN_APOS = re.compile(r"(\w)'(\w)")
_FR_APOS = re.compile(r"(\w)'(\w)")


def normalize_charset(text: str, to_ascii: bool = True) -> str:
    """nkf-role normalization: NFKC + optional full-width→ASCII folding.

    NFKC already maps full-width Latin/digits/punct (ＡＢ１２．) to ASCII
    and half-width katakana to full-width — the two conversions recipes use
    nkf for (`nkf -w -Z`). ``to_ascii=False`` keeps compatibility forms.
    """
    if to_ascii:
        return unicodedata.normalize("NFKC", text)
    return unicodedata.normalize("NFC", text)


def _protect_numbers(tok: str) -> bool:
    # 1,000.5 / 3.14 / 12:30 style tokens stay whole
    return bool(re.fullmatch(r"[\d.,:%-]*\d[\d.,:%-]*", tok))


def moses_tokenize(text: str, lang: str = "en") -> List[str]:
    """Moses ``tokenizer.perl`` behavioral equivalent.

    - splits punctuation off words, keeping numbers like ``1,234.5`` whole
    - keeps abbreviation periods attached (nonbreaking prefixes, ``U.S.``)
    - English: ``don't`` → ``don 't``; French: ``l'eau`` → ``l' eau``
    - ``--`` and unicode dashes/quotes become standalone tokens
    """
    text = text.strip()
    if not text:
        return []
    # normalize exotic whitespace; keep unicode letters intact
    text = re.sub(r"\s+", " ", text)
    # pad non-word characters except . ' , which need context rules
    text = re.sub(r"([^\w\s.',])", r" \1 ", text, flags=re.UNICODE)
    # commas: split unless digit,digit
    text = re.sub(r",(?!\d)", " , ", text)
    text = re.sub(r"(?<!\d),", " , ", text)
    # apostrophes: bare quotes (not between word chars) become standalone
    # tokens FIRST, then intra-word apostrophes split Moses-style
    text = re.sub(r"(?<!\w)'|'(?!\w)", " ' ", text)
    if lang in ("fr", "it", "ca"):
        text = _FR_APOS.sub(r"\1' \2", text)
    else:
        text = _EN_APOS.sub(r"\1 '\2", text)

    out: List[str] = []
    for tok in text.split():
        if "." not in tok or _protect_numbers(tok):
            out.append(tok)
            continue
        # trailing period: split off unless abbreviation / single letter /
        # internal-dot token (U.S., i.e.)
        m = re.fullmatch(r"(.+)\.", tok)
        if m:
            body = m.group(1)
            if (body in _NONBREAKING_PREFIXES or len(body) == 1
                    or "." in body):
                out.append(tok)
            else:
                out.extend([body, "."])
        else:
            out.append(tok)
    return out


_NO_SPACE_BEFORE = {".", ",", "!", "?", ";", ":", ")", "]", "}", "%", "...",
                    "'", "''", "'s", "'t", "'re", "'ve", "'ll", "'d", "'m"}
_NO_SPACE_AFTER = {"(", "[", "{", "$", "``"}


def moses_detokenize(tokens: Iterable[str], lang: str = "en") -> str:
    """Moses ``detokenizer.perl`` behavioral equivalent (quote pairing,
    punctuation reattachment, English apostrophe merge)."""
    out = ""
    quote_open = False
    prev = ""
    for tok in tokens:
        if tok == '"':
            if quote_open:
                out = out.rstrip() + '"'
            else:
                out = (out + " " if out and not out.endswith(" ") else out) + '"'
            quote_open = not quote_open
        elif (tok in _NO_SPACE_BEFORE
              or (tok.startswith("'") and lang not in ("fr", "it", "ca"))):
            out = out.rstrip() + tok
        elif prev in _NO_SPACE_AFTER or (out and out.endswith('"')
                                         and quote_open):
            out += tok
        elif prev.endswith("'") and lang in ("fr", "it", "ca"):
            out += tok
        else:
            out = (out + " " if out and not out.endswith(" ") else out) + tok
        prev = tok
    return out.strip()
