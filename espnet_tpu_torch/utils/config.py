"""YAML config + CLI override system (port of espnet_tpu/utils/config.py).

`_coerce`, `dataclass_from_dict`, `dataclass_to_dict`, `parse_cli_overrides`
and `merge_dicts` are the JAX module's. `load_yaml` and `dump_yaml` are the
port's own codec, since the card's machine has no PyYAML: the reader takes
the subset of YAML that configs use and resolves scalars as PyYAML's
`safe_load` does (YAML 1.1: `1.0e-9` is a float, `1e-9` a string, and
yes/no/on/off/true/false are bools), and raises on anything outside it:

* block maps, block sequences (indented or not) and flow sequences and maps;
* plain, single-quoted and double-quoted scalars, folded over lines;
* literal (`|`) and folded (`>`) block scalars with their chomping and
  indentation indicators;
* comments.

Anchors, aliases, tags, directives, several documents, complex keys,
timestamps and merge keys raise. The writer emits block style, which
PyYAML's `safe_load` reads back to the same values.
"""

from __future__ import annotations

import dataclasses
import math
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Type


class YAMLError(ValueError):
    """Input outside the YAML subset of `load_yaml`, or malformed."""


def load_yaml(path) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        return loads_yaml(f.read()) or {}


def dump_yaml(obj: Dict[str, Any], path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write(dumps_yaml(obj))


# --- scalar resolution (PyYAML's YAML 1.1 implicit resolvers) ---------------

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(
    r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
     (?:[Tt]|[ \t]+)[0-9][0-9]?
     :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
# PyYAML tries its resolvers in this order among those whose first
# characters match; the first characters of each are implied by the regexes
_RESOLVERS = (("bool", _BOOL), ("float", _FLOAT), ("int", _INT),
              ("merge", re.compile(r"^(?:<<)$")), ("null", _NULL),
              ("timestamp", _TIMESTAMP), ("value", re.compile(r"^(?:=)$")))


def _sexagesimal(value: str, cast):
    digits = [cast(part) for part in value.split(":")]
    digits.reverse()
    base, out = 1, 0
    for d in digits:
        out += d * base
        base *= 60
    return out


def _construct_int(value: str) -> int:
    value = value.replace("_", "")
    sign = 1
    if value[0] == "-":
        sign = -1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _construct_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = 1.0
    if value[0] == "-":
        sign = -1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def resolve_plain(text: str) -> Any:
    """The value of a plain (unquoted) scalar, as PyYAML's safe_load gives
    it; raises for the kinds this codec does not take."""
    for kind, pattern in _RESOLVERS:
        if not pattern.match(text):
            continue
        if kind == "bool":
            return text.lower() in ("yes", "true", "on")
        if kind == "float":
            return _construct_float(text)
        if kind == "int":
            return _construct_int(text)
        if kind == "null":
            return None
        raise YAMLError(f"plain scalar {text!r} resolves to a YAML {kind}, "
                        "which this codec does not take")
    return text


# --- reader -----------------------------------------------------------------

_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_INDICATORS = "-?:,[]{}#&*!|>'\"%@`"


def _fold(pieces: List[str]) -> str:
    """Join the lines of a multi-line flow scalar: one line break becomes a
    space, each further (empty) line a newline."""
    out, empties = pieces[0], 0
    for piece in pieces[1:]:
        if piece == "":
            empties += 1
            continue
        out += ("\n" * empties) if empties else " "
        out += piece
        empties = 0
    return out + "\n" * empties


def _quote_end(text: str, start: int) -> Optional[int]:
    """Offset of the quote closing the quoted scalar at text[start]."""
    q = text[start]
    i = start + 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if i + 1 < len(text) and text[i + 1] == "'":
                i += 2
                continue
            return i
        if q == '"':
            if c == "\\":
                i += 2
                continue
            if c == '"':
                return i
        i += 1
    return None


def _double(body: str) -> str:
    """Unescape the body of a one-line double-quoted scalar."""
    out = []
    i = 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        if i + 1 >= len(body):
            raise YAMLError("dangling escape in a double-quoted scalar")
        e = body[i + 1]
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            i += 2
        elif e in _HEX_ESCAPES:
            n = _HEX_ESCAPES[e]
            digits = body[i + 2:i + 2 + n]
            if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                raise YAMLError(f"bad escape \\{e}{digits}")
            out.append(chr(int(digits, 16)))
            i += 2 + n
        else:
            raise YAMLError(f"unknown escape \\{e}")
    return "".join(out)


def _quoted_value(text: str) -> str:
    """The value of a quoted scalar (quotes included in `text`), folded
    over its lines."""
    q, body = text[0], text[1:-1]
    lines = body.split("\n")
    if len(lines) == 1:
        return _double(body) if q == '"' else body.replace("''", "'")
    if q == "'":
        pieces = [lines[0].rstrip(" \t")]
        pieces += [ln.strip(" \t") for ln in lines[1:-1]]
        pieces.append(lines[-1].lstrip(" \t"))
        return _fold(pieces).replace("''", "'")
    # double quotes: a line ending in an odd run of backslashes escapes its
    # line break, which then joins the lines without a space
    pieces, cur = [], ""
    for i, ln in enumerate(lines):
        if i:
            ln = ln.lstrip(" \t")
        if i == len(lines) - 1:
            pieces.append(cur + _double(ln))
            break
        run = len(ln) - len(ln.rstrip("\\"))
        if run % 2 == 1:
            cur += _double(ln[:-1])
            continue
        pieces.append(cur + _double(ln.rstrip(" \t")))
        cur = ""
    return _fold(pieces)


class _Reader:
    def __init__(self, text: str):
        if text.startswith("﻿"):
            text = text[1:]
        if "\t" in "".join(re.findall(r"^[ \t]*", text, re.M)):
            raise YAMLError("tabs in indentation")
        self.lines = text.split("\n")
        self.row = 0

    # helpers on the current line ---------------------------------------
    @staticmethod
    def _indent(line: str) -> int:
        return len(line) - len(line.lstrip(" "))

    @staticmethod
    def _is_blank(line: str) -> bool:
        s = line.strip()
        return not s or s.startswith("#")

    def _skip_blank(self) -> None:
        while (self.row < len(self.lines)
               and self._is_blank(self.lines[self.row])):
            self.row += 1

    def _peek(self) -> Optional[Tuple[int, str]]:
        self._skip_blank()
        if self.row >= len(self.lines):
            return None
        line = self.lines[self.row]
        return self._indent(line), line

    # documents -----------------------------------------------------------
    def document(self) -> Any:
        peek = self._peek()
        if peek is None:
            return None
        indent, line = peek
        if line.startswith("%") or line.startswith("---") \
                or line.startswith("..."):
            raise YAMLError("directives and document markers are not taken")
        value = self.block(indent, -1)
        if self._peek() is not None:
            raise YAMLError(f"line {self.row + 1}: unexpected content "
                            f"{self.lines[self.row].strip()!r}")
        return value

    # block nodes -----------------------------------------------------------
    def block(self, indent: int, parent: int) -> Any:
        """The node whose first line starts at column `indent` of the
        current row (parent: the enclosing block's indent)."""
        line = self.lines[self.row]
        body = line[indent:]
        if body == "-" or body.startswith("- "):
            return self.sequence(indent)
        if self._key_split(body) is not None:
            return self.mapping(indent)
        return self.scalar_value(line, indent, parent)

    def sequence(self, indent: int) -> list:
        out = []
        while True:
            peek = self._peek()
            if peek is None or peek[0] != indent:
                break
            line = peek[1]
            body = line[indent:]
            if not (body == "-" or body.startswith("- ")):
                break
            rest = body[1:]
            content = rest.lstrip(" ")
            if not content or content.startswith("#"):
                self.row += 1
                nxt = self._peek()
                if nxt is not None and nxt[0] > indent:
                    out.append(self.block(nxt[0], indent))
                else:
                    out.append(None)
                continue
            col = indent + 1 + (len(rest) - len(content))
            # the item's node starts at `col`: blank out the dash
            self.lines[self.row] = " " * col + line[col:]
            out.append(self.block(col, indent))
        return out

    def _key_split(self, body: str) -> Optional[Tuple[str, str]]:
        """(key text, rest after the colon) if `body` is a mapping entry."""
        if body == "?" or body.startswith(("? ", "&", "*", "!")):
            raise YAMLError(f"line {self.row + 1}: complex keys, anchors, "
                            "aliases and tags are not taken")
        if body[:1] in "\"'":
            end = _quote_end(body, 0)
            if end is None:
                return None
            after = body[end + 1:]
            stripped = after.lstrip(" ")
            if stripped.startswith(":") and (len(stripped) == 1
                                             or stripped[1] in " \t"):
                return body[:end + 1], stripped[1:]
            return None
        if body[:1] in "[{#|>" or not body:
            return None
        m = re.search(r":(?:[ \t]|$)", body)
        if m is None:
            return None
        hash_at = re.search(r"[ \t]#", body)
        if hash_at is not None and hash_at.start() < m.start():
            return None
        return body[:m.start()].rstrip(" \t"), body[m.end():]

    def _key(self, text: str) -> Any:
        if text[:1] == '"':
            return _double(text[1:-1])
        if text[:1] == "'":
            return text[1:-1].replace("''", "'")
        return resolve_plain(text)

    def mapping(self, indent: int) -> dict:
        out: Dict[Any, Any] = {}
        while True:
            peek = self._peek()
            if peek is None or peek[0] != indent:
                break
            line = peek[1]
            split = self._key_split(line[indent:])
            if split is None:
                break
            key_text, rest = split
            key = self._key(key_text)
            if isinstance(key, (list, dict)):
                raise YAMLError("collection keys are not taken")
            col = len(line) - len(rest)
            content = rest.lstrip(" \t")
            if not content or content.startswith("#"):
                self.row += 1
                nxt = self._peek()
                # a nested node, or a sequence at the key's own indent
                if nxt is not None and (nxt[0] > indent or (
                        nxt[0] == indent
                        and re.match(r"-( |$)", nxt[1][indent:]))):
                    out[key] = self.block(nxt[0], indent)
                else:
                    out[key] = None
                continue
            col += len(rest) - len(content)
            out[key] = self.scalar_value(line, col, indent)
        return out

    # scalars and flow collections ------------------------------------------
    def scalar_value(self, line: str, col: int, parent: int) -> Any:
        """The value that starts at column `col` of the current row: a
        block scalar, a flow collection, a quoted or a plain scalar.
        Continuation lines must be indented past `parent`."""
        text = line[col:]
        c = text[:1]
        if c in ("&", "*", "!", "%", "@", "`"):
            raise YAMLError(f"line {self.row + 1}: anchors, aliases, tags and "
                            f"reserved indicators are not taken: {text!r}")
        if c in ("|", ">"):
            return self.block_scalar(text, parent)
        if c in ("[", "{"):
            return self.flow(col, parent)
        if c in ("'", '"'):
            return self.quoted(col, parent)
        return self.plain(col, parent)

    def plain(self, col: int, parent: int) -> Any:
        """A plain scalar, folded over the following lines indented past
        `parent`, up to a comment."""
        parts = re.split(r"[ \t]#", self.lines[self.row][col:], maxsplit=1)
        pieces = [parts[0].strip()]
        self.row += 1
        ended = len(parts) > 1
        while not ended and self.row < len(self.lines):
            nxt = self.lines[self.row]
            body = nxt.strip()
            if not body:
                pieces.append("")
                self.row += 1
                continue
            if self._indent(nxt) <= parent or body.startswith("#"):
                break
            if body == "-" or body.startswith("- ") or re.search(
                    r":(?:[ \t]|$)", re.split(r"[ \t]#", body)[0]):
                raise YAMLError(f"line {self.row + 1}: a mapping or sequence "
                                "entry inside a multi-line plain scalar")
            parts = re.split(r"[ \t]#", body, maxsplit=1)
            pieces.append(parts[0].strip())
            self.row += 1
            ended = len(parts) > 1
        while len(pieces) > 1 and pieces[-1] == "":
            pieces.pop()  # blank lines after the scalar are not part of it
            self.row -= 1
        if len(pieces) == 1:
            return resolve_plain(pieces[0])
        return _fold(pieces)

    def _gather(self, col: int, parent: int, done) -> Tuple[str, int]:
        """Text from column `col` of the current row over the following
        lines until `done(text)` gives the end offset; leaves the row after
        the last line used. Returns (text, end offset)."""
        text = self.lines[self.row][col:]
        while True:
            end = done(text)
            if end is not None:
                break
            if self.row + 1 >= len(self.lines):
                raise YAMLError(f"line {self.row + 1}: unterminated value")
            self.row += 1
            nxt = self.lines[self.row]
            if nxt.strip() and self._indent(nxt) <= parent:
                raise YAMLError(f"line {self.row + 1}: a multi-line value "
                                "must be indented past its parent")
            text += "\n" + nxt
        self.row += 1
        return text, end

    def _rest_is_empty(self, rest: str) -> None:
        rest = rest.strip(" \t")
        if rest and not rest.startswith("#"):
            raise YAMLError(f"line {self.row}: unexpected {rest!r} after a "
                            "value")

    def quoted(self, col: int, parent: int) -> str:
        text, end = self._gather(col, parent, lambda t: _quote_end(t, 0))
        self._rest_is_empty(text[end + 1:])
        return _quoted_value(text[:end + 1])

    def block_scalar(self, header: str, parent: int) -> str:
        m = re.match(r"^([|>])([-+]?)([1-9]?)([-+]?)[ \t]*(#.*)?$", header)
        if m is None or (m.group(2) and m.group(4)):
            raise YAMLError(f"line {self.row + 1}: bad block scalar header "
                            f"{header!r}")
        folded = m.group(1) == ">"
        chomp = m.group(2) or m.group(4)
        chomping = {"-": False, "+": True, "": None}[chomp]
        self.row += 1
        min_indent = max(parent + 1, 1)
        if m.group(3):
            indent = max(parent, 0) + int(m.group(3))
        else:
            indent = None
            for ln in self.lines[self.row:]:
                if ln.strip():
                    indent = max(min_indent, self._indent(ln))
                    break
            if indent is None:
                indent = min_indent
        # content lines: blank (or short all-space) lines and lines at indent
        rows = []
        while self.row < len(self.lines):
            ln = self.lines[self.row]
            if ln.strip() == "":
                rows.append(None)
            elif self._indent(ln) >= indent:
                rows.append(ln[indent:])
            else:
                break
            self.row += 1
        # the last line of the file has no line break
        at_eof = self.row >= len(self.lines)
        chunks: List[str] = []
        breaks: List[str] = []
        line_break = ""
        i = 0
        while i < len(rows) and rows[i] is None:
            breaks.append("\n")
            i += 1
        while i < len(rows):
            chunks.extend(breaks)
            text = rows[i]
            leading_non_space = text[:1] not in (" ", "\t")
            chunks.append(text)
            i += 1
            last = at_eof and i == len(rows)
            line_break = "" if last else "\n"
            breaks = []
            while i < len(rows) and rows[i] is None:
                breaks.append("\n")
                i += 1
            if i < len(rows):
                if (folded and line_break == "\n" and leading_non_space
                        and rows[i][:1] not in (" ", "\t")):
                    if not breaks:
                        chunks.append(" ")
                else:
                    chunks.append(line_break)
        if at_eof and breaks:
            breaks = breaks[:-1]
        if chomping is not False:
            chunks.append(line_break)
        if chomping is True:
            chunks.extend(breaks)
        return "".join(chunks)

    def flow(self, col: int, parent: int) -> Any:
        text, end = self._gather(col, parent, _flow_end)
        value, pos = _FlowParser(text).parse()
        self._rest_is_empty(text[pos:])
        return value


def _flow_end(text: str) -> Optional[int]:
    """Offset of the bracket closing the flow collection at text[0], or
    None if the text ends first."""
    depth, i = 0, 0
    while i < len(text):
        c = text[i]
        # a quote opens a scalar only where a node starts
        if c in "'\"" and text[:i].rstrip(" \t\n")[-1:] in ("", "[", "{",
                                                            ",", ":"):
            end = _quote_end(text, i)
            if end is None:
                return None
            i = end + 1
            continue
        if c == "#" and (i == 0 or text[i - 1] in " \t\n"):
            nl = text.find("\n", i)
            if nl < 0:
                return None
            i = nl
            continue
        if c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
            if depth == 0:
                return i
        i += 1
    return None


class _FlowParser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def _ws(self) -> None:
        t = self.text
        while self.pos < len(t):
            c = t[self.pos]
            if c in " \t\n":
                self.pos += 1
            elif c == "#" and (self.pos == 0 or t[self.pos - 1] in " \t\n"):
                nl = t.find("\n", self.pos)
                self.pos = len(t) if nl < 0 else nl
            else:
                break

    def parse(self) -> Tuple[Any, int]:
        value = self.node()
        return value, self.pos

    def node(self) -> Any:
        self._ws()
        c = self.text[self.pos]
        if c == "[":
            return self.seq()
        if c == "{":
            return self.map()
        if c in "'\"":
            end = _quote_end(self.text, self.pos)
            raw = self.text[self.pos:end + 1]
            self.pos = end + 1
            return _quoted_value(raw)
        if c in "&*!|>%@`":
            raise YAMLError(f"{c!r} in a flow collection is not taken")
        return self.plain()

    def plain(self) -> Any:
        t = self.text
        start = self.pos
        while self.pos < len(t):
            c = t[self.pos]
            if c in ",[]{}":
                break
            if c == ":" and (self.pos + 1 >= len(t)
                             or t[self.pos + 1] in " \t\n,[]{}"):
                break
            if c == "#" and t[self.pos - 1] in " \t\n":
                break
            self.pos += 1
        raw = t[start:self.pos]
        pieces = [ln.strip(" \t") for ln in raw.strip(" \t\n").split("\n")]
        return resolve_plain(_fold(pieces) if len(pieces) > 1 else pieces[0])

    def _expect(self, chars: str) -> str:
        self._ws()
        if self.pos >= len(self.text) or self.text[self.pos] not in chars:
            raise YAMLError(f"expected one of {chars!r} in a flow collection "
                            f"at {self.text[self.pos:self.pos + 20]!r}")
        c = self.text[self.pos]
        self.pos += 1
        return c

    def seq(self) -> list:
        self.pos += 1
        out = []
        while True:
            self._ws()
            if self.text[self.pos] == "]":
                self.pos += 1
                return out
            item = self.node()
            self._ws()
            if self.text[self.pos] == ":":
                raise YAMLError("single-pair maps in flow sequences are not "
                                "taken")
            out.append(item)
            if self._expect(",]") == "]":
                return out

    def map(self) -> dict:
        self.pos += 1
        out = {}
        while True:
            self._ws()
            if self.text[self.pos] == "}":
                self.pos += 1
                return out
            key = self.node()
            if isinstance(key, (list, dict)):
                raise YAMLError("collection keys are not taken")
            self._ws()
            if self.text[self.pos] == ":":
                self.pos += 1
                self._ws()
                if self.text[self.pos] in ",}":
                    value = None
                else:
                    value = self.node()
            else:
                value = None
            out[key] = value
            if self._expect(",}") == "}":
                return out


def loads_yaml(text: str) -> Any:
    """Parse one YAML document of the codec's subset (see the module
    docstring); None for an empty document."""
    return _Reader(text).document()


# --- writer -----------------------------------------------------------------

def _float_text(v: float) -> str:
    if math.isnan(v):
        return ".nan"
    if math.isinf(v):
        return ".inf" if v > 0 else "-.inf"
    text = repr(v).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def _plain_ok(s: str) -> bool:
    if not s or s != s.strip() or s[0] in _INDICATORS:
        return False
    if any(not (" " <= c <= "~") for c in s):
        return False
    if ": " in s or " #" in s or s.endswith(":") or re.search(r"[,\[\]{}]", s):
        return False
    try:
        return resolve_plain(s) == s
    except YAMLError:
        return False


def _quote(s: str) -> str:
    out = ['"']
    for c in s:
        o = ord(c)
        if c == '"':
            out.append('\\"')
        elif c == "\\":
            out.append("\\\\")
        elif c == "\n":
            out.append("\\n")
        elif c == "\t":
            out.append("\\t")
        elif " " <= c <= "~":
            out.append(c)
        elif o <= 0xFF:
            out.append(f"\\x{o:02X}")
        elif o <= 0xFFFF:
            out.append(f"\\u{o:04X}")
        else:
            out.append(f"\\U{o:08X}")
    out.append('"')
    return "".join(out)


def _scalar_text(v: Any) -> str:
    if v is None:
        return "null"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, int):
        return str(int(v))
    if isinstance(v, float):
        return _float_text(float(v))
    if isinstance(v, str):
        return v if _plain_ok(v) else _quote(v)
    raise TypeError(f"cannot write {type(v).__name__} {v!r} as YAML")


def _emit(value: Any, indent: int, out: List[str], prefix: str) -> None:
    """Append the lines of `value`; `prefix` is the text that precedes it
    on its first line (a key's "key:" or a sequence's "-")."""
    pad = " " * indent
    if isinstance(value, dict) and value:
        first = True
        for k, v in value.items():
            key = _scalar_text(k)
            lead = prefix if first and prefix else pad
            first = False
            if isinstance(v, dict) and v:
                out.append(f"{lead}{key}:")
                _emit(v, indent + 2, out, "")
            elif isinstance(v, (list, tuple)) and v:
                out.append(f"{lead}{key}:")
                _emit(v, indent, out, "")
            else:
                out.append(f"{lead}{key}: {_inline(v)}")
        return
    if isinstance(value, (list, tuple)) and value:
        first = True
        for item in value:
            lead = (prefix if first and prefix else pad) + "- "
            first = False
            if isinstance(item, (dict, list, tuple)) and item:
                _emit(item, len(lead), out, lead)
            else:
                out.append(f"{lead}{_inline(item)}")
        return
    out.append(f"{prefix or pad}{_inline(value)}")


def _inline(v: Any) -> str:
    if isinstance(v, dict):
        if v:
            raise TypeError("a non-empty map is not inline")
        return "{}"
    if isinstance(v, (list, tuple)):
        if v:
            raise TypeError("a non-empty sequence is not inline")
        return "[]"
    return _scalar_text(v)


def dumps_yaml(obj: Any) -> str:
    """Block-style YAML of `obj` (dicts keep their order; tuples are
    written as sequences) that PyYAML's safe_load reads back to `obj`."""
    out: List[str] = []
    _emit(obj, 0, out, "")
    return "\n".join(out) + "\n"


# --- the JAX module's config helpers, unchanged -----------------------------

def _coerce(value: str, typ) -> Any:
    """Parse a CLI string into the field type.

    NB: with `from __future__ import annotations`, dataclass field types are
    *strings* ("int", "Optional[int]", …), so matching is name-based.
    """
    name = typ if isinstance(typ, str) else getattr(typ, "__name__", str(typ))
    is_opt = name.startswith("Optional[")
    if is_opt:
        if str(value).lower() in ("none", "null", ""):
            return None
        name = name[len("Optional["):-1]
    if name in ("bool",):
        return str(value).lower() in ("1", "true", "yes", "on")
    if name in ("int",):
        return int(value)
    if name in ("float",):
        return float(value)
    if isinstance(value, str) and value.lower() in ("none", "null"):
        return None
    if "Tuple" in name or "tuple" in name:
        if isinstance(value, str) and ("," in value or value.startswith("[")):
            items = value.strip().strip("[]()").split(",")
            out = []
            for x in items:
                x = x.strip()
                if not x:
                    continue
                try:
                    out.append(int(x))
                except ValueError:
                    out.append(float(x))
            return tuple(out)
    return value


def dataclass_from_dict(cls: Type, d: Dict[str, Any]):
    """Build a dataclass, coercing string values and rejecting unknown keys."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in (d or {}).items():
        if k not in fields:
            raise KeyError(
                f"unknown config key '{k}' for {cls.__name__}; "
                f"valid: {sorted(fields)}"
            )
        f = fields[k]
        # nested dataclass section (detected via the field default)
        if dataclasses.is_dataclass(f.default) and isinstance(v, dict):
            sub = dataclass_from_dict(type(f.default), v)
            overrides = {sk: getattr(sub, sk) for sk in v}
            v = dataclasses.replace(f.default, **overrides)
        elif isinstance(v, str):
            v = _coerce(v, f.type)
        if isinstance(v, list) and (
            str(f.type).startswith("typing.Tuple") or f.type is tuple
        ):
            v = tuple(v)
        kwargs[k] = v
    return cls(**kwargs)


def dataclass_to_dict(obj) -> Dict[str, Any]:
    import numpy as np

    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, tuple):
            v = list(v)
        if dataclasses.is_dataclass(v):
            v = dataclass_to_dict(v)
        if not isinstance(v, (int, float, str, bool, list, dict, type(None))):
            try:
                v = np.dtype(v).name  # dtype-like (e.g. jnp.bfloat16)
            except TypeError:
                v = str(v)
        out[f.name] = v
    return out


def parse_cli_overrides(argv) -> Dict[str, Any]:
    """['--model.d_model', '512', '--flag', 'true'] -> nested dict."""
    out: Dict[str, Any] = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise ValueError(f"expected --key, got {arg}")
        key = arg[2:]
        if "=" in key:
            key, value = key.split("=", 1)
            i += 1
        else:
            if i + 1 >= len(argv):
                raise ValueError(f"missing value for {arg}")
            value = argv[i + 1]
            i += 2
        cur = out
        parts = key.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = value
    return out


def merge_dicts(base: Dict, override: Dict) -> Dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_dicts(out[k], v)
        else:
            out[k] = v
    return out
