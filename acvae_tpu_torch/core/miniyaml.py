"""A YAML reader for the subset the repo's configs are written in.

The machine the port runs on has no PyYAML, so the port reads its configs
with this module.  ``safe_load(text)`` gives what ``yaml.safe_load`` gives
for:

* block mappings and block sequences (``- item``, also at the indentation of
  the parent key, as ``yaml.safe_dump`` writes them), nested and compact
  (``- key: value``);
* flow sequences and mappings (``[timemask, freqmask]``, ``{a: 1}``),
  nested, on one line;
* comments, and plain, single-quoted and double-quoted scalars;
* YAML 1.1's resolution of plain scalars, as PyYAML's ``SafeLoader`` does
  it: bool (``yes``/``on``/``true``..., any case PyYAML accepts), null
  (``~``, ``null``, empty), int (decimal, ``0b``, ``0x``, leading-0 octal,
  ``_`` separators, base 60) and float (a dot is required, an exponent needs
  its sign, ``.inf``/``.nan``, base 60); ``1e-3`` stays a string there, and
  ``core/config.py`` turns it into a float as the JAX package does.

Anything else (anchors and aliases, tags, block scalars ``|``/``>``,
document markers and several documents, directives, complex keys,
scalars and flow collections continued over lines, timestamps, merge keys)
raises ``ValueError`` naming the line.
"""
from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                      |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                      |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                      |[-+]?\.(?:inf|Inf|INF)
                      |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                          |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                          (?:[Tt]|[\ \t]+)[0-9][0-9]?
                          :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                          (?:[\ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_FLOW_END = ",[]{}"
_UNCLOSED = ("unclosed flow collection (one continued over lines is not "
             "supported)")


def _fail(line: int, what: str):
    raise ValueError(f"YAML line {line}: {what}")


def _base60(text: str, conv) -> Any:
    value = 0
    for part in text.split(":"):
        value = value * 60 + conv(part)
    return value


def resolve(text: str, line: int = 0) -> Any:
    """A plain scalar's value under YAML 1.1 (PyYAML's implicit resolvers,
    tried in its order: bool, float, int, merge, null, timestamp, value)."""
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        return sign * (_base60(v, float) if ":" in v else float(v))
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * (_base60(v, int) if ":" in v else int(v))
    if text == "<<":
        _fail(line, "merge keys are not supported")
    if _NULL.match(text):
        return None
    if _TIMESTAMP.match(text):
        _fail(line, f"timestamps are not supported ({text!r})")
    if text == "=":
        _fail(line, "the value key '=' is not supported")
    return text


def _quote_starts(s: str, i: int) -> bool:
    """Whether a quote at s[i] opens a quoted scalar (it does at the start
    of a node, not inside a plain scalar such as ``it's``)."""
    before = s[:i].rstrip(" ")
    if not before or before[-1] in "[{,":
        return True
    return before[-1] in ":-?" and len(before) < i


def _strip_comment(s: str, line: int) -> str:
    """``s`` without its comment (``#`` at the start or after a space,
    outside quotes) and without trailing spaces."""
    i, quote = 0, None
    while i < len(s):
        c = s[i]
        if quote == "'":
            if c == "'":
                if s[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif c in "'\"" and _quote_starts(s, i):
            quote = c
        elif c == "#" and (i == 0 or s[i - 1] in " \t"):
            return s[:i].rstrip(" \t")
        i += 1
    if quote is not None:
        _fail(line, "a quoted scalar continued over lines is not supported")
    return s.rstrip(" \t")


class _Reader:
    def __init__(self, text: str):
        self.lines: List[Tuple[int, int, str]] = []
        for n, raw in enumerate(text.splitlines(), 1):
            body = raw.lstrip(" ")
            indent = len(raw) - len(body)
            if body.startswith("\t") and body.strip():
                _fail(n, "tabs in indentation")
            body = _strip_comment(body, n)
            if not body:
                continue
            if body in ("---", "...") or body.startswith(("--- ", "... ")):
                _fail(n, "document markers and several documents are not "
                         "supported")
            if body.startswith("%"):
                _fail(n, "directives are not supported")
            self.lines.append((n, indent, body))
        self.i = 0

    def document(self) -> Any:
        if not self.lines:
            return None
        node = self.block(self.lines[0][1])
        if self.i < len(self.lines):
            n, _, body = self.lines[self.i]
            _fail(n, f"unexpected content {body!r} (bad indentation, or a "
                     f"plain scalar continued over lines)")
        return node

    # ---------------------------------------------------------------- block
    def block(self, indent: int) -> Any:
        n, _, body = self.lines[self.i]
        if body == "-" or body.startswith("- "):
            return self.sequence(indent)
        if self.key_split(body, n) is not None:
            return self.mapping(indent)
        self.i += 1
        return self.inline(body, n)

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.i < len(self.lines):
            n, ind, body = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                _fail(n, "bad indentation (or a plain scalar continued over "
                         "lines)")
            split = self.key_split(body, n)
            if split is None:
                _fail(n, f"expected 'key: value', got {body!r}")
            key_text, rest = split
            key = self.inline(key_text, n, key=True)
            self.i += 1
            if rest:
                out[key] = self.inline(rest, n)
                continue
            value = None
            if self.i < len(self.lines):
                _, nxt, nbody = self.lines[self.i]
                if nxt > indent:
                    value = self.block(nxt)
                elif nxt == indent and (nbody == "-" or nbody.startswith("- ")):
                    value = self.sequence(indent)
            out[key] = value
        return out

    def sequence(self, indent: int) -> list:
        out: list = []
        while self.i < len(self.lines):
            n, ind, body = self.lines[self.i]
            if ind > indent:
                _fail(n, "bad indentation (or a plain scalar continued over "
                         "lines)")
            if ind < indent or not (body == "-" or body.startswith("- ")):
                break
            rest = body[1:].lstrip(" ")
            if not rest:
                self.i += 1
                nested = (self.i < len(self.lines)
                          and self.lines[self.i][1] > indent)
                out.append(self.block(self.lines[self.i][1]) if nested else None)
                continue
            # a compact node ("- a: 1", "- - x"): read it as a block at the
            # column where it starts
            col = indent + len(body) - len(rest)
            self.lines[self.i] = (n, col, rest)
            out.append(self.block(col))
        return out

    def key_split(self, body: str, n: int) -> Optional[Tuple[str, str]]:
        """(key text, value text) of a ``key: value`` line, else None."""
        if body[0] in "[{":
            return None
        if body.startswith("? ") or body == "?":
            _fail(n, "complex keys are not supported")
        i = 0
        if body[0] in "'\"":
            i = self.quoted_end(body, 0, n)
        while True:
            j = body.find(":", i)
            if j < 0:
                return None
            if j + 1 == len(body) or body[j + 1] == " ":
                return body[:j].rstrip(" "), body[j + 1:].strip(" ")
            i = j + 1

    # --------------------------------------------------------------- inline
    def inline(self, text: str, n: int, key: bool = False) -> Any:
        """One node written on the line: a flow collection, a quoted scalar
        or a plain one."""
        if text[0] in "[{":
            if key:
                _fail(n, "flow collections as keys are not supported")
            node, end = self.flow(text, 0, n)
            if text[end:].strip(" "):
                _fail(n, f"unexpected text after a flow collection: "
                         f"{text[end:]!r}")
            return node
        if text[0] in "'\"":
            end = self.quoted_end(text, 0, n)
            if text[end:].strip(" "):
                _fail(n, f"unexpected text after a quoted scalar: "
                         f"{text[end:]!r}")
            return self.unquote(text[:end], n)
        self.check_plain(text, n)
        if ": " in text or text.endswith(":"):
            _fail(n, f"a mapping value is not allowed here ({text!r})")
        return resolve(text, n)

    @staticmethod
    def check_plain(text: str, n: int) -> None:
        c = text[0]
        if c in "&*":
            _fail(n, "anchors and aliases are not supported")
        if c == "!":
            _fail(n, "tags are not supported")
        if c in "|>":
            _fail(n, "block scalars are not supported")
        if c in "%@`":
            _fail(n, f"a plain scalar cannot start with {c!r}")
        if c in "-?:" and (len(text) == 1 or text[1] == " "):
            _fail(n, f"unexpected indicator {c!r}")

    def quoted_end(self, s: str, start: int, n: int) -> int:
        """Index just past the quoted scalar starting at ``s[start]``."""
        q, i = s[start], start + 1
        while i < len(s):
            if q == '"' and s[i] == "\\":
                i += 2
                continue
            if s[i] == q:
                if q == "'" and s[i + 1:i + 2] == "'":
                    i += 2
                    continue
                return i + 1
            i += 1
        _fail(n, "unclosed quoted scalar")

    @staticmethod
    def unquote(tok: str, n: int) -> str:
        body = tok[1:-1]
        if tok[0] == "'":
            return body.replace("''", "'")
        out, i = [], 0
        while i < len(body):
            c = body[i]
            if c != "\\":
                out.append(c)
                i += 1
                continue
            e = body[i + 1]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
            elif e in _HEX_ESCAPES:
                width = _HEX_ESCAPES[e]
                digits = body[i + 2:i + 2 + width]
                if len(digits) != width or not all(
                        d in "0123456789abcdefABCDEF" for d in digits):
                    _fail(n, f"bad escape \\{e}{digits}")
                out.append(chr(int(digits, 16)))
                i += 2 + width
            else:
                _fail(n, f"unknown escape \\{e}")
        return "".join(out)

    def flow(self, s: str, i: int, n: int) -> Tuple[Any, int]:
        """(node, index past it) of the flow node at or after ``s[i]``."""
        i = _skip(s, i)
        if i >= len(s):
            _fail(n, _UNCLOSED)
        c = s[i]
        if c == "[":
            out: list = []
            i += 1
            while True:
                i = _skip(s, i)
                if i >= len(s):
                    _fail(n, _UNCLOSED)
                if s[i] == "]":
                    return out, i + 1
                node, i = self.flow(s, i, n)
                i = _skip(s, i)
                if i < len(s) and s[i] == ":":
                    _fail(n, "single-pair mappings in a flow sequence are "
                             "not supported")
                out.append(node)
                i = self.flow_sep(s, i, "]", n)
                if s[i] == "]":
                    return out, i + 1
                i += 1
        if c == "{":
            mapping: dict = {}
            i += 1
            while True:
                i = _skip(s, i)
                if i >= len(s):
                    _fail(n, _UNCLOSED)
                if s[i] == "}":
                    return mapping, i + 1
                if s[i] in "[{":
                    _fail(n, "flow collections as keys are not supported")
                key, i = self.flow(s, i, n)
                i = _skip(s, i)
                value = None
                if i < len(s) and s[i] == ":":
                    i = _skip(s, i + 1)
                    if i < len(s) and s[i] not in ",}":
                        value, i = self.flow(s, i, n)
                mapping[key] = value
                i = self.flow_sep(s, i, "}", n)
                if s[i] == "}":
                    return mapping, i + 1
                i += 1
        if c in "'\"":
            end = self.quoted_end(s, i, n)
            return self.unquote(s[i:end], n), end
        j = i
        while j < len(s) and s[j] not in _FLOW_END and not (
                s[j] == ":" and (j + 1 == len(s) or s[j + 1] in " " + _FLOW_END)):
            j += 1
        text = s[i:j].rstrip(" ")
        if not text:
            _fail(n, f"empty entry in a flow collection: {s!r}")
        self.check_plain(text, n)
        return resolve(text, n), j

    @staticmethod
    def flow_sep(s: str, i: int, close: str, n: int) -> int:
        i = _skip(s, i)
        if i >= len(s):
            _fail(n, _UNCLOSED)
        if s[i] not in "," + close:
            _fail(n, f"expected ',' or {close!r} in a flow collection: {s!r}")
        return i


def _skip(s: str, i: int) -> int:
    while i < len(s) and s[i] == " ":
        i += 1
    return i


def safe_load(text) -> Any:
    """The value of a YAML document in the supported subset (``text`` a
    string or a file object)."""
    if not isinstance(text, str):
        text = text.read()
    return _Reader(text).document()
