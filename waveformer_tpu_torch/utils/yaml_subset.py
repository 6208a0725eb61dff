"""A reader for the subset of YAML that configuration files use.

`safe_load(text)` reads what `yaml.safe_load` reads for these forms, with
the same values:

  * block mappings nested by indentation (`key: value`, `key:` + block);
  * flow lists (`[1, [2, 3], "a"]`), also across lines;
  * single- and double-quoted scalars, and plain scalars resolved as
    PyYAML's YAML 1.1 resolver resolves them (int, float, bool, null,
    else str);
  * `#` comments, and one `---` before the document.

Anything else (block sequences, anchors and aliases, tags, block scalars
`|` and `>`, flow mappings, complex keys, several documents, multi-line
plain or quoted scalars, timestamps, sexagesimal numbers, merge keys)
raises ValueError, so a file is read as PyYAML reads it or not at all.
The port uses it in place of PyYAML, which the machines it runs on may
not have.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

# PyYAML's implicit resolvers (yaml/resolver.py), one pattern per tag
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
# resolved by PyYAML to types this reader does not build
_UNSUPPORTED = re.compile(r"""^(?:[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?
                    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt\ \t].*)?
                    |<<|=)$""", re.X)
_BOOL_VALUES = {"yes": True, "no": False, "true": True, "false": False,
                "on": True, "off": False}
# characters that may not start a plain scalar
_INDICATORS = set("&*!|>%@`{}'\"[]#,")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028",
            "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Line:
    __slots__ = ("indent", "text", "number")

    def __init__(self, indent: int, text: str, number: int):
        self.indent, self.text, self.number = indent, text, number


def _error(number: int, msg: str) -> ValueError:
    return ValueError(f"line {number}: {msg}")


def _resolve_plain(s: str, number: int) -> Any:
    """A plain scalar's value, as PyYAML's resolver and constructor give it."""
    if _UNSUPPORTED.match(s):
        raise _error(number, f"unsupported plain scalar {s!r}")
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return _BOOL_VALUES[s.lower()]
    if _INT.match(s):
        v = s.replace("_", "")
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
        return sign * int(v)
    if _FLOAT.match(s):
        v = s.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        return sign * float(v)
    return s


def _double_quoted(s: str, i: int, number: int) -> Tuple[str, int]:
    """The double-quoted scalar starting at s[i] == '"', and the index after it."""
    out, i = [], i + 1
    while i < len(s):
        c = s[i]
        if c == '"':
            return "".join(out), i + 1
        if c == "\n":
            raise _error(number, "multi-line quoted scalars are not supported")
        if c == "\\":
            e = s[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
                continue
            if e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                digits = s[i + 2:i + 2 + n]
                if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                    raise _error(number, f"bad escape \\{e}{digits}")
                out.append(chr(int(digits, 16)))
                i += 2 + n
                continue
            raise _error(number, f"unknown escape \\{e}")
        out.append(c)
        i += 1
    raise _error(number, "unterminated double-quoted scalar")


def _single_quoted(s: str, i: int, number: int) -> Tuple[str, int]:
    out, i = [], i + 1
    while i < len(s):
        c = s[i]
        if c == "'":
            if s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if c == "\n":
            raise _error(number, "multi-line quoted scalars are not supported")
        out.append(c)
        i += 1
    raise _error(number, "unterminated single-quoted scalar")


def _skip_space(s: str, i: int) -> int:
    """Skip blanks, newlines and comments (a `#` after a blank) in flow text."""
    while i < len(s):
        if s[i] in " \t\n":
            i += 1
        elif s[i] == "#" and (i == 0 or s[i - 1] in " \t\n"):
            while i < len(s) and s[i] != "\n":
                i += 1
        else:
            break
    return i


class _Unterminated(ValueError):
    pass


def _flow_list(s: str, i: int, number: int) -> Tuple[list, int]:
    """The flow list starting at s[i] == '[', and the index after it."""
    out: List[Any] = []
    i += 1
    while True:
        i = _skip_space(s, i)
        if i >= len(s):
            raise _Unterminated(f"line {number}: unterminated flow list")
        if s[i] == "]":
            return out, i + 1
        if s[i] == ",":
            raise _error(number, "empty entry in a flow list")
        item, i = _flow_item(s, i, number)
        out.append(item)
        i = _skip_space(s, i)
        if i >= len(s):
            raise _Unterminated(f"line {number}: unterminated flow list")
        if s[i] == ",":
            i += 1
        elif s[i] != "]":
            raise _error(number, f"expected ',' or ']' in a flow list, got {s[i]!r}")


def _flow_item(s: str, i: int, number: int) -> Tuple[Any, int]:
    c = s[i]
    if c == "[":
        return _flow_list(s, i, number)
    if c == '"':
        return _double_quoted(s, i, number)
    if c == "'":
        return _single_quoted(s, i, number)
    start = i
    while i < len(s) and s[i] not in ",[]{}\n":
        if s[i] == "#" and s[i - 1] in " \t":
            break
        if s[i] == ":" and (i + 1 == len(s) or s[i + 1] in " \t\n,[]{}"):
            raise _error(number, "mappings inside flow lists are not supported")
        i += 1
    return _plain(s[start:i].rstrip(), number), i


def _plain(s: str, number: int) -> Any:
    if s and (s[0] in _INDICATORS or (s[0] in "-?:" and s[1:2] in ("", " "))):
        raise _error(number, f"unsupported YAML syntax {s!r}")
    return _resolve_plain(s, number)


def _block_scalar_text(text: str, number: int) -> Any:
    """A value written on one line in block context: quoted, a flow list
    (already complete), or plain up to a comment."""
    if text[0] == '"':
        value, i = _double_quoted(text, 0, number)
    elif text[0] == "'":
        value, i = _single_quoted(text, 0, number)
    elif text[0] == "[":
        value, i = _flow_list(text, 0, number)
    else:
        m = re.search(r"[ \t]#", text)
        plain = (text[:m.start()] if m else text).rstrip()
        if re.search(r":([ \t]|$)", plain):
            raise _error(number, "mapping values are not allowed here")
        return _plain(plain, number)
    if _skip_space(text, i) != len(text):
        raise _error(number, f"unexpected text after a value: {text[i:]!r}")
    return value


def _strip_comment(text: str) -> str:
    """Remove a trailing comment: a `#` after a blank, outside quotes (a
    quote opens only where a scalar may start)."""
    quote: Optional[str] = None
    i = 0
    while i < len(text):
        c = text[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 1
            elif c == quote:
                if quote == "'" and text[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif c in "\"'" and (i == 0 or text[i - 1] in " \t[,:-"):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _split_key(line: _Line) -> Optional[Tuple[Any, str]]:
    """(key, rest of the line) when the line is `key: ...`, else None."""
    text = line.text
    if text[0] in "\"'":
        quoted = _double_quoted if text[0] == '"' else _single_quoted
        key, i = quoted(text, 0, line.number)
        rest = text[i:].lstrip(" \t")
        if rest[:1] != ":" or rest[1:2] not in ("", " ", "\t"):
            return None
        return key, rest[1:].strip()
    m = re.search(r":([ \t]|$)", text)
    if not m:
        return None
    key = text[:m.start()].rstrip()
    if not key or key[0] == "?":
        raise _error(line.number, "complex keys are not supported")
    return _plain(key, line.number), text[m.end():].strip()


class _Reader:
    def __init__(self, text: str):
        self.raw = text.split("\n")
        self.pos = 0  # index into `raw` of the next line not yet read

    def peek(self) -> Optional[_Line]:
        """The next line with content, its comment removed (comment lines
        and blank lines are skipped)."""
        while self.pos < len(self.raw):
            raw = self.raw[self.pos]
            stripped = raw.lstrip(" ")
            body = _strip_comment(stripped.strip())
            if not body:
                self.pos += 1
                continue
            if stripped[0] == "\t":
                raise _error(self.pos + 1, "tabs in indentation are not supported")
            return _Line(len(raw) - len(stripped), body, self.pos + 1)
        return None

    def value_text(self, line: _Line, text: str) -> Any:
        """The value `text` of `line`, reading further lines while a flow
        list is open."""
        self.pos = line.number  # past `line`
        if not text.startswith("["):
            return _block_scalar_text(text, line.number)
        joined = text
        while True:
            try:
                return _block_scalar_text(joined, line.number)
            except _Unterminated:
                if self.pos >= len(self.raw):
                    raise
                joined += "\n" + self.raw[self.pos]
                self.pos += 1

    def node(self, indent: int) -> Any:
        line = self.peek()
        _refuse_sequence(line)
        if _split_key(line) is not None:
            return self.mapping(line.indent)
        value = self.value_text(line, line.text)
        nxt = self.peek()
        if nxt is not None and nxt.indent > indent:
            raise _error(nxt.number, "multi-line plain scalars are not supported")
        return value

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                raise _error(line.number, "bad indentation")
            _refuse_sequence(line)
            split = _split_key(line)
            if split is None:
                raise _error(line.number, f"expected 'key: value', got {line.text!r}")
            key, rest = split
            if rest:
                out[key] = self.value_text(line, rest)
                nxt = self.peek()
                if nxt is not None and nxt.indent > indent:
                    raise _error(nxt.number, "multi-line plain scalars are not supported")
                continue
            self.pos = line.number
            nxt = self.peek()
            out[key] = self.node(nxt.indent) if nxt is not None and nxt.indent > indent else None


def _refuse_sequence(line: _Line) -> None:
    if line.text == "-" or line.text.startswith(("- ", "-\t")):
        raise _error(line.number, "block sequences are not supported: write a flow list [a, b]")


def safe_load(text: str) -> Any:
    """The document in `text` (None for an empty one), as `yaml.safe_load`
    gives it for the subset above; ValueError on anything else."""
    reader = _Reader(text)
    line = reader.peek()
    if line is not None and line.text.startswith("%"):
        raise _error(line.number, "directives are not supported")
    if line is not None and (line.text == "---" or line.text.startswith("--- ")):
        if line.indent or line.text != "---":
            raise _error(line.number, "content after '---' is not supported")
        reader.pos = line.number
        line = reader.peek()
    if line is None:
        return None
    value = reader.node(line.indent)
    rest = reader.peek()
    if rest is not None:
        if rest.text.startswith(("---", "...")):
            raise _error(rest.number, "multi-document streams are not supported")
        raise _error(rest.number, "bad indentation")
    return value
