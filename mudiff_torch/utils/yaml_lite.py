"""A YAML reader for the experiment files, in place of ``yaml.safe_load``.

The card's machine has no PyYAML, so the port reads its experiment
files (``experiments/*.yaml``) with this module, always.  It reads a
subset of YAML 1.1 and gives what ``yaml.safe_load`` gives on it:

* block mappings and block sequences (a sequence may sit at its key's
  indentation), a sequence item holding a mapping (``- key: value``);
* flow sequences of scalars on one line (``[1, 2, 4]``);
* anchors and aliases on scalars, sequences and mappings (an alias is
  the anchored object itself, as PyYAML returns it);
* the ``<<`` merge key with one alias of a mapping: the explicit keys of
  the mapping win, wherever they stand;
* full-line and trailing comments;
* plain, single-quoted and double-quoted scalars.  Plain scalars are
  typed by PyYAML's YAML 1.1 resolver: ``1e-4`` (no dot) stays a
  string and ``1.0e-4`` is a float; ``yes`` / ``on`` / ``true`` are
  booleans; ``~`` / ``null`` / an empty value are None.

Anything else (tags, block scalars, flow mappings, multi-line flow or
plain scalars, documents, timestamps, tabs in the indentation) raises
``YamlError`` with the line number.  A document this module returns is
one PyYAML would return; one it cannot read it refuses.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1.
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
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_BOOL_VALUES = {"yes": True, "no": False, "true": True, "false": False,
                "on": True, "off": False}
_ANCHOR = re.compile(r"^[&*]([^\s\[\]{},]+)(?:\s+|$)")
# characters a plain scalar may not start with (YAML's indicators)
_PLAIN_START_BAD = set("[]{},#&*!|>'\"%@`")
_DQ_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
               "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
               "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0"}


class YamlError(ValueError):
    """Input outside the subset this reader takes, with its line number."""


def _int(text: str) -> int:
    value = text.replace("_", "")
    sign = -1 if value[0] == "-" else 1
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
        out = 0
        for part in value.split(":"):
            out = out * 60 + int(part)
        return sign * out
    return sign * int(value)


def _float(text: str) -> float:
    value = text.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        out = 0.0
        for part in value.split(":"):
            out = out * 60 + float(part)
        return sign * out
    return sign * float(value)


def resolve_plain(text: str, lineno: int = 0) -> Any:
    """A plain scalar typed as PyYAML's YAML 1.1 resolver types it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return _BOOL_VALUES[text.lower()]
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    if _TIMESTAMP.match(text) or text in ("=", "<<"):
        raise YamlError(f"line {lineno}: scalar {text!r} (timestamp, value or merge "
                        "outside a key) is outside the subset")
    return text


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str):
        self.no, self.indent, self.text = no, indent, text


def _strip_comment(text: str, no: int) -> str:
    """The line without its comment.  A quote opens a quoted scalar only
    where a scalar may start; a ``#`` starts a comment at the line's
    start or after a space, outside quotes."""
    quote = None
    i = 0
    while i < len(text):
        ch = text[i]
        if quote:
            if ch == "\\" and quote == '"':
                i += 2
                continue
            if ch == quote:
                if quote == "'" and text[i + 1:i + 2] == "'":
                    i += 2
                    continue
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " [,{:-"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    if quote:
        raise YamlError(f"line {no}: unterminated quoted scalar")
    return text.rstrip()


def _lines(source: str) -> List[_Line]:
    out = []
    for no, raw in enumerate(source.splitlines(), start=1):
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            raise YamlError(f"line {no}: tab in the indentation")
        text = _strip_comment(body, no)
        if not text:
            continue
        if text.startswith(("---", "...", "%")) and (len(text) == 3 or text[3:4] in " "):
            raise YamlError(f"line {no}: document markers and directives are outside "
                            "the subset")
        out.append(_Line(no, len(raw) - len(body), text))
    return out


def _find_colon(text: str) -> int:
    """Index of the ``:`` that ends a mapping key (followed by a space or
    the end of the line, outside quotes), or -1."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
            continue
        if ch in "'\"" and i == 0:
            quote = ch
        elif ch == ":" and (i + 1 == len(text) or text[i + 1] == " "):
            return i
        elif ch in "[{" and i == 0:
            return -1
    return -1


def _is_seq_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Parser:
    def __init__(self, source: str):
        self.lines = _lines(source)
        self.anchors: Dict[str, Any] = {}

    def error(self, i: int, what: str) -> YamlError:
        no = self.lines[i].no if i < len(self.lines) else (
            self.lines[-1].no if self.lines else 0)
        return YamlError(f"line {no}: {what}")

    # -- scalars ----------------------------------------------------------
    def quoted(self, text: str, no: int) -> Tuple[str, str]:
        """The quoted scalar at the start of ``text`` and what follows it."""
        q = text[0]
        out = []
        i = 1
        while i < len(text):
            ch = text[i]
            if q == "'" and ch == "'":
                if text[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), text[i + 1:]
            if q == '"' and ch == '"':
                return "".join(out), text[i + 1:]
            if q == '"' and ch == "\\":
                esc = text[i + 1:i + 2]
                if esc in _DQ_ESCAPES:
                    out.append(_DQ_ESCAPES[esc])
                    i += 2
                    continue
                m = re.match(r"x([0-9a-fA-F]{2})|u([0-9a-fA-F]{4})|U([0-9a-fA-F]{8})",
                             text[i + 1:])
                if not m:
                    raise YamlError(f"line {no}: unknown escape \\{esc}")
                out.append(chr(int(next(g for g in m.groups() if g), 16)))
                i += 1 + m.end()
                continue
            out.append(ch)
            i += 1
        raise YamlError(f"line {no}: unterminated quoted scalar")

    def scalar(self, text: str, no: int, flow: bool = False) -> Any:
        """A whole scalar: quoted (nothing may follow) or plain."""
        if text[:1] in ("'", '"'):
            value, rest = self.quoted(text, no)
            if rest.strip():
                raise YamlError(f"line {no}: text {rest.strip()!r} after a quoted scalar")
            return value
        bad = (text[:1] in _PLAIN_START_BAD or text.startswith(("? ", "- ", ": "))
               or text in ("?", "-", ":") or ": " in text or text.endswith(":")
               or " #" in text or (flow and any(c in text for c in "[]{},")))
        if bad:
            raise YamlError(f"line {no}: {text!r} is outside the subset (indicator, "
                            "nested mapping or flow collection)")
        return resolve_plain(text, no)

    def flow_seq(self, text: str, no: int) -> List[Any]:
        if not text.endswith("]"):
            raise YamlError(f"line {no}: a flow sequence must close on its line")
        body = text[1:-1]
        items, cur, quote = [], [], None
        for ch in body:
            if quote:
                cur.append(ch)
                if ch == quote:
                    quote = None
                continue
            if ch in "'\"" and not "".join(cur).strip():
                quote = ch
            elif ch in "[]{}":
                raise YamlError(f"line {no}: nested flow collections are outside the subset")
            if ch == ",":
                items.append("".join(cur).strip())
                cur = []
            else:
                cur.append(ch)
        last = "".join(cur).strip()
        if last or items:
            items.append(last)
        if items and items[-1] == "" and len(items) > 1:
            items.pop()  # a trailing comma
        if any(item == "" for item in items):
            raise YamlError(f"line {no}: empty entry in a flow sequence")
        for item in items:
            if item[:1] in "&*":
                raise YamlError(f"line {no}: anchors and aliases inside a flow sequence "
                                "are outside the subset")
        return [self.scalar(item, no, flow=True) for item in items]

    # -- nodes ------------------------------------------------------------
    def value(self, rest: str, i: int, indent: int, in_seq: bool) -> Tuple[Any, int]:
        """The node after ``key:`` or ``-`` on line ``i`` (``rest``, maybe
        empty), whose block content would sit below ``indent``; returns it
        and the index of the first line after it."""
        no = self.lines[i].no
        anchor = None
        m = _ANCHOR.match(rest)
        if m and rest[0] == "*":
            if rest[m.end():].strip():
                raise YamlError(f"line {no}: text after an alias")
            name = m.group(1)
            if name not in self.anchors:
                raise YamlError(f"line {no}: unknown alias *{name}")
            return self.anchors[name], i + 1
        if m:
            anchor, rest = m.group(1), rest[m.end():]
            if _find_colon(rest) >= 0 or _is_seq_item(rest):
                raise YamlError(f"line {no}: an anchor before an inline collection is "
                                "outside the subset")
        if rest:
            if rest[0] in "!|>{":
                raise YamlError(f"line {no}: tags, block scalars and flow mappings are "
                                "outside the subset")
            node = self.flow_seq(rest, no) if rest[0] == "[" else self.scalar(rest, no)
            j = i + 1
            if j < len(self.lines) and self.lines[j].indent > indent:
                raise YamlError(f"line {self.lines[j].no}: multi-line scalars and "
                                "unexpected indentation are outside the subset")
        else:
            j = i + 1
            nxt = self.lines[j] if j < len(self.lines) else None
            if nxt is not None and nxt.indent > indent:
                node, j = self.block(j, nxt.indent)
            elif (nxt is not None and nxt.indent == indent and not in_seq
                  and _is_seq_item(nxt.text)):
                node, j = self.seq(j, indent)  # a sequence at its key's indentation
            else:
                node = None
        if anchor is not None:
            self.anchors[anchor] = node
        return node, j

    def block(self, i: int, indent: int) -> Tuple[Any, int]:
        if _is_seq_item(self.lines[i].text):
            return self.seq(i, indent)
        return self.mapping(i, indent)

    def seq(self, i: int, indent: int) -> Tuple[List[Any], int]:
        out: List[Any] = []
        while i < len(self.lines) and self.lines[i].indent == indent \
                and _is_seq_item(self.lines[i].text):
            line = self.lines[i]
            rest = line.text[1:].lstrip(" ")
            col = indent + len(line.text) - len(rest)
            if rest and (_is_seq_item(rest) or (_find_colon(rest) >= 0
                                               and rest[0] not in "&*")):
                # an inline collection: re-read the rest as a line at its column
                self.lines[i] = _Line(line.no, col, rest)
                node, i = self.block(i, col)
            else:
                node, i = self.value(rest, i, indent, in_seq=True)
            out.append(node)
        if i < len(self.lines) and self.lines[i].indent > indent:
            raise self.error(i, "bad indentation")
        return out, i

    def mapping(self, i: int, indent: int) -> Tuple[Dict[Any, Any], int]:
        out: Dict[Any, Any] = {}
        merged: Optional[Dict[Any, Any]] = None
        explicit: Dict[Any, Any] = {}
        while i < len(self.lines) and self.lines[i].indent == indent:
            line = self.lines[i]
            if _is_seq_item(line.text):
                raise self.error(i, "a sequence item where a mapping key was expected")
            c = _find_colon(line.text)
            if c < 0:
                raise self.error(i, f"{line.text!r}: expected 'key: value'")
            key_text, rest = line.text[:c].strip(), line.text[c + 1:].strip()
            if not key_text:
                raise self.error(i, "empty mapping key")
            if key_text == "<<":
                if merged is not None:
                    raise self.error(i, "more than one merge key in a mapping")
                node, i = self.value(rest, i, indent, in_seq=False)
                if not isinstance(node, dict):
                    raise YamlError(f"line {line.no}: a merge key needs an alias of a mapping")
                merged = dict(node)
                continue
            if key_text[0] in "&*?!|>[{":
                raise self.error(i, f"key {key_text!r} is outside the subset")
            key = self.scalar(key_text, line.no)
            node, i = self.value(rest, i, indent, in_seq=False)
            explicit[key] = node
        if i < len(self.lines) and self.lines[i].indent > indent:
            raise self.error(i, "bad indentation")
        if merged is not None:
            out.update(merged)
        out.update(explicit)
        return out, i

    def document(self) -> Any:
        if not self.lines:
            return None
        first = self.lines[0]
        if first.indent != 0:
            raise YamlError(f"line {first.no}: the document must start at column 0")
        if len(self.lines) == 1 and not _is_seq_item(first.text) and _find_colon(first.text) < 0:
            return self.value(first.text, 0, -1, in_seq=False)[0]
        node, i = self.block(0, 0)
        if i != len(self.lines):
            raise self.error(i, "bad indentation")
        return node


def loads(source: str) -> Any:
    """Parse ``source``; what ``yaml.safe_load`` gives on the subset."""
    return _Parser(source).document()


def load(path: str) -> Any:
    """Parse the file at ``path``."""
    with open(path) as f:
        return loads(f.read())
