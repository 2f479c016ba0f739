"""Read and write the subset of YAML that recipes and ``--set`` values use.

The port has no ``yaml`` package, so it reads recipes itself: block
mappings and sequences by indentation, flow mappings and lists (which may
span lines), comments, single- and double-quoted strings, and plain
scalars. Plain scalars resolve as PyYAML's ``safe_load`` resolves them,
which follows YAML 1.1: ``~``/``null``/empty is None; ``yes``/``no``/
``on``/``off``/``true``/``false`` (three spellings each) are booleans; ints
take ``0b``, ``0x``, a leading-zero octal and ``_`` separators; a float
needs a dot, so ``2e-4`` stays a string while ``1.0e-4`` is a float (an
exponent also needs its sign); ``YYYY-MM-DD`` is a date. Anchors, aliases,
tags, block scalars (``|``, ``>``) and complex keys are outside the subset
and raise :class:`YAMLError`.

:func:`dump` writes block mappings with flow lists and double-quoted
strings, floats always with a dot, so what it writes reads back to the same
values here and through ``yaml.safe_load``.
"""

from __future__ import annotations

import datetime
import json
import math
import re
from typing import Any


class YAMLError(ValueError):
    """Text outside the subset, or not YAML."""


_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_DATE = re.compile(r"^([0-9]{4})-([0-9]{2})-([0-9]{2})$")
_FLOW_END = ",[]{}"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": " ",
            "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(value: str, cast) -> Any:
    total = cast(0)
    for part in value.split(":"):
        total = total * 60 + cast(part)
    return total


def resolve_plain(text: str) -> Any:
    """The value PyYAML's ``safe_load`` gives a plain (unquoted) scalar."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
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
            return sign * _sexagesimal(value, int)
        return sign * int(value)
    if _FLOAT.match(text):
        value = text.replace("_", "").lower()
        sign = -1.0 if value[0] == "-" else 1.0
        if value[0] in "+-":
            value = value[1:]
        if value == ".inf":
            return sign * math.inf
        if value == ".nan":
            return math.nan
        if ":" in value:
            return sign * _sexagesimal(value, float)
        return sign * float(value)
    m = _DATE.match(text)
    if m:
        return datetime.date(int(m.group(1)), int(m.group(2)), int(m.group(3)))
    return text


class _Flow:
    """A scanner over one line of text in flow (or single-value) context."""

    def __init__(self, text: str):
        self.s = text
        self.i = 0

    def skip(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out = []
        while True:
            if self.i >= len(self.s):
                raise YAMLError("unterminated quoted scalar")
            c = self.s[self.i]
            if q == "'":
                if c == "'":
                    if self.s[self.i + 1:self.i + 2] == "'":
                        out.append("'")
                        self.i += 2
                        continue
                    self.i += 1
                    return "".join(out)
            else:
                if c == '"':
                    self.i += 1
                    return "".join(out)
                if c == "\\":
                    e = self.s[self.i + 1:self.i + 2]
                    if e in _ESCAPES:
                        out.append(_ESCAPES[e])
                        self.i += 2
                        continue
                    if e in _HEX_ESCAPES:
                        n = _HEX_ESCAPES[e]
                        code = self.s[self.i + 2:self.i + 2 + n]
                        if len(code) != n or not re.fullmatch(r"[0-9a-fA-F]+", code):
                            raise YAMLError(f"bad escape \\{e}{code}")
                        out.append(chr(int(code, 16)))
                        self.i += 2 + n
                        continue
                    raise YAMLError(f"unknown escape \\{e}")
            out.append(c)
            self.i += 1

    def plain(self, flow: bool) -> str:
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            nxt = self.s[self.i + 1:self.i + 2]
            if c == ":" and (nxt in ("", " ", "\t") or (flow and nxt in _FLOW_END)):
                break
            if c == "#" and self.i > start and self.s[self.i - 1] in " \t":
                break
            if flow and c in _FLOW_END:
                break
            self.i += 1
        return self.s[start:self.i].rstrip()

    def node(self, flow: bool) -> Any:
        self.skip()
        c = self.peek()
        if c == "[":
            return self.sequence()
        if c == "{":
            return self.mapping()
        if c in ("'", '"'):
            return self.quoted()
        if c and c in "&*!|>%@`":
            raise YAMLError(f"{c!r} starts syntax outside the recipe subset")
        if c in ("-", "?", ":") and self.s[self.i + 1:self.i + 2] in ("", " ", "\t"):
            raise YAMLError(f"block indicator {c!r} inside a flow value")
        if flow and c in _FLOW_END:
            raise YAMLError(f"expected a flow entry at {self.s[self.i:]!r}")
        return resolve_plain(self.plain(flow))

    def entry(self) -> tuple[Any, Any, bool]:
        """(key, value, is_pair) of one flow entry."""
        key = self.node(True)
        self.skip()
        if self.peek() == ":":
            self.i += 1
            self.skip()
            value = None if self.peek() in (",", "]", "}", "") else self.node(True)
            return key, value, True
        return key, None, False

    def sequence(self) -> list:
        self.i += 1
        out = []
        while True:
            self.skip()
            if self.peek() == "]":
                self.i += 1
                return out
            if not self.peek():
                raise YAMLError("unterminated flow sequence")
            key, value, pair = self.entry()
            out.append({_hashable(key): value} if pair else key)
            self.skip()
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "]":
                raise YAMLError(f"expected ',' or ']' at {self.s[self.i:]!r}")

    def mapping(self) -> dict:
        self.i += 1
        out: dict = {}
        while True:
            self.skip()
            if self.peek() == "}":
                self.i += 1
                return out
            if not self.peek():
                raise YAMLError("unterminated flow mapping")
            key, value, _ = self.entry()
            out[_hashable(key)] = value
            self.skip()
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "}":
                raise YAMLError(f"expected ',' or '}}' at {self.s[self.i:]!r}")


def _hashable(key: Any) -> Any:
    if isinstance(key, (list, dict)):
        raise YAMLError("complex mapping keys are outside the recipe subset")
    return key


def _value(text: str) -> Any:
    """One complete value: a flow collection, a quoted or a plain scalar."""
    scan = _Flow(text)
    value = scan.node(False)
    scan.skip()
    rest = scan.s[scan.i:]
    if rest and not rest.startswith("#"):
        if rest.startswith(":"):
            raise YAMLError(f"mapping values are not allowed here: {text!r}")
        raise YAMLError(f"unexpected text after a value: {rest!r}")
    return value


def _strip_comment(line: str) -> str:
    """``line`` without its comment (a ``#`` at the start or after a blank,
    outside quotes)."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
            elif c == "\\" and quote == '"':
                continue
        elif c in ("'", '"') and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _depth(text: str) -> int:
    """Open flow brackets at the end of ``text``, outside quotes."""
    depth, quote = 0, None
    for i, c in enumerate(text):
        if quote:
            if c == quote:
                quote = None
        elif c in ("'", '"') and (i == 0 or text[i - 1] in " \t[{,:-"):
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
    return depth


def _lines(text: str) -> list[tuple[int, str]]:
    """(indent, content) of each line that holds content, flow collections
    that span lines joined into one."""
    out: list[tuple[int, str]] = []
    pending = None
    for raw in text.splitlines():
        line = _strip_comment(raw)
        content = line.lstrip(" ")
        if content.startswith("\t"):
            raise YAMLError("tabs are not allowed in indentation")
        if pending is not None:
            pending = (pending[0], pending[1] + " " + content.strip())
            if _depth(pending[1]) <= 0:
                out.append(pending)
                pending = None
            continue
        if not content or content in ("---", "..."):
            continue
        item = (len(line) - len(content), content)
        if _depth(content) > 0:
            pending = item
        else:
            out.append(item)
    if pending is not None:
        raise YAMLError("unterminated flow collection")
    return out


def _split_key(content: str) -> tuple[str, str] | None:
    """(key text, rest) when ``content`` is a ``key: value`` line."""
    scan = _Flow(content)
    c = scan.peek()
    if c in "[{":
        return None
    if c in ("'", '"'):
        scan.quoted()
        scan.skip()
        if scan.peek() == ":" and content[scan.i + 1:scan.i + 2] in ("", " ", "\t"):
            return content[:scan.i], content[scan.i + 1:].strip()
        return None
    scan.plain(False)
    if scan.peek() == ":":
        return content[:scan.i], content[scan.i + 1:].strip()
    return None


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith(("- ", "-\t"))


class _Block:
    def __init__(self, lines: list[tuple[int, str]]):
        self.lines = lines
        self.i = 0

    def node(self, indent: int) -> Any:
        ind, content = self.lines[self.i]
        if _is_item(content):
            return self.sequence(ind)
        if _split_key(content) is not None:
            return self.mapping(ind)
        self.i += 1
        return _value(content)

    def _child(self, parent: int, allow_seq_at_parent: bool) -> Any:
        """The value on the lines after a ``key:`` or a bare ``-``."""
        if self.i < len(self.lines):
            ind, content = self.lines[self.i]
            if ind > parent or (allow_seq_at_parent and ind == parent
                                and _is_item(content)):
                return self.node(ind)
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.i < len(self.lines):
            ind, content = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise YAMLError(f"bad indentation at {content!r}")
            split = _split_key(content)
            if split is None:
                raise YAMLError(f"expected 'key: value' at {content!r}")
            key = _hashable(_value(split[0]))
            self.i += 1
            out[key] = (_value(split[1]) if split[1]
                        else self._child(indent, allow_seq_at_parent=True))
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            ind, content = self.lines[self.i]
            if ind < indent or (ind == indent and not _is_item(content)):
                break
            if ind > indent:
                raise YAMLError(f"bad indentation at {content!r}")
            rest = content[1:].lstrip(" \t")
            if not rest:
                self.i += 1
                out.append(self._child(indent, allow_seq_at_parent=False))
                continue
            # the item's content starts a node at its own column
            self.lines[self.i] = (indent + len(content) - len(rest), rest)
            out.append(self.node(indent + len(content) - len(rest)))
        return out


def loads(text: str) -> Any:
    """Parse one YAML document of the subset (``yaml.safe_load``)."""
    lines = _lines(text)
    if not lines:
        return None
    block = _Block(lines)
    value = block.node(lines[0][0])
    if block.i != len(lines):
        raise YAMLError(f"unexpected content at {lines[block.i][1]!r}")
    return value


_PLAIN_KEY = re.compile(r"^[A-Za-z_][A-Za-z0-9_.\-]*$")


def _scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        if "." not in text:  # 1e-05 reads back as a string in YAML 1.1
            mant, _, exp = text.partition("e")
            text = f"{mant}.0" + (f"e{exp}" if exp else "")
        if "e" in text and text.split("e")[1][0] not in "+-":
            text = text.replace("e", "e+")
        return text
    if isinstance(value, str):
        return json.dumps(value, ensure_ascii=False)
    if isinstance(value, datetime.date):
        return value.isoformat()
    raise TypeError(f"cannot write {type(value).__name__} as YAML")


def _flow(value: Any) -> str:
    if isinstance(value, dict):
        return "{" + ", ".join(f"{_key(k)}: {_flow(v)}" for k, v in value.items()) + "}"
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_flow(v) for v in value) + "]"
    return _scalar(value)


def _key(key: Any) -> str:
    if isinstance(key, str) and _PLAIN_KEY.match(key) and resolve_plain(key) == key:
        return key
    return _scalar(key)


def dump(value: Any, indent: int = 0) -> str:
    """``value`` as YAML text: mappings in block style, lists in flow style."""
    if not isinstance(value, dict):
        return " " * indent + _flow(value) + "\n"
    lines = []
    for k, v in value.items():
        if isinstance(v, dict) and v:
            lines.append(" " * indent + f"{_key(k)}:\n" + dump(v, indent + 2))
        else:
            lines.append(" " * indent + f"{_key(k)}: {_flow(v)}\n")
    return "".join(lines) if lines else " " * indent + "{}\n"
