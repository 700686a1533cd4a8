"""A reader for the YAML that albumentations writes (``A.save(...,
data_format='yaml')``), without PyYAML.

The JAX package reads the augmentation files with ``yaml.safe_load``
(``data/pipeline.py``).  The port reads them with this module on every
device, so it needs no PyYAML.  It takes the block-style subset those files
use and gives what ``yaml.safe_load`` gives for it:

- block mappings ``key: value`` and block sequences ``- item`` (a sequence
  may sit at its key's indentation, as albumentations writes it);
- flow lists of scalars, ``[a, b]``;
- scalars resolved as YAML 1.1 does: ints, floats (``1.0``, ``.5``,
  ``1.0e-3``, ``.inf``, ``.nan``), booleans (``true``/``false`` and
  ``yes``/``no``/``on``/``off``), ``null``/``~``, single- and
  double-quoted strings, and plain strings;
- full-line and trailing ``#`` comments.

Anything else (anchors and aliases, tags, flow mappings, block scalars,
document markers, nested flow lists, tabs, odd indentation) raises
``ValueError`` naming the line.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, List, Tuple

_NULLS = {"", "~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}
# YAML 1.1's decimal int and float forms, as PyYAML resolves them
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
# other YAML 1.1 number forms (octal, hex, binary, base 60): outside the
# subset rather than read as strings
_OTHER_NUMBER = re.compile(r"[-+]?(?:0[0-7_]+|0x[0-9a-fA-F_]+|0b[01_]+"
                           r"|[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?)$")
_INDICATORS = "&*!|>{}%@`"


class _Line:
    __slots__ = ("number", "indent", "text")

    def __init__(self, number: int, indent: int, text: str):
        self.number, self.indent, self.text = number, indent, text


def _fail(line_number: int, what: str):
    raise ValueError(f"line {line_number}: {what} is outside the YAML "
                     f"subset that albumentations writes")


def _strip_comment(text: str, number: int) -> str:
    """``text`` without a ``#`` comment (one at the start, or after a space,
    outside quotes)."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " [,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    if quote:
        _fail(number, "an unterminated quoted string")
    return text.rstrip()


def _lines(source: str) -> List[_Line]:
    lines = []
    for number, raw in enumerate(source.splitlines(), start=1):
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            _fail(number, "a tab in the indentation")
        text = _strip_comment(body, number)
        if not text:
            continue
        if text in ("---", "...") or text.startswith(("--- ", "%")):
            _fail(number, f"the document marker {text!r}")
        lines.append(_Line(number, len(raw) - len(body), text))
    return lines


def _split_key(text: str, number: int):
    """``(key, rest)`` when ``text`` is ``key: rest`` or ``key:``, else
    None."""
    if text[0] in "'\"":
        end = text.find(text[0], 1)
        while end != -1 and text[0] == "'" and text[end + 1:end + 2] == "'":
            end = text.find("'", end + 2)
        if end == -1:
            _fail(number, "an unterminated quoted key")
        after = text[end + 1:]
        if after == ":" or after.startswith(": "):
            return _scalar(text[:end + 1], number), after[1:].strip()
        return None
    if text[0] == "[":
        return None
    for i, ch in enumerate(text):
        if ch == ":" and (i + 1 == len(text) or text[i + 1] == " "):
            key = text[:i].rstrip()
            if key.startswith("? "):
                _fail(number, "a complex mapping key")
            return _scalar(key, number), text[i + 1:].strip()
    return None


def _unquote(text: str, number: int) -> str:
    body = text[1:-1]
    if text[0] == "'":
        if re.search(r"(?<!')'(?!')", body.replace("''", "")):
            _fail(number, "a stray single quote")
        return body.replace("''", "'")
    escapes = {'"': '"', "\\": "\\", "n": "\n", "t": "\t", "/": "/"}
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch == '"':
            _fail(number, "a stray double quote")
        if ch == "\\":
            nxt = body[i + 1:i + 2]
            if nxt not in escapes:
                _fail(number, f"the escape \\{nxt}")
            out.append(escapes[nxt])
            i += 2
            continue
        out.append(ch)
        i += 1
    return "".join(out)


def _scalar(text: str, number: int) -> Any:
    text = text.strip()
    if text and text[0] in "'\"":
        if len(text) < 2 or text[-1] != text[0]:
            _fail(number, f"the quoted scalar {text!r}")
        return _unquote(text, number)
    if text.startswith("["):
        return _flow_list(text, number)
    if text and text[0] in _INDICATORS:
        _fail(number, f"the indicator {text[0]!r}")
    if text.startswith("- ") or text == "-":
        _fail(number, "a sequence inside a mapping value")
    if text in _NULLS:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return float("-inf") if text[0] == "-" else float("inf")
    if _NAN.match(text):
        return float("nan")
    if _OTHER_NUMBER.match(text):
        _fail(number, f"the number form {text!r}")
    if ": " in text or text.endswith(":"):
        _fail(number, f"a mapping inside a scalar, {text!r}")
    return text


def _flow_list(text: str, number: int) -> list:
    if not text.endswith("]"):
        _fail(number, f"the flow list {text!r}")
    body = text[1:-1].strip()
    if not body:
        return []
    items, quote, start = [], None, 0
    for i, ch in enumerate(body):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch in "[]{}":
            _fail(number, "a nested flow collection")
        elif ch == ",":
            items.append(body[start:i])
            start = i + 1
    items.append(body[start:])
    if items[-1].strip() == "" and len(items) > 1:
        items.pop()  # a trailing comma
    return [_scalar(item, number) for item in items]


def _block(lines: List[_Line], i: int, indent: int) -> Tuple[Any, int]:
    """The node whose lines start at ``lines[i]`` (at ``indent``)."""
    if _is_item(lines[i].text):
        return _sequence(lines, i, indent)
    return _mapping(lines, i, indent)


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _mapping(lines: List[_Line], i: int, indent: int) -> Tuple[dict, int]:
    out = {}
    while i < len(lines) and lines[i].indent >= indent:
        line = lines[i]
        if line.indent > indent:
            _fail(line.number, "an indentation that opens no node")
        if _is_item(line.text):
            break  # a sequence at the parent key's indentation ends here
        split = _split_key(line.text, line.number)
        if split is None:
            _fail(line.number, f"the line {line.text!r} in a mapping")
        key, rest = split
        i += 1
        if rest:
            out[key] = _scalar(rest, line.number)
        elif i < len(lines) and lines[i].indent > indent:
            out[key], i = _block(lines, i, lines[i].indent)
        elif i < len(lines) and lines[i].indent == indent and _is_item(
                lines[i].text):
            out[key], i = _sequence(lines, i, indent)
        else:
            out[key] = None
    return out, i


def _sequence(lines: List[_Line], i: int, indent: int) -> Tuple[list, int]:
    out = []
    while i < len(lines) and lines[i].indent == indent and _is_item(
            lines[i].text):
        line = lines[i]
        rest = line.text[1:]
        content = rest.lstrip(" ")
        if not content:
            i += 1
            if i < len(lines) and lines[i].indent > indent:
                item, i = _block(lines, i, lines[i].indent)
            else:
                item = None
            out.append(item)
            continue
        # the item's content starts a node at its own column
        column = indent + 1 + len(rest) - len(content)
        if _is_item(content) or _split_key(content, line.number):
            lines[i] = _Line(line.number, column, content)
            item, i = _block(lines, i, column)
        else:
            item = _scalar(content, line.number)
            i += 1
        out.append(item)
    if i < len(lines) and lines[i].indent > indent:
        _fail(lines[i].number, "an indentation that opens no node")
    return out, i


def loads(source: str) -> Any:
    """The document in ``source``, as ``yaml.safe_load`` reads it."""
    lines = _lines(source)
    if not lines:
        return None
    if lines[0].indent != 0:
        _fail(lines[0].number, "an indented first line")
    if _split_key(lines[0].text, lines[0].number) is None and not _is_item(
            lines[0].text):
        value = _scalar(lines[0].text, lines[0].number)
        if len(lines) > 1:
            _fail(lines[1].number, "a second node after a scalar document")
        return value
    node, i = _block(lines, 0, 0)
    if i != len(lines):
        _fail(lines[i].number, f"the line {lines[i].text!r}")
    return node


def load(path) -> Any:
    """The YAML file at ``path``, as ``yaml.safe_load`` reads it."""
    return loads(Path(path).read_text())
