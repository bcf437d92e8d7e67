"""A reader for the YAML subset of LineMOD's ``gt.yml``.

The JAX package reads ``gt.yml`` with ``yaml.safe_load``
(``data/linemod.py:51``).  Real LineMOD files are an integer-keyed
mapping of block lists of mappings whose values are numbers or flow lists
of numbers (``cam_R_m2c: [0.09, 0.99, ...]``); ``yaml.safe_dump`` writes
the same data with block lists instead.  This module reads both forms,
and what else is made of:

- block mappings (``key: value``, or ``key:`` with the value on the lines
  below, indented deeper or a block list at the same indent);
- block lists (``- item``; an item may be a scalar, a flow list, a
  nested block, or a mapping whose first key follows the dash);
- flow lists of scalars on one line (``[1, 2.5, 3]``);
- plain scalars resolved as PyYAML's YAML 1.1 rules resolve them: null,
  booleans, decimal integers, floats (a dot is needed, and an exponent
  needs its sign: ``1.0e-05``), ``.inf`` / ``.nan``, and other plain
  words as strings;
- comment lines and a leading ``---``.

Anything else (quotes, anchors, aliases, tags, flow mappings, nested flow
lists, multi-line scalars, tabs) raises ``ValueError``.
"""
from __future__ import annotations

import re
from typing import Any, List, Tuple

_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|^[-+]?\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_SPECIAL = set("'\"&*!|>%@`{}[],#")


def _scalar(text: str) -> Any:
    t = text.strip()
    if t in _NULL:
        return None
    if t in _TRUE:
        return True
    if t in _FALSE:
        return False
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _FLOAT.match(t):
        return float(t.replace("_", ""))
    if _INF.match(t):
        return float("-inf") if t.startswith("-") else float("inf")
    if _NAN.match(t):
        return float("nan")
    if t[0] in _SPECIAL or t[0] in "-?:" and (len(t) == 1 or t[1] == " ") \
            or ": " in t or " #" in t:
        raise ValueError(f"YAML scalar outside the supported subset: {t!r}")
    return t


def _value(text: str) -> Any:
    """An inline value: a flow list of scalars or a plain scalar."""
    t = text.strip()
    if t.startswith("["):
        if not t.endswith("]"):
            raise ValueError(f"flow list must close on its line: {t!r}")
        body = t[1:-1].strip()
        if not body:
            return []
        if "[" in body or "{" in body:
            raise ValueError(f"nested flow collections: {t!r}")
        return [_scalar(x) for x in body.split(",")]
    return _scalar(t)


def _split_key(text: str) -> Tuple[Any, str]:
    if text.endswith(":"):
        key, rest = text[:-1], ""
    elif ": " in text:
        key, rest = text.split(": ", 1)
    else:
        raise ValueError(f"expected 'key: value': {text!r}")
    return _scalar(key), rest.strip()


class _Parser:
    def __init__(self, src: str):
        self.lines: List[Tuple[int, str]] = []
        for no, raw in enumerate(src.splitlines(), 1):
            if "\t" in raw:
                raise ValueError(f"line {no}: tabs are not supported")
            body = raw.rstrip()
            stripped = body.lstrip(" ")
            if not stripped or stripped.startswith("#"):
                continue
            if stripped in ("---", "...") and not self.lines:
                continue
            self.lines.append((len(body) - len(stripped), stripped))
        self.i = 0

    def _peek(self):
        return self.lines[self.i] if self.i < len(self.lines) else None

    def block(self, indent: int) -> Any:
        _, text = self.lines[self.i]
        if text == "-" or text.startswith("- "):
            return self.sequence(indent)
        return self.mapping(indent)

    def _nested(self, indent: int, allow_same_indent_list: bool) -> Any:
        nxt = self._peek()
        if nxt is None:
            return None
        ind, text = nxt
        if ind > indent:
            return self.block(ind)
        if (allow_same_indent_list and ind == indent
                and (text == "-" or text.startswith("- "))):
            return self.sequence(ind)
        return None

    def mapping(self, indent: int) -> dict:
        out = {}
        while True:
            cur = self._peek()
            if cur is None or cur[0] < indent:
                return out
            ind, text = cur
            if ind > indent:
                raise ValueError(f"bad indentation at {text!r}")
            if text == "-" or text.startswith("- "):
                return out
            key, rest = _split_key(text)
            self.i += 1
            if key in out:
                raise ValueError(f"duplicate key {key!r}")
            out[key] = (self._nested(indent, True) if rest == ""
                        else _value(rest))

    def sequence(self, indent: int) -> list:
        out = []
        while True:
            cur = self._peek()
            if cur is None or cur[0] != indent or not (
                    cur[1] == "-" or cur[1].startswith("- ")):
                if cur is not None and cur[0] > indent:
                    raise ValueError(f"bad indentation at {cur[1]!r}")
                return out
            item = cur[1][1:].lstrip(" ")
            if item == "":
                self.i += 1
                out.append(self._nested(indent, False))
                continue
            # The item's text continues as a block two columns in (or
            # wherever the dash's trailing spaces put it).
            col = indent + len(cur[1]) - len(item)
            if (item == "-" or item.startswith("- ")
                    or (not item.startswith("[") and (
                        item.endswith(":") or ": " in item))):
                self.lines[self.i] = (col, item)
                out.append(self.block(col))
            else:
                self.i += 1
                out.append(_value(item))


def loads(src: str) -> Any:
    """The document in ``src``, as ``yaml.safe_load`` gives it."""
    p = _Parser(src)
    if not p.lines:
        return None
    first_indent = p.lines[0][0]
    out = p.block(first_indent)
    if p.i != len(p.lines):
        raise ValueError(f"unexpected text: {p.lines[p.i][1]!r}")
    return out


def load(path: str) -> Any:
    with open(path) as f:
        return loads(f.read())
