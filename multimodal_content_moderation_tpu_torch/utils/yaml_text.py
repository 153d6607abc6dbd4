"""YAML text without the ``yaml`` package: a reader for the block subset the
configs use, and an emitter whose output equals ``yaml.safe_dump``.

``load_config`` (``utils/config.py``) reads with ``yaml.safe_load`` where
PyYAML is installed and with ``loads`` here where it is not; the training
entrypoint (``serving/entrypoint.py``) writes its resolved config with
``dumps``. Both follow PyYAML's YAML 1.1 rules:

- scalars resolve by PyYAML's implicit resolvers (``1.0e-5`` is a float,
  ``1e-5`` and ``1.0e5`` are strings, ``no`` / ``off`` are False, ``~`` is
  None, ``017`` is 15, ``1_000`` is 1000);
- the emitter sorts keys, writes floats as PyYAML does (``1.0e-05``),
  quotes exactly the strings PyYAML quotes and folds long strings at its
  width of 80 columns.

The reader takes nested block mappings and sequences (a sequence indented
or at its key's own indentation, ``- a: 1`` and ``- - x`` items), flow
sequences and mappings of scalars on one line (``[a, b]``,
``{wire: u8, attention: pallas}``), plain, single-quoted and one-line
double-quoted scalars, plain and single-quoted scalars folded over lines,
full-line and trailing comments. Anything else (anchors, tags, block
scalars, nested or multi-line flow collections, tabs, timestamps, document
markers) raises ``YAMLSubsetError`` with the file and line: nothing is
guessed.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Optional, Tuple


class YAMLSubsetError(ValueError):
    """The text is outside the subset this module reads or writes."""


# PyYAML's implicit resolvers (yaml/resolver.py), in its order of trial
_RESOLVERS = [
    ("bool", re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                        r"|on|On|ON|off|Off|OFF)$")),
    ("float", re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)),
    ("int", re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)),
    ("merge", re.compile(r"^(?:<<)$")),
    ("null", re.compile(r"^(?:~|null|Null|NULL|)$")),
    ("timestamp", re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)),
    ("value", re.compile(r"^(?:=)$")),
    ("yaml", re.compile(r"^(?:!|&|\*)$")),
]


def resolve_tag(text: str) -> str:
    """The tag PyYAML gives the plain scalar ``text`` ("str" when no implicit
    resolver matches)."""
    for tag, rx in _RESOLVERS:
        if rx.match(text):
            return tag
    return "str"


def _sexagesimal(value: str, kind):
    total = kind(0)
    for part in value.split(":"):
        total = total * 60 + kind(part)
    return total


def resolve_plain(text: str) -> Any:
    """A plain scalar's value by PyYAML's ``SafeConstructor`` rules; raises
    for the tags outside the subset (timestamps, ``<<``, ``=``)."""
    tag = resolve_tag(text)
    if tag == "str":
        return text
    if tag == "null":
        return None
    if tag == "bool":
        return text.lower() in ("yes", "true", "on")
    if tag in ("int", "float"):
        value = text.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        if value[0] in "+-":
            value = value[1:]
        if tag == "float":
            value = value.lower()
            if value == ".inf":
                return sign * math.inf
            if value == ".nan":
                return math.nan
            return sign * (_sexagesimal(value, float) if ":" in value else float(value))
        if value == "0":
            return 0
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value[0] == "0":
            return sign * int(value, 8)
        return sign * (_sexagesimal(value, int) if ":" in value else int(value))
    raise YAMLSubsetError(f"the plain scalar {text!r} resolves to !!{tag}")


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

_DOUBLE_ESCAPES = {
    "0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n", "v": "\x0b",
    "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
    "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029",
}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Reader:
    def __init__(self, text: str, name: str):
        self.name = name
        self.lines = text.split("\n")
        if self.lines and self.lines[-1] == "":
            self.lines.pop()
        self.i = 0
        for n, line in enumerate(self.lines):
            if "\t" in line:
                self.fail(n, "a tab")
        if self.lines and self.lines[0].startswith("\ufeff"):
            self.lines[0] = self.lines[0][1:]

    def fail(self, n: int, what: str):
        raise YAMLSubsetError(f"{self.name}:{n + 1}: {what} is outside the YAML subset "
                              "this reader takes (install PyYAML to read it)")

    def resolve(self, n: int, text: str) -> Any:
        try:
            return resolve_plain(text)
        except YAMLSubsetError as e:
            self.fail(n, str(e))

    # lines ------------------------------------------------------------------
    @staticmethod
    def _blank(line: str) -> bool:
        s = line.strip()
        return not s or s.startswith("#")

    def peek(self) -> Optional[Tuple[int, int, str]]:
        """(line number, indent, content) of the next significant line."""
        while self.i < len(self.lines) and self._blank(self.lines[self.i]):
            self.i += 1
        if self.i == len(self.lines):
            return None
        line = self.lines[self.i]
        content = line.lstrip(" ")
        return self.i, len(line) - len(content), content

    # document ---------------------------------------------------------------
    def document(self) -> Any:
        first = self.peek()
        if first is None:
            return None
        n, indent, content = first
        if content.startswith(("---", "...", "%")):
            self.fail(n, "a document marker or directive")
        if _is_item(content):
            value = self.sequence(indent)
        elif self._key_split(n, content) is not None:
            value = self.mapping(indent)
        elif content[0] in "[{":
            self.i += 1
            value = self.scalar(n, indent, content)
        else:
            self.fail(n, "a document that is a lone scalar")
        rest = self.peek()
        if rest is not None:
            self.fail(rest[0], "text after the document's top-level block")
        return value

    # blocks -----------------------------------------------------------------
    def mapping(self, indent: int) -> dict:
        out = {}
        while True:
            nxt = self.peek()
            if nxt is None or nxt[1] < indent:
                return out
            n, ind, content = nxt
            if ind > indent:
                self.fail(n, "unexpected indentation")
            split = self._key_split(n, content)
            if split is None:
                self.fail(n, "a line that is not a 'key: value' entry")
            key, rest = split
            self.i += 1
            out[key] = self.value_after(n, indent, rest)

    def sequence(self, indent: int) -> list:
        out = []
        while True:
            nxt = self.peek()
            if nxt is None or nxt[1] < indent:
                return out
            n, ind, content = nxt
            if ind > indent:
                self.fail(n, "unexpected indentation")
            if not _is_item(content):
                return out  # an indentless sequence ends at its parent's next key
            rest = content[1:].lstrip(" ")
            if _is_item(rest) or self._key_split(n, rest) is not None:
                # a collection opening on the item's line ("- a: 1", "- - x"):
                # read the line as if it began at the collection's column
                col = len(self.lines[n]) - len(rest)
                self.lines[n] = " " * col + rest
                out.append(self.sequence(col) if _is_item(rest) else self.mapping(col))
                continue
            self.i += 1
            out.append(self.value_after(n, indent, rest, in_sequence=True))

    def value_after(self, n: int, indent: int, rest: str, in_sequence: bool = False) -> Any:
        """The value that follows ``key:`` or ``-`` at column ``indent`` on line
        ``n`` (``rest``: the line's text after the indicator)."""
        if not rest or rest.startswith("#"):
            nxt = self.peek()
            if nxt is None or nxt[1] < indent:
                return None
            if nxt[1] == indent:
                # a sequence may sit at its key's own indentation
                if not in_sequence and _is_item(nxt[2]):
                    return self.sequence(indent)
                return None
            if _is_item(nxt[2]):
                return self.sequence(nxt[1])
            return self.mapping(nxt[1])
        return self.scalar(n, indent, rest)

    # keys -------------------------------------------------------------------
    def _key_split(self, n: int, content: str) -> Optional[Tuple[Any, str]]:
        """(key, text after the colon) when ``content`` opens with a simple
        key, else None."""
        if not content:
            return None
        if content[0] in "'\"":
            end = _quoted_end(content)
            if end is None or not content[end:].startswith(":"):
                return None
            after = content[end + 1:]
            if after and after[0] != " ":
                return None
            return _unquote(content[:end], self, n), after.lstrip(" ")
        m = re.search(r":(?: |$)", content)
        if m is None or " #" in content[: m.start()]:
            return None
        key = content[: m.start()].rstrip(" ")
        if not key or key[0] in "-?:,[]{}#&*!|>%@`" and not (
                key[0] in "-?:" and len(key) > 1 and key[1] != " "):
            return None
        return self.resolve(n, key), content[m.end():].lstrip(" ")

    # scalars ----------------------------------------------------------------
    def scalar(self, n: int, indent: int, text: str) -> Any:
        head = text[0]
        if head == "'":
            return self.single_quoted(n, indent, text)
        if head == '"':
            end = _quoted_end(text)
            if end is None:
                self.fail(n, "a double-quoted scalar over several lines")
            self._trailer(n, text[end:])
            return _unquote(text[:end], self, n)
        if head in "[{":
            return self.flow(n, text)
        if head in "&*!|>%@`" or text[:2] in ("- ", "? ", ": ") or text in ("-", "?", ":"):
            self.fail(n, f"a value opening with {head!r}")
        parts = [self._plain_line(n, text)]
        # a plain scalar folded over the lines indented past its key
        while self.i < len(self.lines):
            line = self.lines[self.i]
            content = line.lstrip(" ")
            if not content or content.startswith("#") or len(line) - len(content) <= indent:
                break
            parts.append(self._plain_line(self.i, content))
            self.i += 1
        return self.resolve(n, " ".join(parts))

    def _plain_line(self, n: int, text: str) -> str:
        cut = text.find(" #")
        if cut >= 0:
            text = text[:cut]
        text = text.rstrip(" ")
        if re.search(r":(?: |$)", text):
            self.fail(n, "': ' inside a plain scalar")
        return text

    def _trailer(self, n: int, rest: str) -> None:
        rest = rest.lstrip(" ")
        if rest and not rest.startswith("#"):
            self.fail(n, f"text {rest!r} after a closed scalar")

    def single_quoted(self, n: int, indent: int, text: str) -> str:
        chunks, body, line_no = [], text[1:], n
        while True:
            j = 0
            while True:
                k = body.find("'", j)
                if k < 0:
                    break
                if body[k + 1: k + 2] == "'":
                    j = k + 2
                    continue
                chunks.append(body[:k].replace("''", "'"))
                self._trailer(line_no, body[k + 1:])
                return _fold(chunks)
            chunks.append(body.replace("''", "'"))
            if self.i >= len(self.lines):
                self.fail(line_no, "an unterminated quoted scalar")
            line = self.lines[self.i]
            content = line.lstrip(" ")
            if not content or len(line) - len(content) <= indent:
                self.fail(self.i, "a quoted scalar with a blank or unindented line")
            line_no, body = self.i, content
            self.i += 1

    def flow(self, n: int, text: str):
        """A flow sequence or mapping of scalars on one line: ``[a, 'b c']``,
        ``{wire: u8, attention: pallas}``, ``[]``, ``{}``."""
        close = "]" if text[0] == "[" else "}"
        out = [] if close == "]" else {}
        pos = 1

        def skip(p):
            while p < len(text) and text[p] == " ":
                p += 1
            if p >= len(text):
                self.fail(n, "a flow collection over several lines")
            return p

        def scalar_at(p):
            ch = text[p]
            if ch in "'\"":
                end = _quoted_end(text[p:])
                if end is None:
                    self.fail(n, "an unterminated quoted scalar")
                return _unquote(text[p: p + end], self, n), p + end
            if ch in "[]{},#&*!|>%@`?":
                self.fail(n, f"{ch!r} in a flow collection")
            j = p
            while j < len(text) and text[j] not in ",[]{}" and not (
                    text[j] == ":" and text[j + 1: j + 2] in ("", " ", ",", "]", "}")) and not (
                    text[j] == "#" and text[j - 1] == " "):
                j += 1
            return self.resolve(n, text[p:j].rstrip(" ")), j

        while True:
            pos = skip(pos)
            if text[pos] == close and not out:
                break
            value, pos = scalar_at(pos)
            if close == "}":
                pos = skip(pos)
                if text[pos] != ":":
                    self.fail(n, "a flow mapping entry without ': '")
                pos = skip(pos + 1)
                key = value
                value, pos = (None, pos) if text[pos] in ",}" else scalar_at(pos)
                out[key] = value
            else:
                out.append(value)
            pos = skip(pos)
            if text[pos] == ",":
                pos += 1
                continue
            if text[pos] != close:
                self.fail(n, "a flow collection that is not one line of scalars")
            break
        self._trailer(n, text[pos + 1:])
        return out


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _quoted_end(text: str) -> Optional[int]:
    """Index just past the quoted scalar that opens ``text``, or None when it
    does not close on this line."""
    q = text[0]
    j = 1
    while j < len(text):
        ch = text[j]
        if q == '"' and ch == "\\":
            j += 2
            continue
        if ch == q:
            if q == "'" and text[j + 1: j + 2] == "'":
                j += 2
                continue
            return j + 1
        j += 1
    return None


def _unquote(token: str, reader: _Reader, n: int) -> str:
    body = token[1:-1]
    if token[0] == "'":
        return body.replace("''", "'")
    out, j = [], 0
    while j < len(body):
        ch = body[j]
        if ch != "\\":
            out.append(ch)
            j += 1
            continue
        code = body[j + 1: j + 2]
        if code in _DOUBLE_ESCAPES:
            out.append(_DOUBLE_ESCAPES[code])
            j += 2
        elif code in _HEX_ESCAPES:
            width = _HEX_ESCAPES[code]
            digits = body[j + 2: j + 2 + width]
            if not re.fullmatch(r"[0-9a-fA-F]{%d}" % width, digits):
                reader.fail(n, f"a bad escape \\{code}{digits}")
            out.append(chr(int(digits, 16)))
            j += 2 + width
        else:
            reader.fail(n, f"an unknown escape \\{code}")
    return "".join(out)


def _fold(chunks: List[str]) -> str:
    """Join the lines of a folded quoted scalar: each line break and the
    spaces around it become one space."""
    if len(chunks) == 1:
        return chunks[0]
    parts = [chunks[0].rstrip(" ")]
    parts += [c.strip(" ") for c in chunks[1:-1]]
    parts.append(chunks[-1].lstrip(" "))
    return " ".join(parts)


def loads(text: str, name: str = "<string>") -> Any:
    """The value of a YAML document in the block subset (None for an empty
    one), equal to ``yaml.safe_load(text)``; ``name`` labels errors."""
    return _Reader(text, name).document()


# ---------------------------------------------------------------------------
# Emitter
# ---------------------------------------------------------------------------

BEST_WIDTH = 80  # PyYAML's default width
_SPACE_AFTER = "\0 \t\r\n\x85\u2028\u2029"


def _plain_allowed(scalar: str) -> bool:
    """``allow_block_plain`` of PyYAML's ``Emitter.analyze_scalar`` for a
    printable-ASCII string without line breaks, which PyYAML writes plain
    or single-quoted; other strings raise (PyYAML writes them
    double-quoted)."""
    if not scalar:
        return True
    for ch in scalar:
        if not "\x20" <= ch <= "\x7e":
            raise YAMLSubsetError(f"{scalar!r}: PyYAML writes this string double-quoted, "
                                  "which this emitter does not")
    block_indicators = scalar.startswith(("---", "..."))
    followed = len(scalar) == 1 or scalar[1] in _SPACE_AFTER
    preceded = True
    for index, ch in enumerate(scalar):
        if index == 0:
            if ch in "#,[]{}&*!|>'\"%@`":
                block_indicators = True
            if ch in "?:" and followed:
                block_indicators = True
            if ch == "-" and followed:
                block_indicators = True
        else:
            if ch == ":" and followed:
                block_indicators = True
            if ch == "#" and preceded:
                block_indicators = True
        preceded = ch in _SPACE_AFTER
        followed = index + 2 >= len(scalar) or scalar[index + 2] in _SPACE_AFTER
    edge_space = scalar[0] == " " or scalar[-1] == " "
    return not (edge_space or block_indicators)


class _Writer:
    """The part of PyYAML's ``Emitter`` state that decides where a long
    scalar folds: the column, the current indent and the whitespace flag."""

    def __init__(self):
        self.out: List[str] = []
        self.column = 0
        self.whitespace = True
        self.indention = True
        self.indent = 0

    def write(self, data: str) -> None:
        self.out.append(data)
        self.column += len(data)

    def write_indent(self) -> None:
        if not self.indention or self.column > self.indent or (
                self.column == self.indent and not self.whitespace):
            self.out.append("\n")
            self.column = 0
            self.whitespace = True
            self.indention = True
        if self.column < self.indent:
            self.whitespace = True
            self.write(" " * (self.indent - self.column))

    def indicator(self, indicator: str, need_whitespace: bool, indention: bool = False) -> None:
        self.write(indicator if self.whitespace or not need_whitespace else " " + indicator)
        self.whitespace = False
        self.indention = self.indention and indention

    def plain(self, text: str, split: bool) -> None:
        if not text:
            return
        if not self.whitespace:
            self.write(" ")
        self.whitespace = False
        self.indention = False
        spaces = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if start + 1 == end and self.column > BEST_WIDTH and split:
                        self.write_indent()
                        self.whitespace = False
                        self.indention = False
                    else:
                        self.write(text[start:end])
                    start = end
            elif ch is None or ch == " ":
                self.write(text[start:end])
                start = end
            if ch is not None:
                spaces = ch == " "
            end += 1

    def single_quoted(self, text: str, split: bool) -> None:
        self.indicator("'", True)
        spaces = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch is None or ch != " ":
                    if (start + 1 == end and self.column > BEST_WIDTH and split
                            and start != 0 and end != len(text)):
                        self.write_indent()
                    else:
                        self.write(text[start:end])
                    start = end
            elif ch is None or ch == " " or ch == "'":
                if start < end:
                    self.write(text[start:end])
                    start = end
            if ch == "'":
                self.write("''")
                start = end + 1
            if ch is not None:
                spaces = ch == " "
            end += 1
        self.indicator("'", False)


def _scalar_text(value: Any) -> Tuple[str, bool]:
    """(text, implicit): PyYAML's representation of a scalar, and whether
    its plain form would resolve back to the same type (only then may it be
    written plain)."""
    if value is None:
        return "null", True
    if isinstance(value, bool):
        return ("true" if value else "false"), True
    if isinstance(value, int):
        return str(value), True
    if isinstance(value, float):
        if value != value:
            return ".nan", True
        if value in (math.inf, -math.inf):
            return (".inf" if value > 0 else "-.inf"), True
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text, True
    if isinstance(value, str):
        return value, resolve_tag(value) == "str"
    raise YAMLSubsetError(f"{type(value).__name__} {value!r}: PyYAML's safe_dump "
                          "does not represent it")


def _write_scalar(w: _Writer, value: Any, simple_key: bool) -> None:
    text, implicit = _scalar_text(value)
    plain_ok = _plain_allowed(text)
    if simple_key and (not text or len(text) >= 128):
        raise YAMLSubsetError(f"key {text!r}: PyYAML writes it as a complex key")
    if implicit and plain_ok:
        w.plain(text, split=not simple_key)
    else:
        w.single_quoted(text, split=not simple_key)


def _write_node(w: _Writer, value: Any, indent: int, after: str) -> None:
    """Write ``value`` whose indicator (``after``: "key", "item" or "root")
    was just written, with its block content at column ``indent``."""
    if isinstance(value, dict) and value:
        items = list(value.items())
        try:
            items.sort()
        except TypeError:
            pass
        for n, (k, v) in enumerate(items):
            w.indent = indent
            if not (after == "item" and n == 0):
                w.write_indent()
            _write_scalar(w, k, simple_key=True)
            w.indicator(":", False)
            if isinstance(v, list) and v:
                _write_node(w, v, indent, "key")  # PyYAML's indentless sequence
            else:
                _write_node(w, v, indent + 2, "key")
    elif isinstance(value, list) and value:
        for n, item in enumerate(value):
            w.indent = indent
            if not (after == "item" and n == 0):
                w.write_indent()
            w.indicator("-", True, indention=True)
            _write_node(w, item, indent + 2, "item")
    elif isinstance(value, (dict, list)):
        w.indicator("{}" if isinstance(value, dict) else "[]", True)
    else:
        w.indent = indent
        _write_scalar(w, value, simple_key=False)


def dumps(data: Any) -> str:
    """``yaml.safe_dump(data)`` (sorted keys, block style, width 80) for a
    dict or list of dicts, lists, None, bools, ints, floats and printable
    ASCII strings; raises ``YAMLSubsetError`` for what it cannot write the
    same way."""
    if not isinstance(data, (dict, list)):
        raise YAMLSubsetError("the emitter writes a mapping or a sequence at the top")
    w = _Writer()
    if not data:
        w.write("{}" if isinstance(data, dict) else "[]")
    else:
        _write_node(w, data, 0, "root")
    return "".join(w.out) + "\n"
