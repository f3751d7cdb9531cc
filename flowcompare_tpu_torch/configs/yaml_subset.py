"""A reader for the YAML that config files use, without PyYAML.

The JAX package's CLI reads config files with `yaml.safe_load`: a plain
`key: value` file, or wandb's `{key: {desc, value}}` file. This module reads
the same files into the same Python values, for a machine without PyYAML:

* block mappings and block sequences (indented or not under a key, and
  `- key: value` items), nested to any depth;
* flow sequences of scalars (`[512, 512]`, `[]`), on one line or more;
* comments, and plain, single-quoted and double-quoted scalars (quoted ones
  may span lines, folded as YAML folds them);
* plain scalars typed as `yaml.safe_load` types them (YAML 1.1's core
  schema): null (`~`, `null`, empty), bool (`true`, `yes`, `on`, ...), int
  (decimal, `0b`, `0x`, leading-0 octal, `_` separators, base 60) and float
  (with a `.`, `.inf`, `.nan`, base 60), anything else a str.

Anything else raises ValueError naming the line: anchors, aliases and tags,
block scalars (`|`, `>`), flow mappings, nested flow collections,
directives and document markers, complex keys, merge keys and timestamps.
"""

from __future__ import annotations

import math
import re
from typing import Optional

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
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/",
            "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# a plain scalar may not start with these (YAML's indicators outside the subset)
_REFUSED_STARTS = {"&": "anchors", "*": "aliases", "!": "tags", "|": "block scalars",
                   ">": "block scalars", "{": "flow mappings", "%": "directives",
                   "@": "reserved indicators", "`": "reserved indicators"}


def load(text: str):
    """The value of one YAML document (None for an empty one)."""
    return _Parser(text).document()


def _sexagesimal(parts: list) -> float:
    value, base = 0, 1
    for part in reversed(parts):
        value += part * base
        base *= 60
    return value


def _signed(text: str):
    sign = -1 if text[0] == "-" else 1
    return sign, text[1:] if text[0] in "+-" else text


def resolve_plain(text: str, where: str = ""):
    """A plain scalar typed as `yaml.safe_load` types it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        sign, value = _signed(text.replace("_", "").lower())
        if value == ".inf":
            return sign * math.inf
        if value == ".nan":
            return math.nan
        if ":" in value:
            return sign * _sexagesimal([float(p) for p in value.split(":")])
        return sign * float(value)
    if _INT.match(text):
        sign, value = _signed(text.replace("_", ""))
        if value == "0":
            return 0
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value[0] == "0":
            return sign * int(value, 8)
        if ":" in value:
            return sign * _sexagesimal([int(p) for p in value.split(":")])
        return sign * int(value)
    if _TIMESTAMP.match(text) or text in ("<<", "="):
        raise ValueError(f"{where}timestamps, merge and value keys are outside the subset: "
                         f"{text!r}")
    return text


def _unescape(text: str, where: str) -> str:
    out, i = [], 0
    while i < len(text):
        ch = text[i]
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        code = text[i + 1:i + 2]
        if code in _ESCAPES:
            out.append(_ESCAPES[code])
            i += 2
        elif code in _HEX_ESCAPES:
            digits = text[i + 2:i + 2 + _HEX_ESCAPES[code]]
            if len(digits) != _HEX_ESCAPES[code] or not all(c in "0123456789abcdefABCDEF"
                                                             for c in digits):
                raise ValueError(f"{where}bad escape \\{code}{digits}")
            out.append(chr(int(digits, 16)))
            i += 2 + len(digits)
        else:
            raise ValueError(f"{where}unknown escape \\{code}")
    return "".join(out)


_SEPARATOR_BREAK = re.compile("[ \t]*([\u2028\u2029])[ \t]*")


def _fold(lines: list, quote: str, where: str) -> str:
    """A scalar's raw lines (quote: the quote character, or None for a plain
    scalar in a flow sequence), folded: a line break between two lines
    becomes a space, k empty lines between them k newlines, and an escaped
    line break (double quotes) nothing; each inner line is stripped. The
    line and paragraph separators (U+2028, U+2029) are line breaks that
    stay: the blanks around them go, and a line ending in one joins the next
    with a newline for each break."""
    pieces = []   # (text, the break it ends in), None for an empty inner line
    last = len(lines) - 1
    for idx, line in enumerate(lines):
        if quote:
            line = _SEPARATOR_BREAK.sub(r"\1", line)
        if idx > 0:
            line = line.lstrip(" \t")
        ends = "fold"
        if idx < last:
            trailing = len(line) - len(line.rstrip("\\"))
            if quote == '"' and trailing % 2 == 1:
                line, ends = line[:-1], "escaped"
            else:
                line = line.rstrip(" \t")
                if quote and line.endswith(("\u2028", "\u2029")):
                    ends = "separator"
        if 0 < idx < last and not line and ends == "fold":
            pieces.append(None)
        else:
            if quote == '"':
                line = _unescape(line, where)
            elif quote == "'":
                line = line.replace("''", "'")
            pieces.append((line, ends))
    out, blanks, ends = pieces[0][0], 0, pieces[0][1]
    for piece in pieces[1:]:
        if piece is None:
            blanks += 1
            continue
        if ends == "separator":
            out += "\n" * (blanks + 1)
        elif ends == "escaped" and not blanks:
            pass
        else:
            out += "\n" * blanks if blanks else " "
        out += piece[0]
        blanks, ends = 0, piece[1]
    return out


class _Parser:
    def __init__(self, text: str):
        # YAML's line breaks: CR LF, CR and NEL read as LF (yaml's reader)
        self.raw = re.sub("\r\n|\r|\x85", "\n", text).split("\n")
        self.pos = 0
        self.virtual: Optional[tuple] = None    # (pos, indent, content) of a "- " item

    # ------------------------------------------------------------ lines

    def where(self, pos: Optional[int] = None) -> str:
        return f"line {(self.pos if pos is None else pos) + 1}: "

    def peek(self) -> Optional[tuple]:
        """(indent, content) of the next line that holds more than a comment,
        moving past the others; None at the end."""
        if self.virtual is not None and self.virtual[0] == self.pos:
            return self.virtual[1:]
        while self.pos < len(self.raw):
            line = self.raw[self.pos]
            content = line.lstrip(" \t")
            if content and not content.startswith("#"):
                indent = len(line) - len(content)
                if "\t" in line[:indent]:
                    raise ValueError(f"{self.where()}tabs in indentation")
                if indent == 0 and (content.startswith("%") or re.match(r"(---|\.\.\.)(\s|$)",
                                                                       content)):
                    raise ValueError(f"{self.where()}directives and document markers are "
                                     f"outside the subset")
                return indent, content.rstrip(" ")
            self.pos += 1
        return None

    def advance(self) -> None:
        self.pos += 1

    # ------------------------------------------------------------ nodes

    def document(self):
        head = self.peek()
        if head is None:
            return None
        value = self.node(head[0], parent=-1)
        if self.peek() is not None:
            raise ValueError(f"{self.where()}unexpected indentation")
        return value

    def node(self, indent: int, parent: int):
        """The block node whose first line is the next one, at `indent`."""
        _, content = self.peek()
        if content == "-" or content.startswith("- "):
            return self.sequence(indent)
        if self.split_key(content) is not None:
            return self.mapping(indent)
        value = self.inline(content, parent)
        return value

    def nested(self, indent: int, allow_indentless: bool):
        """The value of `key:` or `-` with nothing after it on its line."""
        nxt = self.peek()
        if nxt is None:
            return None
        if nxt[0] > indent:
            return self.node(nxt[0], indent)
        if allow_indentless and nxt[0] == indent and (nxt[1] == "-" or nxt[1].startswith("- ")):
            return self.sequence(indent)
        return None

    def sequence(self, indent: int) -> list:
        items = []
        while True:
            line = self.peek()
            if line is None or line[0] < indent:
                return items
            if line[0] > indent or not (line[1] == "-" or line[1].startswith("- ")):
                if line[0] == indent and self.split_key(line[1]) is not None:
                    return items    # an indentless sequence ends at its mapping's next key
                raise ValueError(f"{self.where()}expected a '- ' item at column {indent + 1}")
            rest = line[1][1:]
            body = rest.lstrip(" ")
            if not body or body.startswith("#"):
                self.advance()
                items.append(self.nested(indent, allow_indentless=False))
                continue
            column = indent + 1 + len(rest) - len(body)
            if body == "-" or body.startswith("- ") or self.split_key(body) is not None:
                self.virtual = (self.pos, column, body)
                items.append(self.node(column, indent))
            else:
                items.append(self.inline(body, indent))

    def mapping(self, indent: int) -> dict:
        out = {}
        while True:
            line = self.peek()
            if line is None or line[0] < indent:
                return out
            if line[0] > indent:
                raise ValueError(f"{self.where()}unexpected indentation")
            split = self.split_key(line[1])
            if split is None:
                if line[1] == "-" or line[1].startswith("- "):
                    return out      # the enclosing indentless sequence's next item
                raise ValueError(f"{self.where()}expected 'key: value'")
            key, rest = split
            if not rest or rest.startswith("#"):
                self.advance()
                out[key] = self.nested(indent, allow_indentless=True)
            else:
                out[key] = self.inline(rest, indent)

    # ---------------------------------------------------------- scalars

    def split_key(self, content: str) -> Optional[tuple]:
        """(key, the text after 'key:') when the line is a mapping entry."""
        where = self.where()
        if content.startswith("? ") or content == "?":
            raise ValueError(f"{where}complex keys are outside the subset")
        if content[0] in "'\"":
            end = _closing(content, 1, content[0])
            if end is None:
                return None
            after = content[end + 1:].lstrip(" ")
            if not (after == ":" or after.startswith(": ")):
                return None
            raw = content[1:end]
            key = _unescape(raw, where) if content[0] == '"' else raw.replace("''", "'")
            return key, after[1:].strip(" ")
        if content[0] in "[{" or content.startswith("- ") or content == "-":
            return None
        match = re.search(r":(\s|$)", content)
        comment = re.search(r"\s#", content)
        if match is None or (comment is not None and comment.start() < match.start()):
            return None
        key_text = content[:match.start()].rstrip(" ")
        if key_text and key_text[0] in _REFUSED_STARTS:
            raise ValueError(f"{where}{_REFUSED_STARTS[key_text[0]]} are outside the subset")
        return resolve_plain(key_text, where), content[match.end():].strip(" ")

    def inline(self, text: str, parent: int):
        """A scalar or a flow sequence starting on the current line with
        `text`; the node it belongs to sits at column `parent`. Consumes the
        line, and any continuation lines of a multi-line scalar."""
        where = self.where()
        self.virtual = None
        first = text[0]
        if first in _REFUSED_STARTS:
            raise ValueError(f"{where}{_REFUSED_STARTS[first]} are outside the subset")
        if first in "'\"":
            return self.quoted(text, first)
        if first == "[":
            while True:
                try:
                    value, rest = _flow_sequence(text, where)
                    break
                except _Unclosed:
                    # a flow sequence may go on over lines, folded as scalars fold
                    self.advance()
                    if self.pos >= len(self.raw):
                        raise
                    text += "\n" + self.raw[self.pos]
            self.advance()
            _end_of_line(rest, where)
            return value
        if text.startswith("- "):
            raise ValueError(f"{where}a block sequence cannot start after 'key: '")
        words = [_strip_comment(text)]
        self.advance()
        blanks = 0
        while self.pos < len(self.raw):
            line = self.raw[self.pos]
            content = line.strip(" ")
            if not content:
                blanks += 1
                self.pos += 1
                continue
            if len(line) - len(line.lstrip(" ")) <= parent or content.startswith("#"):
                break
            words.append("\n" * blanks if blanks else " ")
            words.append(_strip_comment(content))
            blanks = 0
            self.pos += 1
        if blanks:
            # the blank lines belong to what follows, not to the scalar
            self.pos -= blanks
            while self.pos < len(self.raw) and not self.raw[self.pos].strip(" "):
                self.pos += 1
        plain = "".join(words)
        if re.search(r":(\s|$)", plain) or plain.endswith(":"):
            raise ValueError(f"{where}a mapping cannot start inside a value: {plain!r}")
        return resolve_plain(plain, where)

    def quoted(self, text: str, quote: str) -> str:
        where = self.where()
        lines, cur = [], text[1:]
        while True:
            end = _closing(cur, 0, quote)
            if end is not None:
                lines.append(cur[:end])
                rest = cur[end + 1:]
                break
            lines.append(cur)
            self.pos += 1
            if self.pos >= len(self.raw):
                raise ValueError(f"{where}unterminated quoted scalar")
            cur = self.raw[self.pos]
        self.advance()
        _end_of_line(rest, where)
        return _fold(lines, quote, where)


class _Unclosed(ValueError):
    pass


def _closing(text: str, start: int, quote: str) -> Optional[int]:
    """Index of the quote that closes a scalar opened before `start`."""
    i = start
    while i < len(text):
        if quote == '"' and text[i] == "\\":
            i += 2
        elif text[i] == quote:
            if quote == "'" and text[i + 1:i + 2] == "'":
                i += 2
            else:
                return i
        else:
            i += 1
    return None


def _strip_comment(text: str) -> str:
    match = re.search(r"\s#", text)
    return (text[:match.start()] if match else text).rstrip(" ")


def _end_of_line(rest: str, where: str) -> None:
    rest = rest.strip(" ")
    if rest and not rest.startswith("#"):
        raise ValueError(f"{where}unexpected text after a value: {rest!r}")


def _flow_sequence(text: str, where: str) -> tuple:
    """`[a, 'b', 1]` -> (list of scalars, the text after it); raises
    _Unclosed where `text` ends first."""
    items, i = [], 1
    while True:
        while i < len(text) and text[i] in " \n":
            i += 1
        if i >= len(text):
            raise _Unclosed(f"{where}unterminated flow sequence")
        ch = text[i]
        if ch == "]":       # [] or a trailing comma
            return items, text[i + 1:]
        if ch in "[{":
            raise ValueError(f"{where}nested flow collections are outside the subset")
        if ch in "'\"":
            end = _closing(text, i + 1, ch)
            if end is None:
                raise _Unclosed(f"{where}unterminated flow sequence")
            items.append(_fold(text[i + 1:end].split("\n"), ch, where))
            i = end + 1
        elif ch in _REFUSED_STARTS or ch == ",":
            raise ValueError(f"{where}unexpected {ch!r} in a flow sequence")
        else:
            j = i
            while j < len(text) and text[j] not in ",]{}[":
                j += 1
            plain = text[i:j].strip(" \n")
            if re.search(r":(\s|$)", plain) or re.search(r"\s#", plain):
                raise ValueError(f"{where}only scalars may stand in a flow sequence")
            items.append(resolve_plain(_fold(plain.split("\n"), None, where), where))
            i = j
        while i < len(text) and text[i] in " \n":
            i += 1
        if i >= len(text):
            raise _Unclosed(f"{where}unterminated flow sequence")
        if text[i] == ",":
            i += 1
        elif text[i] == "]":
            return items, text[i + 1:]
        else:
            raise ValueError(f"{where}expected ',' or ']' in a flow sequence")
