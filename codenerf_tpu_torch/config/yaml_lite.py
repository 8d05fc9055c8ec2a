"""A reader and a writer for the YAML the repository's configs use,
standard library only.

The card's machine has no PyYAML, so ``load_config`` falls back to
``safe_load`` here.  The subset:

  * block mappings and block sequences (``- 4``, also at the indentation
    of their key), nested by indentation with spaces;
  * one-line flow mappings and sequences (``{type: CodeNeRFModel,
    hidden_size: 64}``, ``[1, 2]``), nested;
  * comments, from a ``#`` at the start of a line or after a space;
  * plain, single-quoted (``'it''s'``) and double-quoted (``"lindepth"``,
    with backslash escapes) scalars on one line.

Plain scalars resolve exactly as PyYAML's ``safe_load`` resolves them
(YAML 1.1): ``true`` / ``True`` / ``yes`` / ``on`` are booleans, ``null``
/ ``~`` / nothing is None, ``0x1F`` / ``017`` / ``1_000`` / ``1:30`` are
ints, and a float needs a dot, so ``1.0e-05`` is a float but ``1e-5`` is
the string "1e-5".  Anything outside the subset (anchors, aliases, tags,
block scalars, multi-line scalars, documents markers, timestamps, tabs
in indentation) raises ``ValueError`` with the line number.

``dump`` writes nested dicts, lists / tuples of scalars and scalars in
the block style, quoting every string that would read back as another
type, so both ``safe_load``s return what was dumped (tuples as lists).
"""

from __future__ import annotations

import math
import re

_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on",
                          "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off",
                          "Off", "OFF"), False)}
_NULL = {"~", "null", "Null", "NULL", ""}
# PyYAML's implicit resolvers (yaml/resolver.py), verbatim
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
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)
# a plain scalar may not start with these (anchors, tags, block scalars,
# directives and reserved indicators)
_BAD_START = set("&*!|>%@`")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(text: str, cast):
    value, base = cast(0), 1
    for part in reversed(text.split(":")):
        value += cast(part) * base
        base *= 60
    return value


def _int(text: str) -> int:
    # PyYAML's construct_yaml_int
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


def _float(text: str) -> float:
    # PyYAML's construct_yaml_float
    value = text.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def resolve(text: str, line: int = 0):
    """The value of the plain scalar ``text`` as ``yaml.safe_load`` gives
    it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _FLOAT.match(text):
        return _float(text)
    if _INT.match(text):
        return _int(text)
    if _TIMESTAMP.match(text) or text in ("=", "<<"):
        raise ValueError(f"line {line}: {text!r} is outside the YAML subset "
                         "(timestamp, value or merge key)")
    return text


class _Line:
    __slots__ = ("number", "indent", "text")

    def __init__(self, number, indent, text):
        self.number, self.indent, self.text = number, indent, text


def _strip_comment(raw: str) -> str:
    """``raw`` without its comment, quotes respected."""
    quote = None
    i = 0
    while i < len(raw):
        c = raw[i]
        if quote == "'":
            if c == "'":
                if raw[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif c in "'\"" and (i == 0 or raw[i - 1] in " \t[{,:-"):
            quote = c
        elif c == "#" and (i == 0 or raw[i - 1] in " \t"):
            return raw[:i]
        i += 1
    return raw


def _lines(text: str) -> list:
    out = []
    for number, raw in enumerate(text.splitlines(), 1):
        body = _strip_comment(raw).rstrip()
        if not body.strip():
            continue
        stripped = body.lstrip(" ")
        if stripped.startswith("\t"):
            raise ValueError(f"line {number}: tab in indentation")
        if stripped.startswith(("---", "...", "%")) and (
                len(stripped) == 3 or stripped[3:4] in (" ", "")):
            raise ValueError(f"line {number}: document markers and "
                             "directives are outside the YAML subset")
        out.append(_Line(number, len(body) - len(stripped), stripped))
    return out


def _quoted(text: str, pos: int, number: int):
    """The quoted scalar starting at ``text[pos]``: (value, end)."""
    q = text[pos]
    out = []
    i = pos + 1
    while i < len(text):
        c = text[i]
        if q == "'":
            if c == "'":
                if text[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(c)
        else:
            if c == '"':
                return "".join(out), i + 1
            if c == "\\":
                e = text[i + 1:i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    i += 2
                    continue
                if e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    digits = text[i + 2:i + 2 + n]
                    if len(digits) != n or not all(
                            d in "0123456789abcdefABCDEF" for d in digits):
                        raise ValueError(f"line {number}: bad escape "
                                         f"\\{e}{digits}")
                    out.append(chr(int(digits, 16)))
                    i += 2 + n
                    continue
                raise ValueError(f"line {number}: unknown escape \\{e}")
            out.append(c)
        i += 1
    raise ValueError(f"line {number}: quoted scalar does not end on its "
                     "line (multi-line scalars are outside the YAML subset)")


def _plain(text: str, number: int):
    if text[0] in _BAD_START or (text[0] in "?-:" and text[1:2] in ("", " ")):
        raise ValueError(f"line {number}: {text!r} is outside the YAML "
                         "subset (anchor, alias, tag, block scalar or "
                         "indicator)")
    if ": " in text or text.endswith(":"):
        raise ValueError(f"line {number}: mapping values are not allowed "
                         f"here: {text!r}")
    return resolve(text, number)


def _flow(text: str, pos: int, number: int, in_flow: bool):
    """One flow node starting at ``text[pos]``: (value, end)."""
    while pos < len(text) and text[pos] == " ":
        pos += 1
    if pos >= len(text):
        return None, pos
    c = text[pos]
    if c in "{[":
        close = "}" if c == "{" else "]"
        out = {} if c == "{" else []
        pos += 1
        while True:
            while pos < len(text) and text[pos] == " ":
                pos += 1
            if pos >= len(text):
                raise ValueError(f"line {number}: flow collection does not "
                                 "end on its line")
            if text[pos] == close:
                return out, pos + 1
            if c == "{":
                key, pos = _flow(text, pos, number, True)
                while pos < len(text) and text[pos] == " ":
                    pos += 1
                if text[pos:pos + 1] != ":":
                    raise ValueError(f"line {number}: expected ':' after a "
                                     "flow mapping key")
                value, pos = _flow(text, pos + 1, number, True)
                out[key] = value
            else:
                value, pos = _flow(text, pos, number, True)
                out.append(value)
            while pos < len(text) and text[pos] == " ":
                pos += 1
            if text[pos:pos + 1] == ",":
                pos += 1
            elif text[pos:pos + 1] != close:
                raise ValueError(f"line {number}: expected ',' or "
                                 f"{close!r} in a flow collection")
    if c in "'\"":
        return _quoted(text, pos, number)
    if c in "}],":
        return None, pos
    end = pos
    while end < len(text):
        ch = text[end]
        if in_flow and ch in ",[]{}":
            break
        if ch == ":" and (end + 1 == len(text) or text[end + 1] == " "
                          or (in_flow and text[end + 1] in ",[]{}")):
            if in_flow:
                break
        end += 1
    return _plain(text[pos:end].rstrip(), number), end


def _inline(text: str, number: int):
    """The value written after ``key:`` or ``- `` on one line."""
    value, end = _flow(text, 0, number, False)
    if text[end:].strip():
        raise ValueError(f"line {number}: unexpected {text[end:].strip()!r}")
    return value


def _split_key(text: str, number: int):
    """(key, rest) for a block mapping line, or None."""
    if text[0] in "'\"":
        key, end = _quoted(text, 0, number)
        rest = text[end:].lstrip(" ")
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:].strip()
        return None
    if text[0] in "[{":
        return None
    i = 0
    while True:
        i = text.find(":", i)
        if i < 0:
            return None
        if i + 1 == len(text) or text[i + 1] == " ":
            return _plain(text[:i].rstrip(), number), text[i + 1:].strip()
        i += 1


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _block(lines, i, indent):
    if _is_item(lines[i].text):
        return _sequence(lines, i, indent)
    return _mapping(lines, i, indent)


def _nested(lines, i, parent_indent, allow_indentless):
    """The value on the lines after a ``key:`` or ``-`` with nothing after
    it: a deeper block, an indentless sequence, or None."""
    if i < len(lines):
        nxt = lines[i]
        if nxt.indent > parent_indent:
            return _block(lines, i, nxt.indent)
        if (allow_indentless and nxt.indent == parent_indent
                and _is_item(nxt.text)):
            return _sequence(lines, i, parent_indent)
    return None, i


def _check_no_deeper(lines, i, indent):
    if i < len(lines) and lines[i].indent > indent:
        raise ValueError(f"line {lines[i].number}: unexpected indentation "
                         "(multi-line scalars are outside the YAML subset)")


def _sequence(lines, i, indent):
    out = []
    while i < len(lines) and lines[i].indent == indent and _is_item(
            lines[i].text):
        line = lines[i]
        rest = line.text[1:].strip()
        i += 1
        if not rest:
            value, i = _nested(lines, i, indent, False)
        else:
            if _is_item(rest) or _split_key(rest, line.number) is not None:
                raise ValueError(f"line {line.number}: a block sequence "
                                 "entry must be a scalar or a flow "
                                 "collection in the YAML subset")
            value = _inline(rest, line.number)
            _check_no_deeper(lines, i, indent)
        out.append(value)
    return out, i


def _mapping(lines, i, indent):
    out = {}
    while i < len(lines) and lines[i].indent == indent:
        line = lines[i]
        if _is_item(line.text):
            raise ValueError(f"line {line.number}: a sequence entry where a "
                             "mapping key was expected")
        split = _split_key(line.text, line.number)
        if split is None:
            raise ValueError(f"line {line.number}: expected 'key: value', "
                             f"got {line.text!r}")
        key, rest = split
        i += 1
        if rest:
            out[key] = _inline(rest, line.number)
            _check_no_deeper(lines, i, indent)
        else:
            out[key], i = _nested(lines, i, indent, True)
    return out, i


def safe_load(text: str):
    """The document in ``text`` as ``yaml.safe_load`` reads it; raises
    ``ValueError`` naming the line of anything outside the subset."""
    lines = _lines(text)
    if not lines:
        return None
    first = lines[0]
    if not _is_item(first.text) and _split_key(first.text,
                                               first.number) is None:
        if len(lines) > 1:
            raise ValueError(f"line {lines[1].number}: content after a "
                             "top-level scalar")
        return _inline(first.text, first.number)
    value, i = _block(lines, 0, first.indent)
    if i < len(lines):
        raise ValueError(f"line {lines[i].number}: indentation does not "
                         "match any enclosing block")
    return value


# ---- writer ----

_PLAIN_UNSAFE = set("-?:,[]{}#&*!|>'\"%@`")


def _scalar(value) -> str:
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
        if "." not in text:
            # 1e-05 reads back as a string: YAML 1.1 floats need a dot
            mantissa, _, exponent = text.partition("e")
            text = f"{mantissa}.0e{exponent}" if exponent else f"{text}.0"
        return text
    if isinstance(value, str):
        printable = value.isprintable()
        if (value and printable and value == value.strip()
                and value[0] not in _PLAIN_UNSAFE
                and not any(c in value for c in ",[]{}")
                and ": " not in value and " #" not in value
                and not value.endswith(":")
                and isinstance(_resolve_or_none(value), str)):
            return value
        if printable:
            return "'" + value.replace("'", "''") + "'"
        return '"' + "".join(
            c if c.isprintable() and c not in '"\\' else
            ("\\" + c if c in '"\\' else f"\\u{ord(c):04x}")
            for c in value) + '"'
    raise TypeError(f"cannot write {type(value).__name__} as a YAML scalar")


def _resolve_or_none(text: str):
    """``resolve(text)``, or None where it would raise."""
    try:
        return resolve(text)
    except ValueError:
        return None


def _dump(node, indent: int, out: list) -> None:
    pad = " " * indent
    for key, value in node.items():
        head = f"{pad}{_scalar(key)}:"
        if isinstance(value, dict) and value:
            out.append(head)
            _dump(value, indent + 2, out)
        elif isinstance(value, (list, tuple)) and value:
            out.append(head)
            for item in value:
                if isinstance(item, (dict, list, tuple)):
                    raise TypeError("nested collections in a sequence are "
                                    "outside the YAML subset")
                out.append(f"{pad}- {_scalar(item)}")
        elif isinstance(value, dict):
            out.append(f"{head} {{}}")
        elif isinstance(value, (list, tuple)):
            out.append(f"{head} []")
        else:
            out.append(f"{head} {_scalar(value)}")


def dump(data: dict) -> str:
    """``data``, a dict of dicts, lists / tuples of scalars and scalars,
    as block-style YAML."""
    out = []
    _dump(data, 0, out)
    return "\n".join(out) + "\n"
