"""A reader for the YAML subset that `configs/` uses, with PyYAML's
`safe_load` results (YAML 1.1 scalar resolution), so that the port needs
no YAML package.

The subset: block mappings by indentation, flow sequences `[a, b]` and flow
mappings `{k: v}` (nested, over several lines too), plain scalars, single-
and double-quoted strings, comments and blank lines. Plain scalars resolve
as PyYAML resolves them: null (`null`, `Null`, `NULL`, `~`, empty), booleans
(`true`/`false`, `yes`/`no`, `on`/`off` in three cases), decimal integers,
and floats only with a dot (`2e-4` stays the string `'2e-4'`, as in PyYAML);
everything else is a string. Anything outside the subset raises
`YamlSubsetError`: block sequences, anchors, aliases, tags, block scalars,
documents markers, complex keys, and plain scalars that YAML 1.1 reads as
another type this reader does not build (hexadecimal, octal, binary and
base-60 numbers, timestamps).
"""
from __future__ import annotations

import re

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"""(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?
                       |\.[0-9_]+(?:[eE][-+][0-9]+)?
                       |[-+]?\.(?:inf|Inf|INF)
                       |\.(?:nan|NaN|NAN))$""", re.X)
# YAML 1.1 forms that PyYAML builds as numbers or timestamps
_UNSUPPORTED = re.compile(r"""(?:[-+]?0b[0-1_]+
                             |[-+]?0[0-7_]+
                             |[-+]?0x[0-9a-fA-F_]+
                             |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?
                             |[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*
                             |<<|=)$""", re.X)
_INDICATORS = "&*!|>%@`"


class YamlSubsetError(ValueError):
    pass


def _resolve_plain(text: str):
    """A plain scalar's value, as PyYAML's implicit resolvers give it."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.lstrip("+-") == ".inf":
            return float("-inf") if t.startswith("-") else float("inf")
        if t == ".nan":
            return float("nan")
        return float(t)
    if _UNSUPPORTED.match(text):
        raise YamlSubsetError(f"plain scalar {text!r} is outside the subset")
    if text[0] in _INDICATORS or text.startswith(("- ", "? ", "---", "...")) \
            or text in ("-", "?"):
        raise YamlSubsetError(f"{text!r} uses YAML syntax outside the subset")
    return text


def _strip_comment(line: str) -> str:
    """The line without a trailing comment (a # at the start or after a
    space, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                if quote == "'" and line[i + 1:i + 2] == "'":
                    continue
                quote = None
            elif ch == "\\" and quote == '"':
                continue
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


class _Flow:
    """A cursor over one flow or scalar value (possibly spanning lines)."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t\n":
            self.i += 1

    def peek(self):
        self.ws()
        return self.s[self.i] if self.i < len(self.s) else ""

    def value(self, in_flow: bool):
        ch = self.peek()
        if ch == "[":
            return self.seq()
        if ch == "{":
            return self.map()
        if ch in "'\"":
            return self.quoted()
        return _resolve_plain(self.plain(in_flow))

    def plain(self, in_flow: bool) -> str:
        start = self.i
        stops = ",[]{}" if in_flow else ""
        while self.i < len(self.s):
            ch = self.s[self.i]
            if ch in stops or (ch == ":" and (self.i + 1 == len(self.s)
                                              or self.s[self.i + 1] in " \t\n,[]{}")):
                break
            self.i += 1
        return " ".join(self.s[start:self.i].split())

    def quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out = []
        while True:
            if self.i >= len(self.s):
                raise YamlSubsetError(f"unterminated {q}-quoted string")
            ch = self.s[self.i]
            if ch == q:
                if q == "'" and self.s[self.i + 1:self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and ch == "\\":
                esc = self.s[self.i + 1:self.i + 2]
                mapped = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/",
                          "0": "\0", " ": " "}.get(esc)
                if mapped is None:
                    raise YamlSubsetError(f"escape \\{esc} is outside the subset")
                out.append(mapped)
                self.i += 2
                continue
            if ch == "\n":
                raise YamlSubsetError("multi-line quoted strings are outside the subset")
            out.append(ch)
            self.i += 1

    def seq(self) -> list:
        self.i += 1
        out = []
        while True:
            if self.peek() == "]":
                self.i += 1
                return out
            out.append(self.value(True))
            ch = self.peek()
            if ch == ",":
                self.i += 1
            elif ch != "]":
                raise YamlSubsetError(f"expected , or ] at {self.s[self.i:self.i + 20]!r}")

    def map(self) -> dict:
        self.i += 1
        out = {}
        while True:
            if self.peek() == "}":
                self.i += 1
                return out
            key = self.value(True)
            if self.peek() != ":":
                raise YamlSubsetError(f"expected : in a flow mapping at "
                                      f"{self.s[self.i:self.i + 20]!r}")
            self.i += 1
            out[key] = None if self.peek() in ",}" else self.value(True)
            ch = self.peek()
            if ch == ",":
                self.i += 1
            elif ch != "}":
                raise YamlSubsetError(f"expected , or }} at {self.s[self.i:self.i + 20]!r}")

    def end(self):
        if self.peek():
            raise YamlSubsetError(f"trailing text {self.s[self.i:self.i + 20]!r}")


def _flow_value(text: str):
    f = _Flow(text)
    v = f.value(False)
    f.end()
    return v


def _open_brackets(text: str) -> int:
    """How many [ and { stay open at the end of `text` (outside quotes)."""
    depth, quote = 0, None
    for ch in text:
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth


def _split_key(body: str):
    """`key: rest` -> (key, rest), or None when the line is no mapping entry."""
    f = _Flow(body)
    if f.peek() in "'\"":
        key = f.quoted()
    elif f.peek() in "[{":
        return None
    else:
        key = f.plain(False)
        if not key:
            return None
        key = _resolve_plain(key)
    if f.i >= len(body) or body[f.i] != ":":
        return None
    return key, body[f.i + 1:].strip()


def safe_load(text: str):
    """Parse one document of the subset, as `yaml.safe_load` would."""
    lines = []  # (indent, text) of each non-blank line, comments removed
    for raw in text.split("\n"):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError("tab indentation is outside the subset")
        body = _strip_comment(raw)
        if body.strip():
            lines.append((len(body) - len(body.lstrip(" ")), body.strip()))
    if not lines:
        return None
    if lines[0][1].startswith(("---", "%")):
        raise YamlSubsetError("document markers and directives are outside the subset")
    if _split_key(lines[0][1]) is None:  # a single flow or scalar value
        return _flow_value("\n".join(t for _, t in lines))
    value, pos = _block_map(lines, 0, lines[0][0])
    if pos != len(lines):
        raise YamlSubsetError(f"unexpected indentation at {lines[pos][1]!r}")
    return value


def _block_map(lines, pos: int, indent: int):
    out = {}
    while pos < len(lines):
        ind, body = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            raise YamlSubsetError(f"unexpected indentation at {body!r}")
        if body.startswith("- ") or body == "-":
            raise YamlSubsetError("block sequences are outside the subset")
        kv = _split_key(body)
        if kv is None:
            raise YamlSubsetError(f"expected 'key: value' at {body!r}")
        key, rest = kv
        pos += 1
        if rest == "":
            if pos < len(lines) and lines[pos][0] > indent:
                out[key], pos = _block_map(lines, pos, lines[pos][0])
            else:
                out[key] = None
            continue
        if rest[0] in "|>":
            raise YamlSubsetError("block scalars are outside the subset")
        parts = [rest]
        while rest[0] in "[{" and _open_brackets("\n".join(parts)) > 0 \
                and pos < len(lines):
            parts.append(lines[pos][1])
            pos += 1
        out[key] = _flow_value("\n".join(parts))
    return out, pos
