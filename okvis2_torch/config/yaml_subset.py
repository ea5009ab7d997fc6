"""A reader for the subset of YAML that the reference's config files use.

The reference's configs (``configs/*.yaml``, cv::FileStorage style) use:

- a ``%YAML:1.0`` header line (and at most one ``---`` after it);
- ``#`` comments, whole-line or after a value;
- block mappings and block sequences (``- item``, ``- key: value``);
- flow mappings ``{...}`` and flow sequences ``[...]``, also spanning lines;
- plain scalars, typed as PyYAML 1.1's ``safe_load`` types them (bools such
  as ``true``/``yes``/``off``, ints with ``0x``/``0b``/leading-zero octal
  forms and ``_`` digits, floats that need a ``.`` and a signed exponent,
  nulls, strings).

Everything else raises ``YamlSubsetError`` with the line number: quoted
scalars, anchors, aliases, tags (but the ``!!opencv-matrix`` tag, which is
ignored as the JAX reader strips it), block scalars (``|``, ``>``), merge
keys, several documents, multi-line plain scalars, sexagesimal numbers and
timestamps. Nothing outside the subset is read silently in another way.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

IGNORED_TAG = "!!opencv-matrix"

# PyYAML 1.1 implicit resolvers (yaml/resolver.py), in its order of checks
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
_TRUE = {"yes", "true", "on"}


class YamlSubsetError(ValueError):
    """A construct outside the supported subset, or malformed input."""

    def __init__(self, line: int, msg: str):
        super().__init__(f"line {line}: {msg}")
        self.line = line


def _int(s: str) -> int:
    s = s.replace("_", "")
    sign = -1 if s[0] == "-" else 1
    body = s.lstrip("+-")
    if body == "0":
        return 0
    if body.startswith("0b"):
        return sign * int(body[2:], 2)
    if body.startswith("0x"):
        return sign * int(body[2:], 16)
    if body.startswith("0"):
        return sign * int(body, 8)
    return sign * int(body)


def _float(s: str) -> float:
    s = s.replace("_", "").lower()
    sign = -1.0 if s[0] == "-" else 1.0
    body = s.lstrip("+-")
    if body == ".inf":
        return sign * float("inf")
    if body == ".nan":
        return float("nan")
    return sign * float(body)


def resolve_plain(s: str, line: int) -> Any:
    """A plain scalar typed as PyYAML 1.1's ``safe_load`` types it."""
    if s.startswith(("'", '"')):
        raise YamlSubsetError(line, f"quoted scalars are not supported: {s!r}")
    if s.startswith(("&", "*")):
        raise YamlSubsetError(line, f"anchors and aliases are not supported: {s!r}")
    if s.startswith("!"):
        raise YamlSubsetError(line, f"tags are not supported: {s!r}")
    if s.startswith(("|", ">")):
        raise YamlSubsetError(line, "block scalars are not supported")
    if s == "<<":
        raise YamlSubsetError(line, "merge keys are not supported")
    if _BOOL.match(s):
        return s.lower() in _TRUE
    if (_FLOAT.match(s) or _INT.match(s)) and ":" in s:
        raise YamlSubsetError(line, f"sexagesimal numbers are not supported: {s!r}")
    if _FLOAT.match(s):
        return _float(s)
    if _INT.match(s):
        return _int(s)
    if _NULL.match(s):
        return None
    if _TIMESTAMP.match(s):
        raise YamlSubsetError(line, f"timestamps are not supported: {s!r}")
    return s


def _strip_comment(text: str) -> str:
    """``text`` without a trailing comment (a ``#`` at the start or after
    whitespace)."""
    for i, ch in enumerate(text):
        if ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _split_key(content: str) -> Tuple[str, str] | None:
    """``key: rest`` -> (key, rest), or None when ``content`` is no mapping
    entry."""
    if content.startswith(("[", "{")):
        return None
    m = re.search(r":(?:\s|$)", content)
    if m is None:
        return None
    return content[:m.start()].rstrip(), content[m.end():].strip()


class _Flow:
    """Parser of one flow collection (its text may span lines, joined by
    spaces; ``starts`` maps character offsets back to line numbers)."""

    def __init__(self, text: str, starts: List[Tuple[int, int]]):
        self.s = text
        self.i = 0
        self.starts = starts  # (offset, line)

    def line(self) -> int:
        ln = self.starts[0][1]
        for off, n in self.starts:
            if off <= self.i:
                ln = n
        return ln

    def err(self, msg):
        raise YamlSubsetError(self.line(), msg)

    def ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def peek(self) -> str:
        self.ws()
        return self.s[self.i] if self.i < len(self.s) else ""

    def scalar(self) -> Any:
        self.ws()
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            if c in ",]}[{":
                break
            if c == ":" and (self.i + 1 == len(self.s) or self.s[self.i + 1] in " \t,]}[{"):
                break
            if c == "#" and self.s[self.i - 1] in " \t":
                self.err("comments inside a flow collection are not supported")
            self.i += 1
        text = self.s[start:self.i].strip()
        if text.startswith(IGNORED_TAG):
            text = text[len(IGNORED_TAG):].strip()
        return resolve_plain(text, self.line())

    def node(self) -> Any:
        ch = self.peek()
        if self.s.startswith(IGNORED_TAG, self.i):
            self.i += len(IGNORED_TAG)
            ch = self.peek()
        if ch == "[":
            return self.seq()
        if ch == "{":
            return self.map()
        return self.scalar()

    def seq(self) -> list:
        self.i += 1
        out = []
        while True:
            ch = self.peek()
            if ch == "]":
                self.i += 1
                return out
            if ch == "":
                self.err("unterminated flow sequence")
            item = self.node()
            if self.peek() == ":":
                self.err("single-pair mappings inside a flow sequence are not supported")
            out.append(item)
            ch = self.peek()
            if ch == ",":
                self.i += 1
            elif ch != "]":
                self.err(f"expected ',' or ']' in a flow sequence, found {ch!r}")

    def map(self) -> dict:
        self.i += 1
        out = {}
        while True:
            ch = self.peek()
            if ch == "}":
                self.i += 1
                return out
            if ch == "":
                self.err("unterminated flow mapping")
            if ch in ("[", "{"):
                self.err("collections as mapping keys are not supported")
            key = self.scalar()
            if self.peek() == ":":
                self.i += 1
                value = None if self.peek() in (",", "}") else self.node()
            else:
                value = None
            out[key] = value
            ch = self.peek()
            if ch == ",":
                self.i += 1
            elif ch != "}":
                self.err(f"expected ',' or '}}' in a flow mapping, found {ch!r}")


class _Block:
    """Block-structure parser over (line, indent, content) records."""

    def __init__(self, lines: List[Tuple[int, int, str]]):
        self.lines = lines
        self.k = 0
        # a scalar value's continuation would sit deeper than this indent
        self._indent_of_value = -1

    def flow_or_scalar(self, text: str, line: int) -> Any:
        """A value that starts on ``line``: a flow collection (gathering
        continuation lines until its brackets close) or a scalar."""
        if text.startswith(("[", "{")):
            parts, starts, offset = [text], [(0, line)], len(text) + 1
            while not _balanced(" ".join(parts), line):
                if self.k >= len(self.lines):
                    raise YamlSubsetError(line, "unterminated flow collection")
                ln, _, content = self.lines[self.k]
                self.k += 1
                starts.append((offset, ln))
                parts.append(content)
                offset += len(content) + 1
            f = _Flow(" ".join(parts), starts)
            value = f.node()
            if f.peek() != "":
                f.err(f"unexpected text after a flow collection: {f.s[f.i:]!r}")
            return value
        value = resolve_plain(text, line)
        if self.k < len(self.lines) and self.lines[self.k][1] > self._indent_of_value:
            raise YamlSubsetError(self.lines[self.k][0],
                                  "multi-line plain scalars are not supported")
        return value

    def node(self, indent: int) -> Any:
        """The block node whose first line is at ``self.k`` (indent >= indent)."""
        ln, ind, content = self.lines[self.k]
        if content == "-" or content.startswith("- "):
            return self.seq(ind)
        if _split_key(content) is not None:
            return self.map(ind)
        self.k += 1
        self._indent_of_value = ind - 1
        return self.flow_or_scalar(content, ln)

    def value_after(self, rest: str, line: int, parent_indent: int, seq_ok: bool) -> Any:
        """The value of a ``key:`` or ``-`` whose text after the indicator is
        ``rest``: inline, or the following more-indented block (for a
        mapping key, a sequence may sit at the key's own indent)."""
        if rest.startswith(IGNORED_TAG):
            rest = rest[len(IGNORED_TAG):].strip()
        if rest:
            self._indent_of_value = parent_indent
            return self.flow_or_scalar(rest, line)
        if self.k < len(self.lines):
            _, ind, content = self.lines[self.k]
            if ind > parent_indent:
                return self.node(ind)
            if seq_ok and ind == parent_indent and (content == "-" or content.startswith("- ")):
                return self.seq(ind)
        return None

    def seq(self, indent: int) -> list:
        out = []
        while self.k < len(self.lines):
            ln, ind, content = self.lines[self.k]
            if ind != indent or not (content == "-" or content.startswith("- ")):
                if ind > indent:
                    raise YamlSubsetError(ln, "bad indentation in a block sequence")
                break
            rest = content[1:].strip()
            self.k += 1
            if rest and (rest == "-" or rest.startswith("- ") or _split_key(rest) is not None):
                # a compact nested node: re-read the item's text at its column
                col = indent + 1 + (len(content) - 1 - len(content[1:].lstrip()))
                self.k -= 1
                self.lines[self.k] = (ln, col, rest)
                out.append(self.node(col))
            else:
                out.append(self.value_after(rest, ln, indent, seq_ok=False))
        return out

    def map(self, indent: int) -> dict:
        out = {}
        while self.k < len(self.lines):
            ln, ind, content = self.lines[self.k]
            if ind != indent:
                if ind > indent:
                    raise YamlSubsetError(ln, "bad indentation in a block mapping")
                break
            kv = _split_key(content)
            if kv is None:
                if content == "-" or content.startswith("- "):
                    break  # a sequence at the parent key's indent ends here
                raise YamlSubsetError(ln, f"expected 'key: value', found {content!r}")
            key_text, rest = kv
            key = resolve_plain(key_text, ln)
            self.k += 1
            out[key] = self.value_after(rest, ln, indent, seq_ok=True)
        return out


def _balanced(text: str, line: int) -> bool:
    depth = 0
    for ch in text:
        if ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
            if depth < 0:
                raise YamlSubsetError(line, "unbalanced brackets")
    return depth == 0


def loads(text: str) -> Any:
    """Parse ``text`` (one document of the supported subset)."""
    records: List[Tuple[int, int, str]] = []
    seen_doc_start = False
    for n, raw in enumerate(text.splitlines(), start=1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError(n, "tabs in indentation are not allowed")
        if raw.startswith("%"):
            if records or seen_doc_start or not (raw.startswith("%YAML:1.") or
                                                raw.startswith("%YAML 1.")):
                raise YamlSubsetError(n, f"unsupported directive {raw.strip()!r}")
            continue
        stripped = _strip_comment(raw)
        if not stripped.strip():
            continue
        if stripped.rstrip() in ("---", "..."):
            if records or seen_doc_start or stripped.rstrip() == "...":
                raise YamlSubsetError(n, "several documents are not supported")
            seen_doc_start = True
            continue
        if stripped.startswith("--- ") or stripped.startswith("... "):
            raise YamlSubsetError(n, "several documents are not supported")
        content = stripped.lstrip(" ")
        records.append((n, len(stripped) - len(content), content))
    if not records:
        return None
    p = _Block(records)
    value = p.node(records[0][1])
    if p.k < len(records):
        raise YamlSubsetError(records[p.k][0], "unexpected text after the document's root node")
    return value


def load(path: str) -> Any:
    with open(path) as f:
        return loads(f.read())
