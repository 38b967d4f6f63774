"""Tokenizer for the pbrt scene-description language.

Reference analog: core/parser.{h,cpp} Tokenizer (mmap-based, parser.cpp:98-
200).  Token kinds: quoted strings, '[' / ']', and bare atoms (numbers or
directive names).  '#' starts a comment to end of line.  Tracks file/line
for error messages (the reference's Loc).
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional


class Token(NamedTuple):
    kind: str  # 'string' | 'open' | 'close' | 'atom'
    value: str
    filename: str
    line: int

    @property
    def loc(self) -> str:
        return f"{self.filename}:{self.line}"


class Tokenizer:
    """Pull-based tokenizer with one-token lookahead."""

    def __init__(self, text: str, filename: str = "<string>"):
        self._it = _tokenize(text, filename)
        self._peeked: Optional[Token] = None
        self.filename = filename

    @classmethod
    def from_file(cls, path: str) -> "Tokenizer":
        with open(path, "r", errors="replace") as f:
            return cls(f.read(), path)

    def peek(self) -> Optional[Token]:
        if self._peeked is None:
            self._peeked = next(self._it, None)
        return self._peeked

    def next(self) -> Optional[Token]:
        if self._peeked is not None:
            t, self._peeked = self._peeked, None
            return t
        return next(self._it, None)


def _tokenize(text: str, filename: str) -> Iterator[Token]:
    i, n, line = 0, len(text), 1
    while i < n:
        c = text[i]
        if c == "\n":
            line += 1
            i += 1
        elif c in " \t\r":
            i += 1
        elif c == "#":
            j = text.find("\n", i)
            i = n if j < 0 else j
        elif c == '"':
            j = i + 1
            parts = []
            while j < n and text[j] != '"':
                if text[j] == "\\" and j + 1 < n:
                    esc = text[j + 1]
                    parts.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\"}.get(esc, esc))
                    j += 2
                    continue
                if text[j] == "\n":
                    raise SyntaxError(f"{filename}:{line}: unterminated string")
                parts.append(text[j])
                j += 1
            if j >= n:
                raise SyntaxError(f"{filename}:{line}: unterminated string")
            yield Token("string", "".join(parts), filename, line)
            i = j + 1
        elif c == "[":
            yield Token("open", "[", filename, line)
            i += 1
        elif c == "]":
            yield Token("close", "]", filename, line)
            i += 1
        else:
            j = i
            while j < n and text[j] not in ' \t\r\n"[]#':
                j += 1
            yield Token("atom", text[i:j], filename, line)
            i = j
