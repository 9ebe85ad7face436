"""Tokenizer for the SLR scene-description language.

Python reimplementation of the flex scanner's token set
(reference libSLRSceneGraph/Parser/SceneLexer.l): identifiers, integer/real
literals, double-quoted strings, `//` and `/* */` comments, and the operator
set of the grammar (SceneParser.yy:100-110).
"""
from __future__ import annotations

import re
from typing import Iterator, NamedTuple


class Token(NamedTuple):
    kind: str
    value: str
    line: int


KEYWORDS = {"if", "else", "for", "function", "return", "true", "false"}

# Longest-match-first operator list.
OPERATORS = [
    "+=", "-=", "*=", "/=", "%=", "==", "!=", "<=", ">=", "&&", "||",
    "++", "--",
    "=", "<", ">", "+", "-", "*", "/", "%", "!",
    "(", ")", "{", "}", "[", "]", ",", ";", ":",
]

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>//[^\n]*|/\*.*?\*/)
  | (?P<real>(?:\d+\.\d*|\.\d+)(?:[eE][-+]?\d+)?|\d+[eE][-+]?\d+)
  | (?P<int>\d+)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<id>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>""" + "|".join(re.escape(op) for op in OPERATORS) + r""")
    """,
    re.X | re.S,
)


class LexError(Exception):
    pass


def tokenize(src: str) -> Iterator[Token]:
    pos = 0
    line = 1
    n = len(src)
    while pos < n:
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise LexError(f"line {line}: unexpected character {src[pos]!r}")
        text = m.group(0)
        line += text.count("\n")
        pos = m.end()
        if m.lastgroup in ("ws", "comment"):
            continue
        kind = m.lastgroup
        if kind == "id":
            if text in ("true", "false"):
                yield Token("bool", text, line)
                continue
            if text in KEYWORDS:
                yield Token(text, text, line)
                continue
            yield Token("id", text, line)
        elif kind == "string":
            yield Token("string", text[1:-1].encode().decode("unicode_escape"), line)
        elif kind in ("real", "int"):
            yield Token(kind, text, line)
        else:
            yield Token(text, text, line)
    yield Token("eof", "", line)
