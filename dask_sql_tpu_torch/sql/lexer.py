"""SQL lexer: text -> token stream with line/col positions.

Dialect decisions follow the reference's DaskSqlDialect
(upstream planner/src/main/java/com/dask/sql/application/DaskSqlDialect.java:25-26):
unquoted identifiers KEEP their case (pandas-compatible `df.Name` columns),
keywords are case-insensitive; quoted identifiers use double quotes or
backticks; strings use single quotes with '' escaping.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional


class LexError(Exception):
    def __init__(self, message: str, line: int, col: int):
        super().__init__(message)
        self.line = line
        self.col = col


@dataclass
class Token:
    kind: str          # IDENT | QIDENT | STRING | NUMBER | OP | EOF
    text: str          # raw text (identifier case preserved; string unescaped)
    line: int
    col: int

    @property
    def upper(self) -> str:
        return self.text.upper()

    def __repr__(self):
        return f"{self.kind}({self.text!r}@{self.line}:{self.col})"


_MULTI_OPS = ["<>", "!=", ">=", "<=", "||", "::", "=>"]
_SINGLE_OPS = set("+-*/%=<>(),.;[]{}?&^|~:$")


def tokenize(sql: str) -> List[Token]:
    tokens: List[Token] = []
    i, n = 0, len(sql)
    line, col = 1, 1

    def advance(k: int):
        nonlocal i, line, col
        for _ in range(k):
            if i < n and sql[i] == "\n":
                line += 1
                col = 1
            else:
                col += 1
            i += 1

    while i < n:
        c = sql[i]
        # whitespace
        if c in " \t\r\n":
            advance(1)
            continue
        # line comment
        if c == "-" and i + 1 < n and sql[i + 1] == "-":
            while i < n and sql[i] != "\n":
                advance(1)
            continue
        # block comment
        if c == "/" and i + 1 < n and sql[i + 1] == "*":
            start_line, start_col = line, col
            advance(2)
            while i < n and not (sql[i] == "*" and i + 1 < n and sql[i + 1] == "/"):
                advance(1)
            if i >= n:
                raise LexError("Unterminated block comment", start_line, start_col)
            advance(2)
            continue
        # string literal
        if c == "'":
            start_line, start_col = line, col
            advance(1)
            buf = []
            while True:
                if i >= n:
                    raise LexError("Unterminated string literal", start_line, start_col)
                if sql[i] == "'":
                    if i + 1 < n and sql[i + 1] == "'":
                        buf.append("'")
                        advance(2)
                        continue
                    advance(1)
                    break
                buf.append(sql[i])
                advance(1)
            tokens.append(Token("STRING", "".join(buf), start_line, start_col))
            continue
        # quoted identifier
        if c in ('"', "`"):
            quote = c
            start_line, start_col = line, col
            advance(1)
            buf = []
            while True:
                if i >= n:
                    raise LexError("Unterminated quoted identifier", start_line, start_col)
                if sql[i] == quote:
                    if i + 1 < n and sql[i + 1] == quote:
                        buf.append(quote)
                        advance(2)
                        continue
                    advance(1)
                    break
                buf.append(sql[i])
                advance(1)
            tokens.append(Token("QIDENT", "".join(buf), start_line, start_col))
            continue
        # number
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            start_line, start_col = line, col
            j = i
            seen_dot = False
            seen_exp = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j + 1 < n and (
                    sql[j + 1].isdigit() or (sql[j + 1] in "+-" and j + 2 < n and sql[j + 2].isdigit())
                ):
                    seen_exp = True
                    j += 2 if sql[j + 1] in "+-" else 1
                else:
                    break
            text = sql[i:j]
            advance(j - i)
            tokens.append(Token("NUMBER", text, start_line, start_col))
            continue
        # identifier / keyword
        if c.isalpha() or c == "_":
            start_line, start_col = line, col
            j = i
            while j < n and (sql[j].isalnum() or sql[j] in "_$"):
                j += 1
            text = sql[i:j]
            advance(j - i)
            tokens.append(Token("IDENT", text, start_line, start_col))
            continue
        # operators
        two = sql[i : i + 2]
        if two in _MULTI_OPS:
            tokens.append(Token("OP", two, line, col))
            advance(2)
            continue
        if c in _SINGLE_OPS:
            tokens.append(Token("OP", c, line, col))
            advance(1)
            continue
        raise LexError(f"Unexpected character {c!r}", line, col)

    tokens.append(Token("EOF", "", line, col))
    return tokens
