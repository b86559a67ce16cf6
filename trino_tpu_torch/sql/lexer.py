"""SQL tokenizer.

Reference parity: the lexer rules of core/trino-parser/src/main/antlr4/io/
trino/sql/parser/SqlBase.g4 (identifiers, quoted identifiers, string literals
with '' escape, numbers, operators, comments).
"""

from __future__ import annotations

import dataclasses
import re
from typing import List


from trino_tpu_torch.errors import SYNTAX_ERROR, TrinoError


class ParsingError(TrinoError):
    CODE = SYNTAX_ERROR

    def __init__(self, message: str, line: int = 0, column: int = 0):
        super().__init__(f"line {line}:{column}: {message}")
        self.message = message
        self.line = line
        self.column = column


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str    # KEYWORD IDENT QIDENT STRING INTEGER DECIMAL OP PARAM EOF
    text: str
    line: int
    column: int

    @property
    def upper(self) -> str:
        return self.text.upper()


# Trino reserved words (SqlBase.g4 nonReserved inverse); kept minimal — words
# here cannot be used as bare identifiers.
RESERVED = {
    "SELECT", "FROM", "WHERE", "GROUP", "BY", "HAVING", "ORDER", "LIMIT",
    "AND", "OR", "NOT", "NULL", "TRUE", "FALSE", "AS", "ON", "JOIN", "INNER",
    "LEFT", "RIGHT", "FULL", "OUTER", "CROSS", "UNION", "INTERSECT", "EXCEPT",
    "DISTINCT", "ALL", "CASE", "WHEN", "THEN", "ELSE", "END", "CAST", "IN",
    "IS", "BETWEEN", "LIKE", "EXISTS", "WITH", "RECURSIVE", "VALUES",
    "CREATE", "TABLE", "INSERT", "INTO", "DELETE", "DROP", "DESC", "ASC",
    "NULLS", "FIRST", "LAST", "USING", "NATURAL", "EXTRACT", "INTERVAL",
    "OFFSET", "FETCH", "CONSTRAINT", "FOR", "GROUPING", "ESCAPE",
    "UNNEST", "PREPARE", "EXECUTE", "DEALLOCATE", "COMMIT", "ROLLBACK",
}

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<line_comment>--[^\n]*)
  | (?P<block_comment>/\*.*?\*/)
  | (?P<decimal>(?:\d+\.\d*|\.\d+)(?:[eE][+-]?\d+)?|\d+[eE][+-]?\d+)
  | (?P<integer>\d+)
  | (?P<string>'(?:[^']|'')*')
  | (?P<qident>"(?:[^"]|"")*")
  | (?P<ident>[A-Za-z_][A-Za-z0-9_$]*)
  | (?P<op><=|>=|<>|!=|\|\||=>|[-+*/%<>=(),.;?\[\]])
""", re.VERBOSE | re.DOTALL)


def tokenize(sql: str) -> List[Token]:
    tokens: List[Token] = []
    pos, line, line_start, n = 0, 1, 0, len(sql)
    param_index = 0
    while pos < n:
        m = _TOKEN_RE.match(sql, pos)
        if m is None:
            raise ParsingError(
                f"unexpected character {sql[pos]!r}", line, pos - line_start)
        kind = m.lastgroup
        text = m.group()
        col = m.start() - line_start
        if kind in ("ws", "line_comment", "block_comment"):
            pass  # line tracking below
        elif kind == "ident":
            tk = "KEYWORD" if text.upper() in RESERVED else "IDENT"
            tokens.append(Token(tk, text, line, col))
        elif kind == "qident":
            tokens.append(
                Token("QIDENT", text[1:-1].replace('""', '"'), line, col))
        elif kind == "string":
            tokens.append(
                Token("STRING", text[1:-1].replace("''", "'"), line, col))
        elif kind == "integer":
            tokens.append(Token("INTEGER", text, line, col))
        elif kind == "decimal":
            tokens.append(Token("DECIMAL", text, line, col))
        elif kind == "op":
            if text == "?":
                tokens.append(Token("PARAM", str(param_index), line, col))
                param_index += 1
            else:
                tokens.append(Token("OP", text, line, col))
        # advance line tracking for ANY token containing newlines (multi-line
        # strings/comments/quoted identifiers included)
        nl = text.count("\n")
        if nl:
            line += nl
            line_start = m.start() + text.rindex("\n") + 1
        pos = m.end()
    tokens.append(Token("EOF", "", line, n - line_start))
    return tokens
