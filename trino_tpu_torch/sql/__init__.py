"""SQL frontend: lexer, parser, AST, analyzer.

Reference parity: core/trino-parser (grammar SqlBase.g4, AstBuilder, 224 AST
nodes in sql/tree/) + core/trino-main sql/analyzer/. The reference uses an
ANTLR4-generated parser; here a hand-written recursive-descent parser keeps the
frontend dependency-free (SURVEY.md §2.2 "TPU build" column).
"""

from trino_tpu_torch.sql.parser import parse_statement, parse_expression  # noqa: F401
