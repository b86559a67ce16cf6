"""Recursive-descent SQL parser.

Reference parity: core/trino-parser SqlParser.java + AstBuilder.java over
SqlBase.g4 (1001 lines). Grammar coverage: full query expressions (WITH,
set operations, joins, grouping sets, window functions), the expression
grammar with Trino's precedence (OR < AND < NOT < comparison/predicates <
additive < multiplicative < unary < postfix), EXPLAIN [ANALYZE], SHOW,
SET/RESET SESSION, CREATE TABLE [AS], INSERT, DELETE, DROP, USE,
PREPARE/EXECUTE/DEALLOCATE, transactions.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from trino_tpu_torch.sql import tree as t
from trino_tpu_torch.sql.lexer import ParsingError, Token, tokenize

_COMPARISON_OPS = {"=", "<>", "!=", "<", "<=", ">", ">="}


class _Parser:
    def __init__(self, tokens: List[Token]):
        self.tokens = tokens
        self.pos = 0

    # ------------------------------------------------------------- utilities

    def peek(self, offset: int = 0) -> Token:
        return self.tokens[min(self.pos + offset, len(self.tokens) - 1)]

    def next(self) -> Token:
        tok = self.tokens[self.pos]
        if tok.kind != "EOF":
            self.pos += 1
        return tok

    def at_keyword(self, *words: str) -> bool:
        tok = self.peek()
        return tok.kind in ("KEYWORD", "IDENT") and tok.upper in words

    def accept_keyword(self, *words: str) -> bool:
        if self.at_keyword(*words):
            self.next()
            return True
        return False

    def expect_keyword(self, word: str) -> Token:
        if not self.at_keyword(word):
            self.error(f"expected {word}")
        return self.next()

    def at_op(self, *ops: str) -> bool:
        tok = self.peek()
        return tok.kind == "OP" and tok.text in ops

    def accept_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> Token:
        if not self.at_op(op):
            self.error(f"expected '{op}'")
        return self.next()

    def error(self, message: str):
        tok = self.peek()
        got = tok.text or "<eof>"
        raise ParsingError(f"{message}, found {got!r}", tok.line, tok.column)

    def identifier(self) -> t.Identifier:
        tok = self.peek()
        if tok.kind == "IDENT":
            self.next()
            return t.Identifier(tok.text.lower())
        if tok.kind == "QIDENT":
            self.next()
            return t.Identifier(tok.text, quoted=True)
        # non-reserved keywords usable as identifiers
        if tok.kind == "KEYWORD" and tok.upper not in (
                "SELECT", "FROM", "WHERE", "GROUP", "HAVING", "ORDER",
                "UNION", "INTERSECT", "EXCEPT", "ON", "JOIN", "AND", "OR"):
            self.next()
            return t.Identifier(tok.text.lower())
        self.error("expected identifier")

    def qualified_name(self) -> t.QualifiedName:
        parts = [self.identifier().value]
        while self.at_op(".") and self.peek(1).kind in (
                "IDENT", "QIDENT", "KEYWORD"):
            self.next()
            parts.append(self.identifier().value)
        return t.QualifiedName(tuple(parts))

    # ------------------------------------------------------------ statements

    def statement(self) -> t.Statement:
        if self.at_keyword("SELECT", "WITH", "VALUES") or self.at_op("("):
            return self.query()
        if self.at_keyword("EXPLAIN"):
            return self.explain()
        if self.at_keyword("SHOW"):
            return self.show()
        if self.at_keyword("SET"):
            return self.set_session()
        if self.at_keyword("RESET"):
            self.next()
            self.expect_keyword("SESSION")
            return t.ResetSession(self.qualified_name())
        if self.at_keyword("CREATE"):
            return self.create()
        if self.at_keyword("DROP"):
            return self.drop()
        if self.at_keyword("INSERT"):
            return self.insert()
        if self.at_keyword("DELETE"):
            return self.delete()
        if self.at_keyword("USE"):
            return self.use()
        if self.at_keyword("PREPARE"):
            self.next()
            name = self.identifier()
            self.expect_keyword("FROM")
            return t.Prepare(name, self.statement())
        if self.at_keyword("EXECUTE"):
            self.next()
            name = self.identifier()
            params: Tuple[t.Expression, ...] = ()
            if self.accept_keyword("USING"):
                params = tuple(self.expression_list())
            return t.ExecuteStatement(name, params)
        if self.at_keyword("DEALLOCATE"):
            self.next()
            self.expect_keyword("PREPARE")
            return t.Deallocate(self.identifier())
        if self.at_keyword("COMMIT"):
            self.next()
            return t.Commit()
        if self.at_keyword("ROLLBACK"):
            self.next()
            return t.Rollback()
        if self.at_keyword("START"):
            self.next()
            self.expect_keyword("TRANSACTION")
            return t.StartTransaction()
        if self.at_keyword("ANALYZE"):
            self.next()
            return t.Analyze(self.qualified_name())
        if self.at_keyword("REFRESH"):
            self.next()
            self.expect_keyword("MATERIALIZED")
            self.expect_keyword("VIEW")
            return t.RefreshMaterializedView(self.qualified_name())
        self.error("unexpected statement")

    def explain(self) -> t.Explain:
        self.expect_keyword("EXPLAIN")
        analyze = self.accept_keyword("ANALYZE")
        explain_type = "DISTRIBUTED"
        if self.accept_op("("):
            while True:
                if self.accept_keyword("TYPE"):
                    explain_type = self.next().upper
                elif self.accept_keyword("FORMAT"):
                    self.next()
                else:
                    self.error("expected TYPE or FORMAT")
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        return t.Explain(self.statement(), analyze, explain_type)

    def show(self) -> t.Statement:
        self.expect_keyword("SHOW")
        if self.accept_keyword("TABLES"):
            schema = None
            if self.accept_keyword("FROM", "IN"):
                schema = self.qualified_name()
            like = None
            if self.accept_keyword("LIKE"):
                like = self.next().text
            return t.ShowTables(schema, like)
        if self.accept_keyword("SCHEMAS"):
            catalog = None
            if self.accept_keyword("FROM", "IN"):
                catalog = self.identifier().value
            return t.ShowSchemas(catalog)
        if self.accept_keyword("CATALOGS"):
            return t.ShowCatalogs()
        if self.accept_keyword("COLUMNS"):
            self.expect_keyword("FROM")
            return t.ShowColumns(self.qualified_name())
        if self.accept_keyword("SESSION"):
            return t.ShowSession()
        if self.accept_keyword("FUNCTIONS"):
            return t.ShowFunctions()
        if self.accept_keyword("STATS"):
            self.expect_keyword("FOR")
            if self.accept_op("("):
                rel = t.TableSubquery(self.query())
                self.expect_op(")")
            else:
                rel = t.Table(self.qualified_name())
            return t.ShowStats(rel)
        self.error("unsupported SHOW")

    def set_session(self) -> t.SetSession:
        self.expect_keyword("SET")
        self.expect_keyword("SESSION")
        name = self.qualified_name()
        self.expect_op("=")
        return t.SetSession(name, self.expression())

    def create(self) -> t.Statement:
        self.expect_keyword("CREATE")
        if self.accept_keyword("SCHEMA"):
            not_exists = self._if_not_exists()
            return t.CreateSchema(self.qualified_name(), not_exists)
        replace = False
        if self.accept_keyword("OR"):
            self.expect_keyword("REPLACE")
            replace = True
        if self.accept_keyword("MATERIALIZED"):
            self.expect_keyword("VIEW")
            not_exists = self._if_not_exists()
            name = self.qualified_name()
            props = self._with_properties()
            self.expect_keyword("AS")
            return t.CreateMaterializedView(
                name, self.query(), replace, not_exists, props)
        if self.accept_keyword("VIEW"):
            name = self.qualified_name()
            self.expect_keyword("AS")
            return t.CreateView(name, self.query(), replace)
        self.expect_keyword("TABLE")
        not_exists = self._if_not_exists()
        name = self.qualified_name()
        if self.at_op("(") and not self.peek(1).upper == "SELECT":
            self.expect_op("(")
            cols = []
            while True:
                cname = self.identifier()
                ctype = self.type_name()
                nullable = True
                if self.accept_keyword("NOT"):
                    self.expect_keyword("NULL")
                    nullable = False
                cols.append(t.ColumnDefinition(cname, ctype, nullable))
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            props = self._with_properties()
            return t.CreateTable(name, tuple(cols), not_exists, props)
        props = self._with_properties()
        self.expect_keyword("AS")
        query = self.query()
        with_data = True
        if self.accept_keyword("WITH"):
            if self.accept_keyword("NO"):
                with_data = False
            self.expect_keyword("DATA")
        return t.CreateTableAsSelect(name, query, not_exists, with_data, props)

    def _if_not_exists(self) -> bool:
        if self.accept_keyword("IF"):
            self.expect_keyword("NOT")
            self.expect_keyword("EXISTS")
            return True
        return False

    def _with_properties(self):
        props = []
        if self.accept_keyword("WITH"):
            self.expect_op("(")
            while True:
                key = self.identifier().value
                self.expect_op("=")
                props.append((key, self.expression()))
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        return tuple(props)

    def drop(self) -> t.Statement:
        self.expect_keyword("DROP")
        kind = "VIEW" if self.accept_keyword("VIEW") else None
        if kind is None and self.accept_keyword("MATERIALIZED"):
            self.expect_keyword("VIEW")
            kind = "MATERIALIZED VIEW"
        if kind is None:
            if self.accept_keyword("SCHEMA"):
                kind = "SCHEMA"
            else:
                self.expect_keyword("TABLE")
                kind = "TABLE"
        exists = False
        if self.accept_keyword("IF"):
            self.expect_keyword("EXISTS")
            exists = True
        name = self.qualified_name()
        if kind == "MATERIALIZED VIEW":
            return t.DropMaterializedView(name, exists)
        if kind == "VIEW":
            return t.DropView(name, exists)
        if kind == "SCHEMA":
            return t.DropSchema(name, exists)
        return t.DropTable(name, exists)

    def insert(self) -> t.Insert:
        self.expect_keyword("INSERT")
        self.expect_keyword("INTO")
        target = self.qualified_name()
        columns: Tuple[t.Identifier, ...] = ()
        if self.at_op("(") and self.peek(1).upper not in ("SELECT", "WITH",
                                                          "VALUES"):
            self.expect_op("(")
            cols = [self.identifier()]
            while self.accept_op(","):
                cols.append(self.identifier())
            self.expect_op(")")
            columns = tuple(cols)
        return t.Insert(target, self.query(), columns)

    def delete(self) -> t.Delete:
        self.expect_keyword("DELETE")
        self.expect_keyword("FROM")
        table = self.qualified_name()
        where = self.expression() if self.accept_keyword("WHERE") else None
        return t.Delete(table, where)

    def use(self) -> t.Use:
        self.expect_keyword("USE")
        first = self.identifier()
        if self.accept_op("."):
            return t.Use(first, self.identifier())
        return t.Use(None, first)

    # ----------------------------------------------------- query expressions

    def query(self) -> t.Query:
        with_ = None
        if self.accept_keyword("WITH"):
            recursive = self.accept_keyword("RECURSIVE")
            queries = [self.with_query()]
            while self.accept_op(","):
                queries.append(self.with_query())
            with_ = t.With(recursive, tuple(queries))
        body, order_by, offset, limit = self.query_no_with()
        return t.Query(body, with_, order_by, offset, limit)

    def with_query(self) -> t.WithQuery:
        name = self.identifier()
        column_names: Tuple[t.Identifier, ...] = ()
        if self.accept_op("("):
            cols = [self.identifier()]
            while self.accept_op(","):
                cols.append(self.identifier())
            self.expect_op(")")
            column_names = tuple(cols)
        self.expect_keyword("AS")
        self.expect_op("(")
        query = self.query()
        self.expect_op(")")
        return t.WithQuery(name, query, column_names)

    def query_no_with(self):
        body = self.query_term()
        order_by: Tuple[t.SortItem, ...] = ()
        if self.accept_keyword("ORDER"):
            self.expect_keyword("BY")
            order_by = self.sort_items()
        offset = None
        if self.accept_keyword("OFFSET"):
            offset = self.expression()
            self.accept_keyword("ROW", "ROWS")
        limit = None
        if self.accept_keyword("LIMIT"):
            if self.accept_keyword("ALL"):
                limit = None
            else:
                limit = self.expression()
        elif self.accept_keyword("FETCH"):
            self.accept_keyword("FIRST", "NEXT")
            limit = self.expression()
            self.accept_keyword("ROW", "ROWS")
            self.accept_keyword("ONLY")
        # hoist trailing clauses into a bare QuerySpecification (Trino's
        # AstBuilder does the same when the body is a simple select)
        if isinstance(body, t.QuerySpecification) and not (
                body.order_by or body.limit or body.offset):
            body = t.QuerySpecification(
                body.select, body.from_, body.where, body.group_by,
                body.having, order_by, offset, limit)
            return body, (), None, None
        return body, order_by, offset, limit

    def query_term(self) -> t.QueryBody:
        left = self.query_term2()
        while self.at_keyword("UNION", "EXCEPT"):
            op = self.next().upper
            distinct = not self.accept_keyword("ALL")
            self.accept_keyword("DISTINCT")
            right = self.query_term2()
            left = t.SetOperation(op, distinct, left, right)
        return left

    def query_term2(self) -> t.QueryBody:
        left = self.query_primary()
        while self.at_keyword("INTERSECT"):
            self.next()
            distinct = not self.accept_keyword("ALL")
            self.accept_keyword("DISTINCT")
            right = self.query_primary()
            left = t.SetOperation("INTERSECT", distinct, left, right)
        return left

    def query_primary(self) -> t.QueryBody:
        if self.at_keyword("SELECT"):
            return self.query_specification()
        if self.accept_keyword("VALUES"):
            rows = [self.expression()]
            while self.accept_op(","):
                rows.append(self.expression())
            q = t.Values(tuple(rows))
            return t.QuerySpecification(
                t.Select(False, (t.AllColumns(),)), q)
        if self.accept_op("("):
            body, order_by, offset, limit = self.query_no_with()
            self.expect_op(")")
            if order_by or offset or limit:
                # parenthesized query with its own ordering
                return t.QuerySpecification(
                    t.Select(False, (t.AllColumns(),)),
                    t.TableSubquery(t.Query(body, None, order_by, offset,
                                            limit)))
            return body
        self.error("expected query")

    def query_specification(self) -> t.QuerySpecification:
        self.expect_keyword("SELECT")
        distinct = False
        if self.accept_keyword("DISTINCT"):
            distinct = True
        else:
            self.accept_keyword("ALL")
        items = [self.select_item()]
        while self.accept_op(","):
            items.append(self.select_item())
        from_ = None
        if self.accept_keyword("FROM"):
            from_ = self.relation()
            while self.accept_op(","):
                right = self.relation()
                from_ = t.Join("IMPLICIT", from_, right)
        where = self.expression() if self.accept_keyword("WHERE") else None
        group_by = None
        if self.accept_keyword("GROUP"):
            self.expect_keyword("BY")
            gdistinct = False
            if self.accept_keyword("DISTINCT"):
                gdistinct = True
            else:
                self.accept_keyword("ALL")
            group_by = t.GroupBy(gdistinct, tuple(self.grouping_elements()))
        having = self.expression() if self.accept_keyword("HAVING") else None
        return t.QuerySpecification(
            t.Select(distinct, tuple(items)), from_, where, group_by, having)

    def grouping_elements(self):
        elements = [self.grouping_element()]
        while self.accept_op(","):
            elements.append(self.grouping_element())
        return elements

    def grouping_element(self) -> t.GroupingElement:
        if self.at_keyword("ROLLUP") and self.peek(1).text == "(":
            self.next()
            self.expect_op("(")
            exprs = self.expression_list()
            self.expect_op(")")
            return t.Rollup(tuple(exprs))
        if self.at_keyword("CUBE") and self.peek(1).text == "(":
            self.next()
            self.expect_op("(")
            exprs = self.expression_list()
            self.expect_op(")")
            return t.Cube(tuple(exprs))
        if self.at_keyword("GROUPING") and self.peek(1).upper == "SETS":
            self.next()
            self.next()
            self.expect_op("(")
            sets = []
            while True:
                if self.accept_op("("):
                    if self.accept_op(")"):
                        sets.append(())
                    else:
                        sets.append(tuple(self.expression_list()))
                        self.expect_op(")")
                else:
                    sets.append((self.expression(),))
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            return t.GroupingSets(tuple(sets))
        return t.SimpleGroupBy((self.expression(),))

    def select_item(self) -> t.Node:
        if self.at_op("*"):
            self.next()
            return t.AllColumns()
        # t.* / catalog.schema.t.*
        save = self.pos
        if self.peek().kind in ("IDENT", "QIDENT"):
            try:
                name = self.qualified_name()
                if self.at_op(".") and self.peek(1).text == "*":
                    self.next()
                    self.next()
                    return t.AllColumns(name)
            except ParsingError:
                pass
            self.pos = save
        expr = self.expression()
        alias = None
        if self.accept_keyword("AS"):
            alias = self.identifier()
        elif self.peek().kind in ("IDENT", "QIDENT"):
            alias = self.identifier()
        return t.SingleColumn(expr, alias)

    def sort_items(self) -> Tuple[t.SortItem, ...]:
        items = [self.sort_item()]
        while self.accept_op(","):
            items.append(self.sort_item())
        return tuple(items)

    def sort_item(self) -> t.SortItem:
        key = self.expression()
        ascending = True
        if self.accept_keyword("ASC"):
            pass
        elif self.accept_keyword("DESC"):
            ascending = False
        nulls_first = None
        if self.accept_keyword("NULLS"):
            if self.accept_keyword("FIRST"):
                nulls_first = True
            else:
                self.expect_keyword("LAST")
                nulls_first = False
        return t.SortItem(key, ascending, nulls_first)

    # -------------------------------------------------------------- relations

    def relation(self) -> t.Relation:
        left = self.sampled_relation()
        while True:
            if self.accept_keyword("CROSS"):
                self.expect_keyword("JOIN")
                right = self.sampled_relation()
                left = t.Join("CROSS", left, right)
                continue
            natural = self.at_keyword("NATURAL")
            if natural:
                self.next()
            join_type = None
            if self.accept_keyword("INNER"):
                join_type = "INNER"
            elif self.accept_keyword("LEFT"):
                self.accept_keyword("OUTER")
                join_type = "LEFT"
            elif self.accept_keyword("RIGHT"):
                self.accept_keyword("OUTER")
                join_type = "RIGHT"
            elif self.accept_keyword("FULL"):
                self.accept_keyword("OUTER")
                join_type = "FULL"
            if join_type is None and self.at_keyword("JOIN"):
                join_type = "INNER"
            if join_type is None:
                if natural:
                    self.error("expected JOIN after NATURAL")
                return left
            self.expect_keyword("JOIN")
            right = self.sampled_relation()
            criteria = None
            if not natural:
                if self.accept_keyword("ON"):
                    criteria = t.JoinOn(self.expression())
                elif self.accept_keyword("USING"):
                    self.expect_op("(")
                    cols = [self.identifier()]
                    while self.accept_op(","):
                        cols.append(self.identifier())
                    self.expect_op(")")
                    criteria = t.JoinUsing(tuple(cols))
            left = t.Join(join_type, left, right, criteria)

    def sampled_relation(self) -> t.Relation:
        rel = self.aliased_relation()
        if self.at_keyword("TABLESAMPLE"):
            self.next()
            self.next()  # BERNOULLI | SYSTEM
            self.expect_op("(")
            self.expression()
            self.expect_op(")")
        return rel

    def aliased_relation(self) -> t.Relation:
        rel = self.relation_primary()
        alias = None
        if self.accept_keyword("AS"):
            alias = self.identifier()
        elif self.peek().kind in ("IDENT", "QIDENT") and not self.at_keyword(
                "CROSS", "NATURAL", "INNER", "LEFT", "RIGHT", "FULL", "JOIN",
                "ON", "USING", "TABLESAMPLE"):
            alias = self.identifier()
        if alias is not None:
            column_names: Tuple[t.Identifier, ...] = ()
            if self.accept_op("("):
                cols = [self.identifier()]
                while self.accept_op(","):
                    cols.append(self.identifier())
                self.expect_op(")")
                column_names = tuple(cols)
            return t.AliasedRelation(rel, alias, column_names)
        return rel

    def relation_primary(self) -> t.Relation:
        if self.accept_op("("):
            if self.at_keyword("SELECT", "WITH", "VALUES"):
                query = self.query()
                self.expect_op(")")
                return t.TableSubquery(query)
            if self.at_op("("):
                # ambiguous: "((" opens either a nested subquery or a
                # parenthesized join tree (TPC-DS q72-style
                # "((((t JOIN ...) JOIN ...)"); try query, backtrack
                save = self.pos
                try:
                    query = self.query()
                    self.expect_op(")")
                    return t.TableSubquery(query)
                except ParsingError:
                    self.pos = save
            rel = self.relation()
            self.expect_op(")")
            return rel
        if self.at_keyword("UNNEST"):
            self.next()
            self.expect_op("(")
            exprs = self.expression_list()
            self.expect_op(")")
            with_ord = False
            if self.accept_keyword("WITH"):
                self.expect_keyword("ORDINALITY")
                with_ord = True
            return t.Unnest(tuple(exprs), with_ord)
        if self.at_keyword("VALUES"):
            self.next()
            rows = [self.expression()]
            while self.accept_op(","):
                rows.append(self.expression())
            return t.Values(tuple(rows))
        if self.at_keyword("TABLE"):
            self.next()
            return self._table_reference()
        if self.at_keyword("LATERAL"):
            self.next()
            self.expect_op("(")
            query = self.query()
            self.expect_op(")")
            return t.TableSubquery(query)
        return self._table_reference()

    def _table_reference(self) -> t.Table:
        """Table name with optional time travel:
        `name [FOR VERSION|TIMESTAMP AS OF <expr>]`."""
        name = self.qualified_name()
        version = timestamp = None
        if self.accept_keyword("FOR"):
            if self.accept_keyword("VERSION"):
                which = "version"
            elif self.accept_keyword("TIMESTAMP"):
                which = "timestamp"
            else:
                self.error("expected VERSION or TIMESTAMP after FOR")
            self.expect_keyword("AS")
            self.expect_keyword("OF")
            expr = self.expression()
            if which == "version":
                version = expr
            else:
                timestamp = expr
        return t.Table(name, version, timestamp)

    # ------------------------------------------------------------ expressions

    def expression_list(self) -> List[t.Expression]:
        out = [self.expression()]
        while self.accept_op(","):
            out.append(self.expression())
        return out

    def expression(self) -> t.Expression:
        return self.or_expression()

    def or_expression(self) -> t.Expression:
        left = self.and_expression()
        while self.at_keyword("OR"):
            self.next()
            left = t.LogicalBinary("OR", left, self.and_expression())
        return left

    def and_expression(self) -> t.Expression:
        left = self.not_expression()
        while self.at_keyword("AND"):
            self.next()
            left = t.LogicalBinary("AND", left, self.not_expression())
        return left

    def not_expression(self) -> t.Expression:
        if self.at_keyword("NOT"):
            self.next()
            return t.NotExpression(self.not_expression())
        return self.predicate()

    def predicate(self) -> t.Expression:
        left = self.value_expression()
        while True:
            if self.at_op(*_COMPARISON_OPS):
                op = self.next().text
                if op == "!=":
                    op = "<>"
                # quantified comparison: = ANY (subquery) etc.
                if self.at_keyword("ANY", "SOME", "ALL") and \
                        self.peek(1).text == "(":
                    self.error("quantified comparisons not supported")
                left = t.ComparisonExpression(op, left,
                                              self.value_expression())
                continue
            negated = False
            save = self.pos
            if self.at_keyword("NOT"):
                self.next()
                negated = True
            if self.accept_keyword("BETWEEN"):
                low = self.value_expression()
                self.expect_keyword("AND")
                high = self.value_expression()
                left = t.BetweenPredicate(left, low, high)
            elif self.accept_keyword("IN"):
                self.expect_op("(")
                if self.at_keyword("SELECT", "WITH"):
                    vl: t.Expression = t.SubqueryExpression(self.query())
                else:
                    vl = t.InListExpression(tuple(self.expression_list()))
                self.expect_op(")")
                left = t.InPredicate(left, vl)
            elif self.accept_keyword("LIKE"):
                pattern = self.value_expression()
                escape = None
                if self.accept_keyword("ESCAPE"):
                    escape = self.value_expression()
                left = t.LikePredicate(left, pattern, escape)
            elif self.accept_keyword("IS"):
                isnot = self.accept_keyword("NOT")
                if self.accept_keyword("NULL"):
                    left = t.IsNotNullPredicate(left) if isnot \
                        else t.IsNullPredicate(left)
                elif self.accept_keyword("DISTINCT"):
                    self.expect_keyword("FROM")
                    right = self.value_expression()
                    cmp = t.ComparisonExpression("IS DISTINCT FROM", left,
                                                 right)
                    left = t.NotExpression(cmp) if isnot else cmp
                elif self.accept_keyword("TRUE"):
                    cmp = t.ComparisonExpression(
                        "IS NOT DISTINCT FROM", left, t.BooleanLiteral(True))
                    left = t.NotExpression(cmp) if isnot else cmp
                elif self.accept_keyword("FALSE"):
                    cmp = t.ComparisonExpression(
                        "IS NOT DISTINCT FROM", left, t.BooleanLiteral(False))
                    left = t.NotExpression(cmp) if isnot else cmp
                else:
                    self.error("expected NULL or DISTINCT FROM after IS")
                if negated:
                    left = t.NotExpression(left)
                    negated = False
                continue
            else:
                if negated:
                    self.pos = save
                return left
            if negated:
                left = t.NotExpression(left)

    def value_expression(self) -> t.Expression:
        left = self.term()
        while self.at_op("+", "-", "||"):
            op = self.next().text
            right = self.term()
            if op == "||":
                left = t.FunctionCall(
                    t.QualifiedName(("concat",)), (left, right))
            else:
                left = t.ArithmeticBinary(op, left, right)
        return left

    def term(self) -> t.Expression:
        left = self.unary()
        while self.at_op("*", "/", "%"):
            op = self.next().text
            left = t.ArithmeticBinary(op, left, self.unary())
        return left

    def unary(self) -> t.Expression:
        if self.at_op("+"):
            self.next()
            return self.unary()
        if self.at_op("-"):
            self.next()
            value = self.unary()
            if isinstance(value, t.LongLiteral):
                return t.LongLiteral(-value.value)
            if isinstance(value, t.DoubleLiteral):
                return t.DoubleLiteral(-value.value)
            if isinstance(value, t.DecimalLiteral):
                return t.DecimalLiteral("-" + value.text)
            return t.ArithmeticUnary("-", value)
        return self.postfix()

    def postfix(self) -> t.Expression:
        expr = self.primary()
        while True:
            if self.at_op(".") and self.peek(1).kind in (
                    "IDENT", "QIDENT", "KEYWORD"):
                self.next()
                expr = t.DereferenceExpression(expr, self.identifier())
            elif self.at_op("["):
                self.next()
                index = self.expression()
                self.expect_op("]")
                expr = t.FunctionCall(
                    t.QualifiedName(("element_at",)), (expr, index))
            else:
                return expr

    _TYPE_KEYWORDS = (
        "VARCHAR", "CHAR", "DECIMAL", "NUMERIC", "BIGINT", "INTEGER", "INT",
        "SMALLINT", "TINYINT", "DOUBLE", "REAL", "BOOLEAN", "DATE",
        "TIMESTAMP", "TIME", "VARBINARY", "JSON", "ARRAY", "MAP", "ROW",
        "INTERVAL", "UUID")

    def type_name(self) -> str:
        tok = self.next()
        name = tok.text.lower()
        if name == "double" and self.at_keyword("PRECISION"):
            self.next()
        elif name == "timestamp" or name == "time":
            if self.accept_op("("):
                name += "(" + self.next().text + ")"
                self.expect_op(")")
            if self.at_keyword("WITH", "WITHOUT"):
                with_tz = self.next().upper == "WITH"
                self.expect_keyword("TIME")
                self.expect_keyword("ZONE")
                if with_tz:
                    name += " with time zone"
        elif self.at_op("("):
            self.next()
            params = [self.next().text]
            while self.accept_op(","):
                params.append(self.next().text)
            self.expect_op(")")
            name += "(" + ",".join(params) + ")"
        elif name == "array" or name == "map":
            if self.accept_op("<"):
                inner = [self.type_name()]
                while self.accept_op(","):
                    inner.append(self.type_name())
                self.expect_op(">")
                name += "(" + ",".join(inner) + ")"
        return name

    def primary(self) -> t.Expression:
        tok = self.peek()
        if tok.kind == "INTEGER":
            self.next()
            return t.LongLiteral(int(tok.text))
        if tok.kind == "DECIMAL":
            self.next()
            # Trino: unquoted decimal literal is DOUBLE unless
            # parse_decimal_literals_as_decimal; scientific notation = double
            if "e" in tok.text.lower():
                return t.DoubleLiteral(float(tok.text))
            return t.DecimalLiteral(tok.text)
        if tok.kind == "STRING":
            self.next()
            return t.StringLiteral(tok.text)
        if tok.kind == "PARAM":
            self.next()
            return t.Parameter(int(tok.text))
        if self.at_keyword("NULL"):
            self.next()
            return t.NullLiteral()
        if self.at_keyword("TRUE"):
            self.next()
            return t.BooleanLiteral(True)
        if self.at_keyword("FALSE"):
            self.next()
            return t.BooleanLiteral(False)
        if self.at_keyword("DATE") and self.peek(1).kind == "STRING":
            self.next()
            return t.DateLiteral(self.next().text)
        if self.at_keyword("DECIMAL") and self.peek(1).kind == "STRING":
            self.next()
            return t.DecimalLiteral(self.next().text)
        if self.at_keyword("TIMESTAMP") and self.peek(1).kind == "STRING":
            self.next()
            return t.TimestampLiteral(self.next().text)
        if self.at_keyword("INTERVAL") and self.peek(1).kind in ("STRING",
                                                                 "OP"):
            return self.interval()
        if self.at_keyword("CASE"):
            return self.case_expression()
        if self.at_keyword("CAST") or self.at_keyword("TRY_CAST"):
            safe = self.next().upper == "TRY_CAST"
            self.expect_op("(")
            value = self.expression()
            self.expect_keyword("AS")
            target = self.type_name()
            self.expect_op(")")
            return t.Cast(value, target, safe)
        if self.at_keyword("EXTRACT"):
            self.next()
            self.expect_op("(")
            field = self.next().upper
            self.expect_keyword("FROM")
            value = self.expression()
            self.expect_op(")")
            return t.Extract(field, value)
        if self.at_keyword("EXISTS") and self.peek(1).text == "(":
            self.next()
            self.expect_op("(")
            query = self.query()
            self.expect_op(")")
            return t.ExistsPredicate(t.SubqueryExpression(query))
        if self.at_keyword("CURRENT_DATE"):
            self.next()
            return t.CurrentTime("DATE")
        if self.at_keyword("CURRENT_TIMESTAMP", "LOCALTIMESTAMP"):
            self.next()
            return t.CurrentTime("TIMESTAMP")
        if self.at_keyword("ARRAY") and self.peek(1).text == "[":
            self.next()
            self.expect_op("[")
            items = [] if self.at_op("]") else self.expression_list()
            self.expect_op("]")
            return t.FunctionCall(t.QualifiedName(("array_ctor",)),
                                  tuple(items))
        if self.at_keyword("ROW") and self.peek(1).text == "(":
            self.next()
            self.expect_op("(")
            items = self.expression_list()
            self.expect_op(")")
            return t.Row(tuple(items))
        if self.at_keyword("GROUPING") and self.peek(1).text == "(":
            self.next()
            self.expect_op("(")
            args = self.expression_list()
            self.expect_op(")")
            return t.FunctionCall(t.QualifiedName(("grouping",)), tuple(args))
        if self.accept_op("("):
            if self.at_keyword("SELECT", "WITH"):
                query = self.query()
                self.expect_op(")")
                return t.SubqueryExpression(query)
            exprs = self.expression_list()
            self.expect_op(")")
            if len(exprs) == 1:
                return exprs[0]
            return t.Row(tuple(exprs))
        if tok.kind in ("IDENT", "QIDENT") or (
                tok.kind == "KEYWORD" and tok.upper not in (
                    "SELECT", "FROM", "WHERE", "AND", "OR", "ON")):
            return self.name_or_call()
        self.error("expected expression")

    def interval(self) -> t.IntervalLiteral:
        self.expect_keyword("INTERVAL")
        sign = 1
        if self.accept_op("-"):
            sign = -1
        elif self.accept_op("+"):
            pass
        value = self.next().text  # STRING
        unit = self.next().upper
        end_unit = None
        if self.accept_keyword("TO"):
            end_unit = self.next().upper
        return t.IntervalLiteral(value, unit, sign, end_unit)

    def case_expression(self) -> t.Expression:
        self.expect_keyword("CASE")
        operand = None
        if not self.at_keyword("WHEN"):
            operand = self.expression()
        whens = []
        while self.accept_keyword("WHEN"):
            cond = self.expression()
            self.expect_keyword("THEN")
            whens.append(t.WhenClause(cond, self.expression()))
        default = None
        if self.accept_keyword("ELSE"):
            default = self.expression()
        self.expect_keyword("END")
        if operand is None:
            return t.SearchedCaseExpression(tuple(whens), default)
        return t.SimpleCaseExpression(operand, tuple(whens), default)

    def name_or_call(self) -> t.Expression:
        name = self.qualified_name()
        lname = name.suffix.lower()
        if not self.at_op("("):
            if len(name.parts) == 1:
                return t.Identifier(name.parts[0])
            base: t.Expression = t.Identifier(name.parts[0])
            for part in name.parts[1:]:
                base = t.DereferenceExpression(base, t.Identifier(part))
            return base
        self.expect_op("(")
        if lname in ("coalesce",):
            args = self.expression_list()
            self.expect_op(")")
            return t.CoalesceExpression(tuple(args))
        if lname == "nullif":
            first = self.expression()
            self.expect_op(",")
            second = self.expression()
            self.expect_op(")")
            return t.NullIfExpression(first, second)
        if lname == "if":
            args = self.expression_list()
            self.expect_op(")")
            if len(args) == 2:
                return t.IfExpression(args[0], args[1])
            if len(args) == 3:
                return t.IfExpression(args[0], args[1], args[2])
            self.error(f"if() takes 2 or 3 arguments, got {len(args)}")
        distinct = False
        args: Tuple[t.Expression, ...] = ()
        if self.at_op("*"):
            self.next()
        elif not self.at_op(")"):
            if self.accept_keyword("DISTINCT"):
                distinct = True
            else:
                self.accept_keyword("ALL")
            args = tuple(self.expression_list())
        self.expect_op(")")
        filter_ = None
        if self.at_keyword("FILTER") and self.peek(1).text == "(":
            self.next()
            self.expect_op("(")
            self.expect_keyword("WHERE")
            filter_ = self.expression()
            self.expect_op(")")
        window = None
        if self.at_keyword("OVER"):
            self.next()
            window = self.window_spec()
        return t.FunctionCall(name, args, distinct, filter_, window)

    def window_spec(self) -> t.Window:
        self.expect_op("(")
        partition_by: Tuple[t.Expression, ...] = ()
        if self.accept_keyword("PARTITION"):
            self.expect_keyword("BY")
            partition_by = tuple(self.expression_list())
        order_by: Tuple[t.SortItem, ...] = ()
        if self.accept_keyword("ORDER"):
            self.expect_keyword("BY")
            order_by = self.sort_items()
        frame = None
        if self.at_keyword("RANGE", "ROWS", "GROUPS"):
            frame_type = self.next().upper
            if self.accept_keyword("BETWEEN"):
                start_type, start_value = self.frame_bound()
                self.expect_keyword("AND")
                end_type, end_value = self.frame_bound()
            else:
                start_type, start_value = self.frame_bound()
                end_type, end_value = None, None
            frame = t.WindowFrame(frame_type, start_type, start_value,
                                  end_type, end_value)
        self.expect_op(")")
        return t.Window(partition_by, order_by, frame)

    def frame_bound(self):
        if self.accept_keyword("UNBOUNDED"):
            if self.accept_keyword("PRECEDING"):
                return "UNBOUNDED_PRECEDING", None
            self.expect_keyword("FOLLOWING")
            return "UNBOUNDED_FOLLOWING", None
        if self.accept_keyword("CURRENT"):
            self.expect_keyword("ROW")
            return "CURRENT_ROW", None
        value = self.expression()
        if self.accept_keyword("PRECEDING"):
            return "PRECEDING", value
        self.expect_keyword("FOLLOWING")
        return "FOLLOWING", value


def parse_statement(sql: str) -> t.Statement:
    parser = _Parser(tokenize(sql))
    stmt = parser.statement()
    parser.accept_op(";")
    if parser.peek().kind != "EOF":
        parser.error("unexpected trailing input")
    return stmt


def parse_expression(sql: str) -> t.Expression:
    parser = _Parser(tokenize(sql))
    expr = parser.expression()
    if parser.peek().kind != "EOF":
        parser.error("unexpected trailing input")
    return expr
