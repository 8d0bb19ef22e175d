"""Filter expression language: tokenizer + recursive-descent parser + evaluator.

Implements the reference's filter grammar subset (`src/db/sqlengine/antlr/
SQLParser.g4`: relation_expr with = != <> < > <= >=, LIKE, [NOT] IN,
[NOT] CONTAIN_ALL/CONTAIN_ANY, IS [NOT] NULL, AND/OR, parens, and
function calls like array_length(field)) without ANTLR: a hand-rolled parser
producing an AST that evaluates to a dense numpy bool mask per segment — the
mask that gets fused into the device distance kernel.
"""

from __future__ import annotations

import re
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from ...model.schema import CollectionSchema
from ...typing.enum import DataType

__all__ = ["compile_filter", "compile_value_expression", "FilterError", "CompiledFilter"]


class FilterError(ValueError):
    pass


# ---------------- tokenizer ----------------
_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<float>[-+]?\d+\.\d*(?:[eE][-+]?\d+)?|[-+]?\d+[eE][-+]?\d+)
  | (?P<int>[-+]?\d+)
  | (?P<str>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
  | (?P<op><=|>=|!=|<>|==|=|<|>|\(|\)|,|\+|\-|\*|/)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
""",
    re.VERBOSE,
)

_KEYWORDS = {
    "AND",
    "OR",
    "NOT",
    "IN",
    "LIKE",
    "IS",
    "NULL",
    "TRUE",
    "FALSE",
    "CONTAIN_ALL",
    "CONTAIN_ANY",
    "HAS_PREFIX",
    "HAS_SUFFIX",
}


class _Token:
    __slots__ = ("kind", "value")

    def __init__(self, kind: str, value: Any):
        self.kind = kind  # 'num' | 'str' | 'op' | 'ident' | 'kw' | 'eof'
        self.value = value

    def __repr__(self):
        return f"{self.kind}:{self.value!r}"


def _tokenize(text: str) -> List[_Token]:
    out: List[_Token] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise FilterError(f"filter syntax error at offset {pos}: {text[pos:pos+20]!r}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        if m.lastgroup == "float":
            out.append(_Token("num", float(m.group())))
        elif m.lastgroup == "int":
            out.append(_Token("num", int(m.group())))
        elif m.lastgroup == "str":
            raw = m.group()
            body = raw[1:-1]
            body = re.sub(r"\\(.)", r"\1", body)
            out.append(_Token("str", body))
        elif m.lastgroup == "op":
            out.append(_Token("op", m.group()))
        else:
            ident = m.group()
            if ident.upper() in _KEYWORDS:
                out.append(_Token("kw", ident.upper()))
            else:
                out.append(_Token("ident", ident))
    out.append(_Token("eof", None))
    return out


# ---------------- AST ----------------
class Node:
    def evaluate(self, ctx: "_EvalContext") -> np.ndarray:
        raise NotImplementedError

    def fields(self) -> set:
        raise NotImplementedError


class AndNode(Node):
    def __init__(self, left: Node, right: Node):
        self.left, self.right = left, right

    def evaluate(self, ctx):
        return self.left.evaluate(ctx) & self.right.evaluate(ctx)

    def fields(self):
        return self.left.fields() | self.right.fields()


class OrNode(Node):
    def __init__(self, left: Node, right: Node):
        self.left, self.right = left, right

    def evaluate(self, ctx):
        return self.left.evaluate(ctx) | self.right.evaluate(ctx)

    def fields(self):
        return self.left.fields() | self.right.fields()


class NotNode(Node):
    def __init__(self, child: Node):
        self.child = child

    def evaluate(self, ctx):
        return ~self.child.evaluate(ctx)

    def fields(self):
        return self.child.fields()


class RelNode(Node):
    """field (or function(field)) OP constant."""

    def __init__(self, field: str, op: str, value: Any, func: Optional[str] = None):
        self.field, self.op, self.value, self.func = field, op, value, func

    def fields(self):
        return {self.field}

    def evaluate(self, ctx: "_EvalContext") -> np.ndarray:
        # Prefer the inverted index when present; demote to a forward scan if
        # the predicate matches more than invert_to_forward_scan_ratio of the
        # rows (reference `InvertCondOptimizer.ratio_rule`, `optimizer.cc:66-95`).
        if self.func is None and self.op not in ("IS_NULL", "IS_NOT_NULL"):
            inv = ctx.inverted(self.field)
            if inv is not None and inv.supports(self.op):
                try:
                    from ...utils.config import GlobalConfig

                    ratio = inv.evaluate_ratio(self.op, self.value)
                    if ratio <= GlobalConfig.instance().invert_to_forward_scan_ratio:
                        return inv.mask(self.op, self.value)
                except (KeyError, TypeError, ValueError):
                    pass

        fast = self._arrow_eval(ctx)
        if fast is not None:
            return fast

        if self.func == "array_length":
            col = ctx.column(self.field)
            lengths = np.fromiter(
                (len(v) if v is not None else -1 for v in col),
                dtype=np.int64,
                count=len(col),
            )
            return _compare(lengths, self.op, self.value) & (lengths >= 0)

        if self.op in ("IS_NULL", "IS_NOT_NULL"):
            nulls = ctx.null_mask(self.field)
            return nulls if self.op == "IS_NULL" else ~nulls

        if self.op in ("IN", "NOT_IN"):
            col = ctx.column(self.field)
            mask = np.zeros(len(col), dtype=bool)
            values = set(self.value)
            if isinstance(col, np.ndarray) and col.dtype != object:
                for v in values:
                    try:
                        mask |= col == v
                    except (TypeError, ValueError):
                        pass
            else:
                mask = np.fromiter(
                    (v in values for v in col), dtype=bool, count=len(col)
                )
            mask &= ~ctx.null_mask(self.field)
            return mask if self.op == "IN" else ~mask & ~ctx.null_mask(self.field)

        if self.op in ("LIKE", "NOT_LIKE"):
            col = ctx.column(self.field)
            pattern = _like_to_regex(self.value)
            mask = np.fromiter(
                (
                    v is not None and isinstance(v, str) and pattern.match(v) is not None
                    for v in col
                ),
                dtype=bool,
                count=len(col),
            )
            return mask if self.op == "LIKE" else ~mask & ~ctx.null_mask(self.field)

        if self.op in ("HAS_PREFIX", "HAS_SUFFIX", "NOT_HAS_PREFIX", "NOT_HAS_SUFFIX"):
            # reference CompareOp::HAS_PREFIX/HAS_SUFFIX (`type.h:107-108`,
            # served by `inverted_column_indexer_search.cc:797-803`)
            col = ctx.column(self.field)
            probe = (
                (lambda v: v.startswith(self.value))
                if "PREFIX" in self.op
                else (lambda v: v.endswith(self.value))
            )
            mask = np.fromiter(
                (v is not None and isinstance(v, str) and probe(v) for v in col),
                dtype=bool,
                count=len(col),
            )
            if self.op.startswith("NOT_"):
                return ~mask & ~ctx.null_mask(self.field)
            return mask

        if self.op in ("CONTAIN_ALL", "CONTAIN_ANY", "NOT_CONTAIN_ALL", "NOT_CONTAIN_ANY"):
            col = ctx.column(self.field)
            values = list(self.value)

            def hit(v):
                if v is None:
                    return False
                s = set(v)
                if "ALL" in self.op:
                    return all(x in s for x in values)
                return any(x in s for x in values)

            mask = np.fromiter((hit(v) for v in col), dtype=bool, count=len(col))
            if self.op.startswith("NOT_"):
                return ~mask & ~ctx.null_mask(self.field)
            return mask

        # plain comparison
        col = ctx.column(self.field)
        nulls = ctx.null_mask(self.field)
        return _compare(col, self.op, self.value) & ~nulls

    # ---- pyarrow.compute fast paths (sealed segments) ----

    _PC_CMP = {"=": "equal", "!=": "not_equal", "<": "less",
               "<=": "less_equal", ">": "greater", ">=": "greater_equal"}

    def _arrow_eval(self, ctx) -> Optional[np.ndarray]:
        """Vectorized evaluation over the sealed segment's Arrow column
        (C++ kernels; a 10M-row LIKE drops from seconds of Python to ms).
        Returns None when not applicable — caller falls back to numpy."""
        arr = ctx.arrow_column(self.field)
        if arr is None:
            return None
        import pyarrow as pa
        import pyarrow.compute as pc

        try:
            op = self.op
            if self.func == "array_length" and pa.types.is_list(arr.type):
                lengths = pc.fill_null(pc.list_value_length(arr), -1)
                ln = np.asarray(lengths.to_numpy(zero_copy_only=False))
                return _compare(ln, op, self.value) & (ln >= 0)
            if self.func is not None:
                return None
            if op in ("LIKE", "NOT_LIKE") and pa.types.is_string(arr.type):
                if "\\" in self.value:
                    return None  # numpy path treats backslash literally
                m = pc.match_like(arr, self.value)
            elif op in ("HAS_PREFIX", "NOT_HAS_PREFIX") and pa.types.is_string(arr.type):
                m = pc.starts_with(arr, pattern=self.value)
            elif op in ("HAS_SUFFIX", "NOT_HAS_SUFFIX") and pa.types.is_string(arr.type):
                m = pc.ends_with(arr, pattern=self.value)
            elif op in ("IN", "NOT_IN") and not pa.types.is_list(arr.type):
                m = pc.is_in(arr, value_set=pa.array(list(self.value)))
            elif op in self._PC_CMP and not pa.types.is_list(arr.type) and not pa.types.is_binary(arr.type):
                m = getattr(pc, self._PC_CMP[op])(arr, self.value)
            elif (
                op in ("CONTAIN_ALL", "CONTAIN_ANY", "NOT_CONTAIN_ALL", "NOT_CONTAIN_ANY")
                and pa.types.is_list(arr.type)
            ):
                return self._arrow_contains(ctx, arr, pa, pc)
            else:
                return None
            mask = np.asarray(
                pc.fill_null(m, False).to_numpy(zero_copy_only=False), dtype=bool
            )
        except (pa.ArrowInvalid, pa.ArrowNotImplementedError, pa.ArrowTypeError,
                TypeError, ValueError):
            return None
        if op.startswith("NOT_") or op == "!=":
            if op != "!=":
                mask = ~mask
            return mask & ~ctx.null_mask(self.field)
        return mask

    def _arrow_contains(self, ctx, arr, pa, pc) -> np.ndarray:
        n = len(arr)
        flat = pc.list_flatten(arr)
        parents = np.asarray(
            pc.list_parent_indices(arr).to_numpy(zero_copy_only=False)
        )
        values = list(self.value)
        if "ANY" in self.op:
            hit = pc.fill_null(pc.is_in(flat, value_set=pa.array(values)), False)
            hit = np.asarray(hit.to_numpy(zero_copy_only=False), dtype=bool)
            mask = np.zeros(n, dtype=bool)
            np.logical_or.at(mask, parents[hit], True)
        else:
            mask = np.ones(n, dtype=bool)
            for v in values:
                hv = pc.fill_null(pc.equal(flat, v), False)
                hv = np.asarray(hv.to_numpy(zero_copy_only=False), dtype=bool)
                rowv = np.zeros(n, dtype=bool)
                np.logical_or.at(rowv, parents[hv], True)
                mask &= rowv
            mask &= ~ctx.null_mask(self.field)
        if self.op.startswith("NOT_"):
            return ~mask & ~ctx.null_mask(self.field)
        return mask


def _compare(col, op: str, value) -> np.ndarray:
    if isinstance(col, np.ndarray) and col.dtype == object:
        ops = {
            "=": lambda a: a == value,
            "!=": lambda a: a != value,
            "<": lambda a: a is not None and a < value,
            "<=": lambda a: a is not None and a <= value,
            ">": lambda a: a is not None and a > value,
            ">=": lambda a: a is not None and a >= value,
        }
        fn = ops[op]

        def safe(a):
            try:
                return bool(fn(a)) if a is not None else False
            except TypeError:
                return False

        return np.fromiter((safe(v) for v in col), dtype=bool, count=len(col))
    try:
        with np.errstate(invalid="ignore"):
            if op == "=":
                return np.asarray(col == value)
            if op == "!=":
                return np.asarray(col != value)
            if op == "<":
                return np.asarray(col < value)
            if op == "<=":
                return np.asarray(col <= value)
            if op == ">":
                return np.asarray(col > value)
            if op == ">=":
                return np.asarray(col >= value)
    except (TypeError, ValueError):
        return np.zeros(len(col), dtype=bool)
    raise FilterError(f"unknown comparison operator {op}")


def _like_to_regex(pattern: str) -> "re.Pattern":
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


# ---------------- parser ----------------
class _Parser:
    def __init__(self, tokens: List[_Token], schema: Optional[CollectionSchema]):
        self.tokens = tokens
        self.pos = 0
        self.schema = schema

    def peek(self) -> _Token:
        return self.tokens[self.pos]

    def next(self) -> _Token:
        t = self.tokens[self.pos]
        self.pos += 1
        return t

    def expect_op(self, op: str) -> None:
        t = self.next()
        if t.kind != "op" or t.value != op:
            raise FilterError(f"expected '{op}', got {t.value!r}")

    def parse(self) -> Node:
        node = self.parse_or()
        if self.peek().kind != "eof":
            raise FilterError(f"unexpected trailing input: {self.peek().value!r}")
        return node

    def parse_or(self) -> Node:
        node = self.parse_and()
        while self.peek().kind == "kw" and self.peek().value == "OR":
            self.next()
            node = OrNode(node, self.parse_and())
        return node

    def parse_and(self) -> Node:
        node = self.parse_unary()
        while self.peek().kind == "kw" and self.peek().value == "AND":
            self.next()
            node = AndNode(node, self.parse_unary())
        return node

    def parse_unary(self) -> Node:
        t = self.peek()
        if t.kind == "kw" and t.value == "NOT":
            self.next()
            return NotNode(self.parse_unary())
        if t.kind == "op" and t.value == "(":
            self.next()
            node = self.parse_or()
            self.expect_op(")")
            return node
        return self.parse_relation()

    def parse_relation(self) -> Node:
        t = self.next()
        if t.kind != "ident":
            raise FilterError(f"expected field name, got {t.value!r}")
        name = t.value

        # function call: array_length(field)
        func = None
        if self.peek().kind == "op" and self.peek().value == "(":
            func = name.lower()
            if func != "array_length":
                raise FilterError(f"unknown function '{name}'")
            self.next()
            arg = self.next()
            if arg.kind != "ident":
                raise FilterError("array_length() expects a field name")
            self.expect_op(")")
            name = arg.value

        self._check_field(name, func)

        t = self.peek()
        if t.kind == "op" and t.value in ("=", "==", "!=", "<>", "<", "<=", ">", ">="):
            self.next()
            op = {"==": "=", "<>": "!="}.get(t.value, t.value)
            value = self.parse_constant()
            return RelNode(name, op, value, func)
        if t.kind == "kw":
            negate = False
            if t.value == "NOT":
                self.next()
                negate = True
                t = self.peek()
            if t.kind == "kw" and t.value == "LIKE":
                self.next()
                value = self.parse_constant()
                if not isinstance(value, str):
                    raise FilterError("LIKE expects a string pattern")
                return RelNode(name, "NOT_LIKE" if negate else "LIKE", value, func)
            if t.kind == "kw" and t.value == "IN":
                self.next()
                values = self.parse_value_list()
                return RelNode(name, "NOT_IN" if negate else "IN", values, func)
            if t.kind == "kw" and t.value in ("CONTAIN_ALL", "CONTAIN_ANY"):
                kw = t.value
                self.next()
                values = self.parse_value_list()
                return RelNode(name, ("NOT_" if negate else "") + kw, values, func)
            if t.kind == "kw" and t.value in ("HAS_PREFIX", "HAS_SUFFIX"):
                kw = t.value
                self.next()
                value = self.parse_constant()
                if not isinstance(value, str):
                    raise FilterError(f"{kw} expects a string constant")
                return RelNode(name, ("NOT_" if negate else "") + kw, value, func)
            if t.kind == "kw" and t.value == "IS":
                if negate:
                    raise FilterError("unexpected NOT before IS")
                self.next()
                not_null = False
                if self.peek().kind == "kw" and self.peek().value == "NOT":
                    self.next()
                    not_null = True
                t2 = self.next()
                if t2.kind != "kw" or t2.value != "NULL":
                    raise FilterError("expected NULL after IS")
                return RelNode(name, "IS_NOT_NULL" if not_null else "IS_NULL", None, func)
        raise FilterError(f"expected operator after field '{name}'")

    def parse_constant(self):
        t = self.next()
        if t.kind == "num":
            return t.value
        if t.kind == "str":
            return t.value
        if t.kind == "kw" and t.value in ("TRUE", "FALSE"):
            return t.value == "TRUE"
        raise FilterError(f"expected constant, got {t.value!r}")

    def parse_value_list(self) -> List[Any]:
        self.expect_op("(")
        values = []
        if not (self.peek().kind == "op" and self.peek().value == ")"):
            values.append(self.parse_constant())
            while self.peek().kind == "op" and self.peek().value == ",":
                self.next()
                values.append(self.parse_constant())
        self.expect_op(")")
        return values

    def _check_field(self, name: str, func: Optional[str]) -> None:
        if self.schema is None:
            return
        fs = self.schema.field(name)
        if fs is None:
            raise FilterError(f"unknown field '{name}' in filter")
        if func == "array_length" and not fs.data_type.is_array:
            raise FilterError(f"array_length() expects an array field, got '{name}'")


# ---------------- evaluation ----------------
class _EvalContext:
    def __init__(self, segment):
        self.segment = segment
        self._columns = {}
        self._nulls = {}
        self._arrow = {}

    def column(self, name: str):
        if name not in self._columns:
            self._columns[name] = self.segment.store.scalar_column(name)
        return self._columns[name]

    def arrow_column(self, name: str):
        """Sealed segments expose the raw Arrow column so string/array
        predicates run through pyarrow.compute C++ kernels instead of
        per-row Python (the Acero-expression role, `sqlengine` §2.4).
        Returns None for writing segments (small, python-list-backed)."""
        if name not in self._arrow:
            col = None
            store = self.segment.store
            tbl = getattr(store, "_table", None)
            if tbl is not None and not store._writable and name in tbl.column_names:
                col = tbl.column(name).combine_chunks()
            self._arrow[name] = col
        return self._arrow[name]

    def null_mask(self, name: str) -> np.ndarray:
        if name not in self._nulls:
            self._nulls[name] = self.segment.store.null_mask(name)
        return self._nulls[name]

    def inverted(self, name: str):
        getter = getattr(self.segment, "inverted_index", None)
        return getter(name) if getter else None


class CompiledFilter:
    def __init__(self, text: str, root: Node):
        self.text = text
        self.root = root

    def evaluate(self, segment) -> np.ndarray:
        """Dense bool mask (True = passes filter) over a segment's rows."""
        if segment.doc_count == 0:
            return np.zeros(0, dtype=bool)
        mask = self.root.evaluate(_EvalContext(segment))
        return np.asarray(mask, dtype=bool)

    def fields(self) -> set:
        return self.root.fields()


_CACHE: dict = {}


def compile_filter(text: str, schema: Optional[CollectionSchema] = None) -> CompiledFilter:
    key = (text, id(schema))
    cached = _CACHE.get(key)
    if cached is not None:
        return cached
    root = _Parser(_tokenize(text), schema).parse()
    compiled = CompiledFilter(text, root)
    if len(_CACHE) > 1024:
        _CACHE.clear()
    _CACHE[key] = compiled
    return compiled


# ---------------- value expressions (add_column) ----------------
def compile_value_expression(
    text: str, schema: CollectionSchema
) -> Callable[[Any], Sequence[Any]]:
    """Compile an add_column expression (constant, arithmetic over numeric
    fields, or `CASE WHEN <cond> THEN <expr> ... [ELSE <expr>] END`,
    reference `src/db/index/segment/sql_expr_parser.cc`) into a
    function(segment) -> column values.

    CASE keywords are recognized contextually (idents spelled CASE / WHEN /
    THEN / ELSE / END, case-insensitive) so filter expressions on fields
    with those names keep working; a field literally named `case` cannot be
    referenced inside a value expression."""
    tokens = _tokenize(text)

    _CMP = {
        "=": np.equal,
        "==": np.equal,
        "!=": np.not_equal,
        "<>": np.not_equal,
        "<": np.less,
        "<=": np.less_equal,
        ">": np.greater,
        ">=": np.greater_equal,
    }

    def word(pos, w):
        t = tokens[pos]
        return t.kind == "ident" and t.value.upper() == w

    def parse_expr(pos):
        def parse_term(pos):
            def parse_factor(pos):
                t = tokens[pos]
                if t.kind == "num":
                    return (lambda ctx: t.value), pos + 1
                if t.kind == "str":
                    return (lambda ctx: t.value), pos + 1
                if t.kind == "kw" and t.value in ("TRUE", "FALSE"):
                    return (lambda ctx: t.value == "TRUE"), pos + 1
                if word(pos, "CASE"):
                    return parse_case(pos + 1)
                if t.kind == "ident":
                    name = t.value
                    if schema.field(name) is None:
                        raise FilterError(f"unknown field '{name}' in expression")
                    return (lambda ctx: ctx.column(name)), pos + 1
                if t.kind == "op" and t.value == "(":
                    fn, pos = parse_expr(pos + 1)
                    if tokens[pos].kind != "op" or tokens[pos].value != ")":
                        raise FilterError("expected ')'")
                    return fn, pos + 1
                raise FilterError(f"unexpected token {t.value!r} in expression")

            fn, pos = parse_factor(pos)
            while tokens[pos].kind == "op" and tokens[pos].value in ("*", "/"):
                op = tokens[pos].value
                rhs, pos = parse_factor(pos + 1)
                lhs = fn
                if op == "*":
                    fn = lambda ctx, lhs=lhs, rhs=rhs: np.multiply(lhs(ctx), rhs(ctx))
                else:
                    fn = lambda ctx, lhs=lhs, rhs=rhs: np.divide(lhs(ctx), rhs(ctx))
            return fn, pos

        fn, pos = parse_term(pos)
        while tokens[pos].kind == "op" and tokens[pos].value in ("+", "-"):
            op = tokens[pos].value
            rhs, pos = parse_term(pos + 1)
            lhs = fn
            if op == "+":
                fn = lambda ctx, lhs=lhs, rhs=rhs: np.add(lhs(ctx), rhs(ctx))
            else:
                fn = lambda ctx, lhs=lhs, rhs=rhs: np.subtract(lhs(ctx), rhs(ctx))
        return fn, pos

    def parse_condition(pos):
        # <expr> cmp <expr> [AND|OR ...] — left-associative, no precedence
        # (matches the reference sql_expr_parser's flat condition chains)
        def nullsafe(x):
            # writing-segment nullable numeric columns are object dtype with
            # None holes; convert to float (None -> NaN) so compares run
            # vectorized. String object columns stay object — their None
            # holes are masked out in cmp_nonnull below.
            x = np.asarray(x)
            if x.dtype == object and x.ndim == 1 and any(v is None for v in x):
                try:
                    return np.array(
                        [np.nan if v is None else float(v) for v in x], dtype=float
                    )
                except (TypeError, ValueError):
                    pass
            return x

        def null_mask(x):
            if x.dtype == object:
                return np.fromiter(
                    (v is None for v in x.flat), dtype=bool, count=x.size
                ).reshape(x.shape)
            if np.issubdtype(x.dtype, np.floating):
                return np.isnan(x)
            return np.zeros(x.shape, dtype=bool)

        def cmp_nonnull(f, l, r):
            # NULL fails EVERY predicate — including != and = (the filter
            # path likewise ANDs ~nulls into every CompareOp's mask). The
            # comparison itself runs only over non-null rows, so ordered
            # compares on string columns with None holes cannot crash.
            l, r = nullsafe(l), nullsafe(r)
            nulls = null_mask(l) | null_mask(r)
            shape = np.broadcast_shapes(l.shape, r.shape)
            out = np.zeros(shape, dtype=bool)
            ok = ~np.broadcast_to(nulls, shape)
            if ok.any():
                lv = np.broadcast_to(l, shape)[ok]
                rv = np.broadcast_to(r, shape)[ok]
                out[ok] = f(lv, rv)
            return out

        def parse_cmp(pos):
            lhs, pos = parse_expr(pos)
            t = tokens[pos]
            if t.kind != "op" or t.value not in _CMP:
                raise FilterError("expected comparison in CASE WHEN condition")
            f = _CMP[t.value]
            rhs, pos = parse_expr(pos + 1)
            return (
                lambda ctx, l=lhs, r=rhs, f=f: cmp_nonnull(f, l(ctx), r(ctx))
            ), pos

        fn, pos = parse_cmp(pos)
        while tokens[pos].kind == "kw" and tokens[pos].value in ("AND", "OR"):
            comb = np.logical_and if tokens[pos].value == "AND" else np.logical_or
            rhs, pos = parse_cmp(pos + 1)
            lhs = fn
            fn = lambda ctx, l=lhs, r=rhs, c=comb: c(l(ctx), r(ctx))
        return fn, pos

    def parse_case(pos):
        branches = []
        while word(pos, "WHEN"):
            cond, pos = parse_condition(pos + 1)
            if not word(pos, "THEN"):
                raise FilterError("expected THEN in CASE expression")
            val, pos = parse_expr(pos + 1)
            branches.append((cond, val))
        if not branches:
            raise FilterError("CASE requires at least one WHEN clause")
        else_fn = None
        if word(pos, "ELSE"):
            else_fn, pos = parse_expr(pos + 1)
        if not word(pos, "END"):
            raise FilterError("expected END closing CASE expression")

        def case_fn(ctx, branches=branches, else_fn=else_fn):
            n = ctx.segment.store.count

            def as_col(x):
                a = np.empty(n, dtype=object)
                a[:] = x  # broadcasts scalars, copies length-n arrays
                return a

            # SQL CASE: first matching WHEN wins; no ELSE -> NULL
            res = as_col(else_fn(ctx)) if else_fn is not None else as_col(None)
            chosen = np.zeros(n, dtype=bool)
            for cond, val in branches:
                c = np.broadcast_to(np.asarray(cond(ctx), dtype=bool), (n,))
                take = c & ~chosen
                if take.any():
                    res[take] = as_col(val(ctx))[take]
                chosen |= c
            return res

        return case_fn, pos + 1

    fn, pos = parse_expr(0)
    if tokens[pos].kind != "eof":
        raise FilterError(f"unexpected trailing input in expression")

    def run(segment):
        ctx = _EvalContext(segment)
        result = fn(ctx)
        n = segment.store.count
        if np.isscalar(result) or not hasattr(result, "__len__"):
            return [result] * n
        return list(np.asarray(result))

    return run
