"""Safe vectorized predicate expressions over column batches.

The reference embeds SQL predicate strings into Catalyst expressions
(`Compliance`, reference `analyzers/Compliance.scala:37-53`; `where` filters
via `conditionalSelection`, `analyzers/Analyzer.scala:409-432`). Here
predicates are Python-syntax strings evaluated vectorized over numpy columns
with a whitelisted AST interpreter — no Spark, no eval().

Supported syntax::

    "att1 > 3"
    "att1 >= 2 and att2 < 10"          # elementwise and/or/not
    "att1 in ('a', 'b')"
    "att1 is not None"                  # null checks
    "notnull(att1) | (att2 == 0)"
    "length(att1) >= 3"
    "matches(att1, '^[A-Z]+$')"

Null semantics follow SQL-ish 3-valued logic collapsed to False: any
comparison against a null value yields False.
"""

from __future__ import annotations

import ast
import functools as _functools
import re
from typing import Callable, Dict, List, Tuple, Union

import numpy as np

Predicate = Union[str, Callable]


class DictColumn:
    """Lazy dictionary-encoded column operand: ``entries`` holds the
    DISTINCT values (object array with a trailing ``None`` sentinel for
    null/invalid rows) and ``codes`` indexes rows into it. Single-column
    ops against literals evaluate on the ENTRIES and gather by code —
    an `x in [...]` membership over 1M rows of a 40-category column costs
    one 41-element isin plus a gather instead of a 1M-row object hash pass.
    Anything the entry-level fast paths don't cover materializes via
    ``to_object`` (cached) and takes the ordinary numpy path."""

    __slots__ = ("entries", "codes", "_obj")

    def __init__(self, entries: np.ndarray, codes: np.ndarray):
        self.entries = entries  # object[num_entries + 1], [-1] is None
        self.codes = codes  # int32[rows], sentinel = len(entries) - 1
        self._obj = None

    def gather(self, per_entry: np.ndarray) -> np.ndarray:
        return per_entry[self.codes]

    def to_object(self) -> np.ndarray:
        if self._obj is None:
            self._obj = self.entries[self.codes]
        return self._obj


def _materialize(x):
    return x.to_object() if isinstance(x, DictColumn) else x


def _is_literal(x) -> bool:
    if x is None or isinstance(x, (str, bytes, bool, int, float, np.generic)):
        return True
    if isinstance(x, (list, tuple, set)):
        return all(_is_literal(v) for v in x)
    return False


class ExpressionError(ValueError):
    pass


def _as_bool(x) -> np.ndarray:
    if isinstance(x, DictColumn):
        x = x.to_object()
    arr = np.asarray(x)
    if arr.dtype == bool:
        return arr
    if arr.dtype == object:
        return np.array([bool(v) if v is not None else False for v in arr], dtype=bool)
    if np.issubdtype(arr.dtype, np.floating):
        return np.nan_to_num(arr, nan=0.0) != 0
    return arr != 0


def _null_mask(x) -> np.ndarray:
    arr = np.asarray(x)
    if arr.dtype == object:
        return np.array([v is None for v in arr], dtype=bool)
    if np.issubdtype(arr.dtype, np.floating):
        return np.isnan(arr)
    return np.zeros(arr.shape, dtype=bool)


_FUNCTIONS: Dict[str, Callable] = {
    "abs": np.abs,
    "length": lambda x: np.array(
        [len(v) if v is not None else np.nan for v in np.asarray(x, dtype=object)],
        dtype=np.float64,  # NaN at nulls so comparisons yield False
    ),
    "isnull": _null_mask,
    "notnull": lambda x: ~_null_mask(x),
    "startswith": lambda x, p: np.array(
        [v.startswith(p) if isinstance(v, str) else False for v in np.asarray(x, dtype=object)]
    ),
    "endswith": lambda x, p: np.array(
        [v.endswith(p) if isinstance(v, str) else False for v in np.asarray(x, dtype=object)]
    ),
    "contains": lambda x, p: np.array(
        [p in v if isinstance(v, str) else False for v in np.asarray(x, dtype=object)]
    ),
    "matches": lambda x, p: np.array(
        [bool(re.search(p, v)) if isinstance(v, str) else False for v in np.asarray(x, dtype=object)]
    ),
    "floor": np.floor,
    "ceil": np.ceil,
    "sqrt": np.sqrt,
    # SQL COALESCE(col, default): nulls (None / NaN) replaced by the
    # default — the form the reference's isNonNegative/isPositive emit
    # (`checks/Check.scala:734,751`)
    "coalesce": lambda x, v: np.where(_null_mask(x), v, np.asarray(x)),
}

def _neq(a, b) -> np.ndarray:
    # null on either side -> False (3-valued logic collapsed), like NotIn
    a_arr, b_arr = np.asarray(a), np.asarray(b)
    # implicit-cast path: uncastable strings behave as null (False), same
    # as the == / < / > coercion
    if a_arr.dtype == object and b_arr.shape == () and _is_number(b_arr.item()):
        c = _coerce_object_numeric(a_arr)
        with np.errstate(invalid="ignore"):
            return np.not_equal(c, b_arr) & ~np.isnan(c)
    if b_arr.dtype == object and a_arr.shape == () and _is_number(a_arr.item()):
        c = _coerce_object_numeric(b_arr)
        with np.errstate(invalid="ignore"):
            return np.not_equal(a_arr, c) & ~np.isnan(c)
    return ~_eq(a, b) & ~_null_mask(a) & ~_null_mask(b)


_CMP = {
    ast.Eq: lambda a, b: _eq(a, b),
    ast.NotEq: _neq,
    ast.Lt: lambda a, b: _num_cmp(a, b, np.less),
    ast.LtE: lambda a, b: _num_cmp(a, b, np.less_equal),
    ast.Gt: lambda a, b: _num_cmp(a, b, np.greater),
    ast.GtE: lambda a, b: _num_cmp(a, b, np.greater_equal),
}

_BIN = {
    ast.Add: np.add,
    ast.Sub: np.subtract,
    ast.Mult: np.multiply,
    ast.Div: np.divide,
    ast.Mod: np.mod,
    ast.Pow: np.power,
    ast.FloorDiv: np.floor_divide,
}


def _coerce_object_numeric(a_arr: np.ndarray):
    """SQL implicit cast of a string column for a numeric comparison:
    parse to float64, unparseable/null -> NaN (behaves as null)."""
    import pandas as pd

    return pd.to_numeric(pd.Series(a_arr), errors="coerce").to_numpy(dtype=np.float64)


def _is_number(x) -> bool:
    return isinstance(x, (int, float, np.integer, np.floating)) and not isinstance(x, bool)


def _eq(a, b) -> np.ndarray:
    a_arr, b_arr = np.asarray(a), np.asarray(b)
    # SQL implicit cast: object column vs numeric scalar ('5' = 5 holds)
    if a_arr.dtype == object and b_arr.shape == () and _is_number(b_arr.item()):
        with np.errstate(invalid="ignore"):
            return np.equal(_coerce_object_numeric(a_arr), b_arr)
    if b_arr.dtype == object and a_arr.shape == () and _is_number(a_arr.item()):
        with np.errstate(invalid="ignore"):
            return np.equal(a_arr, _coerce_object_numeric(b_arr))
    if a_arr.dtype == object or b_arr.dtype == object:
        out = a_arr == b_arr
        return _as_bool(out) & ~_null_mask(a) & ~_null_mask(b if b_arr.shape else a)
    with np.errstate(invalid="ignore"):
        return np.equal(a, b)


def _num_cmp(a, b, op) -> np.ndarray:
    a_arr, b_arr = np.asarray(a), np.asarray(b)
    # vectorized SQL implicit cast for object column vs numeric scalar
    if a_arr.dtype == object and b_arr.shape == () and _is_number(b_arr.item()):
        with np.errstate(invalid="ignore"):
            return op(_coerce_object_numeric(a_arr), b_arr)
    if b_arr.dtype == object and a_arr.shape == () and _is_number(a_arr.item()):
        with np.errstate(invalid="ignore"):
            return op(a_arr, _coerce_object_numeric(b_arr))
    if a_arr.dtype == object or b_arr.dtype == object:
        null = _null_mask(a_arr) | _null_mask(b_arr)
        a_f = np.where(null, None, a_arr) if a_arr.dtype == object else a_arr
        out = np.zeros(np.broadcast_shapes(a_arr.shape, np.shape(b_arr)), dtype=bool)
        a_b = np.broadcast_to(a_arr, out.shape)
        b_b = np.broadcast_to(b_arr, out.shape)
        for i in np.ndindex(out.shape):
            av, bv = a_b[i], b_b[i]
            if av is None or bv is None:
                continue
            try:
                out[i] = op(av, bv)
            except TypeError:
                # SQL implicit cast: string vs number comparison coerces the
                # string side ("5" >= 0 is true in Spark); uncastable
                # strings behave as null (False)
                try:
                    out[i] = op(float(av), float(bv))
                except (TypeError, ValueError):
                    pass
        return out
    with np.errstate(invalid="ignore"):
        return op(a, b)


class _Evaluator(ast.NodeVisitor):
    def __init__(self, columns: Dict[str, np.ndarray]):
        self.columns = columns

    def visit(self, node):  # noqa: D102
        method = "visit_" + node.__class__.__name__
        visitor = getattr(self, method, None)
        if visitor is None:
            raise ExpressionError(f"unsupported syntax: {node.__class__.__name__}")
        return visitor(node)

    def visit_Expression(self, node):
        return self.visit(node.body)

    def visit_Name(self, node):
        if node.id in self.columns:
            return self.columns[node.id]
        if node.id in ("None", "null"):
            return None
        raise ExpressionError(f"unknown column: {node.id}")

    def visit_Constant(self, node):
        return node.value

    def _one_compare(self, left, op, right) -> np.ndarray:
        # dictionary-encoded operand vs literal: evaluate on the DISTINCT
        # entries (incl. the None sentinel, which every path maps to False)
        # and gather per row — O(entries + rows) instead of per-row object
        # work
        if isinstance(left, DictColumn) and _is_literal(right):
            return left.gather(self._one_compare(left.entries, op, right))
        if isinstance(right, DictColumn) and _is_literal(left):
            return right.gather(self._one_compare(left, op, right.entries))
        left = _materialize(left)
        right = _materialize(right)
        if isinstance(op, (ast.In, ast.NotIn)):
            if isinstance(right, (str, int, float)) and not isinstance(right, bool):
                # `x in ('abc')`: Python collapses 1-element parens to a
                # scalar, but in the SQL dialect this is a 1-element IN
                # list (there is no substring-membership in this grammar)
                right = [right]
            if not isinstance(right, (list, tuple, set)):
                raise ExpressionError("`in` requires a literal list/tuple")
            left_arr = np.asarray(left)
            if left_arr.dtype == object:
                # np.isin on object dtype degrades to O(n*k) elementwise
                # comparison; pandas isin is one C hash pass (an
                # is_contained_in over 1M rows x 100 categories is 50x+
                # faster this way)
                import pandas as pd

                part = pd.Series(left_arr).isin(list(right)).to_numpy()
            else:
                part = np.isin(left_arr, list(right))
            if isinstance(op, ast.NotIn):
                part = ~part & ~_null_mask(left)
            return part
        if isinstance(op, (ast.Is, ast.IsNot)):
            if right is not None:
                raise ExpressionError("`is` only supports None")
            part = _null_mask(left)
            if isinstance(op, ast.IsNot):
                part = ~part
            return part
        return _CMP[type(op)](left, right)

    def visit_Compare(self, node):
        left = self.visit(node.left)
        result = None
        for op, comparator in zip(node.ops, node.comparators):
            right = self.visit(comparator)
            part = _as_bool(self._one_compare(left, op, right))
            result = part if result is None else (result & part)
            left = right
        return result

    def visit_BoolOp(self, node):
        parts = [_as_bool(self.visit(v)) for v in node.values]
        out = parts[0]
        for p in parts[1:]:
            out = (out & p) if isinstance(node.op, ast.And) else (out | p)
        return out

    def visit_UnaryOp(self, node):
        val = self.visit(node.operand)
        if isinstance(node.op, ast.Not):
            return ~_as_bool(val)
        if isinstance(node.op, ast.USub):
            return np.negative(val)
        if isinstance(node.op, ast.UAdd):
            return val
        raise ExpressionError("unsupported unary op")

    def visit_BinOp(self, node):
        op = _BIN.get(type(node.op))
        if op is None:
            raise ExpressionError("unsupported binary op")
        with np.errstate(invalid="ignore", divide="ignore"):
            return op(
                _materialize(self.visit(node.left)),
                _materialize(self.visit(node.right)),
            )

    def visit_Call(self, node):
        # case-insensitive lookup: SQL spellings (COALESCE, LENGTH) parse
        # as ordinary Python calls and must resolve too
        fn = None
        if isinstance(node.func, ast.Name):
            fn = _FUNCTIONS.get(node.func.id) or _FUNCTIONS.get(node.func.id.lower())
        if fn is None:
            raise ExpressionError("only whitelisted functions allowed")
        args = [self.visit(a) for a in node.args]
        if (
            args
            and isinstance(args[0], DictColumn)
            and all(_is_literal(a) for a in args[1:])
        ):
            # string functions (length/matches/startswith/...) evaluate per
            # DISTINCT entry and gather; the None sentinel flows through each
            # function's own null handling (NaN length, False matches)
            return args[0].gather(fn(args[0].entries, *args[1:]))
        return fn(*[_materialize(a) for a in args])

    def visit_Tuple(self, node):
        return tuple(self.visit(e) for e in node.elts)

    def visit_List(self, node):
        return [self.visit(e) for e in node.elts]


#: SQL keywords the translator maps to the Python grammar (case-insensitive)
_SQL_WORD_MAP = {"and": "and", "or": "or", "not": "not", "null": "None",
                 "true": "True", "false": "False"}


def _translate_sql_predicate(src: str) -> str:
    """Translate the Spark-SQL predicate subset the reference emits into
    the Python-syntax grammar: `=`/`<>` comparisons, AND/OR/NOT, IN
    lists, IS (NOT) NULL, backquoted identifiers, ''-escaped string
    literals, and SQL function names (reference `checks/Check.scala:
    786-799,734,751,913,942`; `examples/BasicExample.scala`). Keywords
    match case-insensitively, as Spark's parser does."""
    tokens: List[Tuple[str, str]] = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c.isspace():
            i += 1
        elif c in ("'", '"'):
            # Spark accepts single- OR double-quoted string literals, with
            # a doubled quote char as the escape
            q = c
            j, buf = i + 1, []
            while j < n:
                if src[j] == q:
                    if j + 1 < n and src[j + 1] == q:
                        buf.append(q)
                        j += 2
                        continue
                    break
                buf.append(src[j])
                j += 1
            if j >= n:
                raise ExpressionError(f"unterminated string literal in {src!r}")
            tokens.append(("str", "".join(buf)))
            i = j + 1
        elif c == "`":
            j = src.find("`", i + 1)
            if j < 0:
                raise ExpressionError(f"unterminated `identifier` in {src!r}")
            name = src[i + 1 : j]
            if not name.isidentifier():
                raise ExpressionError(
                    f"column name {name!r} is not expressible in predicates "
                    "(rename the column to a valid identifier)"
                )
            tokens.append(("name", name))
            i = j + 1
        elif c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            tokens.append(("word", src[i:j]))
            i = j
        elif c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            while j < n and (src[j].isdigit() or src[j] in ".eE" or (
                src[j] in "+-" and src[j - 1] in "eE"
            )):
                j += 1
            tokens.append(("num", src[i:j]))
            i = j
        elif src[i : i + 2] in ("<=", ">=", "!=", "=="):
            tokens.append(("op", src[i : i + 2]))
            i += 2
        elif src[i : i + 2] == "<>":
            tokens.append(("op", "!="))
            i += 2
        elif c == "=":
            tokens.append(("op", "=="))
            i += 1
        else:
            tokens.append(("op", c))
            i += 1

    out: List[str] = []
    k = 0
    while k < len(tokens):
        kind, text = tokens[k]
        low = text.lower() if kind == "word" else None
        if kind == "str":
            out.append(repr(text))
        elif kind == "name":
            out.append(text)
        elif kind == "word" and low == "is":
            # IS [NOT] NULL
            if k + 2 < len(tokens) and tokens[k + 1][1].lower() == "not" and tokens[k + 2][1].lower() == "null":
                out.append("is not None")
                k += 2
            elif k + 1 < len(tokens) and tokens[k + 1][1].lower() == "null":
                out.append("is None")
                k += 1
            else:
                raise ExpressionError(f"IS must be followed by [NOT] NULL in {src!r}")
        elif kind == "word" and low == "in":
            # IN ( a, b, ... ) -> in [a, b, ...] (a 1-element SQL list must
            # not become a Python scalar paren-expression)
            if k + 1 >= len(tokens) or tokens[k + 1][1] != "(":
                raise ExpressionError(f"IN must be followed by a value list in {src!r}")
            out.append("in [")
            depth = 1
            k += 1  # consume the opening paren
            closed = False
            while k + 1 < len(tokens):
                k += 1
                tk, tt = tokens[k]
                if tk == "op" and tt == "(":
                    depth += 1
                elif tk == "op" and tt == ")":
                    depth -= 1
                    if depth == 0:
                        out.append("]")
                        closed = True
                        break
                out.append(repr(tt) if tk == "str" else tt)
            if not closed:
                raise ExpressionError(f"unbalanced IN list in {src!r}")
        elif kind == "word" and low in _SQL_WORD_MAP:
            out.append(_SQL_WORD_MAP[low])
        elif (
            kind == "word"
            and low in _FUNCTIONS
            and k + 1 < len(tokens)
            and tokens[k + 1] == ("op", "(")
        ):
            # a whitelisted function name is only a function when CALLED;
            # Spark resolves a bare `Length`/`Matches` as a column identifier
            out.append(low)
        else:
            out.append(text)
        k += 1
    return " ".join(out)


@_functools.lru_cache(maxsize=512)
def _parse_predicate(src: str) -> ast.AST:
    """Predicates re-evaluate once per batch per pass; ast.parse is pure,
    so the parses cache (thread-safe via lru_cache). Strings that are not
    valid Python expressions get one shot through the Spark-SQL
    translator, so reference check definitions run verbatim."""
    try:
        return ast.parse(src, mode="eval")
    except SyntaxError as py_exc:
        try:
            return ast.parse(_translate_sql_predicate(src), mode="eval")
        except (SyntaxError, ExpressionError) as sql_exc:
            raise ExpressionError(
                f"predicate {src!r} is neither a valid Python expression "
                f"({py_exc}) nor translatable SQL ({sql_exc})"
            ) from None


def evaluate_predicate(predicate: Predicate, columns: Dict[str, np.ndarray], n: int) -> np.ndarray:
    """Evaluate a predicate to a boolean mask of length ``n``.

    ``columns`` maps column name -> numpy array (float64+NaN for numerics,
    object+None for strings). Callables receive the dict and must return a
    boolean array.
    """
    if callable(predicate):
        # user callables see plain arrays, never the DictColumn operand
        columns = {k: _materialize(v) for k, v in columns.items()}
        result = predicate(columns)
    else:
        result = _Evaluator(columns).visit(_parse_predicate(predicate))
    mask = _as_bool(result)
    if mask.shape == ():
        mask = np.full(n, bool(mask))
    if mask.shape != (n,):
        raise ExpressionError(f"predicate produced shape {mask.shape}, expected ({n},)")
    return mask
