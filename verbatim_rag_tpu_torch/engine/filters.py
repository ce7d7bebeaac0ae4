"""Metadata filtering: device-side boolean masks from host-side predicates.

TPU-native replacement for Milvus scalar filtering / JSON predicate pushdown
(`milvus_base.py:315-353`). Instead of a query-language string evaluated
inside a C++ store, a filter here compiles to a boolean mask over index rows
that the scoring kernels apply *before* top-k (masked rows score -inf), so
filtered search costs the same device pass as unfiltered search.

Accepted filter shapes:
- ``dict``: equality / membership per field — ``{"document_id": "d1"}``,
  ``{"dataset_id": ["a", "b"]}``. Promoted fields (user_id, document_id,
  dataset_id — mirroring the reference's promoted dynamic fields,
  `vector_stores/utils.py:32-52`) are evaluated vectorized over hashed
  columns; other fields fall back to a per-row metadata scan.
- ``callable``: ``fn(metadata: dict) -> bool`` evaluated per row.
- ``str``: the reference's Milvus filter-expression syntax
  (`milvus_base.py:315-353`, `index.py:734-739`) — e.g.
  ``'document_id == "x"'``, ``'metadata["topic"] in ["a", "b"] and year >= 2020'``.
  Parsed by :func:`parse_filter_expr`; unparseable strings raise
  ``FilterExpressionError`` loudly rather than silently matching nothing.
"""

from __future__ import annotations

import hashlib
import re
from typing import Any, Callable, Mapping, Sequence, Union

import numpy as np

FilterSpec = Union[str, Mapping[str, Any], Callable[[dict], bool], None]

#: Fields mirrored into vectorized hash columns at ingest.
PROMOTED_FIELDS = ("user_id", "document_id", "dataset_id")


def stable_hash64(value: Any) -> np.int64:
    """Deterministic 64-bit hash of a scalar (stable across processes)."""
    digest = hashlib.blake2b(repr(value).encode(), digest_size=8).digest()
    return np.int64(int.from_bytes(digest, "little", signed=True))


class FilterExpressionError(ValueError):
    """A filter-expression string could not be parsed.

    Raised loudly (parity decision: the reference hands bad strings to
    Milvus, which errors server-side; a silent empty match would be a
    correctness trap)."""


# --- Milvus-syntax filter expressions -------------------------------------------
#
# Grammar (the subset the reference actually emits — `index.py:734-739` plus
# the operators Milvus' scalar filtering documents for metadata predicates):
#
#   expr    := or_expr
#   or_expr := and_expr ('or' and_expr)*
#   and_expr:= unary ('and' unary)*
#   unary   := 'not' unary | '(' expr ')' | comparison
#   comparison := field op literal | field ['not'] 'in' list
#   field   := IDENT | 'metadata' '[' STRING ']'
#   op      := '==' | '!=' | '>=' | '<=' | '>' | '<'
#   literal := STRING | NUMBER | 'true' | 'false' | 'null'
#   list    := '[' literal (',' literal)* ']'

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<string>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
      | (?P<number>-?\d+\.\d+|-?\d+)
      | (?P<op>==|!=|>=|<=|>|<)
      | (?P<punct>[\[\](),])
      | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
    )""",
    re.VERBOSE,
)


def _tokenize_expr(text: str) -> list[tuple[str, str]]:
    tokens: list[tuple[str, str]] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            if text[pos:].strip() == "":
                break
            raise FilterExpressionError(
                f"Unrecognized token at position {pos} in filter expression: "
                f"{text[pos:pos + 20]!r}"
            )
        pos = m.end()
        kind = m.lastgroup
        value = m.group(kind)
        if kind == "ident" and value.lower() in ("and", "or", "not", "in"):
            tokens.append(("keyword", value.lower()))
        else:
            tokens.append((kind, value))
    return tokens


def _unquote(raw: str) -> str:
    body = raw[1:-1]
    return re.sub(r"\\(.)", r"\1", body)


class _ExprParser:
    """Recursive-descent parser → AST of ('or'|'and'|'not'|'cmp', ...) tuples."""

    def __init__(self, text: str):
        self.text = text
        self.tokens = _tokenize_expr(text)
        self.i = 0

    def peek(self):
        return self.tokens[self.i] if self.i < len(self.tokens) else (None, None)

    def next(self):
        tok = self.peek()
        self.i += 1
        return tok

    def expect(self, kind, value=None):
        k, v = self.next()
        if k != kind or (value is not None and v != value):
            raise FilterExpressionError(
                f"Expected {value or kind} in filter expression {self.text!r}, got {v!r}"
            )
        return v

    def parse(self):
        node = self.or_expr()
        if self.i != len(self.tokens):
            raise FilterExpressionError(
                f"Trailing tokens in filter expression {self.text!r}: "
                f"{self.tokens[self.i:]}"
            )
        return node

    def or_expr(self):
        node = self.and_expr()
        while self.peek() == ("keyword", "or"):
            self.next()
            node = ("or", node, self.and_expr())
        return node

    def and_expr(self):
        node = self.unary()
        while self.peek() == ("keyword", "and"):
            self.next()
            node = ("and", node, self.unary())
        return node

    def unary(self):
        kind, value = self.peek()
        if (kind, value) == ("keyword", "not"):
            self.next()
            return ("not", self.unary())
        if (kind, value) == ("punct", "("):
            self.next()
            node = self.or_expr()
            self.expect("punct", ")")
            return node
        return self.comparison()

    def _field(self) -> str:
        kind, value = self.next()
        if kind != "ident":
            raise FilterExpressionError(
                f"Expected a field name in filter expression {self.text!r}, got {value!r}"
            )
        if value == "metadata" and self.peek() == ("punct", "["):
            self.next()
            k, key = self.next()
            if k != "string":
                raise FilterExpressionError(
                    f'metadata[...] requires a quoted key in {self.text!r}'
                )
            self.expect("punct", "]")
            return _unquote(key)
        return value

    def _literal(self):
        kind, value = self.next()
        if kind == "string":
            return _unquote(value)
        if kind == "number":
            return float(value) if "." in value else int(value)
        if kind == "ident" and value.lower() in ("true", "false"):
            return value.lower() == "true"
        if kind == "ident" and value.lower() == "null":
            return None
        raise FilterExpressionError(
            f"Expected a literal in filter expression {self.text!r}, got {value!r}"
        )

    def _list(self) -> list:
        self.expect("punct", "[")
        items = [self._literal()]
        while self.peek() == ("punct", ","):
            self.next()
            items.append(self._literal())
        self.expect("punct", "]")
        return items

    def comparison(self):
        field = self._field()
        kind, value = self.next()
        if (kind, value) == ("keyword", "not"):
            self.expect("keyword", "in")
            return ("not", ("cmp", field, "in", self._list()))
        if (kind, value) == ("keyword", "in"):
            return ("cmp", field, "in", self._list())
        if kind == "op":
            return ("cmp", field, value, self._literal())
        raise FilterExpressionError(
            f"Expected an operator after field {field!r} in {self.text!r}, got {value!r}"
        )


def parse_filter_expr(text: str):
    """Parse a Milvus-syntax filter string into a filter AST."""
    if not text.strip():
        return None
    return _ExprParser(text).parse()


_NUM_OPS = {
    ">": np.greater,
    ">=": np.greater_equal,
    "<": np.less,
    "<=": np.less_equal,
}


def _defined_mask(
    field: str,
    n_rows: int,
    promoted_columns: Mapping[str, np.ndarray],
    metadata_rows: Sequence[dict],
) -> np.ndarray:
    """Rows whose metadata has a non-null value for ``field``."""
    if field in promoted_columns:
        # The ingest-time hash column stores sentinel 0 for missing/None.
        return promoted_columns[field][:n_rows] != 0
    return np.fromiter(
        (metadata_rows[i].get(field) is not None for i in range(n_rows)),
        dtype=bool,
        count=n_rows,
    )


def _eval_expr_mask(
    node,
    n_rows: int,
    promoted_columns: Mapping[str, np.ndarray],
    metadata_rows: Sequence[dict],
) -> np.ndarray:
    kind = node[0]
    if kind == "or":
        return _eval_expr_mask(node[1], n_rows, promoted_columns, metadata_rows) | (
            _eval_expr_mask(node[2], n_rows, promoted_columns, metadata_rows)
        )
    if kind == "and":
        return _eval_expr_mask(node[1], n_rows, promoted_columns, metadata_rows) & (
            _eval_expr_mask(node[2], n_rows, promoted_columns, metadata_rows)
        )
    if kind == "not":
        inner = _eval_expr_mask(node[1], n_rows, promoted_columns, metadata_rows)
        if node[1][0] == "cmp":
            # Null semantics (matching Milvus scalar filtering): a row
            # lacking the field matches neither a comparison nor its
            # negation — `not (year == 2020)` must not return year-less rows.
            return ~inner & _defined_mask(
                node[1][1], n_rows, promoted_columns, metadata_rows
            )
        return ~inner
    _, field, op, rhs = node
    if field in promoted_columns and op in ("==", "in"):
        # Vectorized over the ingest-time hash columns — no metadata scan.
        values = rhs if op == "in" else [rhs]
        column = promoted_columns[field][:n_rows]
        # None maps to the ingest sentinel (0), so `field == null` selects
        # rows missing the field — same result as the metadata-scan branch.
        wanted = np.array(
            [np.int64(0) if v is None else stable_hash64(v) for v in values],
            dtype=np.int64,
        )
        return np.isin(column, wanted)
    if op in ("==", "!="):
        eq = np.fromiter(
            (metadata_rows[i].get(field) == rhs for i in range(n_rows)),
            dtype=bool,
            count=n_rows,
        )
        if op == "==":
            return eq
        # `!=` must not match rows that lack the field (Milvus excludes
        # null/missing from != matches; `field == null` stays the explicit
        # way to select them).
        return ~eq & _defined_mask(field, n_rows, promoted_columns, metadata_rows)
    if op == "in":
        # List membership (not a set): row values may be unhashable
        # (list/dict metadata), and `x in list` compares by equality
        # without hashing x — same contract as the Mapping filter branch.
        allowed = list(rhs)
        return np.fromiter(
            (metadata_rows[i].get(field) in allowed for i in range(n_rows)),
            dtype=bool,
            count=n_rows,
        )
    cmp = _NUM_OPS[op]

    def _row_cmp(i: int) -> bool:
        v = metadata_rows[i].get(field)
        try:
            return bool(cmp(v, rhs))
        except TypeError:
            return False

    return np.fromiter((_row_cmp(i) for i in range(n_rows)), dtype=bool, count=n_rows)


def compile_filter(
    spec: FilterSpec,
    n_rows: int,
    promoted_columns: Mapping[str, np.ndarray],
    metadata_rows: Sequence[dict],
) -> np.ndarray | None:
    """Compile a filter spec to a boolean row mask (or None for no filter)."""
    if spec is None:
        return None
    if isinstance(spec, str):
        ast = parse_filter_expr(spec)
        if ast is None:
            return None
        return _eval_expr_mask(ast, n_rows, promoted_columns, metadata_rows)
    if callable(spec):
        mask = np.zeros(n_rows, dtype=bool)
        for i in range(n_rows):
            try:
                mask[i] = bool(spec(metadata_rows[i]))
            except Exception:
                mask[i] = False
        return mask
    if not isinstance(spec, Mapping):
        raise TypeError(f"Unsupported filter spec: {type(spec)!r}")

    mask = np.ones(n_rows, dtype=bool)
    for fieldname, expected in spec.items():
        values = (
            list(expected)
            if isinstance(expected, (list, tuple, set, frozenset))
            else [expected]
        )
        if fieldname in promoted_columns:
            column = promoted_columns[fieldname][:n_rows]
            # None maps to the ingest sentinel (0) so {'document_id': None}
            # selects rows missing the field — matching the non-promoted
            # dict branch (None in [None]) and the expression path.
            wanted = np.array(
                [np.int64(0) if v is None else stable_hash64(v) for v in values],
                dtype=np.int64,
            )
            mask &= np.isin(column, wanted)
        else:
            row_ok = np.fromiter(
                (metadata_rows[i].get(fieldname) in values for i in range(n_rows)),
                dtype=bool,
                count=n_rows,
            )
            mask &= row_ok
    return mask
