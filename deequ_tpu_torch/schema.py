"""Row-level schema enforcement: declarative column definitions, one
vectorized boolean conformance mask, valid/invalid row split with casting
(reference `schema/RowLevelSchemaValidator.scala:25-223`).

Row-level string validation is host work by nature; the masks are computed
with vectorized pandas/pyarrow ops (the reference builds one CNF Column
expression — same idea, Spark codegen swapped for numpy vectorization).

A copy of the JAX package's module: host code, which the row gate of the
ingest plane (:mod:`deequ_tpu_torch.ingest.rowgate`) shares.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import pandas as pd

from .data import Dataset


@dataclass(frozen=True)
class ColumnDefinition:
    name: str
    is_nullable: bool = True


@dataclass(frozen=True)
class StringColumnDefinition(ColumnDefinition):
    min_length: Optional[int] = None
    max_length: Optional[int] = None
    matches: Optional[str] = None


@dataclass(frozen=True)
class IntColumnDefinition(ColumnDefinition):
    min_value: Optional[int] = None
    max_value: Optional[int] = None


@dataclass(frozen=True)
class DecimalColumnDefinition(ColumnDefinition):
    precision: int = 10
    scale: int = 0


@dataclass(frozen=True)
class TimestampColumnDefinition(ColumnDefinition):
    mask: str = "yyyy-MM-dd HH:mm:ss"


@dataclass(frozen=True)
class RowLevelSchema:
    """Fluent builder (reference `RowLevelSchemaValidator.scala:25-69`)."""

    column_definitions: tuple = ()

    def with_string_column(
        self, name, is_nullable=True, min_length=None, max_length=None, matches=None
    ) -> "RowLevelSchema":
        return RowLevelSchema(
            self.column_definitions
            + (StringColumnDefinition(name, is_nullable, min_length, max_length, matches),)
        )

    def with_int_column(
        self, name, is_nullable=True, min_value=None, max_value=None
    ) -> "RowLevelSchema":
        return RowLevelSchema(
            self.column_definitions
            + (IntColumnDefinition(name, is_nullable, min_value, max_value),)
        )

    def with_decimal_column(
        self, name, precision, scale, is_nullable=True
    ) -> "RowLevelSchema":
        return RowLevelSchema(
            self.column_definitions
            + (DecimalColumnDefinition(name, is_nullable, precision, scale),)
        )

    def with_timestamp_column(self, name, mask, is_nullable=True) -> "RowLevelSchema":
        return RowLevelSchema(
            self.column_definitions + (TimestampColumnDefinition(name, is_nullable, mask),)
        )


@dataclass
class RowLevelSchemaValidationResult:
    """(reference `RowLevelSchemaValidator.scala:169-175`)."""

    valid_rows: Dataset
    num_valid_rows: int
    invalid_rows: Dataset
    num_invalid_rows: int


_JAVA_TO_STRPTIME = [
    ("yyyy", "%Y"), ("yy", "%y"), ("MM", "%m"), ("dd", "%d"),
    ("HH", "%H"), ("mm", "%M"), ("ss", "%S"), ("SSS", "%f"),
]


def _java_mask_to_strptime(mask: str) -> str:
    out = mask
    for java, py in _JAVA_TO_STRPTIME:
        out = out.replace(java, py)
    return out


def _parse_int(series: pd.Series) -> pd.Series:
    """Spark cast-to-int semantics: numeric strings parse, everything else
    (incl. fractional strings) becomes null. Dtype-dispatched: a column
    that is ALREADY integral (the streaming gate's steady state — typed
    Arrow frames, not CSV strings) passes through without touching a
    single value, and float columns vectorize; only object/string columns
    pay the per-value parse."""
    if pd.api.types.is_integer_dtype(series.dtype):
        # every value already casts (incl. nullable Int64 — its NAs stay
        # NAs, which is exactly the null-passthrough the parse encodes)
        return series
    if pd.api.types.is_float_dtype(series.dtype):
        # a numeric column (incl. an int column pandas widened to float64
        # because of nulls): Spark's numeric->int cast truncates; inf
        # cannot cast and marks the row invalid, it must not raise
        arr = series.to_numpy()
        out = pd.Series(np.trunc(arr), index=series.index, dtype="object")
        out[~np.isfinite(arr)] = None
        return out

    def parse(v):
        if v is None or (isinstance(v, float) and np.isnan(v)):
            return None
        if isinstance(v, (float, np.floating)):
            return int(v) if np.isfinite(v) else None
        try:
            return int(str(v).strip())
        except ValueError:
            return None

    return series.map(parse)


def _parse_decimal(series: pd.Series, precision: int, scale: int) -> pd.Series:
    """Castability to DECIMAL(precision, scale): value parses as a number
    and its integer part fits precision - scale digits."""
    max_abs = 10 ** (precision - scale)

    def parse(v):
        if v is None or (isinstance(v, float) and np.isnan(v)):
            return None
        try:
            f = float(str(v).strip())
        except ValueError:
            return None
        if abs(f) >= max_abs:
            return None
        return round(f, scale)

    return series.map(parse)


def _parse_timestamp(series: pd.Series, mask: str) -> pd.Series:
    fmt = _java_mask_to_strptime(mask)
    return pd.to_datetime(series, format=fmt, errors="coerce")


MATCHES_COLUMN = "__deequ__matches__schema"


def compute_conformance(df, schema: RowLevelSchema, num_rows=None):
    """The vectorized conformance pass shared by the batch validator and
    the streaming row gate (`deequ_tpu_torch.ingest.rowgate`): one boolean
    ``matches`` mask over ``df`` plus the per-column casted series for
    the rows that will survive. Factored out so the two paths can NEVER
    diverge on a verdict — the gate's accept/reject split is this exact
    mask, by construction.

    ``df`` is a DataFrame or a plain mapping of column name -> Series
    (with ``num_rows`` passed explicitly): the gate hands over bare
    per-column Series so its per-frame hot path never pays DataFrame /
    block-manager construction. ``name in df`` and ``df[name]`` mean the
    same thing for both shapes."""
    n = len(df) if num_rows is None else num_rows
    matches = np.ones(n, dtype=bool)
    casted: dict = {}
    for cd in schema.column_definitions:
        col = df[cd.name] if cd.name in df else pd.Series([None] * n)
        is_null = col.isna().to_numpy()
        if not cd.is_nullable:
            matches &= ~is_null
        if isinstance(cd, IntColumnDefinition):
            parsed = _parse_int(col)
            if parsed is not col:
                # an already-integral column passes through _parse_int
                # identically — every non-null value casts by
                # construction, so the castability pass is a no-op
                matches &= is_null | parsed.notna().to_numpy()
            # DOCUMENTED DIVERGENCE: nulls pass the min bound here, as
            # they do the max bound. The reference's min-bound CNF reads
            # `colIsNull.isNull.or(colAsInt.geq(value))`
            # (`RowLevelSchemaValidator.scala:246`) — `colIsNull.isNull`
            # is constant-false (isNull of a non-null boolean expr), so
            # there a NULL row FAILS minValue while PASSING maxValue
            # (`:250` uses the plain `colIsNull.or(...)`). That asymmetry
            # is an apparent typo, not a semantic choice; this build uses
            # the symmetric nullable semantics for both bounds, with
            # non-nullability enforced separately via `is_nullable`.
            if cd.min_value is not None or cd.max_value is not None:
                # vectorized bounds: NaN (unparseable or null) compares
                # False on both sides, the exact `v is not None and ...`
                # semantics of the per-value form
                pv = pd.to_numeric(parsed, errors="coerce").to_numpy(
                    dtype=float, na_value=np.nan
                )
                if cd.min_value is not None:
                    matches &= is_null | (pv >= cd.min_value)
                if cd.max_value is not None:
                    matches &= is_null | (pv <= cd.max_value)
            casted[cd.name] = parsed
        elif isinstance(cd, DecimalColumnDefinition):
            parsed = _parse_decimal(col, cd.precision, cd.scale)
            matches &= is_null | parsed.notna().to_numpy()
            casted[cd.name] = parsed
        elif isinstance(cd, TimestampColumnDefinition):
            parsed = _parse_timestamp(col, cd.mask)
            matches &= is_null | parsed.notna().to_numpy()
            casted[cd.name] = parsed
        elif isinstance(cd, StringColumnDefinition):
            # astype("string") is the vectorized str(v)-or-null: non-str
            # values stringify, nulls stay NA — the per-value semantics,
            # at C speed for the Arrow-string steady state
            as_str = col.astype("string")
            if cd.min_length is not None or cd.max_length is not None:
                lengths = as_str.str.len().to_numpy(
                    dtype=float, na_value=-1.0
                )
                if cd.min_length is not None:
                    matches &= is_null | (lengths >= cd.min_length)
                if cd.max_length is not None:
                    matches &= is_null | (lengths <= cd.max_length)
            if cd.matches is not None:
                hit = as_str.str.contains(
                    cd.matches, regex=True
                ).to_numpy(dtype=bool, na_value=False)
                matches &= is_null | hit
    return matches, casted


class RowLevelSchemaValidator:
    @staticmethod
    def validate(data: Dataset, schema: RowLevelSchema) -> RowLevelSchemaValidationResult:
        """(reference `RowLevelSchemaValidator.validate`, `:183-206`)."""
        df = data.to_pandas()
        n = len(df)
        matches, casted = compute_conformance(df, schema)
        valid_df = df[matches].copy()
        for name, series in casted.items():
            out = series[matches]
            if isinstance(
                next(cd for cd in schema.column_definitions if cd.name == name),
                IntColumnDefinition,
            ):
                out = out.astype("Int64")  # keeps integer type despite nulls
            valid_df[name] = out
        invalid_df = df[~matches]
        return RowLevelSchemaValidationResult(
            valid_rows=Dataset.from_pandas(valid_df.reset_index(drop=True)),
            num_valid_rows=int(matches.sum()),
            invalid_rows=Dataset.from_pandas(invalid_df.reset_index(drop=True)),
            num_invalid_rows=int(n - matches.sum()),
        )
