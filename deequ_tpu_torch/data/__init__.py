"""Tabular data frontend.

The reference operates on Spark DataFrames; here a :class:`Dataset` wraps
columnar data (pyarrow Table / Parquet files / pandas / dict-of-arrays) and
yields fixed-size :class:`Batch` objects: per-column numpy value arrays plus
validity masks. Numeric values are materialized as float64 with NaN at nulls
so the device kernels only ever see fixed-shape numeric arrays; strings stay
host-side (object arrays) and are turned into numeric *features* (lengths,
regex masks, hashes) by the feature frontend (`runners/features.py`).

Replaces: Spark `DataFrame` + Row null checks (deequ uses `isNotNull` /
`conditionalSelection`, reference `analyzers/Analyzer.scala:409-432`).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Union

import numpy as np

try:
    import pyarrow as pa
    import pyarrow.parquet as pq
except ImportError:  # pragma: no cover - pyarrow is in the base image
    pa = None
    pq = None


class ColumnKind(enum.Enum):
    INTEGRAL = "Integral"
    FRACTIONAL = "Fractional"
    BOOLEAN = "Boolean"
    STRING = "String"
    TIMESTAMP = "Timestamp"
    UNKNOWN = "Unknown"

    @property
    def is_numeric(self) -> bool:
        return self in (ColumnKind.INTEGRAL, ColumnKind.FRACTIONAL)


@dataclass(frozen=True)
class ColumnSchema:
    name: str
    kind: ColumnKind
    nullable: bool = True


@dataclass(frozen=True)
class Schema:
    columns: Sequence[ColumnSchema]

    def __post_init__(self) -> None:
        object.__setattr__(self, "_by_name", {c.name: c for c in self.columns})

    def __contains__(self, name: str) -> bool:
        return name in self._by_name  # type: ignore[attr-defined]

    def __getitem__(self, name: str) -> ColumnSchema:
        return self._by_name[name]  # type: ignore[attr-defined]

    @property
    def names(self) -> List[str]:
        return [c.name for c in self.columns]


def _kind_of_arrow(t: "pa.DataType") -> ColumnKind:
    if pa.types.is_boolean(t):
        return ColumnKind.BOOLEAN
    if pa.types.is_integer(t):
        return ColumnKind.INTEGRAL
    if pa.types.is_floating(t) or pa.types.is_decimal(t):
        return ColumnKind.FRACTIONAL
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return ColumnKind.STRING
    if pa.types.is_temporal(t):
        return ColumnKind.TIMESTAMP
    if pa.types.is_dictionary(t):
        # a dictionary-encoded column behaves as its value type; the codes
        # additionally feed the device frequency path (analyzers/grouping.py)
        return _kind_of_arrow(t.value_type)
    return ColumnKind.UNKNOWN


def _kind_of_numpy(arr: np.ndarray) -> ColumnKind:
    if arr.dtype == np.bool_:
        return ColumnKind.BOOLEAN
    if np.issubdtype(arr.dtype, np.integer):
        return ColumnKind.INTEGRAL
    if np.issubdtype(arr.dtype, np.floating):
        return ColumnKind.FRACTIONAL
    if np.issubdtype(arr.dtype, np.datetime64):
        return ColumnKind.TIMESTAMP
    return ColumnKind.STRING


class Column:
    """One column slice: raw values + validity mask (True = present).

    Dictionary-encoded sources additionally carry ``codes`` (int32 indices
    into the table-wide unified ``dictionary``; nulls and padding are coded
    ``len(dictionary)``) so frequency counting can ride the device scan
    (scatter-free, see ``DeviceFrequencyScan``) instead of a host group-by.

    String columns keep the Arrow array in ``arrow`` and materialize the
    python-object ``values`` LAZILY, so a scan that never touches
    ``values`` never pays per-value object creation."""

    __slots__ = (
        "name", "kind", "_values", "mask", "codes", "_dictionary",
        "_dictionary_arrow", "arrow", "aux"
    )

    def __init__(
        self,
        name: str,
        kind: ColumnKind,
        values: "Optional[np.ndarray]",
        mask: np.ndarray,
        codes: "Optional[np.ndarray]" = None,
        dictionary: "Optional[np.ndarray]" = None,
        dictionary_arrow: "Optional[pa.Array]" = None,
        arrow: "Optional[pa.Array]" = None,
        aux: "Optional[dict]" = None,
    ):
        self.name = name
        self.kind = kind
        self._values = values
        self.mask = mask
        self.codes = codes
        self._dictionary = dictionary
        self._dictionary_arrow = dictionary_arrow
        self.arrow = arrow
        #: per-dataset-column cache for dictionary-derived artifacts (type
        #: codes, lengths, hashes of the DISTINCT values) — shared across
        #: batches so each dictionary is processed once per run, not once
        #: per batch per consumer
        self.aux = aux if aux is not None else {}

    @property
    def has_dictionary(self) -> bool:
        """Dictionary-encoded? Answered WITHOUT decoding (``.dictionary``
        decodes a large string dictionary to python objects on first touch
        — ~1s for a TPC-H comment column — so presence checks must not)."""
        return self._dictionary is not None or self._dictionary_arrow is not None

    @property
    def num_categories(self) -> "Optional[int]":
        if self._dictionary is not None:
            return len(self._dictionary)
        if self._dictionary_arrow is not None:
            return len(self._dictionary_arrow)
        return None

    @property
    def dictionary_source(self):
        """The dictionary payload for the string feature functions: the
        ARROW array when available (no object materialization up front).
        Non-string dictionaries return the decoded numpy array — their
        consumers (`hash_column`'s numeric paths) need real dtypes, and a
        numeric decode is a cheap buffer view, not an object explosion."""
        if self._dictionary_arrow is not None and self.kind == ColumnKind.STRING:
            return self._dictionary_arrow
        return self.dictionary

    @property
    def dictionary(self) -> "Optional[np.ndarray]":
        """Decoded dictionary values; decodes LAZILY from the arrow payload
        (cached in ``aux['values']`` across batches). Consumers that only
        need presence/length/feature input use ``has_dictionary`` /
        ``num_categories`` / ``dictionary_source`` instead."""
        if self._dictionary is None and self._dictionary_arrow is not None:
            vals = self.aux.get("values")
            if vals is None or len(vals) != len(self._dictionary_arrow):
                vals = _decode_dictionary(self._dictionary_arrow, self.kind)
                self.aux["values"] = vals
            self._dictionary = vals
        return self._dictionary

    @property
    def values(self) -> np.ndarray:
        if self._values is None:
            if self.has_dictionary and self.codes is not None:
                # lazy decode: most consumers read codes/dictionary or the
                # aux caches; a 10M-row object gather only happens if some
                # python-level consumer genuinely needs per-row values
                num_cats = self.num_categories
                safe = np.where(self.codes < num_cats, self.codes, 0)
                if num_cats:
                    self._values = self.dictionary[safe]
                else:
                    self._values = np.empty(len(self.codes), dtype=object)
            else:
                vals = self.arrow.to_numpy(zero_copy_only=False)
                if vals.dtype != object:
                    vals = vals.astype(object)
                self._values = vals
        return self._values

    @values.setter
    def values(self, vals: np.ndarray) -> None:
        self._values = vals

    @property
    def string_source(self):
        """What the string feature functions read: the Arrow array when
        available, else values."""
        return self.arrow if self.arrow is not None else self.values

    def numeric_f64(self) -> np.ndarray:
        """float64 view with NaN at nulls — the device-facing representation."""
        if self.kind == ColumnKind.BOOLEAN:
            out = np.where(self.mask, self.values.astype(np.float64), np.nan)
            return out
        if np.issubdtype(self.values.dtype, np.floating):
            out = self.values.astype(np.float64, copy=True)
            out[~self.mask] = np.nan
            return out
        if np.issubdtype(self.values.dtype, np.number):
            out = self.values.astype(np.float64)
            if not self.mask.all():
                out = np.where(self.mask, out, np.nan)
            return out
        # strings that look numeric: attempt parse (used by the profiler's
        # cast pass, reference `profiles/ColumnProfiler.scala:346-354`)
        out = np.full(len(self.values), np.nan, dtype=np.float64)
        for i in np.flatnonzero(self.mask):
            try:
                out[i] = float(self.values[i])
            except (TypeError, ValueError):
                pass
        return out


class Batch:
    """A fixed-size horizontal slice of the dataset.

    ``row_mask`` marks genuine rows (False rows are padding added to keep
    shapes static across the run, so every batch launches the kernels at
    one shape).
    """

    def __init__(self, columns: Dict[str, Column], row_mask: np.ndarray, num_rows: int):
        self.columns = columns
        self.row_mask = row_mask
        self.num_rows = num_rows  # valid rows

    def __len__(self) -> int:
        return self.num_rows

    def column(self, name: str) -> Column:
        return self.columns[name]


ArrayLike = Union[np.ndarray, list]


class Dataset:
    """Columnar dataset with batch iteration.

    Sources: dict of arrays (`from_dict`), pandas (`from_pandas`),
    pyarrow Table (`from_arrow`), Parquet files (`from_parquet`).
    """

    def __init__(self, table: "pa.Table", *, probe_encoding: bool = True):
        # derived views (select / casts / the profiler's pass-2 tables) pass
        # probe_encoding=False: their parent table already ran the 64k-row
        # cardinality probes and its verdict stands — re-probing every
        # derived construction costs three count_distinct passes per plain
        # string column for no new information
        if probe_encoding:
            table = _maybe_dictionary_encode(table)
        if any(pa.types.is_dictionary(f.type) for f in table.schema):
            # one table-wide dictionary per column: batch slices then share
            # a stable code space, the contract of the device frequency path
            table = table.unify_dictionaries()
        self._table = table
        self._schema = Schema(
            [ColumnSchema(f.name, _kind_of_arrow(f.type), f.nullable) for f in table.schema]
        )
        #: decoded dictionaries + derived-artifact caches, one per column,
        #: shared by every batch this dataset yields
        self._dict_aux: Dict[str, dict] = {}
        #: derived views memoized on their source (the profiler's cast and
        #: dictionary-encoded tables), so repeated profiles reuse them
        self.derived_cache: Dict[Any, "Dataset"] = {}

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_arrow(table: "pa.Table") -> "Dataset":
        return Dataset(table)

    @staticmethod
    def from_parquet(path: Union[str, Sequence[str]]) -> "Dataset":
        """Read Parquet from a local path (or a list of paths)."""
        if isinstance(path, str):
            return Dataset(pq.read_table(path))
        return Dataset(pa.concat_tables([pq.read_table(p) for p in path]))

    @staticmethod
    def from_pandas(df) -> "Dataset":
        return Dataset(pa.Table.from_pandas(df, preserve_index=False))

    @staticmethod
    def from_dict(data: Mapping[str, ArrayLike]) -> "Dataset":
        arrays = {}
        for name, vals in data.items():
            arrays[name] = pa.array(vals)
        return Dataset(pa.table(arrays))

    # -- schema / shape ------------------------------------------------------

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def num_rows(self) -> int:
        return self._table.num_rows

    @property
    def arrow(self) -> "pa.Table":
        return self._table

    def to_pandas(self):
        return self._table.to_pandas()

    def select(self, names: Sequence[str]) -> "Dataset":
        return Dataset(self._table.select(list(names)), probe_encoding=False)

    def dictionary_size(self, name: str) -> Optional[int]:
        """Entry count of an encoded column's table-wide dictionary WITHOUT
        decoding it (decoding a large string dictionary materializes python
        objects); None for plain columns."""
        if name not in self._schema:
            return None
        t = self._table.schema.field(name).type
        if not pa.types.is_dictionary(t):
            return None
        col = self._table[name]
        if col.num_chunks == 0:
            return 0
        return len(col.chunk(0).dictionary)

    def dictionary_values(self, name: str) -> Optional[np.ndarray]:
        """The table-wide unified dictionary of an encoded column, or None
        for plain columns. Positions are the code space the per-batch
        ``Column.codes`` index into."""
        if name not in self._schema:
            return None
        t = self._table.schema.field(name).type
        if not pa.types.is_dictionary(t):
            return None
        col = self._table[name]
        if col.num_chunks == 0:
            return np.array([], dtype=object)
        return _decode_dictionary(col.chunk(0).dictionary, self._schema[name].kind)

    def with_column_cast_to_f64(self, name: str) -> "Dataset":
        """Replace a string column by its parsed-float64 version (profiler
        pass-2 cast, reference `profiles/ColumnProfiler.scala:346-354`).
        Values the arrow cast rejects (e.g. "- 1.5", which the reference's
        type-inference regex accepts) fall back to per-value parsing with
        unparseable values becoming null (Spark cast semantics)."""
        import pyarrow.compute as pc

        col = self._table[name]
        idx = self._table.schema.get_field_index(name)
        try:
            casted = pc.cast(col, pa.float64(), safe=False)
        except pa.ArrowInvalid:
            def parse(v):
                if v is None:
                    return None
                try:
                    # Spark cast trims outer whitespace only; interior
                    # spaces make the cast null
                    return float(str(v).strip())
                except ValueError:
                    return None

            casted = pa.array([parse(v) for v in col.to_pylist()], type=pa.float64())
        return Dataset(self._table.set_column(idx, name, casted), probe_encoding=False)

    def with_columns_dictionary_encoded(self, names: Sequence[str]) -> "Dataset":
        """Dictionary-encode the given (plain) columns — works for any
        primitive type, e.g. a float column known to be low-cardinality.
        Columns that fail to encode are left untouched."""
        import pyarrow.compute as pc

        table = self._table
        for name in names:
            if name not in self._schema:
                continue
            if pa.types.is_dictionary(table.schema.field(name).type):
                continue
            try:
                encoded = pc.dictionary_encode(table[name])
            except Exception:  # noqa: BLE001
                continue
            table = table.set_column(
                table.schema.get_field_index(name), name, encoded
            )
        if table is self._table:
            return self
        return Dataset(table, probe_encoding=False)

    def random_split(self, train_fraction: float, seed: int = 0) -> ("Dataset", "Dataset"):
        """(training, test): each row goes to the training split when its
        draw of ``numpy.random.default_rng(seed).random(num_rows)`` is below
        ``train_fraction``, so a seed picks the rows the reference package
        picks (deequ_tpu/data/__init__.py:432)."""
        rng = np.random.default_rng(seed)
        n = self._table.num_rows
        picks = rng.random(n) < train_fraction
        idx = np.arange(n)
        return (
            Dataset(self._table.take(pa.array(idx[picks])), probe_encoding=False),
            Dataset(self._table.take(pa.array(idx[~picks])), probe_encoding=False),
        )

    # -- batching ------------------------------------------------------------

    def _materialize_column(self, name: str, chunk: "pa.ChunkedArray") -> Column:
        kind = self._schema[name].kind
        if isinstance(chunk, pa.ChunkedArray):
            # single-chunk slices (the common case: one-chunk tables) pass
            # through zero-copy; combine_chunks would COPY the slice — a
            # full extra memory pass per column per batch
            arr = chunk.chunk(0) if chunk.num_chunks == 1 else chunk.combine_chunks()
        else:
            arr = chunk
        n = len(arr)
        if arr.null_count:
            mask = np.asarray(arr.is_valid())
        else:
            mask = np.ones(n, dtype=bool)
        if isinstance(arr, pa.DictionaryArray):
            aux = self._dict_aux.setdefault(name, {})
            return _materialize_dictionary(name, kind, arr, mask, n, aux)
        if kind.is_numeric:
            values = _numeric_buffer_view(arr, n)
            if values is None:
                values = arr.to_numpy(zero_copy_only=False)
        elif kind == ColumnKind.BOOLEAN:
            values = arr.to_numpy(zero_copy_only=False)
            if values.dtype == object:
                values = np.array([bool(v) if v is not None else False for v in values.tolist()])
        elif kind == ColumnKind.TIMESTAMP:
            values = arr.to_numpy(zero_copy_only=False)
        elif kind == ColumnKind.STRING:
            # lazy: keep the arrow array; object values materialize only if
            # a python-level consumer (regex, group-by, histogram) asks
            return Column(name, kind, None, mask, arrow=arr)
        else:
            values = np.asarray(arr.to_pylist(), dtype=object)
        return Column(name, kind, values, mask)

    def batches(
        self,
        batch_size: int,
        columns: Optional[Sequence[str]] = None,
        pad_to_batch_size: bool = True,
    ) -> Iterator[Batch]:
        names = list(columns) if columns is not None else self._schema.names
        table = self._table.select(names) if names != self._schema.names else self._table
        n = table.num_rows
        for start in range(0, max(n, 1), batch_size):
            sl = table.slice(start, batch_size)
            m = min(batch_size, n - start)  # not sl.num_rows: 0-col tables misreport
            cols: Dict[str, Column] = {}
            for name in names:
                col = self._materialize_column(name, sl[name])
                if pad_to_batch_size and m < batch_size:
                    col = _pad_column(col, batch_size)
                cols[name] = col
            size = batch_size if pad_to_batch_size else m
            row_mask = np.zeros(size, dtype=bool)
            row_mask[:m] = True
            yield Batch(cols, row_mask, m)
            if n == 0:
                break


#: rows sampled to estimate a plain string column's cardinality
_ENCODE_PROBE_ROWS = 1 << 16
#: a probe must stay under this many distinct values to qualify
_ENCODE_MAX_PROBE_DISTINCT = 1 << 13


def _maybe_dictionary_encode(table: "pa.Table") -> "pa.Table":
    """Dictionary-encode plain string columns that a cheap probe finds
    low-cardinality (the ingest-time analog of Parquet/Spark dictionary
    encoding). Every downstream consumer then rides the per-dataset
    dictionary caches — type inference, lengths, hashing and frequency
    counting become O(distinct) per dataset plus an O(rows) code pass,
    instead of per-row string work per batch per analyzer: a TPC-H flag
    column's HLL host cost drops ~30x. Columns whose probe looks
    high-cardinality stay as-is (encoding them would waste memory for no
    reuse)."""
    n = table.num_rows
    if n == 0:
        return table
    import pyarrow.compute as pc

    for i, field in enumerate(table.schema):
        if not (
            pa.types.is_string(field.type) or pa.types.is_large_string(field.type)
        ):
            continue
        column = table.column(i)
        # probe the head, middle AND tail: a column clustered/sorted by the
        # key (low-card head, high-card tail) must be rejected here, before
        # the full-column encode — the post-encode guard below still
        # catches what three slices miss, but the probes keep the common
        # clustered case from paying a full encode on EVERY construction
        try:
            qualified = True
            for start in (0, max((n - _ENCODE_PROBE_ROWS) // 2, 0),
                          max(n - _ENCODE_PROBE_ROWS, 0)):
                probe = column.slice(start, _ENCODE_PROBE_ROWS)
                distinct = pc.count_distinct(probe).as_py()
                # smaller tables qualify with proportionally smaller
                # dictionaries — 1000 rows with 900 distinct gains nothing
                limit = min(_ENCODE_MAX_PROBE_DISTINCT, max(len(probe) // 8, 1))
                if distinct > limit:
                    qualified = False
                    break
        except Exception:  # noqa: BLE001 - exotic layout: leave column alone
            continue
        if not qualified:
            continue
        try:
            encoded = pc.dictionary_encode(column)
        except Exception:  # noqa: BLE001
            continue
        # post-encode guard: a clustered/sorted column can fool the head
        # probe (low-card head, high-card tail) — revert when the actual
        # dictionary isn't meaningfully smaller than the rows, otherwise
        # every per-dataset O(dict) cache would dwarf the per-row work the
        # encoding exists to save
        built = sum(
            len(encoded.chunk(c).dictionary) for c in range(encoded.num_chunks)
        )
        if built > max(n // 4, _ENCODE_MAX_PROBE_DISTINCT):
            continue
        table = table.set_column(i, field.name, encoded)
    return table


#: fixed-width arrow types whose values buffer is a plain numpy dtype
_ZERO_COPY_DTYPES = None


def _zero_copy_dtype(t: "pa.DataType"):
    global _ZERO_COPY_DTYPES
    if _ZERO_COPY_DTYPES is None:
        _ZERO_COPY_DTYPES = {
            pa.int8(): np.int8, pa.int16(): np.int16,
            pa.int32(): np.int32, pa.int64(): np.int64,
            pa.uint8(): np.uint8, pa.uint16(): np.uint16,
            pa.uint32(): np.uint32, pa.uint64(): np.uint64,
            pa.float32(): np.float32, pa.float64(): np.float64,
        }
    return _ZERO_COPY_DTYPES.get(t)


def _numeric_buffer_view(arr: "pa.Array", n: int) -> Optional[np.ndarray]:
    """Zero-copy numpy view of a primitive arrow array's values buffer.

    Null slots carry whatever bytes Arrow left there (NOT NaN) — callers
    must treat masked-out positions as garbage. This is the contract the
    device feature feed relies on: every kernel masks before use, so the
    scan path makes no host-side copy of float64 columns at all."""
    dtype = _zero_copy_dtype(arr.type)
    if dtype is None:
        return None
    buf = arr.buffers()[1]
    if buf is None:
        return None
    view = np.frombuffer(buf, dtype=dtype, count=arr.offset + n)
    return view[arr.offset:]


def _decode_dictionary(dictionary: "pa.Array", kind: ColumnKind) -> np.ndarray:
    """The single decode policy for dictionary payloads — shared by batch
    materialization and Dataset.dictionary_values so the code->value mapping
    cannot drift between the two."""
    if kind.is_numeric or kind == ColumnKind.BOOLEAN:
        return dictionary.to_numpy(zero_copy_only=False)
    return np.asarray(dictionary.to_pylist(), dtype=object)


def _materialize_dictionary(
    name: str,
    kind: ColumnKind,
    arr: "pa.DictionaryArray",
    mask: np.ndarray,
    n: int,
    aux: "Optional[dict]" = None,
) -> Column:
    """Keep the (unified) codes + the ARROW dictionary; BOTH per-row values
    and the decoded dictionary stay LAZY — decoding a large string
    dictionary to python objects costs ~1s for a TPC-H comment column. Nulls
    get the out-of-range code len(dictionary), which the device count
    drops. Derived artifacts cache once per dataset via ``aux``."""
    import pyarrow.compute as pc

    if aux is None:
        aux = {}
    num_cats = len(arr.dictionary)
    if aux.get("num_categories") != num_cats:
        aux.clear()  # dictionary changed: derived artifacts are stale
        aux["num_categories"] = num_cats
    indices = arr.indices
    if indices.null_count == 0 and indices.type == pa.int32():
        # the common fast shape (int32 indices, no nulls): zero-copy view,
        # no per-batch cast/fill pass
        codes = np.asarray(indices.to_numpy(zero_copy_only=True), dtype=np.int32)
    else:
        # widen BEFORE filling: the null sentinel num_cats may not fit the
        # dictionary's narrow index type (e.g. int8 indices, 128 categories)
        codes = np.asarray(
            pc.fill_null(indices.cast(pa.int32()), num_cats).to_numpy(
                zero_copy_only=False
            ),
            dtype=np.int32,
        )
    return Column(
        name, kind, None, mask, codes=codes,
        dictionary_arrow=arr.dictionary, aux=aux,
    )


def _pad_column(col: Column, size: int) -> Column:
    m = len(col.mask)
    pad = size - m
    if pad <= 0:
        return col
    mask = np.zeros(size, dtype=bool)
    mask[:m] = col.mask
    codes = None
    if col.codes is not None:
        # padding rows carry the null code (dropped by the device count)
        codes = np.full(size, col.num_categories, dtype=np.int32)
        codes[:m] = col.codes
    if col.arrow is not None and col._values is None:
        # stay lazy: pad the arrow array with nulls (C-speed concat)
        arrow = pa.concat_arrays([col.arrow, pa.nulls(pad, col.arrow.type)])
        return Column(
            col.name, col.kind, None, mask, codes=codes,
            dictionary=col._dictionary, dictionary_arrow=col._dictionary_arrow,
            arrow=arrow, aux=col.aux,
        )
    if col.has_dictionary and col._values is None:
        # dictionary columns stay lazy too: codes already padded above
        return Column(
            col.name, col.kind, None, mask, codes=codes,
            dictionary=col._dictionary, dictionary_arrow=col._dictionary_arrow,
            aux=col.aux,
        )
    if col.values.dtype == object:
        values = np.empty(size, dtype=object)
        values[:m] = col.values
    else:
        values = np.zeros(size, dtype=col.values.dtype)
        values[:m] = col.values
    return Column(
        col.name, col.kind, values, mask, codes=codes,
        dictionary=col._dictionary, dictionary_arrow=col._dictionary_arrow,
    )
