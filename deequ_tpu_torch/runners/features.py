"""Host feature frontend: turns column batches into device-ready numeric
arrays (the union of all analyzers' FeatureSpecs, computed once per batch).

This is the scan-sharing mechanism: deequ shares one Spark scan between N
analyzers via fused aggregation columns with row offsets (reference
`analyzers/runners/AnalysisRunner.scala:303-318`); here N analyzers share
one host pass and one set of device arrays per batch. String-typed work
(regex, type classes, lengths, hashing) happens here on the host, in the
native library's one-pass C++ kernels (``deequ_tpu_torch/native``; the
``*_plain`` functions are their Python twins, for the tests) and once per
DISTINCT value for dictionary columns, so the kernels see only fixed-shape
numeric arrays.
"""

from __future__ import annotations

import re
import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from ..analyzers.base import FeatureSpec
from ..config import x64_enabled
from ..data import Batch, ColumnKind
from ..expr import evaluate_predicate
from ..ops.hashing import as_object_array, hash_column, xxhash64_strings_plain
from ..ops.hll import hll_pack_features


def _hll_packed(col) -> np.ndarray:
    """uint16 HLL ingest feature for one column: one native pass (hash,
    leading zeros, pack) over the column's own buffers."""
    from ..native import native_hll_pack_numeric, native_hll_pack_strings
    from ..ops.hashing import DEFAULT_SEED

    if _is_string_dict(col):
        # hash the DISTINCT values once per dataset, gather per row
        return hll_pack_features(dict_hashes(col), col.mask)
    if col.kind == ColumnKind.STRING:
        src = col.string_source
        if not isinstance(src, np.ndarray) or src.dtype == object:
            return native_hll_pack_strings(src, col.mask, DEFAULT_SEED)
    elif col.kind == ColumnKind.BOOLEAN or col.kind.is_numeric:
        vals = _hll_numeric_values(col.values)
        if np.issubdtype(vals.dtype, np.number):
            return native_hll_pack_numeric(vals, col.mask, DEFAULT_SEED)
    return _hll_packed_plain(col)


def _hll_numeric_values(vals: np.ndarray) -> np.ndarray:
    """Booleans and integers narrower than 64 bits hash as int64."""
    if vals.dtype == np.bool_ or (np.issubdtype(vals.dtype, np.integer) and vals.dtype != np.int64):
        return vals.astype(np.int64)
    return vals


def _hll_packed_plain(col) -> np.ndarray:
    """:func:`_hll_packed` in numpy: xxhash64 of each value, then packed."""
    if _is_string_dict(col):
        return hll_pack_features(dict_hashes(col), col.mask)
    source = col.string_source if col.kind == ColumnKind.STRING else col.values
    if col.kind == ColumnKind.STRING:
        hashes = xxhash64_strings_plain(source)
    else:
        hashes = hash_column(source, col.mask, col.kind)
    return hll_pack_features(hashes, col.mask)


# reference regexes (`analyzers/catalyst/StatefulDataType.scala:36-38`);
# decision order: null -> fractional -> integral -> boolean -> string
# (`StatefulDataType.update`, same file). re.ASCII + fullmatch reproduce the
# Java Matcher semantics (ASCII \d, whole-string match incl. no trailing
# newline).
_FRACTIONAL_RE = re.compile(r"(-|\+)? ?\d*\.\d*", re.ASCII)
_INTEGRAL_RE = re.compile(r"(-|\+)? ?\d*", re.ASCII)
_BOOLEAN_RE = re.compile(r"true|false")

TYPE_NULL, TYPE_FRACTIONAL, TYPE_INTEGRAL, TYPE_BOOLEAN, TYPE_STRING = range(5)


def classify_type_codes(values, mask: np.ndarray, kind: ColumnKind) -> np.ndarray:
    """Per-value inferred-type codes 0..4 (Unknown/Fractional/Integral/
    Boolean/String). Non-string columns map directly from their kind, which
    matches the reference's behavior of casting values to strings first
    (e.g. 1.5 -> "1.5" matches FRACTIONAL). String values are classified in
    one native pass over their Arrow buffers."""
    if kind == ColumnKind.STRING:
        from ..native import native_classify_types

        return native_classify_types(values, mask)
    return classify_type_codes_plain(values, mask, kind)


def classify_type_codes_plain(values, mask: np.ndarray, kind: ColumnKind) -> np.ndarray:
    """:func:`classify_type_codes` in Python: string values one by one
    against the reference regexes."""
    n = len(values)
    if kind == ColumnKind.STRING:
        values = as_object_array(values)
        out = np.full(n, TYPE_NULL, dtype=np.int32)
        for i in range(n):
            if not mask[i]:
                continue
            v = values[i]
            if v is None:
                continue
            if _FRACTIONAL_RE.fullmatch(v):
                out[i] = TYPE_FRACTIONAL
            elif _INTEGRAL_RE.fullmatch(v):
                out[i] = TYPE_INTEGRAL
            elif _BOOLEAN_RE.fullmatch(v):
                out[i] = TYPE_BOOLEAN
            else:
                out[i] = TYPE_STRING
        return out
    if kind == ColumnKind.FRACTIONAL:
        code = TYPE_FRACTIONAL
    elif kind == ColumnKind.INTEGRAL:
        code = TYPE_INTEGRAL
    elif kind == ColumnKind.BOOLEAN:
        code = TYPE_BOOLEAN
    else:
        code = TYPE_STRING
    return np.where(mask, np.int32(code), np.int32(TYPE_NULL)).astype(np.int32)


def dict_entry_type_codes(col) -> np.ndarray:
    """Type codes of each DISTINCT dictionary value, classified once per
    dataset (cached in col.aux across batches)."""
    tc = col.aux.get("type_codes")
    if tc is None:
        ones = np.ones(col.num_categories, dtype=bool)
        tc = classify_type_codes(col.dictionary_source, ones, ColumnKind.STRING)
        col.aux["type_codes"] = tc
    return tc


def dict_type_codes(col) -> np.ndarray:
    """Per-row type codes for a dictionary STRING column: classify the
    DISTINCT values once, gather by code. Null/padding rows -> TYPE_NULL."""
    tc = dict_entry_type_codes(col)
    num_cats = col.num_categories
    safe = np.where(col.codes < num_cats, col.codes, 0)
    out = tc[safe] if num_cats else np.zeros(len(col.codes), dtype=np.int32)
    return np.where(col.mask, out, TYPE_NULL).astype(np.int32)


def string_lengths(values, mask: np.ndarray) -> np.ndarray:
    """int32 code-point length of each masked, non-null string (else 0), in
    one native pass."""
    from ..native import native_string_lengths

    return native_string_lengths(values, mask)


def string_lengths_plain(values, mask: np.ndarray) -> np.ndarray:
    """:func:`string_lengths` in Python."""
    values = as_object_array(values)
    out = np.zeros(len(values), dtype=np.int32)
    for i in np.flatnonzero(mask):
        v = values[i]
        if v is not None:
            out[i] = len(v)
    return out


def regex_matches(values, mask: np.ndarray, pattern: str) -> np.ndarray:
    """Unanchored regex search per value, nulls -> False (the reference uses
    `regexp_extract(col, pattern, 0) != ""`, `analyzers/PatternMatch.scala:
    46-52` — note a successful empty-string match also counts as False there,
    which we reproduce). String arrays match in the native library
    (PCRE2 over the Arrow buffers; Python's ``re`` where PCRE2 is missing or
    refuses the pattern); a column of other objects matches their ``str``
    under ``re``."""
    import pyarrow as pa

    from ..native import native_pattern_match

    if not isinstance(values, np.ndarray) or values.dtype == object:
        try:
            return native_pattern_match(values, mask, pattern)
        except (pa.ArrowInvalid, pa.ArrowTypeError):
            pass  # objects that are not strings: matched as str below
    return regex_matches_plain(values, mask, pattern)


def regex_matches_plain(values, mask: np.ndarray, pattern: str) -> np.ndarray:
    """:func:`regex_matches` in Python, value by value."""
    values = as_object_array(values)
    compiled = re.compile(pattern)
    out = np.zeros(len(values), dtype=bool)
    for i in np.flatnonzero(mask):
        v = values[i]
        if v is None:
            continue
        m = compiled.search(str(v))
        out[i] = bool(m) and m.group(0) != ""
    return out


def dict_regex_matches(col, pattern: str) -> np.ndarray:
    """Per-row regex matches for a dictionary STRING column: each DISTINCT
    entry is matched once per dataset (cached in col.aux, keyed by
    pattern), then gathered by code. Null/padding rows -> False."""
    key = ("regex", pattern)
    per_entry = col.aux.get(key)
    if per_entry is None:
        ones = np.ones(col.num_categories, dtype=bool)
        per_entry = regex_matches(col.dictionary_source, ones, pattern)
        col.aux[key] = per_entry
    num_cats = col.num_categories
    if not num_cats:
        return np.zeros(len(col.codes), dtype=bool)
    safe = np.where(col.codes < num_cats, col.codes, 0)
    return per_entry[safe] & col.mask


def column_regex_matches(col, pattern: str) -> np.ndarray:
    """The one regex entry point for a Column: dictionary fast path when
    possible, else per-value matching."""
    if _is_string_dict(col):
        return dict_regex_matches(col, pattern)
    return regex_matches(col.string_source, col.mask, pattern)


def dict_string_lengths(col) -> np.ndarray:
    ld = col.aux.get("lengths")
    if ld is None:
        ones = np.ones(col.num_categories, dtype=bool)
        ld = string_lengths(col.dictionary_source, ones)
        col.aux["lengths"] = ld
    num_cats = col.num_categories
    safe = np.where(col.codes < num_cats, col.codes, 0)
    out = ld[safe] if num_cats else np.zeros(len(col.codes), dtype=np.int32)
    return np.where(col.mask, out, 0).astype(np.int32)


def dict_entry_hashes(col) -> np.ndarray:
    """xxhash64 of each DISTINCT dictionary value, cached per dataset."""
    hd = col.aux.get("hashes")
    if hd is None:
        ones = np.ones(col.num_categories, dtype=bool)
        hd = hash_column(col.dictionary_source, ones, col.kind)
        col.aux["hashes"] = hd
    return hd


def dict_hashes(col) -> np.ndarray:
    """Per-row xxhash64 via the cached distinct-value hashes + a gather.
    Masked rows carry arbitrary hashes — every consumer masks before use."""
    hd = dict_entry_hashes(col)
    num_cats = col.num_categories
    if not num_cats:
        return np.zeros(len(col.codes), dtype=np.uint64)
    safe = np.where(col.codes < num_cats, col.codes, 0)
    return hd[safe]


def _key_values(col) -> np.ndarray:
    """The ``key`` feature: integers pass through in their own signed dtype
    (masked positions may hold anything), unsigned ones widen to int64 or,
    at 64 bits, keep their bits as int64; booleans become float64 0/1."""
    vals = col.values
    if not (np.issubdtype(vals.dtype, np.integer) and col.kind == ColumnKind.INTEGRAL):
        return col.numeric_f64()
    if vals.dtype == np.uint64:
        return vals.view(np.int64)
    if vals.dtype in (np.uint16, np.uint32):
        return vals.astype(np.int64)
    return vals


#: the numeric feature's dtype: float64, or float32 when the process runs
#: the reference's 32-bit accumulator mode (``DEEQU_TPU_NO_X64``)
NUM_DTYPE = np.float64 if x64_enabled() else np.float32


def _is_string_dict(col) -> bool:
    return (
        col.has_dictionary
        and col.codes is not None
        and col.kind == ColumnKind.STRING
    )


class FeatureBuilder:
    """Computes the union of requested features for each batch. Arrays come
    out in the dtypes the kernels take: bool masks, float64 values (float32
    in the 32-bit accumulator mode, :data:`NUM_DTYPE`), int32 lengths,
    codes and type classes, uint16 HLL keys, int64 hash bits and integers
    of their own width for group keys."""

    def __init__(self, specs: Iterable[FeatureSpec]):
        # dedupe by key, keep spec objects (payload needed for predicates)
        self.specs: Dict[str, FeatureSpec] = {}
        for s in specs:
            self.specs.setdefault(s.key, s)

    @property
    def required_columns(self) -> List[str]:
        # predicates may reference any column — the runner accounts for that
        # in `_columns_needed`, not here
        return sorted({s.column for s in self.specs.values() if s.column is not None})

    def build(self, batch: Batch, seconds: Optional[Dict[str, float]] = None) -> Dict[str, np.ndarray]:
        """The batch's features; with ``seconds``, adds each feature kind's
        host time to it (under ``feature_build.<kind>``)."""
        features: Dict[str, np.ndarray] = {}
        pred_columns = None
        for key, spec in self.specs.items():
            t0 = time.perf_counter()
            if spec.kind == "rows":
                features[key] = batch.row_mask
            elif spec.kind == "num":
                col = batch.column(spec.column)
                if NUM_DTYPE is np.float32:
                    # the 32-bit accumulator mode: one cast, rounding to
                    # nearest as the reference's jnp.asarray of the host
                    # column does; masked-out garbage may overflow to inf
                    src = (col.values if np.issubdtype(col.values.dtype, np.number)
                           else col.numeric_f64())
                    with np.errstate(over="ignore", invalid="ignore"):
                        features[key] = np.asarray(src, dtype=np.float32)
                elif np.issubdtype(col.values.dtype, np.number):
                    # float64 passes through zero-copy: masked-out positions
                    # may carry arbitrary bytes (Arrow leaves null slots
                    # undefined) and every kernel masks before use
                    features[key] = np.asarray(col.values, dtype=np.float64)
                else:
                    features[key] = col.numeric_f64()
            elif spec.kind == "mask":
                features[key] = batch.column(spec.column).mask
            elif spec.kind == "key":
                features[key] = _key_values(batch.column(spec.column))
            elif spec.kind == "hash":
                col = batch.column(spec.column)
                if _is_string_dict(col):
                    # cached hashes of the DISTINCT values, gathered by code
                    hashes = dict_hashes(col)
                elif col.kind == ColumnKind.STRING:
                    hashes = hash_column(col.string_source, col.mask, col.kind)
                else:
                    hashes = hash_column(col.values, col.mask, col.kind)
                features[key] = hashes.view(np.int64)
            elif spec.kind == "len":
                col = batch.column(spec.column)
                if _is_string_dict(col):
                    features[key] = dict_string_lengths(col)
                else:
                    features[key] = string_lengths(col.string_source, col.mask)
            elif spec.kind == "match":
                features[key] = column_regex_matches(
                    batch.column(spec.column), spec.payload
                )
            elif spec.kind == "type":
                col = batch.column(spec.column)
                if _is_string_dict(col):
                    features[key] = dict_type_codes(col)
                else:
                    features[key] = classify_type_codes(
                        col.string_source if col.kind == ColumnKind.STRING else col.values,
                        col.mask,
                        col.kind,
                    )
            elif spec.kind == "hll":
                features[key] = _hll_packed(batch.column(spec.column))
            elif spec.kind == "codes":
                col = batch.column(spec.column)
                if col.codes is None:
                    raise ValueError(
                        f"column {spec.column} is not dictionary-encoded; the "
                        "codes feature is only valid on dictionary sources"
                    )
                features[key] = col.codes
            elif spec.kind == "pred":
                if pred_columns is None:
                    pred_columns = _predicate_columns(batch)
                mask = evaluate_predicate(spec.payload, pred_columns, len(batch.row_mask))
                features[key] = mask & batch.row_mask
            else:
                raise ValueError(f"unknown feature kind {spec.kind}")
            if seconds is not None:
                phase = f"feature_build.{spec.kind}"
                seconds[phase] = seconds.get(phase, 0.0) + time.perf_counter() - t0
        return features


def dry_run_batch(schema) -> Batch:
    """A synthetic all-null 1-row batch used to validate an analyzer's
    features (predicate syntax, column refs, regex compilation) before the
    real pass, so a bad analyzer yields a failure metric instead of killing
    the shared scan."""
    from ..data import Column

    columns = {}
    for cs in schema.columns:
        mask = np.zeros(1, dtype=bool)
        if cs.kind.is_numeric or cs.kind == ColumnKind.BOOLEAN:
            values = np.zeros(1, dtype=np.float64)
        else:
            values = np.array([None], dtype=object)
        columns[cs.name] = Column(cs.name, cs.kind, values, mask)
    return Batch(columns, np.zeros(1, dtype=bool), 0)


class _LazyPredicateColumns:
    """Mapping of column name -> predicate operand, materialized ON ACCESS
    and cached: a predicate battery only touches the columns it references."""

    def __init__(self, batch: Batch):
        self._batch = batch
        self._cache: Dict[str, Any] = {}

    def __contains__(self, name: str) -> bool:
        return name in self._batch.columns

    def keys(self):
        return self._batch.columns.keys()

    def items(self):
        return ((name, self[name]) for name in self.keys())

    def __getitem__(self, name: str):
        cached = self._cache.get(name)
        if cached is None:
            cached = self._cache[name] = _predicate_column(
                self._batch.column(name)
            )
        return cached


def _predicate_column(col):
    from ..expr import DictColumn

    if col.kind.is_numeric or col.kind == ColumnKind.BOOLEAN:
        return col.numeric_f64()
    if col.has_dictionary and col.codes is not None:
        # lazy dictionary operand: membership/comparisons/functions
        # evaluate on the DISTINCT entries and gather by code; the
        # entry table (with its None sentinel) caches per dataset
        num_cats = col.num_categories
        entries = col.aux.get("pred_entries")
        if entries is None or len(entries) != num_cats + 1:
            entries = np.empty(num_cats + 1, dtype=object)
            if num_cats:
                entries[:num_cats] = col.dictionary
            entries[num_cats] = None
            col.aux["pred_entries"] = entries
        codes = np.where(
            col.mask & (col.codes >= 0) & (col.codes < num_cats),
            col.codes,
            num_cats,
        ).astype(np.int32)
        return DictColumn(entries, codes)
    vals = col.values
    if vals.dtype != object:
        vals = vals.astype(object)
    vals = vals.copy()
    vals[~col.mask] = None
    return vals


def _predicate_columns(batch: Batch) -> "_LazyPredicateColumns":
    return _LazyPredicateColumns(batch)
