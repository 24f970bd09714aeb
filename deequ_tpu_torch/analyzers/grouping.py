"""Frequency/grouping analyzers.

The reference computes one `GROUP BY` per distinct grouping-column set and
shares the resulting frequency table between all analyzers on that set
(reference `analyzers/GroupingAnalyzers.scala:29-157`, scheduler sharing at
`analyzers/runners/AnalysisRunner.scala:259-287`). Here every set is
counted in the same single pass as every other analyzer, by one of three
routes (chosen in ``runners/analysis_runner.py``):

- a dictionary-encoded column of at most 2^16 entries: kernel
  ``dict_code_counts`` counts the batch's codes on the device
  (:class:`DeviceFrequencyScan`);
- a set that the cardinality probe finds small: the host group-by
  (:meth:`FrequenciesAndNumRows.update`), batch by batch;
- any other set: the device frequency table (:class:`DeviceFrequencyTableScan`,
  kernels ``freq_keys`` and ``freq_compact``), drained on the host into
  :class:`HashedFrequencies`. A table that drops groups re-runs its set
  through the host group-by in one more pass.

State semantics (verified against the reference):
- frequencies exclude rows where the grouping column is null;
- ``num_rows`` counts ALL rows (`FrequencyBasedAnalyzer.computeFrequencies`,
  `GroupingAnalyzers.scala:53-80`: numRows = data.count());
- merge = outer join adding counts (`GroupingAnalyzers.scala:128-148`).
"""

from __future__ import annotations

import abc
import math
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from ..config import (
    DEFAULT_FREQ_BUFFER_ENTRIES,
    DEFAULT_FREQ_TABLE_SLOTS,
    FREQ_HOST_ROUTE_MAX_DISTINCT,
    FREQ_HOST_ROUTE_MIN_ROWS,
    FREQ_PROBE_ROWS,
)
from ..data import Batch, ColumnKind, Schema
from ..exceptions import EmptyStateException, IllegalAnalyzerParameterException, wrap_if_necessary
from ..kernels.dict_code_counts import dict_code_counts
from ..kernels.freq_keys import KIND_HASH, KIND_NUM, MAX_COLUMNS as MAX_KEY_COLUMNS, KeyColumn
from ..ops.hashing import FREQ_KEY_SENTINEL
from ..metrics import (
    Distribution,
    DistributionValue,
    DoubleMetric,
    Entity,
    Failure,
    HistogramMetric,
    Success,
    metric_from_empty,
    metric_from_failure,
    metric_from_value,
)
from .base import (
    Analyzer,
    Preconditions,
    ScanShareableAnalyzer,
    codes_feature,
    hash_feature,
    key_feature,
    mask_feature,
    rows_feature,
)
from .states import FrequencyCountsState, FrequencyTableState


#: flush the run buffer once it holds at least this many entries (and at
#: least as many as the merged table), so total merge work stays linear in
#: the entries appended
MIN_FLUSH_ENTRIES = 1 << 17


class FrequenciesAndNumRows:
    """Host state: group -> count plus total row count
    (reference `GroupingAnalyzers.scala:128-157`).

    Built once from the device dictionary counts, or batch by batch by the
    host group-by (:meth:`update`), whose per-batch count runs buffer in a
    list and merge with one concat + groupby once they outweigh the merged
    table. The table stays in memory (the reference package's spill to disk
    is not ported)."""

    def __init__(self, frequencies: pd.Series, num_rows: int, group_columns: Sequence[str]):
        self._merged = frequencies  # index = group keys (tuples for several columns)
        self._runs: List[pd.Series] = []
        self._buffered = 0
        self._summary: Optional[Tuple[int, int, int, float]] = None
        self.num_rows = int(num_rows)
        self.group_columns = list(group_columns)

    @property
    def frequencies(self) -> pd.Series:
        """The merged frequency table (flushes buffered runs)."""
        self._flush()
        return self._merged

    def iter_merged_chunks(self) -> Iterator[pd.Series]:
        """Yield the count table (one chunk; the protocol of the
        reference's spilling accumulator)."""
        if len(self.frequencies):
            yield self.frequencies

    def num_distinct(self) -> int:
        return len(self.frequencies)

    def stream_summary(self) -> Tuple[int, int, int, float]:
        """(num_distinct, singleton_count, sum(count), sum(count*ln(count))),
        cached — every scalar frequency reduction (Uniqueness,
        Distinctness, UniqueValueRatio, CountDistinct, Entropy) reads these."""
        if self._summary is None:
            c = self.frequencies.to_numpy(dtype=np.int64)
            self._summary = (
                len(c), int((c == 1).sum()), int(c.sum()), _sum_c_ln_c(c)
            )
        return self._summary

    def is_empty(self) -> bool:
        return len(self.frequencies) == 0

    def _flush(self) -> None:
        if not self._runs:
            return
        parts = ([self._merged] if len(self._merged) else []) + self._runs
        if len(parts) == 1:
            merged = parts[0].astype(np.int64)
        else:
            cat = pd.concat(parts)
            levels = (
                list(range(cat.index.nlevels))
                if isinstance(cat.index, pd.MultiIndex)
                else 0
            )
            # dropna=False: a float column's NaN VALUES form a group (only
            # nulls are excluded, in update)
            merged = (
                cat.groupby(level=levels, sort=False, dropna=False)
                .sum()
                .astype(np.int64)
            )
        self._merged = merged
        self._runs = []
        self._buffered = 0

    def _append_run(self, counts: pd.Series) -> None:
        if len(counts) == 0:
            return
        self._summary = None
        self._runs.append(counts)
        self._buffered += len(counts)
        if self._buffered >= max(len(self._merged), MIN_FLUSH_ENTRIES):
            self._flush()

    def sum(self, other: "FrequenciesAndNumRows") -> "FrequenciesAndNumRows":
        if not isinstance(other, FrequenciesAndNumRows):
            raise TypeError(
                f"cannot merge a value-keyed frequency table with "
                f"{type(other).__name__}: hashed and value-keyed tables never mix"
            )
        merged = _add_series(self.frequencies, other.frequencies)
        return FrequenciesAndNumRows(merged, self.num_rows + other.num_rows, self.group_columns)

    @staticmethod
    def empty(group_columns: Sequence[str]) -> "FrequenciesAndNumRows":
        return FrequenciesAndNumRows(pd.Series([], dtype=np.int64), 0, group_columns)

    def update(self, batch: Batch) -> "FrequenciesAndNumRows":
        """Fold one batch of rows into the table: the host group-by of the
        reference package (deequ_tpu/analyzers/grouping.py:415). Rows where
        any grouping column is null leave the table but count in
        ``num_rows``. Mutates and returns self."""
        mask = batch.row_mask
        columns = {name: batch.column(name) for name in self.group_columns}
        for col in columns.values():
            mask = mask & col.mask
        self.num_rows += batch.num_rows
        if not mask.any():
            return self
        if len(self.group_columns) == 1:
            col = next(iter(columns.values()))
            if col.arrow is not None and batch.row_mask.all():
                # string keys kept as an Arrow array: C-speed value_counts
                # without python objects (its null group is dropped)
                counts = _arrow_value_counts(col.arrow)
                if counts is not None:
                    self._append_run(counts)
                    return self
            vals = col.values
            if vals.dtype != object and np.issubdtype(vals.dtype, np.integer):
                sel = vals[mask]
                smn, smx = sel.min(), sel.max()
                if int(smx) - int(smn) < (1 << 16):
                    # small-range integer keys: an offset bincount. Signed
                    # narrow dtypes widen before subtracting (int8 127 - -128
                    # wraps); unsigned ones subtract in their dtype (exact,
                    # the range is below 2^16) and rebuild keys in it too
                    if np.issubdtype(sel.dtype, np.signedinteger):
                        offs = sel.astype(np.int64) - int(smn)
                    else:
                        offs = (sel - smn).astype(np.int64)
                    cnts = np.bincount(offs, minlength=int(smx) - int(smn) + 1)
                    nz = np.flatnonzero(cnts)
                    if np.issubdtype(sel.dtype, np.signedinteger):
                        keys = (nz + int(smn)).astype(sel.dtype)
                    else:
                        keys = nz.astype(sel.dtype) + smn
                    self._append_run(pd.Series(cnts[nz].astype(np.int64), index=keys))
                    return self
                # other integer keys: np.unique (floats stay on the groupby:
                # NaN keys are pandas' to group)
                uniques, cnts = np.unique(sel, return_counts=True)
                self._append_run(pd.Series(cnts.astype(np.int64), index=uniques))
                return self
        frame = pd.DataFrame({n: c.values[mask] for n, c in columns.items()})
        counts = frame.groupby(self.group_columns, sort=False, dropna=False).size()
        if len(self.group_columns) == 1 and isinstance(counts.index, pd.MultiIndex):
            counts.index = counts.index.get_level_values(0)
        self._append_run(counts)
        return self


def _arrow_value_counts(arr) -> Optional[pd.Series]:
    """Distinct-value counts of an Arrow array as an int64 Series (the null
    entry dropped), or None when Arrow cannot count this type."""
    import pyarrow.compute as pc

    try:
        vc = pc.value_counts(arr)
    except Exception:  # noqa: BLE001 - an unsupported type takes the groupby
        return None
    values = vc.field("values")
    keys = values.to_numpy(zero_copy_only=False)
    counts = vc.field("counts").to_numpy(zero_copy_only=False)
    if values.null_count:
        keep = np.asarray(pc.is_valid(values))
        keys, counts = keys[keep], counts[keep]
    return pd.Series(counts.astype(np.int64), index=keys)


def _with_null_bin(counts: pd.Series, num_null: int) -> pd.Series:
    """Add the NullValue bin (reference `analyzers/Histogram.scala:108`:
    nulls count under the "NullValue" key)."""
    if not num_null:
        return counts
    return counts.add(
        pd.Series({NULL_FIELD_REPLACEMENT: num_null}), fill_value=0
    ).astype(np.int64)


def _sum_c_ln_c(counts: np.ndarray) -> float:
    """sum(count * ln(count)) over a count multiset in CANONICAL order: the
    count-of-counts histogram reduced in ascending count value, a pure
    function of the multiset (the reference package's Entropy reduces the
    same way, so the two agree bit for bit)."""
    counts = np.asarray(counts, dtype=np.int64)
    uc, mult = np.unique(counts[counts > 0], return_counts=True)
    pos = uc.astype(np.float64)
    return float((mult.astype(np.float64) * (pos * np.log(pos))).sum())


def _add_series(a: pd.Series, b: pd.Series) -> pd.Series:
    """Outer-join add of two count series; tolerates empty operands."""
    if len(a) == 0:
        return b.astype(np.int64)
    if len(b) == 0:
        return a.astype(np.int64)
    return a.add(b, fill_value=0).astype(np.int64)


@dataclass(frozen=True)
class DeviceFrequencyScan(ScanShareableAnalyzer):
    """Frequency table of one dictionary-encoded column computed ON DEVICE:
    the ``dict_code_counts`` kernel counts each batch's codes in the fused
    pass (the reference instead runs a Spark groupBy shuffle per set,
    `GroupingAnalyzers.scala:53-80`).

    Runner-internal: `AnalysisRunner` instantiates it for dictionary-encoded
    grouping columns and converts the state back into FrequenciesAndNumRows,
    so every grouping analyzer's metric code sees one state type."""

    column: str = ""
    num_categories: int = 0
    name: str = field(default="DeviceFrequencyScan", init=False)

    @property
    def instance(self) -> str:
        return self.column

    def feature_specs(self):
        return [rows_feature(), mask_feature(self.column), codes_feature(self.column)]

    def init_state(self, device) -> FrequencyCountsState:
        return FrequencyCountsState.init(self.num_categories, device)

    def update(self, state: FrequencyCountsState, features) -> FrequencyCountsState:
        # masked rows and the null/padding code K are dropped by the kernel;
        # num_rows counts every valid row
        counts, num_rows = dict_code_counts(
            features[codes_feature(self.column).key],
            features["rows"],
            features[mask_feature(self.column).key],
            self.num_categories,
        )
        return FrequencyCountsState(state.counts + counts, state.num_rows + num_rows)

    def merge(self, a, b):
        return a.merge(b)

    supports_host_partial = True

    def host_partial(self, ctx) -> FrequencyCountsState:
        """The batch's code counts on the host: the native one-pass count
        that DataType and ApproxCountDistinct share."""
        counts = ctx.dict_code_counts(self.column)[: self.num_categories]
        return FrequencyCountsState(
            torch.from_numpy(np.ascontiguousarray(counts, dtype=np.int64)),
            torch.tensor(ctx.batch.num_rows, dtype=torch.int64),
        )

    def to_frequencies(self, state, dictionary: np.ndarray) -> FrequenciesAndNumRows:
        counts = state.counts.cpu().numpy()
        nz = counts > 0
        series = pd.Series(
            counts[nz].astype(np.int64), index=pd.Index(np.asarray(dictionary)[nz])
        )
        return FrequenciesAndNumRows(series, int(state.num_rows), [self.column])

    def compute_metric_from(self, state):  # pragma: no cover - runner-internal
        raise NotImplementedError(
            "DeviceFrequencyScan states convert via to_frequencies; the "
            "grouping analyzers sharing the set own the metrics"
        )


def _u64_value_counts(keys: np.ndarray, weights: Optional[np.ndarray]):
    """Exact (unique key -> summed weight) over uint64 keys, by the native
    library's cache-partitioned hash aggregation (the reference's drain,
    grouping.py:740-762), in its partition and probe order. ``weights=None``
    counts each key once; explicit weights must be positive."""
    if len(keys) == 0:
        return keys.astype(np.uint64), np.zeros(0, dtype=np.int64)
    from ..native import native_u64_value_counts

    return native_u64_value_counts(keys, weights)


def _u64_value_counts_plain(keys: np.ndarray, weights: Optional[np.ndarray]):
    """:func:`_u64_value_counts` in numpy, ordered by key: a stable argsort
    and a segment sum."""
    if len(keys) == 0:
        return keys.astype(np.uint64), np.zeros(0, dtype=np.int64)
    order = np.argsort(keys, kind="stable")
    k = keys[order]
    w = np.ones(len(k), dtype=np.int64) if weights is None else weights[order].astype(np.int64)
    starts = np.flatnonzero(np.concatenate([[True], k[1:] != k[:-1]]))
    return k[starts], np.add.reduceat(w, starts)


class HashedFrequencies:
    """Exact count multiset keyed by 64-bit group-key hashes: the drained
    host view of a :class:`FrequencyTableState`. The scalar frequency
    reductions (Uniqueness, Distinctness, UniqueValueRatio, CountDistinct,
    Entropy) are functions of the count multiset and ``num_rows`` alone,
    so hashed keys lose nothing for them; it serves the same
    ``stream_summary`` / ``num_distinct`` / ``is_empty`` protocol as
    :class:`FrequenciesAndNumRows`."""

    __slots__ = ("keys", "counts", "num_rows", "group_columns", "_summary")

    def __init__(self, keys: np.ndarray, counts: np.ndarray, num_rows: int,
                 group_columns: Sequence[str]):
        self.keys = np.asarray(keys, dtype=np.uint64)
        self.counts = np.asarray(counts, dtype=np.int64)
        self.num_rows = int(num_rows)
        self.group_columns = list(group_columns)
        self._summary: Optional[Tuple[int, int, int, float]] = None

    def num_distinct(self) -> int:
        return len(self.counts)

    def is_empty(self) -> bool:
        return len(self.counts) == 0

    def stream_summary(self) -> Tuple[int, int, int, float]:
        """(num_distinct, singleton_count, sum(count), sum(count*ln(count)))."""
        if self._summary is None:
            self._summary = (
                len(self.counts), int((self.counts == 1).sum()), int(self.counts.sum()),
                _sum_c_ln_c(self.counts),
            )
        return self._summary

    def sum(self, other: "HashedFrequencies") -> "HashedFrequencies":
        if not isinstance(other, HashedFrequencies):
            raise TypeError(
                f"cannot merge a hashed frequency table with {type(other).__name__}: "
                "hashed and value-keyed tables never mix"
            )
        keys, counts = _u64_value_counts(
            np.concatenate([self.keys, other.keys]),
            np.concatenate([self.counts, other.counts]),
        )
        return HashedFrequencies(keys, counts, self.num_rows + other.num_rows, self.group_columns)


#: column kinds of a table scan's key: SplitMix64 of the values ("num") or
#: the host's xxhash64 of them ("hash")
KEY_NUM = "num"
KEY_HASH = "hash"


@dataclass(frozen=True)
class DeviceFrequencyTableScan(ScanShareableAnalyzer):
    """Frequencies of a grouping set of any cardinality and any number of
    columns (up to ``freq_keys``'s eight), computed on the device in the
    shared pass: per batch, kernel ``freq_keys`` writes one 64-bit group
    key per row into the state's buffer, and kernel ``freq_compact`` folds
    the buffer into the sorted table when a batch would overrun it. Port of
    the reference's ``DeviceFrequencyTableScan``
    (deequ_tpu/analyzers/grouping.py:831).

    A column's key is SplitMix64 of its values (integral and boolean
    columns, a bijection: no collisions) or the host's xxhash64 of them
    (strings and fractionals); several columns chain with xxhash64, each
    key seeding the next. ``resident``: the planner proved the buffer holds
    every padded batch of the run, so the pass never compacts.
    Runner-internal: the runner drains the state into
    :class:`HashedFrequencies`, which every analyzer of the set reads."""

    columns: Tuple[str, ...] = ()
    column_kinds: Tuple[str, ...] = ()
    slots: int = 0
    buffer_entries: int = 0
    resident: bool = False
    name: str = field(default="DeviceFrequencyTableScan", init=False)

    @property
    def instance(self) -> str:
        return ",".join(self.columns)

    def feature_specs(self):
        specs = [rows_feature()]
        for col, kind in zip(self.columns, self.column_kinds):
            specs.append(mask_feature(col))
            specs.append(key_feature(col) if kind == KEY_NUM else hash_feature(col))
        return specs

    def init_state(self, device) -> FrequencyTableState:
        return FrequencyTableState.init(self.slots, self.buffer_entries, device)

    def key_columns(self, features) -> List[KeyColumn]:
        """The batch's key columns, as kernel ``freq_keys`` takes them."""
        return [
            KeyColumn(KIND_NUM, features[key_feature(col).key], features[mask_feature(col).key])
            if kind == KEY_NUM else
            KeyColumn(KIND_HASH, features[hash_feature(col).key], features[mask_feature(col).key])
            for col, kind in zip(self.columns, self.column_kinds)
        ]

    def update(self, state: FrequencyTableState, features) -> FrequencyTableState:
        return state.append_keys(self.key_columns(features), features["rows"],
                                 assume_fits=self.resident)

    def merge(self, a, b):
        return a.merge(b)

    def drain(self, state: FrequencyTableState) -> Optional[HashedFrequencies]:
        """A fetched (host) state -> exact :class:`HashedFrequencies`, or
        None when compactions dropped groups (``lost_rows > 0``): the runner
        then re-runs the set through the host group-by."""
        if int(state.lost_rows) > 0:
            return None
        sent_key = np.uint64(FREQ_KEY_SENTINEL)
        buf = state.buf[:int(state.buf_fill)].numpy().view(np.uint64)
        if int(state.n_table) == 0:
            # resident: the whole run is in the buffer; the sentinel entries
            # aggregate into one group, dropped below
            keys, counts = _u64_value_counts(buf, None)
        else:
            tcounts = state.sorted_counts.numpy()
            nz = tcounts > 0
            keys, counts = _u64_value_counts(
                np.concatenate([state.sorted_keys.numpy().view(np.uint64)[nz], buf]),
                np.concatenate([tcounts[nz], np.ones(len(buf), dtype=np.int64)]),
            )
        # drop the sentinel group (masked and null rows, batch padding, and
        # valid rows whose key was the sentinel: those were counted in
        # sent_rows and come back as their own group)
        at = np.flatnonzero(keys == sent_key)
        if len(at):
            keys = np.delete(keys, at)
            counts = np.delete(counts, at)
        sent = int(state.sent_rows)
        if sent:
            keys = np.concatenate([keys, [sent_key]])
            counts = np.concatenate([counts, [np.int64(sent)]])
        return HashedFrequencies(keys, counts, int(state.num_rows), list(self.columns))

    def compute_metric_from(self, state):  # pragma: no cover - runner-internal
        raise NotImplementedError(
            "DeviceFrequencyTableScan states convert via drain; the grouping "
            "analyzers sharing the set own the metrics"
        )


def _next_pow2(v: int) -> int:
    p = 1
    while p < v:
        p <<= 1
    return p


def probably_low_cardinality(data, columns: Sequence[str],
                             limit: int = FREQ_HOST_ROUTE_MAX_DISTINCT) -> bool:
    """True when every column of the grouping set confidently looks
    low-cardinality (the product of the per-column distinct estimates at
    most ``limit``), so the host group-by serves it; the reference's probe
    (deequ_tpu/analyzers/grouping.py:1022). A dictionary column counts its
    dictionary; any other column counts the distinct values of head,
    middle and tail slices, and a layout whose later slices keep revealing
    new keys answers False. Runs of at most ``FREQ_HOST_ROUTE_MIN_ROWS``
    rows always answer False."""
    import pyarrow as pa
    import pyarrow.compute as pc

    n = int(data.num_rows)
    if n <= FREQ_HOST_ROUTE_MIN_ROWS:
        return False
    probe_rows = FREQ_PROBE_ROWS
    estimate = 1
    for col in columns:
        size = data.dictionary_size(col)
        if size is not None:
            card = size
        else:
            try:
                column = data.arrow.column(col)
                slices = [
                    column.slice(start, probe_rows)
                    for start in (0, (n - probe_rows) // 2, n - probe_rows)
                ]
                per_slice = [pc.count_distinct(s).as_py() for s in slices]
                union = pc.count_distinct(
                    pa.chunked_array([c for s in slices for c in s.chunks])
                ).as_py()
                if union > 1.5 * max(per_slice):
                    return False
                card = union
            except Exception:  # noqa: BLE001 - an unusual layout takes the device
                return False
        estimate *= max(card, 1)
        if estimate > limit:
            return False
    return True


def plan_table_scan(schema, columns: Sequence[str], num_rows: int, batch_rows: int,
                    freq_table_slots: int = DEFAULT_FREQ_TABLE_SLOTS,
                    freq_buffer_entries: int = DEFAULT_FREQ_BUFFER_ENTRIES,
                    ) -> Optional[DeviceFrequencyTableScan]:
    """Size a :class:`DeviceFrequencyTableScan` for one grouping set, or
    None when a column's kind derives no 64-bit key or the set has more
    columns than one ``freq_keys`` launch takes; the reference's planner
    (deequ_tpu/analyzers/grouping.py:1096) for one device. When every
    padded batch of the run fits the buffer (cap ``freq_buffer_entries``,
    rounded up to a power of two), the scan is resident with a minimal
    8-slot table that it never uses; otherwise the table has
    ``freq_table_slots`` slots (capped at the row count: it can then never
    overflow) and the buffer covers at least one padded batch."""
    if len(columns) > MAX_KEY_COLUMNS:
        return None
    kinds: List[str] = []
    for col in columns:
        kind = schema[col].kind
        if kind in (ColumnKind.INTEGRAL, ColumnKind.BOOLEAN):
            kinds.append(KEY_NUM)
        elif kind in (ColumnKind.FRACTIONAL, ColumnKind.STRING):
            kinds.append(KEY_HASH)
        else:
            return None
    slots = _next_pow2(min(int(freq_table_slots), max(int(num_rows), 1024)))
    batch_rows = max(int(batch_rows), 1)
    # every batch appends its padded length
    padded_rows = -(-max(int(num_rows), 1) // batch_rows) * batch_rows
    buffer_cap = _next_pow2(int(freq_buffer_entries))
    if padded_rows <= buffer_cap:
        return DeviceFrequencyTableScan(
            tuple(columns), tuple(kinds), 8, _next_pow2(max(padded_rows, batch_rows)),
            resident=True,
        )
    buffer_entries = _next_pow2(max(batch_rows, min(slots, 1 << 20, buffer_cap)))
    return DeviceFrequencyTableScan(tuple(columns), tuple(kinds), slots, buffer_entries)


class GroupingAnalyzer(Analyzer[FrequenciesAndNumRows, DoubleMetric]):
    """Analyzer computed from a shared frequency table."""

    columns: Sequence[str]

    def grouping_columns(self) -> List[str]:
        return list(self.columns)

    @property
    def instance(self) -> str:
        return ",".join(self.grouping_columns())

    @property
    def entity(self) -> Entity:
        return Entity.COLUMN if len(self.grouping_columns()) == 1 else Entity.MULTICOLUMN

    def preconditions(self) -> List[Callable[[Schema], None]]:
        cols = self.grouping_columns()
        out: List[Callable[[Schema], None]] = [Preconditions.at_least_one(cols)]
        for c in cols:
            out.append(Preconditions.has_column(c))
            out.append(Preconditions.is_not_nested(c))
        return out

    def merge(self, a: FrequenciesAndNumRows, b: FrequenciesAndNumRows) -> FrequenciesAndNumRows:
        return a.sum(b)


class ScanShareableFrequencyBasedAnalyzer(GroupingAnalyzer):
    """Base for analyzers that reduce the frequency table to a double
    (reference `GroupingAnalyzers.scala:85-123`)."""

    #: an EMPTY frequency table (e.g. every grouping value null) yields an
    #: empty metric: the reference's SUM aggregation over an empty relation
    #: returns null -> EmptyStateException (`NullHandlingTests.scala`).
    #: CountDistinct overrides this — COUNT over an empty relation is 0.
    empty_frequencies_are_empty_metric: bool = True

    def compute_metric_from(self, state: Optional[FrequenciesAndNumRows]) -> DoubleMetric:
        if state is None:
            return metric_from_empty(self.name, self.instance, self.entity)
        if self.empty_frequencies_are_empty_metric and state.is_empty():
            return metric_from_empty(self.name, self.instance, self.entity)
        try:
            value = self.metric_from_frequencies(state)
        except Exception as exc:  # noqa: BLE001
            return metric_from_failure(wrap_if_necessary(exc), self.name, self.instance, self.entity)
        if value is None or (isinstance(value, float) and math.isnan(value)):
            return metric_from_empty(self.name, self.instance, self.entity)
        return metric_from_value(float(value), self.name, self.instance, self.entity)

    @abc.abstractmethod
    def metric_from_frequencies(self, state: FrequenciesAndNumRows) -> float:
        ...


@dataclass(frozen=True)
class Uniqueness(ScanShareableFrequencyBasedAnalyzer):
    """Fraction of rows whose group occurs exactly once: sum(count==1)/numRows
    (reference `analyzers/Uniqueness.scala:26-38`)."""

    columns: Tuple[str, ...] = ()
    name: str = field(default="Uniqueness", init=False)

    def __init__(self, columns):
        object.__setattr__(self, "columns", _as_tuple(columns))

    def metric_from_frequencies(self, state: FrequenciesAndNumRows) -> float:
        if state.num_rows == 0:
            return float("nan")
        return float(state.stream_summary()[1]) / state.num_rows


@dataclass(frozen=True)
class Distinctness(ScanShareableFrequencyBasedAnalyzer):
    """Fraction of distinct groups over rows: sum(count>=1)/numRows
    (reference `analyzers/Distinctness.scala:29-41`)."""

    columns: Tuple[str, ...] = ()
    name: str = field(default="Distinctness", init=False)

    def __init__(self, columns):
        object.__setattr__(self, "columns", _as_tuple(columns))

    def metric_from_frequencies(self, state: FrequenciesAndNumRows) -> float:
        if state.num_rows == 0:
            return float("nan")
        return float(state.num_distinct()) / state.num_rows


@dataclass(frozen=True)
class UniqueValueRatio(ScanShareableFrequencyBasedAnalyzer):
    """sum(count==1) / number of distinct groups
    (reference `analyzers/UniqueValueRatio.scala:25-44`)."""

    columns: Tuple[str, ...] = ()
    name: str = field(default="UniqueValueRatio", init=False)

    def __init__(self, columns):
        object.__setattr__(self, "columns", _as_tuple(columns))

    def metric_from_frequencies(self, state: FrequenciesAndNumRows) -> float:
        num_groups, singletons, _, _ = state.stream_summary()
        if num_groups == 0:
            return float("nan")
        return float(singletons) / num_groups


@dataclass(frozen=True)
class CountDistinct(ScanShareableFrequencyBasedAnalyzer):
    """Number of distinct groups (reference `analyzers/CountDistinct.scala:24-40`)."""

    columns: Tuple[str, ...] = ()
    name: str = field(default="CountDistinct", init=False)
    empty_frequencies_are_empty_metric = False  # COUNT of no groups is 0.0

    def __init__(self, columns):
        object.__setattr__(self, "columns", _as_tuple(columns))

    def metric_from_frequencies(self, state: FrequenciesAndNumRows) -> float:
        return float(state.num_distinct())


@dataclass(frozen=True)
class Entropy(ScanShareableFrequencyBasedAnalyzer):
    """Shannon entropy over the value distribution, with N = total row count:
    -sum (c/N) ln(c/N) (reference `analyzers/Entropy.scala:28-42`)."""

    columns: Tuple[str, ...] = ()
    name: str = field(default="Entropy", init=False)

    def __init__(self, column):
        object.__setattr__(self, "columns", _as_tuple(column))

    def metric_from_frequencies(self, state: FrequenciesAndNumRows) -> float:
        n = state.num_rows
        if n == 0:
            return float("nan")
        # -sum (c/n) ln(c/n) = ln(n) * sum(c)/n - sum(c ln c)/n
        _, _, total, c_ln_c = state.stream_summary()
        return float(math.log(n) * total / n - c_ln_c / n)


def _as_tuple(columns) -> Tuple[str, ...]:
    if isinstance(columns, str):
        return (columns,)
    return tuple(columns)


def _java_double_to_string(x: float) -> str:
    """Java ``Double.toString`` semantics: shortest round-trip digits,
    plain decimal for 1e-3 <= |x| < 1e7, otherwise computerized scientific
    notation ``d.dddEn`` (no '+', no leading exponent zeros). Spark's
    cast-to-string on DoubleType delegates to this, so Histogram bin keys
    must match it exactly (e.g. 1e7 keys as '1.0E7', not '10000000.0')."""
    if math.isnan(x):
        return "NaN"
    if math.isinf(x):
        return "Infinity" if x > 0 else "-Infinity"
    if x == 0.0:
        return "-0.0" if math.copysign(1.0, x) < 0 else "0.0"
    sign = "-" if x < 0 else ""
    a = abs(x)
    if 1e-3 <= a < 1e7:
        # Python repr is also shortest-round-trip and stays in plain
        # decimal over exactly this range
        return sign + repr(a)
    # normalize shortest-round-trip digits to d.ddd * 10^dec_exp
    r = repr(a)
    if "e" in r:
        mant, _, exp_s = r.partition("e")
        digits = mant.replace(".", "")
        dec_exp = int(exp_s)
    else:
        int_part, _, frac = r.partition(".")
        if int_part != "0":
            digits = (int_part + frac).lstrip("0")
            dec_exp = len(int_part) - 1
        else:
            stripped = frac.lstrip("0")
            digits = stripped
            dec_exp = -(len(frac) - len(stripped) + 1)
    digits = digits.rstrip("0") or "0"
    mantissa = digits[0] + "." + (digits[1:] or "0")
    return f"{sign}{mantissa}E{dec_exp}"


def _spark_string_cast(value) -> str:
    """Format a value the way Spark's cast-to-string would (booleans
    lowercase, doubles via Java ``Double.toString``)."""
    if isinstance(value, (bool, np.bool_)):
        return "true" if value else "false"
    if isinstance(value, (float, np.floating)):
        return _java_double_to_string(float(value))
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    return str(value)


def device_counts_to_histogram_frequencies(
    scan: DeviceFrequencyScan, state: FrequencyCountsState, dictionary: np.ndarray
) -> FrequenciesAndNumRows:
    """Device frequency counts -> the Histogram state shape: keys become
    their Spark string casts and null rows land in the NullValue bin."""
    counts = state.counts.cpu().numpy()
    nz = np.flatnonzero(counts)
    keys = [_spark_string_cast(v) for v in np.asarray(dictionary)[nz]]
    series = pd.Series(counts[nz].astype(np.int64), index=keys)
    if series.index.has_duplicates:
        series = series.groupby(level=0, sort=False).sum()
    num_rows = int(state.num_rows)
    series = _with_null_bin(series, num_rows - int(counts.sum()))
    return FrequenciesAndNumRows(series.astype(np.int64), num_rows, [scan.column])


NULL_FIELD_REPLACEMENT = "NullValue"  # reference `analyzers/Histogram.scala:108`
MAXIMUM_ALLOWED_DETAIL_BINS = 1000  # reference `analyzers/Histogram.scala:109`


@dataclass(frozen=True)
class Histogram(Analyzer[FrequenciesAndNumRows, HistogramMetric]):
    """Exact value histogram of one dictionary-encoded column: values cast
    to string, nulls replaced by "NullValue", top-K detail bins by count
    (reference `analyzers/Histogram.scala:41-116`). Its counts come from the
    device frequency scan. The fields are the JAX reference's, in its order
    (so reprs, equality and persisted state keys agree); a ``binning_func``
    is the reference's non-dictionary path, which the runner does not run
    yet (it raises, naming ROADMAP A1c)."""

    column: str = ""
    binning_func: Optional[Callable] = None
    max_detail_bins: int = MAXIMUM_ALLOWED_DETAIL_BINS
    name: str = field(default="Histogram", init=False)

    @property
    def instance(self) -> str:
        return self.column

    @property
    def entity(self) -> Entity:
        return Entity.COLUMN

    def preconditions(self) -> List[Callable[[Schema], None]]:
        def param_check(schema: Schema) -> None:
            if self.max_detail_bins > MAXIMUM_ALLOWED_DETAIL_BINS:
                raise IllegalAnalyzerParameterException(
                    f"Cannot return histogram values for more than "
                    f"{MAXIMUM_ALLOWED_DETAIL_BINS} values"
                )

        return [param_check, Preconditions.has_column(self.column)]

    def merge(self, a: FrequenciesAndNumRows, b: FrequenciesAndNumRows) -> FrequenciesAndNumRows:
        return a.sum(b)

    def compute_metric_from(self, state: Optional[FrequenciesAndNumRows]) -> HistogramMetric:
        if state is None:
            return HistogramMetric(
                self.entity,
                self.name,
                self.instance,
                Failure(EmptyStateException(f"Empty state for analyzer {self}")),
                self.column,
            )
        try:
            top = state.frequencies.nlargest(self.max_detail_bins)
            values = {
                str(k): DistributionValue(int(v), int(v) / state.num_rows)
                for k, v in top.items()
            }
            dist = Distribution(values, number_of_bins=state.num_distinct())
            return HistogramMetric(self.entity, self.name, self.instance, Success(dist), self.column)
        except Exception as exc:  # noqa: BLE001
            return HistogramMetric(
                self.entity, self.name, self.instance, Failure(wrap_if_necessary(exc)), self.column
            )
