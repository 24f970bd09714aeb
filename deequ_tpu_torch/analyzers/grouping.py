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

A set with a member that reads the table's keys (MutualInformation) takes
the host group-by, and a Histogram the device frequency scan cannot take
(a plain column, a binning function) folds its own host table
(:meth:`Histogram.host_update`). Host tables spill to
disk above ``DEEQU_TPU_MAX_FREQUENCY_ENTRIES`` entries (:class:`_SpillStore`).

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
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from ..config import (
    DEFAULT_FREQ_BUFFER_ENTRIES,
    DEFAULT_FREQ_TABLE_SLOTS,
    DEVICE_FREQ_ENV,
    FREQ_HOST_ROUTE_ENV,
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

#: optional cap on a frequency table's resident entries (0 = none): above
#: it the table spills to disk, or with spilling off the run fails with
#: :class:`FrequencyBudgetExceeded` (a failure metric, not an OOM). The
#: reference package's names, read the same way.
FREQ_BUDGET_ENV = "DEEQU_TPU_MAX_FREQUENCY_ENTRIES"
#: "0" turns spilling off and restores the hard budget failure
FREQ_SPILL_ENV = "DEEQU_TPU_FREQUENCY_SPILL"
#: the number of hash partitions a spilled table is scattered over
FREQ_SPILL_PARTITIONS_ENV = "DEEQU_TPU_FREQUENCY_SPILL_PARTITIONS"
_DEFAULT_SPILL_PARTITIONS = 64


class FrequencyBudgetExceeded(RuntimeError):
    """A table's distinct groups crossed ``DEEQU_TPU_MAX_FREQUENCY_ENTRIES``
    with spilling off, or a spilled table was asked for all of itself."""


class _SpillStore:
    """Hash-partitioned spill files of an over-budget frequency table (the
    reference package's ``_SpillStore``, deequ_tpu/analyzers/grouping.py:75;
    the analog of Spark's shuffle spill, `GroupingAnalyzers.scala:53-80`).

    Every spill scatters the resident table over P partitions by a stable
    hash of its keys and appends one parquet run file per non-empty
    partition. A key lives in one partition, so a partition's runs summed
    give the final counts of its keys, with ~1/P of the table in memory."""

    #: column names inside the spill files (user columns may be named
    #: anything, "count" included)
    _COUNT = "__deequ_count__"

    def __init__(self, group_columns: Sequence[str]):
        import shutil
        import tempfile
        import weakref

        from ..utils import env_number

        self.group_columns = list(group_columns)
        self._key_cols = [f"__deequ_key{i}__" for i in range(len(self.group_columns))]
        self.partitions = env_number(
            FREQ_SPILL_PARTITIONS_ENV, _DEFAULT_SPILL_PARTITIONS, int, minimum=1
        )
        self.dir = tempfile.mkdtemp(prefix="deequ-tpu-freq-spill-")
        self._runs = 0
        self.entries_spilled = 0
        self._finalizer = weakref.finalize(self, shutil.rmtree, self.dir, True)

    def close(self) -> None:
        """Remove the spill directory now (idempotent); the GC finalizer is
        the backstop."""
        self._finalizer()

    def _partition_of(self, frame: pd.DataFrame) -> np.ndarray:
        """Each row's partition, from a stable hash of its key columns."""
        codes = pd.util.hash_pandas_object(frame[self._key_cols], index=False).to_numpy()
        return (codes % np.uint64(self.partitions)).astype(np.int64)

    def _to_frame(self, counts: pd.Series) -> pd.DataFrame:
        return counts.rename(self._COUNT).rename_axis(self._key_cols).reset_index()

    def _check_open(self) -> None:
        if not self._finalizer.alive:
            raise RuntimeError(
                "frequency spill store was closed; its partition files are "
                "gone — serving from it would silently drop counts"
            )

    def append(self, counts: pd.Series) -> None:
        """Scatter one resident table over the hash partitions."""
        import os

        self._check_open()
        if len(counts) == 0:
            return
        frame = self._to_frame(counts)
        part_of = self._partition_of(frame)
        run = self._runs
        self._runs += 1
        for p in np.unique(part_of):
            sub = frame.iloc[np.flatnonzero(part_of == p)]
            pdir = os.path.join(self.dir, f"part{p:05d}")
            os.makedirs(pdir, exist_ok=True)
            sub.to_parquet(os.path.join(pdir, f"run{run:05d}.parquet"), index=False)
        self.entries_spilled += len(counts)

    def iter_partition_counts(self, extra: Optional[pd.Series] = None) -> Iterator[pd.Series]:
        """One final count Series per partition (every key exactly once
        over all of them); ``extra`` is a resident table not yet spilled,
        hashed the same way."""
        import os

        self._check_open()
        extra_parts: Dict[int, pd.Series] = {}
        if extra is not None and len(extra):
            part_of = self._partition_of(self._to_frame(extra))
            for p in np.unique(part_of):
                extra_parts[int(p)] = extra.iloc[np.flatnonzero(part_of == p)]
        for p in range(self.partitions):
            pdir = os.path.join(self.dir, f"part{p:05d}")
            pieces: List[pd.Series] = []
            if os.path.isdir(pdir):
                for name in sorted(os.listdir(pdir)):
                    frame = pd.read_parquet(os.path.join(pdir, name))
                    series = frame.set_index(self._key_cols)[self._COUNT]
                    if len(self._key_cols) == 1 and isinstance(series.index, pd.MultiIndex):
                        series.index = series.index.get_level_values(0)
                    # the user's level names, for the consumers that read
                    # keys (Histogram, MutualInformation's marginals)
                    series = series.rename_axis(
                        self.group_columns if len(self.group_columns) > 1
                        else self.group_columns[0]
                    )
                    pieces.append(series)
            if p in extra_parts:
                pieces.append(extra_parts[p])
            if not pieces:
                continue
            if len(pieces) == 1:
                yield pieces[0].astype(np.int64)
                continue
            cat = pd.concat(pieces)
            levels = (
                list(range(cat.index.nlevels)) if isinstance(cat.index, pd.MultiIndex) else 0
            )
            yield cat.groupby(level=levels, sort=False, dropna=False).sum().astype(np.int64)


class FrequenciesAndNumRows:
    """Host state: group -> count plus total row count
    (reference `GroupingAnalyzers.scala:128-157`).

    Built once from the device dictionary counts, or batch by batch by the
    host group-by (:meth:`update`), whose per-batch count runs buffer in a
    list and merge with one concat + groupby once they outweigh the merged
    table. Under a ``DEEQU_TPU_MAX_FREQUENCY_ENTRIES`` budget a table that
    outgrows it spills to hash-partitioned files (:class:`_SpillStore`) and
    serves its reductions by streaming them (:meth:`iter_merged_chunks`),
    as the reference package's accumulator does."""

    def __init__(self, frequencies: pd.Series, num_rows: int, group_columns: Sequence[str]):
        self._merged = frequencies  # index = group keys (tuples for several columns)
        self._runs: List[pd.Series] = []
        self._buffered = 0
        self._spill: Optional[_SpillStore] = None
        self._summary: Optional[Tuple[int, int, int, float]] = None
        self.num_rows = int(num_rows)
        self.group_columns = list(group_columns)

    @property
    def spilled(self) -> bool:
        """True once the table crossed the budget and lives (partly) in
        spill files."""
        return self._spill is not None

    @property
    def frequencies(self) -> pd.Series:
        """The merged frequency table (flushes buffered runs). A spilled
        table refuses to materialize: the consumers that need all of it at
        once (persistence, the incremental merge) fail with
        :class:`FrequencyBudgetExceeded`."""
        self._flush()
        if self._spill is not None:
            raise FrequencyBudgetExceeded(
                f"frequency table for {self.group_columns} spilled "
                f"{self._spill.entries_spilled} entries to disk under the "
                f"{FREQ_BUDGET_ENV} budget; full-table materialization is "
                "not available (set a larger budget, or use a streaming "
                "consumer)"
            )
        return self._merged

    def iter_merged_chunks(self) -> Iterator[pd.Series]:
        """Final count chunks, each group in exactly one: the table itself
        when it did not spill, else one chunk per hash partition."""
        self._flush()
        if self._spill is None:
            if len(self._merged):
                yield self._merged
            return
        yield from self._spill.iter_partition_counts(
            self._merged if len(self._merged) else None
        )

    def num_distinct(self) -> int:
        self._flush()  # may spill
        if self._spill is None:
            return len(self._merged)
        return self.stream_summary()[0]

    def stream_summary(self) -> Tuple[int, int, int, float]:
        """(num_distinct, singleton_count, sum(count), sum(count*ln(count))),
        in one streaming pass over the chunks and cached — every scalar
        frequency reduction (Uniqueness, Distinctness, UniqueValueRatio,
        CountDistinct, Entropy) reads these. The count-of-counts histogram
        is gathered chunk by chunk and reduced as :func:`_sum_c_ln_c`
        reduces it, so every chunking gives the same Entropy bit for bit."""
        if self._summary is None:
            nd = singles = total = 0
            hist: Dict[int, int] = {}
            for chunk in self.iter_merged_chunks():
                c = chunk.to_numpy(dtype=np.int64)
                nd += len(c)
                singles += int((c == 1).sum())
                total += int(c.sum())
                uc, mult = np.unique(c[c > 0], return_counts=True)
                for v, m in zip(uc.tolist(), mult.tolist()):
                    hist[v] = hist.get(v, 0) + int(m)
            uc = np.fromiter(sorted(hist), np.int64, count=len(hist))
            mult = np.array([hist[int(v)] for v in uc], dtype=np.int64)
            self._summary = (nd, singles, total, _reduce_count_histogram(uc, mult))
        return self._summary

    def is_empty(self) -> bool:
        self._flush()  # may spill
        if self._spill is not None:
            return False  # a spilled table crossed the budget
        return len(self._merged) == 0

    @staticmethod
    def _budget() -> int:
        from ..utils import env_number

        return env_number(FREQ_BUDGET_ENV, 0, int, minimum=0)

    @staticmethod
    def _spill_enabled() -> bool:
        from ..utils import env_flag

        return env_flag(FREQ_SPILL_ENV, True)

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
        budget = self._budget()
        if budget and len(merged) > budget:
            if not self._spill_enabled():
                raise FrequencyBudgetExceeded(
                    f"frequency table for {self.group_columns} holds {len(merged)} "
                    f"distinct groups, over the {FREQ_BUDGET_ENV}={budget} budget"
                )
            # over budget: scatter the resident table to the spill files
            if self._spill is None:
                self._spill = _SpillStore(self.group_columns)
            self._spill.append(merged)
            merged = pd.Series([], dtype=np.int64)
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

    def close(self) -> None:
        """Remove the spill directory now (idempotent; nothing to do when
        nothing spilled). A closed spilled table refuses to serve."""
        if self._spill is not None:
            self._spill.close()

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
    return _reduce_count_histogram(uc, mult)


def _reduce_count_histogram(uc: np.ndarray, mult: np.ndarray) -> float:
    """The canonical reduction: ``uc`` the ascending count values, ``mult``
    their multiplicities."""
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
        from ..config import COUNT_DTYPE

        counts = ctx.dict_code_counts(self.column)[: self.num_categories]
        return FrequencyCountsState(
            torch.from_numpy(np.ascontiguousarray(counts, dtype=np.int64)).to(COUNT_DTYPE),
            torch.tensor(ctx.batch.num_rows, dtype=COUNT_DTYPE),
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


#: warn-once latches of the two on/off switches (a typo never crashes a
#: run and never floods the log)
_ENV_WARNED: set = set()


def _switch(env: str, what: str) -> Optional[str]:
    """An on/off switch's raw value: None when unset or invalid (an
    invalid value warns once and counts as unset)."""
    import logging
    import os

    raw = os.environ.get(env)
    if raw is None or raw in ("0", "1"):
        return raw
    if env not in _ENV_WARNED:
        _ENV_WARNED.add(env)
        logging.getLogger(__name__).warning(
            "ignoring invalid %s=%r (expected 0 or 1); %s stays enabled", env, raw, what,
        )
    return None


def device_freq_max_cardinality() -> int:
    """The largest dictionary whose grouping counts on ``dict_code_counts``
    (the tuning registry's value: env override > tuned > static)."""
    from ..tuning import knobs

    return knobs.value("device_freq_max_cardinality")


def freq_table_slots() -> int:
    """The device frequency table's distinct-group capacity (registry)."""
    from ..tuning import knobs

    return knobs.value("freq_table_slots")


def freq_buffer_entries() -> int:
    """The device frequency table's raw-key buffer cap, the resident
    ceiling (registry)."""
    from ..tuning import knobs

    return knobs.value("freq_buffer_entries")


def device_freq_enabled() -> bool:
    """``DEEQU_TPU_DEVICE_FREQ``: "0" keeps every grouping set that is
    not a small dictionary column off the device frequency table."""
    return _switch(DEVICE_FREQ_ENV, "the device frequency engine") != "0"


def probably_low_cardinality(data, columns: Sequence[str],
                             limit: Optional[int] = None) -> bool:
    """True when every column of the grouping set confidently looks
    low-cardinality (the product of the per-column distinct estimates at
    most ``limit``, by default the ``freq_host_route_max_distinct`` knob),
    so the host group-by serves it; the reference's probe
    (deequ_tpu/analyzers/grouping.py:1022). A dictionary column counts its
    dictionary; any other column counts the distinct values of head,
    middle and tail slices of ``freq_probe_rows`` rows, and a layout whose
    later slices keep revealing new keys answers False. Runs of at most
    ``freq_host_route_min_rows`` rows always answer False, and so does
    every set under ``DEEQU_TPU_FREQ_HOST_ROUTE=0``."""
    import pyarrow as pa
    import pyarrow.compute as pc

    from ..tuning import knobs

    if _switch(FREQ_HOST_ROUTE_ENV, "cardinality pre-routing") == "0":
        return False
    if limit is None:
        limit = knobs.value("freq_host_route_max_distinct")
    probe_rows = knobs.value("freq_probe_rows")
    n = int(data.num_rows)
    if n <= knobs.value("freq_host_route_min_rows"):
        return False
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
                    sharded: bool = False) -> Optional[DeviceFrequencyTableScan]:
    """Size a :class:`DeviceFrequencyTableScan` for one grouping set, or
    None when a column's kind derives no 64-bit key or the set has more
    columns than one ``freq_keys`` launch takes; the reference's planner
    (deequ_tpu/analyzers/grouping.py:1096) for one device. When every
    padded batch of the run fits the buffer (cap ``freq_buffer_entries``,
    rounded up to a power of two), the scan is resident with a minimal
    8-slot table that it never uses; otherwise the table has
    ``freq_table_slots`` slots (capped at the row count: it can then never
    overflow) and the buffer covers at least one padded batch.

    ``sharded`` (a run over a mesh) gives the same plan. The reference
    keeps no table per shard either: its sharded update runs with
    replicated states, so a set's table on a mesh is one global table; the
    port's is one table on the mesh's first device, fed the whole batch,
    with the same answers. The reference gives a sharded resident plan
    the full ``slots`` table, meant for a compaction at the collective
    merge; that merge never receives a device table scan (it has no host
    partial), and a resident scan's drain reads its buffer alone, so no
    path reads the table and the port keeps the 8-slot one."""
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


@dataclass(frozen=True)
class MutualInformation(GroupingAnalyzer):
    """Mutual information of two columns from their joint frequency table
    (reference `analyzers/MutualInformation.scala:35-103`; the JAX
    package's deequ_tpu/analyzers/grouping.py:1298). It reads the table's
    keys, so its set never takes the hashed device frequency table.

    The marginals keep NaN keys and are looked up by position, so a NaN
    or boolean column has its mutual information; the JAX package's
    label lookups fail on both (a NaN key is dropped from its marginal, a
    boolean key array indexes as a mask)."""

    columns: Tuple[str, ...] = ()
    name: str = field(default="MutualInformation", init=False)

    def __init__(self, columns):
        object.__setattr__(self, "columns", _as_tuple(columns))

    @property
    def entity(self) -> Entity:
        return Entity.MULTICOLUMN

    def preconditions(self) -> List[Callable[[Schema], None]]:
        return [Preconditions.exactly_n_columns(self.columns, 2)] + super().preconditions()

    def compute_metric_from(self, state: Optional[FrequenciesAndNumRows]) -> DoubleMetric:
        if state is None or state.is_empty():
            return metric_from_empty(self.name, self.instance, self.entity)
        try:
            total = state.num_rows
            # two streaming passes over the joint table: the marginals, then
            # the sum (a spilled joint table completes while its marginals
            # fit in memory)
            px: Optional[pd.Series] = None
            py: Optional[pd.Series] = None
            for joint in state.iter_merged_chunks():
                cx = joint.groupby(level=0, dropna=False).sum()
                cy = joint.groupby(level=1, dropna=False).sum()
                px = cx if px is None else px.add(cx, fill_value=0)
                py = cy if py is None else py.add(cy, fill_value=0)
            value = 0.0
            for joint in state.iter_merged_chunks():
                pxy = joint.to_numpy(dtype=np.float64) / total
                px_row = _marginal_at(px, joint.index.get_level_values(0)) / total
                py_row = _marginal_at(py, joint.index.get_level_values(1)) / total
                value += float((pxy * np.log(pxy / (px_row * py_row))).sum())
        except Exception as exc:  # noqa: BLE001
            return metric_from_failure(wrap_if_necessary(exc), self.name, self.instance,
                                       self.entity)
        return metric_from_value(value, self.name, self.instance, self.entity)


def _marginal_at(marginal: pd.Series, keys) -> np.ndarray:
    """The marginal counts of ``keys``, by position (NaN keys included)."""
    at = marginal.index.get_indexer(keys)
    if (at < 0).any():
        raise KeyError(f"{int((at < 0).sum())} joint keys missing from a marginal")
    return marginal.to_numpy(dtype=np.float64)[at]


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
    """Exact value histogram of one column: values cast to string, nulls
    replaced by "NullValue", an optional binning function, top-K detail
    bins by count (reference `analyzers/Histogram.scala:41-116`). The fields
    are the JAX reference's, in its order (so reprs, equality and persisted
    state keys agree). A dictionary column without a binning function is
    counted by the device frequency scan; every other histogram folds its
    batches on the host (:meth:`host_update`, the reference package's
    deequ_tpu/analyzers/grouping.py:1464-1570).

    ``binning_func`` must be a pure ``value -> bin`` mapping: it is applied
    once per distinct value, not once per row (the reference's binning UDF,
    `analyzers/Histogram.scala:63-66`, makes the same assumption).
    Returning ``None`` puts the value in the "NullValue" bin."""

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

    # the host accumulation, folded batch by batch in the runner's pass

    def host_init(self) -> FrequenciesAndNumRows:
        return FrequenciesAndNumRows.empty([self.column])

    def host_update(self, state: FrequenciesAndNumRows, batch: Batch) -> FrequenciesAndNumRows:
        """Fold one batch (a dictionary column without a binning function
        takes the device frequency scan instead, so it never arrives here)."""
        col = batch.column(self.column)
        mask = batch.row_mask
        if self.binning_func is None and col.arrow is not None and mask.all():
            # Arrow-backed strings: Arrow's value counts; a string key is
            # its own string cast
            counts = _arrow_value_counts(col.arrow)
            if counts is not None:
                state._append_run(_with_null_bin(counts, int(col.arrow.null_count)))
                state.num_rows += batch.num_rows
                return state
        values = col.values[mask]
        present = col.mask[mask]
        # count the present values first and cast (or bin) each distinct
        # value once; nullness comes from the validity mask, never from the
        # value (a float NaN keys as 'NaN', a null as NullValue)
        present_values = values[present]
        if present_values.dtype == object:
            vc = pd.Series(present_values).value_counts(sort=False, dropna=False)
            distinct, cnts = list(vc.index), vc.to_numpy()
        else:
            distinct, cnts = np.unique(present_values, return_counts=True)
        if self.binning_func is None:
            keys = [_spark_string_cast(k) for k in distinct]
        else:
            keys = []
            for v in distinct:
                b = self.binning_func(v)
                keys.append(_spark_string_cast(b) if b is not None else NULL_FIELD_REPLACEMENT)
        counts = pd.Series(cnts, index=keys, dtype=np.int64).groupby(level=0, sort=False).sum()
        counts = _with_null_bin(counts, int(len(values) - present.sum()))
        state._append_run(counts.astype(np.int64))
        state.num_rows += batch.num_rows
        return state

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
            # top bins over the streamed chunks (one chunk unless spilled)
            bin_count = 0
            top: Optional[pd.Series] = None
            for chunk in state.iter_merged_chunks():
                bin_count += len(chunk)
                cand = chunk.nlargest(self.max_detail_bins)
                top = cand if top is None else pd.concat([top, cand]).nlargest(
                    self.max_detail_bins
                )
            if top is None:
                top = pd.Series([], dtype=np.int64)
            values = {
                str(k): DistributionValue(int(v), int(v) / state.num_rows)
                for k, v in top.items()
            }
            dist = Distribution(values, number_of_bins=bin_count)
            return HistogramMetric(self.entity, self.name, self.instance, Success(dist), self.column)
        except Exception as exc:  # noqa: BLE001
            return HistogramMetric(
                self.entity, self.name, self.instance, Failure(wrap_if_necessary(exc)), self.column
            )
