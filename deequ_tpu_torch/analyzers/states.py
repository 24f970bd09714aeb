"""Analyzer states: dataclasses of tensors with a semigroup merge.

Each mirrors a state of the JAX reference (deequ_tpu/analyzers/states.py)
with the SAME class name and field order, so the reference's flattened
state leaves map one to one onto these fields (see ``convert.py``). Leaves
are 0-d or 1-d tensors on the run's device; ``merge`` is plain tensor
arithmetic on that device, and the metric helpers read host values.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np
import torch

from ..config import ACC_DTYPE, COUNT_DTYPE
from ..ops.kll import KLLSketchState  # noqa: F401 - the KLL analyzers' state
from ..ops.order import max_nan, min_nan_largest


def _f(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=ACC_DTYPE, device=device)


def _i(x: int, device) -> torch.Tensor:
    return torch.tensor(x, dtype=COUNT_DTYPE, device=device)


def tensor_fields(state) -> List[dataclasses.Field]:
    """The state's tensor fields in order. A field marked
    ``metadata={"static": True}`` (a sketch size, a constant) is
    configuration, not a leaf, as a non-pytree field is in the reference."""
    return [f for f in dataclasses.fields(state) if not f.metadata.get("static")]


def leaves(state) -> List[torch.Tensor]:
    """The state's tensors in field order (the reference's leaf order)."""
    return [getattr(state, f.name) for f in tensor_fields(state)]


def with_leaves(state, tensors: Sequence[torch.Tensor]):
    """A state of the same class and static fields with these tensors."""
    return dataclasses.replace(
        state, **{f.name: t for f, t in zip(tensor_fields(state), tensors)}
    )


@dataclass
class FrequencyCountsState:
    """Dense per-category counts for the device frequency path (dictionary-
    encoded grouping columns): counts[i] = rows whose code is i, plus the
    total row count the frequency semantics require (reference
    `GroupingAnalyzers.scala:53-80`: numRows counts ALL rows)."""

    counts: torch.Tensor    # int64[num_categories]
    num_rows: torch.Tensor  # int64

    @staticmethod
    def init(num_categories: int, device) -> "FrequencyCountsState":
        return FrequencyCountsState(
            torch.zeros(num_categories, dtype=COUNT_DTYPE, device=device), _i(0, device)
        )

    def merge(self, other: "FrequencyCountsState") -> "FrequencyCountsState":
        return FrequencyCountsState(
            self.counts + other.counts, self.num_rows + other.num_rows
        )


@dataclass
class FrequencyTableState:
    """Frequency table of a grouping set of any cardinality (reference
    ``FrequencyTableState``, deequ_tpu/analyzers/states.py:59): a sorted
    table of (key, count) pairs, ``slots`` long and sentinel-padded, plus a
    buffer of raw per-row 64-bit group keys. Keys are uint64 values held in
    int64 tensors (PyTorch has few uint64 operations); ``convert.py`` views
    them as uint64 for the reference.

    Each batch writes its keys into the buffer at ``buf_fill`` (kernel
    ``freq_keys``, in place: the buffer belongs to the state's lineage, and
    a pass keeps only the newest state). When a batch would overrun the
    buffer, the buffer is first compacted into the table (kernel
    ``freq_compact``); groups beyond ``slots`` are dropped and counted in
    ``lost_groups`` / ``lost_rows``, and the runner then re-runs the set on
    the host. ``fill`` mirrors ``buf_fill`` on the host, from the batch
    lengths appended, so deciding to compact reads nothing back from the
    device."""

    sorted_keys: torch.Tensor    # int64[slots]: uint64 keys ascending, sentinel-padded
    sorted_counts: torch.Tensor  # int64[slots]
    n_table: torch.Tensor        # int64: occupied table entries
    buf: torch.Tensor            # int64[buffer_entries]: raw per-row keys
    buf_fill: torch.Tensor       # int64: appended entries (rows incl. masked)
    sent_rows: torch.Tensor      # int64: valid rows whose key is the sentinel
    lost_groups: torch.Tensor    # int64: groups dropped at compactions (upper bound)
    lost_rows: torch.Tensor      # int64: rows in dropped groups (exact)
    num_rows: torch.Tensor       # int64: ALL rows seen (grouping semantics)

    fill: int = field(default=0, metadata={"static": True})

    #: fields whose int64 bits are uint64 keys in the reference
    KEY_FIELDS = ("sorted_keys", "buf")

    @staticmethod
    def init(slots: int, buffer_entries: int, device) -> "FrequencyTableState":
        from ..ops.hashing import FREQ_KEY_SENTINEL_I64

        return FrequencyTableState(
            torch.full((slots,), FREQ_KEY_SENTINEL_I64, dtype=COUNT_DTYPE, device=device),
            torch.zeros(slots, dtype=COUNT_DTYPE, device=device),
            _i(0, device),
            torch.zeros(buffer_entries, dtype=COUNT_DTYPE, device=device),
            *(_i(0, device) for _ in range(5)),
        )

    @property
    def slots(self) -> int:
        return self.sorted_keys.shape[0]

    def _with_table(self, out, buf: torch.Tensor, sent_rows, lost_groups, lost_rows,
                    num_rows) -> "FrequencyTableState":
        slots = self.slots
        return FrequencyTableState(
            out.keys, out.counts, torch.clamp(out.n_unique, max=slots), buf,
            torch.zeros_like(self.buf_fill), sent_rows,
            lost_groups + torch.clamp(out.n_unique - slots, min=0),
            lost_rows + (out.total_rows - out.kept_rows), num_rows, fill=0,
        )

    def compacted(self, in_place: bool = False) -> "FrequencyTableState":
        """The buffer folded into the table (kernel ``freq_compact``), with
        an empty buffer: a zeroed copy, or with ``in_place`` this state's
        own buffer zeroed (the pass's in-batch compaction)."""
        from ..kernels.freq_compact import freq_compact

        out = freq_compact(self.sorted_keys, self.sorted_counts, self.buf[:self.fill], None,
                           self.slots)
        buf = self.buf.zero_() if in_place else torch.zeros_like(self.buf)
        return self._with_table(out, buf, self.sent_rows, self.lost_groups, self.lost_rows,
                                self.num_rows)

    def append_keys(self, columns, rows: torch.Tensor, assume_fits: bool = False
                    ) -> "FrequencyTableState":
        """Fold one batch: compact first when the batch would overrun the
        buffer (never with ``assume_fits``: the planner proved the buffer
        holds the run), then write the batch's keys at ``buf_fill`` (kernel
        ``freq_keys``). ``columns`` are the key's :class:`KeyColumn`\\ s."""
        from ..kernels.freq_keys import freq_keys

        batch = rows.shape[0]
        cap = self.buf.shape[0]
        if batch > cap:
            raise ValueError(
                f"frequency-table buffer holds {cap} entries but the batch carries "
                f"{batch} rows; size buffer_entries >= the padded batch size"
            )
        state = self
        if self.fill + batch > cap:
            if assume_fits:
                raise ValueError("a resident frequency table's buffer cannot hold the run")
            state = self.compacted(in_place=True)
        counts = freq_keys(columns, rows, state.buf, state.fill)
        return dataclasses.replace(
            state, buf_fill=state.buf_fill + batch, sent_rows=state.sent_rows + counts[0],
            num_rows=state.num_rows + counts[1], fill=state.fill + batch,
        )

    def merge(self, other: "FrequencyTableState") -> "FrequencyTableState":
        from ..kernels.freq_compact import freq_compact

        a, b = self.compacted(), other.compacted()
        out = freq_compact(a.sorted_keys, a.sorted_counts, b.sorted_keys, b.sorted_counts,
                           a.slots)
        return a._with_table(
            out, a.buf, a.sent_rows + b.sent_rows, a.lost_groups + b.lost_groups,
            a.lost_rows + b.lost_rows, a.num_rows + b.num_rows,
        )


@dataclass
class NumMatches:
    """Row-count state (reference `analyzers/Size.scala:23-29`)."""

    num_matches: torch.Tensor

    @staticmethod
    def init(device) -> "NumMatches":
        return NumMatches(_i(0, device))

    def merge(self, other: "NumMatches") -> "NumMatches":
        return NumMatches(self.num_matches + other.num_matches)

    def metric_value(self) -> float:
        return float(self.num_matches)


@dataclass
class NumMatchesAndCount:
    """Ratio state (reference `analyzers/Analyzer.scala:438-449`)."""

    num_matches: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def init(device) -> "NumMatchesAndCount":
        return NumMatchesAndCount(_i(0, device), _i(0, device))

    def merge(self, other: "NumMatchesAndCount") -> "NumMatchesAndCount":
        return NumMatchesAndCount(
            self.num_matches + other.num_matches, self.count + other.count
        )

    def metric_value(self) -> float:
        count = float(self.count)
        if count == 0:
            return float("nan")
        return float(self.num_matches) / count


@dataclass
class MeanState:
    """(sum, count) (reference `analyzers/Mean.scala:25-35`)."""

    total: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def init(device) -> "MeanState":
        return MeanState(_f(0.0, device), _i(0, device))

    def merge(self, other: "MeanState") -> "MeanState":
        return MeanState(self.total + other.total, self.count + other.count)

    def metric_value(self) -> float:
        count = float(self.count)
        if count == 0:
            return float("nan")
        return float(self.total) / count


@dataclass
class SumState:
    """(sum) plus a count used only for emptiness detection
    (reference `analyzers/Sum.scala:25-33`)."""

    total: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def init(device) -> "SumState":
        return SumState(_f(0.0, device), _i(0, device))

    def merge(self, other: "SumState") -> "SumState":
        return SumState(self.total + other.total, self.count + other.count)

    def metric_value(self) -> float:
        return float(self.total)


@dataclass
class MinState:
    """(reference `analyzers/Minimum.scala:25-33`)."""

    min_value: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def init(device) -> "MinState":
        # NaN is the identity (top) element of the NaN-largest min order
        return MinState(_f(math.nan, device), _i(0, device))

    def merge(self, other: "MinState") -> "MinState":
        return MinState(
            min_nan_largest(self.min_value, other.min_value),
            self.count + other.count,
        )

    def metric_value(self) -> float:
        return float(self.min_value)


@dataclass
class MaxState:
    """(reference `analyzers/Maximum.scala:25-33`)."""

    max_value: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def init(device) -> "MaxState":
        return MaxState(_f(-math.inf, device), _i(0, device))

    def merge(self, other: "MaxState") -> "MaxState":
        return MaxState(max_nan(self.max_value, other.max_value), self.count + other.count)

    def metric_value(self) -> float:
        return float(self.max_value)


@dataclass
class StandardDeviationState:
    """Welford/Chan parallel-merge moments (n, avg, m2)
    (reference `analyzers/StandardDeviation.scala:25-50`)."""

    n: torch.Tensor
    avg: torch.Tensor
    m2: torch.Tensor

    @staticmethod
    def init(device) -> "StandardDeviationState":
        return StandardDeviationState(_f(0.0, device), _f(0.0, device), _f(0.0, device))

    def merge(self, other: "StandardDeviationState") -> "StandardDeviationState":
        return StandardDeviationState(*merge_moments(leaves(self), leaves(other)))

    def metric_value(self) -> float:
        n = float(self.n)
        if n == 0:
            return float("nan")
        return float(np.sqrt(float(self.m2) / n))


@dataclass
class CorrelationState:
    """Pairwise co-moment accumulators (n, xAvg, yAvg, ck, xMk, yMk)
    (reference `analyzers/Correlation.scala:26-60`)."""

    n: torch.Tensor
    x_avg: torch.Tensor
    y_avg: torch.Tensor
    ck: torch.Tensor
    x_mk: torch.Tensor
    y_mk: torch.Tensor

    @staticmethod
    def init(device) -> "CorrelationState":
        return CorrelationState(*(_f(0.0, device) for _ in range(6)))

    def merge(self, other: "CorrelationState") -> "CorrelationState":
        return CorrelationState(*merge_comoments(leaves(self), leaves(other)))

    def metric_value(self) -> float:
        if float(self.n) == 0:
            return float("nan")
        with np.errstate(divide="ignore", invalid="ignore"):
            return float(float(self.ck) / np.sqrt(float(self.x_mk) * float(self.y_mk)))


def merge_moments(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Chan's rule on (n, avg, m2), in the reference's expression order
    (deequ_tpu/analyzers/states.py:348-355); both 0 when n is 0. Each
    operation rounds on its own: the kernels (``common.cuh``
    ``dq_merge_moments``) compute the same expressions without fused
    multiply-adds, so the two agree bit for bit."""
    a_n, a_avg, a_m2 = a
    b_n, b_avg, b_m2 = b
    n = a_n + b_n
    safe_n = torch.where(n == 0, torch.ones_like(n), n)
    delta = b_avg - a_avg
    zero = torch.zeros_like(n)
    avg = torch.where(n == 0, zero, (a_avg * a_n + b_avg * b_n) / safe_n)
    m2 = a_m2 + b_m2 + delta * delta * a_n * b_n / safe_n
    return [n, avg, torch.where(n == 0, zero, m2)]


def merge_comoments(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Chan's rule on (n, x_avg, y_avg, ck, x_mk, y_mk), in the reference's
    expression order (deequ_tpu/analyzers/states.py:382); ``common.cuh``
    ``dq_merge_comoments`` is the kernels' copy."""
    a_n, a_xa, a_ya, a_ck, a_xmk, a_ymk = a
    b_n, b_xa, b_ya, b_ck, b_xmk, b_ymk = b
    n = a_n + b_n
    safe_n = torch.where(n == 0, torch.ones_like(n), n)
    dx = b_xa - a_xa
    dy = b_ya - a_ya
    frac = a_n * b_n / safe_n
    zero = torch.zeros_like(n)
    x_avg = torch.where(n == 0, zero, (a_xa * a_n + b_xa * b_n) / safe_n)
    y_avg = torch.where(n == 0, zero, (a_ya * a_n + b_ya * b_n) / safe_n)
    ck = a_ck + b_ck + dx * dy * frac
    x_mk = a_xmk + b_xmk + dx * dx * frac
    y_mk = a_ymk + b_ymk + dy * dy * frac
    return [n, x_avg, y_avg, torch.where(n == 0, zero, ck), torch.where(n == 0, zero, x_mk),
            torch.where(n == 0, zero, y_mk)]


@dataclass
class DataTypeHistogram:
    """Counts of inferred value types [null, fractional, integral, boolean,
    string] (reference `analyzers/DataType.scala:32-96`)."""

    counts: torch.Tensor  # int64[5]

    NULL_POS: int = field(default=0, metadata={"static": True})

    @staticmethod
    def init(device) -> "DataTypeHistogram":
        return DataTypeHistogram(torch.zeros(5, dtype=COUNT_DTYPE, device=device))

    def merge(self, other: "DataTypeHistogram") -> "DataTypeHistogram":
        return DataTypeHistogram(self.counts + other.counts)


@dataclass
class ApproxCountDistinctState:
    """HLL++ registers, unpacked int32[512] (reference packs them into 52
    longs, `analyzers/ApproxCountDistinct.scala:26-40`; see ``ops/hll.py``
    for the packed-format converters)."""

    registers: torch.Tensor  # int32[512]

    @staticmethod
    def init(device) -> "ApproxCountDistinctState":
        from ..ops.hll import M

        return ApproxCountDistinctState(torch.zeros(M, dtype=torch.int32, device=device))

    def merge(self, other: "ApproxCountDistinctState") -> "ApproxCountDistinctState":
        return ApproxCountDistinctState(torch.maximum(self.registers, other.registers))

    def metric_value(self) -> float:
        from ..ops.hll import estimate_cardinality

        return estimate_cardinality(self.registers.cpu().numpy())


#: State classes whose merge with the IDENTITY state is bit-transparent:
#: ``merge(init(), s) == s`` leaf for leaf, by construction of the merge
#: (the reference's set, deequ_tpu/analyzers/states.py:477):
#:
#: - integer adds against 0 (NumMatches, NumMatchesAndCount,
#:   DataTypeHistogram, FrequencyCountsState) are exact;
#: - float adds against +0.0 (MeanState, SumState totals) return the other
#:   operand's bits;
#: - ``min_nan_largest(NaN, x) == x`` and ``max_nan(-inf, x) == x``
#:   (MinState, MaxState);
#: - an elementwise max against 0 returns the non-negative HLL registers.
#:
#: The streaming fast path (service.coalesce) relies on this: a
#: micro-batch's host partial IS the batch's folded state, so merging it
#: into the session's persisted states reproduces the serial fold bit for
#: bit. StandardDeviationState and CorrelationState are absent: their
#: merges recompute ``avg = (avg * n) / n`` against the identity, which
#: rounds, so they fold through the device path.
IDENTITY_TRANSPARENT_STATES = frozenset({
    NumMatches,
    NumMatchesAndCount,
    MeanState,
    SumState,
    MinState,
    MaxState,
    DataTypeHistogram,
    ApproxCountDistinctState,
    FrequencyCountsState,
})


def identity_merge_transparent(state_cls: type) -> bool:
    """Whether ``merge(init(), s)`` returns ``s``'s exact bits for this
    state class (see :data:`IDENTITY_TRANSPARENT_STATES`)."""
    return state_cls in IDENTITY_TRANSPARENT_STATES


def host_merge(a, b):
    """The semigroup merge of two identity-transparent states on the host:
    both are brought to the CPU and merged with the class's own ``merge``
    (elementwise IEEE operations, so the bits are those of the merge on any
    device and of ``state_fold``). The streaming fast path merges with it,
    launching nothing. Raises ``TypeError`` for other classes, whose
    merges fold through ``merge_states_batched``."""
    cls = type(a)
    if cls is not type(b):
        raise TypeError(f"cannot host-merge {cls.__name__} with {type(b).__name__}")
    if cls not in IDENTITY_TRANSPARENT_STATES:
        raise TypeError(
            f"{cls.__name__} is not identity-merge transparent; merge it "
            "through merge_states_batched"
        )
    cpu = torch.device("cpu")
    a_cpu = with_leaves(a, [t.to(cpu) for t in leaves(a)])
    b_cpu = with_leaves(b, [t.to(cpu) for t in leaves(b)])
    return a_cpu.merge(b_cpu)
