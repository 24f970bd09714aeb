"""Analyzer protocol: the core algebra of the engine.

An analyzer is a pair of functions ``computeStateFrom: Data -> S`` and
``computeMetricFrom: S -> M`` where ``S`` is a commutative-semigroup state
(reference `analyzers/Analyzer.scala:34-53`). Here a state is a dataclass
of tensors; ``update`` folds a whole column *batch* into it on the run's
device and ``merge`` is the semigroup sum.

Scan-sharing (reference `ScanShareableAnalyzer`, `analyzers/Analyzer.scala:
169-197`): N analyzers contribute their feature requirements; the runner
computes the union of features once per batch, and the analyzers whose
update is a scalar reduction describe it as a ``scan_reduce`` slot, so one
kernel launch per batch serves all of them (see ``runners/engine.py``).
"""

from __future__ import annotations

import abc
import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Generic, List, Optional, Sequence, Tuple, TypeVar

import numpy as np
import torch

from ..data import ColumnKind, Schema
from ..exceptions import (
    MetricCalculationException,
    NoColumnsSpecifiedException,
    NoSuchColumnException,
    NumberOfSpecifiedColumnsException,
    WrongColumnTypeException,
    wrap_if_necessary,
)
from ..expr import Predicate
from ..kernels.scan_reduce import Partials, Slot, partials, scan_reduce
from ..metrics import (
    DoubleMetric,
    Entity,
    Metric,
    metric_from_empty,
    metric_from_failure,
    metric_from_value,
)

S = TypeVar("S")
M = TypeVar("M", bound=Metric)


# ---------------------------------------------------------------------------
# Feature specs: what a scan-shareable analyzer needs per batch on device.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FeatureSpec:
    """A named, device-resident numeric array derived from the batch.

    ``kind`` selects the host computation (see `runners/features.py`);
    ``payload`` carries a predicate (str or callable) or regex pattern.
    ``key`` is the stable string under which the array appears in the
    features dict handed to the analyzers' updates.
    """

    kind: str
    column: Optional[str] = None
    payload: Any = None

    @property
    def key(self) -> str:
        parts = [self.kind]
        if self.column is not None:
            parts.append(self.column)
        if self.payload is not None:
            parts.append(
                self.payload if isinstance(self.payload, str) else f"callable:{id(self.payload)}"
            )
        return ":".join(parts)


def rows_feature() -> FeatureSpec:
    return FeatureSpec("rows")


def numeric_feature(column: str) -> FeatureSpec:
    return FeatureSpec("num", column)


def mask_feature(column: str) -> FeatureSpec:
    return FeatureSpec("mask", column)


def length_feature(column: str) -> FeatureSpec:
    return FeatureSpec("len", column)


def predicate_feature(predicate: Predicate) -> FeatureSpec:
    return FeatureSpec("pred", None, predicate)


def regex_feature(column: str, pattern: str) -> FeatureSpec:
    return FeatureSpec("match", column, pattern)


def hash_feature(column: str) -> FeatureSpec:
    """int64 bits of each row's xxhash64 (the group key of a string or
    fractional column in the device frequency table)."""
    return FeatureSpec("hash", column)


def key_feature(column: str) -> FeatureSpec:
    """The values an integral or boolean group key derives from: integer
    columns in their own signed dtype (unsigned ones widened to int64, or
    viewed as int64 at 64 bits), booleans as float64 0/1. The ``num``
    feature casts to float64, which would merge integers above 2^53."""
    return FeatureSpec("key", column)


def hll_feature(column: str) -> FeatureSpec:
    """uint16 packed (register index << 6 | rank) keys for HLL++."""
    return FeatureSpec("hll", column)


def typeclass_feature(column: str) -> FeatureSpec:
    """int32 inferred-type class codes 0..4 (Unknown/Fractional/Integral/
    Boolean/String) per row, the DataType analyzer's input."""
    return FeatureSpec("type", column)


def codes_feature(column: str) -> FeatureSpec:
    """int32 dictionary codes of an encoded column (nulls/padding coded
    out-of-range) — the device frequency path's input."""
    return FeatureSpec("codes", column)


# ---------------------------------------------------------------------------
# Preconditions (reference `analyzers/Analyzer.scala:285-359`)
# ---------------------------------------------------------------------------


class Preconditions:
    @staticmethod
    def has_column(column: str) -> Callable[[Schema], None]:
        def check(schema: Schema) -> None:
            if column not in schema:
                raise NoSuchColumnException(f"Input data does not include column {column}!")

        return check

    @staticmethod
    def is_numeric(column: str) -> Callable[[Schema], None]:
        def check(schema: Schema) -> None:
            kind = schema[column].kind
            if not (kind.is_numeric or kind == ColumnKind.BOOLEAN):
                raise WrongColumnTypeException(
                    f"Expected type of column {column} to be numeric, but found {kind.value}!"
                )

        return check

    @staticmethod
    def is_string(column: str) -> Callable[[Schema], None]:
        def check(schema: Schema) -> None:
            if schema[column].kind != ColumnKind.STRING:
                raise WrongColumnTypeException(
                    f"Expected type of column {column} to be string, but found "
                    f"{schema[column].kind.value}!"
                )

        return check

    @staticmethod
    def is_not_nested(column: str) -> Callable[[Schema], None]:
        def check(schema: Schema) -> None:
            if schema[column].kind == ColumnKind.UNKNOWN:
                raise WrongColumnTypeException(
                    f"Unsupported nested column type of column {column}!"
                )

        return check

    @staticmethod
    def at_least_one(columns: Sequence[str]) -> Callable[[Schema], None]:
        def check(schema: Schema) -> None:
            if len(columns) == 0:
                raise NoColumnsSpecifiedException("At least one column needs to be specified!")

        return check

    @staticmethod
    def exactly_n_columns(columns: Sequence[str], n: int) -> Callable[[Schema], None]:
        def check(schema: Schema) -> None:
            if len(columns) != n:
                raise NumberOfSpecifiedColumnsException(
                    f"{n} columns have to be specified! Currently, columns contains only "
                    f"{len(columns)} column(s): {','.join(columns)}!"
                )

        return check

    @staticmethod
    def find_first_failing(
        schema: Schema, conditions: Sequence[Callable[[Schema], None]]
    ) -> Optional[MetricCalculationException]:
        for condition in conditions:
            try:
                condition(schema)
            except MetricCalculationException as exc:
                return exc
            except Exception as exc:  # noqa: BLE001
                return wrap_if_necessary(exc)
        return None


# ---------------------------------------------------------------------------
# Analyzer base classes
# ---------------------------------------------------------------------------


class Analyzer(abc.ABC, Generic[S, M]):
    """Base analyzer. Subclasses are frozen dataclasses, hashable for dedupe
    (reference dedupes analyzers against repository results,
    `AnalysisRunner.scala:116-134`)."""

    name: str = "Analyzer"

    @property
    def instance(self) -> str:
        return "*"

    @property
    def entity(self) -> Entity:
        return Entity.DATASET

    def preconditions(self) -> List[Callable[[Schema], None]]:
        return []

    @abc.abstractmethod
    def compute_metric_from(self, state: Optional[S]) -> M:
        ...

    def to_failure_metric(self, exception: BaseException) -> DoubleMetric:
        return metric_from_failure(
            wrap_if_necessary(exception), self.name, self.instance, self.entity
        )

    def merge(self, a: S, b: S) -> S:  # pragma: no cover - overridden
        raise NotImplementedError


#: a slot as an analyzer names it: (kind, where key, sel key, values key),
#: feature keys or None, and for a co-moment slot also (second values key,
#: second sel key); equal specs share one slot of a launch
SlotSpec = Tuple[Optional[Any], ...]


def resolve_slot(spec: SlotSpec, features: Dict[str, torch.Tensor]) -> Slot:
    return Slot(spec[0], *(None if key is None else features[key] for key in spec[1:]))


class HostBatchContext:
    """Per-batch helper of the host ingest tier (reference
    ``HostBatchContext``, deequ_tpu/analyzers/base.py:360): caches predicate
    masks, so analyzers sharing a ``where`` filter evaluate it once, and the
    native passes several analyzers share (a column's block statistics, its
    dictionary code counts, string lengths, type classes).

    ``run_token`` identifies the enclosing pass: host partials whose
    cross-batch skip caches live in the dataset's ``Column.aux`` key their
    entries on it, so a second pass over the same dataset never reuses an
    earlier pass's skip state (which would drop its contribution)."""

    def __init__(self, batch, batch_index: int = 0, run_token=None):
        self.batch = batch
        self.batch_index = batch_index
        self.run_token = run_token
        self._cache: Dict[Any, Any] = {}
        self._pred_columns = None

    def pred_mask(self, predicate) -> np.ndarray:
        key = str(predicate)
        cached = self._cache.get(key)
        if cached is None:
            from ..expr import evaluate_predicate
            from ..runners.features import _predicate_columns

            if self._pred_columns is None:
                self._pred_columns = _predicate_columns(self.batch)
            cached = evaluate_predicate(
                predicate, self._pred_columns, len(self.batch.row_mask)
            ) & self.batch.row_mask
            self._cache[key] = cached
        return cached

    def row_mask(self, analyzer) -> np.ndarray:
        """The batch's row mask and the analyzer's where-filter."""
        where = getattr(analyzer, "where", None)
        if where is None:
            return self.batch.row_mask
        return self.pred_mask(where)

    def row_mask_all(self) -> bool:
        """Whether every row of the batch is valid (no padding)."""
        key = ("row_mask_all",)
        cached = self._cache.get(key)
        if cached is None:
            cached = self._cache[key] = bool(self.batch.row_mask.all())
        return cached

    def dict_code_counts(self, column: str) -> np.ndarray:
        """int64[num_cats + 1] count of each dictionary code over the valid
        rows (masked and null rows in the last slot): one native pass per
        batch and column, shared by DataType, the HLL present-entry fold and
        the dictionary frequency scan."""
        key = ("dict_counts", column)
        cached = self._cache.get(key)
        if cached is None:
            from ..native import native_dict_masked_bincount

            col = self.batch.column(column)
            cached = native_dict_masked_bincount(
                col.codes, self.batch.row_mask & col.mask, col.num_categories
            )
            self._cache[key] = cached
        return cached

    def column_mask(self, analyzer, column: str) -> np.ndarray:
        return self.row_mask(analyzer) & self.batch.column(column).mask

    def _stats_key(self, analyzer, column: str):
        where = getattr(analyzer, "where", None)
        return ("stats", column, None if where is None else str(where))

    def block_stats(self, analyzer, column: str) -> np.ndarray:
        """``[count, sum, min, max, m2, nonnan, max_nonnan]`` over the
        analyzer-masked column: one native pass shared by Mean, Sum,
        Minimum, Maximum, StandardDeviation and the KLL sampler on the same
        column and filter. The column is read in its own dtype (float64,
        float32, int64, int32), so integers above 2^53 keep their value up
        to the one rounding to float64."""
        key = self._stats_key(analyzer, column)
        cached = self._cache.get(key)
        if cached is None:
            from ..native import native_block_stats

            col = self.batch.column(column)
            vals = col.values
            if not np.issubdtype(vals.dtype, np.number):
                vals = col.numeric_f64()
            cached = native_block_stats(vals, self.column_mask(analyzer, column))
            self._cache[key] = cached
        return cached

    def peek_block_stats(self, analyzer, column: str) -> Optional[np.ndarray]:
        """The cached :meth:`block_stats` row, or None if no analyzer has
        computed it for this column and filter yet: the KLL sampler then
        skips its counting pass without forcing a stats pass of its own."""
        return self._cache.get(self._stats_key(analyzer, column))

    def string_lengths(self, column: str) -> np.ndarray:
        key = ("len", column)
        cached = self._cache.get(key)
        if cached is None:
            from ..runners.features import _is_string_dict, dict_string_lengths, string_lengths

            col = self.batch.column(column)
            if _is_string_dict(col):
                cached = dict_string_lengths(col)
            else:
                cached = string_lengths(col.string_source, col.mask)
            self._cache[key] = cached
        return cached

    def type_codes(self, column: str) -> np.ndarray:
        key = ("type", column)
        cached = self._cache.get(key)
        if cached is None:
            from ..runners.features import _is_string_dict, classify_type_codes, dict_type_codes

            col = self.batch.column(column)
            if _is_string_dict(col):
                cached = dict_type_codes(col)
            else:
                source = col.string_source if col.kind == ColumnKind.STRING else col.values
                cached = classify_type_codes(source, col.mask, col.kind)
            self._cache[key] = cached
        return cached


def host_count(n) -> torch.Tensor:
    """A host partial's int64 scalar leaf."""
    return torch.tensor(int(n), dtype=torch.int64)


def host_acc(x) -> torch.Tensor:
    """A host partial's float64 scalar leaf."""
    return torch.tensor(float(x), dtype=torch.float64)


class ScanShareableAnalyzer(Analyzer[S, M]):
    """Analyzer whose state updates fuse into the shared single-pass scan.

    Scalar reductions implement ``scan_slot`` and ``fold_slot``: the engine
    reduces every analyzer's slot in one ``scan_reduce`` launch per batch
    and hands each analyzer its slot's partials. Other analyzers (sketches,
    frequency counts) implement ``update`` with their own kernel.

    On the host ingest tier an analyzer computes a partial state per batch
    on the host instead (``host_partial``, from the native library's block
    passes) and the device folds chunks of them into its state
    (``ingest_partial``: kernel ``state_fold``'s carry entry for every
    state but a KLL sketch, ``kll_compact``'s ingest entry for those)."""

    #: whether ``host_partial`` is implemented (a battery with any analyzer
    #: without it streams to the device whatever the placement)
    supports_host_partial: bool = False

    def host_partial(self, ctx: HostBatchContext) -> Any:
        """The batch's partial state, computed on the host (CPU tensors)."""
        raise NotImplementedError(f"{self!r} has no host partial")

    def ingest_partial(self, state: S, partial: Any) -> S:
        """Fold one host partial into the state: the merge, except for
        sketches whose partial is a sample."""
        return self.merge(state, partial)

    @abc.abstractmethod
    def feature_specs(self) -> List[FeatureSpec]:
        ...

    @abc.abstractmethod
    def init_state(self, device) -> S:
        ...

    def scan_slot(self) -> Optional[SlotSpec]:
        """The ``scan_reduce`` slot this analyzer's update reduces, or None
        when its update launches a kernel of its own."""
        return None

    def fold_slot(self, state: S, p: Partials) -> S:  # pragma: no cover - overridden
        raise NotImplementedError

    def update(self, state: S, features: Dict[str, torch.Tensor]) -> S:
        """Fold one batch into the state. For a slot analyzer: one
        ``scan_reduce`` launch over its own slot (the engine batches all
        slots of a battery into one launch instead)."""
        spec = self.scan_slot()
        if spec is None:  # pragma: no cover - overridden
            raise NotImplementedError
        out_i, out_f = scan_reduce([resolve_slot(spec, features)], features["rows"])
        return self.fold_slot(state, partials(out_i, out_f, 0))

    def update_stacked(self, features: Dict[str, torch.Tensor], width: int,
                       device) -> List[S]:
        """W sessions' batch states of an analyzer with a kernel of its own,
        from ``[W, n]`` features (the streaming service's coalesced fold):
        by default its one-batch ``update`` of a fresh state, once per
        session, on that session's row of each feature. Analyzers with a
        stacked kernel launch it once instead."""
        keys = [spec.key for spec in self.feature_specs()]
        return [
            self.update(self.init_state(device), {k: features[k][w] for k in keys})
            for w in range(width)
        ]

    def _where_key(self) -> Optional[str]:
        """Feature key of this analyzer's where-filter (the
        `conditionalSelection` analog, reference `analyzers/Analyzer.scala:
        409-432`), or None without one."""
        where = getattr(self, "where", None)
        return None if where is None else predicate_feature(where).key


class StandardScanShareableAnalyzer(ScanShareableAnalyzer[S, DoubleMetric]):
    """Adds the success/empty/failure DoubleMetric mapping
    (reference `analyzers/Analyzer.scala:200-226`)."""

    def compute_metric_from(self, state: Optional[S]) -> DoubleMetric:
        if state is None or self.is_empty(state):
            return metric_from_empty(self.name, self.instance, self.entity)
        try:
            value = self.metric_value(state)
        except Exception as exc:  # noqa: BLE001
            return metric_from_failure(wrap_if_necessary(exc), self.name, self.instance, self.entity)
        if value is None:
            return metric_from_empty(self.name, self.instance, self.entity)
        # a NaN from a NON-empty state is a real result (Spark: max/sum/avg
        # over data containing NaN is NaN) and surfaces as Success(NaN)
        return metric_from_value(float(value), self.name, self.instance, self.entity)

    @abc.abstractmethod
    def metric_value(self, state: S) -> float:
        ...

    def is_empty(self, state: S) -> bool:
        """Whether the folded state saw no values at all."""
        return False


# ---------------------------------------------------------------------------
# Folding many states of one analyzer (reference `analyzers/base.py:273`)
# ---------------------------------------------------------------------------


def fold_layout() -> Dict[type, Tuple[Tuple[int, Tuple[str, ...]], ...]]:
    """Per state class, the ``state_fold`` kinds of its tensor fields: the
    class's ``merge`` written as the kernel's slots."""
    from ..kernels import state_fold as K
    from . import states as st

    counted = ("count",)
    return {
        st.NumMatches: ((K.ADD_I64, ("num_matches",)),),
        st.NumMatchesAndCount: ((K.ADD_I64, ("num_matches", "count")),),
        st.MeanState: ((K.ADD_F64, ("total",)), (K.ADD_I64, counted)),
        st.SumState: ((K.ADD_F64, ("total",)), (K.ADD_I64, counted)),
        st.MinState: ((K.MIN, ("min_value",)), (K.ADD_I64, counted)),
        st.MaxState: ((K.MAX, ("max_value",)), (K.ADD_I64, counted)),
        st.StandardDeviationState: ((K.MOMENTS, ("n", "avg", "m2")),),
        st.CorrelationState: ((K.COMOMENTS, ("n", "x_avg", "y_avg", "ck", "x_mk", "y_mk")),),
        st.DataTypeHistogram: ((K.ADD_I64, ("counts",)),),
        st.ApproxCountDistinctState: ((K.MAX_I32, ("registers",)),),
        st.FrequencyCountsState: ((K.ADD_I64, ("counts", "num_rows")),),
    }


def state_to(state: Any, device) -> Any:
    """A tensor state with every leaf on ``device`` (the state itself when
    they all are already); other states (frequency tables, exact-quantile
    values) as they are."""
    from .states import leaves, with_leaves

    if not dataclasses.is_dataclass(state):
        return state
    tensors = leaves(state)
    if not all(isinstance(t, torch.Tensor) for t in tensors):
        return state
    if all(t.device == device for t in tensors):
        return state
    return with_leaves(state, [t.to(device) for t in tensors])


def _signature(state: Any) -> Tuple:
    from .states import leaves

    return (type(state),) + tuple((tuple(t.shape), t.dtype) for t in leaves(state))


def merge_states_batched(analyzer: Analyzer, states: Sequence[Any], device=None) -> Optional[Any]:
    """Fold ``states`` left to right with the analyzer's ``merge`` and
    return exactly what the sequential fold returns (None states are
    skipped; None when nothing is left). See :func:`merge_states_batched_many`."""
    return merge_states_batched_many([(analyzer, states)], device)[0]


def merge_states_batched_many(
    groups: Sequence[Tuple[Analyzer, Sequence[Any]]], device=None
) -> List[Optional[Any]]:
    """:func:`merge_states_batched` of several analyzers at once, on
    ``device`` (the card unless the caller names the CPU). States loaded on
    the host go to the device first.

    - Scalar, DataType, HLL and Correlation states of one shape fold in
      one ``state_fold`` launch for every such analyzer of the call with the
      same number of states (kernel K8).
    - KLL sketches of one shape fold through ``kll_merge`` (kernel K5's
      merge entry), N-1 launches in order, as the reference's scan body.
    - Frequency states and exact-quantile values fold on the host with the
      analyzer's ``merge``.
    - States of differing leaf shapes take the sequential ``merge`` fold."""
    from ..config import resolve_device
    from .grouping import FrequenciesAndNumRows
    from .sketches import ExactQuantileState
    from .states import FrequencyCountsState

    dev = resolve_device(device)
    layout = fold_layout()
    results: List[Optional[Any]] = [None] * len(groups)
    by_count: Dict[int, List[Tuple[int, List[Any]]]] = {}
    for i, (analyzer, given) in enumerate(groups):
        states = [s for s in given if s is not None]
        if not states:
            continue
        # frequency states and exact-quantile values fold on the host, as
        # the reference folds them
        host = isinstance(states[0], (FrequenciesAndNumRows, FrequencyCountsState,
                                      ExactQuantileState))
        if (not host and len(states) > 1 and type(states[0]) in layout
                and len({_signature(s) for s in states}) == 1):
            # stacked on the host where they lie, then copied once per dtype
            by_count.setdefault(len(states), []).append((i, states))
            continue
        states = [state_to(s, torch.device("cpu") if host else dev) for s in states]
        merged = states[0]
        for s in states[1:]:
            merged = analyzer.merge(merged, s)  # KLL: kll_merge, kernel K5
        results[i] = merged
    for jobs in by_count.values():
        for i, state in zip((i for i, _ in jobs), _fold_launch(jobs, layout, dev)):
            results[i] = state
    return results


def stack_states(states: Sequence[Any], device=None) -> Any:
    """One state whose leaves stack ``states``' leaves along a new leading
    axis, on ``device`` (the first state's device when None)."""
    from .states import leaves, with_leaves

    first = leaves(states[0])
    dev = device if device is not None else (first[0].device if first else None)
    return with_leaves(states[0], [
        torch.stack([leaf.detach().to(dev) for leaf in column])
        for column in zip(*(leaves(s) for s in states))
    ])


def pack_states(jobs: Sequence[Sequence[Any]], layout=None):
    """The ``state_fold`` inputs of several analyzers' N states each
    (``jobs``: one list of states per analyzer, all with N states, each list
    of one class and shape): the float64, int64 and int32 matrices, stacked
    where the first state lies, the slot table, and per job where each leaf
    lies (field name, matrix, offset, shape)."""
    first = [leaf for states in jobs for leaf in _leaves(states[0])]
    device = first[0].device if first else torch.device("cpu")
    return pack_stacked([stack_states(states, device) for states in jobs], layout)


def _leaves(state) -> List[torch.Tensor]:
    from .states import leaves

    return leaves(state)


def pack_stacked(stacked: Sequence[Any], layout=None):
    """:func:`pack_states` of states already stacked: each of ``stacked``
    is one analyzer's N states as one state whose leaves carry a leading
    axis of N (all on one device). Returns the three ``[N, W]`` matrices,
    the slot table and the places (field name, matrix, offset, shape of
    one state's leaf)."""
    from ..kernels.state_fold import GROUP_WIDTH, KIND_MATRIX, FoldSlot

    layout = layout if layout is not None else fold_layout()
    dtypes = (torch.float64, torch.int64, torch.int32)
    first = [leaf for st in stacked for leaf in _leaves(st)]
    n = int(first[0].shape[0]) if first else 0
    device = first[0].device if first else torch.device("cpu")
    columns: List[List[torch.Tensor]] = [[], [], []]
    widths = [0, 0, 0]
    slots: List[Any] = []
    places = []
    for state in stacked:
        place = []
        for kind, names in layout[type(state)]:
            m = KIND_MATRIX[kind]
            start = widths[m]
            for name in names:
                leaf = getattr(state, name)
                if leaf.dtype != dtypes[m]:
                    raise TypeError(f"{type(state).__name__}.{name} is {leaf.dtype}, "
                                    f"expected {dtypes[m]}")
                flat = leaf.detach().reshape(n, -1)
                columns[m].append(flat)
                place.append((name, m, widths[m], tuple(leaf.shape[1:])))
                widths[m] += flat.shape[1]
            length = 1 if kind in GROUP_WIDTH else widths[m] - start
            slots.append(FoldSlot(kind, start, length))
        places.append(place)
    mats = [torch.cat(cols, dim=1) if cols else torch.empty((n, 0), dtype=dt, device=device)
            for cols, dt in zip(columns, dtypes)]
    return mats, slots, places


def unpack_states(jobs: Sequence[Sequence[Any]], places, outs) -> List[Any]:
    """One state per job from the folded rows ``outs``; its leaves are views
    of them."""
    return unpack_stacked([states[0] for states in jobs], places, outs)


def unpack_stacked(templates: Sequence[Any], places, outs) -> List[Any]:
    """One state per template (its class and static fields) from the
    packed ``outs``: rows ``[W]`` give plain states, matrices ``[N, W]``
    states whose leaves carry the leading axis of N. Leaves are views."""
    from .states import tensor_fields, with_leaves

    merged = []
    for template, place in zip(templates, places):
        fields = {}
        for name, m, off, shape in place:
            mat = outs[m]
            lead = tuple(mat.shape[:-1])
            fields[name] = mat[..., off:off + math.prod(shape)].reshape(lead + tuple(shape))
        merged.append(with_leaves(template, [fields[f.name] for f in tensor_fields(template)]))
    return merged


def _fold_launch(jobs: Sequence[Tuple[int, List[Any]]], layout, device) -> List[Any]:
    """Pack every job's N states (stacked on the host, one copy per dtype to
    the device), fold them in one ``state_fold`` call and unpack one state
    per job."""
    from ..kernels.state_fold import state_fold

    lists = [states for _, states in jobs]
    mats, slots, places = pack_states(lists, layout)
    mats = [m.to(device) for m in mats]
    return unpack_states(lists, places, state_fold(mats[0], mats[1], mats[2], slots))
