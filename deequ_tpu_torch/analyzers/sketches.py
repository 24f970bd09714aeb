"""Sketch-backed analyzers: approximate distinct counts and quantiles.

The reference implements HLL++ as a Spark ImperativeAggregate with per-row
imperative buffer updates (`analyzers/catalyst/StatefulHyperloglogPlus.
scala`); here the host hashes and packs each row once (``ops/hll.py``) and
the ``hll_registers`` kernel folds a whole batch into the registers.

The quantile analyzers fold a column into a KLL sketch on the device
(``ops/kll.py``: the ``kll_sample`` and ``kll_compact`` kernels) and read
ranks and quantiles on the host (``ops/kll_host.py``).
"""

from __future__ import annotations

import functools
import math
import threading
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..data import Schema
from ..exceptions import (
    EmptyStateException,
    IllegalAnalyzerParameterException,
    wrap_if_necessary,
)
from ..expr import Predicate
from ..kernels.hll_registers import HllColumn, hll_registers_columns, hll_registers_stacked
from ..metrics import (
    BucketDistribution,
    BucketValue,
    Entity,
    Failure,
    KeyedDoubleMetric,
    KLLMetric,
    Success,
    metric_from_empty,
)
from ..ops.kll import (
    DEFAULT_SHRINKING_FACTOR,
    DEFAULT_SKETCH_SIZE,
    MAXIMUM_ALLOWED_DETAIL_BINS,
    compactor_buffers,
    kll_ingest_sampled,
    kll_init,
    kll_merge,
    kll_update,
)
from ..ops.hll import M
from ..ops.kll_host import HostKLL
from .base import (
    FeatureSpec,
    HostBatchContext,
    Preconditions,
    ScanShareableAnalyzer,
    StandardScanShareableAnalyzer,
    hll_feature,
    mask_feature,
    numeric_feature,
    predicate_feature,
    rows_feature,
)
from .states import ApproxCountDistinctState, KLLSketchState


@dataclass(frozen=True)
class ApproxCountDistinct(StandardScanShareableAnalyzer[ApproxCountDistinctState]):
    """Approximate distinct count via HLL++ (relativeSD=0.05, p=9, 512
    registers), matching the reference's accuracy envelope and hash (xxhash64
    seed 42) bit-for-bit (reference `analyzers/ApproxCountDistinct.scala:
    26-64`, kernel `analyzers/catalyst/StatefulHyperloglogPlus.scala:89-139`).
    Merge is an elementwise register max."""

    column: str = ""
    where: Optional[Predicate] = None
    name: str = field(default="ApproxCountDistinct", init=False)

    @property
    def instance(self) -> str:
        return self.column

    @property
    def entity(self) -> Entity:
        return Entity.COLUMN

    def preconditions(self) -> List[Callable[[Schema], None]]:
        return [Preconditions.has_column(self.column)]

    def feature_specs(self) -> List[FeatureSpec]:
        specs = [rows_feature(), mask_feature(self.column), hll_feature(self.column)]
        if self.where is not None:
            specs.append(predicate_feature(self.where))
        return specs

    def init_state(self, device) -> ApproxCountDistinctState:
        return ApproxCountDistinctState.init(device)

    def update(self, state: ApproxCountDistinctState, features) -> ApproxCountDistinctState:
        return ApproxCountDistinct.update_columns([self], [state], features)[0]

    @functools.cached_property
    def _hll_keys(self) -> Tuple[str, str, Optional[str]]:
        """The feature keys of its packed keys, presence mask and filter
        (computed once: a battery's update reads them every batch)."""
        return hll_feature(self.column).key, mask_feature(self.column).key, self._where_key()

    def hll_column(self, state: ApproxCountDistinctState, features) -> HllColumn:
        """This analyzer's column of a battery's ``hll_registers_columns``
        launch: its packed keys (uint16 ``(idx << 6) | pw``, 2 bytes a row;
        nulls arrive packed as 0, which never wins a register max), masks
        and the state's registers."""
        keys, mask, where = self._hll_keys
        return HllColumn(features[keys], features[mask],
                         None if where is None else features[where], state.registers)

    @staticmethod
    def update_columns(analyzers, states, features) -> List[ApproxCountDistinctState]:
        """Fold one batch into several HLL analyzers' states with one
        ``hll_registers_columns`` launch (the reference's fused update holds
        every HLL update of a battery, deequ_tpu/runners/engine.py:366);
        each new state's registers are a row of the launch's new output."""
        regs = hll_registers_columns(
            [a.hll_column(s, features) for a, s in zip(analyzers, states)], features["rows"])
        return [ApproxCountDistinctState(regs[c]) for c in range(len(analyzers))]

    def update_stacked(self, features, width: int, device) -> List[ApproxCountDistinctState]:
        """W sessions' registers in one ``hll_registers_stacked`` launch;
        each row is what :meth:`update` gives a fresh state (the registers
        are non-negative, so the max with the empty state is the row)."""
        key = self._where_key()
        regs = hll_registers_stacked(
            features[hll_feature(self.column).key],
            features["rows"],
            None if key is None else features[key],
            features[mask_feature(self.column).key],
        )
        return [ApproxCountDistinctState(regs[w]) for w in range(width)]

    def merge(self, a, b):
        return a.merge(b)

    def metric_value(self, state) -> float:
        # on empty data the estimate is 0.0, matching the reference where the
        # HLL agg buffer always exists (`ApproxCountDistinct.scala:49-56`)
        return state.metric_value()

    supports_host_partial = True

    def host_partial(self, ctx: HostBatchContext) -> ApproxCountDistinctState:
        """The batch's registers (reference sketches.py:95-240). A
        dictionary column hashes its distinct values once per dataset
        (cached in ``col.aux``) and folds only the entries present in the
        batch; within one pass (``ctx.run_token``) an entry reaches the fold
        through the first batch that sees it only, since registers fold by
        max. Other columns hash every valid row natively."""
        col = ctx.batch.column(self.column)
        mask = ctx.column_mask(self, self.column)
        if not (col.has_dictionary and col.codes is not None):
            return self._host_partial_rows(col, mask)
        from ..ops.hll import hll_features
        from ..runners.features import dict_entry_hashes

        aux = col.aux
        pairs = aux.get("hll_pairs")
        if pairs is None:
            pairs = aux["hll_pairs"] = hll_features(dict_entry_hashes(col))
        num_cats = col.num_categories
        if not num_cats:
            return _registers(np.zeros(M, dtype=np.int32))
        regs_full = aux.get("hll_regs_full")
        if regs_full is None:
            # per dataset: the registers of the whole dictionary, and a
            # register-sorted view of its (idx, pw) pairs for the per-batch
            # reduceat of _regs_for_target. The registers are published
            # last: a pool thread that finds them finds the view too
            idx, pw = pairs[0][:num_cats], pairs[1][:num_cats]
            regs_full = np.zeros(M, dtype=np.int32)
            np.maximum.at(regs_full, idx, pw)
            perm = np.argsort(idx, kind="stable")
            aux["hll_perm"] = perm
            aux["hll_pw_sorted"] = pw[perm]
            aux["hll_starts"] = np.searchsorted(idx[perm], np.arange(M))
            aux["hll_regs_full"] = regs_full
        if self.where is None and ctx.run_token is not None:
            # the pass's seen-set: the lock guards the swap to a new pass;
            # concurrent batches marking entries can at worst contribute one
            # twice (max is idempotent), never drop one
            lock = aux.setdefault("_hll_lock", threading.Lock())
            with lock:
                if aux.get("hll_seen_full") is ctx.run_token:
                    return _registers(np.zeros(M, dtype=np.int32))
                tok, seen = aux.get("hll_seen", (None, None))
                if tok is not ctx.run_token:
                    seen = np.zeros(num_cats + 1, dtype=bool)
                    seen[num_cats] = True
                    aux["hll_seen"] = (ctx.run_token, seen)
            idx, pw = pairs[0][:num_cats], pairs[1][:num_cats]
            if num_cats > (1 << 16):
                # a large dictionary: an O(rows) lookup of the seen-set
                # decides cheaper than an O(rows + cats) presence count
                codes = np.where(col.codes < num_cats, col.codes, num_cats)
                unseen = ~seen[codes]
                n_unseen = int(np.count_nonzero(unseen))
                if n_unseen == 0:
                    return _registers(np.zeros(M, dtype=np.int32))
                if n_unseen <= len(codes) // 64:
                    new_codes = np.unique(codes[unseen])
                    seen[new_codes] = True
                    if seen.all():
                        aux["hll_seen_full"] = ctx.run_token
                    regs = np.zeros(M, dtype=np.int32)
                    np.maximum.at(regs, idx[new_codes], pw[new_codes])
                    return _registers(regs)
            counts = ctx.dict_code_counts(self.column) if ctx.row_mask_all() else None
            if counts is None:
                safe = np.where(col.codes < num_cats, col.codes, num_cats)
                counts = np.bincount(safe[mask], minlength=num_cats + 1)
            present = counts[:num_cats] > 0
            target = present & ~seen[:num_cats]
            seen[:num_cats] |= present
            if seen.all():
                aux["hll_seen_full"] = ctx.run_token
            if not target.any():
                return _registers(np.zeros(M, dtype=np.int32))
            if target.all():
                return _registers(regs_full.copy())
            return _registers(self._regs_for_target(aux, pairs, target, num_cats))
        if self.where is None:
            counts = ctx.dict_code_counts(self.column)[:num_cats]
        else:
            counts = np.bincount(col.codes[mask], minlength=num_cats + 1)[:num_cats]
        present = counts > 0
        if present.all():
            return _registers(regs_full.copy())
        return _registers(self._regs_for_target(aux, pairs, present, num_cats))

    def _regs_for_target(self, aux, pairs, target: np.ndarray, num_cats: int) -> np.ndarray:
        """Registers over the dictionary entries ``target`` selects: a
        sparse scatter-max for few entries, else a reduceat over the cached
        register-sorted view."""
        idx, pw = pairs[0][:num_cats], pairs[1][:num_cats]
        if int(np.count_nonzero(target)) * 8 < num_cats:
            ti = np.flatnonzero(target)
            regs = np.zeros(M, dtype=np.int32)
            np.maximum.at(regs, idx[ti], pw[ti])
            return regs
        perm = aux["hll_perm"]
        pw_eff = np.where(target[perm], aux["hll_pw_sorted"], -1)
        starts = aux["hll_starts"]
        nexts = np.append(starts[1:], num_cats)
        # a trailing -1 keeps every start (up to num_cats, for empty
        # trailing registers) a valid reduceat index without clamping
        seg = np.maximum.reduceat(np.append(pw_eff, np.int32(-1)), starts)
        seg = np.where(nexts > starts, seg, -1)
        return np.maximum(seg, 0).astype(np.int32)

    def _host_partial_rows(self, col, mask) -> ApproxCountDistinctState:
        """Registers of a column without a dictionary: one native pass
        (hash, leading zeros, max) over its valid rows."""
        from ..data import ColumnKind
        from ..native import native_block_hll, native_block_hll_strings
        from ..ops.hashing import DEFAULT_SEED, hash_column
        from ..ops.hll import hll_features
        from ..runners.features import _hll_numeric_values

        if col.kind == ColumnKind.STRING:
            src = col.string_source
            if not isinstance(src, np.ndarray) or src.dtype == object:
                return _registers(native_block_hll_strings(src, mask, DEFAULT_SEED))
        elif col.kind.is_numeric or col.kind == ColumnKind.BOOLEAN:
            vals = _hll_numeric_values(col.values)
            if np.issubdtype(vals.dtype, np.number):
                return _registers(native_block_hll(vals, mask, DEFAULT_SEED))
        pairs = hll_features(hash_column(col.values, col.mask, col.kind))
        regs = np.zeros(M, dtype=np.int32)
        np.maximum.at(regs, pairs[0][mask], pairs[1][mask])
        return _registers(regs)


def _registers(regs: np.ndarray) -> ApproxCountDistinctState:
    return ApproxCountDistinctState(torch.from_numpy(np.asarray(regs, dtype=np.int32)))


# ---------------------------------------------------------------------------
# KLL-backed quantile analyzers
# ---------------------------------------------------------------------------



@dataclass(frozen=True)
class KLLParameters:
    """(reference `analyzers/KLLSketch.scala:82`)."""

    sketch_size: int = DEFAULT_SKETCH_SIZE
    shrinking_factor: float = DEFAULT_SHRINKING_FACTOR
    number_of_buckets: int = MAXIMUM_ALLOWED_DETAIL_BINS


class _KLLBackedAnalyzer(ScanShareableAnalyzer[KLLSketchState, KLLMetric]):
    """Shared plumbing for analyzers folding a column into a KLL sketch.
    Subclasses define ``_sketch_size`` and the metric finalization. On the
    host ingest tier the batch's sample is taken on the host and folded by
    ``kll_compact``'s ingest entry."""

    @property
    def instance(self) -> str:
        return self.column

    @property
    def entity(self) -> Entity:
        return Entity.COLUMN

    def _sketch_size(self) -> int:
        raise NotImplementedError

    def preconditions(self) -> List[Callable[[Schema], None]]:
        return [
            Preconditions.has_column(self.column),
            Preconditions.is_numeric(self.column),
        ]

    def feature_specs(self) -> List[FeatureSpec]:
        specs = [rows_feature(), numeric_feature(self.column), mask_feature(self.column)]
        if self.where is not None:
            specs.append(predicate_feature(self.where))
        return specs

    def init_state(self, device) -> KLLSketchState:
        return kll_init(self._sketch_size(), device=device)

    def update(self, state: KLLSketchState, features) -> KLLSketchState:
        key = self._where_key()
        return kll_update(
            state,
            features[numeric_feature(self.column).key],
            features["rows"],
            None if key is None else features[key],
            features[mask_feature(self.column).key],
        )

    def merge(self, a, b):
        return kll_merge(a, b)

    supports_host_partial = True

    def host_partial(self, ctx: HostBatchContext) -> Tuple:
        """The batch's KLL sample on the host (reference sketches.py:
        375-420): ``(items f64[4k], m, h, nv, min, max)`` by the native
        sampler, seeded by the batch index. When a stats analyzer of the
        same column and filter already counted the block, the sampler only
        picks."""
        from ..native import native_block_kll_pick, native_block_kll_sample

        col = ctx.batch.column(self.column)
        mask = ctx.column_mask(self, self.column)
        vals = col.values if np.issubdtype(col.values.dtype, np.number) else col.numeric_f64()
        k = self._sketch_size()
        stats = ctx.peek_block_stats(self, self.column)
        if stats is not None:
            nv = int(stats[5])
            if nv == 0:
                items, m, h, mn, mx = np.full(4 * k, np.inf), 0, 0, np.inf, -np.inf
            else:
                items, m, h = native_block_kll_pick(vals, mask, k, ctx.batch_index, nv)
                mn, mx = float(stats[2]), float(stats[6])
        else:
            items, m, h, nv, mn, mx = native_block_kll_sample(vals, mask, k, ctx.batch_index)
        return (
            items.astype(np.float64), np.int32(m), np.int32(h), np.int64(nv),
            np.float64(mn), np.float64(mx),
        )

    def ingest_partial(self, state: KLLSketchState, partial: Tuple) -> KLLSketchState:
        return kll_ingest_sampled(state, *partial)


@dataclass(frozen=True)
class KLLSketch(_KLLBackedAnalyzer):
    """Quantile sketch of a numeric column, reported as an equi-width
    BucketDistribution over [globalMin, globalMax]
    (reference `analyzers/KLLSketch.scala:42-176`)."""

    column: str = ""
    kll_parameters: Optional[KLLParameters] = None
    where: Optional[Predicate] = None
    name: str = field(default="KLLSketch", init=False)

    @property
    def params(self) -> KLLParameters:
        return self.kll_parameters or KLLParameters()

    def _sketch_size(self) -> int:
        return self.params.sketch_size

    def preconditions(self) -> List[Callable[[Schema], None]]:
        def param_check(schema: Schema) -> None:
            if self.params.number_of_buckets > MAXIMUM_ALLOWED_DETAIL_BINS:
                raise IllegalAnalyzerParameterException(
                    f"Cannot return KLL Sketch related values for more than "
                    f"{MAXIMUM_ALLOWED_DETAIL_BINS} values"
                )
            if self.params.sketch_size < 1:
                raise IllegalAnalyzerParameterException(
                    f"KLL sketch size must be positive, got {self.params.sketch_size}"
                )

        return [param_check] + super().preconditions()

    def compute_metric_from(self, state: Optional[KLLSketchState]) -> KLLMetric:
        if state is None or int(state.count) == 0:
            return KLLMetric(
                Entity.COLUMN,
                self.name,
                self.column,
                Failure(
                    EmptyStateException(
                        f"Empty state for analyzer {self.name} on {self.column}, "
                        "all input values were NULL."
                    )
                ),
            )
        try:
            sketch = HostKLL.from_state(state)
            start = float(state.g_min)
            end = float(state.g_max)
            nb = self.params.number_of_buckets
            count = int(state.count)
            # bucket i covers (low_i, high_i]; the last bucket includes its
            # upper bound (reference `analyzers/KLLSketch.scala:136-146`).
            # The batch pre-collapse drops remainder items (n mod stride), so
            # the sketch's total weight can drift slightly below the exact
            # value count; scale the cumulative ranks so bucket counts
            # telescope to EXACTLY `count`, like the reference sketch whose
            # compactions preserve total weight (`NonSampleCompactor.scala:
            # 29-69`).
            bounds = [start + (end - start) * i / nb for i in range(nb + 1)]
            raw = [sketch.rank_exclusive(b) for b in bounds[:-1]]
            # anchor the ends at 0 and the FULL sketch weight, not at
            # rank(g_min)/rank(g_max): f32-quantized items can round a hair
            # past either f64 extreme and must still land in the end buckets
            raw[0] = 0
            raw.append(sketch.total_weight)
            tw = sketch.total_weight
            scale = (count / tw) if tw else 0.0
            cum = [int(np.floor(r * scale + 0.5)) for r in raw]
            buckets = [
                BucketValue(bounds[i], bounds[i + 1], cum[i + 1] - cum[i])
                for i in range(nb)
            ]
            dist = BucketDistribution(
                buckets,
                [self.params.shrinking_factor, float(self._sketch_size())],
                compactor_buffers(state),
            )
            return KLLMetric(Entity.COLUMN, self.name, self.column, Success(dist))
        except Exception as exc:  # noqa: BLE001
            return self.to_failure_metric(exc)

    def to_failure_metric(self, exception: BaseException) -> KLLMetric:
        return KLLMetric(
            Entity.COLUMN, self.name, self.column, Failure(wrap_if_necessary(exception))
        )


def _sketch_size_for_error(relative_error: float) -> int:
    """Sketch size giving (empirically validated) rank error well inside
    ``relative_error``. The reference uses a Greenwald-Khanna digest with
    accuracy 1/relativeError (`analyzers/catalyst/DeequFunctions.scala:
    65-77`); KLL-backed needs O(1/eps) space for the same bound."""

    return max(256, int(math.ceil(4.0 / max(relative_error, 1e-4))))


def _check_quantile(q: float) -> None:
    if not 0.0 <= q <= 1.0:
        raise IllegalAnalyzerParameterException(
            "Quantile parameter must be in the closed interval [0, 1]. "
            f"Currently, the value is: {q}!"
        )


def _check_relative_error(relative_error: float) -> None:
    """The reference admits relativeError=0 as 'exact' mode
    (`ApproxQuantiles.scala:30`): ``relative_error=0.0`` routes the analyzer
    to a host full-sort accumulator (:class:`ExactQuantileState`) whose
    result is ``numpy.quantile``'s. Errors in (0, 1] are KLL-backed, with
    1e-4 as the smallest honored error."""
    if not 0.0 <= relative_error <= 1.0:
        raise IllegalAnalyzerParameterException(
            "Relative error parameter must be in the interval [0, 1]. "
            f"Currently, the value is: {relative_error}!"
        )


@dataclass(frozen=True)
class ExactQuantileState:
    """Host accumulator of the exact mode (``relative_error=0.0``, the
    reference's exact GK mode, `ApproxQuantiles.scala:30`; the JAX
    package's class of the same name, deequ_tpu/analyzers/sketches.py:587):
    the column's non-null, non-NaN values in chunks, concatenated and
    sorted at metric time, so the result is ``numpy.quantile``'s (linear
    interpolation). Memory is O(values kept); the merge concatenates the
    chunk lists. Not persistable, as in the reference: a persister given
    one fails that analyzer's metric."""

    chunks: Tuple[np.ndarray, ...] = ()

    def add(self, values: np.ndarray) -> "ExactQuantileState":
        return ExactQuantileState(self.chunks + (np.asarray(values, dtype=np.float64),))

    def merge(self, other: "ExactQuantileState") -> "ExactQuantileState":
        return ExactQuantileState(self.chunks + other.chunks)

    @property
    def count(self) -> int:
        return int(sum(c.size for c in self.chunks))

    def values(self) -> np.ndarray:
        if not self.chunks:
            return np.empty(0, dtype=np.float64)
        return np.concatenate(self.chunks)


class _ExactQuantileMode:
    """The exact mode of ApproxQuantile(s): with ``relative_error == 0.0``
    the analyzer leaves the device scan (``host_exclusive``) and the runner
    folds its batches on the host in the same pass."""

    @property
    def host_exclusive(self) -> bool:
        return self.relative_error == 0.0

    def host_init(self) -> ExactQuantileState:
        return ExactQuantileState()

    def host_update(self, state: ExactQuantileState, batch) -> ExactQuantileState:
        col = batch.column(self.column)
        mask = batch.row_mask & col.mask
        if self.where is not None:
            from ..expr import evaluate_predicate
            from ..runners.features import _predicate_columns

            mask = mask & evaluate_predicate(
                self.where, _predicate_columns(batch), len(batch.row_mask)
            )
        vals = col.values if np.issubdtype(col.values.dtype, np.number) else col.numeric_f64()
        v = np.asarray(vals, dtype=np.float64)[mask]
        v = v[~np.isnan(v)]
        return state.add(v) if v.size else state

    def merge(self, a, b):
        if isinstance(a, ExactQuantileState) or isinstance(b, ExactQuantileState):
            return a.merge(b)
        return kll_merge(a, b)


@dataclass(frozen=True)
class ApproxQuantile(_ExactQuantileMode, _KLLBackedAnalyzer,
                     StandardScanShareableAnalyzer[KLLSketchState]):
    """Approximate single quantile (reference `analyzers/ApproxQuantile.scala:
    28-103`, default relativeError 0.01 at `:49`), KLL-backed;
    ``relative_error=0.0`` selects the exact host full-sort mode."""

    column: str = ""
    quantile: float = 0.5
    relative_error: float = 0.01
    where: Optional[Predicate] = None
    name: str = field(default="ApproxQuantile", init=False)

    def __post_init__(self):
        # metric name carries the quantile so several quantiles of one column
        # stay distinguishable (reference `ApproxQuantile.scala:90-97`)
        object.__setattr__(self, "name", f"ApproxQuantile-{self.quantile}")

    def _sketch_size(self) -> int:
        return _sketch_size_for_error(self.relative_error)

    def preconditions(self) -> List[Callable[[Schema], None]]:
        def param_checks(schema: Schema) -> None:
            _check_quantile(self.quantile)
            _check_relative_error(self.relative_error)

        return [param_checks] + super().preconditions()

    def metric_value(self, state) -> float:
        if isinstance(state, ExactQuantileState):
            return float(np.quantile(state.values(), self.quantile))
        return HostKLL.from_state(state).quantile(self.quantile)

    def is_empty(self, state) -> bool:
        return int(state.count) == 0


@dataclass(frozen=True)
class ApproxQuantiles(_ExactQuantileMode, _KLLBackedAnalyzer):
    """Several quantiles from one sketch -> KeyedDoubleMetric
    (reference `analyzers/ApproxQuantiles.scala:39-101`);
    ``relative_error=0.0`` selects the exact host full-sort mode."""

    column: str = ""
    quantiles: Tuple[float, ...] = ()
    relative_error: float = 0.01
    name: str = field(default="ApproxQuantiles", init=False)
    where: Optional[Predicate] = None

    def __post_init__(self):
        if not isinstance(self.quantiles, tuple):
            object.__setattr__(self, "quantiles", tuple(self.quantiles))

    def _sketch_size(self) -> int:
        return _sketch_size_for_error(self.relative_error)

    def preconditions(self) -> List[Callable[[Schema], None]]:
        def param_checks(schema: Schema) -> None:
            for q in self.quantiles:
                _check_quantile(q)
            _check_relative_error(self.relative_error)

        return [param_checks] + super().preconditions()

    def compute_metric_from(self, state) -> KeyedDoubleMetric:
        if state is None or int(state.count) == 0:
            empty = metric_from_empty(self.name, self.column, Entity.COLUMN)
            return KeyedDoubleMetric(Entity.COLUMN, self.name, self.column, empty.value)
        try:
            if isinstance(state, ExactQuantileState):
                vals = state.values()
                values = {str(q): float(np.quantile(vals, q)) for q in self.quantiles}
                return KeyedDoubleMetric(Entity.COLUMN, self.name, self.column, Success(values))
            sketch = HostKLL.from_state(state)
            values = {str(q): sketch.quantile(q) for q in self.quantiles}
            return KeyedDoubleMetric(Entity.COLUMN, self.name, self.column, Success(values))
        except Exception as exc:  # noqa: BLE001
            return KeyedDoubleMetric(
                Entity.COLUMN, self.name, self.column, Failure(wrap_if_necessary(exc))
            )

    def to_failure_metric(self, exception: BaseException) -> KeyedDoubleMetric:
        return KeyedDoubleMetric(
            Entity.COLUMN, self.name, self.column, Failure(wrap_if_necessary(exception))
        )
