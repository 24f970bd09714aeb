"""Column profiling: generic stats, numeric stats and low-cardinality
histograms (reference `profiles/ColumnProfiler.scala:69-712`,
`profiles/ColumnProfile.scala`, `profiles/ColumnProfilerRunner.scala`),
ported from the JAX package's ``deequ_tpu/profiles``.

The reference needs 3 scans of the data (header comment
`ColumnProfiler.scala:57-68`). Here a full profile touches the data at
most three times and usually twice, each pass one
``AnalysisRunner.do_analysis_run`` on the run's device: pass 1 (generic
stats, DataType on string columns, the numeric stats and KLL sketches of
schema-typed numeric columns, histograms of small dictionaries) and pass 2
(numeric stats on the casted view + histograms of the other low-cardinality
columns, dictionary-encoded first). Histograms of string columns the cast
changed run in a pass of their own over the original data.

Not carried by this port (each raises ``NotImplementedError``): a metrics
repository and its reuse and save keys (ROADMAP A3) and sharding over
several devices (ROADMAP A5).
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from ..analyzers import (
    ApproxCountDistinct,
    Completeness,
    DataType,
    Histogram,
    KLLParameters,
    KLLSketch,
    Maximum,
    Mean,
    Minimum,
    Size,
    StandardDeviation,
    Sum,
)
from ..config import DeviceLike
from ..data import ColumnKind, Dataset
from ..metrics import BucketDistribution, Distribution
from ..runners.analysis_runner import AnalysisRunner

DEFAULT_CARDINALITY_THRESHOLD = 120  # reference `ColumnProfiler.scala:71`

#: inferred/known type names (reference `DataTypeInstances`)
UNKNOWN, FRACTIONAL, INTEGRAL, BOOLEAN, STRING = (
    "Unknown", "Fractional", "Integral", "Boolean", "String",
)


def determine_type(dist: Distribution) -> str:
    """Decision tree over the type histogram
    (reference `analyzers/DataType.scala:116-143`)."""

    def ratio_of(key: str) -> float:
        return dist.values[key].ratio if key in dist.values else 0.0

    if ratio_of(UNKNOWN) == 1.0:
        return UNKNOWN
    if ratio_of(STRING) > 0.0 or (
        ratio_of(BOOLEAN) > 0.0 and (ratio_of(INTEGRAL) > 0.0 or ratio_of(FRACTIONAL) > 0.0)
    ):
        return STRING
    if ratio_of(BOOLEAN) > 0.0:
        return BOOLEAN
    if ratio_of(FRACTIONAL) > 0.0:
        return FRACTIONAL
    return INTEGRAL


@dataclass(frozen=True)
class ColumnProfile:
    """(reference `profiles/ColumnProfile.scala:24-45`)."""

    column: str
    completeness: float
    approximate_num_distinct_values: int
    data_type: str
    is_data_type_inferred: bool
    type_counts: Dict[str, int] = field(default_factory=dict)
    histogram: Optional[Distribution] = None


@dataclass(frozen=True)
class StandardColumnProfile(ColumnProfile):
    pass


@dataclass(frozen=True)
class NumericColumnProfile(ColumnProfile):
    """(reference `profiles/ColumnProfile.scala:47-61`)."""

    mean: Optional[float] = None
    maximum: Optional[float] = None
    minimum: Optional[float] = None
    sum: Optional[float] = None
    std_dev: Optional[float] = None
    approx_percentiles: Optional[List[float]] = None
    kll: Optional[BucketDistribution] = None


class ColumnProfiles:
    """(reference `profiles/ColumnProfile.scala` ColumnProfiles + toJson)."""

    def __init__(self, profiles: Dict[str, ColumnProfile], num_records: int):
        self.profiles = profiles
        self.num_records = num_records

    def __getitem__(self, column: str) -> ColumnProfile:
        return self.profiles[column]

    def to_json(self) -> str:
        columns = []
        for profile in self.profiles.values():
            entry: Dict[str, Any] = {
                "column": profile.column,
                "dataType": profile.data_type,
                "isDataTypeInferred": str(profile.is_data_type_inferred).lower(),
                "completeness": profile.completeness,
                "approximateNumDistinctValues": profile.approximate_num_distinct_values,
            }
            if profile.type_counts:
                entry["typeCounts"] = dict(profile.type_counts)
            if profile.histogram is not None:
                entry["histogram"] = [
                    {"value": k, "count": v.absolute, "ratio": v.ratio}
                    for k, v in profile.histogram.values.items()
                ]
            if isinstance(profile, NumericColumnProfile):
                entry.update(
                    {
                        "mean": profile.mean,
                        "maximum": profile.maximum,
                        "minimum": profile.minimum,
                        "sum": profile.sum,
                        "stdDev": profile.std_dev,
                        "approxPercentiles": profile.approx_percentiles or [],
                    }
                )
            columns.append(entry)
        return json.dumps({"columns": columns}, indent=2)


class ColumnProfiler:
    @staticmethod
    def profile(
        data: Dataset,
        restrict_to_columns: Optional[Sequence[str]] = None,
        print_status_updates: bool = False,
        low_cardinality_histogram_threshold: int = DEFAULT_CARDINALITY_THRESHOLD,
        metrics_repository=None,
        reuse_existing_results_using_key=None,
        fail_if_results_for_reusing_missing: bool = False,
        save_in_metrics_repository_using_key=None,
        kll_parameters: Optional[KLLParameters] = None,
        predefined_types: Optional[Dict[str, str]] = None,
        batch_size: Optional[int] = None,
        monitor=None,
        sharding=None,
        device: DeviceLike = None,
        placement: Optional[str] = None,
    ) -> ColumnProfiles:
        """(reference `ColumnProfiler.profile`, `ColumnProfiler.scala:91-208`).
        Every pass runs on ``device`` (``cuda`` unless the caller names
        another), on the ingest tier ``placement`` resolves to."""
        _refuse_unported(
            metrics_repository=metrics_repository,
            reuse_existing_results_using_key=reuse_existing_results_using_key,
            save_in_metrics_repository_using_key=save_in_metrics_repository_using_key,
            sharding=sharding,
        )
        predefined_types = dict(predefined_types or {})
        schema = data.schema
        if restrict_to_columns is not None:
            for name in restrict_to_columns:
                if name not in schema:
                    raise ValueError(f"Unable to find column {name}")
        relevant = [
            c.name
            for c in schema.columns
            if restrict_to_columns is None or c.name in restrict_to_columns
        ]
        run_kwargs = dict(batch_size=batch_size, monitor=monitor, device=device,
                          placement=placement)

        # ---- PASS 1: generic statistics, the numeric statistics of
        # schema-typed numeric columns, histograms of small dictionaries ----
        if print_status_updates:
            print("### PROFILING: Computing generic column statistics in pass (1/2)...")
        first_pass = first_pass_analyzers(
            data, relevant, predefined_types, kll_parameters, low_cardinality_histogram_threshold
        )
        hist_pass1 = {a.column for a in first_pass if isinstance(a, Histogram)}
        first_results = AnalysisRunner.do_analysis_run(data, first_pass, **run_kwargs)

        generic = _extract_generic_statistics(
            relevant, schema, first_results, predefined_types
        )

        # ---- PASS 2: numeric statistics on the casted view + exact
        # histograms of low-cardinality columns, ONE shared scan
        # (reference needs separate passes 2 and 3, `:153-205`) ----
        if print_status_updates:
            print(
                "### PROFILING: Computing numeric statistics + low-cardinality "
                "histograms in pass (2/2)..."
            )
        casted, casted_names = _cast_numeric_string_columns(relevant, data, generic)
        second_pass: List[Any] = []
        for name in relevant:
            if generic.type_of(name) in (INTEGRAL, FRACTIONAL) and not schema[
                name
            ].kind.is_numeric:
                # only inference-detected (casted string) columns remain;
                # schema-typed numerics already ran in pass 1
                second_pass += _numeric_analyzers(name, kll_parameters)
        histogram_columns = _find_target_columns_for_histograms(
            schema, generic, low_cardinality_histogram_threshold
        )
        # histograms must count ORIGINAL values (reference pass 3 reads the
        # raw data, `getHistogramsForThirdPass`): share pass 2 only for
        # columns the cast did not touch, else run them in an extra pass;
        # columns already histogrammed in pass 1 are done either way
        remaining_hist = [c for c in histogram_columns if c not in hist_pass1]
        shared_hist = [c for c in remaining_hist if c not in casted_names]
        extra_hist = [c for c in remaining_hist if c in casted_names]
        # pass-1 estimates prove these columns low-cardinality, so encode
        # them now (floats/ints included): their histograms then ride the
        # device frequency scan. The encoded view memoizes on the source
        # dataset so repeated profiles reuse ONE arrow table.
        casted = _encoded(data, casted, casted_names, shared_hist)
        second_pass += [Histogram(name) for name in shared_hist]
        second_results = None
        third_results = None
        if second_pass:
            second_results = AnalysisRunner.do_analysis_run(casted, second_pass, **run_kwargs)
        if extra_hist:
            # the original values of cast columns, dictionary-encoded the
            # same way (the JAX package counts them in a host group-by)
            third_results = AnalysisRunner.do_analysis_run(
                _encoded(data, data, (), extra_hist),
                [Histogram(name) for name in extra_hist], **run_kwargs
            )

        numeric_stats = _extract_numeric_statistics(first_results, second_results)
        histograms: Dict[str, Distribution] = {}
        eligible_hist = set(histogram_columns)
        for results in (first_results, second_results, third_results):
            if results is None:
                continue
            for analyzer, metric in results.metric_map.items():
                if (
                    isinstance(analyzer, Histogram)
                    and metric.value.is_success
                    and analyzer.column in eligible_hist
                ):
                    histograms[analyzer.column] = metric.value.get()

        return _create_profiles(relevant, generic, numeric_stats, histograms)


def _encoded(data: Dataset, view: Dataset, casted_names, columns) -> Dataset:
    """``view`` with ``columns`` dictionary-encoded where they are not yet,
    memoized on the source ``data`` so repeated profiles reuse one table."""
    encodable = tuple(c for c in columns if view.dictionary_size(c) is None)
    if not encodable:
        return view
    key = ("__profile_encoded__", tuple(sorted(casted_names)), encodable)
    encoded = data.derived_cache.get(key)
    if encoded is None:
        encoded = view.with_columns_dictionary_encoded(encodable)
        data.derived_cache[key] = encoded
    return encoded


#: where the profiler's options that this port does not carry are planned
_UNPORTED = {
    "metrics_repository": "ROADMAP A3 (state persistence and repositories)",
    "reuse_existing_results_using_key": "ROADMAP A3 (state persistence and repositories)",
    "save_in_metrics_repository_using_key": "ROADMAP A3 (state persistence and repositories)",
    "sharding": "ROADMAP A5 (more than one GPU)",
}


def _refuse_unported(**options) -> None:
    for name, value in options.items():
        if value is not None:
            raise NotImplementedError(
                f"ColumnProfiler option {name} is not supported by deequ_tpu_torch yet: "
                f"{_UNPORTED[name]}"
            )


def first_pass_analyzers(
    data: Dataset,
    columns: Sequence[str],
    predefined_types: Dict[str, str],
    kll_parameters: Optional[KLLParameters] = None,
    low_cardinality_histogram_threshold: int = DEFAULT_CARDINALITY_THRESHOLD,
) -> List[Any]:
    """The analyzers of the profiler's first pass over ``columns``: generic
    statistics (reference `ColumnProfiler.scala:122-139`) PLUS the numeric
    statistics of columns the SCHEMA already types as numeric: those don't
    depend on pass-1 type inference, so they share the first scan (the
    reference always defers them to pass 2, `ColumnProfiler.scala:153-171`)."""
    schema = data.schema
    first_pass: List[Any] = [Size()]
    for name in columns:
        first_pass.append(Completeness(name))
        first_pass.append(ApproxCountDistinct(name))
        if schema[name].kind == ColumnKind.STRING and name not in predefined_types:
            first_pass.append(DataType(name))
        elif schema[name].kind.is_numeric and predefined_types.get(
            name, INTEGRAL
        ) in (INTEGRAL, FRACTIONAL):
            # skipped when the user predefines the column as non-numeric
            first_pass += _numeric_analyzers(name, kll_parameters)
    # histograms of DICTIONARY-ENCODED columns whose dictionary is
    # already <= the cardinality threshold join pass 1 (distinct <=
    # dictionary size, so eligibility cannot be decided otherwise after
    # the scan); the reference always needs its third pass for these
    # (`ColumnProfiler.scala:181-205`). Columns the HLL estimate later
    # DISQUALIFIES (estimate error can exceed the threshold even when
    # the true cardinality is under it) are dropped from the profile,
    # preserving reference semantics. Histograms count ORIGINAL values, so
    # running them before the numeric-string cast is exactly right.
    hist_pass1 = {
        name
        for name in columns
        if (
            (size := data.dictionary_size(name)) is not None
            and size <= low_cardinality_histogram_threshold
        )
    }
    return first_pass + [Histogram(name) for name in sorted(hist_pass1)]


@dataclass
class _GenericColumnStatistics:
    num_records: int
    inferred_types: Dict[str, str]
    known_types: Dict[str, str]
    type_detection_histograms: Dict[str, Dict[str, int]]
    approximate_num_distincts: Dict[str, int]
    completenesses: Dict[str, float]
    predefined_types: Dict[str, str]

    def type_of(self, column: str) -> str:
        merged = {**self.inferred_types, **self.known_types, **self.predefined_types}
        return merged[column]


def _extract_generic_statistics(
    columns, schema, results, predefined_types
) -> _GenericColumnStatistics:
    """(reference `ColumnProfiler.scala:358-420`)."""
    num_records = 0
    inferred: Dict[str, str] = {}
    type_hists: Dict[str, Dict[str, int]] = {}
    distincts: Dict[str, int] = {}
    completenesses: Dict[str, float] = {}
    for analyzer, metric in results.metric_map.items():
        if isinstance(analyzer, Size) and metric.value.is_success:
            num_records = int(metric.value.get())
        elif isinstance(analyzer, DataType) and metric.value.is_success:
            if analyzer.column in predefined_types:
                continue
            dist = metric.value.get()
            inferred[analyzer.column] = determine_type(dist)
            type_hists[analyzer.column] = {
                k: v.absolute for k, v in dist.values.items()
            }
        elif isinstance(analyzer, ApproxCountDistinct) and metric.value.is_success:
            distincts[analyzer.column] = int(metric.value.get())
        elif isinstance(analyzer, Completeness) and metric.value.is_success:
            completenesses[analyzer.column] = metric.value.get()

    known: Dict[str, str] = {}
    for cs in schema.columns:
        if cs.name not in columns or cs.name in predefined_types:
            continue
        if cs.kind == ColumnKind.STRING:
            continue
        known[cs.name] = {
            ColumnKind.INTEGRAL: INTEGRAL,
            ColumnKind.FRACTIONAL: FRACTIONAL,
            ColumnKind.BOOLEAN: BOOLEAN,
            ColumnKind.TIMESTAMP: STRING,  # same TODO as the reference
        }.get(cs.kind, UNKNOWN)
    return _GenericColumnStatistics(
        num_records, inferred, known, type_hists, distincts, completenesses,
        predefined_types,
    )


def _cast_numeric_string_columns(columns, data: Dataset, generic):
    """(reference `castColumn`/`castNumericStringColumns`,
    `ColumnProfiler.scala:346-354,294-308`). Returns (dataset, casted names).
    The casted view memoizes on the source dataset (same inferred types ->
    same view), so repeated profiles share one arrow table identity."""
    names = {
        name
        for name in columns
        if data.schema[name].kind == ColumnKind.STRING
        and generic.type_of(name) in (INTEGRAL, FRACTIONAL)
    }
    if not names:
        return data, names
    key = ("__profile_casted__", tuple(sorted(names)))
    casted = data.derived_cache.get(key)
    if casted is None:
        casted = data
        for name in sorted(names):
            casted = casted.with_column_cast_to_f64(name)
        data.derived_cache[key] = casted
    return casted, names


def _find_target_columns_for_histograms(schema, generic, threshold) -> List[str]:
    """(reference `ColumnProfiler.scala:608-630`)."""
    eligible_kinds = (
        ColumnKind.STRING, ColumnKind.BOOLEAN, ColumnKind.INTEGRAL, ColumnKind.FRACTIONAL,
    )
    out = []
    for column, count in generic.approximate_num_distincts.items():
        if column not in schema or schema[column].kind not in eligible_kinds:
            continue
        if generic.type_of(column) not in (STRING, BOOLEAN, INTEGRAL, FRACTIONAL):
            continue
        if count <= threshold:
            out.append(column)
    return out


@dataclass
class _NumericColumnStatistics:
    means: Dict[str, float] = field(default_factory=dict)
    std_devs: Dict[str, float] = field(default_factory=dict)
    minima: Dict[str, float] = field(default_factory=dict)
    maxima: Dict[str, float] = field(default_factory=dict)
    sums: Dict[str, float] = field(default_factory=dict)
    kll: Dict[str, BucketDistribution] = field(default_factory=dict)
    approx_percentiles: Dict[str, List[float]] = field(default_factory=dict)


def _numeric_analyzers(name: str, kll_parameters: Optional[KLLParameters]) -> List[Any]:
    return [
        Minimum(name), Maximum(name), Mean(name),
        StandardDeviation(name), Sum(name),
        KLLSketch(name, kll_parameters),
    ]


def _extract_numeric_statistics(*result_sets) -> _NumericColumnStatistics:
    """(reference `ColumnProfiler.scala:440-520`). Accepts several analyzer
    contexts (pass 1 carries the schema-typed numeric columns, pass 2 the
    casted ones) and merges them."""
    stats = _NumericColumnStatistics()
    for results in result_sets:
        if results is not None:
            _fold_numeric_statistics(stats, results)
    return stats


def _fold_numeric_statistics(stats: _NumericColumnStatistics, results) -> None:
    for analyzer, metric in results.metric_map.items():
        if not metric.value.is_success:
            continue
        if isinstance(analyzer, Mean):
            stats.means[analyzer.column] = metric.value.get()
        elif isinstance(analyzer, StandardDeviation):
            stats.std_devs[analyzer.column] = metric.value.get()
        elif isinstance(analyzer, Minimum):
            stats.minima[analyzer.column] = metric.value.get()
        elif isinstance(analyzer, Maximum):
            stats.maxima[analyzer.column] = metric.value.get()
        elif isinstance(analyzer, Sum):
            stats.sums[analyzer.column] = metric.value.get()
        elif isinstance(analyzer, KLLSketch):
            dist = metric.value.get()
            stats.kll[analyzer.column] = dist
            stats.approx_percentiles[analyzer.column] = sorted(dist.compute_percentiles())


def _create_profiles(columns, generic, numeric_stats, histograms) -> ColumnProfiles:
    """(reference `ColumnProfiler.scala:632-700`)."""
    out: Dict[str, ColumnProfile] = {}
    for name in columns:
        completeness = generic.completenesses.get(name, 0.0)
        approx_distinct = generic.approximate_num_distincts.get(name, 0)
        data_type = generic.type_of(name)
        # predefined types are user-asserted, not inferred (reference
        # `ColumnProfiler.scala:671`)
        inferred = name in generic.inferred_types
        type_counts = generic.type_detection_histograms.get(name, {})
        histogram = histograms.get(name)
        if data_type in (INTEGRAL, FRACTIONAL):
            out[name] = NumericColumnProfile(
                column=name,
                completeness=completeness,
                approximate_num_distinct_values=approx_distinct,
                data_type=data_type,
                is_data_type_inferred=inferred,
                type_counts=type_counts,
                histogram=histogram,
                mean=numeric_stats.means.get(name),
                maximum=numeric_stats.maxima.get(name),
                minimum=numeric_stats.minima.get(name),
                sum=numeric_stats.sums.get(name),
                std_dev=numeric_stats.std_devs.get(name),
                approx_percentiles=numeric_stats.approx_percentiles.get(name),
                kll=numeric_stats.kll.get(name),
            )
        else:
            out[name] = StandardColumnProfile(
                column=name,
                completeness=completeness,
                approximate_num_distinct_values=approx_distinct,
                data_type=data_type,
                is_data_type_inferred=inferred,
                type_counts=type_counts,
                histogram=histogram,
            )
    return ColumnProfiles(out, generic.num_records)


class ColumnProfilerRunner:
    """(reference `profiles/ColumnProfilerRunner.scala:37-113`)."""

    @staticmethod
    def on_data(data: Dataset, device: DeviceLike = None) -> "ColumnProfilerRunBuilder":
        return ColumnProfilerRunBuilder(data, device=device)


class ColumnProfilerRunBuilder:
    """(reference `profiles/ColumnProfilerRunBuilder.scala:29+`)."""

    def __init__(self, data: Dataset, device: DeviceLike = None):
        self.data = data
        self._device = device
        self._columns: Optional[Sequence[str]] = None
        self._print_status_updates = False
        self._cardinality_threshold = DEFAULT_CARDINALITY_THRESHOLD
        self._kll_parameters: Optional[KLLParameters] = None
        self._predefined_types: Dict[str, str] = {}
        self._profiles_path: Optional[str] = None
        self._batch_size: Optional[int] = None
        self._monitor = None
        self._placement: Optional[str] = None

    def restrict_to_columns(self, columns: Sequence[str]):
        self._columns = columns
        return self

    def print_status_updates(self):
        self._print_status_updates = True
        return self

    def with_low_cardinality_histogram_threshold(self, threshold: int):
        self._cardinality_threshold = threshold
        return self

    def set_kll_parameters(self, parameters: KLLParameters):
        self._kll_parameters = parameters
        return self

    def set_predefined_types(self, types: Dict[str, str]):
        self._predefined_types = dict(types)
        return self

    def use_repository(self, repository):
        _refuse_unported(metrics_repository=repository)

    def reuse_existing_results_for_key(self, key, fail_if_results_missing: bool = False):
        _refuse_unported(reuse_existing_results_using_key=key)

    def save_or_append_result(self, key):
        _refuse_unported(save_in_metrics_repository_using_key=key)

    def save_column_profiles_json_to_path(self, path: str):
        self._profiles_path = path
        return self

    def with_batch_size(self, batch_size: int):
        self._batch_size = batch_size
        return self

    def with_monitor(self, monitor):
        self._monitor = monitor
        return self

    def with_placement(self, placement: str):
        """Every pass's ingest tier: ``"device"``, ``"host"`` or ``"auto"``
        (reference `profiles/__init__.py:588`)."""
        self._placement = placement
        return self

    def with_sharding(self, sharding):
        _refuse_unported(sharding=sharding)

    def run(self) -> ColumnProfiles:
        profiles = ColumnProfiler.profile(
            self.data,
            restrict_to_columns=self._columns,
            print_status_updates=self._print_status_updates,
            low_cardinality_histogram_threshold=self._cardinality_threshold,
            kll_parameters=self._kll_parameters,
            predefined_types=self._predefined_types,
            batch_size=self._batch_size,
            monitor=self._monitor,
            device=self._device,
            placement=self._placement,
        )
        if self._profiles_path is not None:
            _write_text_atomic(self._profiles_path, profiles.to_json())
        return profiles


def _write_text_atomic(path: str, text: str) -> None:
    """Write ``text`` to a temporary file beside ``path``, then rename it
    into place, so a reader never sees a half-written file."""
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
