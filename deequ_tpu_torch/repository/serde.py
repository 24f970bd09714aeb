"""JSON serde for analysis results — the analyzer <-> JSON name mapping IS
the persistence schema (reference `repository/AnalysisResultSerde.scala`,
whose Gson serializers define the same contract for the JVM).

Only string predicates serialize; callable predicates are rejected (the
reference's predicates are always SQL strings).

A copy of the JAX package's serde, so a history written by either package
reads in the other.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from ..analyzers import (
    Analyzer,
    ApproxCountDistinct,
    ApproxQuantile,
    ApproxQuantiles,
    Completeness,
    Compliance,
    Correlation,
    CountDistinct,
    DataType,
    Distinctness,
    Entropy,
    Histogram,
    KLLParameters,
    KLLSketch,
    Maximum,
    MaxLength,
    Mean,
    Minimum,
    MinLength,
    MutualInformation,
    PatternMatch,
    Size,
    StandardDeviation,
    Sum,
    Uniqueness,
    UniqueValueRatio,
)
from ..metrics import (
    BucketDistribution,
    BucketValue,
    Distribution,
    DistributionValue,
    DoubleMetric,
    Entity,
    HistogramMetric,
    KeyedDoubleMetric,
    KLLMetric,
    Metric,
    Success,
)
from ..runners.context import AnalyzerContext


class SerializationError(ValueError):
    pass


#: Version of the metrics-history JSON layout. Bump on ANY change to the
#: analyzer<->JSON mapping or metric payload shapes; the loader refuses
#: newer versions instead of misreading them. v1 layout is frozen by
#: tests/test_state_serde.py::TestFormatVersioning::test_v1_json_layout_pinned.
SERDE_FORMAT_VERSION = 1


def _ser_where(where) -> Optional[str]:
    if where is None:
        return None
    if isinstance(where, str):
        return where
    raise SerializationError("callable predicates are not serializable")


def serialize_analyzer(analyzer: Analyzer) -> Dict[str, Any]:
    t = type(analyzer).__name__
    d: Dict[str, Any] = {"analyzerName": t}
    if isinstance(analyzer, Size):
        d["where"] = _ser_where(analyzer.where)
    elif isinstance(analyzer, (Completeness, Minimum, Maximum, Mean, Sum,
                               StandardDeviation, MinLength, MaxLength,
                               ApproxCountDistinct, DataType)):
        d["column"] = analyzer.column
        d["where"] = _ser_where(analyzer.where)
    elif isinstance(analyzer, Compliance):
        d["instance"] = analyzer.instance_name
        d["predicate"] = _ser_where(analyzer.predicate)
        d["where"] = _ser_where(analyzer.where)
    elif isinstance(analyzer, PatternMatch):
        d["column"] = analyzer.column
        d["pattern"] = analyzer.pattern
        d["where"] = _ser_where(analyzer.where)
    elif isinstance(analyzer, Correlation):
        d["firstColumn"] = analyzer.first_column
        d["secondColumn"] = analyzer.second_column
        d["where"] = _ser_where(analyzer.where)
    elif isinstance(analyzer, ApproxQuantile):
        d["column"] = analyzer.column
        d["quantile"] = analyzer.quantile
        d["relativeError"] = analyzer.relative_error
        d["where"] = _ser_where(analyzer.where)
    elif isinstance(analyzer, ApproxQuantiles):
        d["column"] = analyzer.column
        d["quantiles"] = list(analyzer.quantiles)
        d["relativeError"] = analyzer.relative_error
        d["where"] = _ser_where(analyzer.where)
    elif isinstance(analyzer, KLLSketch):
        d["column"] = analyzer.column
        d["where"] = _ser_where(analyzer.where)
        p = analyzer.kll_parameters
        d["kllParameters"] = (
            None
            if p is None
            else {
                "sketchSize": p.sketch_size,
                "shrinkingFactor": p.shrinking_factor,
                "numberOfBuckets": p.number_of_buckets,
            }
        )
    elif isinstance(analyzer, (Uniqueness, Distinctness, UniqueValueRatio,
                               CountDistinct, MutualInformation, Entropy)):
        d["columns"] = list(analyzer.columns)
    elif isinstance(analyzer, Histogram):
        if analyzer.binning_func is not None:
            raise SerializationError("Histogram with binning function is not serializable")
        d["column"] = analyzer.column
        d["maxDetailBins"] = analyzer.max_detail_bins
    else:
        raise SerializationError(f"Unable to serialize analyzer {analyzer}")
    return d


def deserialize_analyzer(d: Dict[str, Any]) -> Analyzer:
    name = d["analyzerName"]
    where = d.get("where")
    if name == "Size":
        return Size(where=where)
    if name in ("Completeness", "Minimum", "Maximum", "Mean", "Sum",
                "StandardDeviation", "MinLength", "MaxLength",
                "ApproxCountDistinct", "DataType"):
        cls = {
            "Completeness": Completeness, "Minimum": Minimum, "Maximum": Maximum,
            "Mean": Mean, "Sum": Sum, "StandardDeviation": StandardDeviation,
            "MinLength": MinLength, "MaxLength": MaxLength,
            "ApproxCountDistinct": ApproxCountDistinct, "DataType": DataType,
        }[name]
        return cls(d["column"], where)
    if name == "Compliance":
        return Compliance(d["instance"], d["predicate"], where)
    if name == "PatternMatch":
        return PatternMatch(d["column"], d["pattern"], where)
    if name == "Correlation":
        return Correlation(d["firstColumn"], d["secondColumn"], where)
    if name == "ApproxQuantile":
        return ApproxQuantile(d["column"], d["quantile"], d["relativeError"], where)
    if name == "ApproxQuantiles":
        return ApproxQuantiles(d["column"], tuple(d["quantiles"]), d["relativeError"], where=where)
    if name == "KLLSketch":
        p = d.get("kllParameters")
        params = (
            None
            if p is None
            else KLLParameters(p["sketchSize"], p["shrinkingFactor"], p["numberOfBuckets"])
        )
        return KLLSketch(d["column"], params, where)
    if name in ("Uniqueness", "Distinctness", "UniqueValueRatio", "CountDistinct",
                "MutualInformation", "Entropy"):
        cls = {
            "Uniqueness": Uniqueness, "Distinctness": Distinctness,
            "UniqueValueRatio": UniqueValueRatio, "CountDistinct": CountDistinct,
            "MutualInformation": MutualInformation, "Entropy": Entropy,
        }[name]
        return cls(tuple(d["columns"]))
    if name == "Histogram":
        return Histogram(d["column"], None, d["maxDetailBins"])
    raise SerializationError(f"Unable to deserialize analyzer {name}")


def serialize_metric(metric: Metric) -> Dict[str, Any]:
    base = {
        "entity": metric.entity.value,
        "instance": metric.instance,
        "name": metric.name,
    }
    if metric.value.is_failure:
        # failed metrics round-trip as failures (the reference persists only
        # successful runs in practice; we keep the error string)
        base["metricName"] = "DoubleMetric"
        base["error"] = str(metric.value.exception)
        return base
    value = metric.value.get()
    if isinstance(metric, HistogramMetric):
        base["metricName"] = "HistogramMetric"
        base["column"] = metric.column
        base["numberOfBins"] = value.number_of_bins
        base["values"] = {
            k: {"absolute": v.absolute, "ratio": v.ratio} for k, v in value.values.items()
        }
    elif isinstance(metric, KLLMetric):
        base["metricName"] = "KLLMetric"
        base["buckets"] = [
            {"lowValue": b.low_value, "highValue": b.high_value, "count": b.count}
            for b in value.buckets
        ]
        base["parameters"] = list(value.parameters)
        base["data"] = [list(level) for level in value.data]
    elif isinstance(metric, KeyedDoubleMetric):
        base["metricName"] = "KeyedDoubleMetric"
        base["value"] = dict(value)
    else:
        base["metricName"] = "DoubleMetric"
        base["value"] = float(value)
    return base


def deserialize_metric(d: Dict[str, Any]) -> Metric:
    entity = Entity(d["entity"])
    instance = d["instance"]
    name = d["name"]
    if "error" in d:
        from ..exceptions import MetricCalculationRuntimeException
        from ..metrics import Failure

        return DoubleMetric(
            entity, name, instance, Failure(MetricCalculationRuntimeException(d["error"]))
        )
    kind = d["metricName"]
    if kind == "HistogramMetric":
        dist = Distribution(
            {
                k: DistributionValue(int(v["absolute"]), float(v["ratio"]))
                for k, v in d["values"].items()
            },
            number_of_bins=d["numberOfBins"],
        )
        return HistogramMetric(entity, name, instance, Success(dist), d.get("column", instance))
    if kind == "KLLMetric":
        dist = BucketDistribution(
            [BucketValue(b["lowValue"], b["highValue"], int(b["count"])) for b in d["buckets"]],
            list(d["parameters"]),
            [list(level) for level in d["data"]],
        )
        return KLLMetric(entity, name, instance, Success(dist))
    if kind == "KeyedDoubleMetric":
        return KeyedDoubleMetric(entity, name, instance, Success(dict(d["value"])))
    return DoubleMetric(entity, name, instance, Success(float(d["value"])))


def serialize_result(result) -> Dict[str, Any]:
    from . import AnalysisResult

    assert isinstance(result, AnalysisResult)
    pairs = []
    for analyzer, metric in result.analyzer_context.metric_map.items():
        try:
            pairs.append(
                {"analyzer": serialize_analyzer(analyzer), "metric": serialize_metric(metric)}
            )
        except SerializationError:
            continue  # skip non-serializable analyzers, keep the rest
    payload = {
        "formatVersion": SERDE_FORMAT_VERSION,
        "resultKey": {
            "dataSetDate": result.result_key.data_set_date,
            "tags": result.result_key.tags_dict,
        },
        "analyzerContext": {"metricMap": pairs},
    }
    # per-ENTRY content checksum over the canonical JSON of everything
    # above: one flipped byte in one entry fails exactly that entry's
    # verification, so the loader can quarantine it and keep serving the
    # rest of the history (a whole-file checksum would poison every query)
    from ..integrity import checksum_json

    payload["checksum"] = checksum_json(
        {k: v for k, v in payload.items() if k != "checksum"}
    )
    return payload


def deserialize_result(d: Dict[str, Any], *, source: str = "<memory>"):
    from . import AnalysisResult, ResultKey
    from ..exceptions import CorruptStateError

    # payloads from before versioning (round <=3) carry no marker and ARE
    # the v1 layout; anything newer than this build understands is refused
    version = int(d.get("formatVersion", 1))
    if version > SERDE_FORMAT_VERSION or version < 1:
        from ..exceptions import UnsupportedFormatVersionError

        raise UnsupportedFormatVersionError(
            "metrics-history JSON", version, SERDE_FORMAT_VERSION
        )
    if "checksum" in d:
        from ..integrity import verify_json_checksum

        verify_json_checksum(
            {k: v for k, v in d.items() if k != "checksum"},
            d["checksum"], "metrics-repository entry", source,
        )
    else:
        from ..integrity import warn_once_unchecksummed

        warn_once_unchecksummed("metrics-repository entry", source)
    try:
        key = ResultKey(d["resultKey"]["dataSetDate"], d["resultKey"].get("tags", {}))
        metric_map = {}
        for pair in d["analyzerContext"]["metricMap"]:
            analyzer = deserialize_analyzer(pair["analyzer"])
            metric_map[analyzer] = deserialize_metric(pair["metric"])
    except (KeyError, TypeError, ValueError) as exc:
        # a structurally-torn entry that somehow kept a valid checksum (or
        # never had one) still surfaces as the one typed error the
        # quarantine path keys on, not a shape-dependent crash
        raise CorruptStateError(
            "metrics-repository entry", source, str(exc)
        ) from exc
    return AnalysisResult(key, AnalyzerContext(metric_map))


def serialize_results(results: List) -> str:
    return json.dumps([serialize_result(r) for r in results])


def deserialize_results(payload: str) -> List:
    return [deserialize_result(d) for d in json.loads(payload)]
