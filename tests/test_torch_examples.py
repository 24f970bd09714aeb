"""The port's examples suite (``examples_torch/``) on ``device="cpu"``, each
against the JAX package's twin in ``examples/``: the assertions of
``tests/test_examples.py`` on the port's result, then equality with the
reference example's result (metrics, constraint statuses, profiles and
suggestions through their JSON) and with its printed lines.

Tolerances: every float within 1e-12 relative, the port's parity bar for
moments, whose reduction order differs (one ulp of a standard deviation
shows in ``kll_example``'s output); every other value and all text exact.
Printed lines are compared with the timestamps (``dataset_date``, 13-digit
epoch milliseconds) and temporary paths masked. The examples keep the
reference's data sizes.
"""

from __future__ import annotations

import importlib
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

from deequ_tpu_torch import CheckStatus  # noqa: E402
from deequ_tpu_torch.constraints import ConstraintStatus  # noqa: E402

REL = 1e-12

NAMES = [
    "basic_example", "incremental_metrics_example", "update_metrics_on_partitioned_data_example",
    "metrics_repository_example", "anomaly_detection_example", "data_profiling_example",
    "constraint_suggestion_example", "kll_example", "kll_check_example",
    "multi_device_example", "continuous_verification_example",
]

_NUMBER = re.compile(r"-?\d+\.\d+(?:e[-+]?\d+)?|-?\d+(?:e[-+]?\d+)?")
_MASKS = (
    (re.compile(r"\b\d{13}\b"), "<epoch-ms>"),
    (re.compile(r"/tmp/\S+"), "<tmp>"),
)


def run_both(name: str, capsys):
    """(reference result, its printed lines), (port result, its lines)."""
    reference = importlib.import_module(f"examples.{name}")
    port = importlib.import_module(f"examples_torch.{name}")
    capsys.readouterr()
    want = reference.main()
    want_out = capsys.readouterr().out
    got = port.main(device="cpu")
    got_out = capsys.readouterr().out
    assert_lines_equal(got_out, want_out)
    return (want, want_out), (got, got_out)


def _close(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        if isinstance(a, (int, float)) and isinstance(b, (int, float)):
            if math.isnan(a) and math.isnan(b):
                return True
            return a == b or math.isclose(a, b, rel_tol=REL)
        return False
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    return a == b


def assert_close(got, want) -> None:
    assert _close(got, want), (got, want)


def assert_lines_equal(got: str, want: str) -> None:
    def masked(text: str):
        for pattern, mask in _MASKS:
            text = pattern.sub(mask, text)
        return text.splitlines()

    got_lines, want_lines = masked(got), masked(want)
    assert len(got_lines) == len(want_lines), (got, want)
    for g, w in zip(got_lines, want_lines):
        assert _NUMBER.sub("#", g) == _NUMBER.sub("#", w), (g, w)
        numbers = [(float(x), float(y)) for x, y in zip(_NUMBER.findall(g), _NUMBER.findall(w))]
        assert all(x == y or math.isclose(x, y, rel_tol=REL) for x, y in numbers), (g, w)


def metric_values(metric_map) -> dict:
    out = {}
    for analyzer, metric in metric_map.items():
        value = metric.value.get()
        if hasattr(value, "buckets"):
            value = repr(value.buckets)
        elif hasattr(value, "values") and not isinstance(value, (int, float)):
            value = sorted((k, e.absolute) for k, e in value.values.items())
        out[repr(analyzer)] = value
    return out


def statuses(result) -> dict:
    return {str(cr.constraint): cr.status.name
            for check_result in result.check_results.values()
            for cr in check_result.constraint_results}


def assert_same_verification(got, want) -> None:
    assert got.status.name == want.status.name
    assert statuses(got) == statuses(want)
    assert_close(json.loads(got.success_metrics_as_json()),
                 json.loads(want.success_metrics_as_json()))
    assert_close(json.loads(got.check_results_as_json()),
                 json.loads(want.check_results_as_json()))


def test_basic_example(capsys):
    (want, _), (result, out) = run_both("basic_example", capsys)
    assert result.status == CheckStatus.ERROR
    failed = [c for c, s in statuses(result).items() if s != ConstraintStatus.SUCCESS.name]
    assert len(failed) == 2
    assert "We found errors" in out
    assert_same_verification(result, want)


def test_incremental_metrics_example(capsys):
    from deequ_tpu_torch.analyzers import ApproxCountDistinct, Completeness, Size

    (want, _), ((first, combined), _) = run_both("incremental_metrics_example", capsys)
    assert first.metric(Size()).value.get() == 3.0
    assert combined.metric(Size()).value.get() == 5.0
    assert combined.metric(ApproxCountDistinct("id")).value.get() == 5.0
    assert combined.metric(Completeness("description")).value.get() == pytest.approx(0.4)
    assert_close([metric_values(first.metric_map), metric_values(combined.metric_map)],
                 [metric_values(w.metric_map) for w in want])


def test_update_metrics_on_partitioned_data_example(capsys):
    from deequ_tpu_torch.analyzers import Completeness

    (want, _), ((table, updated), _) = run_both(
        "update_metrics_on_partitioned_data_example", capsys)
    assert table.metric(Completeness("manufacturerName")).value.get() == 1.0
    assert updated.metric(Completeness("manufacturerName")).value.get() == pytest.approx(6 / 7)
    assert_close([metric_values(table.metric_map), metric_values(updated.metric_map)],
                 [metric_values(w.metric_map) for w in want])


def test_metrics_repository_example(capsys):
    (want, _), (frame, out) = run_both("metrics_repository_example", capsys)
    assert "completeness of the productName column is: 0.8" in out
    assert len(frame) == 5

    def drop(f):  # the frame's rows come in the order of a dict of metrics
        return sorted(f.drop(columns=["dataset_date"]).to_dict("records"),
                      key=lambda r: (r["entity"], r["instance"], r["name"]))

    assert_close(drop(frame), drop(want))


def test_anomaly_detection_example(capsys):
    (want, _), (result, out) = run_both("anomaly_detection_example", capsys)
    assert result.status != CheckStatus.SUCCESS
    assert "Anomaly detected" in out
    assert_same_verification(result, want)


def test_data_profiling_example(capsys):
    from deequ_tpu_torch.profiles import NumericColumnProfile

    (want, _), (result, _) = run_both("data_profiling_example", capsys)
    total = result.profiles["totalNumber"]
    assert isinstance(total, NumericColumnProfile)
    assert total.minimum == 1.0
    assert total.maximum == 20.0
    assert total.mean == pytest.approx(11.0)
    assert total.data_type == "Fractional"
    status = result.profiles["status"]
    hist = {k: v.absolute for k, v in status.histogram.values.items()}
    assert hist == {"DELAYED": 4, "IN_TRANSIT": 2, "UNKNOWN": 2}
    assert_close(json.loads(result.to_json()), json.loads(want.to_json()))


def test_constraint_suggestion_example(capsys):
    (want, _), (result, _) = run_both("constraint_suggestion_example", capsys)
    suggestions = result.all_suggestions
    assert suggestions
    columns = {s.column_name for s in suggestions}
    assert {"productName", "status"} <= columns
    assert all(s.code_for_constraint for s in suggestions)
    assert_close(json.loads(result.to_json()), json.loads(want.to_json()))


def test_kll_example(capsys):
    from deequ_tpu_torch.profiles import NumericColumnProfile

    (want, _), (result, _) = run_both("kll_example", capsys)
    num_views = result.column_profiles["numViews"]
    assert isinstance(num_views, NumericColumnProfile)
    assert num_views.kll is not None
    assert num_views.kll.parameters == [0.64, 2.0]
    assert len(num_views.kll.buckets) == 2
    assert sum(b.count for b in num_views.kll.buckets) == 5
    assert_close(json.loads(result.to_json()), json.loads(want.to_json()))
    assert_close(num_views.kll.data, want.column_profiles["numViews"].kll.data)


def test_kll_check_example(capsys):
    (want, _), (result, out) = run_both("kll_check_example", capsys)
    assert result.status == CheckStatus.ERROR
    failed = [s for s in statuses(result).values() if s != ConstraintStatus.SUCCESS.name]
    assert len(failed) == 2
    assert "We found errors" in out
    assert_same_verification(result, want)


def test_multi_device_example(capsys):
    (want, _), ((sharded, merged, offline), out) = run_both("multi_device_example", capsys)
    assert set(sharded) == set(merged) == set(offline)
    assert sharded["Size"] == 8 * 4096
    assert "all three distribution modes agree" in out
    assert_close([sharded, merged, offline], list(want))


def test_continuous_verification_example(capsys):
    (want, _), ((stream, flaky, shed, snapshot), out) = run_both(
        "continuous_verification_example", capsys)
    assert [s.name for s in stream] == ["SUCCESS", "SUCCESS", "WARNING"]
    assert flaky.attempts == 2
    assert flaky.result().status == CheckStatus.SUCCESS
    assert shed > 0
    counters = snapshot["counters"]
    assert counters["deequ_service_jobs_shed_total"]["tenant=burst"] == shed
    assert counters["deequ_service_stream_batches_total"][
        "dataset=clickstream,tenant=tenant-a"] == 3
    assert "ServiceOverloaded" in out and "--- /metrics" in out
    w_stream, w_flaky, w_shed, w_snapshot = want
    assert [s.name for s in w_stream] == [s.name for s in stream]
    assert (w_flaky.attempts, w_shed) == (flaky.attempts, shed)
    for series in ("deequ_service_jobs_shed_total", "deequ_service_stream_batches_total"):
        assert counters[series] == w_snapshot["counters"][series]


def test_an_example_runs_on_the_card_by_default():
    """``python -m examples_torch.<name>`` defaults to ``--device cuda``:
    without a card it raises and prints no result."""
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO_ROOT))
    out = subprocess.run([sys.executable, "-m", "examples_torch.basic_example"], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr and "We found errors" not in out.stdout


_MARK = "=== example "
_ALL_MAINS = (
    "import importlib, sys\n"
    f"for name in {NAMES!r}:\n"
    f"    print({_MARK!r} + name, flush=True)\n"
    "    importlib.import_module('examples_torch.' + name).main(device='cpu')\n"
    "    sys.stdout.flush()\n"
)


def _example_env():
    import os

    # a fixed hash seed: a metrics frame lists its rows in the order of a
    # set of analyzers, which follows the process's string hashes
    return dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO_ROOT),
                PYTHONHASHSEED="0")


@pytest.fixture(scope="module")
def mains_output() -> dict:
    """What each example's ``main(device="cpu")`` prints, from one process."""
    out = subprocess.run([sys.executable, "-c", _ALL_MAINS], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=600, env=_example_env())
    assert out.returncode == 0, out.stderr[-3000:]
    chunks = out.stdout.split(_MARK)[1:]
    return {chunk.split("\n", 1)[0]: chunk.split("\n", 1)[1] for chunk in chunks}


@pytest.mark.parametrize("name", NAMES)
def test_each_example_runs_as_a_module(name, mains_output):
    """``python -m examples_torch.<name> --device cpu`` prints what the
    example's ``main(device="cpu")`` prints."""
    out = subprocess.run([sys.executable, "-m", f"examples_torch.{name}", "--device", "cpu"],
                         cwd=REPO_ROOT, capture_output=True, text=True, timeout=300,
                         env=_example_env())
    assert out.returncode == 0, out.stderr[-3000:]
    assert_lines_equal(out.stdout, mains_output[name])
