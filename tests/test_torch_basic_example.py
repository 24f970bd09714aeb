"""BASELINE config 1, ``examples/basic_example.py``, on the PyTorch/CUDA port.

The example's checks run through ``deequ_tpu.VerificationSuite`` (JAX on
the CPU, device placement) and ``deequ_tpu_torch.VerificationSuite`` on
``device="cpu"`` over the same five items. Its ``is_unique("id")`` takes
the port's device frequency table (an int64 column, not
dictionary-encoded). Check statuses, constraint statuses and messages are
identical, and so is every metric (Uniqueness, counts and ratios exactly;
the approximate quantile is a KLL sketch over five values, exact too).
"""

from __future__ import annotations

import pyarrow as pa

import deequ_tpu
import deequ_tpu_torch as dq
from examples.example_utils import SAMPLE_ITEMS, items_as_dataset


def _checks(m):
    """The example's two checks, built with package ``m``."""
    return [
        m.Check(m.CheckLevel.ERROR, "integrity checks")
        .has_size(lambda size: size == 5)
        .is_complete("id")
        .is_unique("id")
        .is_complete("productName")
        .is_contained_in("priority", ["high", "low"])
        .is_non_negative("numViews"),
        m.Check(m.CheckLevel.WARNING, "distribution checks")
        .contains_url("description", lambda ratio: ratio >= 0.5)
        .has_approx_quantile("numViews", 0.5, lambda median: median <= 10),
    ]


def _port_dataset() -> dq.Dataset:
    items = SAMPLE_ITEMS
    return dq.Dataset.from_arrow(pa.table({
        "id": pa.array([i.id for i in items], type=pa.int64()),
        "productName": pa.array([i.product_name for i in items], type=pa.string()),
        "description": pa.array([i.description for i in items], type=pa.string()),
        "priority": pa.array([i.priority for i in items], type=pa.string()),
        "numViews": pa.array([i.num_views for i in items], type=pa.int64()),
    }))


def _summary(result):
    checks = [
        (check.description, r.status.value,
         [(str(c.constraint), c.status.value, c.message) for c in r.constraint_results])
        for check, r in result.check_results.items()
    ]
    metrics = {
        (a.name, a.instance): (m.value.get() if m.value.is_success else repr(m.value.exception))
        for a, m in result.metrics.items()
    }
    return result.status.value, checks, metrics


def test_basic_example_matches_reference():
    want = (deequ_tpu.VerificationSuite.on_data(items_as_dataset(*SAMPLE_ITEMS))
            .add_checks(_checks(deequ_tpu)).run())
    monitor = dq.RunMonitor()
    got = (dq.VerificationSuite.on_data(_port_dataset(), device="cpu")
           .add_checks(_checks(dq)).with_monitor(monitor).run())
    assert _summary(got) == _summary(want)
    assert monitor.device_freq_sets == 1


def test_basic_example_reports_the_duplicate():
    """The same checks over items with a repeated id: ``is_unique`` fails
    in both packages, with the same message."""
    items = list(SAMPLE_ITEMS)
    items[4] = type(items[4])(4, *[getattr(items[4], f) for f in
                                   ("product_name", "description", "priority", "num_views")])
    want = (deequ_tpu.VerificationSuite.on_data(items_as_dataset(*items))
            .add_checks(_checks(deequ_tpu)).run())
    table = items_as_dataset(*items).arrow
    got = (dq.VerificationSuite.on_data(dq.Dataset.from_arrow(table), device="cpu")
           .add_checks(_checks(dq)).run())
    assert _summary(got) == _summary(want)
    assert got.status == dq.CheckStatus.ERROR
