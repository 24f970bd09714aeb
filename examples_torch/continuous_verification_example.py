"""Continuous verification service: multiple tenants sharing one scheduler,
streaming micro-batch sessions with checks evaluated on every merge, a
deliberately injected transient failure that retries to success, admission
control shedding a burst, and the Prometheus/JSON export plane.

The one-shot examples call ``VerificationSuite.run()`` directly; a
production deployment instead keeps ONE `VerificationService` per process
and routes every tenant's work through it — built kernels and warm
batteries are shared, cold batteries warm off the queue, and an operator
scrapes ``/metrics``.
"""

from __future__ import annotations

import numpy as np

from deequ_tpu_torch import Check, CheckLevel, CheckStatus, Dataset, VerificationSuite
from deequ_tpu_torch.service import (
    Priority,
    ServiceOverloaded,
    TransientFailure,
    VerificationService,
)

from . import run_main


def clickstream_batch(rows: int, seed: int, null_fraction: float = 0.0) -> Dataset:
    rng = np.random.default_rng(seed)
    ids = np.arange(rows) + seed * 1_000_000
    latency = rng.lognormal(3.0, 0.3, rows)
    if null_fraction:
        # genuine Arrow NULLs (NaN would count as present for Completeness)
        drop = rng.random(rows) < null_fraction
        latency = [None if d else float(v) for d, v in zip(drop, latency)]
    return Dataset.from_dict(
        {
            "event_id": ids,
            "latency_ms": latency,
            "country": rng.choice(["US", "DE", "JP"], rows),
        }
    )


def main(device="cuda"):
    service = VerificationService(workers=2, max_queue_depth=4, device=device)

    # -- tenant A: a streaming session over a growing clickstream ----------
    checks = [
        Check(CheckLevel.ERROR, "clickstream integrity")
        .is_complete("event_id")
        .is_unique("event_id"),
        Check(CheckLevel.WARNING, "latency quality").has_completeness(
            "latency_ms", lambda c: c > 0.95
        ),
    ]
    session = service.session("tenant-a", "clickstream", checks)
    stream_statuses = []
    for batch_no in range(3):
        # batch 2 arrives with 20% nulls: the WARNING surfaces on THAT
        # merge, mid-stream, not at end-of-day
        batch = clickstream_batch(
            500, seed=batch_no, null_fraction=0.2 if batch_no == 2 else 0.0
        )
        result = session.ingest(batch)
        stream_statuses.append(result.status)
        print(f"[tenant-a] batch {batch_no}: {result.status.value}")

    # -- tenant B: one-shot jobs, one of which fails transiently -----------
    orders = Dataset.from_dict(
        {"order_id": [1, 2, 3, 4, 5], "amount": [10.0, 20.5, 7.0, 99.0, 3.2]}
    )
    order_check = Check(CheckLevel.ERROR, "orders").is_complete(
        "order_id"
    ).is_non_negative("amount")
    ok_handle = service.submit_verification(
        orders, [order_check], tenant="tenant-b", priority=Priority.HIGH
    )

    # injected fault: the first attempt dies with a TransientFailure (a
    # flaky feed link, say); the scheduler retries with backoff and the
    # second attempt verifies for real
    attempts = []

    def flaky_verification(ctx):
        attempts.append(ctx.attempt)
        if ctx.attempt == 1:
            raise TransientFailure("injected: feed link reset mid-run")
        return VerificationSuite.do_verification_run(
            orders, [order_check], monitor=ctx.monitor, placement=ctx.placement,
            device=service.device,
        )

    flaky_handle = service.scheduler.submit(
        flaky_verification, tenant="tenant-b", max_retries=2, retry_backoff_s=0.02
    )

    ok_result = ok_handle.result(timeout=300)
    flaky_result = flaky_handle.result(timeout=300)
    print(f"[tenant-b] one-shot: {ok_result.status.value}")
    print(
        f"[tenant-b] flaky job: {flaky_result.status.value} after "
        f"{flaky_handle.attempts} attempts (injected failure retried)"
    )

    # -- admission control: a burst beyond the queue bound is SHED ---------
    import threading

    gate = threading.Event()
    for _ in range(2):  # occupy both workers so the queue actually fills
        service.scheduler.submit(lambda ctx: gate.wait(60))
    shed = 0
    for _ in range(12):
        try:
            service.scheduler.submit(lambda ctx: None, tenant="burst")
        except ServiceOverloaded:
            shed += 1
    gate.set()
    print(f"[burst] {shed} of 12 burst jobs shed with ServiceOverloaded")

    snapshot = service.json_snapshot()
    prom = service.prometheus_text()
    print("\n--- /metrics (excerpt) ---")
    for line in prom.splitlines():
        if "jobs_" in line or "queue_depth" in line or "stream_" in line:
            print(line)

    service.close()
    return stream_statuses, flaky_handle, shed, snapshot


if __name__ == "__main__":
    statuses, handle, shed, _ = run_main(main)
    assert statuses[2] == CheckStatus.WARNING, "mid-stream anomaly must surface"
    assert handle.attempts == 2 and shed > 0
