"""The scan watchdog of the PyTorch/CUDA port
(``deequ_tpu_torch.reliability.watchdog`` around ``ScanEngine.run``) against
the JAX reference: the reference's ``tests/test_watchdog.py`` (:37-240),
each case through both packages (the port on ``device="cpu"``), with
stalls of 1-3 s under deadlines of 0.5-1 s instead of 30 s. Plus the
port's design change: an abandoned pass stops at its next batch boundary,
so it probes no fault site and folds nothing after its cancel (the
reference's pass runs on, ROADMAP C).

Every drill joins the passes it abandoned (the threads named
``scan-watchdog-<site>``, both packages') before it ends. Tolerances: a
failed-over run's metrics equal the other package's (means within 1e-12
relative); the counters equal.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

import deequ_tpu.reliability as JRel
from deequ_tpu.checks import Check as JCheck, CheckLevel as JLevel
from deequ_tpu.data import Dataset as JDataset
from deequ_tpu.runners.engine import RunMonitor as JMonitor
from deequ_tpu.verification import VerificationSuite as JSuite
import deequ_tpu_torch as dq
import deequ_tpu_torch.reliability as TRel
from deequ_tpu_torch.exceptions import ScanStallError
from deequ_tpu_torch.reliability import (
    SCAN_DEADLINE_ENV,
    RateTracker,
    classify_failure,
    join_abandoned_passes,
    rate_key,
    rate_tracker,
    run_with_deadline,
    scan_deadline_s,
)
from deequ_tpu_torch.runners.engine import RunMonitor

from torch_pairs import reference_isolated  # noqa: F401 - autouse fixture

CPU_DEVICE = rate_key("device", torch.device("cpu"))


@pytest.fixture(autouse=True)
def _clean_rates(monkeypatch):
    """Each test starts with no learned rates and no env deadline in either
    package, leaks neither, and leaves no pass of its own running."""
    monkeypatch.delenv(SCAN_DEADLINE_ENV, raising=False)
    for tracker in (rate_tracker(), JRel.rate_tracker()):
        tracker.clear()
    yield
    assert join_abandoned_passes(60)
    for tracker in (rate_tracker(), JRel.rate_tracker()):
        tracker.clear()


class TestRunWithDeadline:
    def test_value_and_error_pass_through(self):
        monitor = RunMonitor()
        assert run_with_deadline(lambda: 42, 5.0, monitor, "t") == 42
        with pytest.raises(KeyError):
            run_with_deadline(lambda: (_ for _ in ()).throw(KeyError("x")), 5.0, monitor, "t")
        assert monitor.stalls == 0

    def test_deadline_cancels_with_typed_error(self):
        monitor = RunMonitor()
        cancelled = threading.Event()
        t0 = time.perf_counter()
        with pytest.raises(ScanStallError) as err:
            run_with_deadline(lambda: cancelled.wait(10), 0.2, monitor, "device",
                              on_stall=cancelled.set)
        elapsed = time.perf_counter() - t0
        assert elapsed < 2 * 0.2 + 0.5  # cancelled at about the deadline
        assert (monitor.stalls, monitor.device_stalls) == (1, 1)
        assert err.value.deadline_s == 0.2
        assert classify_failure(err.value) == "device"  # the tier failover
        assert cancelled.is_set()  # the pass was told to stop

    def test_the_pass_runs_on_a_named_thread(self):
        names = []
        run_with_deadline(lambda: names.append(threading.current_thread().name), 5.0, None,
                          "host")
        assert names == ["scan-watchdog-host"]


class TestDeadlineDerivation:
    @pytest.mark.parametrize("mod", [JRel, TRel], ids=["jax", "torch"])
    def test_env_override_wins(self, monkeypatch, mod):
        monkeypatch.setenv(SCAN_DEADLINE_ENV, "7.5")
        assert mod.scan_deadline_s(100, "device") == 7.5

    @pytest.mark.parametrize("mod", [JRel, TRel], ids=["jax", "torch"])
    def test_env_zero_or_negative_disables(self, monkeypatch, mod):
        monkeypatch.setenv(SCAN_DEADLINE_ENV, "0")
        assert mod.scan_deadline_s(100, "device") is None
        monkeypatch.setenv(SCAN_DEADLINE_ENV, "-3")
        assert mod.scan_deadline_s(100, "device") is None

    @pytest.mark.parametrize("mod", [JRel, TRel], ids=["jax", "torch"])
    def test_garbage_env_falls_back_to_derived_not_silent_off(self, monkeypatch, mod):
        monkeypatch.setenv(SCAN_DEADLINE_ENV, "60s")
        assert mod.scan_deadline_s(100, "device") is None  # no rate yet either
        mod.rate_tracker().observe("device", rows=10, seconds=10.0)
        assert mod.scan_deadline_s(100, "device") == pytest.approx(1000.0)

    def test_cold_process_runs_unguarded(self):
        assert scan_deadline_s(100, "device") is None

    @pytest.mark.parametrize("mod", [JRel, TRel], ids=["jax", "torch"])
    def test_derived_from_measured_rate_with_floor(self, mod):
        tracker = mod.rate_tracker()
        tracker.observe("device", rows=1000, seconds=1.0)  # 1 ms a row
        assert mod.scan_deadline_s(2000, "device") == 30.0  # 20 s, under the floor
        assert mod.scan_deadline_s(10_000, "device") == pytest.approx(100.0)
        assert mod.scan_deadline_s(10_000, "host") is None  # rates are per tier

    def test_rate_is_per_row_not_per_batch(self):
        from deequ_tpu_torch.reliability.watchdog import DEADLINE_RATE_MULTIPLE

        tracker = RateTracker()
        tracker.observe("host", rows=5120, seconds=0.2)  # 10 micro-batches
        per_row = tracker.per_row_s("host")
        assert max(30.0, DEADLINE_RATE_MULTIPLE * per_row * 32_000_000) > 1000

    def test_ewma_blends_observations(self):
        tracker = RateTracker()
        tracker.observe("device", 1, 1.0)
        tracker.observe("device", 1, 2.0)
        assert tracker.per_row_s("device") == pytest.approx(0.3 * 2.0 + 0.7 * 1.0)

    def test_rates_are_kept_per_kind_of_device(self):
        """A rate learned on the card never sets a CPU pass's deadline."""
        assert CPU_DEVICE == "device@cpu"
        assert rate_key("host") == "host"
        rate_tracker().observe("device", rows=1000, seconds=0.001)
        assert scan_deadline_s(1000, CPU_DEVICE) is None

    def test_engine_pass_feeds_tracker(self):
        from deequ_tpu.analyzers import Mean
        from deequ_tpu.runners.analysis_runner import AnalysisRunner

        x = np.arange(2048, dtype=np.float64)
        AnalysisRunner.do_analysis_run(JDataset.from_dict({"x": x}), [Mean("x")],
                                       batch_size=1024)
        dq.AnalysisRunner.do_analysis_run(dq.Dataset.from_dict({"x": x}), [dq.Mean("x")],
                                          batch_size=1024, device="cpu")
        assert JRel.rate_tracker().per_row_s("device") is not None
        assert rate_tracker().per_row_s(CPU_DEVICE) is not None

    def test_a_failover_pass_falls_back_to_the_failed_tiers_deadline(self):
        """A failover pass with no rate of its own takes the failed tier's
        derived deadline, or the floor when that tier has none either."""
        from deequ_tpu_torch.reliability.watchdog import DEADLINE_FLOOR_S

        host = rate_key("host", torch.device("cpu"))
        assert scan_deadline_s(10_000, host) is None
        assert scan_deadline_s(10_000, host, CPU_DEVICE) == DEADLINE_FLOOR_S
        rate_tracker().observe(CPU_DEVICE, rows=1000, seconds=1.0)  # 1 ms a row
        assert scan_deadline_s(10_000, host, CPU_DEVICE) == pytest.approx(100.0)
        rate_tracker().observe(host, rows=1000, seconds=2.0)  # its own rate wins
        assert scan_deadline_s(10_000, host, CPU_DEVICE) == pytest.approx(200.0)

    def test_a_failover_pass_runs_under_a_deadline_with_the_env_unset(self, monkeypatch):
        """With ``DEEQU_TPU_SCAN_DEADLINE_S`` unset and no rate learned, a
        cold device pass runs unguarded; after its device fault the host
        tier's failover pass still runs under the watchdog, at the floor."""
        from deequ_tpu_torch.reliability import watchdog
        from deequ_tpu_torch.reliability.watchdog import DEADLINE_FLOOR_S

        guarded = []
        run = watchdog.run_with_deadline

        def recording(fn, deadline_s, monitor, site, **kw):
            guarded.append((site, deadline_s))
            return run(fn, deadline_s, monitor, site, **kw)

        monkeypatch.setattr(watchdog, "run_with_deadline", recording)
        monitor = RunMonitor()
        with TRel.inject(TRel.FaultSpec("device_update", "device", at=1)):
            result = stall_run("torch", monitor)
        assert all(m.value.is_success for m in result.metrics.values())
        assert (monitor.device_failovers, monitor.placement) == (1, "host")
        assert guarded == [("host", DEADLINE_FLOOR_S)]
        # a later pass of the same battery is no failover: unguarded again
        # on the device tier, which has learned no rate
        stall_run("torch", RunMonitor())
        assert guarded == [("host", DEADLINE_FLOOR_S)]

    def test_a_background_warm_teaches_no_rate(self):
        from deequ_tpu_torch.runners.engine import warm_fused_program

        data = dq.Dataset.from_dict({"x": np.arange(64, dtype=np.float64)})
        warm_fused_program([dq.Mean("x")], data, batch_size=1024, device="cpu")
        assert rate_tracker().per_row_s(CPU_DEVICE) is None


def settle() -> None:
    """Join both packages' abandoned passes (their threads are named
    ``scan-watchdog-<site>``)."""
    for thread in threading.enumerate():
        if thread.name.startswith("scan-watchdog"):
            thread.join(timeout=60)


def stall_data(m, rows=4096):
    rng = np.random.default_rng(0)
    return m.from_dict({"x": rng.normal(size=rows)})


def stall_check(check, level):
    return (check(level.ERROR, "stall battery")
            .has_mean("x", lambda v: abs(v) < 1)
            .is_complete("x"))


def stall_run(pkg: str, monitor, placement="device", **kw):
    if pkg == "jax":
        return (JSuite.on_data(stall_data(JDataset)).add_check(stall_check(JCheck, JLevel))
                .with_monitor(monitor).with_placement(placement).with_batch_size(1024).run())
    return (dq.VerificationSuite.on_data(stall_data(dq.Dataset), device="cpu")
            .add_check(stall_check(dq.Check, dq.CheckLevel))
            .with_monitor(monitor).with_placement(placement).with_batch_size(1024).run())


@pytest.mark.chaos
class TestStallDrills:
    def test_injected_stall_cancelled_within_2x_deadline_and_fails_over(self, monkeypatch):
        """A stalled (injected) scan is cancelled by the watchdog within 2x
        its deadline and fails over instead of hanging the worker."""
        for pkg in ("jax", "torch"):
            for placement in ("device", "host"):  # warm both tiers first
                stall_run(pkg, RunMonitor() if pkg == "torch" else JMonitor(), placement)
        monkeypatch.setenv(SCAN_DEADLINE_ENV, "1.0")
        out = {}
        for pkg, mod, monitor in (("jax", JRel, JMonitor()), ("torch", TRel, RunMonitor())):
            with mod.inject(mod.FaultSpec("device_update", "stall", at=1, delay_s=3.0)):
                t0 = time.perf_counter()
                result = stall_run(pkg, monitor)
                elapsed = time.perf_counter() - t0
            settle()
            assert elapsed < 2 * 1.0 + 1.5, pkg  # the 1 s deadline, not the 3 s stall
            assert result.status.value == "Success"
            assert all(m.value.is_success for m in result.metrics.values())
            out[pkg] = (monitor, {repr(a): m.value.get() for a, m in result.metrics.items()})
        (jmon, jv), (tmon, tv) = out["jax"], out["torch"]
        for name in ("stalls", "device_stalls", "device_failovers"):
            assert getattr(tmon, name) == getattr(jmon, name) == 1, name
        assert tmon.placement == jmon.placement == "host"
        assert set(tv) == set(jv)
        for key, want in jv.items():
            assert tv[key] == pytest.approx(want, rel=1e-12), key

    def test_an_abandoned_pass_probes_and_folds_nothing_after_its_cancel(self, monkeypatch):
        """The port's design change: once the watchdog abandons a pass (an
        injected 1.5 s stall at batch 1 under a 0.5 s deadline), the pass
        stops at its next batch boundary. Every fault probe is recorded
        with its thread: the abandoned thread probes nothing after the
        cancel, and the device tier folds none of its 8 batches."""
        from deequ_tpu_torch.reliability import faults

        stall_run("torch", RunMonitor(), "host")  # warm the host tier
        probes = []
        fire = faults.FaultInjector.fire

        def recording(self, site, tag=""):
            probes.append((threading.current_thread().name, site, time.perf_counter()))
            return fire(self, site, tag)

        monkeypatch.setattr(faults.FaultInjector, "fire", recording)
        monkeypatch.setenv(SCAN_DEADLINE_ENV, "0.5")
        monkeypatch.setenv("DEEQU_TPU_PREFETCH_DEPTH", "2")  # the feed thread stops too
        monitor = RunMonitor()
        data = stall_data(dq.Dataset, rows=8 * 1024)
        with TRel.inject(TRel.FaultSpec("device_update", "stall", at=1, delay_s=1.5)):
            ctx = dq.AnalysisRunner.do_analysis_run(
                data, [dq.Mean("x"), dq.Completeness("x")], batch_size=1024, device="cpu",
                placement="device", monitor=monitor)
            cancelled_at = time.perf_counter()
            assert join_abandoned_passes(30)
        assert all(m.value.is_success for m in ctx.metric_map.values())
        assert (monitor.stalls, monitor.device_stalls, monitor.device_failovers) == (1, 1, 1)
        zombie = [site for name, site, _ in probes if name == "scan-watchdog-device"]
        # before the stall: the two analyzers, then batch 1's copy and its
        # device_update
        assert zombie == ["analyzer", "analyzer", "device_feed", "device_update"]
        # the pass's thread and its feed thread probed nothing once the run
        # had failed over (the stall's sleep ended a second after that)
        assert all(t < cancelled_at for name, _, t in probes
                   if name in ("scan-watchdog-device", "deequ-ingest-prefetch"))
        assert any(name == "deequ-ingest-prefetch" for name, _, _ in probes)
        assert monitor.device_updates == 0  # not one device batch folded
        assert monitor.placement == "host"

    def test_an_abandoned_host_tier_pass_stops_too(self, monkeypatch):
        """The same on the host tier: a stalled partial's pass folds no
        chunk after its cancel (no ``ingest_fold`` probe from it) and the
        escaped stall raises typed (a host-tier battery has no tier to fail
        over to)."""
        from deequ_tpu_torch.reliability import faults

        stall_run("torch", RunMonitor(), "host")
        probes = []
        fire = faults.FaultInjector.fire

        def recording(self, site, tag=""):
            probes.append((threading.current_thread().name, site))
            return fire(self, site, tag)

        monkeypatch.setattr(faults.FaultInjector, "fire", recording)
        monkeypatch.setenv(SCAN_DEADLINE_ENV, "0.5")
        monitor = RunMonitor()
        with TRel.inject(TRel.FaultSpec("host_partial", "stall", at=1, delay_s=1.5)):
            ctx = dq.AnalysisRunner.do_analysis_run(
                stall_data(dq.Dataset, rows=8 * 1024), [dq.Mean("x")], batch_size=1024,
                device="cpu", placement="host", monitor=monitor)
            assert join_abandoned_passes(30)
        assert ctx.metric_map[dq.Mean("x")].value.is_failure
        assert monitor.stalls == 1 and monitor.device_stalls == 0
        # the partials submitted before the cancel probed; no chunk folded
        # and no state was fetched after it (``compile``: the battery's
        # program, built before the pass when no earlier test built it)
        assert {site for _, site in probes} - {"compile"} == {"analyzer", "host_partial"}
        assert monitor.ingest_folds == 0

    def test_scheduler_requeues_escaped_stall(self):
        """A stall that escapes the engine's failover requeues the job (the
        worker is free) instead of failing it, in both packages."""
        import deequ_tpu.exceptions as JE
        import deequ_tpu.service as JS
        import deequ_tpu_torch.service as TS

        for svc_cls, stall_cls, kw in ((JS.VerificationService, JE.ScanStallError,
                                        {"fleet": False}),
                                       (TS.VerificationService, ScanStallError,
                                        {"device": "cpu"})):
            attempts = []

            def flaky(ctx, attempts=attempts, stall_cls=stall_cls):
                attempts.append(ctx.attempt)
                if len(attempts) == 1:
                    raise stall_cls("device", 1.0, 1.2)
                return "done"

            with svc_cls(workers=1, background_warm=False, **kw) as svc:
                handle = svc.scheduler.submit(flaky, tenant="t", max_retries=1,
                                              retry_backoff_s=0.01)
                assert handle.result(timeout=30) == "done"
            assert attempts == [1, 2]

    def test_stall_counts_on_export_plane_and_probation(self):
        """A job whose monitor recorded a device stall teaches the router
        (probation) and the export plane's counter, in both packages."""
        import deequ_tpu.service as JS
        import deequ_tpu_torch.service as TS

        for svc_cls, kw in ((JS.VerificationService, {"fleet": False}),
                            (TS.VerificationService, {"device": "cpu"})):
            def stalled_then_done(ctx):
                ctx.monitor.bump("stalls")
                ctx.monitor.bump("device_stalls")  # the stall was the device's
                ctx.monitor.placement = "host"
                return "ok"

            with svc_cls(workers=1, background_warm=False, **kw) as svc:
                handle = svc.scheduler.submit(stalled_then_done, tenant="t", signature=("sig",))
                assert handle.result(timeout=30) == "ok"
                counters = svc.json_snapshot()["counters"]
                assert counters["deequ_service_scan_stalls_total"]["tenant=t"] == 1.0
                assert svc.router.decide(("sig",), None) == "host"

    def test_host_tier_stall_does_not_probation_device(self):
        """A HOST-tier hang counts on the export plane but leaves the
        placement routing alone, in both packages."""
        import deequ_tpu.service as JS
        import deequ_tpu_torch.service as TS

        for svc_cls, kw in ((JS.VerificationService, {"fleet": False}),
                            (TS.VerificationService, {"device": "cpu"})):
            def host_stalled(ctx):
                ctx.monitor.bump("stalls")  # the tier was the host: no device_stalls
                ctx.monitor.placement = "device"
                return "ok"

            with svc_cls(workers=1, background_warm=False, **kw) as svc:
                handle = svc.scheduler.submit(host_stalled, tenant="t", signature=("hsig",))
                assert handle.result(timeout=30) == "ok"
                counters = svc.json_snapshot()["counters"]
                assert counters["deequ_service_scan_stalls_total"]["tenant=t"] == 1.0
                assert ("hsig",) not in svc.router._device_suspect
