"""The reliability layer of the PyTorch/CUDA port
(``deequ_tpu_torch.reliability.isolation``, the runner's resilient pass,
the service's device-failure probation) against the JAX reference: the
reference's ``tests/test_reliability.py`` classes ``TestClassification``,
``TestAnalyzerIsolation``, ``TestTierFailover`` and ``TestRouterLearning``
(:128-572), each case run through both packages with the same seeded data
and the same armed fault (the port on ``device="cpu"``), plus the port's
own cases: torch's OOM and CUDA error texts in ``classify_failure``, a
fault of the port's own kernels raising out of every layer, the mesh's
pass-level re-shard on the device tier (the reference's
``tests/test_elastic_mesh.py:170``) and a raw device error inside the
elastic fold.

Tolerances: counts, minima, maxima and HLL-derived metrics equal; means,
sums and standard deviations within 1e-12 relative; a failed-over run (the
host tier in both packages, at the same batch size) the same. The
reliability counters (``device_failovers``, ``batch_bisections``,
``isolation_reruns``, ``stalls``), the passes and the degraded set are
equal in both packages.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import deequ_tpu.analyzers as J
import deequ_tpu.checks as JC
import deequ_tpu.exceptions as JE
import deequ_tpu.reliability as JRel
from deequ_tpu.data import Dataset as JDataset
from deequ_tpu.runners import AnalysisRunner as JRunner
from deequ_tpu.runners.engine import RunMonitor as JMonitor
from deequ_tpu.verification import VerificationSuite as JSuite
import deequ_tpu_torch as dq
import deequ_tpu_torch.analyzers as T
import deequ_tpu_torch.exceptions as TE
import deequ_tpu_torch.reliability as TRel
from deequ_tpu_torch.kernels.build import KernelBuildError, KernelLaunchError
from deequ_tpu_torch.reliability import classify_failure

from torch_pairs import reference_isolated  # noqa: F401 - autouse fixture

MOMENTS = ("Mean", "Sum", "StandardDeviation")
COUNTERS = ("device_failovers", "batch_bisections", "isolation_reruns", "stalls", "passes")


class Pkg:
    def __init__(self, name, A, C, E, R, Dataset, Runner, Suite, Monitor, kw):
        self.name, self.A, self.C, self.E, self.R = name, A, C, E, R
        self.Dataset, self.Runner, self.Suite, self.Monitor, self.kw = (
            Dataset, Runner, Suite, Monitor, kw)

    def run(self, data, analyzers, **kw):
        return self.Runner.do_analysis_run(data, analyzers, **self.kw, **kw)

    def suite(self, data):
        return self.Suite.on_data(data, **self.kw)


REF = Pkg("jax", J, JC, JE, JRel, JDataset, JRunner, JSuite, JMonitor, {})
PORT = Pkg("torch", T, dq, TE, TRel, dq.Dataset, dq.AnalysisRunner, dq.VerificationSuite,
           dq.RunMonitor, {"device": "cpu"})
BOTH = (REF, PORT)


def numeric_data(m, rows=8192, seed=0, with_group=False):
    rng = np.random.default_rng(seed)
    cols = {"x": rng.normal(size=rows), "y": rng.normal(5.0, 2.0, rows)}
    if with_group:
        cols["g"] = [f"id_{i}" for i in range(rows)]  # high cardinality
    return m.Dataset.from_dict(cols)


def ten_analyzer_battery(m):
    A = m.A
    return [A.Size(), A.Completeness("x"), A.Mean("x"), A.Sum("x"), A.Minimum("x"),
            A.Maximum("x"), A.StandardDeviation("x"), A.Mean("y"), A.Sum("y"),
            A.ApproxCountDistinct("x")]


def eight_analyzer_battery(m):
    A = m.A
    return [A.Completeness("x"), A.Mean("x"), A.Sum("x"), A.Minimum("x"), A.Maximum("x"),
            A.StandardDeviation("x"), A.Mean("y"), A.Sum("y")]


def faulted(m, specs, fn):
    """``fn()`` with ``specs`` armed in ``m``'s injector (cleared after);
    returns (fn's value, the faults fired)."""
    with m.R.inject(*(m.R.FaultSpec(**s) for s in specs)) as inj:
        value = fn()
    return value, inj.fired


def values(ctx) -> dict:
    """Metric values by analyzer repr; a failure as its exception's type."""
    out = {}
    for a, metric in ctx.metric_map.items():
        if metric.value.is_failure:
            out[repr(a)] = ("Failure", type(metric.value.exception).__name__)
        else:
            out[repr(a)] = metric.value.get()
    return out


def assert_same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key, w in want.items():
        if key.split("(")[0] in MOMENTS and isinstance(w, float):
            assert got[key] == pytest.approx(w, rel=1e-12), key
        else:
            assert got[key] == w, key


def assert_counters(jmon, tmon) -> None:
    for name in COUNTERS:
        assert getattr(tmon, name) == getattr(jmon, name), name
    assert list(tmon.degraded) == list(jmon.degraded)


# ---------------------------------------------------------------------------
# TestClassification (:128-136) and the port's torch texts
# ---------------------------------------------------------------------------


class TestClassification:
    @pytest.mark.parametrize("m", BOTH, ids=["jax", "torch"])
    def test_typed_taxonomy(self, m):
        assert m.R.classify_failure(m.E.DeviceOOMException("boom")) == "oom"
        assert m.R.classify_failure(m.E.DeviceFailureException("dead")) == "device"
        assert m.R.classify_failure(m.E.PoisonedBatchException(3)) == "data"
        assert m.R.classify_failure(ValueError("nope")) == "data"
        assert m.R.classify_failure(m.E.ShardLossError([3], "x")) == "mesh"
        assert m.R.classify_failure(m.E.ScanStallError("device", 1.0, 1.2)) == "device"
        assert m.R.classify_failure(m.E.FeedStallError("prefetch")) == "device"
        assert m.R.classify_failure(m.E.CorruptStateError("blob", "x")) == "data"

    @pytest.mark.parametrize("exc,kind", [
        (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), "oom"),
        (RuntimeError("CUDA error: out of memory"), "oom"),
        (RuntimeError("CUDA error: an illegal memory access was encountered"), "kernel"),
        (RuntimeError("CUDA error: device-side assert triggered"), "kernel"),
        (RuntimeError("cudaErrorLaunchFailure: unspecified launch failure"), "kernel"),
        (RuntimeError("an illegal memory access was encountered"), "kernel"),
        (RuntimeError("CUDA error: misaligned address"), "kernel"),
        (RuntimeError("CUDA error: an illegal instruction was encountered"), "kernel"),
        (RuntimeError("CUDA error: uncorrectable ECC error encountered"), "device"),
        (RuntimeError("cudaErrorDevicesUnavailable: all CUDA-capable devices are busy"),
         "device"),
        (KernelLaunchError("CUDA kernel scan_reduce failed to launch: cudaError 700"), "kernel"),
        (KernelBuildError("nvcc failed"), "kernel"),
        (RuntimeError("INTERNAL: an XLA status phrase"), "data"),
        (ValueError("CUDA error: not a runtime error"), "data"),
    ])
    def test_torch_errors(self, exc, kind):
        """The port reads torch's types and texts, not XLA status phrases."""
        assert classify_failure(exc) == kind

    def test_the_reference_reads_xla_phrases(self):
        assert JRel.classify_failure(RuntimeError("RESOURCE_EXHAUSTED: oom")) == "oom"
        assert JRel.classify_failure(RuntimeError("INTERNAL: device lost")) == "device"


# ---------------------------------------------------------------------------
# TestAnalyzerIsolation (:139-281)
# ---------------------------------------------------------------------------


def isolated_runs(make_battery, specs, target_of, **kw):
    """The same faulted run in both packages: per package (values, monitor,
    fired)."""
    out = []
    for m in BOTH:
        analyzers = make_battery(m)
        target = target_of(m)
        monitor = m.Monitor()
        armed = [dict(s, match=repr(target)) if s.get("match") == "target" else s
                 for s in specs]
        ctx, fired = faulted(m, armed, lambda: m.run(numeric_data(m), analyzers,
                                                     monitor=monitor, **kw))
        out.append((values(ctx), monitor, fired))
    return out


class TestAnalyzerIsolation:
    def test_one_faulty_analyzer_in_ten_degrades_alone(self):
        (jv, jmon, _), (tv, tmon, _) = isolated_runs(
            ten_analyzer_battery,
            [dict(site="analyzer", kind="analyzer", match="target", count=None)],
            lambda m: m.A.Mean("y"), batch_size=1024)
        target = repr(T.Mean("y"))
        assert [k for k, v in tv.items() if isinstance(v, tuple)] == [target]
        assert tv[target] == ("Failure", "AnalyzerFaultException")
        assert tmon.isolation_reruns > 0
        assert any("Mean" in tag for tag in tmon.degraded)
        assert_same(tv, jv)
        assert_counters(jmon, tmon)

    def test_isolated_values_match_clean_run(self):
        clean = values(PORT.run(numeric_data(PORT), ten_analyzer_battery(PORT), batch_size=1024))
        (jv, jmon, _), (tv, tmon, _) = isolated_runs(
            ten_analyzer_battery,
            [dict(site="analyzer", kind="analyzer", match="target", count=None)],
            lambda m: m.A.Sum("x"), batch_size=1024)
        target = repr(T.Sum("x"))
        assert_same({k: v for k, v in tv.items() if k != target},
                    {k: v for k, v in clean.items() if k != target})
        assert_same(tv, jv)
        assert_counters(jmon, tmon)

    def test_poisoned_batch_absorbed_by_rerun(self):
        out = []
        for m in BOTH:
            monitor = m.Monitor()
            ctx, fired = faulted(m, [dict(site="host_partial", kind="poison", at=3)],
                                 lambda: m.run(numeric_data(m), [m.A.Mean("x"), m.A.Sum("x")],
                                               batch_size=1024, placement="host",
                                               monitor=monitor))
            assert fired == ["host_partial:2:poison"], m.name
            out.append((values(ctx), monitor))
        (jv, jmon), (tv, tmon) = out
        assert all(not isinstance(v, tuple) for v in tv.values())
        assert tmon.isolation_reruns > 0
        assert_same(tv, jv)
        assert_counters(jmon, tmon)

    def test_pass_level_failure_short_circuits_bisection(self):
        """A failure every partition reproduces (here ``state_fetch``'s
        tag-free fault) costs the 8-battery chain 8, 4, 2, 1, 1: five
        passes and three re-runs, never full bisection's ~15."""
        (jv, jmon, _), (tv, tmon, _) = isolated_runs(
            eight_analyzer_battery,
            [dict(site="state_fetch", kind="analyzer", count=None)],
            lambda m: None, batch_size=2048)
        assert all(isinstance(v, tuple) for v in tv.values())
        assert (tmon.passes, tmon.isolation_reruns) == (5, 3)
        assert_same(tv, jv)
        assert_counters(jmon, tmon)

    def test_single_fault_never_trips_short_circuit(self):
        (jv, jmon, _), (tv, tmon, _) = isolated_runs(
            eight_analyzer_battery,
            [dict(site="analyzer", kind="analyzer", match="target", count=None)],
            lambda m: m.A.Completeness("x"), batch_size=2048)
        assert [k for k, v in tv.items() if isinstance(v, tuple)] == [repr(T.Completeness("x"))]
        assert_same(tv, jv)
        assert_counters(jmon, tmon)

    def test_host_accumulator_knockout_spares_battery(self, monkeypatch):
        import deequ_tpu.analyzers.grouping as jgrouping
        import deequ_tpu_torch.analyzers.grouping as tgrouping

        # the grouping set on the host group-by, whose knockout this pins
        monkeypatch.setenv("DEEQU_TPU_DEVICE_FREQ", "0")
        out = []
        for m, grouping, kw in ((REF, jgrouping, {}), (PORT, tgrouping, {"device_freq": False})):
            calls = {"n": 0}
            original = grouping.FrequenciesAndNumRows.update

            def poisoned(self, batch, original=original, calls=calls):
                calls["n"] += 1
                if calls["n"] == 2:
                    raise RuntimeError("poisoned frequency table")
                return original(self, batch)

            monkeypatch.setattr(grouping.FrequenciesAndNumRows, "update", poisoned)
            monitor = m.Monitor()
            ctx = m.run(numeric_data(m, with_group=True), [m.A.Mean("x"), m.A.Uniqueness(("g",))],
                        batch_size=1024, monitor=monitor, **kw)
            out.append((values(ctx), monitor))
        (jv, jmon), (tv, tmon) = out
        assert tv[repr(T.Uniqueness(("g",)))][0] == "Failure"
        assert not isinstance(tv[repr(T.Mean("x"))], tuple)
        assert tmon.passes == 1  # a knockout, not a re-pass
        assert any(tag.startswith("host:") for tag in tmon.degraded)
        assert_same(tv, jv)
        assert_counters(jmon, tmon)


# ---------------------------------------------------------------------------
# TestTierFailover (:284-347)
# ---------------------------------------------------------------------------


def failover_check(m):
    return (m.C.Check(m.C.CheckLevel.ERROR, "failover")
            .has_size(lambda n: n == 8192)
            .has_mean("x", lambda v: abs(v) < 1)
            .is_complete("y"))


class TestTierFailover:
    def test_device_failure_fails_over_to_host(self):
        out = []
        for m in BOTH:
            monitor = m.Monitor()
            result, fired = faulted(
                m, [dict(site="device_update", kind="device", at=2)],
                lambda: m.suite(numeric_data(m)).add_check(failover_check(m))
                .with_batch_size(1024).with_monitor(monitor).run())
            assert fired == ["device_update:2:device"], m.name
            assert result.status.value == "Success"
            assert monitor.placement == "host"  # the completing tier
            out.append(({repr(a): mt.value.get() for a, mt in result.metrics.items()}, monitor))
        (jv, jmon), (tv, tmon) = out
        assert tmon.device_failovers == 1
        assert_same(tv, jv)
        assert_counters(jmon, tmon)

    def test_failover_values_match_device_run(self):
        analyzers = [T.Mean("x"), T.Sum("x"), T.StandardDeviation("x")]
        clean = values(PORT.run(numeric_data(PORT), analyzers, batch_size=1024))
        out = []
        for m in BOTH:
            monitor = m.Monitor()
            ctx, _ = faulted(m, [dict(site="device_update", kind="device", at=1)],
                             lambda: m.run(numeric_data(m), [m.A.Mean("x"), m.A.Sum("x"),
                                                             m.A.StandardDeviation("x")],
                                           batch_size=1024, monitor=monitor))
            out.append((values(ctx), monitor))
        (jv, jmon), (tv, tmon) = out
        assert_same(tv, clean)
        assert_same(tv, jv)
        assert_counters(jmon, tmon)

    def test_oom_triggers_batch_bisection(self):
        half = values(PORT.run(numeric_data(PORT), [T.Mean("x"), T.Sum("x")], batch_size=2048))
        out = []
        for m in BOTH:
            monitor = m.Monitor()
            ctx, _ = faulted(m, [dict(site="device_update", kind="oom", at=1)],
                             lambda: m.run(numeric_data(m), [m.A.Mean("x"), m.A.Sum("x")],
                                           batch_size=4096, monitor=monitor))
            out.append((values(ctx), monitor))
        (jv, jmon), (tv, tmon) = out
        assert (tmon.batch_bisections, tmon.device_failovers) == (1, 0)  # bisection sufficed
        assert_same(tv, half)
        assert_same(tv, jv)
        assert_counters(jmon, tmon)

    def test_persistent_oom_falls_through_to_host(self):
        out = []
        for m in BOTH:
            monitor = m.Monitor()
            ctx, _ = faulted(m, [dict(site="device_update", kind="oom", count=None)],
                             lambda: m.run(numeric_data(m), [m.A.Mean("x"), m.A.Sum("x")],
                                           batch_size=4096, monitor=monitor))
            assert monitor.placement == "host", m.name
            out.append((values(ctx), monitor))
        (jv, jmon), (tv, tmon) = out
        assert tmon.batch_bisections >= 1 and tmon.device_failovers == 1
        assert all(not isinstance(v, tuple) for v in tv.values())
        assert_same(tv, jv)
        assert_counters(jmon, tmon)

    def test_a_fault_of_the_ports_kernels_raises_out_of_every_layer(self, monkeypatch):
        """A kernel's own fault (a launch that reported a CUDA error) is
        neither failed over to the host tier nor bisected into Failure
        metrics: the run raises it."""
        from deequ_tpu_torch.runners import engine

        def broken(self, states, features):
            raise KernelLaunchError("CUDA kernel scan_reduce failed to launch: cudaError 700")

        monkeypatch.setattr(engine.BundledScanProgram, "__call__", broken)
        monitor = dq.RunMonitor()
        with pytest.raises(KernelLaunchError):
            PORT.run(numeric_data(PORT), ten_analyzer_battery(PORT), batch_size=1024,
                     monitor=monitor)
        assert (monitor.device_failovers, monitor.isolation_reruns, monitor.passes) == (0, 0, 1)

    def test_a_raw_cuda_error_of_a_kernel_raises_typed(self, monkeypatch):
        """A RuntimeError carrying a CUDA error that poisons the context
        (how a broken kernel shows at the wait after its launches) is the
        kernels' fault: no failover to the host tier, no bisection, the
        run raises it as a ``KernelLaunchError``."""
        from deequ_tpu_torch.runners import engine

        def broken(self, states, features):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

        monkeypatch.setattr(engine.BundledScanProgram, "__call__", broken)
        monitor = dq.RunMonitor()
        with pytest.raises(KernelLaunchError) as raised:
            PORT.run(numeric_data(PORT), [T.Mean("x"), T.Sum("x")], batch_size=1024,
                     monitor=monitor)
        assert "illegal memory access" in str(raised.value.__cause__)
        assert (monitor.device_failovers, monitor.isolation_reruns, monitor.passes) == (0, 0, 1)
        assert monitor.degraded == []

    def test_a_sticky_error_on_the_full_battery_raises_not_failure_metrics(self, monkeypatch):
        """A sticky CUDA error at the wait after the kernels (every later
        wait, the host tier's included, fails the same way) raises out of
        the full battery's run as a ``KernelLaunchError``: it never turns
        into a failover, a bisection or ``Failure`` metrics."""
        from deequ_tpu_torch.runners import engine

        def sticky(device):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

        monkeypatch.setattr(engine, "synchronize", sticky)
        battery = ten_analyzer_battery(PORT)
        monitor = dq.RunMonitor()
        with pytest.raises(KernelLaunchError):
            PORT.run(numeric_data(PORT), battery, batch_size=1024, monitor=monitor)
        assert (monitor.device_failovers, monitor.isolation_reruns) == (0, 0)
        assert monitor.degraded == []
        monitor = dq.RunMonitor()
        with pytest.raises(KernelLaunchError):
            PORT.suite(numeric_data(PORT)).add_check(failover_check(PORT)).with_batch_size(
                1024).with_monitor(monitor).run()
        assert (monitor.device_failovers, monitor.isolation_reruns) == (0, 0)

    def test_a_device_error_at_the_wait_after_the_kernels_raises_typed(self, monkeypatch):
        """Any CUDA error that surfaces at the wait after a batch's kernels
        is theirs (the copies before them were waited for), so even one
        that reads as a device fault elsewhere raises as a
        ``KernelLaunchError`` there; an OOM keeps its kind."""
        from deequ_tpu_torch.runners import engine

        def failing(device):
            raise RuntimeError("CUDA error: uncorrectable ECC error encountered")

        monkeypatch.setattr(engine, "synchronize", failing)
        with pytest.raises(KernelLaunchError):
            engine.wait_kernels(None)

        def oom(device):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")

        monkeypatch.setattr(engine, "synchronize", oom)
        with pytest.raises(torch.cuda.OutOfMemoryError):
            engine.wait_kernels(None)


# ---------------------------------------------------------------------------
# TestRouterLearning (:512-572)
# ---------------------------------------------------------------------------


class TestRouterLearning:
    @pytest.mark.parametrize("m", BOTH, ids=["jax", "torch"])
    def test_probation_routes_host_then_readmits(self, m):
        svc_mod = __import__(f"{'deequ_tpu' if m is REF else 'deequ_tpu_torch'}.service",
                             fromlist=["PlacementRouter"])
        router = svc_mod.PlacementRouter(background_warm=False)
        # shape-qualified and over a column no other test reads: warmth
        # rests on this router's evidence alone
        signature = svc_mod.shape_qualified_signature(
            [m.A.Mean("probation_only"), m.A.Sum("probation_only")], 12345)
        router.note_ran(signature, worker_id=0, placement="device")
        assert router.decide(signature) is None  # warm: the device default
        router.note_device_failure(signature)
        for _ in range(router.SUSPECT_PROBATION_RUNS):
            assert router.decide(signature) == "host"
        assert router.metrics.counter_value(
            "deequ_service_suspect_host_routes_total") == router.SUSPECT_PROBATION_RUNS
        # probation over AND the warmth claim dropped: cold again
        assert router.decide(signature) == "host"
        router.note_ran(signature, worker_id=0, placement="device")
        assert router.decide(signature) is None
        router.close()

    def test_scheduler_harvests_device_failure(self):
        out = []
        for m, svc_mod, kw in ((REF, "deequ_tpu.service", {"fleet": False}),
                               (PORT, "deequ_tpu_torch.service", {"device": "cpu"})):
            service_cls = __import__(svc_mod, fromlist=["VerificationService"]).VerificationService
            check = m.C.Check(m.C.CheckLevel.ERROR, "svc").has_mean("x", lambda v: abs(v) < 1)
            data = numeric_data(m, rows=4096)
            with service_cls(workers=2, background_warm=False, **kw) as service:
                # the first run shelters the cold battery on the host tier,
                # the second takes the device tier, where the fault fires
                service.verify(data, [check], timeout=120)
                result, fired = faulted(m, [dict(site="device_update", kind="device", at=1)],
                                        lambda: service.verify(data, [check], timeout=120))
                assert fired, m.name  # the job really took the device path
                assert result.status.value == "Success"
                counters = service.json_snapshot()["counters"]
                out.append(counters.get("deequ_service_device_failures_total", 0))
        assert out[1] == out[0] >= 1

    def test_probation_sends_the_next_eight_runs_to_the_host_tier(self):
        """A device fault under one battery: the router sends its next
        eight jobs to the host tier (``deequ_service_suspect_host_routes_
        total``), and the ninth returns to the device tier."""
        from deequ_tpu_torch.service import VerificationService

        check = dq.Check(dq.CheckLevel.ERROR, "probation").has_mean("x", lambda v: abs(v) < 1)
        data = numeric_data(PORT, rows=4096)
        with VerificationService(workers=1, background_warm=False, device="cpu") as svc:
            # the cold battery's first job runs on the host tier, the second
            # launches it on the device tier (warm from then on)
            for _ in range(2):
                svc.verify(data, [check], timeout=120)
            with TRel.inject(TRel.FaultSpec("device_update", "device", at=1)) as inj:
                svc.verify(data, [check], timeout=120)
            assert inj.fired
            hosts = svc.metrics.counter_value("deequ_service_suspect_host_routes_total")
            hits = svc.metrics.counter_value("deequ_service_placement_cache_hits_total")
            for _ in range(svc.router.SUSPECT_PROBATION_RUNS):
                svc.verify(data, [check], timeout=120)
            assert svc.metrics.counter_value("deequ_service_suspect_host_routes_total") \
                == hosts + 8
            assert svc.metrics.counter_value("deequ_service_placement_cache_hits_total") == hits
            svc.verify(data, [check], timeout=120)  # the ninth: the device tier again
            assert svc.metrics.counter_value("deequ_service_suspect_host_routes_total") \
                == hosts + 8
            assert svc.metrics.counter_value("deequ_service_placement_cache_hits_total") \
                == hits + 1
            assert svc.metrics.counter_value("deequ_service_device_failures_total") == 1

    @pytest.mark.parametrize("m", BOTH, ids=["jax", "torch"])
    def test_worker_crash_terminates_typed(self, m):
        svc_mod = __import__(f"{'deequ_tpu' if m is REF else 'deequ_tpu_torch'}.service",
                             fromlist=["VerificationService"])
        kw = {"fleet": False} if m is REF else {"device": "cpu"}
        check = m.C.Check(m.C.CheckLevel.ERROR, "crash").has_size(lambda n: n > 0)
        with svc_mod.VerificationService(workers=2, background_warm=False, **kw) as service:
            with m.R.inject(m.R.FaultSpec("worker", "worker_death", count=None)):
                handle = service.submit_verification(numeric_data(m, rows=2048), [check],
                                                     max_retries=0)
                with pytest.raises(svc_mod.JobFailed) as info:
                    handle.result(timeout=120)
            assert isinstance(info.value.__cause__, m.R.WorkerCrash)


# ---------------------------------------------------------------------------
# the mesh: the pass-level re-shard on the device tier
# (tests/test_elastic_mesh.py:170) and a raw device error in the elastic fold
# ---------------------------------------------------------------------------


MESH_ROWS = 24_000
MESH_BATCH = 512


def mesh_battery(m):
    A = m.A
    return [A.Size(), A.Completeness("x"), A.Mean("x"), A.Sum("x"), A.StandardDeviation("x"),
            A.Maximum("x"), A.ApproxCountDistinct("y")]


def mesh_data(m):
    rng = np.random.default_rng(17)
    return m.Dataset.from_dict({"x": rng.normal(5, 2, MESH_ROWS),
                                "y": rng.integers(0, 700, MESH_ROWS)})


def mesh_of(m, n):
    if m is REF:
        import deequ_tpu.parallel as JP

        return JP.make_mesh(n)
    import deequ_tpu_torch.parallel as TP

    return TP.make_mesh(n, device="cpu")


@pytest.mark.mesh
def test_pass_level_reshard_on_device_path():
    """A shard loss on the device tier over a mesh escapes the engine and
    re-shards at the PASS level: ``classify_failure`` reads ``"mesh"``, and
    the pass re-runs whole on a mesh one rung down, not on the host tier."""
    clean = values(PORT.run(mesh_data(PORT), mesh_battery(PORT), batch_size=MESH_BATCH))
    out = []
    for m in BOTH:
        monitor = m.Monitor()
        ctx, fired = faulted(m, [dict(site="device_update", kind="mesh_loss", at=2, shard=3)],
                             lambda: m.run(mesh_data(m), mesh_battery(m), batch_size=MESH_BATCH,
                                           sharding=mesh_of(m, 8), monitor=monitor))
        assert fired, m.name
        out.append((values(ctx), monitor))
    (jv, jmon), (tv, tmon) = out
    assert tmon.mesh_reshards == 1 and "mesh:pass_reshard" in tmon.degraded
    assert tmon.device_failovers == 0  # the re-run stayed on a smaller mesh
    assert_same(tv, clean)
    assert_same(tv, jv)
    assert_counters(jmon, tmon)
    assert jmon.mesh_reshards == tmon.mesh_reshards


@pytest.mark.mesh
def test_a_raw_device_error_in_the_elastic_fold_recovers_as_a_shard_loss(monkeypatch):
    """A raw CUDA device error (not one of a kernel) inside the host tier's
    sharded fold on a mesh of more than one shard probes the shards and recovers as a shard loss
    (shard 0 when no probe fails), in both packages."""
    import deequ_tpu.parallel as JP
    import deequ_tpu_torch.parallel as TP

    clean = values(PORT.run(mesh_data(PORT), mesh_battery(PORT), batch_size=MESH_BATCH,
                            placement="host"))
    out = []
    for m, mod, text in ((REF, JP, "INTERNAL: collective failed"),
                         (PORT, TP, "CUDA error: uncorrectable ECC error encountered")):
        original = mod.sharded_ingest_fold
        raised = []

        def flaky(*args, original=original, raised=raised, text=text, **kw):
            if not raised:
                raised.append(1)
                raise RuntimeError(text)
            return original(*args, **kw)

        monkeypatch.setattr(mod, "sharded_ingest_fold", flaky)
        monitor = m.Monitor()
        ctx = m.run(mesh_data(m), mesh_battery(m), batch_size=MESH_BATCH,
                    sharding=mesh_of(m, 8), placement="host", monitor=monitor)
        out.append((values(ctx), monitor))
    (jv, jmon), (tv, tmon) = out
    assert (tmon.shard_losses, tmon.mesh_reshards, tmon.device_failovers) == (1, 1, 0)
    for name in ("shard_losses", "mesh_reshards", "salvaged_states"):
        assert getattr(tmon, name) == getattr(jmon, name), name
    assert_same(tv, clean)
    assert_same(tv, jv)
