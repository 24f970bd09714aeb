"""The fleet watch, /statusz and the SLO evaluator of the PyTorch/CUDA port
(deequ_tpu_torch.service.fleetwatch, .statusz, .metrics) against the JAX
reference: the cases of ``tests/test_fleetwatch.py`` and
``tests/test_statusz.py`` run through both packages (``m`` is either
package, its service on the CPU), then a Holt-Winters fleet harvest in both
packages flags the same points, the tenant quotas' token bucket runs on
its injectable clock (no sleeps), and the port's /statusz reports its own
planes (static knobs, no mesh or fleet scheduler).

Tolerances: flags, counters, burn rates and documents are compared
exactly; the histories are the same JSON in both packages.
"""


import glob
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from torch_pairs import pair, reference_isolated  # noqa: F401 (autouse)


DAY_MS = 86_400_000

NAMES = {
    'AbsoluteChangeStrategy': 'anomalydetection:AbsoluteChangeStrategy',
    'AnalysisRunner': 'runners:AnalysisRunner',
    'AnalyzerContext': 'runners.context:AnalyzerContext',
    'Check': 'checks:Check',
    'CheckLevel': 'checks:CheckLevel',
    'Completeness': 'analyzers:Completeness',
    'Dataset': 'data:Dataset',
    'DoubleMetric': 'metrics:DoubleMetric',
    'Entity': 'metrics:Entity',
    'FaultSpec': 'reliability:FaultSpec',
    'FileSystemMetricsRepository': 'repository:FileSystemMetricsRepository',
    'FleetWatch': 'service.fleetwatch:FleetWatch',
    'HISTOGRAM_EDGES': 'service.metrics:HISTOGRAM_EDGES',
    'HoltWinters': 'anomalydetection:HoltWinters',
    'additive_holt_winters': 'anomalydetection.seasonal:additive_holt_winters',
    'Mean': 'analyzers:Mean',
    'MetricInterval': 'anomalydetection:MetricInterval',
    'MetricsExporter': 'service.metrics:MetricsExporter',
    'OnlineNormalStrategy': 'anomalydetection:OnlineNormalStrategy',
    'PLANE_REQUIRED_KEYS': 'service.statusz:PLANE_REQUIRED_KEYS',
    'PartitionedMetricsRepository': 'repository:PartitionedMetricsRepository',
    'REQUIRED_PLANES': 'service.statusz:REQUIRED_PLANES',
    'ResultKey': 'repository:ResultKey',
    'STATUSZ_VERSION': 'service.statusz:STATUSZ_VERSION',
    'SeriesSeasonality': 'anomalydetection:SeriesSeasonality',
    'ServiceMetrics': 'service.metrics:ServiceMetrics',
    'Size': 'analyzers:Size',
    'SloEvaluator': 'service.metrics:SloEvaluator',
    'TenantCatalog': 'service:TenantCatalog',
    'TenantQuota': 'service:TenantQuota',
    'TokenBucket': 'service.scheduler:_TokenBucket',
    'StatuszRegistry': 'service.statusz:StatuszRegistry',
    'Success': 'metrics:Success',
    'VerificationService': 'service:VerificationService',
    'fleetwatch_bundle_size': 'service.fleetwatch:fleetwatch_bundle_size',
    'fleetwatch_window_months': 'service.fleetwatch:fleetwatch_window_months',
    'histogram_fraction_le': 'service.metrics:histogram_fraction_le',
    'histogram_quantile': 'service.metrics:histogram_quantile',
    'inject': 'reliability:inject',
    'merge_histogram_states': 'service.metrics:merge_histogram_states',
    'validate_statusz': 'service.statusz:validate_statusz',
    'window_after_ms': 'service.fleetwatch:window_after_ms',
}
REF, PORT = pair(NAMES)
_CONTEXTS = {}


@pytest.fixture(params=[REF, PORT], ids=["jax", "torch"])
def m(request):
    return request.param


@pytest.fixture
def steady_ctx(m):
    if m.name not in _CONTEXTS:
        data = m.Dataset.from_dict(
            {"x": np.random.default_rng(0).normal(10, 1, 128)}
        )
        _CONTEXTS[m.name] = m.AnalysisRunner.do_analysis_run(
            data, [m.Size(), m.Completeness("x"), m.Mean("x")], **m.dev
        )
    return _CONTEXTS[m.name]


def wild_ctx(m, steady, value=999.0):
    return m.AnalyzerContext({
        **{a: mt for a, mt in steady.metric_map.items() if a != m.Mean("x")},
        m.Mean("x"): m.DoubleMetric(m.Entity.COLUMN, "Mean", "x", m.Success(value)),
    })


def history_repo(m, tmp_path, name, steady, days=30, wild_newest=False):
    repo = m.PartitionedMetricsRepository(str(tmp_path / name))
    now = int(time.time() * 1000)
    for day in range(days):
        repo.save(m.ResultKey(now - (days - day) * DAY_MS), steady)
    repo.save(
        m.ResultKey(now), wild_ctx(m, steady) if wild_newest else steady
    )
    return repo


@pytest.fixture
def service(m):
    with m.VerificationService(
        workers=2, background_warm=False, **m.svc
    ) as svc:
        yield svc


class TestHarvestScoring:
    def test_scores_fleet_and_flags_wild_tenant(self, m, tmp_path, service, steady_ctx):
        service.watch_metrics(
            "t-steady", history_repo(m, tmp_path, "a", steady_ctx),
            [m.Size(), m.Mean("x")],
        )
        service.watch_metrics(
            "t-wild",
            history_repo(m, tmp_path, "b", steady_ctx, wild_newest=True),
            [m.Size(), m.Mean("x")],
        )
        report = service.fleetwatch.harvest_now()
        assert report.tenants == 2
        assert report.series_scored == 4
        assert report.detect_calls == 1  # ONE bundle, one batched call
        flagged_tenants = {f[0] for f in report.flagged}
        assert flagged_tenants == {"t-wild"}
        assert any("Mean" in f[2] for f in report.flagged)
        snap = service.json_snapshot()["counters"]
        assert snap["deequ_service_anomaly_flagged_total"][
            "tenant=t-wild"
        ] >= 1
        assert snap["deequ_service_anomaly_series_scored_total"][
            "tenant=t-steady"
        ] == 2
        assert snap["deequ_service_anomaly_harvests_total"] == 1
        assert snap["deequ_service_anomaly_scoring_seconds_total"] > 0

    def test_one_call_per_strategy_bundle(self, m, tmp_path, service, steady_ctx):
        """Two strategies = two bundles = two calls, regardless of tenant
        count."""
        repo = history_repo(m, tmp_path, "a", steady_ctx)
        service.watch_metrics(
            "t1", repo, [m.Size(), m.Mean("x")], strategy=m.OnlineNormalStrategy()
        )
        service.watch_metrics(
            "t2", repo, [m.Size(), m.Mean("x")], strategy=m.OnlineNormalStrategy(),
            dataset="d2",
        )
        service.watch_metrics(
            "t3", repo, [m.Mean("x")],
            strategy=m.AbsoluteChangeStrategy(max_rate_increase=100.0),
        )
        report = service.fleetwatch.harvest_now()
        assert report.series_scored == 5
        assert report.detect_calls == 2

    def test_bundle_size_knob_chunks(self, m, tmp_path, service, steady_ctx, monkeypatch):
        monkeypatch.setenv("DEEQU_TPU_FLEETWATCH_BUNDLE", "1")
        assert m.fleetwatch_bundle_size() == 1
        service.watch_metrics(
            "t1", history_repo(m, tmp_path, "a", steady_ctx),
            [m.Size(), m.Mean("x")],
        )
        report = service.fleetwatch.harvest_now()
        assert report.detect_calls == 2  # one per series at bundle=1

    def test_standing_anomaly_exports_and_dumps_once(
        self, m, tmp_path, service, steady_ctx, monkeypatch
    ):
        """A persistently anomalous newest point stays in every harvest's
        REPORT but bumps the export counter and schedules a flight dump
        exactly once — re-dumping per harvest would drain the recorder's
        process-wide dump budget and inflate the counter by harvest
        rate."""
        flight_dir = str(tmp_path / "flight")
        monkeypatch.setenv("DEEQU_TPU_FLIGHT_DIR", flight_dir)
        service.watch_metrics(
            "t-wild",
            history_repo(m, tmp_path, "a", steady_ctx, wild_newest=True),
            [m.Mean("x")],
        )
        first = service.fleetwatch.harvest_now()
        second = service.fleetwatch.harvest_now()
        assert first.flagged and second.flagged == first.flagged
        snap = service.json_snapshot()["counters"]
        assert snap["deequ_service_anomaly_flagged_total"][
            "tenant=t-wild"
        ] == 1
        dumps = [
            p for p in glob.glob(os.path.join(flight_dir, "*.jsonl"))
            if "AnomalyFlagged" in open(p).read()
        ]
        assert len(dumps) == 1

    def test_short_holtwinters_tenant_does_not_degrade_its_bundle(
        self, m, tmp_path, service, steady_ctx
    ):
        """One tenant younger than two full cycles is pre-filtered
        (skipped), keeping the rest of the Holt-Winters bundle on the ONE
        batched call."""

        long_repo = history_repo(m, tmp_path, "a", steady_ctx, days=40)
        short_repo = m.PartitionedMetricsRepository(str(tmp_path / "short"))
        now = int(time.time() * 1000)
        for d in range(10):  # < 2 weekly cycles + 1
            short_repo.save(m.ResultKey(now - (10 - d) * DAY_MS), steady_ctx)
        hw = m.HoltWinters(m.MetricInterval.DAILY, m.SeriesSeasonality.WEEKLY)
        service.watch_metrics("t-long", long_repo, [m.Mean("x")], strategy=hw)
        service.watch_metrics("t-young", short_repo, [m.Mean("x")], strategy=hw)
        report = service.fleetwatch.harvest_now()
        assert report.detect_calls == 1  # the bundle stayed batched
        assert report.series_scored == 1
        assert report.series_skipped == 1

    def test_holtwinters_fits_cache_across_harvests(
        self, m, tmp_path, service, steady_ctx, monkeypatch
    ):
        """The per-series L-BFGS-B fit (the dominant serial cost) runs
        once per training slice, not once per harvest: an unchanged
        history re-scores with ZERO new optimizer calls; a new committed
        point re-fits exactly that series."""

        hw = m.HoltWinters(m.MetricInterval.DAILY, m.SeriesSeasonality.WEEKLY)
        repo = history_repo(m, tmp_path, "a", steady_ctx, days=30)
        service.watch_metrics("t1", repo, [m.Mean("x")], strategy=hw)
        calls = []
        real_fit = m.HoltWinters._fit
        monkeypatch.setattr(
            m.HoltWinters, "_fit",
            lambda self, training, nf: calls.append(1) or real_fit(
                self, training, nf
            ),
        )
        first = service.fleetwatch.harvest_now()
        assert first.series_scored == 1 and len(calls) == 1
        second = service.fleetwatch.harvest_now()
        assert second.series_scored == 1 and len(calls) == 1  # cached
        # flags identical with and without the cache in play
        assert second.flagged == first.flagged
        repo.save(m.ResultKey(int(time.time() * 1000) + 1), steady_ctx)
        service.fleetwatch.harvest_now()
        assert len(calls) == 2  # the grown history re-fits

    def test_short_history_skipped_not_fatal(self, m, tmp_path, service, steady_ctx):
        repo = m.PartitionedMetricsRepository(str(tmp_path / "short"))
        repo.save(m.ResultKey(int(time.time() * 1000)), steady_ctx)
        service.watch_metrics("t-short", repo, [m.Mean("x")])
        report = service.fleetwatch.harvest_now()
        assert report.series_scored == 0
        assert report.series_skipped == 1

    def test_unwatch(self, m, tmp_path, service, steady_ctx):
        service.watch_metrics(
            "t1", history_repo(m, tmp_path, "a", steady_ctx), [m.Mean("x")]
        )
        assert service.fleetwatch.unwatch("t1")
        assert not service.fleetwatch.unwatch("t1")
        assert service.fleetwatch.harvest_now().series_scored == 0


class TestStandingTrigger:
    def test_scheduler_harvest_triggers_scoring_job(self, m, tmp_path, steady_ctx):
        """The standing-watch contract: a completed job for a WATCHED
        tenant schedules ONE debounced fleet-scoring job; unwatched
        tenants never trigger."""
        data = m.Dataset.from_dict({"x": [1.0, 2.0, 3.0]})
        checks = [m.Check(m.CheckLevel.ERROR, "c").has_size(lambda n: n > 0)]
        with m.VerificationService(
            workers=2, background_warm=False, **m.svc
        ) as svc:
            svc.watch_metrics(
                "watched", history_repo(m, tmp_path, "a", steady_ctx),
                [m.Mean("x")],
            )
            svc.verify(data, checks, tenant="unwatched", timeout=60)
            time.sleep(0.3)
            assert svc.fleetwatch.last_report is None
            svc.verify(data, checks, tenant="watched", timeout=60)
            for _ in range(100):
                if svc.fleetwatch.last_report is not None:
                    break
                time.sleep(0.05)
            report = svc.fleetwatch.last_report
            assert report is not None and report.series_scored == 1
            snap = svc.json_snapshot()["counters"]
            assert snap["deequ_service_anomaly_harvests_total"] >= 1

    def test_watch_survives_scoring_job_killed_before_body(
        self, m, tmp_path, steady_ctx
    ):
        """Liveness: a scoring job that dies BEFORE its body runs (the
        injected worker fault fires between pickup and fn) must not leak
        the debounce flag — the next harvest re-schedules and the fleet
        keeps being scored."""

        data = m.Dataset.from_dict({"x": [1.0, 2.0, 3.0]})
        checks = [m.Check(m.CheckLevel.ERROR, "c").has_size(lambda n: n > 0)]
        with m.VerificationService(
            workers=1, background_warm=False, **m.svc
        ) as svc:
            svc.watch_metrics(
                "watched", history_repo(m, tmp_path, "a", steady_ctx),
                [m.Mean("x")],
            )
            # every worker pickup crashes while armed: the triggering job
            # retries through its own budget; the scoring job (retries=0)
            # dies pre-body and must clear _job_pending via recover_fn
            with m.inject(
                m.FaultSpec("worker", "worker_death", every=1, count=2)
            ):
                try:
                    svc.verify(data, checks, tenant="watched", timeout=60,
                               max_retries=0)
                except Exception:  # noqa: BLE001 - the crash is the point
                    pass
                deadline = time.time() + 5
                while time.time() < deadline and svc.fleetwatch._job_pending:
                    time.sleep(0.05)
            assert not svc.fleetwatch._job_pending
            # disarmed: the watch schedules and scores normally again
            svc.verify(data, checks, tenant="watched", timeout=60)
            for _ in range(100):
                if svc.fleetwatch.last_report is not None:
                    break
                time.sleep(0.05)
            assert svc.fleetwatch.last_report is not None

    def test_disabled_knob_detaches(self, m, tmp_path, steady_ctx, monkeypatch):
        monkeypatch.setenv("DEEQU_TPU_FLEETWATCH", "0")
        data = m.Dataset.from_dict({"x": [1.0, 2.0, 3.0]})
        checks = [m.Check(m.CheckLevel.ERROR, "c").has_size(lambda n: n > 0)]
        with m.VerificationService(
            workers=2, background_warm=False, **m.svc
        ) as svc:
            svc.watch_metrics(
                "watched", history_repo(m, tmp_path, "a", steady_ctx),
                [m.Mean("x")],
            )
            svc.verify(data, checks, tenant="watched", timeout=60)
            time.sleep(0.3)
            assert svc.fleetwatch.last_report is None
            # explicit scoring still works
            assert svc.fleetwatch.harvest_now().series_scored == 1


class TestQuarantineIsolation:
    def test_poisoned_history_quarantines_typed_others_unaffected(
        self, m, tmp_path, service, steady_ctx
    ):
        """One tenant's corrupt history bucket
        quarantines (typed, counted) while the other tenants' scores are
        byte-identical to a clean run."""
        service.watch_metrics(
            "t-clean", history_repo(m, tmp_path, "a", steady_ctx, wild_newest=True),
            [m.Size(), m.Mean("x")],
        )
        poisoned = history_repo(m, tmp_path, "b", steady_ctx)
        service.watch_metrics("t-poisoned", poisoned, [m.Size(), m.Mean("x")])
        clean_report = service.fleetwatch.harvest_now()
        assert not clean_report.quarantined_tenants
        # flip one byte inside one of the poisoned tenant's stored entries
        # (valid JSON, failing checksum — the bit-rot shape)
        [entry] = sorted(glob.glob(
            os.path.join(poisoned.path, "*", "e-*.json")
        ))[-1:]
        raw = open(entry).read()
        i = raw.index("Mean") + 1
        open(entry, "w").write(
            raw[:i] + ("X" if raw[i] != "X" else "Y") + raw[i + 1:]
        )
        report = service.fleetwatch.harvest_now()
        assert report.quarantined_tenants == ["t-poisoned"]
        # the clean tenant's flags are unchanged
        assert (
            [f for f in report.flagged if f[0] == "t-clean"]
            == [f for f in clean_report.flagged if f[0] == "t-clean"]
        )
        snap = service.json_snapshot()["counters"]
        assert snap["deequ_service_anomaly_quarantined_total"][
            "tenant=t-poisoned"
        ] == 1
        # the corrupt LOOSE entry self-healed on the quarantining read
        # (bytes preserved in the sidecar): the next harvest loads clean,
        # the standing episode closes, and the counter stays put
        again = service.fleetwatch.harvest_now()
        assert again.quarantined_tenants == []
        snap = service.json_snapshot()["counters"]
        assert snap["deequ_service_anomaly_quarantined_total"][
            "tenant=t-poisoned"
        ] == 1

    def test_standing_quarantine_episode_counts_once(
        self, m, tmp_path, service, steady_ctx
    ):
        """A corruption that re-quarantines on EVERY load (injected at the
        repository_load site, so no self-heal) reports per harvest but
        exports one counter bump per episode, not per harvest."""

        service.watch_metrics(
            "t1", history_repo(m, tmp_path, "a", steady_ctx), [m.Mean("x")]
        )
        with m.inject(
            m.FaultSpec("repository_load", "corrupt", every=1, count=None)
        ):
            first = service.fleetwatch.harvest_now()
            second = service.fleetwatch.harvest_now()
        assert first.quarantined_tenants == ["t1"]
        assert second.quarantined_tenants == ["t1"]
        snap = service.json_snapshot()["counters"]
        assert snap["deequ_service_anomaly_quarantined_total"][
            "tenant=t1"
        ] == 1
        # a clean harvest closes the episode; fresh corruption counts anew
        service.fleetwatch.harvest_now()
        with m.inject(
            m.FaultSpec("repository_load", "corrupt", every=1, count=None)
        ):
            service.fleetwatch.harvest_now()
        snap = service.json_snapshot()["counters"]
        assert snap["deequ_service_anomaly_quarantined_total"][
            "tenant=t1"
        ] == 2

    def test_concurrent_foreign_quarantine_is_not_misattributed(
        self, m, tmp_path, service, steady_ctx
    ):
        """Attribution is per REPOSITORY: a quarantine happening elsewhere
        in the process while a clean tenant's history loads (another
        worker hitting a corrupt store) must not flag THIS tenant."""

        corrupt_path = tmp_path / "foreign.json"
        corrupt_path.write_text('[{"torn"')
        foreign = m.FileSystemMetricsRepository(str(corrupt_path))
        inner = history_repo(m, tmp_path, "a", steady_ctx)

        class InterleavingRepo:
            """Simulates a concurrent worker quarantining a FOREIGN store
            mid-load (deterministically, inside this tenant's load)."""

            @property
            def quarantines(self):
                return inner.quarantines

            def load(self):
                foreign._read_all()  # bumps the process-global counter
                return inner.load()

        service.watch_metrics("t-clean", InterleavingRepo(), [m.Mean("x")])
        report = service.fleetwatch.harvest_now()
        assert report.quarantined_tenants == []
        assert report.series_scored == 1

    def test_injected_corrupt_fault_quarantines(self, m, tmp_path, service, steady_ctx):

        service.watch_metrics(
            "t1", history_repo(m, tmp_path, "a", steady_ctx), [m.Mean("x")]
        )
        with m.inject(
            m.FaultSpec("repository_load", "corrupt", at=1)
        ) as inj:
            report = service.fleetwatch.harvest_now()
        assert inj.fired
        assert report.quarantined_tenants == ["t1"]


class TestObservability:
    def test_flight_dump_correlates_to_harvest_trace(
        self, m, tmp_path, service, steady_ctx, monkeypatch
    ):
        flight_dir = str(tmp_path / "flight")
        monkeypatch.setenv("DEEQU_TPU_FLIGHT_DIR", flight_dir)
        service.watch_metrics(
            "t-wild",
            history_repo(m, tmp_path, "a", steady_ctx, wild_newest=True),
            [m.Mean("x")],
        )
        report = service.fleetwatch.harvest_now()
        assert report.flagged
        dumps = glob.glob(os.path.join(flight_dir, "*.jsonl"))
        assert dumps
        correlated = []
        for path in dumps:
            records = [json.loads(line) for line in open(path)]
            header = records[0]
            if any(
                f.get("kind") == "AnomalyFlagged"
                for f in header.get("failures", [])
            ):
                correlated.append((header, records[1:]))
        assert correlated, "no AnomalyFlagged dump"
        header, spans = correlated[0]
        # the dump is CORRELATED: its spans belong to the harvest trace
        assert header["trace_id"]
        assert any(
            s.get("name") == "fleetwatch:harvest" for s in spans
        )
        detail = next(
            f["detail"] for f in header["failures"]
            if f["kind"] == "AnomalyFlagged"
        )
        assert "t-wild" in detail and "Mean" in detail

    def test_export_help_lines_present(self, m, service):
        text = service.prometheus_text()
        for series in (
            "deequ_service_anomaly_series_scored_total",
            "deequ_service_anomaly_flagged_total",
            "deequ_service_anomaly_quarantined_total",
            "deequ_service_anomaly_harvests_total",
            "deequ_service_anomaly_scoring_seconds_total",
            "deequ_service_anomaly_watched_series",
        ):
            # the gauge always exports; counters export once touched — but
            # HELP must be REGISTERED for all (statlint export-help)
            assert series in service.metrics._help

    def test_watched_series_gauge(self, m, tmp_path, service, steady_ctx):
        repo = history_repo(m, tmp_path, "a", steady_ctx)
        service.watch_metrics("t1", repo, [m.Size(), m.Mean("x")])
        snap = service.json_snapshot()
        assert snap["gauges"]["deequ_service_anomaly_watched_series"] == 2


class TestWindowKnob:
    def test_window_after_ms_arithmetic(self, m):
        import datetime

        def utc_ms(y, m, d):
            return int(datetime.datetime(
                y, m, d, tzinfo=datetime.timezone.utc
            ).timestamp() * 1000)

        now = utc_ms(2026, 8, 4)
        # 12-month window -> first ms of the month 11 buckets back
        assert m.window_after_ms(12, now) == utc_ms(2025, 9, 1)
        # 1-month window -> the current (partial) month counts
        assert m.window_after_ms(1, now) == utc_ms(2026, 8, 1)
        # a window crossing a year boundary
        assert m.window_after_ms(3, utc_ms(2026, 1, 15)) == utc_ms(2025, 11, 1)
        assert m.window_after_ms(0) is None

    def test_window_bounds_history_load(self, m, tmp_path, service, steady_ctx, monkeypatch):
        """Entries older than the window never score (and never even
        deserialize — the partitioned walk skips their buckets)."""
        repo = m.PartitionedMetricsRepository(str(tmp_path / "hist"))
        now = int(time.time() * 1000)
        # 10 recent dailies + 10 two years old
        for day in range(10):
            repo.save(m.ResultKey(now - (10 - day) * DAY_MS), steady_ctx)
            repo.save(
                m.ResultKey(now - 730 * DAY_MS - day * DAY_MS), steady_ctx
            )
        service.watch_metrics("t1", repo, [m.Mean("x")])
        monkeypatch.setenv("DEEQU_TPU_FLEETWATCH_WINDOW_MONTHS", "2")
        assert m.fleetwatch_window_months() == 2
        repo.entries_deserialized = 0
        service.fleetwatch.harvest_now()
        assert repo.entries_deserialized == 10  # the stale decade untouched
        monkeypatch.setenv("DEEQU_TPU_FLEETWATCH_WINDOW_MONTHS", "0")
        repo.entries_deserialized = 0
        service.fleetwatch.harvest_now()
        assert repo.entries_deserialized == 20


# ---------------------------------------------------------------------------
# the SLO histograms and /statusz (the cases of tests/test_statusz.py)
# ---------------------------------------------------------------------------



def _checks(m):
    return [
        m.Check(m.CheckLevel.ERROR, "statusz battery")
        .has_size(lambda n: n > 0)
        .is_complete("x")
    ]


def _empty_state(m):
    return {
        "counts": [0] * (len(m.HISTOGRAM_EDGES) + 1), "sum": 0.0, "count": 0,
    }


# ---------------------------------------------------------------------------
# histogram algebra
# ---------------------------------------------------------------------------


class TestHistogramAlgebra:
    def test_edges_are_shared_pow2(self, m):
        assert m.HISTOGRAM_EDGES[0] == 2.0 ** -20
        assert m.HISTOGRAM_EDGES[-1] == 64.0
        assert all(
            b == a * 2.0
            for a, b in zip(m.HISTOGRAM_EDGES, m.HISTOGRAM_EDGES[1:])
        )

    def test_observe_accumulates_state(self, m):
        sm = m.ServiceMetrics()
        for v in (0.001, 0.002, 0.004, 5.0):
            sm.observe("lat_seconds", v, tenant="a")
        state = sm.histogram_state("lat_seconds", tenant="a")
        assert state["count"] == 4
        assert state["sum"] == pytest.approx(5.007)
        assert sum(state["counts"]) == 4

    def test_overflow_bucket(self, m):
        sm = m.ServiceMetrics()
        sm.observe("lat_seconds", 100.0)  # past the 64 s top edge
        state = sm.histogram_state("lat_seconds")
        assert state["counts"][-1] == 1

    def test_nan_observation_dropped(self, m):
        sm = m.ServiceMetrics()
        sm.observe("lat_seconds", float("nan"))
        assert sm.histogram_state("lat_seconds") is None

    def test_merge_is_commutative_vector_add(self, m):
        sm = m.ServiceMetrics()
        sm.observe("lat_seconds", 0.01, tenant="a")
        sm.observe("lat_seconds", 0.02, tenant="b")
        sm.observe("lat_seconds", 0.5, tenant="b")
        a = sm.histogram_state("lat_seconds", tenant="a")
        b = sm.histogram_state("lat_seconds", tenant="b")
        ab = m.merge_histogram_states(a, b)
        assert ab == m.merge_histogram_states(b, a)
        assert ab["count"] == 3
        assert ab["sum"] == pytest.approx(0.53)
        assert ab["counts"] == [
            x + y for x, y in zip(a["counts"], b["counts"])
        ]
        # the no-filter family merge is the same vector add
        assert sm.histogram_merged("lat_seconds") == ab
        # label-subset filter merges only the matching cells
        assert sm.histogram_merged("lat_seconds", tenant="b")["count"] == 2

    def test_quantile_is_upper_edge(self, m):
        sm = m.ServiceMetrics()
        for _ in range(99):
            sm.observe("lat_seconds", 0.01)
        sm.observe("lat_seconds", 10.0)
        state = sm.histogram_state("lat_seconds")
        # 0.01 s buckets under the 2^-6 edge; 10 s under the 16 s edge
        assert m.histogram_quantile(state, 0.5) == 2.0 ** -6
        assert m.histogram_quantile(state, 0.999) == 16.0

    def test_quantile_empty_and_overflow(self, m):
        assert m.histogram_quantile(_empty_state(m), 0.99) is None
        sm = m.ServiceMetrics()
        sm.observe("lat_seconds", 100.0)
        assert m.histogram_quantile(
            sm.histogram_state("lat_seconds"), 0.5
        ) == float("inf")

    def test_fraction_le(self, m):
        sm = m.ServiceMetrics()
        for _ in range(9):
            sm.observe("lat_seconds", 0.01)
        sm.observe("lat_seconds", 10.0)
        state = sm.histogram_state("lat_seconds")
        assert m.histogram_fraction_le(state, 1.0) == pytest.approx(0.9)
        # no traffic violates no objective
        assert m.histogram_fraction_le(_empty_state(m), 1.0) == 1.0


# ---------------------------------------------------------------------------
# Prometheus + JSON rendering
# ---------------------------------------------------------------------------


class TestHistogramRendering:
    def test_prometheus_exposition(self, m):
        sm = m.ServiceMetrics()
        sm.describe_histogram("deequ_test_latency_seconds", "Test latency.")
        for v in (0.001, 0.01, 0.1, 100.0):
            sm.observe("deequ_test_latency_seconds", v, tenant="a")
        text = sm.prometheus_text()
        assert "# HELP deequ_test_latency_seconds Test latency." in text
        assert "# TYPE deequ_test_latency_seconds histogram" in text
        buckets = [
            line for line in text.splitlines()
            if line.startswith("deequ_test_latency_seconds_bucket")
        ]
        assert len(buckets) == len(m.HISTOGRAM_EDGES) + 1  # finite + +Inf
        counts = [int(line.rsplit(" ", 1)[1]) for line in buckets]
        assert counts == sorted(counts)  # cumulative, non-decreasing
        assert counts[-1] == 4  # +Inf bucket == _count
        assert buckets[-1].startswith(
            'deequ_test_latency_seconds_bucket{tenant="a",le="+Inf"}'
        )
        assert 'deequ_test_latency_seconds_count{tenant="a"} 4' in text
        assert 'deequ_test_latency_seconds_sum{tenant="a"}' in text

    def test_json_snapshot_carries_histograms(self, m):
        sm = m.ServiceMetrics()
        sm.observe("lat_seconds", 0.01, tenant="a")
        snap = sm.json_snapshot()
        state = snap["histograms"]["lat_seconds"]["tenant=a"]
        assert state["count"] == 1
        assert sum(state["counts"]) == 1


# ---------------------------------------------------------------------------
# SLO evaluator burn rates
# ---------------------------------------------------------------------------


class TestSloEvaluator:
    def _pair(self, m):
        sm = m.ServiceMetrics()
        slo = m.SloEvaluator(sm)
        slo.add_objective(
            "lat", "lat_seconds", threshold_s=0.1, objective=0.99,
            window_s=300.0,
        )
        return sm, slo

    def test_idle_window_is_zero(self, m):
        _, slo = self._pair(m)
        assert slo.burn_rate("lat", now=0.0) == 0.0
        assert slo.burn_rate("lat", now=1.0) == 0.0

    def test_all_good_zero_burn(self, m):
        sm, slo = self._pair(m)
        slo.burn_rate("lat", now=0.0)  # baseline sample
        for _ in range(100):
            sm.observe("lat_seconds", 0.01)
        assert slo.burn_rate("lat", now=1.0) == 0.0

    def test_total_violation_burns_at_full_rate(self, m):
        sm, slo = self._pair(m)
        slo.burn_rate("lat", now=0.0)
        for _ in range(10):
            sm.observe("lat_seconds", 10.0)
        # (1 - 0) / (1 - 0.99) = 100
        assert slo.burn_rate("lat", now=1.0) == pytest.approx(100.0)

    def test_burning_exactly_at_budget_is_one(self, m):
        sm, slo = self._pair(m)
        slo.burn_rate("lat", now=0.0)
        for _ in range(99):
            sm.observe("lat_seconds", 0.01)
        sm.observe("lat_seconds", 10.0)
        assert slo.burn_rate("lat", now=1.0) == pytest.approx(1.0)

    def test_unknown_slug_raises(self, m):
        _, slo = self._pair(m)
        with pytest.raises(KeyError):
            slo.burn_rate("nope")


# ---------------------------------------------------------------------------
# live service instrumentation
# ---------------------------------------------------------------------------


class TestServiceInstrumentation:
    def test_fold_latency_and_admission_wait_per_tenant(self, m):
        with m.VerificationService(
            workers=2, background_warm=False, **m.svc
        ) as svc:
            sess = svc.session("acme", "d", _checks(m))
            sess.ingest({
                "x": np.arange(64.0), "y": np.ones(64),
            })
            fold = svc.metrics.histogram_merged(
                "deequ_service_fold_latency_seconds", tenant="acme"
            )
            assert fold["count"] >= 1
            wait = svc.metrics.histogram_merged(
                "deequ_service_admission_wait_seconds", tenant="acme"
            )
            assert wait["count"] >= 1
            # the cells are labeled tenant x priority
            cells = svc.metrics.histogram_cells(
                "deequ_service_fold_latency_seconds"
            )
            labels = dict(cells[0][0])
            assert labels["tenant"] == "acme"
            assert "priority" in labels

    def test_fleetwatch_default_slo_objectives(self, m):
        with m.VerificationService(
            workers=1, background_warm=False, **m.svc
        ) as svc:
            slugs = svc.fleetwatch.slo.objectives()
            assert "fold_latency" in slugs
            assert "admission_wait" in slugs
            rates = svc.fleetwatch.slo.burn_rates()
            assert set(rates) == set(slugs)
            # burn-rate gauges render on the export plane
            text = svc.metrics.prometheus_text()
            assert 'deequ_service_slo_burn_rate{slo="fold_latency"}' in text


# ---------------------------------------------------------------------------
# /statusz: registry, validation, live service, HTTP
# ---------------------------------------------------------------------------


def _valid_doc(m):
    planes = {
        "scheduler": {"queue_depth": 0, "active_jobs": 0, "shed_total": 0,
                      "quota_shed_total": 0},
        "tuning": {"enabled": False},
        "cluster": {"attached": False},
        "catalog": {"enabled": False},
        "fleetwatch": {"quarantined_sessions": [], "watched_series": 0},
        "partition_store": {"attached": False},
    }
    return {
        "statusz_version": m.STATUSZ_VERSION,
        "generated_unix_s": 1.0,
        "planes": planes,
    }


class TestStatuszRegistry:
    def test_snapshot_is_versioned(self, m):
        reg = m.StatuszRegistry()
        reg.register("tuning", lambda: {"enabled": True})
        doc = reg.snapshot()
        assert doc["statusz_version"] == m.STATUSZ_VERSION
        assert isinstance(doc["generated_unix_s"], float)
        assert doc["planes"]["tuning"] == {"enabled": True}

    def test_registration_is_last_wins(self, m):
        reg = m.StatuszRegistry()
        reg.register("cluster", lambda: {"attached": False})
        reg.register("cluster", lambda: {"attached": True, "host": "w0"})
        assert reg.snapshot()["planes"]["cluster"]["attached"] is True
        assert reg.planes() == ["cluster"]

    def test_sick_plane_degrades_to_error_section(self, m):
        reg = m.StatuszRegistry()

        def boom():
            raise RuntimeError("plane down")

        reg.register("tuning", boom)
        reg.register("cluster", lambda: {"attached": False})
        doc = reg.snapshot()
        assert doc["planes"]["tuning"] == {
            "error": "RuntimeError: plane down"
        }
        # the healthy plane still reports
        assert doc["planes"]["cluster"] == {"attached": False}
        assert any(
            "tuning" in p and "errored" in p
            for p in m.validate_statusz(doc)
        )


class TestValidateStatusz:
    def test_valid_document_passes(self, m):
        assert m.validate_statusz(_valid_doc(m)) == []

    def test_version_mismatch(self, m):
        doc = _valid_doc(m)
        doc["statusz_version"] = m.STATUSZ_VERSION + 1
        assert any("statusz_version" in p for p in m.validate_statusz(doc))

    def test_missing_plane(self, m):
        doc = _valid_doc(m)
        del doc["planes"]["fleetwatch"]
        assert any("fleetwatch" in p for p in m.validate_statusz(doc))

    def test_missing_required_key(self, m):
        doc = _valid_doc(m)
        del doc["planes"]["scheduler"]["queue_depth"]
        problems = m.validate_statusz(doc)
        assert any(
            "scheduler" in p and "queue_depth" in p for p in problems
        )

    def test_every_required_plane_has_a_key_contract(self, m):
        assert set(m.PLANE_REQUIRED_KEYS) == set(m.REQUIRED_PLANES)

    def test_non_object_document(self, m):
        assert m.validate_statusz(None) != []
        assert m.validate_statusz([1, 2]) != []


class TestLiveStatusz:
    def test_service_snapshot_covers_all_planes(self, m):
        with m.VerificationService(
            workers=1, background_warm=False, **m.svc
        ) as svc:
            doc = svc.statusz.snapshot()
            assert m.validate_statusz(doc) == []
            assert set(m.REQUIRED_PLANES) <= set(doc["planes"])

    def test_http_statusz_round_trip(self, m):
        with m.VerificationService(
            workers=1, background_warm=False, **m.svc
        ) as svc:
            exporter = svc.start_exporter()
            url = (
                f"http://{exporter.host}:{exporter.port}/statusz"
            )
            with urllib.request.urlopen(url, timeout=10) as resp:
                assert resp.status == 200
                doc = json.loads(resp.read())
            assert m.validate_statusz(doc) == []

    def test_exporter_without_statusz_serves_404(self, m):
        exporter = m.MetricsExporter(m.ServiceMetrics())
        try:
            url = (
                f"http://{exporter.host}:{exporter.port}/statusz"
            )
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(url, timeout=10)
            assert err.value.code == 404
        finally:
            exporter.close()



# ---------------------------------------------------------------------------
# tenant quotas on the token bucket's own clock
# ---------------------------------------------------------------------------


class TestTokenBucketClock:
    """The deficit bucket on the injectable clock (``charge(amount,
    now)``): no sleeps, the same admissions and waits in both packages."""

    def test_deficit_admission_and_refill(self, m):
        bucket = m.TokenBucket(10.0)
        assert bucket.charge(100, now=0.0) == 0.0  # admitted into debt
        assert bucket.tokens == -100.0
        assert bucket.charge(1, now=1.0) == pytest.approx(9.0, abs=0.0)
        assert bucket.charge(1, now=10.0) == 0.0  # the debt drained
        assert bucket.tokens == -1.0

    def test_idle_credit_is_capped_at_one_second(self, m):
        bucket = m.TokenBucket(10.0)
        bucket.charge(0, now=0.0)
        bucket.charge(0, now=3600.0)
        assert bucket.tokens == 10.0  # burst == rate

    def test_a_refused_charge_consumes_nothing(self, m):
        bucket = m.TokenBucket(4.0)
        bucket.charge(8, now=0.0)
        before = bucket.tokens
        assert bucket.charge(100, now=0.0) == pytest.approx(2.0, abs=0.0)
        assert bucket.tokens == before

    def test_quota_state_is_per_tenant_and_edits_reset_debt(self, m):
        with m.VerificationService(workers=1, background_warm=False, **m.svc) as svc:
            sched = svc.scheduler
            sched.set_quota("a", m.TenantQuota(rows_per_s=10, bytes_per_s=1e9))
            assert sched.get_quota("a") == m.TenantQuota(rows_per_s=10, bytes_per_s=1e9)
            assert sched.get_quota("b") is None
            sched.charge_quota("a", rows=100, nbytes=10, block_s=0.0)  # into debt
            sched.charge_quota("b", rows=10**9, block_s=0.0)  # no quota: free
            sched.set_quota("a", m.TenantQuota(rows_per_s=10))
            sched.charge_quota("a", rows=100, block_s=0.0)  # a fresh bucket
            sched.clear_quota("a")
            assert sched.get_quota("a") is None
            sched.charge_quota("a", rows=10**9, block_s=0.0)
            assert svc.metrics.counter_value("deequ_service_quota_shed_total") == 0


# ---------------------------------------------------------------------------
# chip_smoke phase 12's scenarios, on the CPU
# ---------------------------------------------------------------------------


def test_phase_12_fleet_is_the_benchs_fleet():
    import chip_smoke
    from tools.anomaly_fleet_bench import build_fleet

    assert chip_smoke.build_fleet(300) == build_fleet(300, 17)


def test_phase_12_documents_register_in_both_packages(tmp_path):
    import chip_smoke

    for m in (REF, PORT):
        catalog = m.TenantCatalog(str(tmp_path / m.name))
        catalog.register("t", chip_smoke.tenant_doc())
        catalog.register("t", chip_smoke.tenant_doc(priority="low", max_len=64))
        assert catalog.load("t").version == 2


@pytest.mark.parametrize("broken", [(5,), (5, 11)])
def test_a_holtwinters_harvest_flags_the_same_points_in_both_packages(broken, tmp_path):
    """Phase 12 (c)'s sixteen histories with their newest days (``(5,)`` is
    the phase's own scenario) through each package's fleet watch: one
    batched call, only the broken days flagged, the same points and values
    in both packages."""
    import chip_smoke

    now = int(time.time() * 1000)
    got = {}
    for m in (REF, PORT):
        with m.VerificationService(workers=1, background_warm=False, **m.svc) as svc:
            hw = m.HoltWinters(m.MetricInterval.DAILY, m.SeriesSeasonality.WEEKLY)
            for i in range(chip_smoke.WATCH_TENANTS):
                repo = m.PartitionedMetricsRepository(str(tmp_path / m.name / str(i)))
                days = chip_smoke.watch_series(i, i in broken)
                for d, size in enumerate(days):
                    repo.save(m.ResultKey(now - (len(days) - 1 - d) * DAY_MS), m.AnalyzerContext(
                        {m.Size(): m.DoubleMetric(m.Entity.DATASET, "Size", "*", m.Success(size))}))
                svc.watch_metrics(f"t{i:02d}", repo, [m.Size()], strategy=hw)
            report = svc.fleetwatch.harvest_now()
        assert report.detect_calls == 1 and report.series_scored == chip_smoke.WATCH_TENANTS
        got[m.name] = sorted((f[0], f[3], f[4], f[5]) for f in report.flagged)
    assert got["torch"] == got["jax"]
    assert [f[:2] for f in got["torch"]] == [(f"t{i:02d}", 35) for i in broken]


@pytest.mark.parametrize("tenant", range(16))
def test_phase_12_plain_recurrence_is_the_references_holtwinters(tenant):
    """Phase 12 (c) holds the harvest's flags against ``hw_oracle``, a
    plain recurrence written apart from both packages. On each of the
    phase's tenants, with the reference's fitted parameters, it gives the
    reference's forecast (1e-9 relative) and its flag, and it flags the
    broken tenant alone."""
    import chip_smoke

    assert chip_smoke.WATCH_TENANTS == 16
    days = chip_smoke.watch_series(tenant, tenant == 5)
    hw = REF.HoltWinters(REF.MetricInterval.DAILY, REF.SeriesSeasonality.WEEKLY)
    interval = (chip_smoke.WATCH_DAYS, chip_smoke.WATCH_DAYS + 1)
    params = hw.fit_batch([days], [interval])[0]
    forecast, flagged = chip_smoke.hw_oracle(days, *params)
    want = REF.additive_holt_winters(days[:-1], 7, 1, *params).forecasts[0]
    assert abs(forecast - want) <= 1e-9 * abs(want)
    assert bool(hw.detect(days, interval)) == flagged == (tenant == 5)
