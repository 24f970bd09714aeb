"""The port's whole-service chaos soak (``tools/torch_chaos_soak.py``) on
the CPU, held to the reference's ``tests/test_chaos_soak.py`` and to the
reference itself.

- **Small soak.** The reference test's sizes and assertions, plus: no
  drill skipped (the port's mesh and fleet drills run on shards of one
  device, where the reference skips them below 2 devices).
- **The plan.** ``default_plan`` of both packages fires the same faults,
  in the same order and with the same error types, over one scripted run
  of ``fire(site, tag)`` calls that covers every site of the plan.
- **A clean soak.** With no fault spec, every job's metrics equal the
  reference's verification of the same data and checks (moments to 1e-12
  relative, the rest exactly), and the soak's trace artifact summarizes
  to the same text through the port's summarizer and the reference's.
- **The big soak** (slow, as the reference's): its sizes with the
  multi-process cluster drill.

Every service of the soak sees fold timings fixed by route, not wall
clocks, as ``tests/test_torch_tuning_service.py`` fixes its controller's:
the host fast path at 5e7 rows/s a fold (1e8 rows/s an analyzer in the
coalescer's crossover router), the device route 20 ms a fold. So load on
the test machine can neither flip a route nor the floor's verdict, and
the tuning drill's demotion is deterministic. The drill's own 0.5x band
on its bursts' wall-clock sessions/s stays in the verdict. (With real
timings the port's soak demotes on the CPU as well, since the drill
starts from the router's seeds: ``tools/torch_chaos_soak.py``,
``_tuning_drill``.)
"""

from __future__ import annotations

import threading

import pytest

from tools import torch_chaos_soak as soak

pytestmark = pytest.mark.chaos

#: the fixed substrate: the fast path's rows/s a fold (the controller) and
#: an analyzer (the router), and the device route's seconds a fold
FAST_ROWS_PER_S = 5e7
HOST_ROWS_PER_S = 1e8
DEVICE_FOLD_S = 0.020
#: the sites of the default plan, in the scripted run's order
PLAN_SITES = ("device_update", "host_partial", "analyzer", "worker", "stream_fold",
              "compile", "state_load", "repository_load")
#: the chaos battery's moments, compared to 1e-12 relative
MOMENTS = ("Mean(y)", "StandardDeviation(y)")


@pytest.fixture(autouse=True)
def fixed_tuning_timings(tmp_path, monkeypatch):
    """Every tuning controller and crossover router of the soak sees its
    folds at fixed timings by route, and boots on an empty profile
    directory. Yields the router's own ``observe_host``."""
    from deequ_tpu_torch.service.coalesce import CrossoverRouter, FoldCoalescer
    from deequ_tpu_torch.tuning import knobs
    from deequ_tpu_torch.tuning.controller import TuningController

    for env in (knobs.AUTOTUNE_ENV, knobs.TUNING_SHADOW_FRACTION_ENV,
                knobs.TUNING_MIN_SAMPLES_ENV, knobs.TUNING_BAND_ENV,
                "DEEQU_TPU_FAST_PATH_MAX_ROWS", "DEEQU_TPU_COALESCE"):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv(knobs.TUNING_PROFILE_DIR_ENV, str(tmp_path / "profiles"))
    route = threading.local()

    def timed(method, name):
        def wrapper(self, *args, **kwargs):
            route.name = name
            try:
                return method(self, *args, **kwargs)
            finally:
                route.name = None
        return wrapper

    monkeypatch.setattr(FoldCoalescer, "_execute_fast",
                        timed(FoldCoalescer._execute_fast, "fast"))
    monkeypatch.setattr(FoldCoalescer, "_launch", timed(FoldCoalescer._launch, "device"))
    record = TuningController.record
    observe_host = CrossoverRouter.observe_host
    observe_device = CrossoverRouter.observe_device

    def fixed_record(self, rows, seconds, arm=None):
        fast = getattr(route, "name", None) == "fast"
        record(self, rows, rows / FAST_ROWS_PER_S if fast else DEVICE_FOLD_S, arm=arm)

    monkeypatch.setattr(TuningController, "record", fixed_record)
    monkeypatch.setattr(CrossoverRouter, "observe_host", lambda self, cls, rows, seconds:
                        observe_host(self, cls, rows, rows / HOST_ROWS_PER_S))
    monkeypatch.setattr(CrossoverRouter, "observe_device", lambda self, rows, seconds, folds:
                        observe_device(self, rows, DEVICE_FOLD_S * folds, folds))
    knobs.clear_tuned()
    yield {"observe_host": observe_host}
    knobs.clear_tuned()


def _assert_tuning_drill(drill):
    assert drill["demoted"] and drill["floor_demotions"] >= 1, drill
    assert "floor_demotion" in drill["decisions"], drill


def test_small_soak_invariants_hold():
    summary = soak.run_soak(jobs=10, stream_batches=4, rows=2048, seed=3, workers=3,
                            device="cpu")
    assert summary["ok"], summary
    assert summary["succeeded"] + summary["typed_failures"] == 10
    assert summary["unterminated"] == 0
    assert summary["untyped_failures"] == 0
    assert summary["incomplete_metric_maps"] == 0
    assert summary["stream_fold_parity"]
    assert soak.skipped_drills(summary) == [], summary
    assert summary["faults_fired"] > 0
    assert summary["mesh_drill"]["devices"] == soak.MESH_DRILL_SHARDS
    assert summary["fleet_drill"]["devices"] == soak.FLEET_DRILL_DEVICES
    _assert_tuning_drill(summary["tuning_drill"])
    report = summary["tuning_report"]
    assert report["enabled"] and "floor_demotion" in [d["verdict"] for d in report["decisions"]]


@pytest.mark.parametrize("seed", [5, 11])
def test_the_plan_fires_as_the_references(seed):
    """The same scripted probes through both packages' ``default_plan(seed)``
    fire the same faults with the same error types."""
    from deequ_tpu.reliability import FaultInjector as RefInjector
    from deequ_tpu_torch.reliability import FaultInjector

    from tools import chaos_soak as ref_soak

    def script(injector):
        raised = []
        for i in range(256):
            for site in PLAN_SITES:
                tag = f"StandardDeviation(y)#{i}" if site == "analyzer" and i % 2 else str(i)
                try:
                    injector.fire(site, tag)
                except BaseException as exc:  # noqa: BLE001 - KeyboardInterrupt kinds too
                    raised.append((site, tag, type(exc).__name__))
        return raised

    ref = RefInjector(ref_soak.default_plan(seed), seed=seed)
    port = FaultInjector(soak.default_plan(seed), seed=seed)
    ref_raised, port_raised = script(ref), script(port)
    assert port.fired == ref.fired
    assert port_raised == ref_raised
    fired_sites = {f.split(":")[0] for f in port.fired}
    assert fired_sites == set(PLAN_SITES), fired_sites
    assert [(s.site, s.kind, s.p, s.count, s.at, s.match, s.delay_s)
            for s in soak.default_plan(seed)] == [
        (s.site, s.kind, s.p, s.count, s.at, s.match, s.delay_s)
        for s in ref_soak.default_plan(seed)]


def test_a_clean_soak_equals_the_reference():
    import deequ_tpu

    from tools import chaos_soak as ref_soak
    from tools import torch_trace_summarize, trace_summarize

    jobs, rows, seed = 6, 2048, 3
    summary = soak.run_soak(jobs=jobs, stream_batches=2, rows=rows, seed=seed, workers=2,
                            specs=[], device="cpu")
    assert summary["ok"], summary
    assert summary["faults_fired"] == 0 and summary["degraded_metrics"] == 0
    assert summary["succeeded"] == jobs == len(summary["job_metrics"])

    result = (deequ_tpu.VerificationSuite.on_data(ref_soak._build_data(rows, seed))
              .add_checks(ref_soak._checks()).run())
    want = soak._metric_values(result)
    assert len(want) == 5 and None not in want.values()
    for got in summary["job_metrics"]:
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            if key in MOMENTS:
                assert got[key] == pytest.approx(value, rel=1e-12, abs=0.0), key
            else:
                assert got[key] == value, key

    artifact = summary["trace_artifact"]
    assert artifact is not None
    assert torch_trace_summarize.summarize(artifact) == trace_summarize.summarize(artifact)


def test_the_tuning_drill_starts_from_the_routers_seeds(fixed_tuning_timings):
    """A fold of a few rows fits a host rate of a few thousand rows/s (the
    router's host model has no fixed cost), after which the drill's static
    8,192-row folds would take the device route, the planted
    ``fast_path_max_rows=0`` would change no route and nothing would
    demote. The drill resets the router first: its static burst takes the
    fast path and the floor demotes the planted knob."""
    from deequ_tpu_torch.analyzers import Completeness, Mean
    from deequ_tpu_torch.service import VerificationService
    from deequ_tpu_torch.service.coalesce import FoldPlan

    with VerificationService(workers=1, background_warm=False, device="cpu") as svc:
        router = svc.coalescer.router
        for cls in (Completeness, Mean):  # a 5-row fold's real fit
            fixed_tuning_timings["observe_host"](router, cls, 5, 1e-4)
        plan = FoldPlan((Completeness("x"), Mean("y")), ("x", "y"), True, ())
        assert router.route(plan, 8192) == "device"
        drill = soak._tuning_drill(svc)
        counts = {r: svc.metrics.counter_value("deequ_service_fold_route_total", route=r)
                  for r in ("fast", "device")}
    _assert_tuning_drill(drill)
    assert drill["ok"], drill
    # the floor needs 8 live folds past the static ones: 8 device folds,
    # then the fast path again; the static burst and its warm-up fold fast
    assert counts == {"fast": 1 + 24 + 40, "device": 8}, counts


@pytest.mark.parametrize("drill", ["mesh", "repository"])
def test_a_drills_ground_truth_runs_outside_the_soak_plan(drill, tmp_path):
    """Under a soak plan that fails every device pass over to the host
    tier and poisons every host partial, the port's mesh and repository
    drills still define their ground truth (its run goes under an empty
    plan) and hold; the reference's raise out of the soak (ROADMAP C)."""
    from deequ_tpu.reliability import FaultSpec as RefSpec
    from deequ_tpu.reliability import clear as ref_clear
    from deequ_tpu.reliability import install as ref_install
    from deequ_tpu_torch.reliability import FaultSpec, clear, install

    from tools import chaos_soak as ref_soak

    def plan(spec):
        return [spec("device_update", "device", every=1, count=None),
                spec("host_partial", "poison", every=1, count=None)]

    install(plan(FaultSpec))
    try:
        data = soak._build_data(4096, 0)
        out = (soak._mesh_drill(data, "cpu") if drill == "mesh"
               else soak._repository_drill(data, str(tmp_path / "port"), "cpu"))
    finally:
        clear()
    assert out["ok"], out

    ref_install(plan(RefSpec))
    try:
        data = ref_soak._build_data(4096, 0)
        with pytest.raises(Exception, match="poisoned" if drill == "mesh" else "not found"):
            if drill == "mesh":
                ref_soak._mesh_drill(data)
            else:
                (tmp_path / "ref").mkdir()
                ref_soak._repository_drill(data, str(tmp_path / "ref"))
    finally:
        ref_clear()


@pytest.mark.slow
def test_big_soak_invariants_hold():
    summary = soak.run_soak(jobs=50, stream_batches=12, rows=8192, seed=1, workers=4,
                            cluster_drill=True, device="cpu")
    assert summary["ok"], summary
    assert summary["faults_fired"] > 0
    assert soak.skipped_drills(summary) == [], summary
    drill = summary["cluster_drill"]
    assert drill["ok"], drill
    assert drill["sessions_recovered"] >= 1, drill
    _assert_tuning_drill(summary["tuning_drill"])

