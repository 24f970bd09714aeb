"""The tuning controller's three hooks in the PyTorch/CUDA port's streaming
service (``deequ_tpu_torch.service.coalesce``), on the CPU.

- **Shadow arm.** With a shadow experiment on ``fast_path_max_rows``,
  exactly every period-th eligible fold is routed the candidate's way and
  recorded under the candidate's arm; the rest keep the incumbent route.
- **Timing sites.** Every fold of the session reaches ``record`` once
  (the host fast path and the coalesced launch): the controller's live
  sample count equals the folds ingested.
- **Guardrail.** The reference's chaos-soak drill (``tools/chaos_soak.py``,
  ``_tuning_drill``) adapted: a static burst, ``fast_path_max_rows=0``
  planted through ``set_tuned``, a recovered burst. The timings the
  controller sees are fixed by route (the device route recorded 20x
  slower than the fast path), not read from a wall clock, so the floor's
  demotion is deterministic.
"""

from __future__ import annotations

import threading

import numpy as np
import pyarrow as pa
import pytest

import deequ_tpu_torch as dq
from deequ_tpu_torch.service import VerificationService
from deequ_tpu_torch.tuning import knobs

pytestmark = pytest.mark.tuning

ROWS = 512
WAIT_S = 60


@pytest.fixture(autouse=True)
def _plane(tmp_path, monkeypatch):
    for env in (knobs.AUTOTUNE_ENV, knobs.TUNING_SHADOW_FRACTION_ENV,
                knobs.TUNING_MIN_SAMPLES_ENV, knobs.TUNING_BAND_ENV,
                "DEEQU_TPU_FAST_PATH_MAX_ROWS", "DEEQU_TPU_COALESCE"):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv(knobs.TUNING_PROFILE_DIR_ENV, str(tmp_path / "profiles"))
    knobs.clear_tuned()
    yield
    knobs.clear_tuned()


def _service():
    return VerificationService(workers=1, background_warm=False, device="cpu")


def _check():
    return (dq.Check(dq.CheckLevel.ERROR, "tuning")
            .is_complete("x").has_mean("y", lambda m: 5.0 < m < 15.0))


def _table(seed: int = 77) -> pa.Table:
    rng = np.random.default_rng(seed)
    return pa.table({"x": rng.normal(size=ROWS), "y": rng.normal(10.0, 2.0, size=ROWS)})


def _spy(controller):
    """Record every ``record`` call's arm, in order."""
    arms = []
    record = controller.record

    def spied(rows, seconds, arm=None):
        arms.append(arm)
        record(rows, seconds, arm=arm)

    controller.record = spied
    return arms


def test_shadow_arm_and_timing_sites(monkeypatch):
    # the incumbent sends every fold to the device; the candidate (8,192
    # rows) sends this battery's 512-row folds to the host fast path
    monkeypatch.setenv("DEEQU_TPU_FAST_PATH_MAX_ROWS", "0")
    monkeypatch.setenv(knobs.TUNING_SHADOW_FRACTION_ENV, "0.25")  # period 4
    monkeypatch.setenv(knobs.TUNING_MIN_SAMPLES_ENV, "1000")      # no verdict here
    folds = 13
    with _service() as svc:
        ctl = svc.tuning_controller
        assert ctl is not None and ctl.profile is None
        arms = _spy(ctl)
        session = svc.session("tuning", "stream", [_check()])
        assert ctl.propose("fast_path_max_rows", 8192, mode="shadow")
        for _ in range(folds):
            session.ingest(_table(), timeout=WAIT_S)
        m = svc.metrics
        assert arms == ([None] * 3 + ["fast_path_max_rows"]) * 3 + [None]
        assert m.counter_value("deequ_service_tuning_shadow_folds_total") == folds // 4
        assert m.counter_value("deequ_service_fold_route_total", route="fast") == folds // 4
        assert m.counter_value("deequ_service_fold_route_total", route="device") == (
            folds - folds // 4)
        snap = ctl.snapshot()
        assert snap["live_samples"] == folds == session.batches_ingested
        exp = snap["experiments"]["fast_path_max_rows"]
        assert (exp["candidate_samples"], exp["incumbent_samples"]) == (3, 10)
        assert exp["incumbent"] == 0 and exp["candidate"] == 8192


def test_guardrail_drill_demotes_a_planted_knob(monkeypatch):
    monkeypatch.setenv(knobs.TUNING_MIN_SAMPLES_ENV, "8")
    fast_s, device_s = 0.001, 0.020
    with _service() as svc:
        ctl = svc.tuning_controller
        coalescer = svc.coalescer
        route = threading.local()
        recorded = []

        def timed(method, name):
            def wrapper(*args, **kwargs):
                route.name = name
                try:
                    return method(*args, **kwargs)
                finally:
                    route.name = None
            return wrapper

        coalescer._execute_fast = timed(coalescer._execute_fast, "fast")
        coalescer._launch = timed(coalescer._launch, "device")
        record = ctl.record

        def fixed_timing(rows, seconds, arm=None):
            recorded.append(route.name)
            record(rows, fast_s if route.name == "fast" else device_s, arm=arm)

        ctl.record = fixed_timing
        session = svc.session("tuning-drill", "stream", [_check()])
        table = _table()

        def burst(n):
            for _ in range(n):
                session.ingest(table, timeout=WAIT_S)

        session.ingest(table, timeout=WAIT_S)  # warm the static route
        burst(24)
        assert recorded == ["fast"] * 25
        snap = ctl.snapshot()
        assert snap["static_samples"] == snap["live_samples"] == 25
        knobs.set_tuned("fast_path_max_rows", 0, source="drill")
        burst(24)
        burst(24)
        m = svc.metrics
        decisions = ctl.snapshot()["decisions"]
        assert [d["verdict"] for d in decisions] == ["floor_demotion"]
        assert decisions[0]["knob"] == "fast_path_max_rows"
        assert m.counter_value("deequ_service_tuning_demotions_total") == 1.0
        assert not knobs.any_tuned()
        # the floor needs static samples + 8 live ones: the 8th device
        # fold demotes, and every fold after it takes the fast path again
        assert recorded[25:] == ["device"] * 8 + ["fast"] * 40
        # the live EWMA restarted at the demotion: it holds the folds after it
        assert ctl.snapshot()["live_samples"] == 40
        assert session.batches_ingested == 73
