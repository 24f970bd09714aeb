"""Resumable ingest checkpoints of the PyTorch/CUDA port
(deequ_tpu_torch.reliability.checkpoint and ``checkpointer=`` on the
engine's tiers) against the JAX reference: the reference's cases of
``tests/test_reliability.py::TestResumableIngest`` run through both
packages (``m`` is either package; the port on ``device="cpu"``), and a
checkpoint either package wrote when its own fault injector interrupted it
is resumed by the other.

Tolerances: a resumed run equals the same package's uninterrupted run bit
for bit (KLL sketches by their buckets' repr), as the reference's test
holds; the port against the reference: counts, minima, maxima, HLL, KLL
sketches and uniqueness equal, means, sums and standard deviations within
1e-12 relative. Both run the device tier at the same batch size (the
reference at ``placement="device"``, tests/conftest.py), or both the host
tier, whose KLL samples are then equal too.
"""

from __future__ import annotations

import threading
from types import SimpleNamespace

import numpy as np
import pytest

import deequ_tpu.analyzers as J
import deequ_tpu.checks as JC
import deequ_tpu.reliability as JRel
from deequ_tpu.analyzers.state_provider import (
    FileSystemStateProvider as JFileSystemStateProvider,
    InMemoryStateProvider as JInMemoryStateProvider,
)
from deequ_tpu.data import Dataset as JDataset
from deequ_tpu.runners import AnalysisRunner as JRunner
from deequ_tpu.runners.engine import RunMonitor as JMonitor
from deequ_tpu.verification import VerificationSuite as JSuite
import deequ_tpu_torch as dq
import deequ_tpu_torch.analyzers as T
import deequ_tpu_torch.reliability as TRel
from deequ_tpu_torch.analyzers.state_provider import (
    FileSystemStateProvider,
    InMemoryStateProvider,
)

MOMENTS = ("Mean", "Sum", "StandardDeviation")

REF = SimpleNamespace(name="jax", A=J, C=JC, Dataset=JDataset, Runner=JRunner, Suite=JSuite,
                      Monitor=JMonitor, R=JRel, Memory=JInMemoryStateProvider,
                      Files=JFileSystemStateProvider, kw={}, host_env=True)
PORT = SimpleNamespace(name="torch", A=T, C=dq, Dataset=dq.Dataset, Runner=dq.AnalysisRunner,
                       Suite=dq.VerificationSuite, Monitor=dq.RunMonitor, R=TRel,
                       Memory=InMemoryStateProvider, Files=FileSystemStateProvider,
                       kw={"device": "cpu"}, host_env=False)


@pytest.fixture(params=[REF, PORT], ids=["jax", "torch"])
def m(request):
    return request.param


def numeric(m, rows: int):
    rng = np.random.default_rng(7)
    return m.Dataset.from_dict({"x": rng.normal(0.0, 1.0, rows)})


def grouped(m, rows: int = 80 * 512):
    rng = np.random.default_rng(3)
    return m.Dataset.from_dict({"x": rng.normal(size=rows),
                                "g": [f"id_{i}" for i in range(rows)]})


def battery(m) -> list:
    A = m.A
    return [A.Completeness("x"), A.Mean("x"), A.Sum("x"), A.Minimum("x"), A.Maximum("x"),
            A.StandardDeviation("x"), A.KLLSketch("x")]


def host_battery(m) -> list:
    A = m.A
    return [A.Mean("x"), A.Sum("x"), A.KLLSketch("x"), A.Uniqueness(("g",))]


def run(m, data, analyzers, **kw):
    return m.Runner.do_analysis_run(data, analyzers, **m.kw, **kw)


def values(ctx) -> dict:
    out = {}
    for a, metric in ctx.metric_map.items():
        v = metric.value.get()
        out[repr(a)] = repr(v.buckets) if hasattr(v, "buckets") else v
    return out


def settle_abandoned_passes() -> None:
    """Wait for the passes the reference's watchdog abandoned in earlier
    tests of this process. Its stall drills leave a pass asleep for 30 s
    inside ``fault_point("device_update")``; once awake, its remaining
    batches probe whatever injector is armed then, and those hits would
    count against this test's."""
    for thread in threading.enumerate():
        if thread.name.startswith("scan-watchdog"):
            thread.join(timeout=60)


def interrupted(m, data, analyzers, checkpointer, spec, **kw):
    settle_abandoned_passes()
    with m.R.inject(spec) as inj:
        with pytest.raises(KeyboardInterrupt):
            run(m, data, analyzers, checkpointer=checkpointer, **kw)
    assert inj.fired


def assert_close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key, w in want.items():
        if key.split("(")[0] in MOMENTS:
            assert got[key] == pytest.approx(w, rel=1e-12), key
        else:
            assert got[key] == w, key


def test_device_path_resume_equals_uninterrupted(m):
    data = numeric(m, 16 * 1024)
    want = values(run(m, data, battery(m), batch_size=1024))
    ckpt = m.R.IngestCheckpointer(m.Memory(), every=4)
    interrupted(m, data, battery(m), ckpt, m.R.FaultSpec("device_update", "interrupt", at=11),
                batch_size=1024)
    assert [index for index, _ in ckpt.saves] == [4, 8]
    mon = m.Monitor()
    got = run(m, data, battery(m), batch_size=1024, checkpointer=ckpt, monitor=mon)
    assert mon.resumed_at_batch == 8 and mon.batches == 8
    assert mon.checkpoint_saves == 2  # batches 12 and 16, then the run completes
    assert values(got) == want


def test_completion_clears_the_checkpoint(m):
    data = numeric(m, 8 * 1024)
    ckpt = m.R.IngestCheckpointer(m.Memory(), every=2)
    run(m, data, battery(m), batch_size=1024, checkpointer=ckpt)
    mon = m.Monitor()
    run(m, data, battery(m), batch_size=1024, checkpointer=ckpt, monitor=mon)
    assert mon.resumed_at_batch is None and mon.batches == 8


def test_a_shape_mismatch_ignores_the_checkpoint(m):
    data = numeric(m, 8 * 1024)
    ckpt = m.R.IngestCheckpointer(m.Memory(), every=2)
    interrupted(m, data, battery(m), ckpt, m.R.FaultSpec("device_update", "interrupt", at=5),
                batch_size=1024)
    assert ckpt.saves
    mon = m.Monitor()
    run(m, data, battery(m), batch_size=2048, checkpointer=ckpt, monitor=mon)
    assert mon.resumed_at_batch is None


def test_host_tier_resume_equals_uninterrupted(m, monkeypatch):
    if m.host_env:
        from deequ_tpu.runners.engine import HOST_TIER_WORKERS_ENV

        monkeypatch.setenv(HOST_TIER_WORKERS_ENV, "2")
    data = grouped(m)
    want = values(run(m, data, host_battery(m), batch_size=512, placement="host"))
    ckpt = m.R.IngestCheckpointer(m.Memory(), every=8)
    interrupted(m, data, host_battery(m), ckpt,
                m.R.FaultSpec("host_partial", "interrupt", at=75),
                batch_size=512, placement="host")
    # host-tier checkpoints land on chunk (32-batch) boundaries
    assert [index for index, _ in ckpt.saves] == [32, 64]
    mon = m.Monitor()
    got = run(m, data, host_battery(m), batch_size=512, placement="host", checkpointer=ckpt,
              monitor=mon)
    assert mon.resumed_at_batch == 64 and mon.batches == 16
    assert values(got) == want


def test_filesystem_provider_checkpoint_roundtrip(m, tmp_path):
    data = numeric(m, 8 * 1024)
    analyzers = [m.A.Completeness("x"), m.A.Mean("x"), m.A.Sum("x")]
    want = values(run(m, data, analyzers, batch_size=1024))
    store = str(tmp_path / "ckpt")
    interrupted(m, data, analyzers, m.R.IngestCheckpointer(m.Files(store), every=2),
                m.R.FaultSpec("device_update", "interrupt", at=6), batch_size=1024)
    mon = m.Monitor()
    got = run(m, data, analyzers, batch_size=1024,
              checkpointer=m.R.IngestCheckpointer(m.Files(store), every=2), monitor=mon)
    assert mon.resumed_at_batch == 4
    assert values(got) == want


def test_checkpointer_via_the_suite_builder(m):
    data = numeric(m, 4096)
    check = m.C.Check(m.C.CheckLevel.ERROR, "ck").has_mean("x", lambda x: abs(x) < 1)
    ckpt = m.R.IngestCheckpointer(m.Memory(), every=1)
    result = (m.Suite.on_data(data, **m.kw).add_check(check).with_batch_size(1024)
              .checkpoint_with(ckpt).run())
    assert result.status == m.C.CheckStatus.SUCCESS
    assert len(ckpt.saves) >= 3


def test_a_torn_save_invalidates_the_resume(m):
    data = numeric(m, 8 * 1024)
    analyzers = [m.A.Completeness("x"), m.A.Mean("x"), m.A.Sum("x")]
    want = values(run(m, data, analyzers, batch_size=1024))
    ckpt = m.R.IngestCheckpointer(m.Memory(), every=2)
    interrupted(m, data, analyzers, ckpt, m.R.FaultSpec("device_update", "interrupt", at=6),
                batch_size=1024)
    assert ckpt.saves
    ckpt._write_meta(None)
    mon = m.Monitor()
    got = run(m, data, analyzers, batch_size=1024, checkpointer=ckpt, monitor=mon)
    assert mon.resumed_at_batch is None and mon.batches == 8
    assert values(got) == want


def test_interval_validation(m):
    with pytest.raises(ValueError):
        m.R.IngestCheckpointer(m.Memory(), every=0)
    with pytest.raises(TypeError):
        m.R.IngestCheckpointer(object())


def test_a_corrupt_checkpoint_costs_the_resume_point_not_the_run(tmp_path):
    data = numeric(PORT, 8 * 1024)
    analyzers = [T.Completeness("x"), T.Mean("x")]
    want = values(run(PORT, data, analyzers, batch_size=1024))
    store = str(tmp_path / "ckpt")
    interrupted(PORT, data, analyzers, TRel.IngestCheckpointer(FileSystemStateProvider(store),
                                                               every=2),
                TRel.FaultSpec("device_update", "interrupt", at=6), batch_size=1024)
    meta = tmp_path / "ckpt" / "ingest-checkpoint-meta.json"
    meta.write_text(meta.read_text().replace('"batch_index": 4', '"batch_index": 2'))
    ckpt = TRel.IngestCheckpointer(FileSystemStateProvider(store), every=2)
    mon = dq.RunMonitor()
    got = run(PORT, data, analyzers, batch_size=1024, checkpointer=ckpt, monitor=mon)
    assert mon.resumed_at_batch is None and ckpt.corrupt_discards == 1
    assert mon.corrupt_quarantined == 1
    assert values(got) == want


def test_an_exact_quantile_battery_runs_without_checkpoints(caplog):
    data = numeric(PORT, 4096)
    ckpt = TRel.IngestCheckpointer(InMemoryStateProvider(), every=1)
    exact = T.ApproxQuantile("x", 0.5, 0.0)
    got = run(PORT, data, [exact, T.Mean("x")], batch_size=1024, checkpointer=ckpt)
    assert got.metric(exact).value.is_success and not ckpt.saves
    assert "running without checkpoints" in caplog.text


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("tier", ["device", "host"])
def test_a_checkpoint_written_by_either_package_resumes_in_the_other(writer, tier, tmp_path):
    """One package is interrupted by its own fault injector with a
    checkpointer over a directory; the other resumes from that directory
    (the meta record, the v2 state blobs and, on the host tier, a grouping
    set's frequency table under the reference's key) and ends with the
    writer's uninterrupted metrics."""
    first, second = (REF, PORT) if writer == "jax" else (PORT, REF)
    store = str(tmp_path / "ckpt")
    if tier == "device":
        make, analyzers, kw = numeric, battery, dict(batch_size=1024)
        spec, resumed_at, rows = ("device_update", 11), 8, 16 * 1024
    else:
        make, analyzers, kw = grouped, host_battery, dict(batch_size=512, placement="host")
        spec, resumed_at, rows = ("host_partial", 75), 64, 80 * 512
    want = values(run(first, make(first, rows), analyzers(first), **kw))
    interrupted(first, make(first, rows), analyzers(first),
                first.R.IngestCheckpointer(first.Files(store), every=8 if tier == "host" else 4),
                first.R.FaultSpec(spec[0], "interrupt", at=spec[1]), **kw)
    mon = second.Monitor()
    got = run(second, make(second, rows), analyzers(second),
              checkpointer=second.R.IngestCheckpointer(second.Files(store), every=4),
              monitor=mon, **kw)
    assert mon.resumed_at_batch == resumed_at
    assert_close(values(got), want)
