"""The feed pipeline of the PyTorch/CUDA port (``deequ_tpu_torch.ingest.
prefetch`` and the engine's device tier over it) against the JAX
reference: the reference's ``TestPrefetch`` (``tests/test_ingest.py:
470-600``), each iterator case through both packages' iterators, the
engine cases through both runners (the port on ``device="cpu"``), the
feed-stall failover included. Plus: depth 0 and depth 2 give the same
states bit for bit on the port's device tier, and a feed thread stops once
its pass is cancelled. The same parity on the card is in
``tests/test_torch_cuda.py``.

Tolerances: metrics across depths bit for bit; the port against the
reference: counts equal, means and sums within 1e-12 relative (a
failed-over run: the host tier in both packages).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

import deequ_tpu.analyzers as J
import deequ_tpu.ingest.prefetch as JP
import deequ_tpu.reliability as JRel
from deequ_tpu.data import Dataset as JDataset
from deequ_tpu.exceptions import FeedStallError as JFeedStallError
from deequ_tpu.runners import AnalysisRunner as JRunner
from deequ_tpu.runners.engine import RunMonitor as JMonitor
import deequ_tpu_torch as dq
import deequ_tpu_torch.ingest.prefetch as TP
import deequ_tpu_torch.reliability as TRel
from deequ_tpu_torch.exceptions import FeedStallError
from deequ_tpu_torch.runners.engine import ScanEngine

from torch_pairs import reference_isolated  # noqa: F401 - autouse fixture

pytestmark = pytest.mark.ingest


@pytest.fixture(params=[JP, TP], ids=["jax", "torch"])
def pf(request):
    return request.param


class TestPrefetch:
    def test_preserves_order_and_stops(self, pf):
        items = iter(range(10))
        with pf.PrefetchingBatchIterator(lambda: next(items, None), depth=2) as it:
            assert list(it) == list(range(10))

    def test_serial_depth_zero_inline(self, pf):
        calls = []
        items = iter(range(4))

        def produce():
            calls.append(threading.current_thread().name)
            return next(items, None)

        with pf.PrefetchingBatchIterator(produce, depth=0) as it:
            got = list(it)
        assert got == list(range(4))
        assert set(calls) == {threading.current_thread().name}

    def test_propagates_producer_exception(self, pf):
        state = {"n": 0}

        def produce():
            state["n"] += 1
            if state["n"] == 3:
                raise RuntimeError("boom")
            return state["n"]

        with pf.PrefetchingBatchIterator(produce, depth=2) as it:
            assert next(it) == 1
            assert next(it) == 2
            with pytest.raises(RuntimeError, match="boom"):
                for _ in it:
                    pass

    def test_close_unblocks_parked_producer(self, pf):
        it = pf.PrefetchingBatchIterator(lambda: "item", depth=1)  # endless
        assert next(it) == "item"
        it.close()  # must not hang on the full queue
        assert it._thread is None

    def test_silent_feed_trips_stall_deadline_typed(self, pf):
        stall_type = JFeedStallError if pf is JP else FeedStallError
        wedge = threading.Event()

        def produce():
            wedge.wait(30)  # a hung copy: never returns, never raises
            return None

        with pf.PrefetchingBatchIterator(produce, depth=1, stall_timeout_s=0.3) as it:
            t0 = time.perf_counter()
            with pytest.raises(stall_type):
                next(it)
            assert 0.2 <= time.perf_counter() - t0 < 10.0
        wedge.set()

    def test_env_depth_warn_and_fallback(self, pf, monkeypatch):
        monkeypatch.setenv(pf.PREFETCH_DEPTH_ENV, "not-a-number")
        # the reference feeds at depth 2 by default, the port serially
        assert pf.prefetch_depth() == pf.DEFAULT_PREFETCH_DEPTH == (0 if pf is TP else 2)
        monkeypatch.setenv(pf.PREFETCH_DEPTH_ENV, "5")
        assert pf.prefetch_depth() == 5
        monkeypatch.setenv(pf.PREFETCH_DEPTH_ENV, "0")
        assert pf.prefetch_depth() == 0

    def test_a_one_batch_pass_stages_inline(self, pf):
        assert pf.staging_depth(1) == 0
        assert pf.staging_depth(2) is None

    def test_a_stopped_feed_produces_and_probes_nothing_more(self):
        """The port's cancel: once the pass's ``stop`` event is set, the feed
        thread ends without another produce or ``prefetch`` probe."""
        stop = threading.Event()
        produced = []

        def produce():
            produced.append(len(produced))
            if len(produced) == 2:
                stop.set()
            return len(produced)

        with TRel.inject(TRel.FaultSpec("prefetch", "stall", count=None)) as inj:
            with TP.PrefetchingBatchIterator(produce, depth=1, stop=stop) as it:
                got = list(it)
        # what the consumer saw before the stop depends on timing; nothing
        # was produced or probed after it
        assert produced == [0, 1] and got == [1, 2][:len(got)]
        assert inj.fired == ["prefetch:0:stall", "prefetch:1:stall"]


def engine_data(m, rows, seed):
    rng = np.random.default_rng(seed)
    return m.from_dict({"x": rng.normal(size=rows)})


def metrics(ctx) -> dict:
    return {repr(a): m.value.get() for a, m in ctx.metric_map.items() if m.value.is_success}


def test_engine_parity_across_depths(monkeypatch):
    def run(depth):
        monkeypatch.setenv("DEEQU_TPU_PREFETCH_DEPTH", str(depth))
        jctx = JRunner.do_analysis_run(engine_data(JDataset, 50_000, 6),
                                       [J.Completeness("x"), J.Mean("x"), J.Sum("x")],
                                       batch_size=8192, placement="device")
        tctx = dq.AnalysisRunner.do_analysis_run(engine_data(dq.Dataset, 50_000, 6),
                                                 [dq.Completeness("x"), dq.Mean("x"), dq.Sum("x")],
                                                 batch_size=8192, placement="device",
                                                 device="cpu")
        return metrics(jctx), metrics(tctx)

    (j0, t0), (j1, t1), (j3, t3) = run(0), run(1), run(3)
    assert j0 == j1 == j3 and t0 == t1 == t3 and len(t0) == 3  # bit for bit
    for key, want in j0.items():
        assert t0[key] == pytest.approx(want, rel=1e-12), key


def test_depth_0_and_depth_2_give_the_same_states_on_the_device_tier(monkeypatch):
    """The engine's device tier at depth 0 (the serial loop) and at depth 2
    (a feed thread staging two batches ahead): every state bit for bit,
    the same batches and device updates."""
    import chip_smoke

    rng = np.random.default_rng(9)
    rows = 40_000
    data = dq.Dataset.from_dict({
        "x": rng.normal(size=rows), "k": rng.integers(0, 500, rows),
        "s": np.array([f"v{i % 97}" for i in range(rows)]),
    })
    battery = [dq.Size(), dq.Mean("x"), dq.StandardDeviation("x"), dq.Maximum("x"),
               dq.ApproxCountDistinct("k"), dq.KLLSketch("x"), dq.DataType("s"),
               dq.Correlation("x", "k")]
    out = []
    for depth in (0, 2):
        monkeypatch.setenv("DEEQU_TPU_PREFETCH_DEPTH", str(depth))
        monitor = dq.RunMonitor()
        engine = ScanEngine(battery, torch.device("cpu"), monitor=monitor, placement="device")
        out.append((engine.run(data, batch_size=4096), monitor))
    (s0, m0), (s2, m2) = out
    assert all(chip_smoke.same_state_bits(a, b) for a, b in zip(s2, s0))
    assert (m2.batches, m2.device_updates) == (m0.batches, m0.device_updates) == (10, 10)


def test_feed_stall_fails_over_typed(monkeypatch):
    """A ``feed_stall`` at the feed's second batch fails the pass over to
    the host tier, in both packages, with the clean run's metrics."""
    out = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            analyzers = [J.Completeness("x"), J.Mean("x")]
            run = lambda **kw: JRunner.do_analysis_run(  # noqa: E731
                engine_data(JDataset, 40_000, 7), analyzers, batch_size=8192,
                placement="device", **kw)
            mod, mon = JRel, JMonitor()
        else:
            analyzers = [dq.Completeness("x"), dq.Mean("x")]
            run = lambda **kw: dq.AnalysisRunner.do_analysis_run(  # noqa: E731
                engine_data(dq.Dataset, 40_000, 7), analyzers, batch_size=8192,
                placement="device", device="cpu", **kw)
            mod, mon = TRel, dq.RunMonitor()
        clean = metrics(run())
        with mod.inject(mod.FaultSpec("prefetch", "feed_stall", at=2)) as inj:
            stalled = metrics(run(monitor=mon))
        assert inj.fired == ["prefetch:1:feed_stall"], pkg
        assert mon.device_failovers == 1 and mon.placement == "host"  # typed: the host tier
        for key, want in clean.items():
            assert stalled[key] == pytest.approx(want, rel=1e-9), key
        out.append(stalled)
    for key, want in out[0].items():
        assert out[1][key] == pytest.approx(want, rel=1e-12), key


def test_a_silent_feed_fails_over_at_the_feed_stall_deadline(monkeypatch):
    """A feed that goes silent (an injected 3 s stall at its second batch)
    trips ``DEEQU_TPU_FEED_STALL_S=1``: the consumer raises a typed
    ``FeedStallError`` and the pass fails over, about 1 s later, not 3."""
    monkeypatch.setenv(TP.FEED_STALL_ENV, "1")
    monkeypatch.setenv(TP.PREFETCH_DEPTH_ENV, "2")  # a feed thread to go silent
    data = engine_data(dq.Dataset, 40_000, 7)
    analyzers = [dq.Completeness("x"), dq.Mean("x")]
    clean = metrics(dq.AnalysisRunner.do_analysis_run(data, analyzers, batch_size=8192,
                                                      placement="host", device="cpu"))
    monitor = dq.RunMonitor()
    with TRel.inject(TRel.FaultSpec("prefetch", "stall", at=2, delay_s=3.0)):
        t0 = time.perf_counter()
        got = metrics(dq.AnalysisRunner.do_analysis_run(data, analyzers, batch_size=8192,
                                                        placement="device", device="cpu",
                                                        monitor=monitor))
        seconds = time.perf_counter() - t0
    assert (monitor.device_failovers, monitor.placement) == (1, "host")
    assert monitor.degraded == ["tier:device->device"]
    assert seconds < 2.8
    assert got == clean
    for thread in threading.enumerate():  # the wedged feed wakes and ends
        if thread.name == "deequ-ingest-prefetch":
            thread.join(10)
