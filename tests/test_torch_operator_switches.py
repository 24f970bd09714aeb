"""The operator switches of the PyTorch/CUDA port against the JAX
reference, each under the same environment in both packages:

- ``DEEQU_TPU_HOST_TIER_WORKERS`` sizes the host tier's pool; the states
  are the same bit for bit at every size (partials fold in submission
  order), and equal to the reference's at the same size (host tier, same
  batch size: KLL samples and HLL registers bit for bit, moments within
  1e-12 relative).
- ``DEEQU_TPU_NO_NATIVE=1`` (read when the native module is imported, so
  each package runs in a subprocess) sends every host kernel to its numpy
  version; the metrics equal the library's and the reference's fallbacks'.
- ``DEEQU_TPU_ADAPTIVE_DICT_ENCODE=0`` leaves low-cardinality string
  columns plain in both packages, with unchanged metrics.
- ``DEEQU_TPU_PROFILE_DIR`` writes one ``torch.profiler`` trace a pass
  (the reference writes a ``jax.profiler`` trace there).
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import deequ_tpu.analyzers as J
import deequ_tpu.runners.engine as JEng
from deequ_tpu.data import Dataset as JDataset
from deequ_tpu.runners import AnalysisRunner as JRunner
import deequ_tpu_torch as dq
import deequ_tpu_torch.analyzers as T
import deequ_tpu_torch.runners.engine as TEng

REPO = Path(__file__).resolve().parent.parent

REF = SimpleNamespace(name="jax", A=J, Dataset=JDataset, Runner=JRunner, kw={})
PORT = SimpleNamespace(name="torch", A=T, Dataset=dq.Dataset, Runner=dq.AnalysisRunner,
                       kw={"device": "cpu"})

MOMENTS = ("Mean", "Sum", "StandardDeviation")


def table(m, rows: int = 40_000, seed: int = 11):
    rng = np.random.default_rng(seed)
    x = rng.normal(5.0, 2.0, rows)
    null = rng.random(rows) < 0.1
    return m.Dataset.from_dict({
        "x": [None if n else float(v) for n, v in zip(null, x)],
        "n": rng.integers(-50, 1000, rows),
        "s": [f"v{v}" for v in rng.integers(0, 40, rows)],
    })


def host_battery(m):
    A = m.A
    return [A.Size(), A.Completeness("x"), A.Mean("x"), A.Sum("n"), A.Minimum("x"),
            A.Maximum("n"), A.StandardDeviation("x"), A.ApproxCountDistinct("n"),
            A.ApproxCountDistinct("s"), A.KLLSketch("x")]


def values(ctx) -> dict:
    out = {}
    for a, metric in ctx.metric_map.items():
        v = metric.value.get()
        out[repr(a)] = repr(v.buckets) if hasattr(v, "buckets") else v
    return out


def assert_close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key, w in want.items():
        if key.split("(")[0].split(":")[-1] in MOMENTS:
            assert got[key] == pytest.approx(w, rel=1e-12), key
        else:
            assert got[key] == w, key


# ---------------------------------------------------------------------------
# DEEQU_TPU_HOST_TIER_WORKERS
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("workers", ["1", "2", "7"])
def test_host_tier_states_are_the_same_at_every_pool_size(monkeypatch, workers):
    monkeypatch.delenv(TEng.HOST_TIER_WORKERS_ENV, raising=False)
    run = lambda m: values(m.Runner.do_analysis_run(  # noqa: E731
        table(m), host_battery(m), placement="host", batch_size=1024, **m.kw))
    default = run(PORT)
    monkeypatch.setenv(TEng.HOST_TIER_WORKERS_ENV, workers)
    assert TEng.host_tier_workers() == int(workers)
    sized = run(PORT)
    assert sized == default
    assert_close(sized, run(REF))


def test_the_pool_takes_the_knobs_size(monkeypatch):
    sizes = []
    real = TEng.ThreadPoolExecutor

    class Recording(real):
        def __init__(self, max_workers=None, **kw):
            sizes.append(max_workers)
            super().__init__(max_workers=max_workers, **kw)

    monkeypatch.setattr(TEng, "ThreadPoolExecutor", Recording)
    monkeypatch.setenv(TEng.HOST_TIER_WORKERS_ENV, "3")
    dq.AnalysisRunner.do_analysis_run(table(PORT, rows=5000), [T.Mean("x")], placement="host",
                                      batch_size=1024, device="cpu")
    assert sizes == [3]


@pytest.mark.parametrize("raw", [None, "0", "-2", "many"])
def test_zero_unset_or_bad_worker_counts_keep_every_core(monkeypatch, caplog, raw):
    if raw is None:
        monkeypatch.delenv(TEng.HOST_TIER_WORKERS_ENV, raising=False)
    else:
        monkeypatch.setenv(TEng.HOST_TIER_WORKERS_ENV, raw)
    from deequ_tpu_torch import utils

    utils._ENV_WARNED.discard(TEng.HOST_TIER_WORKERS_ENV)
    with caplog.at_level(logging.WARNING):
        assert TEng.host_tier_workers() == (os.cpu_count() or 1)
    warned = any(TEng.HOST_TIER_WORKERS_ENV in r.getMessage() for r in caplog.records)
    assert warned == (raw in ("-2", "many"))
    assert TEng.HOST_TIER_WORKERS_ENV == JEng.HOST_TIER_WORKERS_ENV


# ---------------------------------------------------------------------------
# DEEQU_TPU_NO_NATIVE, in subprocesses (read at import)
# ---------------------------------------------------------------------------

_SWITCH_RUN = r"""
import json, os, sys
import numpy as np
root = sys.argv[1]
if root == "deequ_tpu":
    import jax
    jax.config.update("jax_platforms", "cpu")
import importlib
pkg = importlib.import_module(root)
A = importlib.import_module(root + ".analyzers")
from importlib import import_module
Dataset = import_module(root + ".data").Dataset
Runner = import_module(root + ".runners").AnalysisRunner
rng = np.random.default_rng(3)
rows = 3000
names = [f"user{v}@mail.com" if v % 3 else f"id-{v}" for v in rng.integers(0, 500, rows)]
data = Dataset.from_dict({
    "x": rng.normal(0.0, 1.0, rows),
    "n": rng.integers(0, 90, rows),
    "name": names,
    "flag": [("yes", "no", None)[v] for v in rng.integers(0, 3, rows)],
})
battery = [A.Size(), A.Mean("x"), A.StandardDeviation("x"), A.ApproxCountDistinct("n"),
           A.ApproxCountDistinct("name"), A.ApproxCountDistinct("x"), A.DataType("name"),
           A.MaxLength("name"), A.MinLength("flag"), A.Completeness("flag"),
           A.PatternMatch("name", r"@mail\.com$"), A.KLLSketch("x")]
kw = {"device": "cpu"} if root == "deequ_tpu_torch" else {}
out = {}
for placement in ("device", "host"):
    ctx = Runner.do_analysis_run(data, battery, placement=placement, batch_size=1024, **kw)
    for a, metric in ctx.metric_map.items():
        v = metric.value.get()
        if hasattr(v, "buckets"):
            v = repr(v.buckets)
        elif hasattr(v, "values") and not isinstance(v, (int, float)):
            v = repr(sorted((k, e.absolute) for k, e in v.values.items()))
        out[placement + ":" + repr(a)] = v
if root == "deequ_tpu_torch":
    import deequ_tpu_torch.native as N
    out["__plain__"] = N.native_xxhash64_strings.__name__.endswith("_plain")
    try:
        N.load()
        out["__load__"] = "loaded"
    except ImportError as exc:
        out["__load__"] = str(exc)
print(json.dumps(out))
"""


def switch_run(root: str, **env) -> dict:
    full = dict(os.environ, JAX_PLATFORMS="cpu", DEEQU_TPU_PLACEMENT="device",
                DEEQU_TPU_AUTOTUNE="0", PYTHONPATH=str(REPO))
    for key in ("DEEQU_TPU_NO_NATIVE", "DEEQU_TPU_ADAPTIVE_DICT_ENCODE"):
        full.pop(key, None)
    full.update(env)
    proc = subprocess.run([sys.executable, "-c", _SWITCH_RUN, root], env=full, cwd=str(REPO),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def split(result: dict):
    flags = {k: result.pop(k) for k in list(result) if k.startswith("__")}
    return result, flags


def test_no_native_runs_the_plain_versions_with_the_same_metrics():
    native, native_flags = split(switch_run("deequ_tpu_torch"))
    plain, plain_flags = split(switch_run("deequ_tpu_torch", DEEQU_TPU_NO_NATIVE="1"))
    reference, _ = split(switch_run("deequ_tpu", DEEQU_TPU_NO_NATIVE="1"))
    assert native_flags == {"__plain__": False, "__load__": "loaded"}
    assert plain_flags["__plain__"] is True
    assert "DEEQU_TPU_NO_NATIVE" in plain_flags["__load__"]
    assert plain == native
    assert_close(plain, reference)


def test_adaptive_dictionary_encoding_can_be_turned_off(monkeypatch):
    for m in (REF, PORT):
        monkeypatch.delenv("DEEQU_TPU_ADAPTIVE_DICT_ENCODE", raising=False)
        on = table(m)
        monkeypatch.setenv("DEEQU_TPU_ADAPTIVE_DICT_ENCODE", "0")
        off = table(m)
        assert on.dictionary_size("s") == 40, m.name
        assert off.dictionary_size("s") is None, m.name
    encoded, _ = split(switch_run("deequ_tpu_torch"))
    plain, _ = split(switch_run("deequ_tpu_torch", DEEQU_TPU_ADAPTIVE_DICT_ENCODE="0"))
    reference, _ = split(switch_run("deequ_tpu", DEEQU_TPU_ADAPTIVE_DICT_ENCODE="0"))
    assert plain == encoded
    assert_close(plain, reference)


# ---------------------------------------------------------------------------
# DEEQU_TPU_PROFILE_DIR
# ---------------------------------------------------------------------------


def test_a_profile_dir_receives_one_trace_a_pass(monkeypatch, tmp_path):
    monkeypatch.setenv(TEng.PROFILE_DIR_ENV, str(tmp_path))
    assert TEng.PROFILE_DIR_ENV == JEng.PROFILE_DIR_ENV
    data = table(PORT, rows=5000)
    want = values(dq.AnalysisRunner.do_analysis_run(data, host_battery(PORT), batch_size=1024,
                                                    device="cpu"))
    dq.AnalysisRunner.do_analysis_run(data, host_battery(PORT), placement="host",
                                      batch_size=1024, device="cpu")
    traces = sorted(tmp_path.glob("deequ-pass-*.json"))
    assert len(traces) == 2
    for path in traces:
        events = json.loads(path.read_text())["traceEvents"]
        assert events
    monkeypatch.delenv(TEng.PROFILE_DIR_ENV)
    assert values(dq.AnalysisRunner.do_analysis_run(
        data, host_battery(PORT), batch_size=1024, device="cpu")) == want
    assert len(sorted(tmp_path.glob("deequ-pass-*.json"))) == 2


def test_a_pass_started_while_another_is_traced_runs_untraced(monkeypatch, tmp_path):
    monkeypatch.setenv(TEng.PROFILE_DIR_ENV, str(tmp_path))
    with TEng.pass_profiler(TEng.torch.device("cpu")):
        with TEng.pass_profiler(TEng.torch.device("cpu")):
            pass
    assert len(list(tmp_path.glob("deequ-pass-*.json"))) == 1
