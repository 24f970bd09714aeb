"""The reference's 32-bit accumulator mode (``DEEQU_TPU_NO_X64=1``) in the
PyTorch/CUDA port, held against the reference.

The switch is read when each package is imported and holds for the
process, so every 32-bit run happens in a subprocess (as the reference's
``tests/test_no_x64.py`` does): one runs the reference (JAX on the CPU),
one the port (``device="cpu"``, the kernels' plain versions), from the same
seeded numpy data, and each prints one JSON object of results; then one
process of each package loads the 32-bit state blobs the other wrote.
The test process itself is 64-bit: it writes 64-bit state blobs with both
packages for the 32-bit processes to load, and loads theirs.

Cases: the reference's own battery (20,000 rows, ``batch_size=4096``);
BASELINE configs 1 (BasicExample) and 2 (Completeness, Mean, StdDev,
Histogram) on the device tier and config 2 on the host tier; the mesh
(the host tier with a KLL sketch on 8 and 3 shards, the device tier on 8;
the reference's process gets 8 CPU devices as ``tests/conftest.py``
gives this one); the route of
grouping sets (no device frequency table in this mode); persisted states
crossing the packages and the modes both ways; one coalesced fold of two
sessions through ``VerificationService``.

Tolerances. Counts, min, max, HLL registers and estimates, KLL sketches
(at equal batch boundaries), dictionary counts and every state's leaf
dtypes are bit for bit. Float32 sums and moments add in different orders
in the two packages: measured on the CPU, the largest relative
difference between them is 9.0e-8 on these inputs (config 2's
StandardDeviation over 20,000 values), and they are held to ``F32_RTOL`` =
1e-6 of each other, and to the reference's own bound, 1e-4, against a
float64 numpy oracle. Without the switch nothing changes
(``ACC_DTYPE`` float64 and ``COUNT_DTYPE`` int64 in this process).

Kernel-level cases that need the card (each float32 entry against its
plain version) are in ``tests/test_torch_cuda.py`` (marker ``cuda``).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import deequ_tpu.analyzers as J
import deequ_tpu.analyzers.base as JB
import deequ_tpu.analyzers.state_provider as JSP
import deequ_tpu_torch as dq
import deequ_tpu_torch.analyzers.state_provider as TSP
from deequ_tpu.data import Dataset as JDataset
from deequ_tpu.runners import AnalysisRunner as JRunner
from deequ_tpu_torch import config
from deequ_tpu_torch.analyzers.base import merge_states_batched
from deequ_tpu_torch.analyzers.states import leaves
from tests.torch_no_x64_cases import PROGRAM, persisted

REPO = Path(__file__).resolve().parent.parent
#: float32 sums and moments, port against reference (measured < 1e-7)
F32_RTOL = 1e-6
#: the reference's bound of a float32 run against a float64 oracle
ORACLE_RTOL = 1e-4
MOMENTS = ("Mean", "Sum", "StandardDeviation", "Correlation")
TIMEOUT_S = 900

# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------

def _run(pkg: str, store: Path, stage: str) -> dict:
    env = dict(os.environ)
    env.pop("DEEQU_TPU_PLACEMENT", None)
    env["DEEQU_TPU_AUTOTUNE"] = "0"
    # one thread a process: the suite's other workers run beside these
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags += " --xla_force_host_platform_device_count=8"  # the reference's mesh
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               XLA_FLAGS=flags + " --xla_cpu_multi_thread_eigen=false"
                                 " intra_op_parallelism_threads=1")
    env["DEEQU_TPU_TUNING_PROFILE_DIR"] = str(store / f"tuning-{pkg}-{stage}")
    proc = subprocess.run([sys.executable, "-c", PROGRAM, pkg, str(store), stage],
                          capture_output=True, text=True, env=env, cwd=str(REPO),
                          timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 64-bit blobs of both packages (written here), then the
    reference's and the port's 32-bit runs, then the port's load of the
    reference's 32-bit blobs."""
    store = tmp_path_factory.mktemp("no_x64")
    table_data = persisted(JDataset, J)
    JRunner.do_analysis_run(table_data[0], table_data[1], batch_size=4096, placement="device",
                            save_states_with=JSP.FileSystemStateProvider(str(store / "ref64")))
    pdata, pan = persisted(dq.Dataset, dq)
    dq.AnalysisRunner.do_analysis_run(pdata, pan, batch_size=4096, device="cpu",
                                      placement="device",
                                      save_states_with=TSP.FileSystemStateProvider(
                                          str(store / "port64")))
    out = {"ref": _run("ref", store, "main"), "port": _run("port", store, "main")}
    out["ref_load"] = _run("ref", store, "load")
    out["port_load"] = _run("port", store, "load")
    out["store"] = store
    return out


def _ref_dtypes(state) -> list:
    return [np.asarray(leaf).dtype.name for leaf in jax.tree_util.tree_leaves(state)]


def _port_dtypes(state) -> list:
    return [str(t.dtype).replace("torch.", "") for t in leaves(state)]


def _buckets(dist) -> list:
    return [(b.low_value, b.high_value, b.count) for b in dist.buckets]


def _close(name: str, got, want, rtol: float = F32_RTOL) -> bool:
    if isinstance(want, float) and math.isnan(want):
        return isinstance(got, float) and math.isnan(got)
    if name in MOMENTS and isinstance(want, float):
        return abs(got - want) <= rtol * max(1.0, abs(want))
    return got == want


def _assert_metrics(got: dict, want: dict, rtol: float = F32_RTOL) -> None:
    assert set(got) == set(want)
    for key, w in want.items():
        name = key.split("(")[0]
        assert _close(name, got[key], w, rtol), (key, got[key], w)


def test_the_switch_sets_both_dtypes(runs):
    assert runs["ref"]["mode"] == ["float32", "int32"]
    assert runs["port"]["mode"] == ["float32", "int32"]


def test_default_mode_is_unchanged():
    assert "DEEQU_TPU_NO_X64" not in os.environ
    assert config.ACC_DTYPE == torch.float64 and config.COUNT_DTYPE == torch.int64
    assert config.x64_enabled()


def test_the_public_config_documents_the_switch():
    assert config.NO_X64_ENV == "DEEQU_TPU_NO_X64"
    assert "DEEQU_TPU_NO_X64" in (config.__doc__ or "")


@pytest.mark.parametrize("case", ["battery", "config2_device", "config2_host", "mesh_host_8",
                                  "mesh_host_3", "mesh_device_8"])
def test_metrics_and_state_dtypes_match_the_reference(runs, case):
    """Counts, min, max, HLL and (on the host tier, sharded or not) KLL
    sketches bit for bit, float32 moments within ``F32_RTOL``; every state
    leaf of the reference's dtype, none 64-bit."""
    ref, port = runs["ref"][case], runs["port"][case]
    _assert_metrics(port["metrics"], ref["metrics"])
    assert port["dtypes"] == ref["dtypes"]
    for dtypes in port["dtypes"].values():
        assert not {"float64", "int64"} & set(dtypes), dtypes
    if case.startswith("config2"):
        assert port["placement"] == ref["placement"] == case.split("_")[1]


def test_battery_holds_the_references_own_bounds(runs):
    """The reference's test: exact counts, float32 moments within 1e-4 of
    float64, an HLL estimate in its envelope, and a float32-representable
    minimum (the mode really took effect)."""
    rng = np.random.default_rng(11)
    x = rng.normal(50.0, 4.0, 20_000)
    oracle = {"Mean": x.mean(), "Sum": x.sum(), "StandardDeviation": x.std()}
    for pkg in ("ref", "port"):
        got = {k.split("(")[0]: v for k, v in runs[pkg]["battery"]["metrics"].items()}
        assert got["Size"] == 20_000.0 and got["Completeness"] == 1.0
        for name, want in oracle.items():
            assert abs(got[name] - want) <= ORACLE_RTOL * max(1.0, abs(want)), (pkg, name)
        assert abs(got["ApproxCountDistinct"] - 500) <= 0.2 * 500
        assert got["Minimum"] == float(np.float32(got["Minimum"]))
        assert got["Maximum"] == float(np.float32(got["Maximum"]))


def test_config1_basic_example_matches_the_reference(runs):
    ref, port = runs["ref"]["config1"], runs["port"]["config1"]
    assert port["status"] == ref["status"]
    assert port["checks"] == ref["checks"]
    assert port["metrics"] == ref["metrics"]


@pytest.mark.parametrize("case", ["config1", "grouping"])
def test_grouping_sets_take_no_device_frequency_table(runs, case):
    """Without x64 no grouping set takes the device frequency table (its
    keys are uint64): the reference gates it on ``jax_enable_x64``, the
    port on ``config.x64_enabled()``. The sets' metrics agree exactly."""
    assert runs["ref"][case]["device_freq_sets"] == 0
    assert runs["port"][case]["device_freq_sets"] == 0
    assert runs["port"][case]["metrics"] == runs["ref"][case]["metrics"]


@pytest.mark.parametrize("writer", ["ref64", "port64"])
def test_64_bit_blobs_load_and_merge_in_a_32_bit_process(runs, writer):
    """A 64-bit blob keeps its float64 / int64 leaves when a 32-bit
    process loads it (its metric is the 64-bit one); a merge of two of
    them runs in float32 / int32; a merge with this process's own 32-bit
    state too."""
    ref, port = runs["ref"]["loaded64"][writer], runs["port"]["loaded64"][writer]
    assert set(port) == set(ref)
    for key, w in ref.items():
        g = port[key]
        name = key.split("(")[0]
        assert g["dtypes"] == w["dtypes"], key
        assert _close(name, g["metric"], w["metric"], 1e-12), key
        assert g["merged2_dtypes"] == w["merged2_dtypes"], key
        for what in ("merged2", "mixed"):
            if name == "KLLSketch":
                assert g[what] == w[what], (key, what)
            else:
                assert _close(name, g[what], w[what]), (key, what, g[what], w[what])


@pytest.mark.parametrize("reader", ["ref_load", "port_load"])
def test_32_bit_blobs_cross_the_packages(runs, reader):
    """Each package loads the other's 32-bit blobs in a 32-bit process:
    float32 / int32 leaves, the writer's metric, and a merge of two."""
    got = runs[reader]["loaded32"]
    other = runs["port_load" if reader == "ref_load" else "ref_load"]["loaded32"]
    assert set(got) == set(other)
    for key, g in got.items():
        assert not {"float64", "int64"} & set(g["dtypes"]), (key, g["dtypes"])
    # the same blob bytes give each package's metric: the reference's blob
    # in the port equals the port's blob in the reference up to the
    # packages' float32 summation order
    for key, g in got.items():
        name = key.split("(")[0]
        assert _close(name, g["metric"], other[key]["metric"]), key
        assert _close(name, g["merged2"], other[key]["merged2"]), key


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_32_bit_blobs_load_and_merge_in_a_64_bit_process(runs, writer):
    """In a 64-bit process a 32-bit blob keeps its float32 / int32 leaves in
    both packages; two of them merge in float32 (the same leaf dtypes);
    merged with a 64-bit state they widen to float64 / int64."""
    store = runs["store"]
    jdir = tdir = str(store / f"{writer}32")
    _, jan = persisted(JDataset, J)
    _, tan = persisted(dq.Dataset, dq)
    for ja, ta in zip(jan, tan):
        js = JSP.FileSystemStateProvider(jdir).load(ja)
        ts = TSP.FileSystemStateProvider(tdir).load(ta)
        assert _port_dtypes(ts) == _ref_dtypes(js), ta.name
        jm = JB.merge_states_batched(ja, [js, js])
        tm = merge_states_batched(ta, [ts, ts], "cpu")
        assert _port_dtypes(tm) == _ref_dtypes(jm), ta.name
        name = ta.name
        for jx, tx in ((ja.compute_metric_from(js), ta.compute_metric_from(ts)),
                       (ja.compute_metric_from(jm), ta.compute_metric_from(tm))):
            jv, tv = jx.value.get(), tx.value.get()
            if name == "KLLSketch":
                assert _buckets(tv) == _buckets(jv), name
            else:
                assert _close(name, tv, jv, 1e-12), (name, tv, jv)
        own_j = JSP.FileSystemStateProvider(str(store / "ref64")).load(ja)
        own_t = TSP.FileSystemStateProvider(str(store / "port64")).load(ta)
        jmix = JB.merge_states_batched(ja, [own_j, js])
        tmix = merge_states_batched(ta, [own_t, ts], "cpu")
        assert _port_dtypes(tmix) == _ref_dtypes(jmix), name


def test_coalesced_two_session_fold_matches_the_reference(runs):
    """Two sessions, two micro-batches each, every fold on the coalesced
    device route (``scan_reduce_stacked``, ``state_fold``) in both
    packages: counts, min, max, HLL and KLL bit for bit, moments within
    ``F32_RTOL``."""
    ref, port = runs["ref"]["stream"], runs["port"]["stream"]
    assert port["counters"] == ref["counters"] == 4
    for g, w in zip(port["metrics"], ref["metrics"]):
        _assert_metrics(g, w)
