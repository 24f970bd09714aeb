"""K2's battery entry, ``hll_registers_columns``, against the JAX reference.

The port folds every HLL column of a battery into its states with one
launch a batch (``BundledScanProgram`` over ``ApproxCountDistinct
.update_columns``), as the reference's one jitted fused update holds every
HLL update (deequ_tpu/runners/engine.py:366). On the CPU the entry runs
its plain version. The same batches (made with numpy from a seed, one
pyarrow table for both packages) go through the reference's
``ApproxCountDistinct.update`` one column at a time and through the
port's battery entry for all columns at once, with nonzero previous
registers; then whole batteries go through both packages' runners.
Tolerance: registers and metrics bit-exact.

The kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import jax  # noqa: F401 - the reference package runs on JAX's CPU backend
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import deequ_tpu.analyzers as J
import deequ_tpu.data as JD
import deequ_tpu.runners.features as JF
from deequ_tpu.analyzers.state_provider import InMemoryStateProvider as JInMemoryStateProvider
from deequ_tpu.runners import AnalysisRunner as JaxRunner
import deequ_tpu_torch as dq
import deequ_tpu_torch.analyzers as T
import deequ_tpu_torch.data as TD
import deequ_tpu_torch.runners.features as TF
from deequ_tpu_torch.analyzers.state_provider import InMemoryStateProvider
from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts
from deequ_tpu_torch.kernels.hll_registers import (
    HllColumn,
    hll_registers_columns,
    hll_registers_columns_plain,
    hll_registers_plain,
)
from deequ_tpu_torch.runners.engine import BundledScanProgram, to_device

CPU = torch.device("cpu")


def _table(n: int = 2000, seed: int = 11) -> pa.Table:
    """Sixteen columns of every kind the HLL feature builder hashes:
    integers, floats with NaN and infinities, nullable strings and a
    dictionary column, several of them nullable."""
    rng = np.random.default_rng(seed)
    cols = {}
    for i in range(16):
        kind = i % 4
        mask = rng.random(n) < (0.1 if i % 3 else 0.0)
        if kind == 0:
            cols[f"c{i}"] = pa.array(rng.integers(-10 ** (i % 7 + 1), 10 ** (i % 7 + 1), n),
                                     mask=mask)
        elif kind == 1:
            v = rng.normal(0, 10 ** (i % 5), n)
            v[rng.random(n) < 0.02] = np.nan
            v[rng.random(n) < 0.01] = np.inf
            cols[f"c{i}"] = pa.array(v, mask=mask)
        elif kind == 2:
            cols[f"c{i}"] = pa.array([None if m else f"s{int(x)}" for m, x in zip(
                mask, rng.integers(0, 50 * (i + 1), n))])
        else:
            cols[f"c{i}"] = pa.DictionaryArray.from_arrays(
                pa.array(rng.integers(0, 40 + i, n).astype(np.int32), mask=mask),
                pa.array([f"k{j}" for j in range(40 + i)]))
    cols["w"] = pa.array(rng.normal(size=n))
    return pa.table(cols)


def _analyzers(m, ncols: int) -> list:
    """``ncols`` ApproxCountDistinct analyzers of package ``m``, every third
    with a where-filter."""
    return [m.ApproxCountDistinct(f"c{i}", "w > -0.5" if i % 3 == 1 else None)
            for i in range(ncols)]


def _features(builder_module, analyzers, batch):
    specs = [s for a in analyzers for s in a.feature_specs()]
    return builder_module.FeatureBuilder(specs).build(batch)


@pytest.mark.parametrize("ncols", [1, 2, 16])
def test_battery_entry_plain_matches_the_reference_column_by_column(ncols):
    """Three batches: the port folds each into all columns at once with the
    battery entry (previous registers nonzero from the second batch on),
    the reference folds each column with its own ``update``."""
    table = _table()
    ja, ta = _analyzers(J, ncols), _analyzers(T, ncols)
    jb = list(JD.Dataset.from_arrow(table).batches(700))
    tb = list(TD.Dataset.from_arrow(table).batches(700))
    assert len(jb) == len(tb) == 3
    js = [a.init_state() for a in ja]
    regs = [None] * ncols
    for b, (jbatch, tbatch) in enumerate(zip(jb, tb)):
        jf = {k: jnp.asarray(v) for k, v in _features(JF, ja, jbatch).items()}
        js = [a.update(s, jf) for a, s in zip(ja, js)]
        tf = to_device(_features(TF, ta, tbatch), CPU)
        columns = [HllColumn(tf[f"hll:{a.column}"], tf[f"mask:{a.column}"],
                             None if a._where_key() is None else tf[a._where_key()], prev)
                   for a, prev in zip(ta, regs)]
        if b:
            assert all(c.prev is not None and int(c.prev.max()) > 0 for c in columns)
        out = hll_registers_columns(columns, tf["rows"])
        assert out.shape == (ncols, 512) and out.dtype == torch.int32
        regs = [out[c] for c in range(ncols)]
        for c in range(ncols):
            want = np.asarray(jax.tree_util.tree_leaves(js[c])[0])
            assert np.array_equal(regs[c].numpy(), want), (b, c)


def test_battery_entry_without_previous_registers_is_the_one_column_entry():
    rng = np.random.default_rng(5)
    n = 3001
    rows = torch.from_numpy(rng.random(n) < 0.9)
    columns = [HllColumn(torch.from_numpy(rng.integers(0, 1 << 15, n).astype(np.uint16)),
                         torch.from_numpy(rng.random(n) < 0.8),
                         torch.from_numpy(rng.random(n) < 0.5) if c % 2 else None)
               for c in range(3)]
    out = hll_registers_columns(columns, rows)
    for c, col in enumerate(columns):
        assert torch.equal(out[c], hll_registers_plain(col.keys, rows, col.where, col.present))
    assert torch.equal(out, hll_registers_columns_plain(columns, rows))


def test_battery_entry_rejects_malformed_columns():
    n = 10
    rows = torch.ones(n, dtype=torch.bool)
    keys = torch.zeros(n, dtype=torch.uint16)
    present = torch.ones(n, dtype=torch.bool)
    with pytest.raises(ValueError):
        hll_registers_columns([], rows)
    with pytest.raises(TypeError):
        hll_registers_columns([HllColumn(keys.to(torch.int32), present)], rows)
    with pytest.raises(ValueError):
        hll_registers_columns([HllColumn(keys[:9], present)], rows)
    with pytest.raises(ValueError):
        hll_registers_columns([HllColumn(keys, present, prev=torch.zeros(511, dtype=torch.int32))],
                              rows)
    with pytest.raises(TypeError):
        hll_registers_columns([HllColumn(keys, present, prev=torch.zeros(512))], rows)
    with pytest.raises(ValueError):
        hll_registers_columns([HllColumn(keys, present)], rows[None])


def test_the_program_folds_a_battery_with_one_launch_a_batch_and_leaves_inputs_alone():
    """``BundledScanProgram`` routes its HLL analyzers through one battery
    call a batch (counted on the card, a plain call here), and the states
    it returns are new tensors: the previous registers stay as they were."""
    table = _table()
    analyzers = _analyzers(T, 5) + [T.Size()]
    program = BundledScanProgram(analyzers)
    assert program.hll_of == [0, 1, 2, 3, 4]
    batch = next(TD.Dataset.from_arrow(table).batches(1000))
    features = to_device(_features(TF, analyzers, batch), CPU)
    states = program(program.init_states(CPU), features)
    before = [s.registers.clone() for s in states[:5]]
    again = program(states, features)
    for s, b, a in zip(states[:5], before, again[:5]):
        assert torch.equal(s.registers, b)
        assert torch.equal(a.registers, b)  # the same batch again: max is idempotent
    reset_launch_counts()
    program(states, features)
    assert launch_counts()["hll_registers_columns"] == 0  # the CPU runs the plain version


@pytest.mark.parametrize("ncols", [2, 16])
@pytest.mark.parametrize("batches", [1, 3, 7])
def test_a_battery_through_the_runner_matches_the_reference(ncols, batches):
    """A battery of ``ncols`` HLL analyzers with a Size and a Mean, through
    both packages' runners at the same batch size: the HLL and Size metrics
    and every state's registers bit-exact, the Mean within 1e-12 of max |w|
    (its adds reordered)."""
    n = 2000
    table = _table(n, seed=ncols + batches)
    batch = -(-n // batches)
    ja = _analyzers(J, ncols) + [J.Size(), J.Mean("w")]
    ta = _analyzers(T, ncols) + [T.Size(), T.Mean("w")]
    jsp, tsp = JInMemoryStateProvider(), InMemoryStateProvider()
    jctx = JaxRunner.do_analysis_run(JD.Dataset.from_arrow(table), ja, save_states_with=jsp,
                                     batch_size=batch, placement="device")
    monitor = dq.RunMonitor()
    tctx = dq.AnalysisRunner.do_analysis_run(TD.Dataset.from_arrow(table), ta,
                                             save_states_with=tsp, batch_size=batch,
                                             device="cpu", monitor=monitor)
    assert monitor.batches == batches
    for a, b in zip(ja[:-1], ta[:-1]):
        assert repr(jctx.metric(a).value.get()) == repr(tctx.metric(b).value.get()), a
    scale = float(np.abs(table["w"].to_numpy()).max())
    assert abs(jctx.metric(ja[-1]).value.get() - tctx.metric(ta[-1]).value.get()) <= 1e-12 * scale
    for a, b in zip(ja[:ncols], ta[:ncols]):
        want = np.asarray(jax.tree_util.tree_leaves(jsp.load(a))[0])
        assert np.array_equal(tsp.load(b).registers.numpy(), want), a
