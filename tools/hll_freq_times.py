#!/usr/bin/env python3
"""Time K2 ``hll_registers`` and K6 ``freq_keys`` on one CUDA GPU, at the
shapes the port's paths launch them, for comparing two trees of the port
on one card.

    python3 tools/hll_freq_times.py [--root DIR] [--label NAME]

The package is imported from ``DIR`` (default: this checkout), the inputs
and the timer from this checkout's ``chip_smoke.py``; so a second tree
unpacked beside this one (``git archive <commit> | tar -x -C
archive-check/parent``) is timed by the same script on the same inputs.
Run the two in turns in one call (parent, change, change, parent) and
compare within it. The inputs:

- K2's batch entry on one batch of 2^20 rows: config 2's first HLL column
  (``build_table`` seed 0), without and with a where-filter (a seeded
  mask);
- the HLL updates of config 3's profile battery on one 2^20-row lineitem
  batch (seed 19; its 16 ``ApproxCountDistinct`` analyzers, each state
  already holding a batch): a ``BundledScanProgram`` of those analyzers
  alone, called as the engine calls it, so the tree's own route is timed
  (one launch and its zero fill and ``torch.maximum`` per analyzer, or one
  launch for all);
- K2's stacked entry over phase 8's HLL column, 16 sessions x 4,096 and
  16 x 65,536 rows (``build_stream_table`` seed 7);
- K6 on the grouping workload's first batch (one int64 key), on the edge
  batch's first 1, 2 and 5 key columns (``chip_smoke.freq_edge_columns``)
  and on lineitem's ``(l_orderkey, l_linenumber)``, each at 2^20 rows.

Beside each K2 shape, one ``scatter_reduce`` amax computing the same
registers (the battery's into the previous registers). No PyTorch call
computes K6's keys.

Prints one JSON line with the card (``nvidia-smi``'s name and power
limit) and, per shape, the median CUDA-event ms and host ms of a call
(``chip_smoke._time_ms``: L2 flushed, a spin kernel queued ahead), the
bound (inputs read once, outputs written once at 3.35 TB/s, or the
operations at 67 TFLOP/s where larger) and the PyTorch call's ms.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
STACKED_ROWS = (4096, 65536)
REGISTERS = 512


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _nbytes(tensors) -> int:
    """Bytes of the distinct arrays among ``tensors`` (by data pointer)."""
    arrays = {t.data_ptr(): t for t in tensors if t is not None}
    return sum(t.numel() * t.element_size() for t in arrays.values())


def k2_cases(torch, dq, cs) -> dict:
    """label -> (call, bytes, ops, library call): K2's launches at the
    paths' shapes, each a zero-argument call of the tree's wrapper."""
    from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer
    from deequ_tpu_torch.analyzers.sketches import ApproxCountDistinct
    from deequ_tpu_torch.kernels.hll_registers import hll_registers, hll_registers_stacked
    from deequ_tpu_torch.profiles import first_pass_analyzers
    from deequ_tpu_torch.runners.analysis_runner import collect_required_analyzers
    from deequ_tpu_torch.runners.engine import (
        BundledScanProgram, ScanEngine, _stack_to_device, to_device)

    device = torch.device("cuda")
    cases = {}

    def features_of(battery, table):
        engine = ScanEngine(battery, device)
        batch = next(dq.Dataset.from_arrow(table).batches(cs.BATCH_ROWS))
        return to_device(engine.builder.build(batch), device)

    table = cs.build_table(cs.BATCH_ROWS, 0)
    analyzers = collect_required_analyzers([cs.build_check(dq, table.num_rows)])
    battery = [a for a in dict.fromkeys(analyzers) if isinstance(a, ScanShareableAnalyzer)]
    hll = [a for a in battery if isinstance(a, ApproxCountDistinct)][0]
    features = features_of([hll], table)
    keys, rows = features[f"hll:{hll.column}"], features["rows"]
    present = features[f"mask:{hll.column}"]
    rng = np.random.default_rng(3)
    where = torch.from_numpy(rng.random(keys.shape[0]) < 0.6).to(device)
    n = keys.shape[0]
    for label, w in (("", None), (", where", where)):
        args = (keys, rows, w, present)
        valid = rows & present if w is None else rows & present & w
        cases[f"hll_registers 1M rows{label}"] = (
            lambda args=args: hll_registers(*args), _nbytes(args) + REGISTERS * 4, 2 * n,
            cs._registers_amax(torch, keys[None], valid[None]))

    lineitem = cs.build_lineitem(cs.BATCH_ROWS, cs.LINEITEM_SEED, cs.COMMENT_POOL // 10)
    probe = dq.Dataset.from_arrow(lineitem)
    hlls = [a for a in first_pass_analyzers(probe, probe.schema.names, {})
            if isinstance(a, ApproxCountDistinct)]
    features = features_of(hlls, lineitem)
    program = BundledScanProgram(hlls)
    states = program(program.init_states(device), features)
    torch.cuda.synchronize()
    rows = features["rows"]
    keys = torch.stack([features[f"hll:{a.column}"] for a in hlls])
    valid = torch.stack([rows & features[f"mask:{a.column}"] for a in hlls])
    prev = torch.stack([s.registers for s in states])
    arrays = [rows] + [features[k] for a in hlls for k in (f"hll:{a.column}", f"mask:{a.column}")]
    cases[f"hll_registers battery {len(hlls)} columns 1M rows"] = (
        lambda: program(states, features), _nbytes(arrays) + 2 * len(hlls) * REGISTERS * 4,
        2 * len(hlls) * n, cs._registers_amax(torch, keys, valid, prev))

    width = cs.STREAM_WIDTH
    for n in STACKED_ROWS:
        stream = cs.build_stream_table(width, cs.STREAM_BATCHES, n, cs.STREAM_SEED)
        prog, feats = cs._session_features(dq, stream, width, n)
        stacked = {key: _stack_to_device([f[key] for f in feats], device)
                   for key in prog.feature_keys}
        a = [a for a in prog.analyzers if isinstance(a, ApproxCountDistinct)][0]
        key = a._where_key()
        args = (stacked[f"hll:{a.column}"], stacked["rows"],
                None if key is None else stacked[key], stacked[f"mask:{a.column}"])
        valid = args[1] & args[3] if args[2] is None else args[1] & args[2] & args[3]
        cases[f"hll_registers_stacked {width} x {n}"] = (
            lambda args=args: hll_registers_stacked(*args),
            _nbytes(args) + width * REGISTERS * 4, 2 * width * n,
            cs._registers_amax(torch, args[0], valid))
    torch.cuda.synchronize()
    return cases


def k6_cases(torch, dq, cs) -> dict:
    """label -> (columns, rows): K6's launches at the paths' shapes."""
    cases = {}
    scan, features = cs._table_features(torch, dq, cs.build_grouping(cs.BATCH_ROWS), ("k",))
    cases["freq_keys grouping batch, 1 column"] = (scan.key_columns(features), features["rows"])
    edge, rows = cs.freq_edge_columns(torch, cs.BATCH_ROWS)
    for width in (1, 2, 5):
        cases[f"freq_keys edge batch, {width} columns"] = (edge[:width], rows)
    lineitem = cs.build_lineitem(cs.BATCH_ROWS, cs.LINEITEM_SEED, cs.COMMENT_POOL // 10)
    cols = ("l_orderkey", "l_linenumber")
    scan, features = cs._table_features(torch, dq, lineitem, cols)
    cases["freq_keys lineitem (l_orderkey, l_linenumber)"] = (
        scan.key_columns(features), features["rows"])
    torch.cuda.synchronize()
    return cases


def k6_cost(columns, rows) -> tuple:
    """Bytes and integer operations of a K6 launch, as chip_smoke counts
    them: the row mask, each column's mask and values read, the keys and
    counters written; SplitMix64 or a load a column and an xxhash64 a
    chained column."""
    n = rows.shape[0]
    nbytes = n + sum(n + c.values.numel() * c.values.element_size() for c in columns) \
        + 8 * n + 16
    return nbytes, n * (10 * len(columns) + 16 * (len(columns) - 1))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(HERE))
    parser.add_argument("--label", default="")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("hll_freq_times: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    cs = chip_smoke()
    import deequ_tpu_torch as dq
    from deequ_tpu_torch.kernels.freq_keys import freq_keys

    assert Path(dq.__file__).resolve().is_relative_to(Path(args.root).resolve())
    times = {}
    for label, (fn, nbytes, ops, library) in k2_cases(torch, dq, cs).items():
        t = cs._time_kernel_ms(torch, fn)
        bound, by = cs._bound_ms(nbytes, ops)
        times[label] = {"ms": t["ms"], "host_ms": t["host_ms"], "bound_ms": bound,
                        "bound_by": by, "library_ms": cs._time_ms(torch, library)["ms"]}
    for label, (columns, rows) in k6_cases(torch, dq, cs).items():
        out = torch.empty(rows.shape[0], dtype=torch.int64, device="cuda")
        t = cs._time_kernel_ms(torch, lambda: freq_keys(columns, rows, out, 0))
        bound, by = cs._bound_ms(*k6_cost(columns, rows))
        times[label] = {"ms": t["ms"], "host_ms": t["host_ms"], "bound_ms": bound,
                        "bound_by": by, "library_ms": None}
    print(json.dumps({"label": args.label, "root": args.root, "card": cs._nvidia_smi(),
                      "kind": torch.cuda.get_device_name(0), "times": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
