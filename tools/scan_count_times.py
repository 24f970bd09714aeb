#!/usr/bin/env python3
"""Time K1 ``scan_reduce`` and K3 ``dict_code_counts`` on one CUDA GPU, at
the shapes the port's paths launch them, for comparing two trees of the
port on one card.

    python3 tools/scan_count_times.py [--root DIR] [--label NAME]

The package is imported from ``DIR`` (default: this checkout), the inputs
and the timer from this checkout's ``chip_smoke.py``; so a second tree
unpacked beside this one (``git archive <commit> | tar -x -C
archive-check/parent``) is timed by the same script on the same inputs.
Run the two in turns in one call (parent, change, change, parent) and
compare within it. The inputs:

- K1, one batch of 2^20 rows: config 2's 16 slots (``build_table`` seed
  0, the verification path's one bundle); lineitem's 33 slots (seed 19,
  the profile's first pass); one co-moment slot over ``build_scan_data``'s
  x0 and x1 (seed 42, phase 6 (e)'s Correlation);
- K1's stacked entry: phase 8's battery over 16 sessions x 4,096 rows and
  16 x 65,536 (``build_stream_table`` seed 7);
- K3: config 2's ``cat_large`` (50,000 codes, Zipf(1.3)) on a 2^20-row
  batch, the same K on codes spread evenly, and ``cat_small`` (1,000
  codes), each beside ``torch.bincount``.

Prints one JSON line with the card (``nvidia-smi``'s name and power
limit) and, per shape, the median CUDA-event ms and host ms of a call, the
bound (inputs read once, outputs written once at 3.35 TB/s) and the
PyTorch call's ms where there is one (none for K1).
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


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _slot_bytes(slots, rows, outputs: int) -> int:
    """Bytes a launch must move: each distinct input array read once, the
    outputs (``outputs`` int64/float64 words a slot) written once."""
    arrays = {t.data_ptr(): t for slot in slots
              for t in (slot.where, slot.sel, slot.vals, slot.vals2, slot.sel2) if t is not None}
    arrays[rows.data_ptr()] = rows
    width = rows.shape[0] if rows.dim() == 2 else 1
    return sum(t.numel() * t.element_size() for t in arrays.values()) \
        + width * len(slots) * outputs * 8


def k1_cases(torch, dq, cs) -> dict:
    """label -> (entry, slots, rows): K1's launches at the paths' shapes;
    entry is ``"one"`` (``scan_reduce``) or ``"stacked"``."""
    from deequ_tpu_torch.analyzers import Histogram
    from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer, resolve_slot
    from deequ_tpu_torch.analyzers.grouping import DeviceFrequencyScan
    from deequ_tpu_torch.profiles import first_pass_analyzers
    from deequ_tpu_torch.runners.analysis_runner import collect_required_analyzers
    from deequ_tpu_torch.runners.engine import ScanEngine, _stack_to_device, to_device

    device = torch.device("cuda")
    cases = {}

    def bundles(battery, table):
        data = dq.Dataset.from_arrow(table)
        engine = ScanEngine(battery, device)
        features = to_device(engine.builder.build(next(data.batches(cs.BATCH_ROWS))), device)
        return [([resolve_slot(spec, features) for spec in bundle], features["rows"])
                for bundle in engine.program.bundles]

    table = cs.build_table(cs.BATCH_ROWS, 0)
    analyzers = collect_required_analyzers([cs.build_check(dq, table.num_rows)])
    battery = [a for a in dict.fromkeys(analyzers) if isinstance(a, ScanShareableAnalyzer)]
    for slots, rows in bundles(battery, table):
        cases[f"scan_reduce {len(slots)} slots"] = ("one", slots, rows)

    lineitem = cs.build_lineitem(cs.BATCH_ROWS, cs.LINEITEM_SEED, cs.COMMENT_POOL // 10)
    probe = dq.Dataset.from_arrow(lineitem)
    first = first_pass_analyzers(probe, probe.schema.names, {})
    battery = [a for a in first if not isinstance(a, Histogram)]
    battery += [DeviceFrequencyScan(a.column, probe.dictionary_size(a.column))
                for a in first if isinstance(a, Histogram)]
    for slots, rows in bundles(battery, lineitem):
        cases[f"scan_reduce {len(slots)} slots (profile)"] = ("one", slots, rows)

    scan = cs.build_scan_data(cs.BATCH_ROWS)
    for slots, rows in bundles([dq.Correlation("x0", "x1")], scan):
        cases["scan_reduce co-moment slot"] = ("one", slots, rows)

    for n in STACKED_ROWS:
        stream = cs.build_stream_table(cs.STREAM_WIDTH, cs.STREAM_BATCHES, n, cs.STREAM_SEED)
        program, feats = cs._session_features(dq, stream, cs.STREAM_WIDTH, n)
        stacked = {key: _stack_to_device([f[key] for f in feats], device)
                   for key in program.feature_keys}
        for bundle in program.bundles:
            slots = [resolve_slot(spec, stacked) for spec in bundle]
            cases[f"scan_reduce_stacked {cs.STREAM_WIDTH} x {n}, {len(slots)} slots"] = (
                "stacked", slots, stacked["rows"])
    torch.cuda.synchronize()
    return cases


def k3_cases(torch, cs) -> dict:
    """label -> (codes, rows, present, k): K3 on config 2's two dictionary
    columns (Zipf(1.3) codes) and on ``cat_large``'s K spread evenly."""
    batch = cs.build_table(cs.BATCH_ROWS, 0)
    every = torch.ones(cs.BATCH_ROWS, dtype=torch.bool, device="cuda")
    cases = {}
    for name in ("cat_large", "cat_small"):
        column = batch[name].combine_chunks()
        k = len(column.dictionary)
        codes = torch.from_numpy(column.indices.fill_null(k).to_numpy().astype(np.int32)).cuda()
        present = torch.from_numpy(~column.is_null().to_numpy(zero_copy_only=False)).cuda()
        cases[f"dict_code_counts {name} K={k}"] = (codes, every, present, k)
        if name == "cat_large":
            even = torch.randint(0, k, (cs.BATCH_ROWS,), dtype=torch.int32, device="cuda",
                                 generator=torch.Generator("cuda").manual_seed(0))
            cases[f"dict_code_counts K={k} even codes"] = (even, every, present, k)
    return cases


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(HERE))
    parser.add_argument("--label", default="")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("scan_count_times: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    cs = chip_smoke()
    import deequ_tpu_torch as dq
    from deequ_tpu_torch.kernels.dict_code_counts import dict_code_counts
    from deequ_tpu_torch.kernels.scan_reduce import scan_reduce, scan_reduce_stacked

    assert Path(dq.__file__).resolve().is_relative_to(Path(args.root).resolve())
    times = {}
    for label, (entry, slots, rows) in k1_cases(torch, dq, cs).items():
        fn = scan_reduce if entry == "one" else scan_reduce_stacked
        t = cs._time_kernel_ms(torch, lambda: fn(slots, rows))
        bound, _ = cs._bound_ms(_slot_bytes(slots, rows, 7 + 5), 0)
        times[label] = {"ms": t["ms"], "host_ms": t["host_ms"], "bound_ms": bound,
                        "library_ms": None}
    for label, (codes, rows, present, k) in k3_cases(torch, cs).items():
        keys = torch.where(rows & present & (codes >= 0) & (codes < k), codes, k).long()
        t = cs._time_kernel_ms(torch, lambda: dict_code_counts(codes, rows, present, k))
        library = cs._time_ms(torch, lambda: torch.bincount(keys, minlength=k + 1))
        n = codes.shape[0]
        bound, _ = cs._bound_ms(6 * n + 8 * k + 8, 2 * n)
        times[label] = {"ms": t["ms"], "host_ms": t["host_ms"], "bound_ms": bound,
                        "library_ms": library["ms"]}
    print(json.dumps({"label": args.label, "root": args.root, "card": cs._nvidia_smi(),
                      "kind": torch.cuda.get_device_name(0), "times": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
