#!/usr/bin/env python3
"""Time the port's main paths end to end on one CUDA GPU, for comparing two
trees of the port, or two feed depths, on one card.

    python3 tools/torch_main_paths.py [--root DIR] [--label NAME] [--rounds N]
    python3 tools/torch_main_paths.py --alternate PAIRS [--root DIR] [--label NAME]

The package is imported from ``DIR`` (default: this checkout), the data
builders and checks from this checkout's ``chip_smoke.py``; so a second
tree unpacked beside this one (``git archive <commit> | tar -x -C
archive-check/parent``) runs the same paths on the same data. The feed
depth is the environment's ``DEEQU_TPU_PREFETCH_DEPTH`` (a tree without
the feed pipeline ignores it). Run the trees and depths in turns in one
call (parent, change, change, parent) and compare within it. After one
warm run of each, it times:

- phase 3: ``VerificationSuite`` over ``build_table`` (10M rows, seed 0)
  with ``build_check`` and ``CountDistinct("cat_large")``, ``N`` times;
- phase 4: ``ColumnProfilerRunner`` over ``build_lineitem`` (10M rows,
  seed 19), ``N`` times;
- one-batch passes: ``SERIAL_JOBS`` verification runs of phase 3's checks
  over 4,096-row slices of its table, one after another (the per-pass
  cost of the reliability wrapper and the watchdog's thread).

Prints one JSON line with the card (``nvidia-smi``'s name and power
limit), the depth, each run's seconds, the medians and the phases of the
median runs.

With ``--alternate PAIRS`` it compares the feed depths 0 and 2 within
one process instead: phase 3 ``PAIRS`` times at each depth and phase 4
``max(1, PAIRS // 2)`` times, in the order 0, 2, 2, 0, 0, 2, ... (each
run sets ``DEEQU_TPU_PREFETCH_DEPTH``, which the engine reads at every
pass), and prints per path and depth the seconds, the median and the
median run's phases, and the median of the pairs' ratios (depth 2 over
depth 0).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ROWS = 10_000_000
SERIAL_JOBS = 200
SERIAL_ROWS = 4096


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def timed(torch, run) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    monitor = run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, monitor


def median_run(runs: list) -> dict:
    seconds = [s for s, _ in runs]
    at = seconds.index(sorted(seconds)[len(seconds) // 2])
    phases = {k: round(v, 4) for k, v in runs[at][1].phase_seconds.items() if "." not in k}
    return {"seconds": seconds, "median": statistics.median(seconds), "phases": phases}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(HERE))
    parser.add_argument("--label", default="")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--alternate", type=int, default=0, metavar="PAIRS")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_main_paths: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    cs = chip_smoke()
    import deequ_tpu_torch as dq
    from deequ_tpu_torch.kernels import build

    assert Path(dq.__file__).resolve().is_relative_to(Path(args.root).resolve())
    build.build()
    table = cs.build_table(ROWS, 0)
    data = dq.Dataset.from_arrow(table)
    check = cs.build_check(dq, ROWS)

    def verify():
        monitor = dq.RunMonitor()
        (dq.VerificationSuite.on_data(data, device="cuda").add_check(check)
         .add_required_analyzer(dq.CountDistinct("cat_large")).with_monitor(monitor).run())
        return monitor

    verify()
    if args.alternate:
        return alternate(args, torch, cs, dq, verify)
    verification = median_run([timed(torch, verify) for _ in range(args.rounds)])

    small = cs.build_check(dq, SERIAL_ROWS)
    slices = [dq.Dataset.from_arrow(table.slice(i * SERIAL_ROWS, SERIAL_ROWS))
              for i in range(SERIAL_JOBS)]

    def serial():
        monitor = dq.RunMonitor()
        for part in slices:
            (dq.VerificationSuite.on_data(part, device="cuda").add_check(small)
             .with_batch_size(SERIAL_ROWS).with_monitor(monitor).run())
        return monitor

    serial()
    one_batch = median_run([timed(torch, serial)])
    del data, table, slices

    lineitem = dq.Dataset.from_arrow(cs.build_lineitem(ROWS, cs.LINEITEM_SEED))

    def profile():
        monitor = dq.RunMonitor()
        dq.ColumnProfilerRunner.on_data(lineitem, device="cuda").with_monitor(monitor).run()
        return monitor

    profile()
    profiles = median_run([timed(torch, profile) for _ in range(max(1, args.rounds - 1))])
    print(json.dumps({
        "label": args.label, "root": args.root, "card": cs._nvidia_smi(),
        "depth": os.environ.get("DEEQU_TPU_PREFETCH_DEPTH"),
        "phase 3": verification, "phase 4": profiles,
        f"{SERIAL_JOBS} one-batch passes": one_batch,
    }), flush=True)
    return 0


def alternate(args, torch, cs, dq, verify) -> int:
    """Depths 0 and 2 in turns within this process (see the module's
    docstring)."""

    def pairs(run, n: int) -> dict:
        runs = {"0": [], "2": []}
        for i in range(n):
            for depth in (("0", "2") if i % 2 == 0 else ("2", "0")):
                os.environ["DEEQU_TPU_PREFETCH_DEPTH"] = depth
                runs[depth].append(timed(torch, run))
        out = {f"depth {d}": median_run(r) for d, r in runs.items()}
        out["ratio 2/0 median"] = statistics.median(
            b[0] / a[0] for a, b in zip(runs["0"], runs["2"]))
        return out

    verification = pairs(verify, args.alternate)
    lineitem = dq.Dataset.from_arrow(cs.build_lineitem(ROWS, cs.LINEITEM_SEED))

    def profile():
        monitor = dq.RunMonitor()
        dq.ColumnProfilerRunner.on_data(lineitem, device="cuda").with_monitor(monitor).run()
        return monitor

    profile()
    profiles = pairs(profile, max(1, args.alternate // 2))
    print(json.dumps({"label": args.label, "root": args.root, "card": cs._nvidia_smi(),
                      "phase 3": verification, "phase 4": profiles}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
