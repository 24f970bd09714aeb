#!/usr/bin/env python3
"""Time K8 ``state_fold``'s four entries and K7 ``freq_compact``'s two
modes on one CUDA GPU, at the shapes ``chip_smoke.py`` times them, for
comparing two trees of the port on one card; and K3 ``dict_code_counts``
beside ``torch.bincount``.

    python3 tools/fold_compact_times.py [--root DIR] [--label NAME]

The package is imported from ``DIR`` (default: this checkout), the inputs
and the timer from this checkout's ``chip_smoke.py``; so a second tree
unpacked beside this one (``git archive <commit> | tar -x -C
archive-check/parent``) is timed by the same script on the same inputs.
Run the two in turns in one call (parent, change, change, parent) and
compare within it. The inputs:

- ``state_fold``: config 4's battery (``incremental_battery`` without its
  sketch) over two day partitions, N = 2 (phase 6's launch; the states'
  shapes do not depend on the partitions' rows, cut here to 2^17); every
  state kind at N = 32 (``fold_groups``, seed 11, a month of days);
- ``state_fold_carry``: config 2's battery and ApproxQuantile (28 slots,
  ``build_table`` seed 0; its 50,000-category dictionary makes the row
  412 KB), the carry and 32 host partials (phase 7's chunk; 2^15-row
  batches, the same shapes as 2^18);
- ``state_fold_butterfly``: 8 of those partials as 8 shards x 1 (phase 9
  (b)'s merge);
- ``state_fold_carry_stacked``: 8 identity carries, 4 partials each;

each beside ``torch.amax`` of the stacked HLL registers (plus
``torch.sum`` of the stacked int64 columns for the last three);

- ``freq_compact``: a full 2^22-slot table and the 2^20 keys of the grouping
  workload's first batch (phase 5 (b)'s compaction), and the merge of two
  full 2^22 tables, beside ``torch.sort`` of the keys;
- ``dict_code_counts``: config 2's ``cat_large`` (50,000 Zipf codes) on a
  2^20-row batch, beside ``torch.bincount``.

With ``--stream N`` it also runs phase 8 (c) of ``chip_smoke.py`` with N
sessions (serial folds: one ``state_fold`` launch per analyzer and fold,
the path whose host cost K8's wrapper sets) and reports its wall time,
sessions per second and K8 launches.

Prints one JSON line with the card (``nvidia-smi``'s name and power limit)
and the median CUDA-event ms and host ms of each.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(HERE))
    parser.add_argument("--label", default="")
    parser.add_argument("--stream", type=int, default=0,
                        help="sessions of phase 8 (c) to run after the kernels (0: none)")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("fold_compact_times: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    cs = _chip_smoke()
    import deequ_tpu_torch as dq
    from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer, fold_layout, pack_states
    from deequ_tpu_torch.analyzers.grouping import DeviceFrequencyScan
    from deequ_tpu_torch.analyzers.state_provider import InMemoryStateProvider
    from deequ_tpu_torch.kernels.dict_code_counts import dict_code_counts
    from deequ_tpu_torch.kernels.freq_compact import freq_compact
    from deequ_tpu_torch.kernels.freq_keys import freq_keys
    from deequ_tpu_torch.kernels.state_fold import (
        state_fold,
        state_fold_butterfly,
        state_fold_carry,
        state_fold_carry_stacked,
    )
    from deequ_tpu_torch.runners.analysis_runner import collect_required_analyzers

    assert Path(dq.__file__).resolve().is_relative_to(Path(args.root).resolve())
    times = {}

    def timed(name, fn, library=None):
        t = cs._time_kernel_ms(torch, fn)
        times[name] = {"ms": t["ms"], "host_ms": t["host_ms"]}
        if library is not None:
            times[name]["library_ms"] = cs._time_ms(torch, library)["ms"]

    def registers_and_counts(mats):
        return lambda: (torch.amax(mats[2], dim=0), torch.sum(mats[1], dim=0))

    # K8 at N = 2 on config 4's partition states, and at N = 32 on every kind
    battery = [a for a in cs.incremental_battery(dq) if not isinstance(a, dq.KLLSketch)]
    rows = 1 << 17
    scan = cs.build_scan_data(2 * rows)
    providers = []
    for p in range(2):
        sp = InMemoryStateProvider()
        dq.AnalysisRunner.do_analysis_run(dq.Dataset.from_arrow(scan.slice(p * rows, rows)),
                                          battery, save_states_with=sp, device="cuda")
        providers.append(sp)
    config4 = [[p.load(a) for p in providers] for a in battery]
    month = [states for _, states in cs.fold_groups(dq, cs.MONTH_OF_DAYS, 11)]
    for label, jobs in (("state_fold N=2 config 4", config4),
                        (f"state_fold N={cs.MONTH_OF_DAYS} every kind", month)):
        mats, slots, _ = pack_states(jobs, fold_layout())
        mats = [m.cuda() for m in mats]
        timed(label, lambda: state_fold(*mats, slots), lambda: torch.amax(mats[2], dim=0))

    # K8's carry, butterfly and stacked carry on config 2's host partials
    table = cs.build_table(cs.CHUNK << 15, 0)
    data = dq.Dataset.from_arrow(table)
    analyzers = collect_required_analyzers([cs.build_check(dq, table.num_rows)])
    config2 = [a for a in dict.fromkeys(analyzers) if isinstance(a, ScanShareableAnalyzer)]
    config2 += [DeviceFrequencyScan(c, data.dictionary_size(c)) for c in ("cat_small", "cat_large")]
    config2 += [dq.ApproxQuantile("a", 0.5, cs.KLL_RELATIVE_ERROR)]
    ingest, packed = cs.host_partial_rows(dq, config2, data, 1 << 15, cs.CHUNK)
    slots = ingest.slots
    parts = [torch.stack([r[d] for r, _ in packed]).cuda() for d in range(3)]
    carry = [c.clone() for c in ingest.carry]
    timed(f"state_fold_carry {len(slots)} slots + {cs.CHUNK} partials",
          lambda: state_fold_carry(carry, parts, slots), registers_and_counts(parts))
    shards = [m[:cs.MESH_SHARDS].contiguous() for m in parts]
    timed(f"state_fold_butterfly {cs.MESH_SHARDS} x 1",
          lambda: state_fold_butterfly(*shards, slots, cs.MESH_SHARDS),
          registers_and_counts(shards))
    carries = [c[None].expand(cs.MESH_SHARDS, -1).contiguous() for c in ingest.carry]
    timed(f"state_fold_carry_stacked {cs.MESH_SHARDS} x {cs.CHUNK // cs.MESH_SHARDS}",
          lambda: state_fold_carry_stacked(carries, parts, slots), registers_and_counts(parts))

    # K7: phase 5 (b)'s compaction and the merge of two full tables
    grouping = cs.build_grouping()
    scan_plan, features = cs._table_features(torch, dq, grouping, ("k",))
    keys = torch.empty(cs.BATCH_ROWS, dtype=torch.int64, device="cuda")
    freq_keys(scan_plan.key_columns(features), features["rows"], keys, 0)
    full = cs._full_table(torch, 0, cs.FULL_TABLE_SLOTS)
    other = cs._full_table(torch, cs.FULL_TABLE_SLOTS // 2, cs.FULL_TABLE_SLOTS)
    both = torch.cat([full.keys, keys])
    timed("freq_compact 2^22 + 2^20",
          lambda: freq_compact(full.keys, full.counts, keys, None, cs.FULL_TABLE_SLOTS),
          lambda: torch.sort(both))
    tables = torch.cat([full.keys, other.keys])
    timed("freq_compact merge 2^22 + 2^22",
          lambda: freq_compact(full.keys, full.counts, other.keys, other.counts,
                               cs.FULL_TABLE_SLOTS),
          lambda: torch.sort(tables))

    # K3 on 50,000 Zipf codes
    batch = cs.build_table(cs.BATCH_ROWS, 0)
    column = batch["cat_large"].combine_chunks()
    k = len(column.dictionary)
    codes = torch.from_numpy(column.indices.fill_null(-1).to_numpy().astype(np.int32)).cuda()
    present = torch.from_numpy(~column.is_null().to_numpy(zero_copy_only=False)).cuda()
    every = torch.ones(cs.BATCH_ROWS, dtype=torch.bool, device="cuda")
    counted = torch.where(present, codes, k).long()
    timed(f"dict_code_counts K={k}", lambda: dict_code_counts(codes, every, present, k),
          lambda: torch.bincount(counted, minlength=k + 1))

    stream = None
    if args.stream:
        table = cs.build_stream_table(args.stream, cs.STREAM_BATCHES, cs.STREAM_ROWS,
                                      cs.STREAM_SEED)
        _, summary, launches = cs.stream_run(torch, dq, table, args.stream, cs.STREAM_ROWS, False,
                                             label="stream (c) serial", kernels=("state_fold",))
        stream = {"sessions": args.stream, "wall_s": summary["wall_s"],
                  "sessions_per_s": summary["sessions_per_s"],
                  "state_fold_launches": launches["state_fold"]}
    print(json.dumps({"label": args.label, "root": args.root, "card": cs._nvidia_smi(),
                      "kind": torch.cuda.get_device_name(0), "times": times, "stream": stream}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
