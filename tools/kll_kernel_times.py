#!/usr/bin/env python3
"""Time K4 ``kll_sample`` and K5 ``kll_compact``'s entries on one CUDA GPU,
at the shapes ``chip_smoke.py`` phase 2 times them, for comparing two
trees of the port on one card.

    python3 tools/kll_kernel_times.py [--root DIR] [--label NAME]

The package is imported from ``DIR`` (default: this checkout), the inputs
and the timer from this checkout's ``chip_smoke.py``; so a second tree
unpacked beside this one (``git archive <commit> | tar -x -C
archive-check/parent``) is timed by the same script on the same inputs.
Run the two in turns in one call (parent, change, change, parent) and
compare within it. The inputs, from lineitem's 10M rows (seed 19):

- ``kll_sample``: l_extendedprice's first 2^20 rows, and a constant column
  of 2^20 rows, beside ``torch.sort`` of 2^20 float32;
- ``kll_compact`` update: the second sample of that batch appended to the
  sketch of the first (as ``chip_smoke._check_kll``);
- ``kll_compact_ingest``: the profile's numeric sketches taking the host
  samples of their first chunk, 10 batches of 2^20 rows, and of a full
  chunk of 32 batches of 2^18 rows (as ``check_ingest_kernels``);
- ``kll_compact_merge_stacked``: 8 pairs of l_extendedprice sketches, each
  filled with two host samples of 2^18-row batches;

each beside ``torch.sort`` of one 4,096-item level. Prints one JSON line
with the card (``nvidia-smi``'s name and power limit) and the median
CUDA-event ms and host ms of each.
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
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kll_kernel_times: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    cs = _chip_smoke()
    import deequ_tpu_torch as dq
    from deequ_tpu_torch.analyzers.sketches import KLLSketch
    from deequ_tpu_torch.kernels.kll_compact import (
        kll_compact_ingest,
        kll_compact_merge_stacked,
        kll_compact_update,
    )
    from deequ_tpu_torch.kernels.kll_sample import kll_sample
    from deequ_tpu_torch.ops.kll import kll_init, kll_update
    from deequ_tpu_torch.profiles import first_pass_analyzers
    from deequ_tpu_torch.runners.engine import stack_samples

    assert Path(dq.__file__).resolve().is_relative_to(Path(args.root).resolve())
    times = {}

    def timed(name, fn, library=None):
        t = cs._time_kernel_ms(torch, fn)
        times[name] = {"ms": t["ms"], "host_ms": t["host_ms"]}
        if library is not None:
            times[name]["library_ms"] = cs._time_ms(torch, library)["ms"]

    table = cs.build_lineitem(cs.LINEITEM_ROWS, cs.LINEITEM_SEED)
    data = dq.Dataset.from_arrow(table)
    sketches = [a for a in first_pass_analyzers(data, data.schema.names, {})
                if isinstance(a, KLLSketch)]
    k = sketches[0]._sketch_size()

    n = cs.BATCH_ROWS
    column = table["l_extendedprice"].combine_chunks().to_numpy(zero_copy_only=False)
    values = torch.from_numpy(column[:n].astype(np.float64)).cuda()
    rows = torch.ones(n, dtype=torch.bool, device="cuda")
    sorted_items = values.float()
    state = kll_init(k, device="cuda")
    timed("kll_sample", lambda: kll_sample(values, rows, None, None, state.ticks, k),
          lambda: torch.sort(sorted_items))
    constant = torch.full((n,), 7.25, dtype=torch.float64, device="cuda")
    timed("kll_sample constant column",
          lambda: kll_sample(constant, rows, None, None, state.ticks, k))
    state = kll_update(state, values, rows)
    sample = kll_sample(values, rows, None, None, state.ticks, k)
    level = torch.from_numpy(np.tile(column[:2 * k], 2).astype(np.float32)).cuda()
    timed("kll_compact update", lambda: kll_compact_update(state.tensors(), sample, k),
          lambda: torch.sort(level))

    def fresh(count):
        return [torch.stack(list(col)).contiguous()
                for col in zip(*(kll_init(k, device="cuda").tensors() for _ in range(count)))]

    batches = -(-data.num_rows // cs.BATCH_ROWS)
    for label, batch_rows, count in (("10 x 2^20", cs.BATCH_ROWS, min(cs.CHUNK, batches)),
                                     ("32 x 2^18", cs.HOST_BATCH_ROWS, cs.CHUNK)):
        chunk = cs._ingest_chunk(dq, data, sketches, batch_rows, count)
        fields = stack_samples(chunk, 4 * k, lambda t: t.cuda())
        scratch = fresh(len(chunk))
        timed(f"kll_compact_ingest {len(chunk)} x {label}",
              lambda: kll_compact_ingest(scratch, fields, k), lambda: torch.sort(level))

    at = [a.column for a in sketches].index("l_extendedprice")
    samples = cs._ingest_chunk(dq, data, sketches, cs.HOST_BATCH_ROWS, 32)[at]
    stacked = fresh(16)
    kll_compact_ingest(stacked, stack_samples(
        [[samples[2 * i], samples[2 * i + 1]] for i in range(16)], 4 * k, lambda t: t.cuda()), k)
    a, b = [t[:8] for t in stacked], [t[8:] for t in stacked]
    timed("kll_compact_merge_stacked 8 pairs", lambda: kll_compact_merge_stacked(a, b, k),
          lambda: torch.sort(level))

    print(json.dumps({"label": args.label, "root": args.root, "card": cs._nvidia_smi(),
                      "kind": torch.cuda.get_device_name(0), "times": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
