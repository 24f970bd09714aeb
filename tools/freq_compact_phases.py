#!/usr/bin/env python3
"""Time the launches of K7 ``freq_compact`` and the phases of its merge on
one CUDA GPU.

    python3 tools/freq_compact_phases.py

Inputs as ``tools/fold_compact_times.py``: a full 2^22-slot table with the
2^20 keys of the grouping workload's first batch (phase 5 (b)'s
compaction), and the merge of two full 2^22 tables.

1. ``torch.profiler`` over five calls of each: the device time of every
   kernel of a call (the memset, the upsweep, the eight scatter launches,
   the merge-path split, the merge-compaction, the fill).
2. A copy of ``deequ_tpu_torch/kernels/csrc/freq_compact.cu`` in which
   every block of ``fc_merge_compact`` stamps the GPU's ``%globaltimer``
   (ns) at the boundaries of its phases (ticket, tile load, merge, run
   flags and scans, look-back, writes), built with the package's ``nvcc``
   flags into ``deequ_tpu_torch/kernels/_build/``: the median and largest
   time of each phase over the tiles, and the kernel's span. The stamps
   add a block barrier at each boundary. The package's kernel is not
   changed.
"""

from __future__ import annotations

import ctypes
import importlib.util
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PHASES = ("ticket", "tile load", "merge", "run flags and scans", "look-back", "writes")
#: the source lines a stamp goes before, in order (stamps 1 .. 6)
MARKERS = (
    "  const i64 a0 = splits[tile];",
    "  // each thread merges FC_ITEMS entries",
    "  // run starts, run ends and the counts of real keys",
    "  const bool closes = s_last_break >= 0;",
    "  // the runs that end in this tile, by local rank",
    "  for (int o = 16; o > 0; o >>= 1) kept += __shfl_xor_sync",
)
SLOTS = 8
#: merged entries a block of the merge takes; equals FC_TILE
MERGE_TILE = 2048


def stamped_source(src: str) -> str:
    """The kernel source with the phase stamps and a ``set_stamps`` entry."""
    stamp = (
        "__device__ unsigned long long* g_stamps;\n"
        "__device__ __forceinline__ unsigned long long fc_now() {\n"
        "  unsigned long long t;\n"
        "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
        "  return t;\n"
        "}\n"
        f"#define FC_STAMP(k) do {{ __syncthreads(); if (threadIdx.x == 0) "
        f"g_stamps[(long long)tile * {SLOTS} + (k)] = fc_now(); }} while (0)\n")
    src = src.replace('#include "common.cuh"', '#include "common.cuh"\n' + stamp, 1)
    start = src.index("fc_merge_compact(const u64* __restrict__ a_keys")
    body = src.index("{", start) + 1
    src = src[:body] + "\n  const unsigned long long t_entry = fc_now();" + src[body:]
    for k, marker in enumerate(MARKERS, start=1):
        at = src.index(marker, start)
        extra = (f"  FC_STAMP({k});\n" if k > 1 else
                 f"  if (threadIdx.x == 0) g_stamps[(long long)tile * {SLOTS}] = t_entry;\n"
                 f"  FC_STAMP({k});\n")
        src = src[:at] + extra + src[at:]
    src += ("\nextern \"C\" int set_stamps(unsigned long long* p) {\n"
            "  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n")
    return src


def build_stamped():
    from deequ_tpu_torch.kernels import build

    source = stamped_source((build.CSRC / "freq_compact.cu").read_text())
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / "freq_compact_phases.cu"
    cu.write_text(source)
    lib = build.BUILD_DIR / "libfreq_compact_phases.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib),
                    str(cu)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("freq_compact_phases: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import deequ_tpu_torch as dq
    from deequ_tpu_torch.kernels import freq_compact as K
    from deequ_tpu_torch.kernels.freq_keys import freq_keys

    print(f"[card] {cs._nvidia_smi()}", flush=True)
    grouping = cs.build_grouping()
    scan_plan, features = cs._table_features(torch, dq, grouping, ("k",))
    keys = torch.empty(cs.BATCH_ROWS, dtype=torch.int64, device="cuda")
    freq_keys(scan_plan.key_columns(features), features["rows"], keys, 0)
    full = cs._full_table(torch, 0, cs.FULL_TABLE_SLOTS)
    other = cs._full_table(torch, cs.FULL_TABLE_SLOTS // 2, cs.FULL_TABLE_SLOTS)
    cases = {
        "2^22 + 2^20": (full.keys, full.counts, keys, None),
        "merge 2^22 + 2^22": (full.keys, full.counts, other.keys, other.counts),
    }

    from torch.profiler import ProfilerActivity, profile

    for label, args in cases.items():
        for _ in range(3):
            K.freq_compact(*args, cs.FULL_TABLE_SLOTS)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                K.freq_compact(*args, cs.FULL_TABLE_SLOTS)
            torch.cuda.synchronize()
        print(f"[profile {label}] device us a call, by kernel:", flush=True)
        for event in prof.key_averages():
            device_us = getattr(event, "device_time_total", getattr(event, "cuda_time_total", 0))
            if device_us > 0 and event.count >= 5:
                print(f"  {event.key[:60]:60s} launches {event.count // 5:2d} a call, "
                      f"{device_us / 5:9.2f} us a call", flush=True)

    lib = build_stamped()
    lib.freq_compact_scratch_words.restype = ctypes.c_longlong
    lib.freq_compact_scratch_words.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
    lib.freq_compact_launch.restype = ctypes.c_int
    lib.freq_compact_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                        ctypes.c_longlong] + [ctypes.c_void_p] * 5
    for label, (ak, ac, bk, bc) in cases.items():
        na, nb = ak.shape[0], bk.shape[0]
        tiles = -(-(na + nb) // MERGE_TILE)
        stamps = torch.zeros(tiles * SLOTS, dtype=torch.int64, device="cuda")
        assert lib.set_stamps(ctypes.c_void_p(stamps.data_ptr())) == 0
        words = lib.freq_compact_scratch_words(na, nb, int(bc is None))
        scratch = torch.empty(words, dtype=torch.int64, device="cuda")
        out_k = torch.empty(cs.FULL_TABLE_SLOTS, dtype=torch.int64, device="cuda")
        out_c = torch.empty_like(out_k)
        meta = torch.empty(4, dtype=torch.int64, device="cuda")
        for _ in range(2):
            stamps.zero_()
            status = lib.freq_compact_launch(
                ak.data_ptr(), ac.data_ptr(), na, bk.data_ptr(),
                None if bc is None else bc.data_ptr(), nb, cs.FULL_TABLE_SLOTS,
                out_k.data_ptr(), out_c.data_ptr(), meta.data_ptr(), scratch.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            assert status == 0
            torch.cuda.synchronize()
        want = K.freq_compact(ak, ac, bk, bc, cs.FULL_TABLE_SLOTS)
        assert torch.equal(out_k, want.keys) and torch.equal(out_c, want.counts)
        s = stamps.view(tiles, SLOTS).cpu().numpy()
        s = s[s[:, 0] > 0]
        span = (s[:, len(PHASES)].max() - s[:, 0].min()) / 1e3
        print(f"[phases {label}] {len(s)} tiles, merge kernel span {span:.2f} us "
              f"(first block in to last block out); per tile, median / largest us:", flush=True)
        for k, phase in enumerate(PHASES):
            d = (s[:, k + 1] - s[:, k]) / 1e3
            print(f"  {phase:22s} {statistics.median(d):8.2f} / {d.max():8.2f}", flush=True)
        # blocks resident at once: tiles whose lifetimes overlap the median tile's middle
        mid = (s[:, 0] + s[:, len(PHASES)]) // 2
        m = int(statistics.median(mid))
        print(f"  tiles running at the median moment: "
              f"{int(((s[:, 0] <= m) & (s[:, len(PHASES)] >= m)).sum())}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
