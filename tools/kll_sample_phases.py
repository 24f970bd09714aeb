#!/usr/bin/env python3
"""Time the phases of K4 ``kll_sample``'s scatter passes on one CUDA GPU.

    python3 tools/kll_sample_phases.py [--rows N] [--seed S]

Writes a copy of ``deequ_tpu_torch/kernels/csrc/kll_sample.cu`` in which
every block of ``ks_scatter`` stamps the GPU's ``%globaltimer`` (ns) at the
boundaries of its phases into a device array, builds it with the package's
``nvcc`` flags into ``deequ_tpu_torch/kernels/_build/``, runs it once on two
columns of ``--rows`` rows (normal values; small integers, whose low bytes
are zero so two passes are skipped) and prints, for each pass that moved
rows: its span, and the median and largest time of each phase over the
tiles (ticket and zeroing, tile load, ranking, publish and digit scans,
offsets, reorder, look-back, store), with the look-back of every 16th tile.
The stamps add a block barrier at each boundary, so the phases sum to a
little more than the kernel's own time. The package's kernel is not
changed.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
PHASES = ("ticket and zeroing", "load", "ranking", "publish and scans", "offsets", "reorder",
          "look-back", "store")
#: the source lines a stamp goes before, in order (stamps 2 .. 8)
MARKERS = (
    "  // rank: warp w takes rows",
    "  // the status words: two arrays",
    "  if (d < KS_RADIX) {\n    unsigned t_base",
    "  // reorder the tile so that",
    "  // decoupled look-back: warp w",
    "  // write each digit's run out",
    "  if (pass != 3) return;",
)
SLOTS = 16
MAX_TILES = 4096


def stamped_source(src: str) -> str:
    """The kernel source with the phase stamps and a ``set_stamps`` entry."""
    stamp = (
        "__device__ unsigned long long* g_stamps;\n"
        "__device__ __forceinline__ unsigned long long ks_now() {\n"
        "  unsigned long long t;\n"
        "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
        "  return t;\n"
        "}\n"
        f"#define KS_STAMP(k) do {{ __syncthreads(); if (threadIdx.x == 0) "
        f"g_stamps[((long long)pass * {MAX_TILES} + tile) * {SLOTS} + (k)] = ks_now(); }} "
        "while (0)\n")
    src = src.replace('#include "common.cuh"', '#include "common.cuh"\n' + stamp, 1)
    start = src.index("ks_scatter(uint32_t* bits0")
    end = src.index("\n}\n", start) + 3
    body = src[start:end]
    edits = [("  if (ks_trivial(ctl, n, pass)) {",
              "  const unsigned long long t_enter = ks_now();\n  if (ks_trivial(ctl, n, pass)) {"),
             ("  const int tile = s_tile_id;\n",
              "  const int tile = s_tile_id;\n  if (threadIdx.x == 0) g_stamps[((long long)pass * "
              f"{MAX_TILES} + tile) * {SLOTS}] = t_enter;\n  KS_STAMP(1);\n")]
    edits += [(m, f"  KS_STAMP({k});\n" + m) for k, m in enumerate(MARKERS, start=2)]
    for old, new in edits:
        if old not in body:
            raise RuntimeError(f"kll_sample.cu changed: no {old!r} in ks_scatter")
        body = body.replace(old, new, 1)
    src = src[:start] + body + src[end:]
    return src.replace(
        'extern "C" long long kll_sample_scratch_bytes',
        'extern "C" int set_stamps(unsigned long long* p) {\n'
        '  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n\n'
        'extern "C" long long kll_sample_scratch_bytes', 1)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", type=int, default=1 << 20)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kll_sample_phases: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from deequ_tpu_torch.kernels import build

    source = build.CSRC / "kll_sample.cu"
    stamped = build.BUILD_DIR / "kll_sample_phases.cu"
    library = build.BUILD_DIR / "libkll_sample_phases.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stamped.write_text(stamped_source(source.read_text()))
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
                    str(library), str(stamped)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(library))
    lib.kll_sample_scratch_bytes.restype = ctypes.c_longlong
    lib.kll_sample_scratch_bytes.argtypes = [ctypes.c_longlong]
    lib.kll_sample_launch.restype = ctypes.c_int
    lib.kll_sample_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
                                      + [ctypes.c_void_p] * 6)
    lib.set_stamps.argtypes = [ctypes.c_void_p]
    stamps = torch.zeros(4 * MAX_TILES * SLOTS, dtype=torch.int64, device="cuda")
    if lib.set_stamps(stamps.data_ptr()) != 0:
        raise RuntimeError("set_stamps failed")

    n, k = args.rows, 2048
    rng = np.random.default_rng(args.seed)
    columns = {"normal": rng.normal(50_000.0, 20_000.0, n),
               "small integers": rng.integers(1, 51, n).astype(np.float64)}
    tiles = -(-n // 8192)
    print(f"[card] {torch.cuda.get_device_name(0)}; {n} rows, {tiles} tiles", flush=True)
    for label, values in columns.items():
        v = torch.from_numpy(values).cuda()
        rows = torch.ones(n, dtype=torch.bool, device="cuda")
        ticks = torch.zeros((), dtype=torch.int32, device="cuda")
        for _ in range(3):  # the last call's stamps are read
            stamps.zero_()
            scratch = torch.empty(lib.kll_sample_scratch_bytes(n), dtype=torch.uint8,
                                  device="cuda")
            out = (torch.empty(k, dtype=torch.float32, device="cuda"),
                   torch.empty(3, dtype=torch.int32, device="cuda"),
                   torch.empty(2, dtype=torch.float64, device="cuda"))
            status = lib.kll_sample_launch(
                v.data_ptr(), rows.data_ptr(), None, None, n, k, ticks.data_ptr(),
                scratch.data_ptr(), *(t.data_ptr() for t in out),
                torch.cuda.current_stream().cuda_stream)
            if status != 0:
                raise RuntimeError(f"launch failed: cudaError {status}")
            torch.cuda.synchronize()
        table = stamps.view(4, MAX_TILES, SLOTS)[:, :tiles, :len(PHASES) + 1].cpu().numpy()
        for p in range(4):
            t = table[p].astype(np.int64)
            if t[:, -1].max() == 0:
                print(f"[{label} pass {p}] skipped: one digit for every row", flush=True)
                continue
            phases = np.diff(t, axis=1) / 1e3
            span = (t[:, -1].max() - t[:, 0].min()) / 1e3
            median = {name: round(float(np.median(phases[:, i])), 2)
                      for i, name in enumerate(PHASES)}
            most = {name: round(float(phases[:, i].max()), 2) for i, name in enumerate(PHASES)}
            print(f"[{label} pass {p}] span {span:.2f} us; median us {median}; largest us {most}; "
                  f"look-back of every 16th tile "
                  f"{[round(float(x), 2) for x in phases[::16, PHASES.index('look-back')]]}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
