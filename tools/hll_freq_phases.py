#!/usr/bin/env python3
"""Time the phases of K2 ``hll_registers``'s and K6 ``freq_keys``'s blocks
on one CUDA GPU, and each launch's device time.

    python3 tools/hll_freq_phases.py [--root DIR]

Writes a copy of ``csrc/hll_registers.cu`` and ``csrc/freq_keys.cu`` of
the tree at ``DIR`` (default: this checkout) in which thread 0 of every
block stamps the GPU's ``%globaltimer`` (ns, one clock for all SMs) at
the boundaries of its phases, builds them with the package's ``nvcc``
flags into ``deequ_tpu_torch/kernels/_build/`` and runs them at the
shapes ``tools/hll_freq_times.py`` times: K2's batch entry at 2^20 rows,
config 3's 16 HLL columns (the tree's route: the parent stamps the last
of its 16 launches), 16 sessions x 4,096 rows stacked; K6 on the grouping
batch's one column, the edge batch's five and lineitem's two. The stamps
add a block barrier at each boundary. The package's kernels are not
changed.

Phases, where the tree's kernel has them. The parent's K2: ``zero`` (the
block's shared registers), ``rows`` (the row loop), ``flush`` (a device
``atomicMax`` per nonzero register). The parent's K6: ``rows``, ``sums``
(the counters' reduction and atomics). A kernel that marks its phases
with ``// PHASE <k> <name>`` comments (k = 0, 1, ...) is stamped there;
the phase from marker k to marker k + 1 is named by marker k's text.

With ``--flush-variant`` it also builds K2 with the flush the parent's
design would have had at one wave (each block stores its registers, the
last block sweeps them) and times each K2 case with either flush.

Prints, per launch, the blocks, the median and longest time of each phase
over the blocks, the span from the first block's first stamp to the last
block's last, and ``torch.profiler``'s device time of every kernel of a
call (the zero fills, ``torch.maximum`` and memsets beside the kernel).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE / "tools"))
import hll_freq_times  # noqa: E402

#: stamp words a block keeps, and blocks a stamped launch may have
STAMPS = 8
MAX_BLOCKS = 1 << 15

STAMP_HEAD = (
    "__device__ unsigned long long* g_stamps;\n"
    "__device__ __forceinline__ unsigned long long ph_now() {\n"
    "  unsigned long long t;\n"
    "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
    "  return t;\n"
    "}\n"
    f"#define PH_STAMP(k) do {{ __syncthreads(); if (threadIdx.x == 0) "
    f"g_stamps[((long long)blockIdx.y * gridDim.x + blockIdx.x) * {STAMPS} + (k)] = "
    f"ph_now(); }} while (0)\n")

PARENT_K2 = (
    ("  for (int r = threadIdx.x; r < HLL_REGISTERS; r += blockDim.x) regs[r] = 0;", 0),
    ("  const long long stride = (long long)gridDim.x * blockDim.x;", 1),
    ("  for (int r = threadIdx.x; r < HLL_REGISTERS; r += blockDim.x) {\n"
     "    if (regs[r] != 0)", 2),
)
PARENT_K6 = (
    ("  unsigned long long sent = 0ull;", 0),
    ("  for (int off = 16; off > 0; off >>= 1) {\n    sent +=", 1),
)


def _marked_phases(src: str) -> list:
    """The ``// PHASE <k> <name>`` markers of a source, one a k, in order
    of k (a phase may end at several markers of one k: the returns)."""
    return sorted({int(k): name.strip() for k, name in
                   re.findall(r"// PHASE (\d+)([^\n]*)", src)}.items())


def stamp(src: str, parent_markers, kernel: str) -> tuple:
    """The source with its phase stamps, and the phase names."""
    src = src.replace('#include "common.cuh"', '#include "common.cuh"\n' + STAMP_HEAD, 1)
    marked = _marked_phases(src)
    if marked:
        src = re.sub(r"// PHASE (\d+)[^\n]*", lambda m: f"PH_STAMP({m.group(1)});", src)
        return src, [name for _, name in marked[:-1]]
    at = src.index(kernel)
    for marker, k in parent_markers:
        i = src.index(marker, at)
        src = src[:i] + f"  PH_STAMP({k});\n" + src[i:]
    end = src.index("\n}\n", src.index(parent_markers[-1][0], at))
    src = src[:end] + f"\n  PH_STAMP({len(parent_markers)});" + src[end:]
    names = (["zero", "rows", "flush"] if parent_markers is PARENT_K2 else ["rows", "sums"])
    return src, names


#: K2's flush as the tree has it (device atomicMax into the group's
#: accumulator rows, the last block reading them back) and the variant timed
#: beside it with --flush-variant: each block stores its 512 registers
#: into its own row of a [groups, blocks, 512] scratch and the last block
#: reduces the group's rows register by register, in a coalesced sweep
FLUSH_FROM = "  int* acc = t.ws + (long long)g * HLL_SPREAD * HLL_REGISTERS;"
FLUSH_TO = "  if (threadIdx.x == 0) *ticket = 0u;"
FLUSH_VARIANT = """  int* rows_of = t.ws + (long long)g * t.blocks * HLL_REGISTERS;
  unsigned* ticket = (unsigned*)t.ws + t.parts * t.sessions * t.blocks * HLL_REGISTERS + g;
  for (int r = threadIdx.x; r < HLL_REGISTERS; r += HLL_THREADS) {
    rows_of[(long long)blockIdx.x * HLL_REGISTERS + r] = regs[r];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == (unsigned)(t.blocks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int r = threadIdx.x; r < HLL_REGISTERS; r += HLL_THREADS) {
    int b = 0;
    for (long long k = 0; k < t.blocks; ++k) b = max(b, __ldcg(rows_of + k * HLL_REGISTERS + r));
    out[r] = prev != nullptr ? max(prev[r], b) : b;
  }
"""


def flush_variant(src: str) -> str:
    """K2's source with the store-and-sweep flush in place of its own."""
    start, end = src.index(FLUSH_FROM), src.index(FLUSH_TO)
    return src[:start] + FLUSH_VARIANT + src[end:]


def build_stamped(root: Path, name: str, parent_markers, kernel: str):
    from deequ_tpu_torch.kernels import build

    csrc = root / "deequ_tpu_torch" / "kernels" / "csrc"
    source, names = stamp((csrc / f"{name}.cu").read_text(), parent_markers, kernel)
    source += ("\nextern \"C\" int set_stamps(unsigned long long* p) {\n"
               "  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / f"{name}_phases.cu"
    cu.write_text(source)
    lib = build.BUILD_DIR / f"lib{name}_phases.so"
    out = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib),
                          str(cu)], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed on the stamped {name}.cu:\n{out.stdout}{out.stderr}")
    return ctypes.CDLL(str(lib)), names


def profile(torch, label: str, fn, calls: int = 5) -> None:
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us > 0 and e.device_type.name == "CUDA":
            print(f"[profile {label}] {e.key[:90]}: {us / calls:.2f} us a call, "
                  f"{e.count / calls:g} launches", flush=True)


def _line(name: str, ns: np.ndarray) -> str:
    return (f"  {name:28s} median {statistics.median(ns.tolist()) / 1e3:8.3f} us, "
            f"longest {ns.max() / 1e3:8.3f} us")


def report(label: str, rec: np.ndarray, names: list) -> None:
    per = rec.reshape(MAX_BLOCKS, STAMPS)
    live = per[per[:, 0] > 0]
    print(f"[phases {label}] {len(live)} blocks", flush=True)
    if not len(live):
        return
    for p, name in enumerate(names):
        a, b = live[:, p], live[:, p + 1]
        ok = (a > 0) & (b > 0)
        if ok.any():
            print(_line(f"{name} ({int(ok.sum())} blocks)", (b[ok] - a[ok]).astype(np.int64)),
                  flush=True)
    last = live[:, :len(names) + 1].max(axis=1)
    print(_line("block life", (last - live[:, 0]).astype(np.int64)), flush=True)
    print(f"  span (first stamp to last): {(last.max() - live[:, 0].min()) / 1e3:.3f} us",
          flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(HERE))
    parser.add_argument("--flush-variant", action="store_true",
                        help="also time K2 with the store-and-sweep flush")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("hll_freq_phases: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    cs = hll_freq_times.chip_smoke()
    import deequ_tpu_torch as dq
    import deequ_tpu_torch.kernels.freq_keys as K6
    import deequ_tpu_torch.kernels.hll_registers as K2

    assert Path(dq.__file__).resolve().is_relative_to(root)
    print(f"[card] {cs._nvidia_smi()}", flush=True)
    lib2, names2 = build_stamped(root, "hll_registers", PARENT_K2, "hll_registers_kernel(")
    lib6, names6 = build_stamped(root, "freq_keys", PARENT_K6, "freq_keys_kernel(")
    stamps = torch.zeros(MAX_BLOCKS * STAMPS, dtype=torch.int64, device="cuda")
    for lib in (lib2, lib6):
        assert lib.set_stamps(ctypes.c_void_p(stamps.data_ptr())) == 0
    load = K2.build.load

    def stamped(fn, lib, name):
        """Run ``fn`` on the stamped copy of kernel ``name``; its stamps."""
        K2.build.load = lambda n: lib if n == name else load(n)
        try:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            stamps.zero_()
            fn()
            torch.cuda.synchronize()
            return stamps.cpu().numpy()
        finally:
            K2.build.load = load

    for label, (fn, *_) in hll_freq_times.k2_cases(torch, dq, cs).items():
        if "65536" in label:
            continue
        t = cs._time_kernel_ms(torch, fn)
        print(f"[time {label}] {t['ms']:.4f} ms (CUDA events, median of {t['reps']}), "
              f"host {t['host_ms']:.4f} ms", flush=True)
        profile(torch, label, fn)
        report(label, stamped(fn, lib2, K2.NAME), names2)
    if args.flush_variant:
        time_flush_variant(torch, dq, cs, root, K2)
    for label, (columns, rows) in hll_freq_times.k6_cases(torch, dq, cs).items():
        if "edge batch, 2" in label or "edge batch, 1" in label:
            continue
        out = torch.empty(rows.shape[0], dtype=torch.int64, device="cuda")
        fn = lambda: K6.freq_keys(columns, rows, out, 0)  # noqa: E731
        t = cs._time_kernel_ms(torch, fn)
        print(f"[time {label}] {t['ms']:.4f} ms (CUDA events, median of {t['reps']}), "
              f"host {t['host_ms']:.4f} ms", flush=True)
        profile(torch, label, fn)
        report(label, stamped(fn, lib6, K6.NAME), names6)
    return 0


def time_flush_variant(torch, dq, cs, root: Path, K2) -> None:
    """CUDA-event ms of each K2 case (L2 flushed) with the tree's flush and
    with :data:`FLUSH_VARIANT`, built from a copy of the source; the
    variant's outputs are held to the kernel's bit for bit. Its scratch
    (every block's registers) replaces the wrapper's workspace."""
    from deequ_tpu_torch.kernels import build

    csrc = root / "deequ_tpu_torch" / "kernels" / "csrc"
    source = flush_variant((csrc / "hll_registers.cu").read_text())
    cu = build.BUILD_DIR / "hll_registers_flush.cu"
    cu.write_text(source)
    so = build.BUILD_DIR / "libhll_registers_flush.so"
    out = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(csrc), "-o", str(so),
                          str(cu)], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed on the flush variant:\n{out.stdout}{out.stderr}")
    variant = ctypes.CDLL(str(so))
    scratch = torch.zeros(1 << 24, dtype=torch.int32, device="cuda")
    load, workspace = K2.build.load, K2.stream_workspace
    for label, (fn, *_) in hll_freq_times.k2_cases(torch, dq, cs).items():
        want = fn()
        kernel = cs._time_kernel_ms(torch, fn)["ms"]
        K2.build.load = lambda n: variant if n == K2.NAME else load(n)
        K2.stream_workspace = lambda *args: scratch
        try:
            got = fn()
            same = all(torch.equal(a.registers if hasattr(a, "registers") else a,
                                   b.registers if hasattr(b, "registers") else b)
                       for a, b in zip(got if isinstance(got, list) else [got],
                                       want if isinstance(want, list) else [want]))
            ms = cs._time_kernel_ms(torch, fn)["ms"]
        finally:
            K2.build.load, K2.stream_workspace = load, workspace
        print(f"[flush {label}] atomics {kernel:.4f} ms, store-and-sweep {ms:.4f} ms "
              f"(CUDA events, L2 flushed); same registers: {same}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
