#!/usr/bin/env python3
"""Time the phases of K1 ``scan_reduce``'s and K3 ``dict_code_counts``'s
blocks on one CUDA GPU.

    python3 tools/scan_reduce_phases.py [--root DIR] [--split]

Writes a copy of ``csrc/scan_reduce.cu`` and ``csrc/dict_code_counts.cu``
of the tree at ``DIR`` (default: this checkout) in which thread 0 of every
block (K1's current kernel: lane 0 of every warp) stamps ``clock64()`` at
the boundaries of each phase, builds them with the package's ``nvcc``
flags into ``deequ_tpu_torch/kernels/_build/`` and runs them at the shapes
``tools/scan_count_times.py`` times: config 2's 16 slots, the co-moment
slot and phase 8 (b)'s 16 sessions x 4,096 rows (K1); config 2's
``cat_large`` on its Zipf(1.3) codes and on the same 50,000 codes spread
evenly, and ``cat_small`` (K3). Cycles turn into microseconds at the SM
clock ``nvidia-smi`` reads after the run. Prints, per
launch, the median and longest cycles of each phase by slot kind over the
blocks, and ``torch.profiler``'s device time of each kernel of a call (K1's
block launch and its fold launch). The stamps add a barrier at each
boundary. The package's kernels are not changed.

K1's phases, where the tree's kernel has them: ``stage`` (the wait for a
chunk's distinct arrays to land in shared memory, with the next chunk's
copies issued), per slot ``pass 1`` (its loads and
first pass), ``reduce 1`` (the block or warp reduction and mean), ``pass
2`` (the second pass of a moments or co-moment slot), ``write`` (the
reduction of the second pass and the partial's write). K3's: ``zero`` (the
shared histogram), ``rows`` (the row loop), ``flush`` (the nonzero bins
into device memory).

With ``--split`` (the current K1 only) it also builds two more copies of
K1, one whose blocks stage their chunk and reduce nothing and one whose
blocks reduce an unstaged chunk, and prints the CUDA-event ms of a call
(L2 flushed, as ``chip_smoke._time_ms``) with each beside the kernel's:
how much of a launch is its loads, how much its reductions, and how far
the two overlap. Their outputs are not checked.

The current K1's fold launch is stamped too: the life of each of its
blocks (one a slot and session), the time a fold of one slot takes.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE / "tools"))
import scan_count_times  # noqa: E402

KINDS = ("counts", "moments", "classes", "co-moments")
#: stamps a slot (or, for K3, a block) keeps
STAMPS = 6
SLOT_STAMPS = ("pass 1", "reduce 1", "pass 2", "write")
#: blocks (the parent's K1, K3) or chunks (K1) a stamped launch may have
MAX_BLOCKS = 8192
#: stamp words a block or chunk keeps: 64 slots x STAMPS; the stage's two
#: after all of them
BLOCK_WORDS = 64 * STAMPS
STAGE_AT = MAX_BLOCKS * BLOCK_WORDS
#: the fold blocks' two stamps each, after the stages'
FOLD_AT = STAGE_AT + 2 * MAX_BLOCKS

STAMP_HEAD = "__device__ long long* g_stamps;\n"


def _insert(src: str, marker: str, text: str, after: bool = False, start: int = 0) -> str:
    at = src.index(marker, start)
    if after:
        at += len(marker)
    return src[:at] + text + src[at:]


def stamp_k1_parent(src: str) -> str:
    """The block-per-chunk kernel of PRs 1-9: a block walks the slots, each
    slot a row loop, a block reduction and (moments) a second loop."""
    head = STAMP_HEAD + (
        "#define PH_REC(s) (g_stamps + (((long long)blockIdx.y * gridDim.x + blockIdx.x) * "
        "SR_MAX_SLOTS + (s)) * 6)\n"
        "#define PH_STAMP(s, k) do { __syncthreads(); if (threadIdx.x == 0) PH_REC(s)[k] = "
        "clock64(); } while (0)\n")
    src = src.replace('#include "common.cuh"', '#include "common.cuh"\n' + head, 1)
    k = src.index("scan_reduce_blocks(const SrTable table")
    src = _insert(src, "    if (slot.kind == SR_KIND_CLASSES) {",
                  "    PH_STAMP(s, 0);\n",
                  start=k)
    # pass 1 ends where the warp reduction starts
    src = _insert(src, "    for (int off = 16; off > 0; off >>= 1) {\n      const SrAcc o",
                  "    PH_STAMP(s, 1);\n", start=k)
    src = _insert(src, "    const double mean = block_mean;\n", "    PH_STAMP(s, 2);\n",
                  after=True, start=k)
    src = _insert(src, "      for (int off = 16; off > 0; off >>= 1) {\n        m2 +=",
                  "      PH_STAMP(s, 3);\n", start=k)
    src = _insert(src, "    __syncthreads();  // warp_acc and block_mean are rewritten",
                  "    PH_STAMP(s, 4);\n", start=k)
    # class-count and co-moment slots: their whole slot as pass 1
    for call in ("      sr_class_counts(slot, rows", "      sr_comoments(slot, rows"):
        at = src.index(call, k)
        end = src.index(";\n", at) + 2
        src = src[:end] + "      PH_STAMP(s, 1);\n" + src[end:]
    return src


def stamp_k1_current(src: str) -> str:
    """The staged kernel: a resident grid walks the chunks, staging the
    next while its warps reduce the current one; lane 0 of a warp stamps its
    slots' phases, thread 0 the wait for a chunk's stage (records by chunk)."""
    head = STAMP_HEAD + (
        "#define PH_REC(t, s) (g_stamps + ((long long)(t) * SR_MAX_SLOTS + (s)) * 6)\n"
        "#define PH_WSTAMP(s, k) do { __syncwarp(); if ((threadIdx.x & 31) == 0) "
        "PH_REC(ch.w * ch.n_chunks + ch.c, s)[k] = clock64(); } while (0)\n")
    src = src.replace('#include "common.cuh"', '#include "common.cuh"\n' + head, 1)
    for marker, k in (("// PHASE pass1", 0), ("// PHASE reduce1", 1), ("// PHASE pass2", 2),
                      ("// PHASE write", 3), ("// PHASE done", 4)):
        src = src.replace(marker, f"PH_WSTAMP(s, {k});")
    # the wait for a chunk's stage, after every chunk's slot records
    for marker, k in (("// PHASE stage0", 0), ("// PHASE stage1", 1)):
        src = src.replace(marker, f"if (threadIdx.x == 0) g_stamps[{STAGE_AT}LL + 2 * t + {k}] "
                          "= clock64();")
    # a fold block's life (thread 0 starts it and writes the outputs last)
    for marker, k in (("// PHASE fold0", 0), ("// PHASE fold1", 1)):
        src = src.replace(marker, f"if (threadIdx.x == 0) g_stamps[{FOLD_AT}LL + 2 * o + {k}] "
                          "= clock64();")
    return src


def stamp_k3(src: str) -> str:
    """K3's shared-histogram kernel: its zero, row loop and flush."""
    head = STAMP_HEAD + (
        "#define PH_KSTAMP(k) do { __syncthreads(); if (threadIdx.x == 0) "
        "g_stamps[(long long)blockIdx.x * 6 + (k)] = clock64(); } "
        "while (0)\n")
    src = src.replace('#include "common.cuh"', '#include "common.cuh"\n' + head, 1)
    if "// PHASE" in src:
        for marker, k in (("// PHASE start", 0), ("// PHASE zeroed", 1), ("// PHASE rows", 2),
                          ("// PHASE flushed", 3)):
            src = src.replace(marker, f"PH_KSTAMP({k});")
        return src
    k = src.index("dict_code_counts_shared(const int*")
    src = _insert(src, "  for (int c = threadIdx.x; c < k; c += blockDim.x) hist[c] = 0u;",
                  "  PH_KSTAMP(0);\n", start=k)
    src = _insert(src, "  unsigned long long local_rows = 0ull;", "  PH_KSTAMP(1);\n", start=k)
    src = _insert(src, "  dcc_add_rows(local_rows, num_rows);\n  __syncthreads();\n",
                  "  PH_KSTAMP(2);\n", after=True, start=k)
    end = src.index("\n}\n", k)
    return src[:end] + "\n  PH_KSTAMP(3);" + src[end:]


#: K1's staging and its slot loop in the current source, for --split
SPLIT_STAGE = "  sr_stage_chunk<K>(table, n, n_chunks, t, sr_stage);\n"
SPLIT_LOOP = "  for (int s = threadIdx.x >> 5; s < table.n_slots; s += SR_WARPS) {\n"


def split_sources(src: str) -> dict:
    """K1's source with its slot loop skipped ("stage only") and with its
    staging skipped ("reduce only"); the guard reads a kernel argument, so
    the compiler keeps the other half as it is."""
    if SPLIT_STAGE not in src or SPLIT_LOOP not in src:
        return {}
    return {"stage only": src.replace(SPLIT_LOOP, "  if (n < 0)\n" + SPLIT_LOOP),
            "reduce only": src.replace(SPLIT_STAGE, "  if (n < 0)" + SPLIT_STAGE[1:])}


def build_stamped(root: Path, name: str, stamper, tag: str = "phases"):
    from deequ_tpu_torch.kernels import build

    csrc = root / "deequ_tpu_torch" / "kernels" / "csrc"
    source = stamper((csrc / f"{name}.cu").read_text())
    if "g_stamps" not in source:
        source = STAMP_HEAD + source
    source += ("\nextern \"C\" int set_stamps(long long* p) {\n"
               "  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / f"{name}_{tag}.cu"
    cu.write_text(source)
    lib = build.BUILD_DIR / f"lib{name}_{tag}.so"
    out = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib),
                          str(cu)], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed on the stamped {name}.cu:\n{out.stdout}{out.stderr}")
    return ctypes.CDLL(str(lib))


def ns_per_cycle() -> float:
    """Nanoseconds a cycle at the SM clock ``nvidia-smi`` reads just after a
    run (the card may run below its maximum clock under its power limit)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return 1e3 / float(out.stdout.split()[0])


def _line(name: str, cycles: np.ndarray, ns_per_cycle: float) -> str:
    med = statistics.median(cycles.tolist())
    return (f"  {name:22s} median {med:9.0f} cycles ({med * ns_per_cycle / 1e3:7.3f} us), "
            f"longest {cycles.max():9.0f} ({cycles.max() * ns_per_cycle / 1e3:7.3f} us)")


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(HERE))
    parser.add_argument("--split", action="store_true",
                        help="also time K1 staging alone and reducing alone")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("scan_reduce_phases: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    cs = scan_count_times.chip_smoke()
    import deequ_tpu_torch as dq
    import deequ_tpu_torch.kernels.dict_code_counts as K3
    import deequ_tpu_torch.kernels.scan_reduce as K1

    assert Path(dq.__file__).resolve().is_relative_to(root)
    print(f"[card] {cs._nvidia_smi()}", flush=True)
    src = (root / "deequ_tpu_torch" / "kernels" / "csrc" / "scan_reduce.cu").read_text()
    parent = "scan_reduce_blocks(const SrTable table, int n_slots" in src
    lib1 = build_stamped(root, "scan_reduce", stamp_k1_parent if parent else stamp_k1_current)
    lib3 = build_stamped(root, "dict_code_counts", stamp_k3)
    stamps = torch.zeros(FOLD_AT + 2 * MAX_BLOCKS, dtype=torch.int64, device="cuda")
    for lib in (lib1, lib3):
        assert lib.set_stamps(ctypes.c_void_p(stamps.data_ptr())) == 0
    load = K1.build.load

    def stamped(fn, lib, name):
        """Run ``fn`` once on the package's kernel (for the profile), then
        once on the stamped copy, and return the stamps."""
        K1.build.load = lambda n: lib if n == name else load(n)
        try:
            for attr in ("_deequ_bound",):
                if hasattr(lib, attr):
                    delattr(lib, attr)
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            stamps.zero_()
            fn()
            torch.cuda.synchronize()
            return stamps.cpu().numpy()
        finally:
            K1.build.load = load

    for label, (entry, slots, rows) in scan_count_times.k1_cases(torch, dq, cs).items():
        if "profile" in label or "65536" in label:
            continue
        fn = K1.scan_reduce if entry == "one" else K1.scan_reduce_stacked
        profile(torch, label, lambda: fn(slots, rows))
        rec = stamped(lambda: fn(slots, rows), lib1, K1.NAME)
        per = rec[:STAGE_AT].reshape(MAX_BLOCKS, 64, STAMPS)
        live = np.nonzero(per[:, :, :5].max(axis=(1, 2)) > 0)[0]
        stage = rec[STAGE_AT:FOLD_AT].reshape(MAX_BLOCKS, 2)
        ns = ns_per_cycle()
        _k1_print(label, slots, per, live, None if parent else stage, ns)
        fold = rec[FOLD_AT:].reshape(MAX_BLOCKS, 2)
        fold = fold[(fold[:, 0] > 0) & (fold[:, 1] > 0)]
        if len(fold):
            print(_line(f"fold block ({len(fold)})", fold[:, 1] - fold[:, 0], ns), flush=True)
    if args.split:
        variants = split_sources(src)
        if not variants:
            print("[split] the tree's K1 has no staging to split off", flush=True)
        libs = {"kernel": None}
        for tag, text in variants.items():
            libs[tag] = build_stamped(root, "scan_reduce", lambda _, text=text: text,
                                      tag=tag.replace(" ", "_"))
        for label, (entry, slots, rows) in scan_count_times.k1_cases(torch, dq, cs).items():
            fn = K1.scan_reduce if entry == "one" else K1.scan_reduce_stacked
            times = []
            for tag, lib in libs.items():
                K1.build.load = load if lib is None else (
                    lambda n, lib=lib: lib if n == K1.NAME else load(n))
                try:
                    times.append(f"{tag} {cs._time_kernel_ms(torch, lambda: fn(slots, rows))['ms']:.4f}")
                finally:
                    K1.build.load = load
            print(f"[split {label}] ms: " + ", ".join(times), flush=True)
    for label, (codes, rows, present, k) in scan_count_times.k3_cases(torch, cs).items():
        fn = lambda: K3.dict_code_counts(codes, rows, present, k)  # noqa: E731
        t = cs._time_kernel_ms(torch, fn)
        print(f"[time {label}] {t['ms']:.4f} ms (CUDA events, median of {t['reps']})",
              flush=True)
        profile(torch, label, fn)
        rec = stamped(fn, lib3, K3.NAME)[: MAX_BLOCKS * STAMPS].reshape(MAX_BLOCKS, STAMPS)
        rec = rec[rec[:, 0] > 0]
        if not len(rec):
            print(f"[phases {label}] the launch took no stamped (shared-histogram) path",
                  flush=True)
            continue
        print(f"[phases {label}] {len(rec)} blocks", flush=True)
        ns = ns_per_cycle()
        for p, name in enumerate(("zero", "rows", "flush")):
            print(_line(name, rec[:, p + 1] - rec[:, p], ns), flush=True)
    return 0


def _k1_print(label, slots, per, live, stage, ns) -> None:
    print(f"[phases {label}] {len(live)} blocks, {len(slots)} slots "
          f"({', '.join(f'{sum(s.kind == k for s in slots)} {KINDS[k]}' for k in range(4))})",
          flush=True)
    if stage is not None:
        st = stage[live]
        ok = st[:, 0] > 0
        if ok.any():
            print(_line("stage", st[ok, 1] - st[ok, 0], ns), flush=True)
    rec = per[live]
    for kind in sorted({s.kind for s in slots}):
        idx = [i for i, s in enumerate(slots) if s.kind == kind]
        print(f"  {KINDS[kind]} slots ({len(idx)}), cycles a slot:", flush=True)
        for p, name in enumerate(SLOT_STAMPS):
            a, b = rec[:, idx, p].ravel(), rec[:, idx, p + 1].ravel()
            ok = (a > 0) & (b > 0)
            if ok.any():
                print(_line(name, b[ok] - a[ok], ns), flush=True)
    first = rec[:, :len(slots), 0]
    last = rec[:, :len(slots), :5].max(axis=2)
    ok = (first.min(axis=1) > 0)
    if ok.any():
        print(_line("chunk, every slot", last[ok].max(axis=1) - first[ok].min(axis=1), ns),
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
