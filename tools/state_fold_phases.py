#!/usr/bin/env python3
"""Time the blocks of K8 ``state_fold``'s launches on one CUDA GPU.

    python3 tools/state_fold_phases.py

Writes a copy of ``deequ_tpu_torch/kernels/csrc/state_fold.cu`` in which
every block of both kernels stamps the GPU's ``%globaltimer`` (ns) when it
starts and when it ends, with its work item's merge kind, builds it with
the package's ``nvcc`` flags into ``deequ_tpu_torch/kernels/_build/`` and
runs it at the shapes ``tools/fold_compact_times.py`` times (every kind at
N = 32; config 2's carry of 32 partials, its 8 shards x 1 butterfly and
its 8 x 4 stacked carry). Prints, per launch, its span (the first block in
to the last block out) and, per merge kind, the blocks, their median and
longest life, and the most blocks alive at once. The package's kernel is
not changed.
"""

from __future__ import annotations

import ctypes
import importlib.util
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
KINDS = ("add_i64", "add_f64", "min", "max", "moments", "comoments", "max_i32")
MAX_BLOCKS = 1 << 20


def stamped_source(src: str) -> str:
    """The source with an entry and an exit stamp in both kernels."""
    head = (
        "__device__ unsigned long long* g_stamps;\n"
        "__device__ __forceinline__ unsigned long long sf_now() {\n"
        "  unsigned long long t;\n"
        "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
        "  return t;\n"
        "}\n")
    src = src.replace('#include "common.cuh"', '#include "common.cuh"\n' + head, 1)
    for kernel in ("state_fold_kernel(const SfItem*", "state_fold_butterfly_kernel(const SfItem*"):
        start = src.index(kernel)
        body = src.index("{", start) + 1
        src = (src[:body] + "\n  const unsigned long long t_entry = sf_now();\n"
               "  const long long blk = (long long)blockIdx.y * gridDim.x + blockIdx.x;\n"
               + src[body:])
        tail = "    default:\n      break;\n  }\n"
        end = src.index(tail, start) + len(tail)
        src = (src[:end] + "  __syncthreads();\n  if (threadIdx.x == 0) {\n"
               "    g_stamps[3 * blk] = t_entry;\n    g_stamps[3 * blk + 1] = sf_now();\n"
               "    g_stamps[3 * blk + 2] = it.kind;\n  }\n" + src[end:])
    src += ("\nextern \"C\" int set_stamps(unsigned long long* p) {\n"
            "  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n")
    return src


def build_stamped():
    from deequ_tpu_torch.kernels import build

    source = stamped_source((build.CSRC / "state_fold.cu").read_text())
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / "state_fold_phases.cu"
    cu.write_text(source)
    lib = build.BUILD_DIR / "libstate_fold_phases.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib),
                    str(cu)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def report(label: str, stamps: np.ndarray) -> None:
    s = stamps.reshape(-1, 3)
    s = s[s[:, 0] > 0]
    span = (s[:, 1].max() - s[:, 0].min()) / 1e3
    print(f"[blocks {label}] {len(s)} blocks, span {span:.2f} us", flush=True)
    for kind in sorted(set(s[:, 2].tolist())):
        k = s[s[:, 2] == kind]
        life = (k[:, 1] - k[:, 0]) / 1e3
        events = sorted([(t, 1) for t in k[:, 0]] + [(t, -1) for t in k[:, 1]])
        alive = most = 0
        for _, step in events:
            alive += step
            most = max(most, alive)
        print(f"  {KINDS[kind]:10s} blocks {len(k):5d}  life median {statistics.median(life):7.2f}"
              f" us, longest {life.max():7.2f} us, at once {most}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("state_fold_phases: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import deequ_tpu_torch as dq
    import deequ_tpu_torch.kernels.state_fold as K
    from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer, fold_layout, pack_states
    from deequ_tpu_torch.analyzers.grouping import DeviceFrequencyScan
    from deequ_tpu_torch.runners.analysis_runner import collect_required_analyzers

    print(f"[card] {cs._nvidia_smi()}", flush=True)
    lib = build_stamped()
    stamps = torch.zeros(3 * MAX_BLOCKS, dtype=torch.int64, device="cuda")
    assert lib.set_stamps(ctypes.c_void_p(stamps.data_ptr())) == 0
    load = K.build.load
    K.build.load = lambda name: lib if name == K.NAME else load(name)  # the stamped copy
    K._lib.cache_clear()

    def run(label, fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        stamps.zero_()
        fn()
        torch.cuda.synchronize()
        report(label, stamps.cpu().numpy())

    month = [states for _, states in cs.fold_groups(dq, cs.MONTH_OF_DAYS, 11)]
    mats, slots, _ = pack_states(month, fold_layout())
    mats = [m.cuda() for m in mats]
    run(f"state_fold N={cs.MONTH_OF_DAYS} every kind", lambda: K.state_fold(*mats, slots))

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
    run(f"state_fold_carry {len(slots)} slots + {cs.CHUNK}",
        lambda: K.state_fold_carry(carry, parts, slots))
    shards = [m[:cs.MESH_SHARDS].contiguous() for m in parts]
    run(f"state_fold_butterfly {cs.MESH_SHARDS} x 1",
        lambda: K.state_fold_butterfly(*shards, slots, cs.MESH_SHARDS))
    carries = [c[None].expand(cs.MESH_SHARDS, -1).contiguous() for c in ingest.carry]
    run(f"state_fold_carry_stacked {cs.MESH_SHARDS} x {cs.CHUNK // cs.MESH_SHARDS}",
        lambda: K.state_fold_carry_stacked(carries, parts, slots))
    return 0


if __name__ == "__main__":
    sys.exit(main())
