"""Build and load the CUDA kernels of ``kernels/csrc``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with :mod:`ctypes`. The build runs at
first use into ``kernels/_build`` (listed in ``.gitignore``), so a fresh
checkout builds on the machine with the card; a library is rebuilt when
its source or ``common.cuh`` is newer. :func:`build` starts one ``nvcc``
per stale source, all at once.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = (
    "scan_reduce", "hll_registers", "dict_code_counts", "kll_sample", "kll_compact",
    "freq_keys", "freq_compact", "state_fold",
)

#: sm_90a: Hopper with its architecture-specific instructions
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: serialises builds: threads that find the same sources stale wait for
#: one build instead of starting an nvcc each
_BUILD_LOCK = threading.Lock()
#: set once :func:`ensure_built` has found every kernel built
_ALL_BUILT = threading.Event()


class KernelError(RuntimeError):
    """A fault of this package's own kernels, not of the card or the data:
    the reliability layer (``reliability.isolation``) never fails it over
    to the host tier nor bisects it into ``Failure`` metrics; it raises out
    of the run, so no fallback hides a kernel."""


class KernelBuildError(KernelError):
    """A kernel (or the native host library) failed to build or load."""


class KernelLaunchError(KernelError):
    """A kernel failed to launch (its C entry point reported a CUDA error),
    or its wrapper and its library disagree."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError(
        "nvcc not found: the CUDA kernels of deequ_tpu_torch build on a "
        "machine with the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    newest = max(
        (CSRC / f"{name}.cu").stat().st_mtime,
        (CSRC / "common.cuh").stat().st_mtime,
    )
    return lib.stat().st_mtime < newest


def build(names: Iterable[str] = SOURCES, force: bool = False) -> Dict[str, str]:
    """Compile the named kernels (the stale ones, or all with ``force``),
    one ``nvcc`` process per source, started together. Returns each built
    library's ptxas report; raises with the compiler's output when a
    build fails."""
    with _BUILD_LOCK:
        return _build([n for n in names if force or _stale(n)])


def ensure_built() -> None:
    """Build every stale kernel, once a process: the engine calls it before
    a guarded pass's clock starts, so ``nvcc`` at first use is never taken
    for a stall (later calls cost one flag read)."""
    if not _ALL_BUILT.is_set():
        build()
        _ALL_BUILT.set()


def _build(todo) -> Dict[str, str]:
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        # a unique temporary name, renamed into place when done: concurrent
        # builds (test workers) never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    reports: Dict[str, str] = {}
    failures = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            Path(tmp).unlink(missing_ok=True)
            continue
        os.replace(tmp, library_path(name))
        reports[name] = out
    if failures:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failures))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            try:
                lib = ctypes.CDLL(str(library_path(name)))
            except OSError as exc:
                raise KernelBuildError(f"cannot load kernel library {name}: {exc}") from exc
            _LIBS[name] = lib
        return lib
