"""Build the native host-kernel shared library.

``src/host_kernels.cpp`` compiles with the reference's g++ line into
``_build/_host_kernels.so`` (listed in ``.gitignore``) at first use, so a
fresh checkout builds on whatever machine runs it; the library is rebuilt
when the source is newer. Run ``python -m deequ_tpu_torch.native.build``
to build ahead of time. A failed build raises with the compiler's output:
there is no pure-Python stand-in.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

from ..kernels.build import KernelBuildError

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "src" / "host_kernels.cpp"
BUILD_DIR = _DIR / "_build"
#: the C++ compiler; its flags are the reference's (no -ffast-math: the
#: block partials' sums must round as the reference's do)
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")


def library_path() -> Path:
    return BUILD_DIR / "_host_kernels.so"


def build(force: bool = False) -> str:
    """Compile the library if it is missing or older than its source;
    returns its path. Raises ``KernelBuildError`` (a ``RuntimeError``) with
    the compiler's output when the build fails."""
    lib = library_path()
    if not force and lib.exists() and lib.stat().st_mtime >= SOURCE.stat().st_mtime:
        return str(lib)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a unique temporary name renamed into place: concurrent importers never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    cmd = [CXX, *CXX_FLAGS, "-o", tmp, str(SOURCE), "-ldl"]
    try:
        try:
            result = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as exc:
            raise KernelBuildError(f"native build failed: cannot run {CXX}: {exc}") from exc
        if result.returncode != 0:
            raise KernelBuildError(f"native build failed ({' '.join(cmd)}):\n{result.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return str(lib)


if __name__ == "__main__":
    print(f"built {build(force='--force' in sys.argv)}")
