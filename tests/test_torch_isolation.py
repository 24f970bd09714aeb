"""The PyTorch/CUDA port stands alone: ``deequ_tpu_torch`` and
``chip_smoke.py`` import neither JAX nor the JAX package ``deequ_tpu``, and
``chip_smoke.py`` refuses to report a result without a CUDA device or
without the package beside it."""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "deequ_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "deequ_tpu")


def _env_without_cuda():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    code = (
        "import sys, deequ_tpu_torch, deequ_tpu_torch.convert, deequ_tpu_torch.kernels.build\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120, check=True,
    )
    assert out.stdout.strip() == ""


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path",
    sorted(p.relative_to(REPO).as_posix() for p in PACKAGE.rglob("*.py")) + ["chip_smoke.py"],
)
def test_no_source_of_the_port_imports_jax_or_the_reference(path):
    roots = set(_imported_roots(REPO / path))
    assert not roots & set(FORBIDDEN), (path, roots & set(FORBIDDEN))


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True,
        timeout=120, env=_env_without_cuda(),
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _env_without_cuda()
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env=env,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
