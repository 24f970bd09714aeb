"""The PyTorch/CUDA port stands alone: ``deequ_tpu_torch``, ``chip_smoke.py``
and the port's tools (``tools/torch_*.py``) import neither JAX nor the JAX
package ``deequ_tpu`` (nor the reference's test harness), and
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
FORBIDDEN = ("jax", "jaxlib", "flax", "deequ_tpu", "cluster_harness")
TOOLS = sorted(p.relative_to(REPO).as_posix() for p in (REPO / "tools").glob("torch_*.py"))


def _env_without_cuda():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    code = (
        "import sys, deequ_tpu_torch, deequ_tpu_torch.convert, deequ_tpu_torch.kernels.build\n"
        "import deequ_tpu_torch.service, deequ_tpu_torch.service.coalesce\n"
        "import deequ_tpu_torch.observability, deequ_tpu_torch.reliability\n"
        "import deequ_tpu_torch.tuning, deequ_tpu_torch.ingest, deequ_tpu_torch.utils\n"
        "import deequ_tpu_torch.parallel, deequ_tpu_torch.parallel.dcn\n"
        "import deequ_tpu_torch.suggestions, deequ_tpu_torch.suggestions.rules\n"
        "import deequ_tpu_torch.reliability.checkpoint, deequ_tpu_torch.runners.incremental\n"
        "import deequ_tpu_torch.repository.partition_store, deequ_tpu_torch.repository.lease\n"
        "import deequ_tpu_torch.repository.partitioned\n"
        "import deequ_tpu_torch.anomalydetection.seasonal, deequ_tpu_torch.schema\n"
        "import deequ_tpu_torch.applicability, deequ_tpu_torch.interop\n"
        "import deequ_tpu_torch.analyzers.distance, deequ_tpu_torch.ingest.endpoint\n"
        "import deequ_tpu_torch.ingest.arrow_stream, deequ_tpu_torch.ingest.rowgate\n"
        "import deequ_tpu_torch.service.catalog\n"
        "import deequ_tpu_torch.service.fleetwatch, deequ_tpu_torch.service.statusz\n"
        "import deequ_tpu_torch.cluster, deequ_tpu_torch.cluster.front\n"
        "import tools.torch_cluster_soak, tools.torch_chaos_soak, tools.torch_tuning_report\n"
        "import tools.torch_trace_summarize\n"
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
    sorted(p.relative_to(REPO).as_posix() for p in PACKAGE.rglob("*.py")) + ["chip_smoke.py"]
    + TOOLS,
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


@pytest.mark.parametrize("tool", [
    ["tools.torch_chaos_soak", "--no-cluster-drill", "--jobs", "1"],
    ["tools.torch_tuning_report"],
    ["tools.torch_tuning_report", "--bench-point", "--sessions", "1"],
], ids=["chaos_soak", "tuning_report", "bench_point"])
def test_tools_run_on_the_card_by_default(tool):
    """The port's tools default to ``--device cuda``: without a card they
    raise, and report no result."""
    out = subprocess.run(
        [sys.executable, "-m", *tool], cwd=REPO, capture_output=True, text=True,
        timeout=120, env=_env_without_cuda(),
    )
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr
    assert '"ok"' not in out.stdout


def _tenant_plane_entry_points():
    """Every entry point of the tenant plane that builds or holds state on a
    device, called with no ``device``."""
    from deequ_tpu_torch import interop
    from deequ_tpu_torch.applicability import Applicability
    from deequ_tpu_torch.checks import Check, CheckLevel
    from deequ_tpu_torch.data import ColumnKind, ColumnSchema, Schema
    from deequ_tpu_torch.ops.kll import kll_init
    from deequ_tpu_torch.service import VerificationService
    import torch

    schema = Schema([ColumnSchema("x", ColumnKind.FRACTIONAL)])
    check = Check(CheckLevel.ERROR, "c").has_size(lambda n: n > 0)
    hll = interop.write_jvm_hll_state_blob(
        type("S", (), {"registers": torch.zeros(512, dtype=torch.int32)})())
    kll = interop.write_jvm_kll_state_blob(kll_init(16))
    return {
        "is_applicable_check": lambda: Applicability.is_applicable_check(check, schema),
        "is_applicable_analyzers": lambda: Applicability.is_applicable_analyzers([], schema),
        "read_jvm_hll_state_blob": lambda: interop.read_jvm_hll_state_blob(hll),
        "read_jvm_kll_state_blob": lambda: interop.read_jvm_kll_state_blob(kll),
        "VerificationService(catalog=)": lambda: VerificationService(catalog="unused-root"),
    }


@pytest.mark.parametrize("entry", sorted(_tenant_plane_entry_points()))
def test_tenant_plane_entry_points_run_on_the_card_by_default(entry):
    """With no ``device`` they resolve ``cuda``: without a card they raise
    (no quiet CPU run), and with ``device="cpu"`` they run."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _tenant_plane_entry_points()[entry]()
