"""The public import surface of the PyTorch/CUDA port against the JAX
reference: every public name of every module of ``deequ_tpu`` resolves on
the same-named module of ``deequ_tpu_torch``, and every ``DEEQU_TPU_*``
knob the reference reads the port reads too.

A module's public names are its ``__all__`` where it has one, else its
non-underscore names bound to a class or function whose ``__module__``
starts with ``deequ_tpu``. A name may stay out of the port only when the
reference's object is itself a JAX construct: :data:`JAX_ONLY` (names)
and :data:`JAX_KNOBS` (env knobs) are that exception table, each row with
its reason and the port's counterpart, and this file is the one place
that lists them. ``DEEQU_TPU_NO_X64`` (32-bit accumulators) is not a JAX
construct and not in the table: it is still to be ported.
"""

from __future__ import annotations

import importlib
import inspect
import pkgutil
import re
from pathlib import Path

import pytest

import deequ_tpu
import deequ_tpu_torch

REPO = Path(__file__).resolve().parent.parent

#: (reference module, name) -> (why it is a JAX construct, the port's counterpart
#: as "module:attribute")
JAX_ONLY = {
    ("deequ_tpu.parallel", "replicated"): (
        "returns a jax.sharding.NamedSharding that replicates states over a mesh",
        "deequ_tpu_torch.parallel:Mesh"),
    ("deequ_tpu.parallel", "row_sharded"): (
        "returns a jax.sharding.NamedSharding that splits rows over a mesh",
        "deequ_tpu_torch.parallel:shard_features"),
    ("deequ_tpu.ops.hashing", "splitmix64_jnp"): (
        "jax.numpy SplitMix64 for device group keys",
        "deequ_tpu_torch.ops.hashing:splitmix64_torch"),
    ("deequ_tpu.ops.hashing", "xxhash64_u64_jnp"): (
        "jax.numpy xxHash64 of 8-byte keys for device group keys",
        "deequ_tpu_torch.ops.hashing:xxhash64_u64_torch"),
    ("deequ_tpu.runners.engine", "PackedScanProgram"): (
        "the jitted per-batch XLA program over a packed carry",
        "deequ_tpu_torch.runners.engine:BundledScanProgram"),
    ("deequ_tpu.runners.engine", "make_flagged_ingest_body"): (
        "the lax.scan body of the host tier's jitted ingest program",
        "deequ_tpu_torch.runners.engine:HostIngest"),
    ("deequ_tpu.analyzers.states", "to_host"): (
        "jax.device_get over a state pytree",
        "deequ_tpu_torch.runners.engine:fetch_states"),
    ("deequ_tpu.ops", "chunked_key_fold"): (
        "a lax.scan fold over fixed key chunks, sized for TPU VMEM",
        "deequ_tpu_torch.kernels.freq_keys:freq_keys"),
    ("deequ_tpu.config", "scan_bundle_size"): (
        "reads DEEQU_TPU_SCAN_BUNDLE, the bundling of XLA scan programs",
        "deequ_tpu_torch.runners.engine:BundledScanProgram"),
    ("deequ_tpu.config", "slim_fetch_enabled"): (
        "reads DEEQU_TPU_SLIM_FETCH, the slimming of the JAX state fetch",
        "deequ_tpu_torch.runners.engine:fetch_states"),
}

#: env knobs of the reference that drive XLA -> (reason, the port's counterpart)
JAX_KNOBS = {
    "DEEQU_TPU_NO_COMPILE_CACHE": (
        "turns off XLA's persistent compile cache",
        "deequ_tpu_torch.kernels.build:build"),
    "DEEQU_TPU_SCAN_BUNDLE": (
        "bundles analyzers into XLA scan programs",
        "deequ_tpu_torch.runners.engine:BundledScanProgram"),
    "DEEQU_TPU_SLIM_FETCH": (
        "slims the JAX state fetch",
        "deequ_tpu_torch.runners.engine:fetch_states"),
}

#: knobs still to be ported (not JAX constructs, so not in the table): none
STILL_TO_PORT: set = set()

_JAX_SOURCE = re.compile(r"\bjax\b|\bjnp\.|\blax\.|NamedSharding|\bXLA\b|\bjit\b")


def _modules(package):
    yield package.__name__
    for info in pkgutil.walk_packages(package.__path__, package.__name__ + "."):
        if info.name.endswith("_host_kernels"):  # the native library's build output
            continue
        yield info.name


def _public(module) -> list:
    if hasattr(module, "__all__"):
        return list(module.__all__)
    return sorted(
        name for name, value in vars(module).items()
        if not name.startswith("_") and (inspect.isclass(value) or inspect.isfunction(value))
        and (getattr(value, "__module__", None) or "").startswith("deequ_tpu")
    )


REFERENCE_MODULES = sorted(_modules(deequ_tpu))


def _port_name(name: str) -> str:
    return "deequ_tpu_torch" + name[len("deequ_tpu"):]


def _resolve(spec: str):
    module, _, attr = spec.partition(":")
    return getattr(importlib.import_module(module), attr)


@pytest.mark.parametrize("name", REFERENCE_MODULES)
def test_every_public_name_of_the_reference_resolves_on_the_port(name):
    reference = importlib.import_module(name)
    port = importlib.import_module(_port_name(name))
    missing = [n for n in _public(reference)
               if not hasattr(port, n) and (name, n) not in JAX_ONLY]
    assert missing == [], (name, missing)


def test_the_walk_covers_every_module():
    port_modules = set(_modules(deequ_tpu_torch))
    assert {_port_name(n) for n in REFERENCE_MODULES} <= port_modules
    assert len(REFERENCE_MODULES) >= 90


@pytest.mark.parametrize("row", sorted(JAX_ONLY), ids=lambda r: f"{r[0]}.{r[1]}")
def test_every_exception_still_names_a_missing_jax_object(row):
    module, name = row
    reason, counterpart = JAX_ONLY[row]
    obj = getattr(importlib.import_module(module), name)
    assert not hasattr(importlib.import_module(_port_name(module)), name)
    source = inspect.getsource(obj)
    knobs = set(re.findall(r"DEEQU_TPU_\w+", reason))
    read = {getattr(importlib.import_module(module), v, None)
            for v in re.findall(r"\b([A-Z_]+_ENV)\b", source)}
    assert _JAX_SOURCE.search(source) or (knobs and knobs <= set(JAX_KNOBS) and knobs <= read), row
    assert reason and _resolve(counterpart) is not None


def _knobs(root: Path) -> set:
    found = set()
    for path in root.rglob("*.py"):
        found |= set(re.findall(r"\"(DEEQU_TPU_[A-Z0-9_]+)\"", path.read_text()))
    return found


def test_every_knob_of_the_reference_is_read_by_the_port():
    reference = _knobs(REPO / "deequ_tpu")
    port = _knobs(REPO / "deequ_tpu_torch")
    assert reference - port == set(JAX_KNOBS) | STILL_TO_PORT
    for knob, (reason, counterpart) in JAX_KNOBS.items():
        assert knob in reference and reason and _resolve(counterpart) is not None


OPERATOR_SWITCHES = [
    "DEEQU_TPU_DEVICE_FEATURE_CACHE", "DEEQU_TPU_HOST_TIER_WORKERS", "DEEQU_TPU_NO_NATIVE",
    "DEEQU_TPU_ADAPTIVE_DICT_ENCODE", "DEEQU_TPU_PROFILE_DIR", "DEEQU_TPU_NO_X64",
]


@pytest.mark.parametrize("knob", sorted(set(OPERATOR_SWITCHES) | _knobs(REPO / "deequ_tpu_torch")))
def test_the_operator_switches_are_documented_with_the_others(knob):
    """Every ``DEEQU_TPU_*`` knob the port reads is named in its ``config.py``,
    the one place an operator finds every switch (the reference's rule)."""
    assert knob in (REPO / "deequ_tpu_torch" / "config.py").read_text()


def test_the_reference_top_level_imports_work_on_the_port():
    from deequ_tpu_torch import (  # noqa: F401
        DoubleMetric,
        InMemoryMetricsRepository,
        ResultKey,
        __version__,
    )

    assert __version__ == deequ_tpu.__version__
    assert set(deequ_tpu.__all__) <= set(deequ_tpu_torch.__all__)
    for name in deequ_tpu_torch.__all__:
        assert hasattr(deequ_tpu_torch, name), name


#: (reference module, name, subsystem module) of every reference module's lazy
#: ``_SUBSYSTEM_EXCEPTIONS`` re-export table (PEP 562): names a namespace walk
#: never sees, since they resolve through the module's ``__getattr__``
LAZY_EXCEPTIONS = sorted(
    (name, exc, target)
    for name in REFERENCE_MODULES
    for exc, target in getattr(importlib.import_module(name), "_SUBSYSTEM_EXCEPTIONS", {}).items()
)


def test_the_lazy_exception_tables_are_found():
    assert len(LAZY_EXCEPTIONS) >= 7
    assert {m for m, _, _ in LAZY_EXCEPTIONS} == {"deequ_tpu.exceptions"}


@pytest.mark.parametrize("row", LAZY_EXCEPTIONS, ids=lambda r: f"{r[0]}.{r[1]}")
def test_every_lazy_exception_of_the_reference_resolves_on_the_port(row):
    module, name, target = row
    port = importlib.import_module(_port_name(module))
    got = getattr(port, name)
    assert got is getattr(importlib.import_module(_port_name(target)), name)
    assert inspect.isclass(got) and issubclass(got, BaseException)
    assert port._SUBSYSTEM_EXCEPTIONS[name] == _port_name(target)


@pytest.mark.parametrize("module", sorted({m for m, _, _ in LAZY_EXCEPTIONS}))
def test_an_unknown_name_still_raises_attribute_error(module):
    port = importlib.import_module(_port_name(module))
    with pytest.raises(AttributeError):
        getattr(port, "NoSuchSubsystemError")
    assert not hasattr(port, "NoSuchSubsystemError")
