"""Two-package namespaces for the port's parity tests: one test body runs
through the JAX package (``deequ_tpu``) and the PyTorch port
(``deequ_tpu_torch``) alike, reading every name through ``m``.

``names`` maps a local name to ``"module.path:attr"`` relative to the
package root (``"service:VerificationService"``), or to ``"module.path"``
for a module. Each namespace carries the keywords that make the two
packages comparable on the CPU: ``svc`` for ``VerificationService`` (the
reference's fleet scheduler off, the port on ``device="cpu"``) and ``dev``
for runs and state builders (nothing for the reference, ``device="cpu"``
for the port).

``reference_isolated`` (autouse in every module that imports it) runs each
test with the reference's self-tuning plane off, as the port's static
knobs are, and clears whatever tuned knob values a test leaves, so that
no test of the pair changes the reference's routing for a later test in
the same process.
"""

from __future__ import annotations

import importlib
from types import SimpleNamespace
from typing import Dict, Tuple

import pytest


def package(root: str, names: Dict[str, str], **extra) -> SimpleNamespace:
    ns = SimpleNamespace(name="jax" if root == "deequ_tpu" else "torch", root=root, **extra)
    for local, spec in names.items():
        path, _, attr = spec.partition(":")
        module = importlib.import_module(f"{root}.{path}" if path else root)
        setattr(ns, local, getattr(module, attr) if attr else module)
    return ns


def pair(names: Dict[str, str]) -> Tuple[SimpleNamespace, SimpleNamespace]:
    """The reference's namespace and the port's, in that order."""
    ref = package("deequ_tpu", names, svc={"fleet": False}, dev={})
    port = package("deequ_tpu_torch", names, svc={"device": "cpu"}, dev={"device": "cpu"})
    return ref, port


@pytest.fixture(autouse=True)
def reference_isolated(monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_AUTOTUNE", "0")
    yield
    from deequ_tpu.tuning import knobs

    knobs.clear_tuned()
