"""Deterministic fault injection at named service sites (copied from the
reference's ``deequ_tpu/reliability/faults.py``, cut to the sites and
kinds this package has).

Recovery claims are only worth anything if they are EXERCISED, and real
device faults cannot be provoked on demand. This module plants cheap
``fault_point(site, tag)`` probes where faults occur and lets tests arm
them with a seeded, fully deterministic plan: the same plan + seed
produces the same faults at the same sites in the same order, every run.

Arming is explicit (``inject(...)`` context manager / ``install``), or
environment-driven for whole-process runs: ``DEEQU_TPU_FAULTS`` holds a
JSON list of spec dicts and ``DEEQU_TPU_FAULT_SEED`` the rng seed. When
nothing is armed, a fault point is one global read and a ``None`` check.

Instrumented sites (grep ``fault_point(`` for ground truth):

===================  ========================================================
site                 fires
===================  ========================================================
``worker``           at job pickup in the service scheduler, tag = worker id
``stream_fold``      before a streaming session's fold mutates state
``coalesced_fold``   before a coalesced fast/device fold executes a claimed
                     group, tag = session key
===================  ========================================================

The engine's sites (device dispatch, compile, host partials, state fetch),
the mesh, ingest and cluster kinds belong to the reliability wrapper, the
watchdog and the planes the port has not taken yet (ROADMAP A3, A5, A6).
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..exceptions import (
    AnalyzerFaultException,
    CorruptStateError,
    DeviceFailureException,
    DeviceOOMException,
    PoisonedBatchException,
    SchemaDriftError,
)

#: env vars arming a process-wide plan (JSON spec list / int seed)
FAULTS_ENV = "DEEQU_TPU_FAULTS"
FAULT_SEED_ENV = "DEEQU_TPU_FAULT_SEED"


class InjectedInterrupt(KeyboardInterrupt):
    """Simulated hard interruption (operator ^C / preemption). Deliberately
    a ``KeyboardInterrupt`` subclass: every recovery layer catches only
    ``Exception``, so this rides OUT of the engine exactly like a real
    SIGINT — the resumable-ingest tests use it to kill a run mid-fold."""


class WorkerCrash(RuntimeError):
    """Simulated death of a service worker mid-job (the Spark executor-loss
    analog). Raised inside the job attempt, it exercises the scheduler's
    defense-in-depth path: the job must terminate with a typed error or be
    retried, never hang its handle."""


#: fault kind -> exception factory (tag-aware where the type carries one)
def _make_error(kind: str, site: str, tag: str) -> BaseException:
    note = f"injected fault at site={site!r} tag={tag!r}"
    if kind == "device":
        return DeviceFailureException(note)
    if kind == "oom":
        return DeviceOOMException(f"RESOURCE_EXHAUSTED: {note}")
    if kind == "poison":
        try:
            index = int(tag)
        except (TypeError, ValueError):
            index = -1
        return PoisonedBatchException(index, note)
    if kind == "analyzer":
        return AnalyzerFaultException(note)
    if kind == "interrupt":
        return InjectedInterrupt(note)
    if kind == "worker_death":
        return WorkerCrash(note)
    if kind == "corrupt":
        return CorruptStateError("injected payload", site, note)
    if kind == "drift":
        return SchemaDriftError(site, [note])
    raise ValueError(f"unknown fault kind {kind!r}")


FAULT_KINDS = (
    "device", "oom", "poison", "analyzer", "interrupt", "worker_death",
    "stall", "corrupt", "drift",
)

#: The fault-site REGISTRY: every ``fault_point(site, ...)`` planted in the
#: package names a site listed here, and every site listed here has at
#: least one live probe (``tests/test_torch_service.py`` checks both).
KNOWN_FAULT_SITES = frozenset({
    "worker",
    "stream_fold",
    "coalesced_fold",
})


@dataclass
class FaultSpec:
    """One deterministic rule: at ``site``, on hits selected by ``at`` /
    ``every`` / ``p`` (and optionally narrowed by ``match`` against the
    tag), raise the ``kind`` error — at most ``count`` times (None =
    unlimited). ``kind="stall"`` sleeps ``delay_s`` instead of raising
    (compile-stall injection). Hit numbering is PER SITE and 1-based, so
    ``at=2`` means "the second time this site fires"."""

    site: str
    kind: str
    at: Optional[int] = None
    every: Optional[int] = None
    p: float = 0.0
    count: Optional[int] = 1
    match: Optional[str] = None
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"fault kind {self.kind!r} not in {FAULT_KINDS}"
            )

    def to_dict(self) -> Dict:
        return {
            k: v
            for k, v in self.__dict__.items()
            if v not in (None, 0.0) or k in ("site", "kind")
        }

    @staticmethod
    def from_dict(d: Dict) -> "FaultSpec":
        return FaultSpec(**d)


class FaultInjector:
    """Armed fault plan. Deterministic: per-site hit counters plus ONE
    seeded ``random.Random`` consumed in probe order — identical call
    sequences see identical faults. Thread-safe: the service scheduler's
    workers and the engine's prefetch threads all probe concurrently."""

    def __init__(self, specs: Sequence[FaultSpec], seed: int = 0):
        import random

        self.specs = list(specs)
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._hits: Dict[str, int] = {}
        self._fired: List[str] = []
        self._spec_fired = [0] * len(self.specs)
        self._lock = threading.Lock()

    @property
    def fired(self) -> List[str]:
        """``"site:tag:kind"`` records of every fault fired, in order."""
        with self._lock:
            return list(self._fired)

    def fire(self, site: str, tag: str = "") -> None:
        delay = 0.0
        error: Optional[BaseException] = None
        with self._lock:
            hit = self._hits.get(site, 0) + 1
            self._hits[site] = hit
            for i, spec in enumerate(self.specs):
                if spec.site != site:
                    continue
                if spec.match is not None and spec.match not in tag:
                    continue
                if spec.count is not None and self._spec_fired[i] >= spec.count:
                    continue
                selected = False
                if spec.at is not None:
                    selected = hit == spec.at
                elif spec.every is not None:
                    selected = hit % spec.every == 0
                elif spec.p > 0.0:
                    # one shared seeded stream, consumed ONLY for p-specs on
                    # their own site so unrelated probes don't shift it
                    selected = self._rng.random() < spec.p
                else:
                    selected = True
                if not selected:
                    continue
                self._spec_fired[i] += 1
                self._fired.append(f"{site}:{tag}:{spec.kind}")
                # every kind honors delay_s ("stall" sleeps and nothing
                # more; other kinds model a SLOW failure — a feed that
                # drags before wedging — by sleeping, then raising)
                delay = spec.delay_s
                if spec.kind != "stall":
                    error = _make_error(spec.kind, site, tag)
                break
        if delay:
            time.sleep(delay)
        if error is not None:
            raise error


#: the armed injector (process-global; None = disarmed). Reads are
#: lock-free — arming mid-probe at worst misses one probe, which the
#: deterministic tests never do.
_ACTIVE: Optional[FaultInjector] = None
_ENV_CHECKED = False


def active_injector() -> Optional[FaultInjector]:
    global _ACTIVE, _ENV_CHECKED
    if _ACTIVE is None and not _ENV_CHECKED:
        _ENV_CHECKED = True
        from ..utils import env_str

        env = env_str(FAULTS_ENV)
        if env:
            specs = [FaultSpec.from_dict(d) for d in json.loads(env)]
            # deliberately NOT warn-and-fallback (like the plan itself): a
            # chaos drill with an unparseable seed must abort loudly, not
            # silently run a different fault sequence under seed 0
            _ACTIVE = FaultInjector(
                specs, seed=int(env_str(FAULT_SEED_ENV, "0"))
            )
    return _ACTIVE


def install(specs: Sequence[FaultSpec], seed: int = 0) -> FaultInjector:
    global _ACTIVE
    _ACTIVE = FaultInjector(specs, seed=seed)
    return _ACTIVE


def clear() -> None:
    global _ACTIVE, _ENV_CHECKED
    _ACTIVE = None
    _ENV_CHECKED = False


@contextmanager
def inject(*specs: FaultSpec, seed: int = 0):
    """Arm a plan for the enclosed block (the test-facing entry point)::

        with inject(FaultSpec("device_update", "device", at=2)) as inj:
            result = VerificationSuite.on_data(data).add_check(c).run()
        assert inj.fired
    """
    global _ACTIVE
    prior = _ACTIVE
    injector = install(specs, seed=seed)
    try:
        yield injector
    finally:
        _ACTIVE = prior


def fault_point(site: str, tag: str = "") -> None:
    """Probe planted at an instrumented site; near-free when disarmed."""
    injector = _ACTIVE
    if injector is None:
        if _ENV_CHECKED:
            return
        injector = active_injector()
        if injector is None:
            return
    injector.fire(site, tag)
