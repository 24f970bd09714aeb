"""Deterministic fault injection at named engine and service sites (copied
from the reference's ``deequ_tpu/reliability/faults.py``).

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
``analyzer``         once per scan analyzer per pass, tag = ``repr(analyzer)``
``compile``          when a battery's program is first built (the port's
                     counterpart of the reference's fused-program build)
``device_update``    before each device-tier batch's launches, tag = batch
                     number (1-based)
``device_feed``      before a batch's features are copied to the device,
                     tag = batch index
``prefetch``         per staged batch of the device feed pipeline, tag =
                     batch index (0-based)
``host_heartbeat``   per host in the cluster membership scan, tag = host id
``ring_rebalance``   before a hash-ring host add/remove re-hashes key ranges
``host_partial``     before each host-tier partial, tag = batch index
``ingest_fold``      before each host-tier chunk fold on the device
``state_fetch``      before a pass's device-to-host state fetch
``checkpoint``       before an ingest checkpoint is persisted, tag = batch
``state_load``       in ``FileSystemStateProvider.load``, tag =
                     ``repr(analyzer)``
``repository_load``  in the FS metrics repository's read-all and the
                     partitioned metrics repository's bucket read, tag =
                     path
``partition_store_load``  in ``PartitionStateStore.get``, tag =
                     ``dataset/partition``
``lease_acquire``    at a compaction-lease election attempt, tag = lease path
``worker``           at job pickup in the service scheduler, tag = worker id
``stream_fold``      before a streaming session's fold mutates state
``coalesced_fold``   before a coalesced fast/device fold executes a claimed
                     group, tag = session key
``sharded_fold``     before a mesh ingest fold dispatch
``collective_merge`` before a collective state merge dispatch
``shard_probe``      per mesh shard in the heartbeat health probe, tag = shard
``frame_decode``     per ingest-plane frame before it folds, tag = frame idx
``catalog_load``     before a tenant catalog document parses, tag = tenant
``row_gate``         per frame before the row-level conformance mask runs,
                     tag = ``tenant/dataset``
===================  ========================================================

The ``interrupt`` kind (a ``KeyboardInterrupt`` subclass) at
``device_update``, ``host_partial`` or ``ingest_fold`` kills a run mid-fold,
which an ingest checkpoint then resumes; the ``corrupt`` kind (a typed
``CorruptStateError``) at the three load sites stands in for bit rot or a
torn write the checksum layer would detect. At ``catalog_load`` the
``corrupt`` kind stands in for a torn or garbled tenant catalog document
(the catalog quarantines it and keeps serving last-good); at ``row_gate``
it stands in for a frame the conformance mask cannot even be computed over
(the gate surfaces it typed before anything folds).

The ingest kind ``frame_corrupt`` (a typed ``MalformedFrameError``)
injected at ``frame_decode`` stands in for torn or garbled Arrow IPC bytes
a producer shipped.

The mesh kinds: ``mesh_loss`` (a typed ``ShardLossError`` whose ``lost``
list carries the spec's ``shard``, default 0) stands in for a device or
process dying mid-pass: injected at ``sharded_fold`` or
``collective_merge`` it exercises the elastic salvage and re-shard path,
at ``shard_probe`` it makes the heartbeat declare that shard dead;
``shard_stall`` (a typed ``ShardStallError``, the same payload) stands in
for a shard that wedged without raising.

The engine's ``feed_stall`` kind (a typed ``FeedStallError``) at
``prefetch`` stands in for the device feed pipeline wedging mid-pass; with
a ``delay_s`` it sleeps that long first, modeling a slow feed before the
stall is declared. The ``stall`` kind at ``device_update`` or
``host_partial`` holds a pass past the scan watchdog's deadline; ``oom``
and ``device`` at ``device_update`` drive the tier ladder, and
``analyzer`` at ``analyzer`` (matched to one analyzer's tag) the battery
bisection (``reliability.isolation``).

The cluster kind: ``host_loss`` (a typed ``HostLossError`` whose ``host``
carries the probe tag) stands in for a whole worker process dying:
injected at ``host_heartbeat`` it makes the membership scan declare that
host dead and the front tier re-hash its ring range to survivors.
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
    FeedStallError,
    HostLossError,
    PoisonedBatchException,
    MalformedFrameError,
    SchemaDriftError,
    ShardLossError,
    ShardStallError,
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
def _make_error(kind: str, site: str, tag: str, shard: Optional[int] = None) -> BaseException:
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
    if kind == "frame_corrupt":
        try:
            index = int(tag)
        except (TypeError, ValueError):
            index = -1
        return MalformedFrameError(site, note, frame_index=index)
    if kind == "mesh_loss":
        return ShardLossError([0 if shard is None else shard], site, detail=note)
    if kind == "shard_stall":
        return ShardStallError([0 if shard is None else shard], site, detail=note)
    if kind == "feed_stall":
        return FeedStallError(site, note)
    if kind == "host_loss":
        return HostLossError(tag or site, site=site, detail=note)
    raise ValueError(f"unknown fault kind {kind!r}")


FAULT_KINDS = (
    "device", "oom", "poison", "analyzer", "interrupt", "worker_death",
    "stall", "corrupt", "drift", "mesh_loss", "shard_stall",
    "frame_corrupt", "feed_stall", "host_loss",
)

#: The fault-site REGISTRY: every ``fault_point(site, ...)`` planted in the
#: package names a site listed here, and every site listed here has at
#: least one live probe (``tests/test_torch_service.py`` checks both).
KNOWN_FAULT_SITES = frozenset({
    "analyzer",
    "compile",
    "device_update",
    "device_feed",
    "prefetch",
    "state_fetch",
    "state_load",
    "host_partial",
    "ingest_fold",
    "checkpoint",
    "repository_load",
    "partition_store_load",
    "lease_acquire",
    "worker",
    "stream_fold",
    "coalesced_fold",
    "sharded_fold",
    "collective_merge",
    "shard_probe",
    "host_heartbeat",
    "ring_rebalance",
    "frame_decode",
    "catalog_load",
    "row_gate",
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
    shard: Optional[int] = None

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
                    error = _make_error(spec.kind, site, tag, shard=spec.shard)
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
