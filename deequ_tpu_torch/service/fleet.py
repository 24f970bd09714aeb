"""Fleet scheduler: tenants packed onto disjoint sub-meshes (the reference's
``deequ_tpu/service/fleet.py``, ported).

- **Sharding by default on more than one card.** When the service's device
  table spans more than one CUDA card, every batch verification job's row
  stream shards across the tenant's slice of it: the device tier's stacked
  launches (``sharded_update``), the host tier's ``sharded_ingest_fold``
  under the :class:`~deequ_tpu_torch.parallel.ElasticMeshFold` ladder, and
  the collective merge. ``DEEQU_TPU_FLEET=0`` is the escape hatch:
  single-device routing, byte for byte the path without a fleet.

- **Disjoint sub-mesh packing.** The :class:`FleetScheduler` partitions
  the healthy positions of its device table into power-of-two slices (8 ->
  4+4 for two tenants, 2-position slices for three or four, single
  positions beyond) and leases each tenant its own slice. More tenants
  than positions wrap around (slices shared round-robin).

- **Elastic re-packing.** A shard dropping out of the ladder (an injected
  ``mesh_loss``, a failed probe, a heartbeat miss) marks its position
  unhealthy fleet-wide, and the next lease packs tenants over the
  survivors. A lease's mesh knows the table positions of its shards
  (``Mesh.fleet_positions``), so a loss names positions, never devices:
  on a table of shards of one card every entry is the same device, and
  losing one shard must drop one position, not all of them.

The device table is the port's own. ``FleetScheduler(devices=...)`` takes
it as the reference's does, and its entries may repeat a card (shards of
one card, as ``make_mesh(8, device="cuda")`` places them). A
:class:`~deequ_tpu_torch.service.VerificationService` builds its table
from ``fleet_devices=`` (:func:`fleet_table`): the port's form of the
reference's virtual-device flag (``--xla_force_host_platform_device_count``).

Default policy: the fleet is on when the table spans more than one CUDA
card. ``DEEQU_TPU_FLEET=1`` forces it on for any table of two or more
shards (shards of one card, CPU drills); ``DEEQU_TPU_FLEET=0``,
``fleet=False`` or an explicit ``mesh=`` turns it off.

Warmth: warmth keys carry the slice's shard count
(``placement.shape_qualified_signature``), so a battery warm on 8 shards
reads cold on the 4-shard slice a re-pack hands the tenant until the
sharded path of that width has launched.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

_logger = logging.getLogger(__name__)

#: env var: "0" disables the fleet scheduler (single-device routing, byte
#: for byte the path without a fleet); "1" forces it on for any device
#: table of two or more shards; unset = on iff the table spans more than
#: one CUDA card
FLEET_ENV = "DEEQU_TPU_FLEET"

#: env var: minimum micro-batch rows before a STREAMING fold shards over
#: the tenant's sub-mesh (default 65536, through the tuning registry)
FLEET_STREAM_MIN_ROWS_ENV = "DEEQU_TPU_FLEET_STREAM_MIN_ROWS"
DEFAULT_FLEET_STREAM_MIN_ROWS = 1 << 16

_FLEET_ENV_WARNED = False


def default_fleet_devices(device=None) -> List[Any]:
    """The device table of a service on ``device`` (``cuda`` unless the
    caller names another): every visible card for ``"cuda"``, the one
    device otherwise (``make_mesh(device=...)``'s devices)."""
    from ..parallel import make_mesh

    return list(make_mesh(device=device).devices)


def fleet_table(fleet_devices, device) -> List[Any]:
    """A service's device table from its ``fleet_devices=`` argument: None
    -> :func:`default_fleet_devices`; an int n -> n shards over ``device``,
    placed as ``make_mesh(n, device=...)`` places them; a sequence -> those
    devices, each of ``device``'s type (a service on ``cuda`` leases only
    ``cuda`` shards)."""
    import torch

    from ..parallel import make_mesh

    if fleet_devices is None:
        return default_fleet_devices(device)
    if isinstance(fleet_devices, int):
        return list(make_mesh(int(fleet_devices), device=device).devices)
    table = [torch.device(d) for d in fleet_devices]
    kind = torch.device(device).type
    wrong = [str(d) for d in table if d.type != kind]
    if wrong or not table:
        raise ValueError(f"fleet_devices must be devices of the service's type {kind!r}, "
                         f"got {[str(d) for d in table]}")
    return table


def _distinct_cards(devices: Sequence[Any]) -> int:
    """How many distinct CUDA cards a table spans (0 for a CPU table)."""
    cards = set()
    for d in devices:
        if getattr(d, "type", None) == "cuda":
            import torch

            cards.add(d.index if d.index is not None else torch.cuda.current_device())
    return len(cards)


def fleet_enabled(devices: Optional[Sequence[Any]] = None) -> bool:
    """Whether a service over this device table (default:
    :func:`default_fleet_devices`) runs the fleet scheduler (see the module
    docstring for the policy). Any value of ``DEEQU_TPU_FLEET`` other than
    "0"/"1" warns once and keeps the default policy."""
    from ..utils import env_str

    global _FLEET_ENV_WARNED
    raw = env_str(FLEET_ENV)
    if raw is not None:
        value = raw.strip()
        if value == "0":
            return False
        if value == "1":
            table = list(devices) if devices is not None else _visible_table()
            if len(table) > 1:
                return True
            if not _FLEET_ENV_WARNED:
                _FLEET_ENV_WARNED = True
                _logger.warning(
                    "%s=1 but the device table holds one shard: the fleet stays off "
                    "(for a drill on one device pass fleet_devices=N)", FLEET_ENV)
            return False
        if not _FLEET_ENV_WARNED:
            _FLEET_ENV_WARNED = True
            _logger.warning(
                "ignoring invalid %s=%r (expected \"0\" or \"1\"); keeping the default "
                "policy", FLEET_ENV, raw)
    table = list(devices) if devices is not None else _visible_table()
    return _distinct_cards(table) > 1


def _visible_table() -> List[Any]:
    """Every visible card, or none without one (no fleet then)."""
    import torch

    if not torch.cuda.is_available():
        return []
    return default_fleet_devices("cuda")


def fleet_stream_min_rows() -> int:
    # registry-resolved (env override > tuned > static 65536)
    from ..tuning import knobs

    return knobs.value("fleet_stream_min_rows")


def mesh_substrate(devices: Optional[Sequence[Any]] = None) -> Dict[str, Any]:
    """What a mesh over this device table (default: every visible card, or
    the CPU without one) is made of, in the reference's four keys.
    ``chip_count`` counts distinct devices, never logical shards: a table
    of 8 shards of one card is one chip (a shared-resource point must never
    read as a multi-chip one)."""
    import torch

    if devices is None:
        devices = _visible_table() or [torch.device("cpu")]
    devices = [torch.device(d) for d in devices]
    cuda = [d for d in devices if d.type == "cuda"]
    if cuda:
        index = cuda[0].index if cuda[0].index is not None else torch.cuda.current_device()
        kind = torch.cuda.get_device_name(index)
    else:
        kind = "cpu"
    return {
        "substrate": "accelerator" if cuda else "cpu-virtual",
        "backend": "cuda" if cuda else "cpu",
        "device_kind": kind if devices else "none",
        "chip_count": _distinct_cards(devices) if cuda else len(set(devices)),
    }


class SubMeshLease:
    """One tenant's grant of a slice: the positions (indices into the
    fleet's device table), their devices, and the packing generation it
    was cut from. ``mesh`` builds lazily and is shared per slice
    fleet-wide."""

    __slots__ = ("tenant", "positions", "devices", "generation", "_fleet")

    def __init__(self, tenant, positions, devices, generation, fleet):
        self.tenant = tenant
        self.positions: Tuple[int, ...] = tuple(positions)
        self.devices = tuple(devices)
        self.generation = int(generation)
        self._fleet = fleet

    @property
    def n_dev(self) -> int:
        return len(self.devices)

    @property
    def mesh(self):
        """The slice's 1-D row mesh (its shards know their table
        positions), or None for a one-shard slice: single device IS the
        escape-hatch path."""
        if self.n_dev < 2:
            return None
        return self._fleet._mesh_for(self.positions)

    def __repr__(self) -> str:  # lease lines show up in trace events
        return (
            f"SubMeshLease({self.tenant!r}, devices={self.positions}, "
            f"gen={self.generation})"
        )


class FleetScheduler:
    """The device-mesh packing plane of the service.

    Thread-safe; every public method takes the internal lock. Packing is
    recomputed whenever the ACTIVE tenant set or the healthy position set
    changes: slice size = the largest power of two that gives every active
    tenant its own slice (floor 1), tenants assigned to slices in arrival
    order, wrapping when tenants outnumber slices. Leases are refcounted
    per tenant; membership is sticky between jobs (see :meth:`release`)."""

    def __init__(self, metrics=None, devices: Optional[Sequence] = None):
        from .metrics import ServiceMetrics

        self.metrics = metrics or ServiceMetrics()
        self._lock = threading.Lock()
        #: the full device table, fixed at construction (positions in every
        #: lease and loss report index into it; entries may repeat a card)
        self._devices: List[Any] = list(
            devices if devices is not None else default_fleet_devices()
        )
        #: what this fleet's meshes carry, so a loss reported by one of
        #: them names this table's positions (another fleet's meshes and
        #: plain meshes carry something else)
        self._token = object()
        #: positions still believed healthy (losses remove, never re-add —
        #: an operator restarts the service to reclaim a lost device)
        self._healthy: List[int] = list(range(len(self._devices)))
        #: active tenants in arrival order (the packing order)
        self._members: List[str] = []
        self._refs: Dict[str, int] = {}
        #: tenant -> monotonic time of its last acquire/release: what the
        #: idle-TTL reclamation in _pack_locked reads
        self._last_seen: Dict[str, float] = {}
        #: tenant -> healthy positions of its current slice
        self._assignment: Dict[str, List[int]] = {}
        self._generation = 0
        self.repacks = 0
        #: one Mesh per slice (positions tuple): on a table of shards of one
        #: card two disjoint slices have equal device tuples, so the key is
        #: the positions
        self._meshes: Dict[Tuple[int, ...], Any] = {}
        m = self.metrics
        m.describe(
            "deequ_service_fleet_leases_total",
            "Sub-mesh leases granted to tenant jobs by the fleet "
            "scheduler, labeled by slice device count.",
        )
        m.describe(
            "deequ_service_fleet_repacks_total",
            "Fleet re-packings (tenant membership change or shard loss "
            "re-pack over the surviving devices).",
        )
        m.describe(
            "deequ_service_fleet_shard_losses_total",
            "Devices marked unhealthy fleet-wide after a shard dropped "
            "out of the elastic ladder.",
        )
        m.set_gauge_fn(
            "deequ_service_fleet_healthy_devices",
            lambda: len(self._healthy),
            "Devices the fleet scheduler still packs tenants onto.",
        )
        m.set_gauge_fn(
            "deequ_service_fleet_active_tenants",
            lambda: len(self._members),
            "Tenants currently holding at least one sub-mesh lease.",
        )
        # the elastic layer reports a loss the moment a ladder walk
        # salvages it: subscribe so re-packing does not wait for the
        # scheduler's post-job harvest. Weakly: a torn-down service's fleet
        # must unhook itself instead of living on in the listener list
        import weakref

        from ..parallel.elastic import (
            add_shard_loss_listener,
            remove_shard_loss_listener,
        )

        ref = weakref.ref(self)

        def _listener(lost, _ref=ref):
            fleet = _ref()
            if fleet is None:
                remove_shard_loss_listener(_listener)
                return
            fleet._on_elastic_loss(lost)

        self._listener = _listener
        add_shard_loss_listener(_listener)

    def close(self) -> None:
        from ..parallel.elastic import remove_shard_loss_listener

        remove_shard_loss_listener(self._listener)

    # -- packing -------------------------------------------------------------

    def _mesh_for(self, positions: Tuple[int, ...]):
        with self._lock:
            mesh = self._meshes.get(positions)
            if mesh is None:
                from ..parallel import Mesh

                mesh = Mesh([self._devices[p] for p in positions],
                            fleet_positions=positions, fleet_token=self._token)
                self._meshes[positions] = mesh
            return mesh

    @staticmethod
    def _slice_size(n_healthy: int, n_tenants: int) -> int:
        if n_healthy <= 0:
            return 0
        per = max(1, n_healthy // max(1, n_tenants))
        size = 1
        while size * 2 <= per:
            size *= 2
        return size

    def _cut_slices_locked(self, n_tenants: int) -> List[List[int]]:
        """The slice partition a packing over ``n_tenants`` would cut from
        the current healthy set (under the lock). One function serves both
        the real packing and peek's prediction."""
        healthy = list(self._healthy)
        size = self._slice_size(len(healthy), n_tenants)
        if not size:
            return []
        return [
            healthy[i: i + size]
            for i in range(0, len(healthy) - size + 1, size)
        ]

    def _pack_locked(self) -> None:
        """Recompute the tenant -> slice assignment (under the lock).

        Re-packing changes FUTURE leases only: a job already running on
        its leased slice keeps it, so disjointness is a steady-state
        guarantee."""
        import time

        self._generation += 1
        self.repacks += 1
        # every re-pack reaches the export plane (ServiceMetrics has its own
        # lock and never calls back into the fleet, so this nesting cannot
        # invert)
        self.metrics.inc("deequ_service_fleet_repacks_total")
        # membership is sticky between jobs (a streaming tenant's refs drop
        # to zero between folds), so reclaim only tenants idle past the
        # TTL, and only when the packing changes anyway
        cutoff = time.monotonic() - self.IDLE_TTL_S
        self._members = [
            t for t in self._members
            if self._refs.get(t, 0) > 0
            or self._last_seen.get(t, cutoff) > cutoff
        ]
        keep = set(self._members) | {
            t for t, n in self._refs.items() if n > 0
        }
        self._last_seen = {
            t: v for t, v in self._last_seen.items() if t in keep
        }
        self._assignment = {}
        slices = self._cut_slices_locked(len(self._members))
        if not slices:
            return
        for i, tenant in enumerate(self._members):
            self._assignment[tenant] = slices[i % len(slices)]

    def _lease_locked(self, tenant: str) -> SubMeshLease:
        positions = self._assignment.get(tenant, self._healthy[:1])
        return SubMeshLease(
            tenant, positions,
            [self._devices[p] for p in positions],
            self._generation, self,
        )

    # -- tenant-facing API ---------------------------------------------------

    #: seconds a zero-ref tenant survives in the packing before a re-pack
    #: may reclaim its slice
    IDLE_TTL_S = 300.0

    def acquire(self, tenant: str) -> SubMeshLease:
        """Lease the tenant's sub-mesh for one job or drain; pair with
        :meth:`release`. The first lease of an unseen tenant re-packs."""
        import time

        with self._lock:
            self._refs[tenant] = self._refs.get(tenant, 0) + 1
            self._last_seen[tenant] = time.monotonic()
            if tenant not in self._assignment:
                if tenant not in self._members:
                    self._members.append(tenant)
                self._pack_locked()
            lease = self._lease_locked(tenant)
        self.metrics.inc(
            "deequ_service_fleet_leases_total", devices=str(lease.n_dev)
        )
        return lease

    def release(self, tenant: str) -> None:
        """Release one lease. Membership is STICKY: a tenant keeps its
        slice between jobs, so re-packs happen only on membership growth
        and on shard loss. :meth:`evict_idle` reclaims slices of tenants
        that stopped submitting."""
        import time

        with self._lock:
            self._last_seen[tenant] = time.monotonic()
            n = self._refs.get(tenant, 0) - 1
            if n > 0:
                self._refs[tenant] = n
            else:
                self._refs.pop(tenant, None)

    def evict_idle(self) -> int:
        """Drop zero-ref tenants from the packing and re-pack now (an
        operator hook). Returns how many tenants were evicted."""
        with self._lock:
            idle = [t for t in self._members if self._refs.get(t, 0) <= 0]
            for t in idle:
                self._members.remove(t)
                self._assignment.pop(t, None)
                self._last_seen.pop(t, None)
            if idle:
                self._pack_locked()
            return len(idle)

    def peek(self, tenant: str) -> SubMeshLease:
        """The slice the CURRENT packing would grant this tenant, without
        taking a lease (submit-time warmth keys and warm closures use it).
        For an unseen tenant it predicts the exact slice :meth:`acquire`
        would grant with the tenant joined."""
        with self._lock:
            if tenant in self._assignment:
                return self._lease_locked(tenant)
            slices = self._cut_slices_locked(len(self._members) + 1)
            positions: Sequence[int] = []
            if slices:
                positions = slices[len(self._members) % len(slices)]
            return SubMeshLease(
                tenant, positions,
                [self._devices[p] for p in positions],
                self._generation, self,
            )

    def devices_of(self, tenant: str) -> Tuple[int, ...]:
        """Healthy positions currently assigned to the tenant."""
        with self._lock:
            return tuple(self._assignment.get(tenant, ()))

    # -- elasticity ----------------------------------------------------------

    def _on_elastic_loss(self, lost) -> None:
        """An elastic salvage declared shards lost. A mesh of this fleet
        reports the table positions of its lost shards; any other mesh only
        devices, which name a position only where the table holds that
        device once (a device shared by several shards names none)."""
        if getattr(lost, "fleet_token", None) is self._token:
            positions = list(lost.fleet_positions)
        else:
            devices = tuple(lost)
            positions = [
                i for i, d in enumerate(self._devices)
                if d in devices and self._devices.count(d) == 1
            ]
        if positions:
            self.mark_unhealthy(positions)

    def mark_unhealthy(self, positions: Sequence[int]) -> None:
        dropped = []
        with self._lock:
            for p in positions:
                if p in self._healthy:
                    self._healthy.remove(p)
                    dropped.append(p)
            if dropped:
                self._pack_locked()
        if dropped:
            from ..observability import trace as _trace

            self.metrics.inc(
                "deequ_service_fleet_shard_losses_total", float(len(dropped))
            )
            _trace.add_event(
                "fleet_repack", dropped=dropped,
                healthy=len(self._healthy), tenants=len(self._members),
            )
            _logger.warning(
                "fleet re-pack: positions %s marked unhealthy, %d healthy "
                "remain, %d tenants re-packed",
                dropped, len(self._healthy), len(self._members),
            )

    def note_shard_loss(self) -> None:
        """A job's monitor reported shard losses: probe each healthy
        position once (``probe_devices``, whose answer is indices into the
        probed list) and drop the positions whose probe fails or that an
        injected ``shard_probe`` fault names. The elastic listener usually
        got there first; probing again is idempotent."""
        from ..parallel.health import probe_devices

        with self._lock:
            candidates = [(p, self._devices[p]) for p in self._healthy]
        if len(candidates) < 2:
            return
        dead = probe_devices([d for _, d in candidates])
        if dead:
            self.mark_unhealthy([candidates[i][0] for i in dead])

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "healthy": list(self._healthy),
                "tenants": list(self._members),
                "assignment": {
                    t: list(p) for t, p in self._assignment.items()
                },
                "generation": self._generation,
                "repacks": self.repacks,
            }
