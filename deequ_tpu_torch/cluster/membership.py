"""Membership and health: who is in the cluster, and who just died (the
reference's ``deequ_tpu/cluster/membership.py``).

Workers prove liveness by heartbeating a shared directory: each writes
``host-<id>.json`` (a ``tmp.<pid>`` file renamed into place, so readers
never see a torn beat) carrying its host id, a monotonically increasing
beat sequence and a wall-clock stamp. The front tier scans the directory:
a host whose last beat is older than ``DEEQU_TPU_CLUSTER_HOST_TTL_S`` is
declared LOST and surfaces as a typed :class:`HostLossError`, the signal
that drives ring re-hash and session recovery in
:class:`~deequ_tpu_torch.cluster.front.FrontTier`. Files, not sockets,
deliberately: the partition store and the compaction lease already live on
the shared filesystem, so membership rides the same substrate with the
same failure domain (a worker that cannot reach the share cannot beat,
and cannot commit either, so declaring it lost is safe).

Each membership scan passes a ``host_heartbeat`` fault probe per host
(tag = host id), so chaos plans can declare any host dead without killing
anything. The beat files are the reference's, so a front tier of either
package reads the workers of both.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..config import CLUSTER_HEARTBEAT_ENV as HEARTBEAT_ENV
from ..config import CLUSTER_HOST_TTL_ENV as HOST_TTL_ENV
from ..exceptions import HostLossError, ShardLossError  # noqa: F401
from ..reliability.faults import fault_point
from ..utils import env_number

_logger = logging.getLogger(__name__)

#: seconds between heartbeat writes from a live worker
DEFAULT_HEARTBEAT_S = 0.5

#: seconds without a beat before a host is declared lost (a few multiples
#: of the heartbeat period, to ride out scheduler hiccups)
DEFAULT_HOST_TTL_S = 3.0

__all__ = [
    "DEFAULT_HEARTBEAT_S", "DEFAULT_HOST_TTL_S", "HEARTBEAT_ENV", "HOST_TTL_ENV",
    "HeartbeatMembership", "HostLossError", "heartbeat_s", "host_ttl_s",
]


def heartbeat_s() -> float:
    return float(env_number(HEARTBEAT_ENV, DEFAULT_HEARTBEAT_S, float, minimum=0.05))


def host_ttl_s() -> float:
    return float(env_number(HOST_TTL_ENV, DEFAULT_HOST_TTL_S, float, minimum=0.1))


class HeartbeatMembership:
    """File-based heartbeat membership over a shared directory.

    One instance per participant: workers call :meth:`beat` (or
    :meth:`start` a background beater), the front tier calls :meth:`scan`
    to partition the membership into (alive, lost). A lost host's beat
    file is retired by whoever recovers it (:meth:`retire`), so one loss is
    reported once."""

    def __init__(
        self,
        root: str,
        host_id: str = "",
        heartbeat_period_s: Optional[float] = None,
        ttl_s: Optional[float] = None,
    ) -> None:
        self.root = root
        self.host_id = host_id
        self.period_s = heartbeat_s() if heartbeat_period_s is None else float(heartbeat_period_s)
        self.ttl_s = host_ttl_s() if ttl_s is None else float(ttl_s)
        self._seq = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        os.makedirs(self.root, exist_ok=True)

    def _path(self, host: str) -> str:
        safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in host)
        return os.path.join(self.root, f"host-{safe}.json")

    # -- writer side (workers) -------------------------------------------

    def beat(self) -> None:
        """Write one heartbeat (atomic rename). A failed write logs and
        carries on: a missed beat is exactly what the TTL tolerates."""
        if not self.host_id:
            raise ValueError("beat() requires a host_id")
        self._seq += 1
        payload = json.dumps({"host": self.host_id, "seq": self._seq, "ts": time.time()})
        path = self._path(self.host_id)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(payload)
            os.replace(tmp, path)
        except OSError as exc:  # pragma: no cover - fs-dependent
            _logger.warning("heartbeat write failed for %s: %s", self.host_id, exc)

    def start(self) -> None:
        """A background beater every ``period_s`` until :meth:`stop`."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.period_s):
                self.beat()

        self.beat()
        self._thread = threading.Thread(target=loop, daemon=True, name=f"heartbeat-{self.host_id}")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=self.period_s * 4)
        self._thread = None

    # -- reader side (front tier) ----------------------------------------

    def members(self) -> Dict[str, dict]:
        """The last beat of each host (torn or alien files skipped)."""
        out: Dict[str, dict] = {}
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for name in names:
            if not (name.startswith("host-") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.root, name), encoding="utf-8") as fh:
                    rec = json.load(fh)
            except (OSError, ValueError):
                continue
            host = rec.get("host") if isinstance(rec, dict) else None
            if isinstance(host, str) and host:
                out[host] = rec
        return out

    def scan(self) -> Tuple[List[str], List[str]]:
        """Partition the membership into ``(alive, lost)`` by beat age.
        Each host passes a ``host_heartbeat`` fault probe (tag = host id);
        an injected ``host_loss`` fault declares that host dead, the chaos
        path that exercises recovery without killing a process."""
        now = time.time()
        alive: List[str] = []
        lost: List[str] = []
        for host, rec in sorted(self.members().items()):
            try:
                fault_point("host_heartbeat", tag=host)
            except HostLossError:
                lost.append(host)
                continue
            age = now - float(rec.get("ts", 0.0))
            (alive if age <= self.ttl_s else lost).append(host)
        return alive, lost

    def retire(self, host: str) -> None:
        """Drop ``host``'s beat file once its loss has been handled, so
        later scans stop reporting it."""
        try:
            os.unlink(self._path(host))
        except OSError:
            pass
