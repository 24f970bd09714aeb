"""Per-shard heartbeat and health probing for meshes (the reference's
``deequ_tpu/parallel/health.py``).

A sharded fold can lose exactly one shard: a card drops off the bus, a
process of a cross-process group dies, one device wedges while its
neighbours keep folding. The elastic layer needs to know which shards are
still alive:

- :func:`probe_shards` runs a one-element round trip (a copy to the device
  and back) against every device of a mesh under the heartbeat deadline
  and returns the mesh positions that failed or stalled;
- :class:`HeartbeatGate` time-gates the probe (every
  ``DEEQU_TPU_SHARD_HEARTBEAT_S`` seconds by default), so the per-chunk
  fold pays one clock read between heartbeats.

Each shard's probe passes through the ``shard_probe`` fault site (tag =
the shard's position), so tests can declare any shard dead. The knob
follows the warn-once convention of ``utils.env_number``; a value <= 0
disables the periodic heartbeat (explicit probes still work).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional

import torch

from ..exceptions import ShardLossError
from ..reliability.faults import fault_point

_logger = logging.getLogger(__name__)

#: env var: seconds between heartbeat probes of a live mesh fold (also the
#: per-shard probe deadline); <= 0 disables the periodic heartbeat
HEARTBEAT_ENV = "DEEQU_TPU_SHARD_HEARTBEAT_S"
DEFAULT_HEARTBEAT_S = 5.0


def shard_heartbeat_s() -> Optional[float]:
    """The configured heartbeat interval in seconds, or None when the
    periodic heartbeat is disabled (a value <= 0)."""
    from ..utils import env_number

    seconds = env_number(HEARTBEAT_ENV, DEFAULT_HEARTBEAT_S, float)
    return seconds if seconds > 0 else None


def probe_shards(mesh, deadline_s: Optional[float] = None) -> List[int]:
    """The dead positions of ``mesh`` (indices into ``mesh.devices``); see
    :func:`probe_devices`."""
    return probe_devices(list(mesh.devices), deadline_s=deadline_s)


def probe_devices(devices, deadline_s: Optional[float] = None) -> List[int]:
    """Probe a list of devices and return the positions of the dead ones: a
    probe that raises, or that does not complete within ``deadline_s``
    (default: the heartbeat interval), declares its device dead. Each probe
    is one element copied to the device and back. The probes run on one
    daemon thread, so a wedged device cannot hang the caller: past the
    deadline the thread is abandoned and every device not yet confirmed
    counts as stalled."""
    if deadline_s is None:
        deadline_s = shard_heartbeat_s() or DEFAULT_HEARTBEAT_S
    devices = list(devices)
    dead: List[int] = []
    confirmed = [False] * len(devices)

    def probe_all() -> None:
        for i, device in enumerate(devices):
            try:
                fault_point("shard_probe", tag=str(i))
                torch.ones(1, dtype=torch.int32).to(device).cpu()
            except ShardLossError as exc:
                # an injected loss names its shards; none means this one
                dead.extend(exc.lost or (i,))
            except Exception:  # noqa: BLE001 - a raising probe is the signal
                dead.append(i)
            confirmed[i] = True

    worker = threading.Thread(target=probe_all, name="deequ-shard-probe", daemon=True)
    worker.start()
    worker.join(deadline_s)
    if worker.is_alive():
        dead.extend(i for i in range(len(devices)) if not confirmed[i])
    if dead:
        _logger.warning("shard heartbeat: %d/%d shards unresponsive (positions %s)",
                        len(set(dead)), len(devices), sorted(set(dead)))
    return sorted({i for i in dead if 0 <= i < len(devices)})


class HeartbeatGate:
    """Time-gated heartbeat: :meth:`due` is a clock read; once the interval
    has passed, :meth:`check` probes the mesh and returns the dead
    positions (empty when healthy). A disabled heartbeat is never due."""

    def __init__(self, interval_s: Optional[float] = None):
        self.interval_s = shard_heartbeat_s() if interval_s is None else interval_s
        self._last = time.monotonic()

    def due(self) -> bool:
        if self.interval_s is None:
            return False
        return (time.monotonic() - self._last) >= self.interval_s

    def check(self, mesh) -> List[int]:
        self._last = time.monotonic()
        return probe_shards(mesh, deadline_s=self.interval_s)
