"""Consistent-hash ring: the front tier's session router (the reference's
``deequ_tpu/cluster/ring.py``).

Sessions are sticky (a streaming session's algebraic states live on ONE
worker between fold boundaries), so routing must be a pure function of
the session key that (a) every front-tier replica computes identically
and (b) moves as FEW keys as possible when the host set changes. A
consistent-hash ring with virtual nodes gives both: each host owns
``DEEQU_TPU_CLUSTER_VNODES`` pseudo-random points on a 64-bit circle, and
a key routes to the first point clockwise of its own hash. Adding or
removing one host re-homes only the ~1/N of keys whose clockwise arc
changed; everything else stays put. The ring decides WHERE a session
lives; :class:`~deequ_tpu_torch.cluster.front.FrontTier` performs the move
(flush on the old host, adopt on the new one, through the partition
store, at a fold boundary).

Hashing is ``blake2b`` (stdlib, keyed by nothing, stable across processes
and Python runs; ``hash()`` is salted per process and useless here), read
exactly as the reference reads it, so a front tier of either package
routes every key to the same host. Ring mutations pass a
``ring_rebalance`` fault probe so chaos plans can fail the re-hash
mid-membership-change.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

from ..config import CLUSTER_VNODES_ENV as VNODES_ENV
from ..reliability.faults import fault_point
from ..utils import env_number

#: virtual nodes per host: more points give a smoother key distribution at
#: slightly larger rings; 64 keeps the worst-case host imbalance under a
#: few percent for small clusters
DEFAULT_VNODES = 64


def ring_vnodes() -> int:
    return int(env_number(VNODES_ENV, DEFAULT_VNODES, int, minimum=1))


def stable_hash(key: str) -> int:
    """Process-stable 64-bit hash of ``key`` (blake2b, the 8-byte digest
    read big-endian)."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big"
    )


class HashRing:
    """Consistent-hash ring with virtual nodes.

    Not thread-safe by itself: the front tier serializes membership
    changes under its own lock. Lookups between mutations read immutable
    snapshots (``_points``/``_owners`` are rebuilt whole, never edited in
    place), so a racing ``route`` sees either the old or the new ring,
    both valid."""

    def __init__(self, hosts: Sequence[str] = (), vnodes: Optional[int] = None) -> None:
        self._vnodes = ring_vnodes() if vnodes is None else max(1, int(vnodes))
        self._hosts: List[str] = []
        self._points: List[int] = []
        self._owners: List[str] = []
        for host in hosts:
            self.add_host(host)

    @property
    def hosts(self) -> Tuple[str, ...]:
        return tuple(self._hosts)

    @property
    def vnodes(self) -> int:
        return self._vnodes

    def __len__(self) -> int:
        return len(self._hosts)

    def __contains__(self, host: str) -> bool:
        return host in self._hosts

    def _rebuild(self) -> None:
        pairs = sorted(
            # ties broken by host id so every replica builds the same ring
            (stable_hash(f"{host}#{v}"), host)
            for host in self._hosts for v in range(self._vnodes)
        )
        self._points = [p for p, _ in pairs]
        self._owners = [h for _, h in pairs]

    def add_host(self, host: str) -> None:
        """Add ``host``; ~1/N of the key space re-homes onto it."""
        if host in self._hosts:
            return
        fault_point("ring_rebalance", tag=host)
        self._hosts.append(host)
        self._hosts.sort()
        self._rebuild()

    def remove_host(self, host: str) -> None:
        """Remove ``host``; its arcs re-home to the clockwise survivors."""
        if host not in self._hosts:
            return
        fault_point("ring_rebalance", tag=host)
        self._hosts.remove(host)
        self._rebuild()

    def route(self, key: str) -> str:
        """Owner host for ``key``: the first ring point clockwise of its
        hash. Raises ``LookupError`` on an empty ring; the caller (the
        front tier) decides whether that is a 503 or a crash."""
        if not self._points:
            raise LookupError("hash ring has no hosts")
        idx = bisect.bisect_right(self._points, stable_hash(key))
        return self._owners[idx % len(self._points)]

    def moved_keys(self, keys: Sequence[str], before: "HashRing") -> Dict[str, Tuple[str, str]]:
        """Which of ``keys`` route differently on this ring than on
        ``before``: ``{key: (old_host, new_host)}``, the migration work
        list of a membership change (every key absent stayed put)."""
        moved: Dict[str, Tuple[str, str]] = {}
        for key in keys:
            try:
                old = before.route(key)
            except LookupError:
                old = ""
            new = self.route(key)
            if old != new:
                moved[key] = (old, new)
        return moved

    def snapshot(self) -> "HashRing":
        """An independent copy (for ``moved_keys`` before/after diffs)."""
        clone = HashRing(vnodes=self._vnodes)
        clone._hosts = list(self._hosts)
        clone._points = list(self._points)
        clone._owners = list(self._owners)
        return clone
