"""Lease/fence file: single-compactor election for cross-process writers
(a copy of the JAX package's ``deequ_tpu/repository/lease.py``; the lease
file is the same, so compactors of either package exclude each other).

`PartitionedMetricsRepository.compact` is safe against concurrent saves
in ONE process (append-first commits + the in-process ``_compact_lock``),
but its docstring has always carried the caveat that cross-PROCESS writers
of one store root need external coordination: two processes compacting one
bucket can each rewrite ``compacted.json`` wholesale, and the loser's
rewrite silently drops entries the winner merged (whose loose files the
winner already removed). This module is that coordination — a filesystem
lease with fencing:

- the lease is ONE JSON file beside the store root (``<root>.lease``)
  holding ``{owner, epoch, acquiredAt, expiresAt}``;
- a FRESH acquire is an atomic create (write-to-temp + ``os.link``, which
  fails if the file exists — the POSIX test-and-set);
- a STALE lease (expiresAt in the past: the holder crashed mid-compaction)
  is taken over by atomic rename (``os.replace``) with ``epoch + 1``,
  then CONFIRMED by re-read — when two takeovers race, the last rename
  wins and the loser sees a foreign (owner, epoch) and backs off;
- the epoch is the FENCE: a compactor re-verifies (and renews) its
  (owner, epoch) immediately before the destructive rewrite, so a holder
  that stalled past its TTL and lost the lease aborts with the bucket's
  loose entries intact instead of clobbering the new holder's merge.

A crash while holding the lease costs at most one TTL of deferred
compaction — saves stay append-only and reads merge loose entries
throughout, so no history is ever unavailable behind the lease.

Leases only exist for LOCAL store roots (the link/rename primitives are
POSIX); remote roots (s3://, gs://, memory://) keep the documented
in-process-only guarantee.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import time
from typing import Optional

_logger = logging.getLogger(__name__)

#: env knob: seconds a compaction lease lives before any other process may
#: take it over (stale-holder recovery bound). Warn-once parser.
LEASE_TTL_ENV = "DEEQU_TPU_CLUSTER_LEASE_TTL_S"
DEFAULT_LEASE_TTL_S = 30.0


def lease_ttl_s() -> float:
    from ..utils import env_number

    return float(
        env_number(LEASE_TTL_ENV, DEFAULT_LEASE_TTL_S, float, minimum=0.1)
    )


def default_owner_id() -> str:
    """host:pid — unique per live process, stable within it (the lease
    survives re-acquire by the same process across repository objects)."""
    return f"{socket.gethostname()}:{os.getpid()}"


class FileLease:
    """One named lease over a shared directory tree (see module
    docstring). Not thread-safe by itself — callers serialize in-process
    (the repository's ``_compact_lock`` does)."""

    def __init__(
        self,
        path: str,
        owner: Optional[str] = None,
        ttl_s: Optional[float] = None,
    ):
        self.path = str(path)
        self.owner = owner or default_owner_id()
        self.ttl_s = float(ttl_s) if ttl_s is not None else lease_ttl_s()
        #: the epoch of OUR current hold (0 = not holding)
        self.epoch = 0
        #: protocol observability, asserted by the cluster drills
        self.refusals = 0
        self.takeovers = 0

    # -- protocol ------------------------------------------------------------

    def _read(self) -> Optional[dict]:
        try:
            with open(self.path, "r") as fh:
                d = json.load(fh)
            if not isinstance(d, dict) or "owner" not in d:
                return None
            return d
        except (OSError, ValueError):
            # missing file = no holder; a torn lease file reads as stale
            # (it cannot prove a live holder) and is replaced by takeover
            return None

    def _record(self, epoch: int, now: float) -> dict:
        return {
            "owner": self.owner,
            "epoch": int(epoch),
            "acquiredAt": now,
            "expiresAt": now + self.ttl_s,
        }

    def _write_temp(self, record: dict) -> str:
        tmp = f"{self.path}.tmp-{self.owner.replace('/', '_')}-{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(record, fh)
            fh.flush()
            os.fsync(fh.fileno())
        return tmp

    def acquire(self) -> bool:
        """Try to take the lease; True iff WE hold it on return. Never
        blocks: a live foreign holder is a refusal (the caller skips its
        compaction — the entries stay loose and readable)."""
        from ..reliability.faults import fault_point

        # chaos site: an injected fault here stands in for the lease file
        # being unreachable/contended at election time
        fault_point("lease_acquire", tag=self.path)
        now = time.time()
        current = self._read()
        if current is not None:
            if (
                current.get("owner") == self.owner
                and int(current.get("epoch", 0)) == self.epoch
                and self.epoch > 0
            ):
                return self.renew()
            if float(current.get("expiresAt", 0)) > now:
                self.refusals += 1
                return False
        proposed = int(current.get("epoch", 0)) + 1 if current else 1
        tmp = self._write_temp(self._record(proposed, now))
        try:
            if current is None:
                try:
                    os.link(tmp, self.path)  # atomic create: loser raises
                except FileExistsError:
                    self.refusals += 1
                    return False
            else:
                # stale takeover: last rename wins; the confirm below
                # detects a lost race
                os.replace(tmp, self.path)
                tmp = None
        finally:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        after = self._read()
        if (
            after is not None
            and after.get("owner") == self.owner
            and int(after.get("epoch", 0)) == proposed
        ):
            self.epoch = proposed
            if current is not None:
                self.takeovers += 1
                _logger.warning(
                    "took over stale compaction lease %s from %s "
                    "(epoch %d -> %d)", self.path,
                    current.get("owner"), proposed - 1, proposed,
                )
            return True
        self.refusals += 1
        self.epoch = 0
        return False

    def held(self) -> bool:
        """Re-read the file: are WE still the live holder at OUR epoch?
        The fence check — run immediately before any destructive step."""
        if self.epoch <= 0:
            return False
        current = self._read()
        return (
            current is not None
            and current.get("owner") == self.owner
            and int(current.get("epoch", 0)) == self.epoch
            and float(current.get("expiresAt", 0)) > time.time()
        )

    def renew(self) -> bool:
        """Extend our hold's TTL (same epoch) iff we still hold it; the
        pre-rewrite fence uses this so the destructive window always
        starts with a fresh TTL."""
        if not self.held():
            self.epoch = 0
            return False
        tmp = self._write_temp(self._record(self.epoch, time.time()))
        os.replace(tmp, self.path)
        return True

    def release(self) -> None:
        """Drop the lease if we hold it (best-effort: a crash without
        release is exactly the stale case takeover recovers)."""
        if self.epoch > 0 and self.held():
            try:
                os.unlink(self.path)
            except OSError:
                pass
        self.epoch = 0
