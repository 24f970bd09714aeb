"""Partition-keyed algebraic state store: the durable half of incremental
verification (a copy of the JAX package's
``deequ_tpu/repository/partition_store.py``, with the same on-disk layout
and manifest JSON, so a store written by either package serves the other).

A :class:`PartitionStateStore` holds, per ``(dataset, partition)``, the
per-analyzer algebraic states one scan of that partition produced, plus a
checksummed manifest recording what those states are states OF:

- the **schema-contract fingerprint** the battery ran under (column
  names + kinds): states folded under a different schema must never merge
  with these, so a fingerprint mismatch invalidates the partition;
- the partition's **content checksum** (a caller-supplied version token —
  file etag, snapshot id — or a digest computed from the materialized
  payload): a mismatch means the partition's bytes changed and its stored
  states are stale;
- the **analyzer keys** covered: a battery that grew since the partition
  was scanned cannot be served from a store that lacks the new analyzer's
  state, so coverage is checked per query;
- the partition's **row count** and schema (so a fully-reused plan knows
  its totals and schema with zero data touched).

State blobs ride the checksummed v2 ``.npz`` / parquet path
(:class:`~deequ_tpu_torch.analyzers.state_provider.FileSystemStateProvider`
per partition directory), so integrity semantics (verified checksums,
typed :class:`~deequ_tpu_torch.exceptions.CorruptStateError`, no pickle)
are inherited. A corrupt manifest or blob QUARANTINES to a
content-addressed ``<root>.quarantine/`` sidecar and surfaces typed; the
delta planner answers by re-scanning exactly that partition.

Directory layout is TIME-PARTITIONED: partitions whose names start with a
``YYYY-MM`` date land under a month bucket directory, everything else
under a stable hash bucket, so listing a queried window over a year of
daily partitions walks O(months in window) directories, not O(365).

``path`` may be local or any URI scheme the port's ``io`` supports
(``s3://``, ``gs://``, ``memory://``), exactly like the state provider.
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import io as dio
from ..analyzers.state_provider import (
    FileSystemStateProvider,
    StateLoader,
    _sanitize_namespace_part,
)
from ..exceptions import CorruptStateError

_logger = logging.getLogger(__name__)

#: manifest layout version; the loader refuses newer versions instead of
#: misreading them (the state-serde convention)
PARTITION_MANIFEST_VERSION = 1

#: env var: root path (local or URI) of the service's default partition
#: store. Unset = the service has no partition store (sessions don't
#: flush, verify_partitioned requires an explicit store).
PARTITION_STORE_ENV = "DEEQU_TPU_PARTITION_STORE"

#: env var: default listing window in MONTH BUCKETS for
#: ``list_partitions`` calls with no explicit window (0 = unlimited).
#: Date-named partitions outside the most recent N month buckets are not
#: walked — a year of daily partitions lists in O(window), the
#: time-partitioned layout's whole point. Non-date (hash-bucket)
#: partitions are always listed. Warn-and-fallback convention: an
#: unparseable value warns once and keeps the default.
PARTITION_WINDOW_ENV = "DEEQU_TPU_PARTITION_WINDOW_MONTHS"


def partition_window_months() -> int:
    from ..utils import env_number

    return env_number(PARTITION_WINDOW_ENV, 0, int, minimum=0)


def default_partition_store(monitor: Optional[Any] = None):
    """The process-default store from ``DEEQU_TPU_PARTITION_STORE``, or
    None when the env var is unset."""
    from ..utils import env_str

    path = env_str(PARTITION_STORE_ENV)
    if not path:
        return None
    return PartitionStateStore(path, monitor=monitor)

_MANIFEST = "partition-manifest.json"

#: partition names starting with a YYYY-MM(-DD...) date bucket by month
_DATE_BUCKET_RE = re.compile(r"^(\d{4})-(\d{2})(?:\b|[-T_])")

#: process-wide count of quarantined partition payloads, for tests and the
#: chaos soak (the FS repository keeps the analogous counter for entries)
_QUARANTINE_LOCK = threading.Lock()
_QUARANTINED_TOTAL = 0


def partition_quarantined_total() -> int:
    with _QUARANTINE_LOCK:
        return _QUARANTINED_TOTAL


def _count_quarantine(n: int = 1) -> None:
    global _QUARANTINED_TOTAL
    with _QUARANTINE_LOCK:
        _QUARANTINED_TOTAL += n


def partition_bucket(partition: str) -> str:
    """The time bucket a partition lists under: ``YYYY-MM`` for
    date-named partitions (a year of dailies lists in O(queried months)),
    else a stable 2-hex-char hash bucket (bounded fanout for arbitrary
    names)."""
    m = _DATE_BUCKET_RE.match(partition)
    if m:
        return f"{m.group(1)}-{m.group(2)}"
    from ..integrity import checksum_bytes

    return "x" + checksum_bytes(partition.encode("utf-8"))[:2]


@dataclass(frozen=True)
class PartitionManifest:
    """One committed partition's verified manifest."""

    dataset: str
    partition: str
    fingerprint: str
    content_checksum: Optional[str]
    num_rows: int
    analyzer_keys: Tuple[str, ...]
    schema: Tuple[Tuple[str, str], ...]  # ((name, kind), ...)
    created_at_ms: int

    def covers(self, analyzer_keys: Sequence[str]) -> bool:
        """Whether this partition's stored states cover every analyzer in
        ``analyzer_keys`` (a battery that grew needs a re-scan; one that
        shrank reuses the superset)."""
        have = set(self.analyzer_keys)
        return all(k in have for k in analyzer_keys)


@dataclass(frozen=True)
class RollupManifest:
    """What the persisted rollup states fold (see the rollup section of
    :class:`PartitionStateStore`)."""

    dataset: str
    fingerprint: str
    analyzer_keys: Tuple[str, ...]
    #: ordered (partition, content-checksum) pairs the rollup folds
    folded: Tuple[Tuple[str, Optional[str]], ...]
    num_rows: int

    def covers(self, analyzer_keys: Sequence[str]) -> bool:
        have = set(self.analyzer_keys)
        return all(k in have for k in analyzer_keys)


class PartitionStateStore:
    """Per-(dataset, partition) algebraic state store; see module
    docstring. ``monitor`` (a ``RunMonitor``), when given, records
    quarantines on its ``corrupt_quarantined`` counter."""

    def __init__(self, path: str, monitor: Optional[Any] = None):
        self.path = str(path)
        self.monitor = monitor
        dio.makedirs(self.path)

    # -- paths ---------------------------------------------------------------

    def _partition_dir(self, dataset: str, partition: str) -> str:
        return dio.join(
            self.path,
            "ds-" + _sanitize_namespace_part(str(dataset)),
            partition_bucket(str(partition)),
            "p-" + _sanitize_namespace_part(str(partition)),
        )

    def provider(self, dataset: str, partition: str) -> FileSystemStateProvider:
        """The partition's state provider (the checksummed v2 .npz /
        parquet path): scans persist through it, merges load through it."""
        return FileSystemStateProvider(self._partition_dir(dataset, partition))

    def loader(self, dataset: str, partition: str) -> StateLoader:
        """Read-side alias of :meth:`provider` (the delta planner hands
        these to the aggregated-states merge)."""
        return self.provider(dataset, partition)

    # -- manifest lifecycle --------------------------------------------------

    def commit(
        self,
        dataset: str,
        partition: str,
        *,
        fingerprint: str,
        content_checksum: Optional[str],
        num_rows: int,
        analyzer_keys: Sequence[str],
        schema: Optional[Sequence[Tuple[str, str]]] = None,
        created_at_ms: Optional[int] = None,
    ) -> PartitionManifest:
        """Write the partition's manifest — called AFTER its state blobs
        persisted, so a crash mid-scan leaves no manifest and the next
        plan simply re-scans (the invalidate-first checkpoint
        convention)."""
        manifest = PartitionManifest(
            dataset=str(dataset),
            partition=str(partition),
            fingerprint=str(fingerprint),
            content_checksum=(
                None if content_checksum is None else str(content_checksum)
            ),
            num_rows=int(num_rows),
            analyzer_keys=tuple(str(k) for k in analyzer_keys),
            schema=tuple(
                (str(n), str(k)) for n, k in (schema or ())
            ),
            created_at_ms=(
                int(created_at_ms)
                if created_at_ms is not None
                else int(time.time() * 1000)
            ),
        )
        d: Dict[str, Any] = {
            "formatVersion": PARTITION_MANIFEST_VERSION,
            "dataset": manifest.dataset,
            "partition": manifest.partition,
            "fingerprint": manifest.fingerprint,
            "contentChecksum": manifest.content_checksum,
            "numRows": manifest.num_rows,
            "analyzerKeys": list(manifest.analyzer_keys),
            "schema": [[n, k] for n, k in manifest.schema],
            "createdAtMs": manifest.created_at_ms,
        }
        from ..integrity import checksum_json

        d["checksum"] = checksum_json(d)
        part_dir = self._partition_dir(dataset, partition)
        dio.makedirs(part_dir)
        dio.write_text_atomic(dio.join(part_dir, _MANIFEST), json.dumps(d))
        return manifest

    def invalidate(self, dataset: str, partition: str) -> None:
        """Drop the partition's manifest (its blobs stay until the re-scan
        overwrites them): the invalidate-FIRST half of a changed-partition
        re-scan, so a crash between invalidation and the new commit costs
        a re-scan, never a half-new half-old merge."""
        path = dio.join(self._partition_dir(dataset, partition), _MANIFEST)
        if dio.exists(path):
            try:
                self._remove_file(path)
            except Exception:  # noqa: BLE001 - best effort; a manifest
                # that survives is re-checked (and re-invalidated) by the
                # next plan
                _logger.warning(
                    "could not invalidate partition manifest %s", path,
                    exc_info=True,
                )

    @staticmethod
    def _remove_file(path: str) -> None:
        dio.remove_file(path)

    def get(
        self, dataset: str, partition: str
    ) -> Optional[PartitionManifest]:
        """The partition's verified manifest, or None when it was never
        committed (or was invalidated). A corrupt manifest — torn write,
        flipped byte, unparseable JSON — QUARANTINES and raises the typed
        :class:`CorruptStateError` the recovery layers key on (the delta
        planner answers by re-scanning the partition)."""
        from ..reliability.faults import fault_point

        path = dio.join(self._partition_dir(dataset, partition), _MANIFEST)
        # chaos site: an injected "corrupt" fault here stands in for a
        # manifest whose bytes rotted after it was committed
        fault_point("partition_store_load", tag=f"{dataset}/{partition}")
        if not dio.exists(path):
            return None
        with dio.open_file(path, "r") as fh:
            payload = fh.read()
        try:
            d = json.loads(payload)
            version = int(d.get("formatVersion", 1))
            if version > PARTITION_MANIFEST_VERSION or version < 1:
                from ..exceptions import UnsupportedFormatVersionError

                raise UnsupportedFormatVersionError(
                    "partition manifest", version, PARTITION_MANIFEST_VERSION
                )
            from ..integrity import verify_json_checksum

            verify_json_checksum(
                {k: v for k, v in d.items() if k != "checksum"},
                d.get("checksum", ""), "partition manifest", path,
            )
            return PartitionManifest(
                dataset=str(d["dataset"]),
                partition=str(d["partition"]),
                fingerprint=str(d["fingerprint"]),
                content_checksum=(
                    None if d.get("contentChecksum") is None
                    else str(d["contentChecksum"])
                ),
                num_rows=int(d["numRows"]),
                analyzer_keys=tuple(d["analyzerKeys"]),
                schema=tuple((n, k) for n, k in d.get("schema", [])),
                created_at_ms=int(d.get("createdAtMs", 0)),
            )
        except CorruptStateError:
            self._quarantine(path, payload, "checksum mismatch")
            raise
        except Exception as exc:  # noqa: BLE001 - torn JSON = corrupt
            from ..exceptions import UnsupportedFormatVersionError

            if isinstance(exc, UnsupportedFormatVersionError):
                # a NEWER manifest is refused, not quarantined: treating
                # it as corrupt would re-scan and OVERWRITE a store a
                # newer build owns (the state-serde refusal convention)
                raise
            self._quarantine(path, payload, str(exc))
            raise CorruptStateError(
                "partition manifest", path, str(exc)
            ) from exc

    def quarantine_states(self, dataset: str, partition: str, reason: str) -> None:
        """A stored state BLOB of this partition failed its load (torn
        .npz, checksum trip): preserve the partition's payload files in
        the quarantine sidecar and invalidate the manifest, so the next
        plan re-scans instead of re-tripping (the repository's
        quarantine-and-keep-serving stance applied per partition)."""
        part_dir = self._partition_dir(dataset, partition)
        try:
            import os

            if dio.is_local(part_dir) and os.path.isdir(part_dir):
                for name in sorted(os.listdir(part_dir)):
                    src = os.path.join(part_dir, name)
                    if os.path.isfile(src):
                        with open(src, "rb") as fh:
                            self._quarantine_bytes(src, fh.read(), reason)
        except Exception:  # noqa: BLE001 - preservation is best-effort
            _logger.warning(
                "could not quarantine partition payload %s", part_dir,
                exc_info=True,
            )
        self.invalidate(dataset, partition)
        _count_quarantine()
        if self.monitor is not None:
            try:
                self.monitor.bump("corrupt_quarantined")
            except Exception:  # noqa: BLE001 - observability only
                pass
        from ..observability import trace as _trace

        _trace.add_event(
            "partition_quarantined", dataset=str(dataset),
            partition=str(partition), reason=str(reason)[:200],
        )
        _logger.warning(
            "quarantined corrupt partition %s/%s: %s",
            dataset, partition, reason,
        )

    def _quarantine(self, source: str, payload: str, reason: str) -> None:
        self._quarantine_bytes(source, payload.encode("utf-8"), reason)
        _count_quarantine()
        if self.monitor is not None:
            try:
                self.monitor.bump("corrupt_quarantined")
            except Exception:  # noqa: BLE001 - observability only
                pass
        _logger.warning(
            "quarantined corrupt partition manifest %s: %s", source, reason
        )

    def _quarantine_bytes(self, source: str, payload: bytes, reason: str) -> None:
        """Content-addressed sidecar copy (idempotent re-quarantine, the
        FS repository convention); best-effort — an unwritable store must
        not turn a survivable corruption into a crash."""
        from ..integrity import checksum_bytes

        side_dir = self.path + ".quarantine"
        import os

        name = (
            f"{os.path.basename(source)}-{checksum_bytes(payload)}"
        )
        try:
            dio.makedirs(side_dir)
            with dio.open_file(dio.join(side_dir, name), "wb") as fh:
                fh.write(payload)
        except Exception:  # noqa: BLE001 - best-effort preservation
            pass

    # -- rollup cache --------------------------------------------------------
    #
    # The merged LEFT-FOLD of a dataset's partition sequence, persisted so
    # an append-only growth run folds ``rollup + suffix`` (O(1) state
    # loads) instead of re-loading every partition's states (O(N) — the
    # dominant cost of a fully-reused merge). The fold is
    # associativity-safe bitwise: ``merge_states_batched_many`` is a
    # sequential left fold, so ``fold(fold(p1..pk), pk+1..pn)`` equals
    # ``fold(p1..pn)`` exactly. The rollup manifest records the ORDERED
    # (partition, content-checksum) list it folds; any prefix mismatch —
    # changed/dropped/reordered partitions, fingerprint or battery drift —
    # rebuilds from the per-partition states (which remain the source of
    # truth; the rollup is purely a cache).

    def _rollup_dir(self, dataset: str) -> str:
        # lives beside the time buckets; the lister only walks "p-"
        # entries inside buckets, so the rollup never lists as a partition
        return dio.join(
            self.path, "ds-" + _sanitize_namespace_part(str(dataset)),
            "rollup",
        )

    def rollup_provider(self, dataset: str) -> FileSystemStateProvider:
        return FileSystemStateProvider(self._rollup_dir(dataset))

    def rollup_commit(
        self,
        dataset: str,
        *,
        fingerprint: str,
        analyzer_keys: Sequence[str],
        folded: Sequence[Tuple[str, Optional[str]]],
        num_rows: int,
    ) -> None:
        """Record what the persisted rollup states fold — called AFTER
        the merged states persisted (invalidate-first discipline: callers
        `rollup_invalidate` before overwriting the blobs)."""
        d: Dict[str, Any] = {
            "formatVersion": PARTITION_MANIFEST_VERSION,
            "dataset": str(dataset),
            "fingerprint": str(fingerprint),
            "analyzerKeys": [str(k) for k in analyzer_keys],
            "folded": [
                [str(n), None if c is None else str(c)] for n, c in folded
            ],
            "numRows": int(num_rows),
            "createdAtMs": int(time.time() * 1000),
        }
        from ..integrity import checksum_json

        d["checksum"] = checksum_json(d)
        roll_dir = self._rollup_dir(dataset)
        dio.makedirs(roll_dir)
        dio.write_text_atomic(dio.join(roll_dir, _MANIFEST), json.dumps(d))

    def rollup_invalidate(self, dataset: str) -> None:
        path = dio.join(self._rollup_dir(dataset), _MANIFEST)
        if dio.exists(path):
            try:
                self._remove_file(path)
            except Exception:  # noqa: BLE001 - see invalidate()
                _logger.warning(
                    "could not invalidate rollup manifest %s", path,
                    exc_info=True,
                )

    def rollup_get(self, dataset: str) -> Optional["RollupManifest"]:
        """The verified rollup manifest, or None. Corruption quarantines
        and returns None — the rollup is a CACHE; its loss costs a
        re-merge from partition states, never an error."""
        path = dio.join(self._rollup_dir(dataset), _MANIFEST)
        if not dio.exists(path):
            return None
        with dio.open_file(path, "r") as fh:
            payload = fh.read()
        try:
            d = json.loads(payload)
            from ..integrity import verify_json_checksum

            verify_json_checksum(
                {k: v for k, v in d.items() if k != "checksum"},
                d.get("checksum", ""), "rollup manifest", path,
            )
            return RollupManifest(
                dataset=str(d["dataset"]),
                fingerprint=str(d["fingerprint"]),
                analyzer_keys=tuple(d["analyzerKeys"]),
                folded=tuple(
                    (n, None if c is None else str(c))
                    for n, c in d["folded"]
                ),
                num_rows=int(d["numRows"]),
            )
        except Exception as exc:  # noqa: BLE001 - cache loss, not error
            self._quarantine(path, payload, str(exc))
            self.rollup_invalidate(dataset)
            return None

    # -- listing / retention -------------------------------------------------

    def list_partitions(
        self,
        dataset: str,
        after: Optional[str] = None,
        before: Optional[str] = None,
    ) -> List[str]:
        """Committed partition names of ``dataset``, sorted. ``after`` /
        ``before`` (PREFIX-inclusive partition-name bounds — ``"2026-01"``
        includes every ``2026-01-*`` partition) restrict the walk to
        month buckets intersecting the window — the O(queried window)
        listing contract; non-date (hash-bucket) partitions are always
        walked, their names filtered."""
        ds_dir = dio.join(
            self.path, "ds-" + _sanitize_namespace_part(str(dataset))
        )
        out: List[str] = []
        buckets = self._list_dirs(ds_dir)
        if after is None and before is None:
            window = partition_window_months()
            if window > 0:
                # default-window listing: only the most recent N month
                # buckets are walked (hash buckets always are)
                dated = sorted(
                    b for b in buckets if _DATE_BUCKET_RE.match(b + "-")
                )
                keep = set(dated[-window:])
                buckets = [
                    b for b in buckets
                    if b in keep or not _DATE_BUCKET_RE.match(b + "-")
                ]
        for bucket in buckets:
            if _DATE_BUCKET_RE.match(bucket + "-"):
                # a month bucket wholly outside the window cannot contain
                # a partition inside it (bucket == name[:7] for date
                # names): skip the directory walk entirely
                if after is not None and bucket < str(after)[:7]:
                    continue
                if before is not None and bucket > str(before)[:7]:
                    continue
            bucket_dir = dio.join(ds_dir, bucket)
            for entry in self._list_dirs(bucket_dir):
                if not entry.startswith("p-"):
                    continue
                if not dio.exists(
                    dio.join(bucket_dir, entry, _MANIFEST)
                ):
                    continue  # never committed / invalidated
                name = self._unsanitize(entry[2:])
                # prefix-inclusive bounds: compare only the bound's
                # length of the name, so before="2026-05" keeps
                # "2026-05-31"
                if after is not None and name[: len(str(after))] < str(after):
                    continue
                if (
                    before is not None
                    and name[: len(str(before))] > str(before)
                ):
                    continue
                out.append(name)
        return sorted(out)

    @staticmethod
    def _list_dirs(path: str) -> List[str]:
        # an absent prefix lists empty; auth/network failures RAISE (an
        # unreachable store reading as "no partitions" would silently
        # re-scan 100% of the data)
        return dio.list_dirs(path)

    @staticmethod
    def _unsanitize(safe: str) -> str:
        """Invert `_sanitize_namespace_part`'s injective escaping."""
        if safe in ("_.", "_.."):
            return safe[1:]
        out = bytearray()
        i = 0
        while i < len(safe):
            ch = safe[i]
            if ch == "_" and i + 3 <= len(safe):
                try:
                    out.append(int(safe[i + 1:i + 3], 16))
                    i += 3
                    continue
                except ValueError:
                    pass
            out.extend(ch.encode("utf-8"))
            i += 1
        return out.decode("utf-8", errors="replace")

    def delete(self, dataset: str, partition: str) -> bool:
        """Retention: drop one partition's manifest AND state blobs.
        Returns whether anything existed. Metrics stay consistent because
        suite metrics are always a RE-MERGE of the surviving partitions —
        nothing is subtracted from anything."""
        part_dir = self._partition_dir(dataset, partition)
        import os

        if dio.is_local(part_dir) and not os.path.isdir(part_dir):
            return False
        # manifest first: a reader racing the delete sees "never
        # committed", not a manifest whose blobs are vanishing
        try:
            self.invalidate(dataset, partition)
            dio.remove_dir(part_dir)
            return True
        except Exception:  # noqa: BLE001
            return False

    def __repr__(self) -> str:
        return f"PartitionStateStore({self.path!r})"
