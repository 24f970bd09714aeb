"""Time-partitioned, compacting metrics repository: the fleet-scale
history store behind the anomaly plane (a copy of the JAX package's
``deequ_tpu/repository/partitioned.py``, with the same layout, so either
package reads and compacts the other's history).

The whole-file :class:`~deequ_tpu_torch.repository.fs.FileSystemMetricsRepository`
keeps the WHOLE history in one JSON file — every save rewrites it, every
query parses it, so a year of per-run metrics costs O(all history) per
touch. This layout slots into the :class:`PartitionStateStore` conventions
instead (checksummed entries, quarantine-on-corruption, ``YYYY-MM``
buckets):

- each entry lands in the MONTH BUCKET directory its result key's
  ``data_set_date`` names, so a windowed query walks only the buckets
  intersecting ``[after, before]`` — a year of dailies loads in
  O(queried window), never O(365);
- a save APPENDS one small ``e-<date>-<checksum>.json`` file (no
  whole-history rewrite; 10k tenants saving per harvest stay O(1) each);
  once a bucket accumulates ``compact_threshold`` loose entries they
  COMPACT into the bucket's single ``compacted.json`` array, so steady
  state reads one file + a handful of recent appends per month;
- every entry carries the serde layer's xxhash64 content checksum; a
  corrupt entry/file quarantines content-addressed to
  ``<root>.quarantine/`` and the rest of the history keeps serving (the
  FS repository's stance, kept bucket-local);
- the reference's Gson/JVM metrics-history dialect is an input
  (``import_jvm_history``, through :mod:`deequ_tpu_torch.interop`).

The public API is exactly :class:`MetricsRepository` — callers,
``VerificationSuite.use_repository`` and the anomaly wiring see no
difference. ``path`` may be local or any URI scheme the port's ``io``
supports (``s3://``, ``gs://``, ``memory://``).
"""

from __future__ import annotations

import json
import logging
import threading
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional, Tuple

from .. import io as dio
from ..exceptions import CorruptStateError
from ..runners.context import AnalyzerContext
from . import (
    AnalysisResult,
    MetricsRepository,
    MetricsRepositoryMultipleResultsLoader,
    ResultKey,
)
from .fs import _count_quarantine, entry_outside_window
from .serde import deserialize_result, serialize_result

_logger = logging.getLogger(__name__)

_COMPACTED = "compacted.json"

#: loose entry files a bucket may hold before a save compacts it into the
#: bucket's single array file (the append-vs-rewrite crossover: appends
#: keep saves O(1), compaction keeps reads O(files-in-window) bounded)
DEFAULT_COMPACT_THRESHOLD = 64


def month_bucket(date_ms: int) -> str:
    """The ``YYYY-MM`` bucket a result-key date (epoch millis, UTC) lands
    in — the partition-store convention applied to metric history."""
    return datetime.fromtimestamp(
        int(date_ms) / 1000.0, tz=timezone.utc
    ).strftime("%Y-%m")


class PartitionedMetricsRepository(MetricsRepository):
    """See module docstring. ``monitor`` (a ``RunMonitor``), when given,
    records quarantines on its ``corrupt_quarantined`` counter."""

    def __init__(
        self,
        path: str,
        monitor: Optional[Any] = None,
        compact_threshold: int = DEFAULT_COMPACT_THRESHOLD,
    ):
        self.path = str(path)
        self.monitor = monitor
        self.compact_threshold = int(compact_threshold)
        #: entries fully deserialized by reads (the O(window) pin — same
        #: meaning as the FS repository's counter) and buckets walked
        self.entries_deserialized = 0
        self.buckets_walked = 0
        #: quarantines THIS repository performed (the fleet watch keys
        #: per-tenant corruption attribution on this, never the
        #: process-global counter — concurrent quarantines elsewhere must
        #: not read as this history rotting)
        self.quarantines = 0
        #: serializes compactions: two concurrent compact() merges of one
        #: bucket could otherwise each rewrite compacted.json wholesale
        #: and the loser's rewrite would drop entries the winner merged
        #: (and whose loose files the winner already removed). In-process
        #: half of the story; the CROSS-process half is the lease below.
        self._compact_lock = threading.Lock()
        #: cross-process single-compactor election (repository.lease): a
        #: filesystem lease/fence file beside the root. Only local roots
        #: get one (the link/rename primitives are POSIX); remote roots
        #: keep the documented in-process-only guarantee. Reads and
        #: append-only saves never touch the lease — they are safe against
        #: concurrent compactors by the append-first commit protocol.
        self.lease = None
        if dio.is_local(self.path):
            from .lease import FileLease

            self.lease = FileLease(self.path + ".lease")
        dio.makedirs(self.path)

    # -- layout --------------------------------------------------------------

    def _bucket_dir(self, bucket: str) -> str:
        return dio.join(self.path, bucket)

    @staticmethod
    def _entry_name(entry: Dict[str, Any]) -> str:
        import time as _time

        # the zero-padded nanosecond component makes loose filenames sort
        # by RECENCY within a date, so when a replaced entry's removal
        # fails (best-effort path) the NEWER entry still wins the
        # last-wins merge in _read_all/compact
        date = int(entry["resultKey"]["dataSetDate"])
        return (
            f"e-{date}-{_time.time_ns():020d}-"
            f"{entry.get('checksum', '0')}.json"
        )

    # -- MetricsRepository API -----------------------------------------------

    def save(self, result_key: ResultKey, analyzer_context: AnalyzerContext) -> None:
        """APPEND-FIRST save: the single atomic write of the new loose
        entry IS the commit point — a crash at any moment leaves either
        the old history or old + new, never a missing key (replace-key is
        a READ-side rule: queries and compaction merge last-wins per key
        by recency, so the newest entry serves the moment it lands).
        After the commit, older same-key loose entries prune best-effort
        (same-DATE candidates only — a result key includes its date and
        the date is embedded in the filename, so a save reads O(same-date
        entries), never the bucket). The compacted file is not touched;
        stale same-key entries inside it lose the recency merge and drop
        at the next compaction."""
        successful = AnalyzerContext(
            {a: m for a, m in analyzer_context.metric_map.items() if m.value.is_success}
        )
        entry = serialize_result(AnalysisResult(result_key, successful))
        bucket = month_bucket(result_key.data_set_date)
        bucket_dir = self._bucket_dir(bucket)
        dio.makedirs(bucket_dir)
        name = self._entry_name(entry)
        dio.write_text_atomic(
            dio.join(bucket_dir, name), json.dumps(entry)
        )
        key = entry["resultKey"]
        date_prefix = f"e-{int(key['dataSetDate'])}-"
        n_loose = 0
        for other in dio.list_files(bucket_dir):
            if other == _COMPACTED or not other.startswith("e-"):
                continue
            if other != name and other.startswith(date_prefix):
                raw = self._read_loose(bucket, other)
                if raw is not None and raw.get("resultKey") == key:
                    try:
                        dio.remove_file(dio.join(bucket_dir, other))
                        continue
                    except Exception:  # noqa: BLE001 - the new entry
                        # still wins at read time: merges are last-wins
                        # by the recency sequence in the filename
                        _logger.warning(
                            "could not drop replaced entry %s/%s",
                            bucket, other, exc_info=True,
                        )
            n_loose += 1  # includes the entry just written
        if n_loose >= self.compact_threshold:
            try:
                self.compact(bucket)
            except CorruptStateError:
                # the entry above already committed durably; a TORN
                # compacted file refuses ITS rewrite (quarantined, typed
                # on explicit compact()) but must not make an append-only
                # save read as failed — appends stay safe until the
                # operator restores/clears the torn file
                _logger.warning(
                    "bucket %s/%s is torn; save committed loose, "
                    "compaction deferred", self.path, bucket,
                )

    def load_by_key(self, result_key: ResultKey) -> Optional[AnalyzerContext]:
        date = int(result_key.data_set_date)
        for result in self._read_all(after=date, before=date):
            if result.result_key == result_key:
                return result.analyzer_context
        return None

    def load(self) -> "PartitionedMetricsRepositoryLoader":
        return PartitionedMetricsRepositoryLoader(self)

    # -- compaction ----------------------------------------------------------

    @staticmethod
    def _loose_seq(name: str) -> int:
        """The recency sequence embedded in a loose filename; unparseable
        names read as newest (a foreign file should win over a possibly
        stale compacted entry, never silently lose)."""
        import re

        m = re.match(r"^e--?\d+-(\d{20})-", name)
        return int(m.group(1)) if m else 2 ** 63 - 1

    def _merged_bucket_entries(
        self,
        bucket: str,
        raise_on_torn: bool = False,
        consumed_names: Optional[List[str]] = None,
    ) -> List[Tuple[Dict[str, Any], Optional[str], int]]:
        """One bucket's raw entries, deduplicated LAST-WINS per result key
        by RECENCY: compacted entries carry the bucket's ``compactedAtNs``
        stamp, loose entries the sequence in their filename — so a loose
        file that predates the compaction (a merged file whose removal
        failed) can never shadow the newer compacted entry, and vice
        versa. Returns ``(entry, loose filename or None, seq)`` tuples;
        the filename lets readers self-heal corrupt loose entries."""
        bucket_dir = self._bucket_dir(bucket)
        compacted, compacted_at = self._read_compacted(
            bucket, raise_on_torn=raise_on_torn
        )
        items: List[Tuple[Dict[str, Any], Optional[str], int]] = [
            (e, None, compacted_at) for e in compacted
        ]
        for name in dio.list_files(bucket_dir):
            if name == _COMPACTED or not name.startswith("e-"):
                continue
            raw = self._read_loose(bucket, name)
            if raw is not None:
                # consumed == successfully READ and merged: a transient
                # read failure (remote timeout) must leave the file for
                # the next pass, never let compaction delete an unmerged
                # committed entry
                if consumed_names is not None:
                    consumed_names.append(name)
                items.append((raw, name, self._loose_seq(name)))
        out: List[Tuple[Dict[str, Any], Optional[str], int]] = []
        by_key: Dict[str, int] = {}
        for item in items:
            k = json.dumps(item[0].get("resultKey"), sort_keys=True)
            at = by_key.get(k)
            if at is None:
                by_key[k] = len(out)
                out.append(item)
            elif item[2] >= out[at][2]:
                out[at] = item
        return out

    def compact(self, bucket: str) -> int:
        """Merge a bucket's loose entry files into its single
        ``compacted.json`` (recency-stamped wrapper; last-wins per key);
        returns the compacted entry count, or ``-1`` when another
        process's compactor holds the lease (the entries stay loose and
        readable — refusal is never data loss). Checksum-corrupt entries
        quarantine and DROP here — compaction is where standing bit rot
        self-heals instead of re-quarantining on every read. Torn loose
        files quarantine and drop (bytes preserved in the sidecar); a
        torn compacted file refuses the rewrite typed (rewriting would
        erase whatever it still holds)."""
        with self._compact_lock:
            if self.lease is None:
                return self._compact_locked(bucket)
            if not self.lease.acquire():
                _logger.info(
                    "another compactor holds %s; leaving bucket %s loose",
                    self.lease.path, bucket,
                )
                return -1
            try:
                return self._compact_locked(bucket)
            finally:
                self.lease.release()

    def _compact_locked(self, bucket: str) -> int:
        import time as _time

        from ..integrity import checksum_json

        bucket_dir = self._bucket_dir(bucket)
        # remove EXACTLY the loose files the merge consumed: a save
        # landing concurrently must never be deleted unmerged
        removed: List[str] = []
        merged = self._merged_bucket_entries(
            bucket, raise_on_torn=True, consumed_names=removed
        )
        kept: List[Dict[str, Any]] = []
        for entry, name, _ in merged:
            stored = entry.get("checksum")
            if stored is not None and checksum_json(
                {k: v for k, v in entry.items() if k != "checksum"}
            ) != stored:
                if not self._quarantine(
                    dio.join(bucket_dir, name or _COMPACTED),
                    json.dumps(entry), "entry",
                ):
                    # unwritable sidecar: keep the corrupt entry in the
                    # rewrite rather than destroy its only copy; it drops
                    # at the next compaction once quarantine can preserve
                    kept.append(entry)
            else:
                kept.append(entry)
        if self.lease is not None and not self.lease.renew():
            # the FENCE: we stalled past the lease TTL mid-merge and a
            # takeover happened — rewriting compacted.json now could drop
            # entries the new holder merged. Abort with the bucket's loose
            # files untouched (they stay readable; the live holder or a
            # later compaction consumes them).
            _logger.warning(
                "compaction lease lost mid-merge; leaving bucket %s/%s "
                "loose", self.path, bucket,
            )
            return -1
        stamp = _time.time_ns()
        dio.write_text_atomic(
            dio.join(bucket_dir, _COMPACTED),
            json.dumps({"compactedAtNs": stamp, "entries": kept}),
        )
        for name in removed:
            try:
                dio.remove_file(dio.join(bucket_dir, name))
            except Exception:  # noqa: BLE001 - a surviving loose file's
                # seq PREDATES compactedAtNs, so it loses every future
                # merge and drops at the next compaction
                _logger.warning(
                    "could not remove compacted entry %s/%s", bucket, name,
                    exc_info=True,
                )
        return len(kept)

    def compaction_lag(self) -> Dict[str, Any]:
        """How far behind the compactor is: loose (uncompacted) entry
        counts per bucket. ``max_loose`` against ``threshold`` is the ops
        signal — a bucket sitting well past the threshold means the
        compactor cannot win the lease or keeps hitting a torn file
        (the /statusz partition-store section surfaces this)."""
        per_bucket: Dict[str, int] = {}
        for bucket in self.buckets():
            n_loose = sum(
                1 for name in dio.list_files(self._bucket_dir(bucket))
                if name != _COMPACTED and name.startswith("e-")
            )
            per_bucket[bucket] = n_loose
        return {
            "buckets": per_bucket,
            "max_loose": max(per_bucket.values(), default=0),
            "threshold": self.compact_threshold,
        }

    # -- reads ---------------------------------------------------------------

    def buckets(self) -> List[str]:
        return dio.list_dirs(self.path)

    def _window_buckets(
        self, after: Optional[int], before: Optional[int]
    ) -> List[str]:
        lo = month_bucket(after) if after is not None else None
        hi = month_bucket(before) if before is not None else None
        out = []
        for bucket in self.buckets():
            if lo is not None and bucket < lo:
                continue
            if hi is not None and bucket > hi:
                continue
            out.append(bucket)
        return out

    def _read_compacted(
        self, bucket: str, raise_on_torn: bool = False
    ) -> Tuple[List[Dict[str, Any]], int]:
        """``(entries, compactedAtNs)`` of a bucket's compacted file (0
        when never compacted). The payload is a recency-stamped wrapper —
        the stamp is what lets the merge order compacted entries against
        loose files correctly."""
        from ..reliability.faults import fault_point

        path = dio.join(self._bucket_dir(bucket), _COMPACTED)
        payload = None
        if dio.exists(path):
            with dio.open_file(path, "r") as fh:
                payload = fh.read()
        try:
            # chaos site: an injected "corrupt" fault stands in for a
            # bucket whose bytes rotted — the poisoned-history drill's
            # target (same site name as the FS repository: one knob
            # poisons either layout). Probed per BUCKET read, whether or
            # not the bucket has compacted yet.
            fault_point("repository_load", tag=path)
            if payload is None or not payload.strip():
                return [], 0
            doc = json.loads(payload)
            if not (
                isinstance(doc, dict) and isinstance(doc.get("entries"), list)
            ):
                raise ValueError("compacted payload is not a stamped wrapper")
            return doc["entries"], int(doc.get("compactedAtNs", 0))
        except (ValueError, CorruptStateError) as exc:
            self._quarantine(path, payload or "", "bucket")
            if raise_on_torn:
                raise CorruptStateError(
                    "metrics-repository bucket", path, str(exc)
                ) from exc
            return [], 0

    def _read_loose(self, bucket: str, name: str) -> Optional[Dict[str, Any]]:
        path = dio.join(self._bucket_dir(bucket), name)
        try:
            with dio.open_file(path, "r") as fh:
                payload = fh.read()
        except (OSError, FileNotFoundError):
            return None  # racing save/compact removed it
        try:
            entry = json.loads(payload)
            if not isinstance(entry, dict):
                raise ValueError("entry payload is not a JSON object")
            return entry
        except ValueError:
            if self._quarantine(path, payload, "entry-file"):
                # self-heal only once the bytes are safe in the sidecar —
                # an unwritable quarantine dir must not destroy the only
                # forensic copy
                try:
                    dio.remove_file(path)
                except Exception:  # noqa: BLE001 - re-quarantines next read
                    pass
            return None

    def _read_all(
        self, after: Optional[int] = None, before: Optional[int] = None
    ) -> List[AnalysisResult]:
        """Entries inside [after, before] (inclusive, the loader filter),
        walking ONLY the month buckets intersecting the window and
        deserializing only in-window entries — the O(queried window)
        contract. Per-entry checksum failures quarantine that entry and
        the rest keeps serving."""
        results: List[AnalysisResult] = []
        for bucket in self._window_buckets(after, before):
            self.buckets_walked += 1
            bucket_dir = self._bucket_dir(bucket)
            for entry, loose_name, _ in self._merged_bucket_entries(bucket):
                if entry_outside_window(entry, after, before):
                    continue
                # provenance for errors/quarantine names the file that
                # actually held the entry — the rotten loose file's path,
                # not the (possibly intact) compacted.json
                source = dio.join(bucket_dir, loose_name or _COMPACTED)
                try:
                    self.entries_deserialized += 1
                    results.append(deserialize_result(entry, source=source))
                except CorruptStateError as exc:
                    preserved = self._quarantine(
                        source, json.dumps(entry), "entry"
                    )
                    _logger.warning(
                        "skipped corrupt entry in %s: %s", source, exc
                    )
                    if loose_name is not None and preserved:
                        # self-heal: the rotten LOOSE entry's bytes are
                        # safe in the sidecar; dropping the file stops
                        # every later read from re-quarantining it
                        # (compaction does the same for compacted
                        # entries). An unwritable sidecar keeps the file
                        # — never destroy the only forensic copy.
                        try:
                            dio.remove_file(
                                dio.join(bucket_dir, loose_name)
                            )
                        except Exception:  # noqa: BLE001 - re-heals on
                            # a later read or at compaction
                            pass
        return results

    # -- JVM interop ---------------------------------------------------------

    def import_jvm_history(self, payload: str, source: str = "<jvm>") -> int:
        """Read a reference-written (Gson dialect) metrics-history JSON
        payload and save every entry into the partitioned layout; returns
        the entry count. The JVM dialect stays an INPUT format — storage
        is always the checksummed native layout."""
        from ..interop import read_jvm_metrics_history_json

        results = read_jvm_metrics_history_json(payload, source=source)
        for result in results:
            self.save(result.result_key, result.analyzer_context)
        return len(results)

    # -- quarantine ----------------------------------------------------------

    def _quarantine(self, source: str, payload: str, kind: str) -> bool:
        """Content-addressed sidecar copy under ``<root>.quarantine/``
        (idempotent re-quarantine — the FS repository convention);
        best-effort, and counted on the shared process-wide repository
        quarantine counter. Returns whether the bytes were actually
        PRESERVED — self-heal paths must not delete the only copy of a
        corrupt payload when the sidecar is unwritable."""
        from ..integrity import checksum_bytes

        side_dir = self.path + ".quarantine"
        data = payload.encode("utf-8")
        name = f"{kind}-{checksum_bytes(data)}.json"
        preserved = True
        try:
            dio.makedirs(side_dir)
            dio.write_text_atomic(dio.join(side_dir, name), payload)
            where = dio.join(side_dir, name)
        except Exception:  # noqa: BLE001 - best-effort preservation
            where = "<unwritable quarantine dir>"
            preserved = False
        _count_quarantine()
        self.quarantines += 1
        if self.monitor is not None:
            try:
                self.monitor.bump("corrupt_quarantined")
            except Exception:  # noqa: BLE001 - observability only
                pass
        from ..observability import trace as _trace

        _trace.add_event(
            "repository_quarantined", kind=kind, where=where, source=source,
        )
        _logger.warning(
            "quarantined corrupt repository %s from %s to %s",
            kind, source, where,
        )
        return preserved

    def __repr__(self) -> str:
        return f"PartitionedMetricsRepository({self.path!r})"


class PartitionedMetricsRepositoryLoader(MetricsRepositoryMultipleResultsLoader):
    def __init__(self, repository: PartitionedMetricsRepository):
        super().__init__()
        self._repository = repository

    def _all_results(self) -> List[AnalysisResult]:
        # the window pushes down to the bucket walk: out-of-window months
        # are never listed, out-of-window entries never deserialized
        return self._repository._read_all(
            after=self._after, before=self._before
        )
