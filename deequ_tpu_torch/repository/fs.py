"""File-backed metrics repository: the whole history lives in ONE json file;
save = read-all, replace-key, rewrite — simple and atomic enough for metric
histories, exactly the reference's strategy
(reference `repository/fs/FileSystemMetricsRepository.scala:41-57`). The
path may be local or any URI scheme `io` supports (``s3://``,
``gs://``, ``memory://``, ...) — the reference reads/writes the same file
through Hadoop `FileSystem` (`io/DfsUtils.scala:24-85`).

Integrity: every entry carries an xxhash64 content checksum
(`serde.serialize_result`); a corrupt entry — flipped byte, torn write,
concurrent-writer shear — is QUARANTINED to a ``<path>.quarantine/``
sidecar and counted, instead of poisoning every query loader over the
history. Corruption never crashes a reader: the remaining entries keep
serving (the same partial-results-are-a-feature stance the analyzer
taxonomy takes).

A copy of the JAX package's module, without its tracing and fault sites
(not ported); a quarantine is logged."""

from __future__ import annotations

import json
import logging
import threading
from typing import Any, List, Optional

from .. import io as dio
from ..exceptions import CorruptStateError
from ..runners.context import AnalyzerContext
from . import (
    AnalysisResult,
    MetricsRepository,
    MetricsRepositoryMultipleResultsLoader,
    ResultKey,
)
from .serde import deserialize_result, serialize_results

_logger = logging.getLogger(__name__)

#: process-wide count of quarantined repository payloads (entries or whole
#: files), for tests and the chaos soak; per-run attribution goes through
#: the repository's optional RunMonitor
_QUARANTINE_LOCK = threading.Lock()
_QUARANTINED_TOTAL = 0


def quarantined_total() -> int:
    with _QUARANTINE_LOCK:
        return _QUARANTINED_TOTAL


def _count_quarantine(n: int = 1) -> None:
    global _QUARANTINED_TOTAL
    with _QUARANTINE_LOCK:
        _QUARANTINED_TOTAL += n


class FileSystemMetricsRepository(MetricsRepository):
    """The whole history in one JSON file, in the JAX package's layout."""

    def __init__(self, path: str):
        self.path = path
        #: entries fully deserialized (checksum-verified + metric map
        #: materialized) by this repository's reads — the windowed-load
        #: regression pin: a bounded query must never deserialize entries
        #: outside its [after, before] window, even on this legacy
        #: one-file layout
        self.entries_deserialized = 0
        #: quarantines THIS repository performed (per-instance corruption
        #: attribution — the fleet watch reads this, never the
        #: process-global counter)
        self.quarantines = 0

    def save(self, result_key: ResultKey, analyzer_context: AnalyzerContext) -> None:
        successful = AnalyzerContext(
            {a: m for a, m in analyzer_context.metric_map.items() if m.value.is_success}
        )
        # raise_on_torn_file: QUERIES over a structurally-torn history may
        # serve the empty set (quarantine-and-continue), but a SAVE must
        # not follow by rewriting the file with only the new entry — that
        # would silently erase every entry the torn file still holds.
        # Saving raises typed instead; the operator restores/clears the
        # file (the quarantine sidecar preserves its bytes) and retries.
        existing = [
            r
            # count=False: entries_deserialized is the READ-path windowed
            # pin; the rewrite's own full read must not pollute it
            for r in self._read_all(raise_on_torn_file=True, count=False)
            if r.result_key != result_key
        ]
        existing.append(AnalysisResult(result_key, successful))
        payload = serialize_results(existing)
        # local: write-rename so a crash mid-write never corrupts the
        # history; object stores: one atomic put
        dio.write_text_atomic(self.path, payload)

    def load_by_key(self, result_key: ResultKey) -> Optional[AnalyzerContext]:
        for result in self._read_all():
            if result.result_key == result_key:
                return result.analyzer_context
        return None

    def load(self) -> "FileSystemMetricsRepositoryMultipleResultsLoader":
        return FileSystemMetricsRepositoryMultipleResultsLoader(self)

    # -- quarantine ----------------------------------------------------------

    def _quarantine(self, payload: str, reason: str, kind: str) -> None:
        """Copy a corrupt payload into the ``<path>.quarantine/`` sidecar
        and count it. Sidecar names are CONTENT-ADDRESSED (the payload's
        checksum), so re-reading the same unrepaired corruption for weeks
        rewrites one idempotent file instead of accumulating a timestamped
        copy per read — and concurrent quarantines of one payload land on
        one name. Quarantine is best-effort: failing to WRITE the sidecar
        (read-only store) must not turn a survivable corruption into a
        crash — the payload is still skipped, just not preserved."""
        from ..integrity import checksum_bytes

        side_dir = self.path + ".quarantine"
        name = f"{kind}-{checksum_bytes(payload.encode('utf-8'))}.json"
        try:
            dio.makedirs(side_dir)
            dio.write_text_atomic(dio.join(side_dir, name), payload)
            where = dio.join(side_dir, name)
        except Exception:  # noqa: BLE001 - best-effort preservation
            where = "<unwritable quarantine dir>"
        _count_quarantine()
        self.quarantines += 1
        _logger.warning(
            "quarantined corrupt repository %s from %s to %s: %s",
            kind, self.path, where, reason,
        )

    def _read_all(
        self,
        raise_on_torn_file: bool = False,
        after: Optional[int] = None,
        before: Optional[int] = None,
        count: bool = True,
    ) -> List[AnalysisResult]:
        """All entries — or, with ``after``/``before`` bounds, only the
        entries inside the window. Even on this one-file layout a bounded
        query must not pay O(all history) deserialization: the structural
        JSON parse is unavoidable (one file), but each entry's result-key
        date is PEEKED from the raw dict first and out-of-window entries
        are skipped before their checksums verify or their metric maps
        materialize (``entries_deserialized`` pins it). An entry whose key
        cannot even be peeked still deserializes, so the quarantine path
        sees it."""
        if not dio.exists(self.path):
            return []
        with dio.open_file(self.path, "r") as f:
            payload = f.read()
        if not payload.strip():
            return []
        try:
            entries = json.loads(payload)
        except (ValueError, CorruptStateError) as exc:
            # the file itself is torn (a flip landed on JSON structure):
            # quarantine the whole payload; queries serve an empty history,
            # saves refuse (see ``save``) so valid entries are never
            # rewritten away
            self._quarantine(payload, str(exc), "file")
            if raise_on_torn_file:
                raise CorruptStateError(
                    "metrics-repository file", self.path, str(exc)
                ) from exc
            return []
        results: List[AnalysisResult] = []
        for entry in entries:
            if entry_outside_window(entry, after, before):
                continue
            try:
                if count:
                    self.entries_deserialized += 1
                results.append(deserialize_result(entry, source=self.path))
            except CorruptStateError as exc:
                self._quarantine(
                    json.dumps(entry), str(exc), "entry"
                )
        return results


def entry_outside_window(
    entry: Any, after: Optional[int], before: Optional[int]
) -> bool:
    """Whether a RAW serialized entry's result-key date provably falls
    outside [after, before] (both inclusive, matching the loader's
    filter). Unpeekable entries answer False so they still flow through
    full deserialization — and its quarantine path."""
    if after is None and before is None:
        return False
    try:
        date = int(entry["resultKey"]["dataSetDate"])
    except (KeyError, TypeError, ValueError):
        return False
    if after is not None and date < after:
        return True
    return before is not None and date > before


class FileSystemMetricsRepositoryMultipleResultsLoader(MetricsRepositoryMultipleResultsLoader):
    def __init__(self, repository: FileSystemMetricsRepository):
        super().__init__()
        self._repository = repository

    def _all_results(self) -> List[AnalysisResult]:
        # push the time window down: entries outside [after, before] are
        # skipped BEFORE deserialization (get() re-applies the same filter
        # on the survivors, which is then a no-op)
        return self._repository._read_all(
            after=self._after, before=self._before
        )
