"""Flight recorder: bounded ring of recent finished spans + post-mortem
dumps on typed failures.

An operator debugging a 3am failover cannot retroactively enable verbose
logging. The recorder keeps the last ``DEEQU_TPU_TRACE_RING`` finished
spans in memory at all times (default 4096 — a few MB at worst), and every
TYPED failure path (``DeviceFailureException``, ``ScanStallError``,
``CorruptStateError``, ``SchemaDriftError``, ...) calls
:func:`record_failure`, which

1. stamps a ``failure`` event (exception type + message) on the current
   span, so the trace tree itself explains the degradation;
2. marks the failure's ``trace_id`` dump-pending: the moment that trace's
   root (or owning job span) finishes, the correlated span snippet is
   written as a JSONL artifact under :func:`FlightRecorder.directory`
   (``DEEQU_TPU_FLIGHT_DIR``, else a per-process temp dir);
3. counts the failure kind on ``dump_counts`` regardless, so tests and the
   export plane can assert "a dump fired for every typed failure kind"
   without touching the filesystem.

Dumps are bounded (``_MAX_DUMPS``) so a pathological failure storm in a
long-lived service degrades to counting, never to unbounded artifact
growth. A failure with no live trace (tracing disabled, or a loader hit
outside any span) writes a single standalone record carrying only the
exception, so the signal is never silently dropped.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Any, Dict, List, Optional

#: env var: directory receiving flight-record JSONL artifacts; unset =
#: a lazily-created per-process temp directory (path discoverable via
#: ``recorder().directory()`` and logged on first dump).
FLIGHT_DIR_ENV = "DEEQU_TPU_FLIGHT_DIR"

#: env var: directory receiving this process's span JOURNAL — every
#: finished span teed as one JSONL line to ``spans-<host>.jsonl`` (after a
#: ``journal_header`` line carrying host/pid/epoch anchor). Unset = no
#: journal (the default: the ring alone serves single-process use; multi-
#: host soaks set this per worker so ``export.merge_journals`` can stitch
#: one cross-process Perfetto trace).
TRACE_JOURNAL_ENV = "DEEQU_TPU_TRACE_JOURNAL"

#: env var: logical host label stamped on journal lines and the journal
#: filename; unset = ``pid<os.getpid()>``.
TRACE_HOST_ENV = "DEEQU_TPU_TRACE_HOST"


def journal_host() -> str:
    from ..utils import env_str

    return env_str(TRACE_HOST_ENV) or f"pid{os.getpid()}"

#: hard cap on dump artifacts per process: beyond it, failures only count
_MAX_DUMPS = 256

#: span kinds whose finish closes a "unit of work" and releases any
#: pending dump for their trace: the job span (service path), the
#: verification/analysis roots (direct-call path — these close per run
#: even when the caller holds one long-lived outer span), and true roots
_DUMP_TRIGGER_KINDS = frozenset({"job", "verification", "analysis"})

#: bound on traces awaiting their unit-of-work close: beyond it the oldest
#: pending dump flushes immediately with whatever the ring holds (a
#: partial artifact beats a leaked entry that never dumps — e.g. a typed
#: failure recorded by a watchdog-abandoned zombie whose job already
#: finished)
_MAX_PENDING = 64

_DEFAULT_RING = 4096


def ring_capacity() -> int:
    from ..utils import env_number
    from .trace import TRACE_RING_ENV

    # clamp (not reject) below-minimum values: an operator capping trace
    # memory with a tiny ring must get the 16-entry floor, never a silent
    # fallback to the 4096 default; unparseable values warn once
    return max(16, env_number(TRACE_RING_ENV, _DEFAULT_RING, int))


class FlightRecorder:
    def __init__(self, capacity: Optional[int] = None):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity or ring_capacity())
        #: trace_id -> [(failure kind, exception repr), ...] awaiting the
        #: trace's root/job span so the dump captures the whole tree
        self._pending: Dict[str, List[Dict[str, Any]]] = {}
        #: typed-failure counts by exception class name (monotonic; counted
        #: even when the dump itself was rate-limited away)
        self.dump_counts: Dict[str, int] = {}
        self.dump_paths: List[str] = []
        #: monotonic artifact sequence — RESERVED under the lock before the
        #: write, so two concurrent dumps with the same stem can never
        #: compute the same filename (and the _MAX_DUMPS cap counts
        #: reservations, not completed writes)
        self._dump_seq = 0
        self._dir: Optional[str] = None
        self._logged_dir = False
        #: span-journal tee: None = env not probed yet, False = off (unset
        #: or failed), else the open line-buffered file handle. Probed
        #: lazily so importing the module never touches the filesystem.
        self._journal: Any = None
        self.journal_path: Optional[str] = None

    # -- span intake ---------------------------------------------------------

    def _journal_handle(self):
        """Resolve (once) and return the journal file handle, or False.
        Caller holds ``self._lock``."""
        if self._journal is None:
            from ..utils import env_str

            directory = env_str(TRACE_JOURNAL_ENV)
            if not directory:
                self._journal = False
            else:
                from .trace import EPOCH_ANCHOR_S

                try:
                    os.makedirs(directory, exist_ok=True)
                    host = journal_host()
                    path = os.path.join(directory, f"spans-{host}.jsonl")
                    # line-buffered: each span line hits the fd as it is
                    # written, so a SIGKILLed worker's journal still holds
                    # everything it finished (the kill-one drill reads it)
                    fh = open(path, "a", buffering=1)
                    fh.write(json.dumps({
                        "journal_header": True, "host": host,
                        "pid": os.getpid(),
                        "epoch_anchor_s": EPOCH_ANCHOR_S,
                    }) + "\n")
                    self._journal = fh
                    self.journal_path = path
                except Exception:  # noqa: BLE001 - journal is advisory
                    import logging

                    logging.getLogger(__name__).warning(
                        "could not open span journal under %s=%r",
                        TRACE_JOURNAL_ENV, directory, exc_info=True,
                    )
                    self._journal = False
        return self._journal

    def on_span_finish(self, span) -> None:
        dump_for: Optional[List[Dict[str, Any]]] = None
        with self._lock:
            self._ring.append(span)
            journal = self._journal_handle()
            if journal is not False:
                try:
                    journal.write(
                        json.dumps(span.to_dict(), default=str) + "\n"
                    )
                except Exception:  # noqa: BLE001 - journal is advisory
                    self._journal = False
            # a unit-of-work span closing releases the trace's pending
            # dump: the job span (service path), verification/analysis
            # (direct-call path — a caller's long-lived outer span may
            # never close while the service runs, and waiting for it would
            # both delay the artifact past ring eviction and pin the
            # pending entry), or a true root
            if span.trace_id in self._pending and (
                span.parent_id is None or span.kind in _DUMP_TRIGGER_KINDS
            ):
                dump_for = self._pending.pop(span.trace_id)
        if dump_for is not None:
            self._dump_trace(span.trace_id, dump_for)

    def spans(self) -> List[Any]:
        """Snapshot of the ring, oldest first."""
        with self._lock:
            return list(self._ring)

    def drain(self) -> List[Any]:
        """Snapshot AND clear the ring (per-stage artifact writers)."""
        with self._lock:
            out = list(self._ring)
            self._ring.clear()
            return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._pending.clear()
            self.dump_counts.clear()
            self.dump_paths.clear()
            self._dump_seq = 0
            # re-probe the journal env on next span: tests (and soaks that
            # re-point DEEQU_TPU_TRACE_JOURNAL between stages) rely on
            # clear() being a full reset of the singleton
            if self._journal not in (None, False):
                try:
                    self._journal.close()
                except Exception:  # noqa: BLE001
                    pass
            self._journal = None
            self.journal_path = None

    # -- failure intake ------------------------------------------------------

    def note_failure(
        self, kind: str, trace_id: Optional[str], detail: str
    ) -> None:
        with self._lock:
            self.dump_counts[kind] = self.dump_counts.get(kind, 0) + 1
        if trace_id is not None:
            overflow = None
            with self._lock:
                self._pending.setdefault(trace_id, []).append(
                    {"kind": kind, "detail": detail}
                )
                if len(self._pending) > _MAX_PENDING:
                    # a trace whose unit of work already closed (zombie
                    # failure after its job finished) would otherwise pin
                    # its entry forever: flush the OLDEST pending trace
                    # now with whatever the ring still holds
                    oldest = next(iter(self._pending))
                    overflow = (oldest, self._pending.pop(oldest))
            if overflow is not None:
                self._dump_trace(*overflow)
            return
        # no live trace: write a standalone record so the failure still
        # leaves an artifact behind
        self._write_dump(
            f"flight-untraced-{kind}",
            [{"flight_record": True, "kind": kind, "detail": detail,
              "trace_id": None}],
        )

    # -- dumping -------------------------------------------------------------

    def directory(self) -> str:
        from ..utils import env_str

        env = env_str(FLIGHT_DIR_ENV)
        if env:
            os.makedirs(env, exist_ok=True)
            return env
        if self._dir is None:
            import tempfile

            self._dir = tempfile.mkdtemp(prefix="deequ-tpu-flight-")
        return self._dir

    def _dump_trace(self, trace_id: str, failures: List[Dict[str, Any]]) -> None:
        with self._lock:
            spans = [s for s in self._ring if s.trace_id == trace_id]
        from .trace import EPOCH_ANCHOR_S

        header = {
            "flight_record": True,
            "trace_id": trace_id,
            "failures": failures,
            "spans": len(spans),
            # span timestamps are process-monotonic perf_counter_ns; add
            # the anchor so a post-mortem can place them on wall clock
            # (absolute seconds ~= epoch_anchor_s + start_ns / 1e9)
            "epoch_anchor_s": EPOCH_ANCHOR_S,
        }
        self._write_dump(
            f"flight-{trace_id}",
            [header] + [s.to_dict() for s in spans],
        )

    def _write_dump(self, stem: str, records: List[Dict[str, Any]]) -> None:
        with self._lock:
            if self._dump_seq >= _MAX_DUMPS:
                return
            seq = self._dump_seq
            self._dump_seq += 1
        try:
            path = os.path.join(self.directory(), f"{stem}-{seq}.jsonl")
            with open(path, "w") as fh:
                for record in records:
                    fh.write(json.dumps(record) + "\n")
        except Exception:  # noqa: BLE001 - post-mortem capture is advisory
            import logging

            logging.getLogger(__name__).warning(
                "could not write flight record %s", stem, exc_info=True
            )
            return
        with self._lock:
            self.dump_paths.append(path)
        if not self._logged_dir:
            self._logged_dir = True
            import logging

            logging.getLogger(__name__).info(
                "flight records land in %s", os.path.dirname(path)
            )


_RECORDER: Optional[FlightRecorder] = None
_RECORDER_LOCK = threading.Lock()


def recorder() -> FlightRecorder:
    global _RECORDER
    if _RECORDER is None:
        with _RECORDER_LOCK:
            if _RECORDER is None:
                _RECORDER = FlightRecorder()
    return _RECORDER


def record_failure(exc: BaseException, span=None) -> None:
    """The one call every typed failure path makes: event on the current
    span + flight-recorder dump scheduling + kind counting. Safe (and
    still counted) when tracing is disabled."""
    from . import trace

    target = span if span is not None else trace.current_span()
    kind = type(exc).__name__
    detail = str(exc)[:500]
    if target is not None:
        target.add_event("failure", type=kind, message=detail)
    recorder().note_failure(
        kind, target.trace_id if target is not None else None, detail
    )
