"""Row-level ingest gating: the streaming promotion of
`deequ_tpu_torch.schema` onto the Arrow ingest path.

The reference's row-level validator (`schema/RowLevelSchemaValidator.
scala:25-223`) is a BATCH tool: hand it a DataFrame, get a valid/invalid
split back. At fleet scale the split has to happen on the WIRE, before
anything folds — one tenant's malformed rows must never reach a session's
persisted algebraic states, and the rejected rows must stay recoverable
for producer triage rather than vanishing into a counter. This module is
that gate:

- **one vectorized conformance mask per frame** — the gate calls
  :func:`deequ_tpu_torch.schema.compute_conformance`, the EXACT pass the batch
  validator uses, so the two paths can never diverge on a verdict (pinned
  by the ported ``RowLevelSchemaValidatorTest`` scenarios, run against
  both);
- **clean rows fold bit-exact** — the accept side is an Arrow
  ``table.filter`` of the ORIGINAL buffers (no pandas round-trip, no
  cast), so folding the gated stream equals folding a pre-filtered copy
  of it, metric for metric;
- **typed, bounded, content-addressed quarantine** — rejected rows write
  as Arrow IPC sidecar files named by their payload checksum (the
  partition store's ``.quarantine`` convention), bounded by
  ``DEEQU_TPU_ROWGATE_QUARANTINE_MAX_ROWS`` with overflow counted, and
  :meth:`QuarantineSidecar.read_all` decodes them back to exactly the
  rejected rows;
- **a frame with ZERO conforming rows raises** a typed
  :class:`FrameQuarantinedError` (HTTP 422 on the endpoint) — folding
  nothing silently would report SUCCESS for a producer whose every row
  is garbage;
- the ``row_gate`` fault site wires the gate into the chaos plane
  (`deequ_tpu_torch.reliability.faults`): an injected ``corrupt`` fault stands
  in for a frame whose mask cannot even be computed.

Gate policy normally arrives from the tenant catalog
(`deequ_tpu_torch.service.catalog`, the ``row_gate`` document section); the
class is equally constructible by hand for in-process streams.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

_logger = logging.getLogger(__name__)

from ..exceptions import MetricCalculationRuntimeException
from ..schema import RowLevelSchema, compute_conformance
from ..utils import env_number

#: row budget of one QuarantineSidecar before overflow rows are DROPPED
#: (counted, never silently): a producer whose every frame is garbage
#: must not fill the disk with its own rejects. Warn-once parser.
QUARANTINE_MAX_ROWS_ENV = "DEEQU_TPU_ROWGATE_QUARANTINE_MAX_ROWS"
DEFAULT_QUARANTINE_MAX_ROWS = 100_000


def quarantine_max_rows() -> int:
    return int(env_number(
        QUARANTINE_MAX_ROWS_ENV, DEFAULT_QUARANTINE_MAX_ROWS, int, minimum=0
    ))


class FrameQuarantinedError(MetricCalculationRuntimeException):
    """Every row of an ingest frame failed the tenant's row-level schema:
    nothing folded, the whole frame went to the quarantine sidecar.
    Raised INSTEAD of folding an empty delta — a producer whose entire
    output is nonconforming must hear a typed rejection (HTTP 422), not a
    SUCCESS verdict computed over zero of its rows. Partial rejections do
    NOT raise: the conforming rows fold, the rest quarantine, and the
    split surfaces on the ``deequ_service_rowgate_*`` series."""

    def __init__(self, tenant: str, dataset: str, rows: int,
                 detail: str = ""):
        self.tenant = str(tenant)
        self.dataset = str(dataset)
        self.rows = int(rows)
        super().__init__(
            f"all {rows} row(s) of a frame for {tenant}/{dataset} failed "
            "row-level schema validation; nothing folded, the frame is "
            "quarantined" + (f": {detail}" if detail else "")
        )


def describe_rowgate_metrics(metrics) -> None:
    """Register HELP text for every export-plane series the row gate
    increments (idempotent). Literal per-series calls — the statlint
    export-completeness check matches these statically."""
    metrics.describe(
        "deequ_service_rowgate_frames_total",
        "Ingest frames that passed through a row-level gate (clean and "
        "split frames both count).",
    )
    metrics.describe(
        "deequ_service_rowgate_rows_total",
        "Rows ACCEPTED by row-level gates (the clean side of the split "
        "that went on to fold).",
    )
    metrics.describe(
        "deequ_service_rowgate_rejected_rows_total",
        "Rows rejected by row-level gates and routed to the quarantine "
        "sidecar (never folded).",
    )
    metrics.describe(
        "deequ_service_rowgate_quarantined_frames_total",
        "Frames FULLY rejected by a row-level gate (typed "
        "FrameQuarantinedError; HTTP 422; nothing folded).",
    )
    metrics.describe(
        "deequ_service_rowgate_quarantine_bytes_total",
        "Arrow IPC bytes written to row-gate quarantine sidecars.",
    )
    metrics.describe(
        "deequ_service_rowgate_quarantine_dropped_rows_total",
        "Rejected rows DROPPED because the quarantine sidecar hit its "
        "row budget (DEEQU_TPU_ROWGATE_QUARANTINE_MAX_ROWS).",
    )


def _sanitize(component: str) -> str:
    from urllib.parse import quote

    return quote(str(component), safe="")


class QuarantineSidecar:
    """Bounded, content-addressed Arrow quarantine for rejected rows.

    Layout: ``<root>/t-<tenant>/d-<dataset>/<checksum>.arrows`` — each
    file one Arrow IPC stream of rejected rows, named by the xxhash64
    checksum of its own payload (the partition store's ``.quarantine``
    naming), so re-quarantining identical rejects is idempotent and every
    file self-verifies. Bounded by ``max_rows`` across the sidecar's
    lifetime in this process; overflow rows are counted and dropped,
    never written. Writes are best-effort: a full disk must not turn a
    survivable rejection into a crash (the rows still COUNT as rejected
    either way — the gate's accept side never depends on the sidecar)."""

    def __init__(self, path: str, max_rows: Optional[int] = None):
        self.path = str(path)
        self.max_rows = (
            quarantine_max_rows() if max_rows is None else int(max_rows)
        )
        self._lock = threading.Lock()
        self.rows_written = 0
        self.rows_dropped = 0
        self.bytes_written = 0

    def quarantine(self, table, tenant: str, dataset: str) -> int:
        """Write ``table``'s rows (an arrow Table of rejects) into the
        sidecar, honoring the row budget. Returns the bytes written (0
        when the budget dropped everything or the write failed)."""
        from .arrow_stream import encode_ipc_stream

        with self._lock:
            budget = (
                max(self.max_rows - self.rows_written, 0)
                if self.max_rows else table.num_rows
            )
            keep = min(int(table.num_rows), budget)
            dropped = int(table.num_rows) - keep
            self.rows_dropped += dropped
            self.rows_written += keep
        if keep == 0:
            return 0
        payload = encode_ipc_stream(table.slice(0, keep))
        from .. import io as dio
        from ..integrity import checksum_bytes

        side_dir = dio.join(
            self.path, f"t-{_sanitize(tenant)}", f"d-{_sanitize(dataset)}"
        )
        name = f"{checksum_bytes(payload)}.arrows"
        try:
            dio.makedirs(side_dir)
            with dio.open_file(dio.join(side_dir, name), "wb") as fh:
                fh.write(payload)
        except Exception:  # noqa: BLE001 - best-effort preservation
            _logger.warning(
                "could not write row-gate quarantine sidecar under %s",
                side_dir, exc_info=True,
            )
            return 0
        with self._lock:
            self.bytes_written += len(payload)
        return len(payload)

    def read_all(self, tenant: str, dataset: str):
        """Decode every sidecar file for ``(tenant, dataset)`` back into
        ONE arrow Table of the rejected rows (None when nothing was
        quarantined) — the triage/acceptance read path: the quarantine
        must decode back to exactly the rows the gate rejected."""
        import pyarrow as pa

        from .. import io as dio

        side_dir = dio.join(
            self.path, f"t-{_sanitize(tenant)}", f"d-{_sanitize(dataset)}"
        )
        def plain(table):
            # frames arrive with per-frame encoding decisions (adaptive
            # dictionary encoding probes each dataset independently), so
            # sibling sidecar files can disagree on a column's encoding;
            # decode to the value type so the concat is one uniform table
            # of the rejected VALUES
            for i, f in enumerate(table.schema):
                if pa.types.is_dictionary(f.type):
                    table = table.set_column(
                        i, f.name, table.column(i).cast(f.type.value_type)
                    )
            return table

        tables = []
        for name in dio.list_files(side_dir):
            if not name.endswith(".arrows"):
                continue
            with dio.open_file(dio.join(side_dir, name), "rb") as fh:
                with pa.ipc.open_stream(fh.read()) as reader:
                    tables.append(plain(reader.read_all()))
        if not tables:
            return None
        return pa.concat_tables(tables)


class RowGate:
    """The per-session streaming gate: one conformance mask per frame,
    BEFORE the fold. Stateless between frames except the sidecar's row
    budget; thread-safety rides the session's fold serialization (the
    gate runs on the ingest caller's thread, before submission)."""

    def __init__(
        self,
        schema: RowLevelSchema,
        *,
        sidecar: Optional[QuarantineSidecar] = None,
        metrics=None,
    ):
        self.schema = schema
        self.sidecar = sidecar
        self.metrics = metrics
        if metrics is not None:
            describe_rowgate_metrics(metrics)

    def split(self, data, tenant: str, dataset: str):
        """Gate one frame: returns the Dataset of CONFORMING rows (the
        original dataset object, untouched, when every row conforms — the
        zero-copy fast path), quarantines the rest, and raises typed
        :class:`FrameQuarantinedError` when nothing conforms."""
        from ..data import Dataset
        from ..observability import trace as _trace
        from ..reliability.faults import fault_point

        # chaos site: a `corrupt` fault here stands in for a frame the
        # conformance mask cannot be computed over — surfaced typed
        # BEFORE anything folds, exactly like a real undecodable frame
        fault_point("row_gate", tag=f"{tenant}/{dataset}")
        table = data.arrow
        # convert only the columns the schema reads, as bare Series: the
        # mask is row-level, so the frame's other (often wide, often
        # numeric) columns never pay the pandas hop — and the gated ones
        # skip DataFrame construction entirely
        names = set(table.schema.names)
        cols = {
            cd.name: table.column(cd.name).to_pandas()
            for cd in self.schema.column_definitions
            if cd.name in names
        }
        n = int(table.num_rows)
        matches, _ = compute_conformance(cols, self.schema, num_rows=n)
        accepted = int(matches.sum())
        labels = {"tenant": tenant, "dataset": dataset}
        updates = [
            ("deequ_service_rowgate_frames_total", 1.0, labels),
            ("deequ_service_rowgate_rows_total", float(accepted), labels),
        ]
        if accepted == n:
            if self.metrics is not None:
                self.metrics.inc_many(updates)
            return data
        import pyarrow as pa

        mask = pa.array(matches)
        rejected = table.filter(pa.array(~matches))
        quarantine_bytes = 0
        if self.sidecar is not None:
            dropped_before = self.sidecar.rows_dropped
            quarantine_bytes = self.sidecar.quarantine(
                rejected, tenant, dataset
            )
            dropped = self.sidecar.rows_dropped - dropped_before
            if dropped:
                updates.append((
                    "deequ_service_rowgate_quarantine_dropped_rows_total",
                    float(dropped), labels,
                ))
            if quarantine_bytes:
                updates.append((
                    "deequ_service_rowgate_quarantine_bytes_total",
                    float(quarantine_bytes), labels,
                ))
        updates.append((
            "deequ_service_rowgate_rejected_rows_total",
            float(n - accepted), labels,
        ))
        _trace.add_event(
            "rowgate_rejected", session=f"{tenant}/{dataset}",
            rows=n - accepted, accepted=accepted,
            quarantine_bytes=quarantine_bytes,
        )
        if accepted == 0:
            updates.append((
                "deequ_service_rowgate_quarantined_frames_total", 1.0, labels,
            ))
            if self.metrics is not None:
                self.metrics.inc_many(updates)
            exc = FrameQuarantinedError(tenant, dataset, n)
            from ..observability import record_failure

            # a fully-rejected frame is a typed failure an operator will
            # want the trace artifact for (which producer, which frame)
            record_failure(exc)
            raise exc
        if self.metrics is not None:
            self.metrics.inc_many(updates)
        # the accept side filters the ORIGINAL arrow buffers: no pandas
        # hop, no cast — folding these rows is bit-exact with folding a
        # pre-filtered copy of the producer's stream. probe_encoding=False
        # because this is a derived view of an already-probed dataset: the
        # parent's dictionary-encoding verdict stands, so a filtered frame
        # can never drift its session's schema contract by re-probing a
        # now-smaller column as low-cardinality
        return Dataset(table.filter(mask), probe_encoding=False)
