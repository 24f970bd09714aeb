"""HTTP ingest endpoint: the Arrow IPC wire frontend on the export plane.

``POST /ingest/v1/<tenant>/<dataset>`` with an Arrow IPC stream body
folds each record batch into the named streaming session, one atomic
micro-batch merge per frame, and answers with the fold report as JSON.
The endpoint rides the existing :class:`~deequ_tpu_torch.service.metrics.
MetricsExporter` HTTP plane (same server, same port as ``/metrics``), so
a service that exports metrics already has an ingest socket.

Contract:

- the session must already exist (created by the operator with its
  checks via ``service.session(...)``): an unknown session is 404 — the
  endpoint never auto-creates a zero-check session that would verify
  nothing and always report SUCCESS;
- ``X-Deequ-Checksum`` (optional) carries the xxhash64 hex digest of the
  raw body; a mismatch is 400 and nothing folds;
- bounded admission maps to 429 (``ServiceOverloaded`` — the scheduler
  shed the fold), schema drift to 409, a closed session to 410, a closed
  service to 503, malformed frames to 400;
- a client that disconnects mid-body tears the stream typed: complete
  leading frames stay committed, the torn tail never folds, and the
  disconnect is counted (no response can reach a dead client, so the
  counters + flight record ARE the observable). If the request DECLARED
  a checksum, a torn body can never verify it — nothing folds at all,
  because folding unverified frames would bypass the digest tripwire.
"""

from __future__ import annotations

import json
import logging
from typing import Optional, Tuple

_logger = logging.getLogger(__name__)

from ..exceptions import (
    FeedDisconnectError,
    MalformedFrameError,
    SchemaDriftError,
)
from .arrow_stream import (
    CHECKSUM_HEADER,
    describe_ingest_metrics,
    fold_stream,
)

#: route prefix the exporter dispatches to this endpoint
INGEST_PREFIX = "/ingest/v1/"


def _unquote(component: str) -> str:
    from urllib.parse import unquote

    return unquote(component)



def _typed_error_response(exc, metrics, labels, source) -> Tuple[int, dict]:
    """One shared mapping from typed fold errors to HTTP responses —
    the buffered and incremental paths must never diverge on status
    semantics."""
    if isinstance(exc, MalformedFrameError):
        return 400, {"error": "malformed_frame", "detail": str(exc)}
    if isinstance(exc, SchemaDriftError):
        return 409, {"error": "schema_drift", "detail": str(exc)}
    from .rowgate import FrameQuarantinedError

    if isinstance(exc, FrameQuarantinedError):
        # every row of the frame failed the tenant's row-level schema:
        # nothing folded, the frame sits in the quarantine sidecar —
        # 422 (the payload is well-FORMED Arrow, its CONTENT is
        # unprocessable), distinct from the 400 decode failures
        return 422, {"error": "frame_quarantined", "detail": str(exc)}
    from ..service.errors import (
        JobFailed,
        JobTimeout,
        QuotaExceeded,
        ServiceClosed,
        ServiceOverloaded,
        SessionClosed,
    )

    # QuotaExceeded BEFORE its ServiceOverloaded parent: both are 429,
    # but the body must tell the producer whether ITS budget or the
    # GLOBAL queue was the limit (the remedies differ: back off vs
    # retry-later)
    if isinstance(exc, QuotaExceeded):
        metrics.inc("deequ_service_ingest_shed_total", **labels)
        return 429, {"error": "quota_exceeded", "detail": str(exc),
                     "resource": exc.resource}
    if isinstance(exc, ServiceOverloaded):
        metrics.inc("deequ_service_ingest_shed_total", **labels)
        return 429, {"error": "overloaded", "detail": str(exc)}
    if isinstance(exc, SessionClosed):
        return 410, {"error": "session_closed"}
    if isinstance(exc, ServiceClosed):
        return 503, {"error": "service_closed"}
    if isinstance(exc, JobTimeout):
        return 504, {"error": "fold_timeout", "detail": str(exc)}
    if isinstance(exc, JobFailed):
        return 500, {"error": "fold_failed", "detail": str(exc)}
    _logger.warning("ingest %s: unexpected failure", source, exc_info=True)
    return 500, {"error": "internal", "detail": str(exc)}


class IngestEndpoint:
    """Stateless request handler bound to one VerificationService."""

    def __init__(self, service):
        self.service = service
        describe_ingest_metrics(service.metrics)

    # -- routing -------------------------------------------------------------

    def matches(self, path: str) -> bool:
        return path.startswith(INGEST_PREFIX)

    def parse_target(self, path: str) -> Optional[Tuple[str, str]]:
        rest = path[len(INGEST_PREFIX):]
        if "?" in rest:
            rest = rest.split("?", 1)[0]
        parts = [p for p in rest.split("/") if p]
        if len(parts) != 2:
            return None
        return _unquote(parts[0]), _unquote(parts[1])

    # -- request handling ----------------------------------------------------

    def handle_post(self, path: str, headers, rfile) -> Tuple[int, dict]:
        """Process one POST; returns ``(http_status, json_body)``. Never
        raises — every failure mode maps to a typed JSON error body (the
        transport layer decides whether a client is still there to read
        it).

        ``X-Deequ-Trace`` (optional) carries a serialized trace context
        from the producer: the request span — and every fold/decode span
        under it — parents into the REMOTE trace, so a cross-process
        ingest shows up as one trace_id end to end."""
        from ..observability import trace as _trace

        parent = _trace.extract(headers.get(_trace.TRACE_HEADER))
        sp = _trace.start_span(
            "ingest_request", kind="ingest", attrs={"path": path},
            parent=parent if parent is not None else "auto",
        )
        with _trace.attach(sp):
            try:
                status, body = self._handle_post_traced(
                    path, headers, rfile
                )
            except BaseException as exc:
                if sp is not _trace.NULL:
                    sp.set_attr("error", f"{type(exc).__name__}: {exc}")
                sp.finish("error")
                raise
        if sp is not _trace.NULL:
            sp.set_attr("status", status)
        sp.finish("ok" if status < 400 else "error")
        return status, body

    def _handle_post_traced(
        self, path: str, headers, rfile
    ) -> Tuple[int, dict]:
        target = self.parse_target(path)
        if target is None:
            return 404, {"error": "not_found", "detail": (
                f"expected {INGEST_PREFIX}<tenant>/<dataset>"
            )}
        tenant, dataset = target
        session = self.service.get_session(tenant, dataset,
                                           include_closed=True)
        plane = getattr(self.service, "catalog_plane", None)
        if session is None and plane is not None and plane.catalog.registered(
            tenant
        ):
            # catalog auto-open: a REGISTERED tenant's first POST
            # materializes its session from the catalog document (checks,
            # gate, quotas, watches all from the declarative suite) — the
            # cold->hot promotion of the tenant tiering. UNREGISTERED
            # tenants keep the 404 below: the endpoint still never
            # invents a zero-check session.
            from ..service.catalog import CatalogError

            try:
                session = plane.ensure_session(tenant, dataset)
            except CatalogError as exc:
                # registered but unservable (every version corrupt, no
                # last-good): the tenant EXISTS, the catalog is the sick
                # part — 503 so the producer retries after the operator
                # repairs the document, instead of a 404 baiting it into
                # re-registering
                return 503, {"error": "catalog_error", "tenant": tenant,
                             "detail": str(exc)}
        if session is None:
            return 404, {"error": "unknown_session", "tenant": tenant,
                         "dataset": dataset, "detail": (
                             "create the session (with its checks) via "
                             "service.session(), or register the tenant "
                             "in the catalog, before feeding it"
                         )}
        if session.closed:
            # "gone", not "never existed": the documented 410 contract —
            # a producer retrying on 404 by re-registering must NOT be
            # told to do that for a deliberately closed session
            return 410, {"error": "session_closed", "tenant": tenant,
                         "dataset": dataset}
        if plane is not None:
            # the fold-boundary hook: touch the tenant's hot-tier idle
            # clock and (debounced) poll its document version, hot-
            # reloading the session when the catalog was edited —
            # tolerant of sessions the plane did not open
            plane.on_fold_boundary(session)
        metrics = self.service.metrics
        labels = {"tenant": tenant, "dataset": dataset}
        try:
            declared = int(headers.get("Content-Length", "0"))
        except ValueError:
            return 411, {"error": "length_required"}
        if declared <= 0:
            return 411, {"error": "length_required"}
        source = f"http:{tenant}/{dataset}"
        checksum = headers.get(CHECKSUM_HEADER)
        if checksum is None:
            # INCREMENTAL decode: frames fold as they arrive off the
            # socket — a GB-scale stream holds one frame in memory, not
            # its whole body. Only possible WITHOUT a declared digest:
            # a checksum must verify over the complete payload before
            # anything folds (the tripwire contract), so checksummed
            # requests keep the buffered path below.
            return self._handle_incremental(
                session, rfile, declared, source, metrics, labels
            )
        try:
            body = rfile.read(declared)
        except OSError:
            # socket timeout/reset mid-body: whatever partial data the
            # buffered reader held is gone with the raise — a pure
            # disconnect, nothing decodable arrived
            metrics.inc("deequ_service_ingest_disconnects_total", **labels)
            from ..observability import record_failure

            record_failure(FeedDisconnectError(source, detail="socket error"))
            return 400, {"error": "feed_disconnect", "received_bytes": 0,
                         "declared_bytes": declared}
        if len(body) < declared:
            # the producer DECLARED a digest and a torn body can never
            # verify it: folding unverified leading frames would bypass
            # the exact tripwire the digest exists for (a flipped byte
            # decodes silently in Arrow IPC), so nothing folds. (Digest-
            # free requests never reach here — they ride the incremental
            # path, whose disconnect contract folds the whole leading
            # frames.)
            metrics.inc(
                "deequ_service_ingest_disconnects_total", **labels
            )
            from ..observability import record_failure

            record_failure(FeedDisconnectError(
                source, bytes_read=len(body),
                detail="checksummed stream torn; nothing folded",
            ))
            return 400, {
                "error": "feed_disconnect",
                "declared_bytes": declared,
                "received_bytes": len(body),
                "detail": "declared checksum cannot be verified on a "
                          "torn body; nothing folded",
            }
        try:
            report = fold_stream(
                session, body, checksum=checksum, complete=True,
                source=source,
            )
        except Exception as exc:  # noqa: BLE001 - typed service errors
            return _typed_error_response(exc, metrics, labels, source)
        return 200, {"ok": True, **report.to_dict()}

    def _handle_incremental(
        self, session, rfile, declared: int, source: str, metrics, labels
    ) -> Tuple[int, dict]:
        """Unbuffered body handling: Arrow frames decode straight off the
        socket and fold one by one — memory holds one frame, not the
        declared Content-Length. Torn-tail semantics are the documented
        disconnect contract (complete leading frames stay committed, the
        tail never folds, the tear is counted + flight-recorded by the
        fold machinery)."""
        from .arrow_stream import BoundedReader, fold_stream_reader

        reader = BoundedReader(rfile, declared)
        try:
            report = fold_stream_reader(session, reader, source=source)
        except FeedDisconnectError:
            return 400, {
                "error": "feed_disconnect",
                "declared_bytes": declared,
                "received_bytes": reader.bytes_read,
            }
        except Exception as exc:  # noqa: BLE001 - typed service errors
            # drain the remainder so a keep-alive connection stays framed
            # (the client may still be sending)
            reader.drain()
            return _typed_error_response(exc, metrics, labels, source)
        reader.drain()
        if reader.bytes_read < declared:
            # every frame decoded but the body came up short (the length
            # header lied high): still a disconnect for accounting —
            # the buffered path's exact contract
            metrics.inc("deequ_service_ingest_disconnects_total", **labels)
            return 400, {
                "error": "feed_disconnect",
                "declared_bytes": declared,
                "received_bytes": reader.bytes_read,
            }
        return 200, {"ok": True, **report.to_dict()}


def render_response(status: int, body: dict) -> bytes:
    return json.dumps(body, sort_keys=True).encode()
