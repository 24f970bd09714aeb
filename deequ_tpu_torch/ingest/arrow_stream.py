"""Zero-copy Arrow IPC streaming frontend for the ingestion plane.

The wire format is the standard Arrow IPC *stream* (schema message, then
record batches, then EOS): anything that speaks Arrow — a Flight client, a
``pa.ipc.new_stream`` writer, polars, DuckDB ``COPY TO`` — can feed a
streaming session directly. Decoding is zero-copy over the received
buffer: each record batch's columns are views into the payload bytes, and
`deequ_tpu_torch.data.Dataset` keeps them lazy (dictionary-encoded string
columns map straight onto the engine's cached distinct-value hash path;
numeric columns are copied to the device from the buffer views).

A copy of the JAX package's module: host code. A frame's fold runs on the
service's scheduler workers, which launch the kernels; nothing here
touches a tensor.

Failure contract (each frame is one atomic micro-batch fold):

- a payload whose declared xxhash64 checksum does not match, or whose
  bytes fail structural decode with the stream fully present, raises a
  typed :class:`MalformedFrameError` BEFORE anything folds;
- a stream that ends mid-frame raises a typed :class:`FeedDisconnectError`
  — frames that decoded completely before the tear have already folded,
  the torn tail never touches state;
- both paths are fault-injectable at the ``frame_decode`` site (kind
  ``frame_corrupt``), flight-recorded, and counted on the export plane.

Arrow IPC itself carries NO data checksum — a flipped byte inside a
buffer body decodes silently — so producers
that care about integrity send the optional xxhash64 digest of the whole
payload (the ``X-Deequ-Checksum`` header on the HTTP plane, the
``checksum=`` argument in-process). Verification uses the same vectorized
`deequ_tpu_torch.integrity.checksum_bytes` the durable state plane uses.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Iterator, List, Optional, Sequence, Tuple, Union

_logger = logging.getLogger(__name__)

from ..exceptions import FeedDisconnectError, MalformedFrameError

try:
    import pyarrow as pa
except ImportError:  # pragma: no cover - pyarrow is in the base image
    pa = None

#: HTTP header carrying the optional xxhash64 hex digest of the raw body
CHECKSUM_HEADER = "X-Deequ-Checksum"

#: pyarrow error fragments that mean "the stream ran out of bytes" (the
#: producer died / the payload was truncated) rather than "the bytes are
#: structurally wrong". Pinned against pyarrow 22 by tests.
_TRUNCATION_MARKERS = (
    "Expected to be able to read",
    "but only read",
    "bytes available",
    "was null or length 0",
)


def _looks_truncated(exc: BaseException) -> bool:
    msg = str(exc)
    return any(marker in msg for marker in _TRUNCATION_MARKERS)


def encode_ipc_stream(
    data: Union["pa.Table", Sequence["pa.RecordBatch"]],
    *,
    max_chunksize: Optional[int] = None,
) -> bytes:
    """Serialize a table (or record batches) to Arrow IPC stream bytes —
    the producer side of the wire contract, used by tests and by
    ``chip_smoke.py``'s tenant plane."""
    import io

    if isinstance(data, pa.Table):
        batches = data.to_batches(max_chunksize=max_chunksize)
        schema = data.schema
    else:
        batches = list(data)
        if not batches:
            raise ValueError("cannot encode an empty batch sequence")
        schema = batches[0].schema
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, schema) as writer:
        for batch in batches:
            writer.write_batch(batch)
    return sink.getvalue()


def iter_frames(
    payload: Union[bytes, bytearray, memoryview, "pa.Buffer"],
    *,
    source: str = "<bytes>",
    complete: bool = True,
) -> Iterator[Tuple[int, "pa.RecordBatch"]]:
    """Decode an Arrow IPC stream payload into ``(index, record_batch)``
    pairs with the typed failure contract.

    ``complete=True`` asserts the whole declared payload is present (the
    checksum verified, or the transport delivered its full Content-Length)
    — every decode error is then a :class:`MalformedFrameError`, because
    nothing more is coming. ``complete=False`` means the transport may
    have delivered a prefix; truncation-shaped decode errors become
    :class:`FeedDisconnectError`."""
    from ..reliability.faults import fault_point

    if not isinstance(payload, pa.Buffer):
        payload = pa.py_buffer(payload)
    n_bytes = payload.size
    try:
        reader = pa.ipc.open_stream(pa.BufferReader(payload))
    except Exception as exc:  # noqa: BLE001 - typed below
        if not complete and _looks_truncated(exc):
            raise FeedDisconnectError(
                source, frames_decoded=0, bytes_read=n_bytes, detail=str(exc)
            ) from exc
        raise MalformedFrameError(source, str(exc), frame_index=0) from exc
    index = 0
    while True:
        # chaos site: an injected frame_corrupt stands in for garbled
        # bytes the structural decode cannot see (IPC has no checksum)
        fault_point("frame_decode", tag=str(index))
        try:
            batch = reader.read_next_batch()
        except StopIteration:
            return
        except MalformedFrameError:
            raise
        except Exception as exc:  # noqa: BLE001 - typed below
            if not complete and _looks_truncated(exc):
                raise FeedDisconnectError(
                    source, frames_decoded=index, bytes_read=n_bytes,
                    detail=str(exc),
                ) from exc
            raise MalformedFrameError(
                source, str(exc), frame_index=index
            ) from exc
        yield index, batch
        index += 1


@dataclass
class IngestReport:
    """What one stream fold accomplished: per-frame verification results
    plus the byte/row accounting the export plane mirrors."""

    source: str
    frames: int = 0
    rows: int = 0
    bytes: int = 0
    results: List[Any] = field(default_factory=list)

    @property
    def statuses(self) -> List[str]:
        out = []
        for r in self.results:
            status = getattr(r, "status", None)
            out.append(getattr(status, "value", str(status)))
        return out

    def to_dict(self) -> dict:
        return {
            "source": self.source,
            "frames": self.frames,
            "rows": self.rows,
            "bytes": self.bytes,
            "statuses": self.statuses,
        }


def fold_stream(
    session,
    payload: Union[bytes, bytearray, memoryview, "pa.Buffer"],
    *,
    checksum: Optional[str] = None,
    complete: bool = True,
    source: str = "<bytes>",
    timeout: Optional[float] = None,
) -> IngestReport:
    """Fold every record batch of an Arrow IPC stream payload into a
    :class:`~deequ_tpu_torch.service.streaming.StreamingSession`, one atomic
    micro-batch merge per frame. The shared implementation behind the HTTP
    ingest endpoint and in-process Arrow feeds.

    ``checksum`` (xxhash64 hex of the raw payload) is verified BEFORE any
    decode — a mismatch is a :class:`MalformedFrameError` and nothing
    folds. Schema drift, admission shedding and session lifecycle errors
    propagate typed from ``session.ingest`` exactly as on the in-process
    path; frames already folded when a later frame fails stay committed
    (the report in the raised error's ``__notes__`` is not needed — the
    session's ``batches_ingested`` is the commit log).
    """
    from ..observability import record_failure
    from ..observability import trace as _trace

    from .columnar import as_dataset

    if not isinstance(payload, pa.Buffer):
        payload = pa.py_buffer(payload)
    report = IngestReport(source=source, bytes=payload.size)
    metrics = session.service.metrics
    labels = {"tenant": session.tenant, "dataset": session.dataset}
    with _trace.span(
        "ingest_stream", kind="ingest", source=source,
        tenant=session.tenant, dataset=session.dataset,
        payload_bytes=payload.size,
    ) as sp:
        metrics.inc("deequ_service_ingest_sessions_total", **labels)
        if checksum is not None:
            try:
                from ..integrity import checksum_bytes

                # memoryview over the arrow buffer: the digest reads the
                # payload in place, no second copy of a large stream
                actual = checksum_bytes(memoryview(payload))
                if actual != str(checksum).lower():
                    raise MalformedFrameError(
                        source,
                        f"payload checksum mismatch (declared {checksum}, "
                        f"computed {actual})",
                    )
            except MalformedFrameError as exc:
                record_failure(exc)
                metrics.inc(
                    "deequ_service_ingest_malformed_total", **labels
                )
                raise
        _fold_frames(
            session,
            iter_frames(payload, source=source, complete=complete),
            report, sp, timeout,
        )
        # bytes count once per COMPLETED stream: a rejected payload's
        # bytes were never ingested, so MB/s on the plane stays honest
        metrics.inc(
            "deequ_service_ingest_bytes_total", float(payload.size), **labels
        )
    return report


def _fold_frames(session, frames, report: IngestReport, sp, timeout) -> None:
    """The shared per-frame fold loop (buffered and incremental paths):
    one atomic micro-batch merge per decoded frame, typed failures
    counted + flight-recorded, committed leading frames never rolled
    back."""
    from ..observability import record_failure

    from .columnar import as_dataset

    metrics = session.service.metrics
    labels = {"tenant": session.tenant, "dataset": session.dataset}
    decode_labels = {
        "tenant": session.tenant,
        "priority": getattr(
            session.priority, "name", str(session.priority)
        ).lower(),
    }
    frames = iter(frames)
    try:
        while True:
            # the next() pull IS the frame decode (both generators do
            # their read_next_batch inside) — time it per frame
            t0 = time.perf_counter()
            try:
                index, batch = next(frames)
            except StopIteration:
                break
            metrics.observe(
                "deequ_service_ingest_decode_seconds",
                time.perf_counter() - t0, **decode_labels,
            )
            data = as_dataset(batch)
            result = session.ingest(data, timeout=timeout)
            report.frames += 1
            report.rows += int(data.num_rows)
            report.results.append(result)
            metrics.inc_many([
                ("deequ_service_ingest_batches_total", 1.0, labels),
                ("deequ_service_ingest_rows_total",
                 float(data.num_rows), labels),
            ])
            sp.add_event(
                "frame_folded", frame=index, rows=int(data.num_rows)
            )
    except MalformedFrameError as exc:
        record_failure(exc)
        metrics.inc("deequ_service_ingest_malformed_total", **labels)
        sp.add_event("malformed_frame", frame=report.frames)
        raise
    except FeedDisconnectError as exc:
        record_failure(exc)
        metrics.inc("deequ_service_ingest_disconnects_total", **labels)
        sp.add_event("feed_disconnect", frames_folded=report.frames)
        raise


class BoundedReader:
    """File-like view over a transport stream that reads at most ``limit``
    bytes (an HTTP body must never be over-read: the bytes after it belong
    to the next request) and counts what actually arrived. A short read —
    the producer died — surfaces to the Arrow decoder as truncation, which
    the typed contract maps to :class:`FeedDisconnectError`."""

    def __init__(self, raw, limit: int):
        self._raw = raw
        self._remaining = int(limit)
        self.bytes_read = 0
        #: True once the transport delivered FEWER bytes than declared —
        #: what tells a real disconnect (the producer died mid-body) from
        #: a fully-delivered payload whose bytes are structurally bad
        self.short = False

    def read(self, n: int = -1) -> bytes:
        if self._remaining <= 0:
            return b""
        if n is None or n < 0 or n > self._remaining:
            n = self._remaining
        data = self._raw.read(n)
        got = len(data)
        self._remaining -= got
        self.bytes_read += got
        if got < n:
            self.short = True
            self._remaining = 0  # transport exhausted: everything after
            # this is a short read, never a block on a dead socket
        return data

    def drain(self) -> None:
        """Consume any unread remainder (trailing bytes after the Arrow
        EOS marker) so a keep-alive connection stays framed."""
        while self._remaining > 0:
            if not self.read(min(self._remaining, 1 << 16)):
                break

    # the minimal file-object surface pyarrow's PythonFile wrapper probes
    closed = False

    def readable(self) -> bool:
        return True

    def writable(self) -> bool:
        return False

    def seekable(self) -> bool:
        return False

    def flush(self) -> None:
        pass

    def close(self) -> None:
        # the transport (HTTP rfile) outlives this view; never close it
        pass


def fold_stream_reader(
    session,
    reader: BoundedReader,
    *,
    source: str = "<stream>",
    timeout: Optional[float] = None,
) -> IngestReport:
    """INCREMENTAL stream fold: decode Arrow IPC frames straight off a
    transport reader and fold each as it arrives — a GB-scale stream
    holds ONE frame in memory instead of buffering its whole body (the
    unbuffered HTTP ingest path). Checksummed requests cannot ride this
    path: the digest must verify over the complete payload BEFORE
    anything folds, so the endpoint keeps those on the buffered
    :func:`fold_stream` (the documented tripwire semantics, unchanged).

    Failure contract mirrors ``fold_stream(complete=False)``: whole
    leading frames fold and stay committed; a truncated tail — or a
    transport error mid-read — raises typed :class:`FeedDisconnectError`;
    structurally bad bytes with the stream still flowing raise
    :class:`MalformedFrameError`."""
    from ..observability import record_failure
    from ..observability import trace as _trace

    report = IngestReport(source=source)
    metrics = session.service.metrics
    labels = {"tenant": session.tenant, "dataset": session.dataset}

    def frames():
        from ..reliability.faults import fault_point

        def classify(exc, index):
            # truncation-shaped errors are a DISCONNECT only when the
            # transport actually under-delivered; a fully-delivered body
            # that still runs out of bytes is structurally malformed
            if isinstance(exc, OSError) or (
                _looks_truncated(exc) and reader.short
            ):
                return FeedDisconnectError(
                    source, frames_decoded=index,
                    bytes_read=reader.bytes_read, detail=str(exc),
                )
            return MalformedFrameError(source, str(exc), frame_index=index)

        try:
            arrow_reader = pa.ipc.open_stream(reader)
        except Exception as exc:  # noqa: BLE001 - typed below
            raise classify(exc, 0) from exc
        index = 0
        while True:
            fault_point("frame_decode", tag=str(index))
            try:
                batch = arrow_reader.read_next_batch()
            except StopIteration:
                return
            except MalformedFrameError:
                raise
            except Exception as exc:  # noqa: BLE001 - typed below
                raise classify(exc, index) from exc
            yield index, batch
            index += 1

    with _trace.span(
        "ingest_stream", kind="ingest", source=source,
        tenant=session.tenant, dataset=session.dataset, incremental=True,
    ) as sp:
        metrics.inc("deequ_service_ingest_sessions_total", **labels)
        _fold_frames(session, frames(), report, sp, timeout)
        report.bytes = reader.bytes_read
        metrics.inc(
            "deequ_service_ingest_bytes_total",
            float(reader.bytes_read), **labels,
        )
    return report


def describe_ingest_metrics(metrics) -> None:
    """Register HELP text for the ingest-plane series (idempotent; the
    endpoint calls it when it is mounted)."""
    metrics.describe(
        "deequ_service_ingest_sessions_total",
        "Ingest streams opened against a session (HTTP or in-process "
        "Arrow feeds).",
    )
    metrics.describe(
        "deequ_service_ingest_batches_total",
        "Record-batch frames folded through the Arrow ingestion plane.",
    )
    metrics.describe(
        "deequ_service_ingest_rows_total",
        "Rows folded through the Arrow ingestion plane.",
    )
    metrics.describe(
        "deequ_service_ingest_bytes_total",
        "Payload bytes of COMPLETED ingest streams (rejected payloads "
        "never count).",
    )
    metrics.describe(
        "deequ_service_ingest_malformed_total",
        "Ingest payloads rejected typed: checksum mismatch or structural "
        "decode failure (MalformedFrameError). Nothing folded.",
    )
    metrics.describe(
        "deequ_service_ingest_disconnects_total",
        "Ingest streams torn mid-frame (FeedDisconnectError). Complete "
        "leading frames stayed committed.",
    )
    metrics.describe(
        "deequ_service_ingest_shed_total",
        "Ingest frames shed by bounded admission (ServiceOverloaded "
        "surfaced as HTTP 429 / typed error).",
    )
    metrics.describe_histogram(
        "deequ_service_ingest_decode_seconds",
        "Arrow IPC frame decode time on the ingestion plane, per tenant "
        "and priority class (pow2 buckets, seconds).",
    )
