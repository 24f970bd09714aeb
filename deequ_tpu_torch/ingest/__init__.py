"""High-throughput ingestion plane: socket to device (the JAX package's
plane, ported; host code — every fold it drives runs on the service's
scheduler workers, which launch the kernels).

- :mod:`.columnar` — in-process coercion: dict-of-numpy / Arrow tables /
  record batches become :class:`~deequ_tpu_torch.data.Dataset` with no
  pandas hop (`as_dataset`);
- :mod:`.arrow_stream` — the zero-copy Arrow IPC wire format: typed,
  checksummed, fault-injectable frame decode (`iter_frames`) and the
  per-frame atomic fold into a streaming session (`fold_stream`);
- :mod:`.endpoint` — the HTTP frontend riding the MetricsExporter plane
  (``POST /ingest/v1/<tenant>/<dataset>``);
- :mod:`.rowgate` — row-level ingest gating: one vectorized conformance
  mask per frame BEFORE the fold, clean rows fold bit-exact, rejects go
  to a typed, bounded, content-addressed Arrow quarantine sidecar
  (`RowGate`, `QuarantineSidecar`);
- :mod:`.prefetch` — the double-buffered feed pipeline of the engine's
  device tier (`PrefetchingBatchIterator`, ``DEEQU_TPU_PREFETCH_DEPTH``,
  ``DEEQU_TPU_FEED_STALL_S``).
"""

from ..exceptions import (
    FeedDisconnectError,
    FeedStallError,
    MalformedFrameError,
)
from .arrow_stream import (
    CHECKSUM_HEADER,
    BoundedReader,
    IngestReport,
    encode_ipc_stream,
    fold_stream,
    fold_stream_reader,
    iter_frames,
)
from .columnar import as_dataset, payload_bytes
from .endpoint import INGEST_PREFIX, IngestEndpoint
from .prefetch import (
    DEFAULT_FEED_STALL_S,
    DEFAULT_PREFETCH_DEPTH,
    FEED_STALL_ENV,
    PREFETCH_DEPTH_ENV,
    PrefetchingBatchIterator,
    feed_stall_s,
    prefetch_depth,
    staging_depth,
)
from .rowgate import (
    DEFAULT_QUARANTINE_MAX_ROWS,
    QUARANTINE_MAX_ROWS_ENV,
    FrameQuarantinedError,
    QuarantineSidecar,
    RowGate,
    quarantine_max_rows,
)

__all__ = [
    "as_dataset", "payload_bytes",
    "encode_ipc_stream", "iter_frames", "fold_stream", "IngestReport",
    "fold_stream_reader", "BoundedReader",
    "CHECKSUM_HEADER", "INGEST_PREFIX", "IngestEndpoint",
    "MalformedFrameError", "FeedDisconnectError", "FeedStallError",
    "PrefetchingBatchIterator", "prefetch_depth", "staging_depth", "feed_stall_s",
    "PREFETCH_DEPTH_ENV", "DEFAULT_PREFETCH_DEPTH", "FEED_STALL_ENV",
    "DEFAULT_FEED_STALL_S",
    "RowGate", "QuarantineSidecar", "FrameQuarantinedError",
    "quarantine_max_rows", "QUARANTINE_MAX_ROWS_ENV",
    "DEFAULT_QUARANTINE_MAX_ROWS",
]
