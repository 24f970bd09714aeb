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
  (`RowGate`, `QuarantineSidecar`).

The JAX package's double-buffered feed pipeline (``ingest/prefetch.py``)
is not here: only its engine's device tier runs through it, and the
port's engine builds its batches inline.
"""

from ..exceptions import (
    FeedDisconnectError,
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
    "MalformedFrameError", "FeedDisconnectError",
    "RowGate", "QuarantineSidecar", "FrameQuarantinedError",
    "quarantine_max_rows", "QUARANTINE_MAX_ROWS_ENV",
    "DEFAULT_QUARANTINE_MAX_ROWS",
]
