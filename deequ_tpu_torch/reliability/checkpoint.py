"""Resumable ingest: periodic algebraic-state checkpoints through the
state providers (the reference's ``deequ_tpu/reliability/checkpoint.py``).

A multi-batch fold is a left fold of commutative-semigroup states over the
batch sequence, so the state after batch ``k`` plus the remaining batches
``k+1..n`` determines the final state exactly (reference
`analyzers/StateProvider.scala:37-66`). The checkpointer persists every
analyzer's state every ``every`` batches (the scan battery's states and
the host accumulators' states, such as grouping frequency tables), with a
meta record pinning the fold position and shape; an interrupted run then
resumes from the last checkpoint and equals the uninterrupted run: the
engine re-enters the batch loop at the checkpoint index with the restored
states, and batch indices are kept, so index-keyed logic (the host tier's
KLL sampler offsets) replays identically.

The meta record validates before any resume: batch size, row count and
the battery fingerprint must match, else the checkpoint is ignored and the
run starts fresh. Completion clears the meta, so a finished run's
checkpoint never resurrects into the next.

Mesh-shape independence: the meta record pins nothing about the mesh.
Mesh runs checkpoint their states in canonical (merged) form
(``ElasticMeshFold.canonical``), and every checkpointed run rounds its
batch size to the re-shard ladder's quantum (``mesh_batch_quantum``), so
batch boundaries, and this record's ``batch_size``, are the same at every
rung: a checkpoint taken on 8 shards resumes on 4, on 1 or on the plain
host tier.

The files are the reference's: the meta record is the same JSON
(``ingest-checkpoint-meta.json`` beside a directory provider's states),
the states the v2 blobs, and host accumulators key on the same
``HostAccumulator(...)`` names, so a checkpoint either package wrote
resumes in the other.
"""

from __future__ import annotations

import copy
import hashlib
import json
import logging
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

_logger = logging.getLogger(__name__)

_META_FILENAME = "ingest-checkpoint-meta.json"


@dataclass(frozen=True)
class _HostStateKey:
    """Analyzer-shaped persistence key for host accumulator states whose
    run-time key is not an Analyzer (a grouping set's shared frequency
    table). Duck-types the two members the providers read: ``name`` and a
    stable ``repr``."""

    ident: str

    @property
    def name(self) -> str:
        return "HostAccumulator"

    def __repr__(self) -> str:
        return f"HostAccumulator({self.ident})"


def _host_ident(key: Any) -> str:
    """The reference's identity of a host accumulator key. The port keys a
    grouping set's table by its column tuple, the reference by
    ``("__grouping__", columns)``; both name it the reference's way."""
    if isinstance(key, tuple) and key and all(isinstance(c, str) for c in key):
        key = ("__grouping__", key)
    return str(key)


def _host_key(key: Any) -> Any:
    from ..analyzers.base import Analyzer

    if isinstance(key, Analyzer):
        return key
    return _HostStateKey(_host_ident(key))


def _snapshot_state(state: Any) -> Any:
    """A copy of a host accumulator state at checkpoint time that the run's
    later folds cannot reach. A frequency table copies its merged series (a
    spilled table raises its budget error: it cannot be persisted anyway);
    anything else deep-copies."""
    from ..analyzers.grouping import FrequenciesAndNumRows

    if isinstance(state, FrequenciesAndNumRows):
        return FrequenciesAndNumRows(
            state.frequencies.copy(), state.num_rows, list(state.group_columns)
        )
    return copy.deepcopy(state)


def battery_fingerprint(scan_analyzers: Sequence[Any], host_keys: Sequence[Any]) -> str:
    """Stable identity of what a run folds: the analyzers' reprs and the
    host keys, hashed so the meta record stays small for wide batteries."""
    payload = "\x1f".join([repr(a) for a in scan_analyzers]
                          + sorted(_host_ident(k) for k in host_keys))
    return hashlib.sha1(payload.encode("utf-8")).hexdigest()[:16]


@dataclass
class ResumePoint:
    """What a resumed run starts from. ``host_batch_index`` can run ahead of
    ``batch_index``: the host tier folds accumulators per batch on the
    submitting thread while scan states advance per chunk fold, so each
    records its own high-water mark and the resumed run replays each from
    its own position."""

    batch_index: int
    scan_states: List[Any]
    host_states: Dict[Any, Any]
    host_batch_index: int = 0


class IngestCheckpointer:
    """Checkpoint and resume around one state provider, which must be both a
    ``StateLoader`` and a ``StatePersister``. The meta record rides beside
    the states: a JSON file for directory-backed providers (anything with
    a ``path``), else through the provider itself under a sentinel key."""

    def __init__(self, provider: Any, every: int = 8):
        from ..analyzers.state_provider import StateLoader, StatePersister

        if not (isinstance(provider, StateLoader) and isinstance(provider, StatePersister)):
            raise TypeError(
                "checkpoint provider must be both a StateLoader and a "
                f"StatePersister, got {type(provider).__name__}"
            )
        if int(every) < 1:
            raise ValueError(f"checkpoint interval must be >= 1, got {every}")
        self.provider = provider
        self.every = int(every)
        #: (batch_index, n_states) per save, newest last
        self.saves: List[Tuple[int, int]] = []
        #: resume points discarded because a meta record or state blob
        #: failed its integrity check (each cost a fresh fold, never a crash)
        self.corrupt_discards: int = 0
        #: saves and completes refused because a newer pass fenced theirs
        self.fenced_saves: int = 0
        #: serializes saves and the epoch check, so the save sequences of
        #: two passes never interleave
        self._save_lock = threading.Lock()
        self._epoch = 0

    def begin_run(self) -> int:
        """Fence every earlier pass and return this pass's epoch token: a
        ``save``/``complete`` carrying a stale epoch is refused under the
        save lock (counted in ``fenced_saves``), so an abandoned pass that
        keeps folding can never splice its meta record over another pass's
        states."""
        with self._save_lock:
            self._epoch += 1
            return self._epoch

    def _current(self, epoch: Optional[int]) -> bool:
        return epoch is None or epoch == self._epoch

    # -- meta ----------------------------------------------------------------

    def _meta_path(self) -> Optional[str]:
        path = getattr(self.provider, "path", None)
        if path is None:
            return None
        from .. import io as dio

        return dio.join(path, _META_FILENAME)

    _META_SENTINEL = _HostStateKey("__ingest_checkpoint_meta__")

    def _write_meta(self, meta: Optional[Dict[str, Any]]) -> None:
        path = self._meta_path()
        if path is None:
            # an in-memory provider holds the record under a sentinel key
            self.provider.persist(self._META_SENTINEL, meta)
            return
        from .. import io as dio

        if meta is None:
            if dio.exists(path):
                dio.write_text_atomic(path, json.dumps({"cleared": True}))
            return
        from ..integrity import checksum_json

        # the meta record pins WHICH states form a resume point; a flipped
        # byte in it would splice wrong states into a resumed fold
        meta = dict(meta)
        meta["checksum"] = checksum_json({k: v for k, v in meta.items() if k != "checksum"})
        dio.write_text_atomic(path, json.dumps(meta))

    def _read_meta(self) -> Optional[Dict[str, Any]]:
        """The persisted meta record, or None. Raises
        :class:`CorruptStateError` when the record exists but is torn or
        fails its checksum; ``load`` turns that into a fresh start."""
        path = self._meta_path()
        if path is None:
            return self.provider.load(self._META_SENTINEL)
        from .. import io as dio
        from ..exceptions import CorruptStateError

        if not dio.exists(path):
            return None
        with dio.open_file(path, "r") as fh:
            raw = fh.read()
        try:
            meta = json.loads(raw)
        except ValueError as exc:
            from ..observability import record_failure

            torn = CorruptStateError("ingest-checkpoint meta", path, str(exc))
            torn.__cause__ = exc
            record_failure(torn)
            raise torn
        if meta.get("cleared"):
            return None
        if "checksum" in meta:
            from ..integrity import verify_json_checksum

            verify_json_checksum({k: v for k, v in meta.items() if k != "checksum"},
                                 meta["checksum"], "ingest-checkpoint meta", path)
        else:
            from ..integrity import warn_once_unchecksummed

            warn_once_unchecksummed("ingest-checkpoint meta", path)
        return meta

    # -- checkpoint lifecycle ------------------------------------------------

    def save(
        self,
        batch_index: int,
        batch_size: int,
        num_rows: int,
        scan_analyzers: Sequence[Any],
        scan_states: Sequence[Any],
        host_states: Dict[Any, Any],
        host_batch_index: Optional[int] = None,
        epoch: Optional[int] = None,
    ) -> None:
        """Persist one checkpoint, invalidate first: the meta record is
        cleared, every state overwrites its slot, then the new meta lands. A
        crash mid-save costs the resume point (the next run starts from
        batch 0), never a resume that pairs an old meta with newer states.
        A save carrying a fenced ``epoch`` is refused whole."""
        from .faults import fault_point

        with self._save_lock:
            if not self._current(epoch):
                self.fenced_saves += 1
                _logger.warning("checkpoint save at batch %d refused: a newer pass "
                                "fenced its own", batch_index)
                return
            fault_point("checkpoint", tag=str(batch_index))
            self._write_meta(None)
            for analyzer, state in zip(scan_analyzers, scan_states):
                self.provider.persist(analyzer, state)
            for key, state in host_states.items():
                # the run keeps folding into the live object after this
                # save, and an in-memory provider keeps references
                self.provider.persist(_host_key(key), _snapshot_state(state))
            self._write_meta({
                "batch_index": int(batch_index),
                "batch_size": int(batch_size),
                "num_rows": int(num_rows),
                "host_batch_index": int(
                    batch_index if host_batch_index is None else host_batch_index),
                "fingerprint": battery_fingerprint(scan_analyzers, list(host_states)),
            })
            self.saves.append((int(batch_index), len(list(scan_analyzers))))

    def load(
        self,
        batch_size: int,
        num_rows: int,
        scan_analyzers: Sequence[Any],
        host_keys: Sequence[Any],
        monitor: Optional[Any] = None,
    ) -> Optional[ResumePoint]:
        """The resume point for a run of this exact shape, or None (no
        checkpoint, a shape mismatch, a missing state, or a corrupt
        checkpoint: a torn meta record or a failed checksum costs the
        resume point, never the run). ``monitor`` (a RunMonitor) counts a
        discard under ``corrupt_quarantined``."""
        from ..exceptions import CorruptStateError

        def discard(what: str, exc: BaseException) -> None:
            self.corrupt_discards += 1
            if monitor is not None:
                monitor.bump("corrupt_quarantined")
            from ..observability import trace as _trace

            _trace.add_event("checkpoint_discarded", what=what,
                             error=f"{type(exc).__name__}: {str(exc)[:200]}")
            _logger.warning("ingest checkpoint discarded (%s is corrupt; restarting the "
                            "fold from batch 0): %s", what, exc)

        try:
            meta = self._read_meta()
        except CorruptStateError as exc:
            discard("meta record", exc)
            return None
        if not meta:
            return None
        fingerprint = battery_fingerprint(scan_analyzers, host_keys)
        if (int(meta.get("batch_size", -1)) != int(batch_size)
                or int(meta.get("num_rows", -1)) != int(num_rows)
                or meta.get("fingerprint") != fingerprint):
            _logger.info("ingest checkpoint ignored: run shape changed (meta=%s, now "
                         "batch_size=%d num_rows=%d fp=%s)", meta, batch_size, num_rows,
                         fingerprint)
            return None
        try:
            scan_states = [self.provider.load(a) for a in scan_analyzers]
        except CorruptStateError as exc:
            discard("a scan state blob", exc)
            return None
        if any(s is None for s in scan_states):
            return None
        host_states = {}
        for key in host_keys:
            try:
                state = self.provider.load(_host_key(key))
            except CorruptStateError as exc:
                discard("a host accumulator state blob", exc)
                return None
            if state is None:
                return None
            # the resumed run folds into this object; an in-memory provider
            # keeps the checkpoint-time value until the next save
            host_states[key] = _snapshot_state(state)
        batch_index = int(meta["batch_index"])
        return ResumePoint(batch_index, scan_states, host_states,
                           host_batch_index=int(meta.get("host_batch_index", batch_index)))

    def complete(self, epoch: Optional[int] = None) -> None:
        """Mark the run finished: clears the meta so the next run over this
        provider starts fresh. A fenced pass completing late does not clear
        the active pass's resume point."""
        with self._save_lock:
            if not self._current(epoch):
                self.fenced_saves += 1
                return
            self._write_meta(None)
