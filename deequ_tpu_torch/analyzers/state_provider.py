"""State persistence: StateLoader / StatePersister.

Reference: `analyzers/StateProvider.scala:37-312` — states are loaded and
merged into a run (``aggregate_with``) or persisted after it
(``save_states_with``), so metrics of a growing or partitioned table
refresh from merged states without a rescan (``run_on_aggregated_states``).

The on-disk layout is the JAX package's v2 blob
(deequ_tpu/analyzers/state_provider.py), the contract between the two
packages: a state written by either loads in the other.

- A tensor state is one ``<name>-<sha1(repr)[:16]>-state.npz`` holding
  ``__format_version__``, ``__state_type__`` (the class name, looked up in a
  static registry), ``__static__`` (the static fields as JSON),
  ``__checksum__`` (xxhash64 over the type name, the static JSON and each
  leaf's dtype, shape and bytes) and ``leaf0..`` in the reference's flatten
  order and dtypes (``convert.to_reference``: uint64 frequency keys,
  int32 HLL registers and KLL ticks, float32 KLL items).
- A grouping state (:class:`FrequenciesAndNumRows`) is a
  ``-frequencies.parquet`` table plus a ``-meta.json`` sidecar with its
  row count, group columns and the parquet bytes' checksum.

Loading never unpickles (``np.load(..., allow_pickle=False)``); v1 blobs
(no type name) take their structure from the requesting analyzer. Loaded
tensor states live on the CPU; merges move them to the run's device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io as _io
import json
import threading
from typing import Any, Dict, List, Optional

import numpy as np

from .. import io as dio
from ..convert import STATE_CLASSES, from_reference, to_reference
from ..exceptions import CorruptStateError, UnsupportedFormatVersionError
from ..integrity import checksum_bytes, verify_checksum, warn_once_unchecksummed
from .base import Analyzer
from .grouping import FrequenciesAndNumRows
from .sketches import ExactQuantileState
from .states import leaves as state_leaves, tensor_fields, with_leaves

#: version of the persisted layout; the loader refuses newer versions
STATE_FORMAT_VERSION = 2

#: the persistable state types (the reference's registry, same names)
REGISTERED_STATES = (
    "FrequencyCountsState", "NumMatches", "NumMatchesAndCount", "MeanState", "SumState",
    "MinState", "MaxState", "StandardDeviationState", "CorrelationState",
    "DataTypeHistogram", "ApproxCountDistinctState", "KLLSketchState",
)


def _state_registry() -> Dict[str, type]:
    """Persistable state types by name — the reconstruction allowlist."""
    return {name: STATE_CLASSES[name] for name in REGISTERED_STATES}


def _static_fields(cls) -> List[str]:
    return [f.name for f in dataclasses.fields(cls) if f.metadata.get("static")]


def _reconstruct_state(type_name: str, static: Dict[str, Any], leaves: list) -> Any:
    registry = _state_registry()
    cls = registry.get(type_name)
    if cls is None:
        raise ValueError(
            f"persisted state type {type_name!r} is not in the reconstruction "
            f"registry ({sorted(registry)}); refusing to load"
        )
    static_fields = _static_fields(cls)
    if set(static) != set(static_fields):
        raise ValueError(
            f"persisted {type_name} blob static fields {sorted(static)} do "
            f"not match the type's {sorted(static_fields)}"
        )
    try:
        state = from_reference(type_name, leaves)
    except TypeError as exc:  # a leaf of the wrong dtype: a torn or foreign blob
        raise ValueError(str(exc)) from exc
    state = dataclasses.replace(state, **static)
    if isinstance(static.get("sketch_size"), int) and state.items.shape[1] != 4 * static[
            "sketch_size"]:
        raise ValueError(
            f"persisted {type_name} blob holds items of width {state.items.shape[1]} "
            f"for sketch size {static['sketch_size']}"
        )
    return state


def _check_state_version(found: int, kind: str) -> None:
    if found > STATE_FORMAT_VERSION or found < 1:
        raise UnsupportedFormatVersionError(kind, found, STATE_FORMAT_VERSION)


def _blob_checksum(type_name: str, static: Dict[str, Any], leaves: list) -> str:
    """Content checksum of a v2 .npz state blob: the state-type name, the
    canonical static-field JSON and every leaf's dtype, shape and bytes."""
    parts = [
        type_name.encode("utf-8"),
        json.dumps(static, sort_keys=True).encode("utf-8"),
    ]
    for leaf in leaves:
        arr = np.ascontiguousarray(leaf)
        parts.append(str(arr.dtype).encode("utf-8"))
        parts.append(str(arr.shape).encode("utf-8"))
        parts.append(arr.tobytes())
    return checksum_bytes(b"\x1f".join(parts))


def _sanitize_namespace_part(part: str) -> str:
    """One path segment of a state namespace: ASCII lowercase
    alphanumerics, dot and dash kept; everything else escaped as ``_XX``
    per UTF-8 byte; ``.`` and ``..`` prefixed."""
    out = []
    for ch in part:
        if ch.isascii() and (ch.islower() or ch.isdigit() or ch in ".-"):
            out.append(ch)
        else:
            out.extend(f"_{b:02x}" for b in ch.encode("utf-8"))
    safe = "".join(out)
    if safe in (".", ".."):
        return "_" + safe
    return safe


def copy_state(state: Any) -> Any:
    """A copy that shares no buffer with ``state``: kernels write some
    state buffers in place (a frequency table's key buffer), so a kept
    state must not alias one a later launch writes. A spilled frequency
    table (its counts in spill files, which it alone reads) and an
    exact-quantile state (host arrays nothing writes) are kept as they are,
    as the reference's provider keeps every state."""
    if isinstance(state, FrequenciesAndNumRows):
        if state.spilled:
            return state
        return FrequenciesAndNumRows(state.frequencies.copy(), state.num_rows,
                                     state.group_columns)
    if isinstance(state, ExactQuantileState):
        return state
    return with_leaves(state, [t.detach().clone() for t in state_leaves(state)])


class StateLoader:
    def load(self, analyzer: Analyzer) -> Optional[Any]:
        raise NotImplementedError


class StatePersister:
    def persist(self, analyzer: Analyzer, state: Any) -> None:
        raise NotImplementedError


class InMemoryStateProvider(StateLoader, StatePersister):
    """Thread-safe in-memory store (reference `StateProvider.scala:46-68`).
    It keeps a copy of each persisted state (:func:`copy_state`), on the
    device the state was on."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._states: Dict[Analyzer, Any] = {}

    def load(self, analyzer: Analyzer) -> Optional[Any]:
        with self._lock:
            return self._states.get(analyzer)

    def persist(self, analyzer: Analyzer, state: Any) -> None:
        kept = copy_state(state)
        with self._lock:
            self._states[analyzer] = kept

    def analyzers(self) -> list:
        with self._lock:
            return list(self._states)

    def __len__(self) -> int:
        with self._lock:
            return len(self._states)

    def clear(self) -> None:
        with self._lock:
            self._states.clear()

    def __repr__(self) -> str:
        return f"InMemoryStateProvider({len(self)} states)"


class FileSystemStateProvider(StateLoader, StatePersister):
    """Directory-backed state store (reference `HdfsStateProvider`,
    `StateProvider.scala:73-312`), in the JAX package's v2 layout. ``path``
    may be a local directory or any URI scheme ``io`` supports.
    ``namespace`` scopes the store to a subdirectory."""

    def __init__(self, path: str, allow_overwrite: bool = True,
                 namespace: Optional[str] = None):
        if namespace:
            for part in str(namespace).split("/"):
                path = dio.join(path, _sanitize_namespace_part(part) or "_")
        self.path = path
        self.allow_overwrite = allow_overwrite
        dio.makedirs(path)

    def _key(self, analyzer: Analyzer) -> str:
        # the repr is the reference's (same classes, fields and order), so
        # both packages name a state's file alike
        digest = hashlib.sha1(repr(analyzer).encode("utf-8")).hexdigest()[:16]
        return f"{analyzer.name}-{digest}"

    def persist(self, analyzer: Analyzer, state: Any) -> None:
        base = dio.join(self.path, self._key(analyzer))
        if isinstance(state, FrequenciesAndNumRows):
            import pyarrow as pa
            import pyarrow.parquet as pq

            frame = (
                state.frequencies.rename("count")
                .rename_axis(state.group_columns)
                .reset_index()
            )
            sink = _io.BytesIO()
            pq.write_table(pa.Table.from_pandas(frame, preserve_index=False), sink)
            payload = sink.getvalue()
            with dio.open_file(base + "-frequencies.parquet", "wb") as fh:
                fh.write(payload)
            with dio.open_file(base + "-meta.json", "w") as fh:
                json.dump(
                    {
                        "formatVersion": STATE_FORMAT_VERSION,
                        "num_rows": state.num_rows,
                        "group_columns": state.group_columns,
                        "checksum": checksum_bytes(payload),
                    },
                    fh,
                )
            return
        type_name = type(state).__name__
        if type_name not in _state_registry():
            raise ValueError(
                f"state type {type_name!r} is not registered for persistence; "
                "add it to REGISTERED_STATES so it can be reconstructed "
                "without code execution on load"
            )
        static = {name: getattr(state, name) for name in _static_fields(type(state))}
        _, host_leaves = to_reference(state)
        with dio.open_file(base + "-state.npz", "wb") as fh:
            np.savez(
                fh,
                __format_version__=np.int64(STATE_FORMAT_VERSION),
                __state_type__=np.str_(type_name),
                __static__=np.str_(json.dumps(static)),
                __checksum__=np.str_(_blob_checksum(type_name, static, host_leaves)),
                **{f"leaf{i}": v for i, v in enumerate(host_leaves)},
            )

    def load(self, analyzer: Analyzer) -> Optional[Any]:
        base = dio.join(self.path, self._key(analyzer))
        if dio.exists(base + "-frequencies.parquet"):
            return self._load_frequencies(base)
        if dio.exists(base + "-state.npz"):
            return self._load_blob(analyzer, base + "-state.npz")
        return None

    def _load_frequencies(self, base: str) -> FrequenciesAndNumRows:
        import pandas as pd
        import pyarrow.parquet as pq

        source = base + "-frequencies.parquet"
        with dio.open_file(source, "rb") as fh:
            payload = fh.read()
        try:
            with dio.open_file(base + "-meta.json", "r") as fh:
                meta = json.load(fh)
        except ValueError as exc:
            raise CorruptStateError("frequency-state sidecar", base + "-meta.json",
                                    str(exc)) from exc
        _check_state_version(int(meta.get("formatVersion", 1)), "frequency-state sidecar")
        if "checksum" in meta:
            verify_checksum(payload, meta["checksum"], "frequency-state parquet", source)
        else:
            warn_once_unchecksummed("frequency-state parquet", source)
        try:
            frame = pq.read_table(_io.BytesIO(payload)).to_pandas()
        except Exception as exc:  # noqa: BLE001 - unparseable = corrupt
            raise CorruptStateError("frequency-state parquet", source, str(exc)) from exc
        cols = meta["group_columns"]
        series = frame.set_index(cols)["count"]
        if len(cols) == 1 and isinstance(series.index, pd.MultiIndex):
            series.index = series.index.get_level_values(0)
        return FrequenciesAndNumRows(series, meta["num_rows"], cols)

    def _load_blob(self, analyzer: Analyzer, source: str) -> Any:
        with dio.open_file(source, "rb") as fh:
            raw = fh.read()
        # np.load is lazy: every member read stays inside the corruption guard
        try:
            data = np.load(_io.BytesIO(raw), allow_pickle=False)
            files = set(data.files)
            version = int(data["__format_version__"]) if "__format_version__" in files else None
            n_leaves = sum(1 for f in files if f.startswith("leaf"))
            leaves = [data[f"leaf{i}"] for i in range(n_leaves)]
            type_name = str(data["__state_type__"]) if "__state_type__" in files else None
            static_raw = str(data["__static__"]) if type_name else "{}"
            stored = str(data["__checksum__"]) if "__checksum__" in files else None
        except Exception as exc:  # noqa: BLE001 - a torn zip is corrupt
            raise CorruptStateError(".npz state blob", source, str(exc)) from exc
        if version is not None:
            _check_state_version(version, ".npz state blob")
        if type_name is None:
            # v1: the same leaf order; the structure is the analyzer's own
            identity = analyzer.init_state("cpu")
            if len(tensor_fields(identity)) != len(leaves):
                raise ValueError(
                    f"v1 state blob for {analyzer} carries {len(leaves)} leaves but the "
                    f"analyzer's state has {len(tensor_fields(identity))}; blob is corrupt "
                    "or from an incompatible analyzer"
                )
            return from_reference(type(identity).__name__, leaves)
        try:
            static = json.loads(static_raw)
        except ValueError as exc:
            raise CorruptStateError(".npz state blob", source, str(exc)) from exc
        if stored is not None:
            actual = _blob_checksum(type_name, static, leaves)
            if actual != stored:
                raise CorruptStateError(
                    ".npz state blob", source,
                    f"checksum mismatch (stored {stored}, computed {actual})",
                )
        else:
            warn_once_unchecksummed(".npz state blob", source)
        try:
            return _reconstruct_state(type_name, static, leaves)
        except ValueError as exc:
            raise CorruptStateError(".npz state blob", source, str(exc)) from exc
