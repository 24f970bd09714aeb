"""JVM interop: readers/writers for the reference's persisted state blobs.

The reference persists each state through a fixed per-type binary codec on
a JVM ``DataOutputStream`` (`analyzers/StateProvider.scala:187-311`) —
big-endian, no framing beyond the type's own fields. Reading those blobs
directly lets a deployment take over (or run shadow to) an existing JVM
deequ pipeline without re-scanning history: day-partition states written
by Spark merge straight into our engine's semigroup states.

The JAX package's module, with the states in torch: the blob readers build
the port's states on ``device=`` (``cuda`` unless the caller names another;
without a card that raises), the writers read any port state back to the
host. The byte layouts are the reference's, so a blob written by either
package reads in the other.

First leg: the ApproxCountDistinct (HLL++) state. The reference stores the
sketch as a packed word array — 512 six-bit registers, 10 per 64-bit word,
52 words (`StatefulHyperloglogPlus.scala`) — serialized as::

    int32  (big-endian)  number of words
    int64 * n (big-endian) the words

(`StateProvider.scala` ``persistLongArrayState``/``loadLongArrayState``).
Our engine keeps the registers UNPACKED (int32[512], device-friendly
``maximum`` merges); `ops/hll.py`'s ``words_to_registers`` /
``registers_to_words`` convert between the two layouts bit-exactly, so a
round trip through the JVM blob format is lossless and the cardinality
estimate is identical on both sides (same hash, same bias tables).

Second leg: the KLL sketch. The reference serializes a
``QuantileNonSample[Double]`` through a fixed binary codec — header
(sketchSize, shrinkingFactor, item count, number of compactors) followed by
each compactor's (numOfCompress, offset, buffer) — on the same big-endian
``DataOutputStream`` conventions
(`analyzers/catalyst/KLLSketchSerializer.scala:26-121`), and the enclosing
``KLLState`` adds the global max/min the sketch itself does not track
(`analyzers/KLLSketch.scala:42-55`). :func:`read_jvm_kll_state_blob` /
:func:`write_jvm_kll_state_blob` implement that layout against our
fixed-shape :class:`~deequ_tpu_torch.ops.kll.KLLSketchState`: level ``l``'s
occupied item prefix is the reference's compactor-``l`` buffer, ``parity``
is the compactor's alternating ``offset``. Two lossy-by-design edges are
documented rather than hidden: item values ship as f64 but our buffers are
f32 (the engine's quantisation, `ops/kll.py` ITEM_DTYPE — re-reading
quantises once, inside the sketch's rank-error envelope), and
``numOfCompress``/``ticks`` do not survive (each side reconstructs its own
update bookkeeping; both only shape FUTURE compaction offsets, never the
already-folded items).

Third leg: the Gson metrics-history JSON
(`repository/AnalysisResultSerde.scala`). Our FS repository's entry layout
is deliberately Gson-shaped already, but adds ``formatVersion`` +
``checksum`` fields and keeps failed metrics; the JVM dialect has neither.
:func:`write_jvm_metrics_history_json` / :func:`read_jvm_metrics_history_json`
speak the exact reference dialect — successful metrics only, no envelope
fields, and the reference's literal ``"Mutlicolumn"`` entity spelling
(`metrics/Metric.scala`'s famous typo) accepted and emitted — so
reference-written histories load as first-class
:class:`~deequ_tpu_torch.repository.AnalysisResult` inputs and ours read back on
the JVM.

Every reader raises a typed :class:`CorruptStateError` on structural
violations (short reads, negative lengths, trailing bytes, non-list JSON):
JVM payloads carry no checksum, so the fixed layout IS the integrity check.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .config import ACC_DTYPE, COUNT_DTYPE, DeviceLike, resolve_device
from .exceptions import CorruptStateError
from .ops.hll import M, NUM_WORDS, registers_to_words, words_to_registers

#: bytes of a well-formed reference HLL blob: the int32 count + 52 longs
JVM_HLL_BLOB_BYTES = 4 + 8 * NUM_WORDS


def read_jvm_hll_state_blob(
    blob: bytes, source: str = "<bytes>", *, device: DeviceLike = None
):
    """Parse a reference ``ApproxCountDistinctState`` blob into a live
    :class:`~deequ_tpu_torch.analyzers.states.ApproxCountDistinctState`
    whose registers lie on ``device``.

    Raises :class:`CorruptStateError` on any structural violation (short
    read, wrong word count) — a JVM blob has no checksum of its own, so
    the fixed layout IS the integrity check."""
    from .analyzers.states import ApproxCountDistinctState

    dev = resolve_device(device)
    if len(blob) < 4:
        raise CorruptStateError(
            "JVM HLL state blob", source,
            f"{len(blob)} bytes is too short for the word-count header",
        )
    (n_words,) = struct.unpack_from(">i", blob, 0)
    if n_words != NUM_WORDS:
        raise CorruptStateError(
            "JVM HLL state blob", source,
            f"word count {n_words} != {NUM_WORDS} (p=9 layout)",
        )
    if len(blob) != 4 + 8 * n_words:
        raise CorruptStateError(
            "JVM HLL state blob", source,
            f"{len(blob)} bytes != expected {4 + 8 * n_words}",
        )
    words = np.frombuffer(blob, dtype=">i8", count=n_words, offset=4)
    registers = words_to_registers(words.astype(np.int64).view(np.uint64))
    return ApproxCountDistinctState(
        torch.as_tensor(registers, dtype=torch.int32).to(dev)
    )


def write_jvm_hll_state_blob(state) -> bytes:
    """Serialize an ``ApproxCountDistinctState`` into the reference's blob
    layout (the inverse of :func:`read_jvm_hll_state_blob`; exists so a
    deployment can hand states BACK to a JVM pipeline, and so the
    round-trip tests need no checked-in binary fixture)."""
    registers = _host(state.registers).astype(np.int32)
    if registers.shape != (M,):
        raise ValueError(
            f"expected int32[{M}] registers, got shape {registers.shape}"
        )
    words = registers_to_words(registers)
    return struct.pack(">i", NUM_WORDS) + words.view(np.int64).astype(
        ">i8"
    ).tobytes()


def _host(value) -> np.ndarray:
    """A state leaf (a torch tensor on any device, or an array) as numpy."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


# ---------------------------------------------------------------------------
# KLL sketch state (KLLSketchSerializer.scala layout + KLLState min/max)
# ---------------------------------------------------------------------------

def write_jvm_kll_state_blob(state, shrinking_factor: float = 0.64) -> bytes:
    """Serialize a :class:`~deequ_tpu_torch.ops.kll.KLLSketchState` into the
    reference's KLL codec::

        int32   sketchSize
        float64 shrinkingFactor
        int64   item count (exact folded-value count)
        int32   number of compactors (occupied levels; empty tail dropped)
        per compactor:
          int32   numOfCompress   (reference bookkeeping; written as 0 —
                                   our state tracks ``ticks`` instead)
          int32   offset          (the alternating compaction parity)
          int32   buffer length
          float64 * length        (the buffer items, ascending level)
        float64 globalMax
        float64 globalMin

    (all big-endian, ``DataOutputStream`` conventions). The trailing
    max/min pair is the enclosing ``KLLState``'s contribution
    (`analyzers/KLLSketch.scala:42-55`)."""
    items = _host(state.items).astype(np.float64)
    sizes = _host(state.sizes).astype(np.int64)
    parity = _host(state.parity).astype(np.int64)
    occupied = int(np.max(np.nonzero(sizes)[0])) + 1 if np.any(sizes) else 0
    out = [struct.pack(
        ">idqi", int(state.sketch_size), float(shrinking_factor),
        int(_host(state.count)), occupied,
    )]
    for level in range(occupied):
        n = int(sizes[level])
        out.append(struct.pack(">iii", 0, int(parity[level]), n))
        out.append(items[level, :n].astype(">f8").tobytes())
    out.append(struct.pack(
        ">dd", float(_host(state.g_max)), float(_host(state.g_min))
    ))
    return b"".join(out)


def read_jvm_kll_state_blob(
    blob: bytes, source: str = "<bytes>", *, device: DeviceLike = None
):
    """Parse a reference KLL state blob (see
    :func:`write_jvm_kll_state_blob` for the layout) into a live
    ``KLLSketchState`` on ``device`` plus the sketch's shrinking factor.

    Returns ``(state, shrinking_factor)``. The reconstructed state's
    ``ticks`` update counter is seeded from the exact count (the reference
    tracks ``numOfCompress`` instead; both only perturb FUTURE subsample
    offsets — the folded items, sizes, parities, count and min/max
    round-trip exactly, modulo the engine's documented f32 item
    quantisation). Raises :class:`CorruptStateError` on any structural
    violation."""
    from .ops.kll import ITEM_DTYPE, MAX_LEVELS, KLLSketchState

    dev = resolve_device(device)

    def corrupt(detail: str) -> CorruptStateError:
        return CorruptStateError("JVM KLL state blob", source, detail)

    header = struct.calcsize(">idqi")
    if len(blob) < header:
        raise corrupt(f"{len(blob)} bytes is too short for the header")
    sketch_size, shrinking_factor, count, n_compactors = struct.unpack_from(
        ">idqi", blob, 0
    )
    # the reference's sketchSize defaults to 2048 and is a user-visible
    # accuracy knob in the hundreds-to-thousands; a 16-bit bound keeps a
    # corrupt header from provoking a multi-GiB buffer allocation (the
    # fixed-shape state allocates 32 levels x 4*sketchSize f32 items)
    if sketch_size < 1 or sketch_size > (1 << 16):
        raise corrupt(f"implausible sketchSize {sketch_size}")
    if not (0.0 < shrinking_factor <= 1.0):
        raise corrupt(f"shrinkingFactor {shrinking_factor} outside (0, 1]")
    if count < 0:
        raise corrupt(f"negative item count {count}")
    if not (0 <= n_compactors <= MAX_LEVELS):
        raise corrupt(
            f"compactor count {n_compactors} outside [0, {MAX_LEVELS}]"
        )
    # parse the FULL structure before allocating the fixed-shape state:
    # nothing bigger than the blob itself materializes until every length,
    # range and trailer check has passed
    buf_len = 4 * int(sketch_size)
    buffers = []
    offset = header
    for level in range(n_compactors):
        if len(blob) < offset + 12:
            raise corrupt(f"truncated compactor header at level {level}")
        _num_compress, level_offset, n = struct.unpack_from(">iii", blob, offset)
        offset += 12
        if n < 0 or n > buf_len:
            raise corrupt(
                f"compactor {level} buffer length {n} outside [0, {buf_len}]"
            )
        if level_offset not in (0, 1):
            raise corrupt(f"compactor {level} offset {level_offset} not 0/1")
        if len(blob) < offset + 8 * n:
            raise corrupt(f"truncated compactor {level} buffer")
        buffers.append(
            (level_offset, np.frombuffer(blob, dtype=">f8", count=n,
                                         offset=offset).astype(np.float64))
        )
        offset += 8 * n
    if len(blob) != offset + 16:
        raise corrupt(
            f"{len(blob)} bytes != expected {offset + 16} "
            "(globalMax/globalMin trailer)"
        )
    g_max, g_min = struct.unpack_from(">dd", blob, offset)
    k = int(sketch_size)
    items = np.full((MAX_LEVELS, 4 * k), np.inf, dtype=np.float32)
    sizes = np.zeros(MAX_LEVELS, dtype=np.int32)
    parity = np.zeros(MAX_LEVELS, dtype=np.int32)
    for level, (level_offset, buf) in enumerate(buffers):
        items[level, :len(buf)] = buf
        sizes[level] = len(buf)
        parity[level] = level_offset
    state = KLLSketchState(
        items=torch.as_tensor(items, dtype=ITEM_DTYPE).to(dev),
        sizes=torch.as_tensor(sizes, dtype=torch.int32).to(dev),
        parity=torch.as_tensor(parity, dtype=torch.int32).to(dev),
        ticks=torch.tensor(
            min(int(count), np.iinfo(np.int32).max), dtype=torch.int32, device=dev
        ),
        count=torch.tensor(int(count), dtype=COUNT_DTYPE, device=dev),
        g_min=torch.tensor(g_min, dtype=ACC_DTYPE, device=dev),
        g_max=torch.tensor(g_max, dtype=ACC_DTYPE, device=dev),
        sketch_size=k,
    )
    return state, float(shrinking_factor)


# ---------------------------------------------------------------------------
# Gson metrics-history JSON (AnalysisResultSerde.scala dialect)
# ---------------------------------------------------------------------------

#: the reference's Entity enumeration spells the multicolumn member
#: "Mutlicolumn" (`metrics/Metric.scala`); the JVM dialect must emit and
#: accept that literal spelling or round trips break on exactly the
#: Uniqueness/Correlation-style metrics interop exists for
_JVM_MULTICOLUMN = "Mutlicolumn"


def write_jvm_metrics_history_json(results) -> str:
    """Serialize AnalysisResults into the reference's Gson metrics-history
    dialect: a JSON array of ``{"resultKey": {"dataSetDate", "tags"},
    "analyzerContext": {"metricMap": [{"analyzer", "metric"}, ...]}}``
    records — no ``formatVersion``, no ``checksum``, successful metrics
    only (the reference persists ``Try`` successes), and the JVM's literal
    ``"Mutlicolumn"`` entity spelling. Analyzers our serde cannot express
    as reference JSON are skipped, like the repository writer does."""
    import json

    from .metrics import Entity
    from .repository.serde import (
        SerializationError,
        serialize_analyzer,
        serialize_metric,
    )

    records = []
    for result in results:
        pairs = []
        for analyzer, metric in result.analyzer_context.metric_map.items():
            if metric.value.is_failure:
                continue
            try:
                pair = {
                    "analyzer": serialize_analyzer(analyzer),
                    "metric": serialize_metric(metric),
                }
            except SerializationError:
                continue
            if pair["metric"].get("entity") == Entity.MULTICOLUMN.value:
                pair["metric"]["entity"] = _JVM_MULTICOLUMN
            pairs.append(pair)
        records.append(
            {
                "resultKey": {
                    "dataSetDate": result.result_key.data_set_date,
                    "tags": result.result_key.tags_dict,
                },
                "analyzerContext": {"metricMap": pairs},
            }
        )
    return json.dumps(records)


def read_jvm_metrics_history_json(payload: str, source: str = "<json>"):
    """Parse a reference-written Gson metrics history into a list of
    :class:`~deequ_tpu_torch.repository.AnalysisResult`. Raises
    :class:`CorruptStateError` on structural violations (invalid JSON, a
    non-array root, records missing their key/context shape) — JVM
    histories carry no checksum, so the layout is the integrity check."""
    import json

    from .metrics import Entity
    from .repository import AnalysisResult, ResultKey
    from .repository.serde import deserialize_analyzer, deserialize_metric
    from .runners.context import AnalyzerContext

    def corrupt(detail: str) -> CorruptStateError:
        return CorruptStateError("JVM metrics-history JSON", source, detail)

    try:
        records = json.loads(payload)
    except ValueError as exc:
        raise corrupt(f"invalid JSON: {exc}") from exc
    if not isinstance(records, list):
        raise corrupt(f"root is {type(records).__name__}, expected an array")
    results = []
    for i, record in enumerate(records):
        try:
            key = ResultKey(
                record["resultKey"]["dataSetDate"],
                record["resultKey"].get("tags", {}),
            )
            metric_map = {}
            for pair in record["analyzerContext"]["metricMap"]:
                metric_d = dict(pair["metric"])
                if metric_d.get("entity") == _JVM_MULTICOLUMN:
                    metric_d["entity"] = Entity.MULTICOLUMN.value
                analyzer = deserialize_analyzer(pair["analyzer"])
                metric_map[analyzer] = deserialize_metric(metric_d)
        except (KeyError, TypeError, ValueError) as exc:
            raise corrupt(f"record {i}: {exc}") from exc
        results.append(AnalysisResult(key, AnalyzerContext(metric_map)))
    return results
