"""Partition-aware incremental verification: the delta planner (the JAX
package's ``deequ_tpu/runners/incremental.py``).

Algebraic state reuse (``AnalysisRunner.runOnAggregatedStates`` with a
StateLoader/StatePersister, SURVEY L3/L4) lets a growing dataset be
verified by folding only its new partitions. This module composes it from
checksummed persisted states, the bit-exact merge of merges (kernel
``state_fold`` and ``kll_compact``'s merge) and the aggregated-states
runner, plus a planner that decides, per partition, whether any data needs
touching at all:

==============  ==========================================================
decision        when / what happens
==============  ==========================================================
``scan``        partition never seen: scan it, persist its states, commit
                its manifest
``invalidated`` stored but stale — content checksum mismatch (the data
                changed), schema-contract fingerprint mismatch (the
                schema changed), battery outgrew the stored coverage, or
                the stored payload is corrupt (quarantined typed) — the
                partition re-scans and overwrites
``reuse``       stored and current: its states LOAD, its data is never
                touched
``dropped``     stored but absent from the incoming set (retention
                deleted it): it simply does not join the merge — metrics
                stay consistent because suite metrics are always a
                re-merge of exactly the incoming partitions
==============  ==========================================================

Fresh-partition scans run through ``do_analysis_run`` on ``device`` (or
over a mesh, ``sharding``), on the ingest tier ``placement``; stored and
fresh states then merge in one ``run_on_aggregated_states`` call, in the
incoming partition order, starting from the rollup cache when it folds a
prefix of that order. Non-sketch metrics equal a full re-scan bit for bit
when that scan's batch size equals the partitions' row count; KLL
sketches hold their rank envelope.

A table that grew 1% verifies by scanning 1% of its rows; the profiler and
the suggestion runner ride the same stored states
(:func:`profile_partitioned` / :func:`suggest_partitioned`).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

_logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# fingerprints and content checksums
# ---------------------------------------------------------------------------


def contract_fingerprint(schema) -> str:
    """The schema-contract fingerprint a partition's states are keyed
    under: column names + kinds, canonical-JSON checksummed. Column ORDER
    is part of the schema identity here (the engine's feature layout
    follows it); dictionary-encoding is NOT (it is a per-batch transport
    detail the drift guard owns)."""
    from ..integrity import checksum_json

    return checksum_json(
        {"columns": [[c.name, c.kind.value] for c in schema.columns]}
    )


def analyzer_key(analyzer) -> str:
    """The stable identity a partition manifest records per analyzer —
    ``repr`` of a frozen analyzer dataclass is deterministic across
    processes (the FS state provider already keys blobs on it)."""
    return repr(analyzer)


def dataset_content_checksum(data) -> str:
    """Content checksum of a materialized partition payload: every
    column's arrow buffers hashed with the integrity-plane digest and
    combined canonically. Runs at memory bandwidth (no scan, no device),
    but it DOES touch the bytes — callers wanting the zero-touch contract
    pass their own version token (file etag, snapshot id, ingest offset)
    instead.

    Each chunk's OFFSET and LENGTH join the digest: a zero-copy slice's
    ``buffers()`` are the un-trimmed PARENT buffers, so two different
    slices of one table would otherwise hash identically and stale
    stored states could silently serve the wrong window. The offset
    makes the digest change whenever the logical window moves (the safe
    direction — at worst an equal-content re-slice re-scans once)."""
    from ..integrity import checksum_bytes, checksum_json

    per_column: Dict[str, List[str]] = {}
    table = data.arrow
    for name in table.column_names:
        digests: List[str] = []
        for chunk in table.column(name).chunks:
            digests.append(f"@{chunk.offset}+{len(chunk)}:{chunk.type}")
            for buf in chunk.buffers():
                digests.append(
                    "-" if buf is None else checksum_bytes(memoryview(buf))
                )
        per_column[name] = digests
    return checksum_json({"rows": int(data.num_rows), "columns": per_column})


# ---------------------------------------------------------------------------
# partition inputs
# ---------------------------------------------------------------------------


class PartitionInput:
    """One incoming partition: a name, a payload (anything
    ``ingest.as_dataset`` accepts, or a zero-arg callable producing one,
    or ``None`` when only the version token is known), and an optional
    ``checksum`` version token. With a callable + checksum, an unchanged
    partition is planned and reused without the payload ever being
    produced — the zero-data-touched contract."""

    __slots__ = ("name", "_payload", "checksum", "_data")

    def __init__(self, name: str, payload: Any = None, checksum: Optional[str] = None):
        self.name = str(name)
        self._payload = payload
        self.checksum = None if checksum is None else str(checksum)
        self._data = None

    @property
    def materialized(self) -> bool:
        return self._data is not None

    @property
    def eager(self) -> bool:
        """Whether the payload is directly at hand (not a deferred
        callable): reading its schema costs nothing the caller didn't
        already pay."""
        return self._data is not None or (
            self._payload is not None and not callable(self._payload)
        )

    def data(self):
        """Materialize the payload (memoized). Raises ``ValueError`` when
        the partition carries no payload at all (a reuse-only input asked
        to re-scan — e.g. after a corruption quarantine)."""
        if self._data is None:
            payload = self._payload
            if callable(payload):
                payload = payload()
            if payload is None:
                raise ValueError(
                    f"partition {self.name!r} must be re-scanned but "
                    "carries no payload (pass data or a loader callable)"
                )
            from ..ingest.columnar import as_dataset

            self._data = as_dataset(payload)
        return self._data

    def release(self) -> None:
        """Drop the memoized Dataset of a CALLABLE payload (re-derivable
        on demand): the scan loop calls this after each partition's
        commit so a full-invalidation run holds one partition's decoded
        payload at a time, not all of them. Eager payloads stay — the
        caller holds the reference either way."""
        if callable(self._payload):
            self._data = None

    def resolve_checksum(self) -> Optional[str]:
        """The version token: caller-supplied, else a content digest of
        the materialized payload, else None (unversioned — planned as
        always-scan)."""
        if self.checksum is not None:
            return self.checksum
        if self._payload is not None and not callable(self._payload):
            self.checksum = dataset_content_checksum(self.data())
        return self.checksum


def normalize_partitions(
    partitions, checksums: Optional[Mapping[str, str]] = None
) -> "List[PartitionInput]":
    """Accepts a mapping name -> payload (payload may be a Dataset/arrow/
    dict/callable/None or an explicit ``PartitionInput``), or a sequence
    of ``PartitionInput``. ``checksums`` supplies version tokens by
    name."""
    checksums = dict(checksums or {})
    out: List[PartitionInput] = []
    if isinstance(partitions, Mapping):
        items = partitions.items()
    else:
        items = [(p.name, p) for p in partitions]
    seen = set()
    for name, payload in items:
        if name in seen:
            raise ValueError(f"duplicate partition name {name!r}")
        seen.add(name)
        if isinstance(payload, PartitionInput):
            if payload.name != name:
                raise ValueError(
                    f"partition mapping key {name!r} does not match the "
                    f"PartitionInput's own name {payload.name!r}"
                )
            if checksums.get(name) is not None and payload.checksum is None:
                payload.checksum = str(checksums[name])
            out.append(payload)
        else:
            out.append(PartitionInput(name, payload, checksums.get(name)))
    return out


# ---------------------------------------------------------------------------
# the delta plan
# ---------------------------------------------------------------------------


@dataclass
class DeltaPlan:
    """What the planner decided for one incremental run."""

    dataset: str
    fingerprint: str
    scan: List[str] = field(default_factory=list)
    reuse: List[str] = field(default_factory=list)
    #: subset of ``scan`` that had stored states which went stale (content
    #: change, fingerprint mismatch, battery growth, corruption)
    invalidated: List[str] = field(default_factory=list)
    #: stored partitions absent from the incoming set — excluded from the
    #: merge (and deletable by retention)
    dropped: List[str] = field(default_factory=list)
    #: partition -> why it scans / was invalidated
    reasons: Dict[str, str] = field(default_factory=dict)
    #: reused partition -> its manifest row count (zero data touched)
    reuse_rows: Dict[str, int] = field(default_factory=dict)

    @property
    def rows_reused(self) -> int:
        return sum(self.reuse_rows.values())

    @property
    def fully_reused(self) -> bool:
        return not self.scan

    def as_dict(self) -> Dict[str, Any]:
        return {
            "dataset": self.dataset,
            "scan": list(self.scan),
            "reuse": list(self.reuse),
            "invalidated": list(self.invalidated),
            "dropped": list(self.dropped),
            "reasons": dict(self.reasons),
        }


def plan_delta(
    store,
    dataset: str,
    partitions: Sequence[PartitionInput],
    fingerprint: str,
    analyzer_keys: Sequence[str],
    monitor=None,
) -> DeltaPlan:
    """Diff the incoming partition set against the store. Every decision
    lands as a trace event (one ``incremental_plan`` span per run) and on
    the RunMonitor's partition counters."""
    from ..exceptions import CorruptStateError
    from ..observability import trace as _trace

    plan = DeltaPlan(dataset=str(dataset), fingerprint=fingerprint)
    incoming = {p.name for p in partitions}
    with _trace.span(
        "incremental_plan", kind="incremental", dataset=str(dataset),
        partitions=len(partitions),
    ) as sp:
        for p in partitions:
            reason = None
            manifest = None
            try:
                manifest = store.get(dataset, p.name)
            except CorruptStateError as exc:
                # the manifest itself is rot: quarantined by the store;
                # treat exactly like a changed partition — re-scan it
                reason = f"corrupt-manifest: {exc}"
            if manifest is None and reason is None:
                reason = "new"
            elif reason is None:
                if manifest.fingerprint != fingerprint:
                    reason = "stale-fingerprint"
                elif not manifest.covers(analyzer_keys):
                    reason = "battery-grew"
                else:
                    checksum = p.resolve_checksum()
                    if checksum is None:
                        reason = "unversioned"
                    elif manifest.content_checksum != checksum:
                        reason = "content-changed"
            if reason is None:
                plan.reuse.append(p.name)
                plan.reuse_rows[p.name] = manifest.num_rows
                sp.add_event("partition_reuse", partition=p.name,
                             rows=manifest.num_rows)
            else:
                plan.scan.append(p.name)
                plan.reasons[p.name] = reason
                # "unversioned" is not staleness — the partition simply
                # cannot be validated, so it re-scans every run without
                # counting as an invalidation
                if reason not in ("new", "unversioned") and (
                    manifest is not None or "corrupt" in reason
                ):
                    plan.invalidated.append(p.name)
                sp.add_event("partition_scan", partition=p.name,
                             reason=reason)
        for name in store.list_partitions(dataset):
            if name not in incoming:
                plan.dropped.append(name)
                sp.add_event("partition_dropped", partition=name)
        sp.add_event(
            "plan", scan=len(plan.scan), reuse=len(plan.reuse),
            invalidated=len(plan.invalidated), dropped=len(plan.dropped),
        )
    if monitor is not None:
        monitor.bump("partitions_scanned", len(plan.scan))
        monitor.bump("partitions_reused", len(plan.reuse))
        monitor.bump("partitions_invalidated", len(plan.invalidated))
        monitor.bump("partitions_dropped", len(plan.dropped))
    return plan


# ---------------------------------------------------------------------------
# the incremental runner
# ---------------------------------------------------------------------------


class IncrementalRunReport:
    """Plan + cost accounting of one incremental run, attached to its
    result (``result.incremental``)."""

    def __init__(self, plan: DeltaPlan, rows_scanned: int, rows_total: int):
        self.plan = plan
        self.rows_scanned = int(rows_scanned)
        self.rows_total = int(rows_total)

    @property
    def reuse_ratio(self) -> float:
        """Fraction of merged partitions served from stored states."""
        n = len(self.plan.scan) + len(self.plan.reuse)
        return (len(self.plan.reuse) / n) if n else 0.0

    @property
    def rows_touched_fraction(self) -> float:
        return (
            self.rows_scanned / self.rows_total if self.rows_total else 0.0
        )

    def as_dict(self) -> Dict[str, Any]:
        d = self.plan.as_dict()
        d.update(
            rows_scanned=self.rows_scanned,
            rows_total=self.rows_total,
            reuse_ratio=round(self.reuse_ratio, 4),
            rows_touched_fraction=round(self.rows_touched_fraction, 4),
        )
        return d


def _scan_partition(
    store,
    dataset: str,
    part: PartitionInput,
    analyzers,
    fingerprint: str,
    keys: Sequence[str],
    *,
    batch_size=None,
    monitor=None,
    sharding=None,
    placement=None,
    device=None,
) -> Tuple[Any, int]:
    """One fresh partition: invalidate-first, scan persisting per-analyzer
    states, commit the manifest. Returns (AnalyzerContext, rows)."""
    from ..observability import trace as _trace
    from .analysis_runner import AnalysisRunner

    data = part.data()
    with _trace.span(
        "partition_scan", kind="incremental", dataset=str(dataset),
        partition=part.name, rows=int(data.num_rows),
    ):
        store.invalidate(dataset, part.name)
        provider = store.provider(dataset, part.name)
        ctx = AnalysisRunner.do_analysis_run(
            data, analyzers,
            save_states_with=provider,
            batch_size=batch_size, monitor=monitor,
            sharding=sharding, placement=placement, device=device,
        )
        store.commit(
            dataset, part.name,
            fingerprint=fingerprint,
            content_checksum=part.resolve_checksum(),
            num_rows=int(data.num_rows),
            analyzer_keys=keys,
            schema=[(c.name, c.kind.value) for c in data.schema.columns],
        )
    return ctx, int(data.num_rows)


class _TeePersister:
    """Fan one persist out to several persisters (rollup cache + the
    caller's save_states_with); None members are skipped."""

    def __init__(self, *persisters):
        self._persisters = [p for p in persisters if p is not None]

    def persist(self, analyzer, state) -> None:
        for p in self._persisters:
            p.persist(analyzer, state)


def _manifest_safe(store, dataset: str, name: str):
    """``store.get`` that treats a corrupt manifest as absent — the
    planner handles corruption with its typed re-scan path; auxiliary
    reads (schema resolution, row accounting) must not crash first."""
    from ..exceptions import CorruptStateError

    try:
        return store.get(dataset, name)
    except CorruptStateError:
        return None


def _schema_from_manifests(store, dataset: str, names: Sequence[str]):
    """Reconstruct a Schema from stored manifests (the fully-reused path's
    zero-data-touched schema source)."""
    from ..data import ColumnKind, ColumnSchema, Schema

    for name in names:
        manifest = _manifest_safe(store, dataset, name)
        if manifest is not None and manifest.schema:
            return Schema(
                tuple(
                    ColumnSchema(n, ColumnKind(k))
                    for n, k in manifest.schema
                )
            )
    return None


def _resolve_schema(store, dataset: str, parts: Sequence[PartitionInput]):
    """See run_incremental: eager payload > stored manifest > forced
    materialization of the first payload."""
    for p in parts:
        if p.eager:
            return p.data().schema
    schema = _schema_from_manifests(store, dataset, [p.name for p in parts])
    if schema is None:
        schema = parts[0].data().schema
    return schema


def run_incremental(
    store,
    dataset: str,
    partitions,
    analyzers: Sequence[Any],
    *,
    checksums: Optional[Mapping[str, str]] = None,
    batch_size=None,
    monitor=None,
    sharding=None,
    placement=None,
    save_states_with=None,
    metrics_repository=None,
    save_or_append_results_with_key=None,
    delete_dropped: bool = False,
    device=None,
):
    """The analysis half of an incremental run: plan the delta, scan only
    the fresh/changed partitions, merge stored + fresh states into ONE
    AnalyzerContext. Returns ``(AnalyzerContext, IncrementalRunReport)``.
    Scans and the merge run on ``device`` (``"cuda"`` by default; without a
    card the run raises unless ``device="cpu"``), or over the mesh
    ``sharding``.

    Failure semantics: a stored partition whose state blob is corrupt
    (torn .npz, checksum trip) QUARANTINES and falls back to re-scanning
    that partition only — the run degrades by one partition scan, never
    crashes, unless the partition's payload is unavailable (then the
    typed :class:`CorruptStateError` surfaces to the caller, who holds
    the only copy of the remedy)."""
    from ..exceptions import CorruptStateError
    from ..observability import record_failure
    from .analysis_runner import AnalysisRunner, _run_device
    from .engine import RunMonitor

    dev = _run_device(device, sharding)
    monitor = monitor if monitor is not None else RunMonitor()
    parts = normalize_partitions(partitions, checksums)
    if not parts:
        from .context import AnalyzerContext

        empty_plan = DeltaPlan(dataset=str(dataset), fingerprint="")
        return AnalyzerContext.empty(), IncrementalRunReport(empty_plan, 0, 0)
    # dedupe the battery exactly like the runner will
    unique = list(dict.fromkeys(analyzers))
    keys = [analyzer_key(a) for a in unique]

    # the schema (and therefore the fingerprint) comes from the cheapest
    # INCOMING source: an eagerly-passed payload first — the incoming
    # schema is what fingerprint staleness is judged against, so a stored
    # manifest may only supply it when every payload is deferred (the
    # zero-touch reuse path, where an unchanged version token implies an
    # unchanged schema) — else the first payload materializes
    schema = _resolve_schema(store, dataset, parts)
    fingerprint = contract_fingerprint(schema)

    plan = plan_delta(store, dataset, parts, fingerprint, keys, monitor)
    by_name = {p.name: p for p in parts}

    rows_scanned = 0
    scan_queue = list(plan.scan)
    scanned = set()
    while scan_queue:
        name = scan_queue.pop(0)
        if name in scanned:
            continue
        scanned.add(name)
        part = by_name[name]
        _, rows = _scan_partition(
            store, dataset, part, unique, fingerprint, keys,
            batch_size=batch_size, monitor=monitor, sharding=sharding,
            placement=placement, device=dev,
        )
        part.release()  # one decoded partition in memory at a time
        rows_scanned += rows

    # merge: stored (reused) + freshly-persisted states, all through the
    # store's checksummed loaders — the aggregated-states path. A corrupt
    # blob here (torn after commit) quarantines the partition and re-scans
    # it, exactly once per partition.
    def merged_context():
        # merge in the INCOMING partition order, independent of the
        # scan/reuse split: float merges associate by order, so a
        # corrupt-rescue re-scan must not reshuffle the fold (parity
        # against the aligned full scan is bit-exact only because this
        # order equals the data order)
        include = set(plan.reuse) | scanned
        names = [p.name for p in parts if p.name in include]
        # rollup prefix: when the stored rollup folds an exact PREFIX of
        # this run's partition sequence (same order, same content
        # checksums, all still reused, same fingerprint, battery
        # covered), the merge starts from it and folds only the suffix —
        # O(suffix) state loads instead of O(N). A left fold makes this
        # bitwise identical to folding every partition.
        prefix_len = 0
        rollup = store.rollup_get(dataset)
        if (
            rollup is not None
            and rollup.fingerprint == fingerprint
            and rollup.covers(keys)
            and len(rollup.folded) <= len(names)
        ):
            # prefix entries match on (name, content token) — NOT on the
            # scan/reuse split: a partition re-scanned with an UNCHANGED
            # token (a corrupt-blob rescue, a manifest loss) contributed
            # the same bits the rollup already folded, so the rollup
            # still serves it
            if all(
                names[i] == n
                and c is not None
                and by_name[n].checksum == c
                for i, (n, c) in enumerate(rollup.folded)
            ):
                prefix_len = len(rollup.folded)
        suffix = names[prefix_len:]
        merge_state["prefix"] = prefix_len
        loaders = (
            [store.rollup_provider(dataset)] if prefix_len else []
        ) + [store.loader(dataset, n) for n in suffix]
        write_rollup = suffix or not prefix_len
        rollup_persister = None
        if write_rollup:
            # invalidate-FIRST: the manifest must never describe blobs a
            # crash left half-overwritten
            store.rollup_invalidate(dataset)
            rollup_persister = store.rollup_provider(dataset)
        context = AnalysisRunner.run_on_aggregated_states(
            schema, unique, loaders,
            save_states_with=_TeePersister(
                rollup_persister, save_states_with
            ),
            metrics_repository=metrics_repository,
            save_or_append_results_with_key=save_or_append_results_with_key,
            device=dev, monitor=monitor,
        )
        if write_rollup:
            store.rollup_commit(
                dataset,
                fingerprint=fingerprint,
                analyzer_keys=keys,
                folded=[(n, by_name[n].checksum) for n in names],
                num_rows=rows_scanned + plan.rows_reused,
            )
        return context

    merge_state = {"prefix": 0}
    retried = set()
    while True:
        try:
            context = merged_context()
            break
        except CorruptStateError as exc:
            record_failure(exc)
            if merge_state["prefix"]:
                # the corruption may live in the ROLLUP cache's own
                # blobs: drop the cache and re-merge from the
                # per-partition states (the source of truth) before
                # blaming a partition
                _logger.warning(
                    "merge with the rollup prefix tripped a corruption "
                    "(%s); invalidating the rollup cache and re-merging "
                    "from partition states", exc,
                )
                store.rollup_invalidate(dataset)
                merge_state["prefix"] = 0
                continue
            victim = _partition_of_corruption(
                store, dataset, list(plan.reuse) + sorted(scanned), unique
            )
            if victim is None or victim in retried:
                raise
            retried.add(victim)
            monitor.bump("partitions_invalidated")
            if getattr(store, "monitor", None) is not monitor:
                # the store counts on its own monitor when it has one;
                # this run's ledger records the quarantine either way
                monitor.bump("corrupt_quarantined")
            store.quarantine_states(dataset, victim, str(exc))
            if victim in plan.reuse:
                plan.reuse.remove(victim)
                plan.reuse_rows.pop(victim, None)
            plan.invalidated.append(victim)
            plan.scan.append(victim)
            plan.reasons[victim] = "corrupt-state"
            _logger.warning(
                "stored states of partition %s/%s are corrupt; "
                "quarantined and re-scanning that partition only",
                dataset, victim,
            )
            scanned.add(victim)
            _, rows = _scan_partition(
                store, dataset, by_name[victim], unique, fingerprint, keys,
                batch_size=batch_size, monitor=monitor, sharding=sharding,
                placement=placement, device=dev,
            )
            rows_scanned += rows

    # counted AFTER the merge commits: a corruption-aborted attempt that
    # re-merged without the rollup must not report rollup-served
    # partitions it did not serve
    monitor.bump("partitions_rolled_up", merge_state["prefix"])

    if delete_dropped:
        for name in plan.dropped:
            store.delete(dataset, name)

    report = IncrementalRunReport(
        plan, rows_scanned, rows_scanned + plan.rows_reused
    )
    return context, report


def _partition_of_corruption(store, dataset, names, analyzers):
    """Which partition's stored states trip the typed corruption error —
    probed by loading each partition's states in isolation (cheap: state
    blobs, not data)."""
    from ..exceptions import CorruptStateError

    for name in names:
        loader = store.loader(dataset, name)
        for a in analyzers:
            try:
                loader.load(a)
            except CorruptStateError:
                return name
            except Exception:  # noqa: BLE001 - only corruption routes here
                continue
    return None


# ---------------------------------------------------------------------------
# profiler / suggestion runner on stored states
# ---------------------------------------------------------------------------


def _profile_battery(schema, kll_parameters=None, predefined_types=None,
                     histogram_columns: Sequence[str] = ()):
    """The schema-derivable profiler battery (the profiler's pass-1 set):
    Size + per-column Completeness/ApproxCountDistinct, DataType for
    string columns, the numeric analyzers for schema-typed numerics, and
    Histograms for the given low-cardinality columns. Numeric-LOOKING
    string columns (whose stats the serial profiler computes over an
    inference-casted view) are profiled for type/completeness/
    distinctness here but not numeric stats, as in the reference."""
    from ..analyzers import (
        ApproxCountDistinct,
        Completeness,
        DataType,
        Histogram,
        Size,
    )
    from ..data import ColumnKind
    from ..profiles import FRACTIONAL, INTEGRAL, _numeric_analyzers

    predefined_types = dict(predefined_types or {})
    battery: List[Any] = [Size()]
    for c in schema.columns:
        battery.append(Completeness(c.name))
        battery.append(ApproxCountDistinct(c.name))
        if c.kind == ColumnKind.STRING and c.name not in predefined_types:
            battery.append(DataType(c.name))
        elif c.kind.is_numeric and predefined_types.get(
            c.name, INTEGRAL
        ) in (INTEGRAL, FRACTIONAL):
            battery += _numeric_analyzers(c.name, kll_parameters)
    battery += [Histogram(name) for name in sorted(histogram_columns)]
    return battery


def profile_partitioned(
    store,
    dataset: str,
    partitions,
    *,
    checksums: Optional[Mapping[str, str]] = None,
    restrict_to_columns: Optional[Sequence[str]] = None,
    low_cardinality_histogram_threshold: Optional[int] = None,
    kll_parameters=None,
    predefined_types: Optional[Mapping[str, str]] = None,
    batch_size=None,
    monitor=None,
    sharding=None,
    placement=None,
    device=None,
):
    """Column profiles over a partitioned dataset, riding the SAME stored
    states the verification plane persists: unchanged partitions
    contribute their stored profiler states with zero data touched; only
    new/changed partitions scan. Returns ``(ColumnProfiles,
    IncrementalRunReport)``.

    The battery is the schema-derivable profiler set (see
    `_profile_battery`); numeric-string inference casting — the serial
    profiler's pass 2 — is out of scope for state reuse and documented
    as such."""
    from ..profiles import (
        DEFAULT_CARDINALITY_THRESHOLD,
        _create_profiles,
        _extract_generic_statistics,
        _extract_numeric_statistics,
        _find_target_columns_for_histograms,
    )
    from ..analyzers.grouping import Histogram

    threshold = (
        DEFAULT_CARDINALITY_THRESHOLD
        if low_cardinality_histogram_threshold is None
        else int(low_cardinality_histogram_threshold)
    )
    parts = normalize_partitions(partitions, checksums)
    schema = _resolve_schema(store, dataset, parts)
    relevant = [
        c.name for c in schema.columns
        if restrict_to_columns is None or c.name in restrict_to_columns
    ]
    if restrict_to_columns is not None:
        for name in restrict_to_columns:
            if name not in schema:
                raise ValueError(f"Unable to find column {name}")

    # low-cardinality histogram columns must be decidable without a scan:
    # dictionary-encoded columns qualify by dictionary size when a payload
    # is at hand, else by the Histogram states already stored
    hist_cols: List[str] = []
    sample = next((p for p in parts if p.eager), None)
    if sample is not None:
        hist_cols = [
            name for name in relevant
            if (size := sample.data().dictionary_size(name)) is not None
            and size <= threshold
        ]
    else:
        known = store.list_partitions(dataset)
        if known:
            manifest = _manifest_safe(store, dataset, known[0])
            if manifest is not None:
                hist_cols = [
                    name for name in relevant
                    if analyzer_key(Histogram(name)) in manifest.analyzer_keys
                ]

    battery = _profile_battery(
        schema, kll_parameters=kll_parameters,
        predefined_types=predefined_types, histogram_columns=hist_cols,
    )
    if restrict_to_columns is not None:
        battery = [
            a for a in battery
            if getattr(a, "column", None) in (None, *relevant)
            and all(c in relevant for c in getattr(a, "columns", ()))
        ]
    context, report = run_incremental(
        store, dataset, parts, battery,
        batch_size=batch_size, monitor=monitor, sharding=sharding,
        placement=placement, device=device,
    )
    generic = _extract_generic_statistics(
        relevant, schema, context, dict(predefined_types or {})
    )
    numeric_stats = _extract_numeric_statistics(context)
    histograms: Dict[str, Any] = {}
    eligible = set(
        _find_target_columns_for_histograms(schema, generic, threshold)
    ) | set(hist_cols)
    for analyzer, metric in context.metric_map.items():
        if (
            isinstance(analyzer, Histogram)
            and metric.value.is_success
            and analyzer.column in eligible
        ):
            histograms[analyzer.column] = metric.value.get()
    profiles = _create_profiles(relevant, generic, numeric_stats, histograms)
    return profiles, report


def suggest_partitioned(
    store,
    dataset: str,
    partitions,
    constraint_rules,
    *,
    checksums: Optional[Mapping[str, str]] = None,
    restrict_to_columns: Optional[Sequence[str]] = None,
    low_cardinality_histogram_threshold: Optional[int] = None,
    kll_parameters=None,
    predefined_types: Optional[Mapping[str, str]] = None,
    batch_size=None,
    monitor=None,
    device=None,
):
    """Constraint suggestions over a partitioned dataset riding the same
    stored states (profile incrementally, then apply the rules). Returns
    ``(ConstraintSuggestionResult, IncrementalRunReport)``."""
    from ..suggestions import apply_rules

    profiles, report = profile_partitioned(
        store, dataset, partitions,
        checksums=checksums,
        restrict_to_columns=restrict_to_columns,
        low_cardinality_histogram_threshold=low_cardinality_histogram_threshold,
        kll_parameters=kll_parameters,
        predefined_types=predefined_types,
        batch_size=batch_size,
        monitor=monitor,
        device=device,
    )
    return apply_rules(profiles, constraint_rules), report
