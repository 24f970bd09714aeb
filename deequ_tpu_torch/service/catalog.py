"""Tenant catalog: per-tenant quality suites as versioned, checksummed
DATA (the JAX package's module, copied: host code, whose sessions fold on
the service's device).

A fleet of a million tenants cannot be a million Python call sites
constructing ``Check`` objects — tenants become DOCUMENTS. One JSON document per tenant declares its whole quality
suite: checks, anomaly watches, drift policy, row-gate schema, partition
retention, priority/SLO class and admission quotas. The catalog stores
them versioned + checksummed in the partition-store layout
(``<root>/t-<tenant>/v00000001.json``; byte for byte the JAX package's
layout, so a catalog root written by either package loads in the other),
and the service plane
materializes live state (streaming session, row gate, quotas, watches)
from the CURRENT document on first ingest — and re-materializes it at
fold boundaries when the document changes, without a restart.

Robustness contract (the reason this module exists):

- **last-good wins.** A corrupt or invalid document version NEVER drops a
  live tenant: :meth:`TenantCatalog.load` quarantines the bad version
  content-addressed (the partition store's ``.quarantine`` convention),
  bumps exactly one typed counter, and serves the newest version that
  parses + verifies. Only a tenant with NO good version raises
  :class:`CatalogError`.
- **writes are validated + atomic.** :meth:`TenantCatalog.register`
  validates the document (typed :class:`CatalogError` on rejection —
  an operator typo is caught at write time, not at 3am on the ingest
  path) and writes the next version via atomic rename, so a torn write
  can only ever produce a missing version, not a half document.
- **hot/cold tiering.** Registered-but-idle tenants cost a directory on
  disk and nothing in memory: session + watch state materialize on first
  ingest (:meth:`CatalogPlane.ensure_session`) and evict on idle TTL
  (:meth:`CatalogPlane.sweep`), so 1M registered / 1k active costs 1k
  tenants.
- the ``catalog_load`` fault site wires document loading into the chaos
  plane: an injected ``corrupt`` fault quarantines exactly like a torn
  on-disk document.

Document model (every key optional unless noted)::

    {
      "checks": [{"name": str, "level": "error"|"warning",
                  "constraints": [{"kind": str, "column": str,
                                   "min": num, "max": num, ...}]}],
      "row_gate": {"columns": [{"name": str (required),
                                "type": "string"|"int"|"decimal"|"timestamp",
                                "nullable": bool, "min_length": int,
                                "max_length": int, "matches": str,
                                "min_value": num, "max_value": num,
                                "precision": int, "scale": int,
                                "mask": str}]},
      "watches": [{"analyzer": {"kind": str, "column": str,
                                "columns": [str]},
                   "strategy": {"kind": "online_normal"|"simple_threshold"
                                |"absolute_change", ...params}}],
      "drift_policy": "reject"|"coerce"|"degrade",
      "priority": "high"|"normal"|"low",
      "quotas": {"rows_per_s": num, "bytes_per_s": num,
                 "queue_share": num in (0, 1]},
      "retention": {"keep_partitions": int},
      "session": {"batch_size": int, "keep_results": int,
                  "admission_block_s": num, "deadline_s": num,
                  "max_retries": int}
    }
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

_logger = logging.getLogger(__name__)

from .. import io as dio
from ..utils import env_number

#: seconds a HOT tenant (materialized session + watch state) may sit idle
#: before :meth:`CatalogPlane.sweep` evicts it back to the cold tier
#: (close + flush; the document stays registered). Warn-once parser.
CATALOG_HOT_TTL_ENV = "DEEQU_TPU_CATALOG_HOT_TTL_S"
DEFAULT_CATALOG_HOT_TTL_S = 300.0

#: seconds between version polls of a hot tenant's document at fold
#: boundaries — the hot-reload debounce: a 10k-fold/s tenant must not
#: stat the catalog directory 10k times a second. Warn-once parser.
CATALOG_POLL_ENV = "DEEQU_TPU_CATALOG_POLL_S"
DEFAULT_CATALOG_POLL_S = 2.0


def catalog_hot_ttl_s() -> float:
    return float(env_number(
        CATALOG_HOT_TTL_ENV, DEFAULT_CATALOG_HOT_TTL_S, float, minimum=0.0
    ))


def catalog_poll_s() -> float:
    return float(env_number(
        CATALOG_POLL_ENV, DEFAULT_CATALOG_POLL_S, float, minimum=0.0
    ))


class CatalogError(Exception):
    """A tenant catalog operation failed TYPED: an invalid document at
    registration time (the operator hears about the typo immediately), or
    a load for a tenant with no good version (unregistered, or every
    version corrupt AND no last-good cached). Never raised for a tenant
    that has ANY servable version — a bad edit degrades to last-good, not
    to an error."""

    def __init__(self, tenant: str, detail: str):
        self.tenant = str(tenant)
        super().__init__(f"tenant catalog [{tenant}]: {detail}")


@dataclass(frozen=True)
class TenantDocument:
    """One validated, checksummed catalog version as loaded from disk."""

    tenant: str
    version: int
    doc: Dict[str, Any]


# -- document validation + declarative builders ------------------------------

#: constraint kinds the declarative schema accepts, with the document keys
#: each reads. Deliberately a CLOSED set with numeric bounds instead of
#: arbitrary expressions: documents are data written by operators, and
#: data must not smuggle code (no eval, no lambdas on the wire).
_CONSTRAINT_KINDS = {
    "size": ("min", "max"),
    "complete": ("column",),
    "completeness": ("column", "min", "max"),
    "unique": ("column",),
    "uniqueness": ("columns", "min"),
    "distinctness": ("columns", "min"),
    "entropy": ("column", "min", "max"),
    "min": ("column", "min", "max"),
    "max": ("column", "min", "max"),
    "mean": ("column", "min", "max"),
    "sum": ("column", "min", "max"),
    "standard_deviation": ("column", "min", "max"),
    "min_length": ("column", "min", "max"),
    "max_length": ("column", "min", "max"),
    "approx_count_distinct": ("column", "min", "max"),
    "pattern": ("column", "pattern"),
    "non_negative": ("column",),
    "positive": ("column",),
    "contained_in": ("column", "allowed"),
}

_ROW_GATE_TYPES = ("string", "int", "decimal", "timestamp")

_WATCH_ANALYZERS = (
    "size", "completeness", "mean", "minimum", "maximum", "sum",
    "standard_deviation", "approx_count_distinct", "uniqueness",
    "distinctness", "entropy",
)

_WATCH_STRATEGIES = ("online_normal", "simple_threshold", "absolute_change")


def _bound_assertion(lo, hi):
    """min/max bounds -> the assertion callable the Check builders take.
    Closed over plain floats — documents carry bounds, never code."""
    lo = None if lo is None else float(lo)
    hi = None if hi is None else float(hi)

    def assertion(value: float) -> bool:
        if lo is not None and value < lo:
            return False
        if hi is not None and value > hi:
            return False
        return True

    return assertion


def _reject(tenant: str, detail: str):
    raise CatalogError(tenant, detail)


def validate_document(tenant: str, doc: Any) -> Dict[str, Any]:
    """Structural validation of one tenant document; raises typed
    :class:`CatalogError` naming the offending key. Returns ``doc``.
    Validation is deliberately strict on SHAPE (unknown constraint kinds,
    wrong types, unknown policies all reject) — a silently-ignored typo'd
    check is a tenant who believes they are verified and is not."""
    if not isinstance(doc, dict):
        _reject(tenant, f"document must be a JSON object, got {type(doc).__name__}")
    for check in doc.get("checks", ()):
        if not isinstance(check, dict):
            _reject(tenant, "checks[] entries must be objects")
        level = check.get("level", "error")
        if level not in ("error", "warning"):
            _reject(tenant, f"unknown check level {level!r}")
        for c in check.get("constraints", ()):
            if not isinstance(c, dict):
                _reject(tenant, "constraints[] entries must be objects")
            kind = c.get("kind")
            if kind not in _CONSTRAINT_KINDS:
                _reject(tenant, f"unknown constraint kind {kind!r}")
            allowed = _CONSTRAINT_KINDS[kind]
            for key in c:
                if key != "kind" and key not in allowed:
                    _reject(
                        tenant,
                        f"constraint kind {kind!r} does not take {key!r}",
                    )
            if "column" in allowed and not isinstance(
                c.get("column", ""), str
            ):
                _reject(tenant, f"constraint {kind!r}: column must be a string")
            if "column" in allowed and "columns" not in allowed and not c.get("column"):
                _reject(tenant, f"constraint {kind!r} requires a column")
            if "columns" in allowed and not c.get("columns"):
                _reject(tenant, f"constraint {kind!r} requires columns")
            if kind == "pattern":
                if not c.get("pattern"):
                    _reject(tenant, "constraint 'pattern' requires a pattern")
                try:
                    re.compile(c["pattern"])
                except re.error as err:
                    _reject(
                        tenant,
                        f"constraint 'pattern': invalid regex "
                        f"{c['pattern']!r} ({err})",
                    )
            if kind == "contained_in" and not isinstance(
                c.get("allowed"), list
            ):
                _reject(tenant, "constraint 'contained_in' requires allowed[]")
    gate = doc.get("row_gate")
    if gate is not None:
        if not isinstance(gate, dict) or not isinstance(
            gate.get("columns"), list
        ) or not gate["columns"]:
            _reject(tenant, "row_gate requires a non-empty columns[] list")
        for col in gate["columns"]:
            if not isinstance(col, dict) or not col.get("name"):
                _reject(tenant, "row_gate columns[] entries require a name")
            if col.get("type", "string") not in _ROW_GATE_TYPES:
                _reject(
                    tenant,
                    f"row_gate column {col.get('name')!r}: unknown type "
                    f"{col.get('type')!r}",
                )
            if col.get("matches") is not None:
                try:
                    re.compile(col["matches"])
                except re.error as err:
                    _reject(
                        tenant,
                        f"row_gate column {col.get('name')!r}: invalid "
                        f"regex {col['matches']!r} ({err})",
                    )
    for watch in doc.get("watches", ()):
        if not isinstance(watch, dict) or not isinstance(
            watch.get("analyzer"), dict
        ):
            _reject(tenant, "watches[] entries require an analyzer object")
        akind = watch["analyzer"].get("kind")
        if akind not in _WATCH_ANALYZERS:
            _reject(tenant, f"unknown watch analyzer kind {akind!r}")
        if akind != "size" and not (
            watch["analyzer"].get("column") or watch["analyzer"].get("columns")
        ):
            _reject(tenant, f"watch analyzer {akind!r} requires a column")
        strategy = watch.get("strategy")
        if strategy is not None and strategy.get("kind") not in _WATCH_STRATEGIES:
            _reject(
                tenant, f"unknown watch strategy {strategy.get('kind')!r}"
            )
    from .drift import DRIFT_POLICIES

    policy = doc.get("drift_policy", "reject")
    if policy not in DRIFT_POLICIES:
        _reject(tenant, f"drift_policy must be one of {DRIFT_POLICIES}")
    if doc.get("priority", "normal") not in ("high", "normal", "low"):
        _reject(tenant, f"unknown priority {doc.get('priority')!r}")
    quotas = doc.get("quotas")
    if quotas is not None:
        if not isinstance(quotas, dict):
            _reject(tenant, "quotas must be an object")
        for key, value in quotas.items():
            if key not in ("rows_per_s", "bytes_per_s", "queue_share"):
                _reject(tenant, f"unknown quota {key!r}")
            if not isinstance(value, (int, float)) or value <= 0:
                _reject(tenant, f"quota {key!r} must be a positive number")
        if quotas.get("queue_share", 0.5) > 1:
            _reject(tenant, "queue_share is a fraction in (0, 1]")
    retention = doc.get("retention")
    if retention is not None and not isinstance(retention, dict):
        _reject(tenant, "retention must be an object")
    session = doc.get("session")
    if session is not None and not isinstance(session, dict):
        _reject(tenant, "session must be an object")
    return doc


def build_checks(tenant: str, doc: Dict[str, Any]) -> List[Any]:
    """Document ``checks`` -> live :class:`~deequ_tpu_torch.checks.Check`
    objects via the fluent builders (the same constraint machinery every
    in-process caller uses — documents are a FRONTEND, not a fork)."""
    from ..checks import Check, CheckLevel

    out = []
    for spec in doc.get("checks", ()):
        level = (
            CheckLevel.WARNING if spec.get("level") == "warning"
            else CheckLevel.ERROR
        )
        check = Check(level, spec.get("name", f"{tenant}-check"))
        for c in spec.get("constraints", ()):
            kind = c["kind"]
            col = c.get("column")
            assertion = _bound_assertion(c.get("min"), c.get("max"))
            if kind == "size":
                check = check.has_size(assertion)
            elif kind == "complete":
                check = check.is_complete(col)
            elif kind == "completeness":
                check = check.has_completeness(col, assertion)
            elif kind == "unique":
                check = check.is_unique(col)
            elif kind == "uniqueness":
                check = check.has_uniqueness(
                    list(c["columns"]), _bound_assertion(c.get("min"), None)
                )
            elif kind == "distinctness":
                check = check.has_distinctness(
                    list(c["columns"]), _bound_assertion(c.get("min"), None)
                )
            elif kind == "entropy":
                check = check.has_entropy(col, assertion)
            elif kind == "min":
                check = check.has_min(col, assertion)
            elif kind == "max":
                check = check.has_max(col, assertion)
            elif kind == "mean":
                check = check.has_mean(col, assertion)
            elif kind == "sum":
                check = check.has_sum(col, assertion)
            elif kind == "standard_deviation":
                check = check.has_standard_deviation(col, assertion)
            elif kind == "min_length":
                check = check.has_min_length(col, assertion)
            elif kind == "max_length":
                check = check.has_max_length(col, assertion)
            elif kind == "approx_count_distinct":
                check = check.has_approx_count_distinct(col, assertion)
            elif kind == "pattern":
                check = check.has_pattern(col, c["pattern"])
            elif kind == "non_negative":
                check = check.is_non_negative(col)
            elif kind == "positive":
                check = check.is_positive(col)
            elif kind == "contained_in":
                check = check.is_contained_in(col, list(c["allowed"]))
            else:  # pragma: no cover - validate_document pins the set
                raise CatalogError(tenant, f"unbuildable constraint {kind!r}")
        out.append(check)
    return out


def build_row_gate_schema(doc: Dict[str, Any]):
    """Document ``row_gate`` -> a
    :class:`~deequ_tpu_torch.schema.RowLevelSchema` (None when the document
    declares no gate)."""
    gate = doc.get("row_gate")
    if gate is None:
        return None
    from ..schema import RowLevelSchema

    schema = RowLevelSchema()
    for col in gate["columns"]:
        kind = col.get("type", "string")
        nullable = bool(col.get("nullable", True))
        if kind == "string":
            schema = schema.with_string_column(
                col["name"], is_nullable=nullable,
                min_length=col.get("min_length"),
                max_length=col.get("max_length"),
                matches=col.get("matches"),
            )
        elif kind == "int":
            schema = schema.with_int_column(
                col["name"], is_nullable=nullable,
                min_value=col.get("min_value"),
                max_value=col.get("max_value"),
            )
        elif kind == "decimal":
            schema = schema.with_decimal_column(
                col["name"], int(col.get("precision", 10)),
                int(col.get("scale", 0)), is_nullable=nullable,
            )
        else:
            schema = schema.with_timestamp_column(
                col["name"], col.get("mask", "yyyy-MM-dd HH:mm:ss"),
                is_nullable=nullable,
            )
    return schema


def build_quota(doc: Dict[str, Any]):
    """Document ``quotas`` -> a
    :class:`~deequ_tpu_torch.service.scheduler.TenantQuota` (None when the
    document declares none)."""
    quotas = doc.get("quotas")
    if quotas is None:
        return None
    from .scheduler import TenantQuota

    return TenantQuota(
        rows_per_s=quotas.get("rows_per_s"),
        bytes_per_s=quotas.get("bytes_per_s"),
        queue_share=quotas.get("queue_share"),
    )


def build_priority(doc: Dict[str, Any]):
    from .scheduler import Priority

    return {
        "high": Priority.HIGH, "low": Priority.LOW,
    }.get(doc.get("priority", "normal"), Priority.NORMAL)


def build_watches(doc: Dict[str, Any]) -> List[Tuple[Any, Any]]:
    """Document ``watches`` -> ``[(analyzer, strategy)]`` pairs ready for
    :meth:`~deequ_tpu_torch.service.fleetwatch.FleetWatch.watch`."""
    from ..analyzers import (
        ApproxCountDistinct,
        Completeness,
        Distinctness,
        Entropy,
        Maximum,
        Mean,
        Minimum,
        Size,
        StandardDeviation,
        Sum,
        Uniqueness,
    )
    from ..anomalydetection import (
        AbsoluteChangeStrategy,
        OnlineNormalStrategy,
        SimpleThresholdStrategy,
    )

    single = {
        "completeness": Completeness, "mean": Mean, "minimum": Minimum,
        "maximum": Maximum, "sum": Sum,
        "standard_deviation": StandardDeviation,
        "approx_count_distinct": ApproxCountDistinct, "entropy": Entropy,
    }
    multi = {"uniqueness": Uniqueness, "distinctness": Distinctness}
    out = []
    for watch in doc.get("watches", ()):
        spec = watch["analyzer"]
        kind = spec["kind"]
        if kind == "size":
            analyzer = Size()
        elif kind in multi:
            analyzer = multi[kind](
                list(spec.get("columns") or [spec["column"]])
            )
        else:
            analyzer = single[kind](spec["column"])
        sspec = watch.get("strategy") or {}
        skind = sspec.get("kind", "online_normal")
        if skind == "simple_threshold":
            strategy = SimpleThresholdStrategy(
                upper_bound=float(sspec.get("upper_bound", float("inf"))),
                lower_bound=float(sspec.get("lower_bound", float("-inf"))),
            )
        elif skind == "absolute_change":
            strategy = AbsoluteChangeStrategy(
                max_rate_decrease=sspec.get("max_rate_decrease"),
                max_rate_increase=sspec.get("max_rate_increase"),
            )
        else:
            strategy = OnlineNormalStrategy(
                lower_deviation_factor=float(
                    sspec.get("lower_deviation_factor", 3.0)
                ),
                upper_deviation_factor=float(
                    sspec.get("upper_deviation_factor", 3.0)
                ),
            )
        out.append((analyzer, strategy))
    return out


# -- the store ---------------------------------------------------------------


def describe_catalog_series(metrics) -> None:
    """Register HELP text for every export-plane series the catalog plane
    increments (idempotent; literal calls for the statlint export check)."""
    metrics.describe(
        "deequ_service_catalog_loads_total",
        "Tenant catalog documents loaded (registration reads, first-"
        "ingest materializations and hot-reload polls that re-read).",
    )
    metrics.describe(
        "deequ_service_catalog_reloads_total",
        "Hot reloads APPLIED to live sessions at fold boundaries after a "
        "catalog edit (no restart).",
    )
    metrics.describe(
        "deequ_service_catalog_quarantined_total",
        "Corrupt or invalid catalog document versions quarantined "
        "content-addressed; the tenant kept serving its last-good "
        "version.",
    )
    metrics.describe(
        "deequ_service_catalog_evictions_total",
        "Hot tenants evicted to the cold tier after their idle TTL "
        "(session closed + flushed; the document stays registered).",
    )


def _tenant_dirname(tenant: str) -> str:
    from urllib.parse import quote

    return "t-" + quote(str(tenant), safe="")


_VERSION_DIGITS = 8


class TenantCatalog:
    """The versioned document store. Thread-safe; every mutation is an
    atomic whole-file write, so concurrent registers at worst interleave
    version numbers (each version is still internally consistent)."""

    def __init__(self, path: str, metrics=None):
        self.path = str(path)
        self.metrics = metrics
        if metrics is not None:
            describe_catalog_series(metrics)
        self._lock = threading.Lock()
        #: tenant -> last GOOD TenantDocument served by load(): what a
        #: tenant keeps serving when every on-disk version goes bad
        #: mid-flight (disk loss after a successful load)
        self._last_good: Dict[str, TenantDocument] = {}
        #: version paths already quarantined by this process — dedupes
        #: the counter bump when the original could not be removed (a
        #: read-only store re-walks the same bad file every load)
        self._quarantined_paths: set = set()

    # -- paths ---------------------------------------------------------------

    def _tenant_dir(self, tenant: str) -> str:
        return dio.join(self.path, _tenant_dirname(tenant))

    def _versions(self, tenant: str) -> List[int]:
        out = []
        for name in dio.list_files(self._tenant_dir(tenant)):
            if name.startswith("v") and name.endswith(".json"):
                try:
                    out.append(int(name[1:-5]))
                except ValueError:
                    continue
        return sorted(out)

    # -- registration --------------------------------------------------------

    def register(self, tenant: str, doc: Dict[str, Any]) -> TenantDocument:
        """Validate ``doc`` and write it as the tenant's next version.
        Raises typed :class:`CatalogError` on an invalid document —
        NOTHING is written, the tenant's current version is untouched."""
        validate_document(tenant, doc)
        # exercise the full builder path at registration time: a document
        # that validates structurally but cannot BUILD (a regex that does
        # not compile) must bounce here, not on the ingest path
        try:
            build_checks(tenant, doc)
            build_row_gate_schema(doc)
            build_quota(doc)
            build_watches(doc)
        except CatalogError:
            raise
        except Exception as exc:  # noqa: BLE001 - rebuilt typed
            raise CatalogError(
                str(tenant), f"document does not build: {exc}"
            ) from exc
        with self._lock:
            versions = self._versions(tenant)
            version = (versions[-1] + 1) if versions else 1
            payload = {
                "tenant": str(tenant), "version": version, "doc": doc,
            }
            from ..integrity import checksum_json

            payload["checksum"] = checksum_json(payload)
            dio.makedirs(self._tenant_dir(tenant))
            dio.write_text_atomic(
                dio.join(
                    self._tenant_dir(tenant),
                    f"v{version:0{_VERSION_DIGITS}d}.json",
                ),
                json.dumps(payload, sort_keys=True),
            )
        return TenantDocument(str(tenant), version, doc)

    def registered(self, tenant: str) -> bool:
        return dio.exists(self._tenant_dir(tenant))

    def tenants(self) -> List[str]:
        from urllib.parse import unquote

        return [
            unquote(name[2:]) for name in dio.list_dirs(self.path)
            if name.startswith("t-")
        ]

    def registered_count(self) -> int:
        return sum(
            1 for name in dio.list_dirs(self.path) if name.startswith("t-")
        )

    def current_version(self, tenant: str) -> int:
        """The newest on-disk version number (0 = unregistered) — a pure
        listing, no parse: the hot-reload poll's cheap staleness probe."""
        versions = self._versions(tenant)
        return versions[-1] if versions else 0

    # -- loading -------------------------------------------------------------

    def load(self, tenant: str) -> TenantDocument:
        """The newest GOOD document version for ``tenant``. Walks versions
        newest-first; a version that is torn, fails its checksum, or fails
        validation is quarantined content-addressed + counted, and the
        walk continues to the previous version (LAST-GOOD semantics: a
        bad edit can never drop a live tenant). Raises
        :class:`CatalogError` only when NO version is servable and no
        last-good is cached."""
        tenant = str(tenant)
        versions = self._versions(tenant)
        for version in reversed(versions):
            path = dio.join(
                self._tenant_dir(tenant),
                f"v{version:0{_VERSION_DIGITS}d}.json",
            )
            try:
                from ..reliability.faults import fault_point

                # chaos site: a `corrupt` fault here stands in for a
                # torn/garbled on-disk document — quarantined exactly
                # like the real thing, last-good keeps serving
                fault_point("catalog_load", tag=tenant)
                with dio.open_file(path, "r") as fh:
                    payload = json.load(fh)
                from ..integrity import verify_json_checksum

                verify_json_checksum(
                    {k: v for k, v in payload.items() if k != "checksum"},
                    payload.get("checksum", ""),
                    "tenant catalog document", path,
                )
                doc = validate_document(tenant, payload["doc"])
                loaded = TenantDocument(tenant, version, doc)
                with self._lock:
                    self._last_good[tenant] = loaded
                if self.metrics is not None:
                    self.metrics.inc(
                        "deequ_service_catalog_loads_total", tenant=tenant
                    )
                return loaded
            except Exception as exc:  # noqa: BLE001 - quarantine + walk on
                self._quarantine_version(tenant, path, exc)
        with self._lock:
            cached = self._last_good.get(tenant)
        if cached is not None:
            _logger.warning(
                "tenant %s has no servable on-disk catalog version; "
                "serving the cached last-good v%d", tenant, cached.version,
            )
            return cached
        raise CatalogError(
            tenant,
            "no servable document version"
            if versions else "tenant is not registered",
        )

    def _quarantine_version(
        self, tenant: str, path: str, exc: BaseException
    ) -> None:
        """MOVE one bad document version into the content-addressed
        sidecar (the partition store's ``.quarantine`` convention) +
        exactly one typed counter bump. The move (copy, then remove the
        original) is what makes the bump exactly-once: a quarantined
        version leaves the tenant's listing, so the next load — and the
        hot-reload poll — never walk past it again. Best-effort on every
        step: an unwritable store must not turn a survivable bad edit
        into a crash, and an unremovable original degrades to a counted
        re-quarantine (deduped in-process), never a lost tenant."""
        from ..integrity import checksum_bytes
        from ..observability import trace as _trace

        with self._lock:
            if path in self._quarantined_paths:
                return
            self._quarantined_paths.add(path)
        payload = b""
        try:
            with dio.open_file(path, "rb") as fh:
                payload = fh.read()
        except Exception:  # noqa: BLE001 - the version may not even exist
            pass
        if payload:
            import os

            side_dir = self.path + ".quarantine"
            name = f"{os.path.basename(path)}-{checksum_bytes(payload)}"
            try:
                dio.makedirs(side_dir)
                with dio.open_file(dio.join(side_dir, name), "wb") as fh:
                    fh.write(payload)
            except Exception:  # noqa: BLE001 - best-effort preservation
                pass
            else:
                # content is preserved in the sidecar: complete the move
                # so the bad version stops shadowing last-good in the
                # listing (evidence is never deleted before it is copied)
                try:
                    dio.remove_file(path)
                except Exception:  # noqa: BLE001 - dedupe set covers this
                    pass
        if self.metrics is not None:
            self.metrics.inc(
                "deequ_service_catalog_quarantined_total", tenant=tenant
            )
        _trace.add_event(
            "catalog_version_quarantined", tenant=tenant, source=path,
            reason=f"{type(exc).__name__}: {str(exc)[:200]}",
        )
        _logger.warning(
            "quarantined bad catalog document %s for tenant %s: %s",
            path, tenant, exc,
        )


# -- the hot tier ------------------------------------------------------------


@dataclass
class _HotTenant:
    """Per-(tenant, dataset) hot-tier bookkeeping."""

    version: int
    last_seen: float
    last_poll: float
    watch_keys: Tuple[Tuple[str, str], ...] = ()


class CatalogPlane:
    """Binds a :class:`TenantCatalog` to a live
    :class:`~deequ_tpu_torch.service.VerificationService`: materializes
    sessions (+ row gate + quotas + watches) from documents on first
    ingest, hot-reloads them at fold boundaries when the document
    changes, and evicts idle tenants back to the cold tier on TTL."""

    def __init__(
        self,
        service,
        catalog: TenantCatalog,
        *,
        hot_ttl_s: Optional[float] = None,
        poll_s: Optional[float] = None,
    ):
        self.service = service
        self.catalog = catalog
        if catalog.metrics is None:
            catalog.metrics = service.metrics
        self.hot_ttl_s = (
            catalog_hot_ttl_s() if hot_ttl_s is None else float(hot_ttl_s)
        )
        self.poll_s = catalog_poll_s() if poll_s is None else float(poll_s)
        self._lock = threading.Lock()
        self._hot: Dict[Tuple[str, str], _HotTenant] = {}
        describe_catalog_series(service.metrics)
        service.metrics.set_gauge_fn(
            "deequ_service_catalog_hot_tenants",
            lambda: len(self._hot),
            "Catalog tenants currently materialized on the hot tier "
            "(live session + watch state).",
        )
        service.metrics.set_gauge_fn(
            "deequ_service_catalog_registered_tenants",
            self.catalog.registered_count,
            "Tenants registered in the catalog (hot or cold).",
        )

    # -- materialization -----------------------------------------------------

    def ensure_session(self, tenant: str, dataset: str):
        """Get-or-materialize the streaming session for a catalog-
        registered tenant. A live session is returned as-is (with the
        debounced hot-reload poll applied); a cold tenant materializes
        its whole suite — session with document checks/policy/priority,
        row gate, admission quotas, anomaly watches — from the CURRENT
        document. Raises :class:`CatalogError` for unregistered tenants
        (the endpoint's 404 contract stays intact)."""
        session = self.service.get_session(tenant, dataset)
        if session is not None:
            self.on_fold_boundary(session)
            return session
        document = self.catalog.load(tenant)
        doc = document.doc
        session_kw = dict(doc.get("session") or {})
        gate = self._build_gate(doc)
        session = self.service.session(
            tenant, dataset, build_checks(tenant, doc),
            drift_policy=doc.get("drift_policy", "reject"),
            priority=build_priority(doc),
            row_gate=gate,
            **{
                k: session_kw[k] for k in (
                    "batch_size", "keep_results", "admission_block_s",
                    "deadline_s", "max_retries",
                ) if k in session_kw
            },
        )
        quota = build_quota(doc)
        if quota is not None:
            self.service.scheduler.set_quota(tenant, quota)
        watch_keys = self._register_watches(tenant, dataset, doc)
        now = time.monotonic()
        with self._lock:
            self._hot[(tenant, dataset)] = _HotTenant(
                version=document.version, last_seen=now, last_poll=now,
                watch_keys=watch_keys,
            )
        return session

    def _build_gate(self, doc: Dict[str, Any]):
        schema = build_row_gate_schema(doc)
        if schema is None:
            return None
        from ..ingest.rowgate import QuarantineSidecar, RowGate

        root = getattr(self.service, "state_root", None) or self.catalog.path
        return RowGate(
            schema,
            sidecar=QuarantineSidecar(str(root) + ".rowgate-quarantine"),
            metrics=self.service.metrics,
        )

    def _register_watches(
        self, tenant: str, dataset: str, doc: Dict[str, Any]
    ) -> Tuple[Tuple[str, str], ...]:
        """Materialize the document's anomaly watches on the service's
        fleet watch, grouped per strategy (one watch key per strategy so
        differently-parameterized strategies coexist)."""
        pairs = build_watches(doc)
        fleetwatch = getattr(self.service, "fleetwatch", None)
        if not pairs or fleetwatch is None:
            return ()
        from ..repository import InMemoryMetricsRepository

        keys = []
        for i, (analyzer, strategy) in enumerate(pairs):
            # dataset-qualified watch key: each declared watch gets its
            # own slot so re-registration replaces exactly itself
            wdataset = f"{dataset}#w{i}"
            fleetwatch.watch(
                tenant, InMemoryMetricsRepository(), [analyzer],
                strategy=strategy, dataset=wdataset,
            )
            keys.append((tenant, wdataset))
        return tuple(keys)

    # -- hot reload ----------------------------------------------------------

    def on_fold_boundary(self, session) -> None:
        """The fold-boundary hook (the ingest endpoint calls this per
        POST): touch the hot entry's idle clock and — debounced by
        ``poll_s`` — poll the document version, re-materializing the
        session's checks/policy/gate/quotas in place when it changed. A
        corrupt edit never reaches here as a new version: ``load`` serves
        last-good (same version, no reload) and the quarantine counter is
        the only trace."""
        key = (session.tenant, session.dataset)
        now = time.monotonic()
        with self._lock:
            hot = self._hot.get(key)
            if hot is None:
                hot = self._hot[key] = _HotTenant(
                    version=self.catalog.current_version(session.tenant),
                    last_seen=now, last_poll=now,
                )
                return
            hot.last_seen = now
            if self.poll_s and now - hot.last_poll < self.poll_s:
                return
            hot.last_poll = now
            known = hot.version
        if self.catalog.current_version(session.tenant) == known:
            return
        try:
            document = self.catalog.load(session.tenant)
        except CatalogError:
            return  # no servable version: keep running the live config
        if document.version == known:
            # the newer version(s) were corrupt: load already quarantined
            # them and served last-good — nothing to apply
            return
        doc = document.doc
        session.reconfigure(
            checks=build_checks(session.tenant, doc),
            drift_policy=doc.get("drift_policy", "reject"),
            priority=build_priority(doc),
            row_gate=self._build_gate(doc),
        )
        quota = build_quota(doc)
        if quota is not None:
            self.service.scheduler.set_quota(session.tenant, quota)
        else:
            self.service.scheduler.clear_quota(session.tenant)
        with self._lock:
            hot = self._hot.get(key)
            old_watch_keys = hot.watch_keys if hot is not None else ()
        fleetwatch = getattr(self.service, "fleetwatch", None)
        if fleetwatch is not None:
            for wtenant, wdataset in old_watch_keys:
                fleetwatch.unwatch(wtenant, wdataset)
        new_keys = self._register_watches(
            session.tenant, session.dataset, doc
        )
        with self._lock:
            hot = self._hot.get(key)
            if hot is not None:
                hot.version = document.version
                hot.watch_keys = new_keys
        self.service.metrics.inc(
            "deequ_service_catalog_reloads_total", tenant=session.tenant
        )
        from ..observability import trace as _trace

        _trace.add_event(
            "catalog_hot_reload", tenant=session.tenant,
            dataset=session.dataset, version=document.version,
        )

    # -- eviction ------------------------------------------------------------

    def sweep(self, now: Optional[float] = None) -> int:
        """Evict hot tenants idle past the TTL back to the cold tier:
        close the session (which flushes its cumulative states to the
        partition store — re-materialization adopts them), drop the watch
        state, clear the hot entry. Returns the evictions performed. The
        document stays registered: the next ingest re-materializes from
        it, which is the whole hot/cold contract (1M registered / 1k
        active costs 1k tenants)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            idle = [
                (key, hot) for key, hot in self._hot.items()
                if now - hot.last_seen >= self.hot_ttl_s
            ]
            for key, _hot in idle:
                del self._hot[key]
        fleetwatch = getattr(self.service, "fleetwatch", None)
        evicted = 0
        for (tenant, dataset), hot in idle:
            session = self.service.get_session(tenant, dataset)
            if session is not None:
                session.close()
            if fleetwatch is not None:
                for wtenant, wdataset in hot.watch_keys:
                    fleetwatch.unwatch(wtenant, wdataset)
            evicted += 1
            self.service.metrics.inc(
                "deequ_service_catalog_evictions_total", tenant=tenant
            )
        return evicted

    def hot_count(self) -> int:
        with self._lock:
            return len(self._hot)
