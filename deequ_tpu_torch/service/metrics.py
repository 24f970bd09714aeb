"""The export plane: service observability for an operator.

`ServiceMetrics` aggregates what the per-run :class:`RunMonitor` phase
timers already measure (`runners/engine.py`) with scheduler-level counters
(queue depth, retries, sheds, timeouts) and placement-cache hit rates, and
renders them as either a Prometheus text exposition or a JSON snapshot.
`MetricsExporter` serves both over HTTP from a background thread — the
subsystem the one-shot CLI mode never needed and a long-lived service
cannot run without.
"""

from __future__ import annotations

import json
import threading
from bisect import bisect_left
from typing import Any, Callable, Dict, List, Optional, Tuple

_LabelKey = Tuple[str, Tuple[Tuple[str, str], ...]]

#: fixed pow2 bucket edges (seconds) shared by EVERY histogram family:
#: 2^-20 s (~0.95 µs) .. 2^6 s (64 s), 27 finite buckets + the +Inf
#: overflow slot. FIXED edges are the whole design: two snapshots of the
#: same family — from two scrapes, two tenants, or two HOSTS — merge by
#: plain vector add (the same algebra as the sketch states), which is what
#: makes per-host histograms aggregable into fleet-level quantiles.
HISTOGRAM_EDGES: Tuple[float, ...] = tuple(2.0 ** e for e in range(-20, 7))


class _HistCell:
    """One (family, label set) histogram: bucket counts + sum + count."""

    __slots__ = ("counts", "sum", "count")

    def __init__(self) -> None:
        self.counts = [0] * (len(HISTOGRAM_EDGES) + 1)
        self.sum = 0.0
        self.count = 0

    def state(self) -> Dict[str, Any]:
        return {"counts": list(self.counts), "sum": self.sum,
                "count": self.count}


def merge_histogram_states(*states: Dict[str, Any]) -> Dict[str, Any]:
    """Vector-add histogram states (the mergeable-bucket algebra). All
    states share :data:`HISTOGRAM_EDGES`, so the merge is associative and
    commutative — fold per-host snapshots in any order."""
    counts = [0] * (len(HISTOGRAM_EDGES) + 1)
    total_sum = 0.0
    total_count = 0
    for state in states:
        for i, c in enumerate(state["counts"]):
            counts[i] += c
        total_sum += state["sum"]
        total_count += state["count"]
    return {"counts": counts, "sum": total_sum, "count": total_count}


def histogram_quantile(state: Dict[str, Any], q: float) -> Optional[float]:
    """Upper-edge quantile estimate from bucket counts (what a scraper
    computes from the ``_bucket`` lines): the smallest bucket edge whose
    cumulative count covers ``q`` of the observations. ``None`` for an
    empty histogram; ``inf`` when the quantile lands in the overflow
    bucket."""
    total = state["count"]
    if total <= 0:
        return None
    target = max(q, 0.0) * total
    cumulative = 0
    for i, c in enumerate(state["counts"]):
        cumulative += c
        if cumulative >= target and cumulative > 0:
            if i < len(HISTOGRAM_EDGES):
                return HISTOGRAM_EDGES[i]
            return float("inf")
    return float("inf")


def _labels_key(name: str, labels: Dict[str, str]) -> _LabelKey:
    return name, tuple(sorted(labels.items()))


def _escape_snapshot_value(value: str) -> str:
    """JSON-snapshot series keys join labels with ','/'='; escape those in
    the value so distinct label sets cannot collide on one key."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace(",", "\\,")
        .replace("=", "\\=")
    )


def _escape_label_value(value: str) -> str:
    """Prometheus text-format label escaping: one odd tenant name must not
    poison the whole exposition (scrapers reject the entire payload)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _escape_help(text: str) -> str:
    """Prometheus HELP-line escaping (backslash and newline only)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _render_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in labels)
    return "{" + inner + "}"


class ServiceMetrics:
    """Thread-safe counter/gauge registry with Prometheus + JSON export.

    Counters are monotonic floats keyed by (name, sorted label items);
    gauges are CALLABLES evaluated at export time, so queue depth and
    session counts are always live rather than sampled. Phase timings
    accumulate under ``deequ_service_phase_seconds_total{phase=...}``
    straight from each job's ``RunMonitor.phase_seconds``.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[_LabelKey, float] = {}
        self._gauges: Dict[_LabelKey, Callable[[], float]] = {}
        self._histograms: Dict[_LabelKey, _HistCell] = {}
        self._help: Dict[str, str] = {}
        self.describe(
            "deequ_service_export_errors_total",
            "Gauge callables that raised during an exposition; the series "
            "was skipped so the rest of the scrape kept serving.",
        )
        self.describe(
            "deequ_service_phase_seconds_total",
            "Engine phase wall-clock accumulated across runs, by phase "
            "(straight from each job's RunMonitor.phase_seconds).",
        )

    # -- registration / update ----------------------------------------------

    def describe(self, name: str, help_text: str) -> None:
        with self._lock:
            self._help[name] = help_text

    def inc(self, name: str, value: float = 1.0, **labels: str) -> None:
        key = _labels_key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def inc_many(self, updates) -> None:
        """Batched counter increments under ONE lock round-trip.
        ``updates``: iterable of ``(name, value, labels_dict)``. The
        scheduler's per-job harvest and the streaming commit path bump up
        to a dozen series per fold; at thousands of folds per second the
        per-``inc`` lock traffic was measurable (the streaming-knee
        scheduler diet)."""
        with self._lock:
            counters = self._counters
            for name, value, labels in updates:
                key = _labels_key(name, labels)
                counters[key] = counters.get(key, 0.0) + value

    def counter_value(self, name: str, **labels: str) -> float:
        """Current value of one counter series (0.0 when never touched)."""
        with self._lock:
            if labels:
                return self._counters.get(_labels_key(name, labels), 0.0)
            return sum(v for (n, _), v in self._counters.items() if n == name)

    def set_gauge_fn(
        self, name: str, fn: Callable[[], float],
        help_text: Optional[str] = None, **labels: str,
    ) -> None:
        with self._lock:
            self._gauges[_labels_key(name, labels)] = fn
            if help_text:
                self._help[name] = help_text

    # -- histograms ----------------------------------------------------------

    def describe_histogram(self, name: str, help_text: str) -> None:
        """Register a histogram family's HELP text. Every family MUST be
        described (the export-HELP statlint check enforces it, exactly as
        for counters)."""
        with self._lock:
            self._help[name] = help_text

    def observe(self, name: str, value: float, **labels: str) -> None:
        """Record one observation (seconds) into the family's pow2
        buckets. NaN observations are dropped — they cannot be bucketed
        and would poison ``_sum``."""
        if value != value:  # NaN
            return
        key = _labels_key(name, labels)
        idx = bisect_left(HISTOGRAM_EDGES, value)
        with self._lock:
            cell = self._histograms.get(key)
            if cell is None:
                cell = self._histograms[key] = _HistCell()
            cell.counts[idx] += 1
            cell.sum += value
            cell.count += 1

    def histogram_state(
        self, name: str, **labels: str
    ) -> Optional[Dict[str, Any]]:
        """Snapshot of ONE (family, label set) cell, or None if never
        observed."""
        with self._lock:
            cell = self._histograms.get(_labels_key(name, labels))
            return cell.state() if cell is not None else None

    def histogram_cells(
        self, name: str
    ) -> List[Tuple[Tuple[Tuple[str, str], ...], Dict[str, Any]]]:
        """All (label items, state) cells of a family — the input to
        cross-label merges (fleet quantiles, SLO achieved fractions)."""
        with self._lock:
            return [
                (labels, cell.state())
                for (n, labels), cell in sorted(self._histograms.items())
                if n == name
            ]

    def histogram_merged(self, name: str, **labels: str) -> Dict[str, Any]:
        """Merge every cell of a family whose labels contain ``labels`` as
        a subset (no filter = the whole family) — vector-add algebra."""
        wanted = set(labels.items())
        states = [
            state for cell_labels, state in self.histogram_cells(name)
            if wanted.issubset(set(cell_labels))
        ]
        return merge_histogram_states(*states)

    # -- export --------------------------------------------------------------

    def _eval_gauges(self) -> Dict[str, float]:
        """Evaluate every registered gauge. A RAISING gauge must not kill
        the whole exposition: its series is SKIPPED for this scrape (a NaN
        placeholder would poison recording rules; absence is the honest
        signal) and the failure is counted under
        ``deequ_service_export_errors_total{gauge=...}`` so the breakage
        itself is monitorable."""
        out: Dict[_LabelKey, float] = {}
        with self._lock:  # snapshot: a scrape must not race set_gauge_fn
            gauges = list(self._gauges.items())
        failed = []
        for key, fn in gauges:
            try:
                out[key] = float(fn())
            except Exception:  # noqa: BLE001 - skip, count, keep serving
                failed.append(key[0])
        for name in failed:
            self.inc("deequ_service_export_errors_total", gauge=name)
        return out

    def json_snapshot(self) -> Dict[str, Any]:
        """One JSON-able dict of everything the plane knows right now.
        Non-finite gauge readings (a dead gauge) become ``None`` — a bare
        NaN token would make the whole payload unparseable to strict JSON
        parsers."""
        import math
        # evaluate gauges BEFORE snapshotting counters: a raising gauge
        # increments the export-error counter, and this snapshot should
        # already show that increment (mirrors prometheus_text)
        gauge_values = self._eval_gauges()
        with self._lock:
            counters = dict(self._counters)
            hists = {
                key: cell.state() for key, cell in self._histograms.items()
            }

        def label_join(labels) -> str:
            # escape the joiners so arbitrary caller strings (tenant
            # names) cannot produce ambiguous or colliding series keys
            return ",".join(
                f"{k}={_escape_snapshot_value(v)}" for k, v in labels
            )

        series: Dict[str, Any] = {}
        for (name, labels), value in sorted(counters.items()):
            if labels:
                series.setdefault(name, {})[label_join(labels)] = value
            else:
                series[name] = value
        gauges: Dict[str, Any] = {}
        for (name, labels), value in sorted(gauge_values.items()):
            clean = value if math.isfinite(value) else None
            if labels:
                # labeled gauges nest like labeled counters; UNLABELED
                # ones keep the flat name -> value shape callers rely on
                gauges.setdefault(name, {})[label_join(labels)] = clean
            else:
                gauges[name] = clean
        histograms: Dict[str, Any] = {}
        for (name, labels), state in sorted(hists.items()):
            histograms.setdefault(name, {})[label_join(labels)] = state
        return {"counters": series, "gauges": gauges,
                "histograms": histograms}

    def json_text(self) -> str:
        return json.dumps(self.json_snapshot(), sort_keys=True)

    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4. EVERY series gets its
        ``# HELP`` and ``# TYPE`` lines — scrapers and ``promtool check
        metrics`` expect them; an undescribed series gets a generated
        placeholder rather than a bare sample."""
        # evaluate gauges FIRST: a raising gauge increments the export-error
        # counter, and this scrape should already show that increment
        gauges = self._eval_gauges()
        with self._lock:
            counters = dict(self._counters)
            help_texts = dict(self._help)
            hists = {
                key: cell.state() for key, cell in self._histograms.items()
            }

        def help_line(name: str) -> str:
            text = help_texts.get(name, f"{name} (no description registered).")
            return f"# HELP {name} {_escape_help(text)}"

        lines = []
        seen_header = set()
        for (name, labels), value in sorted(counters.items()):
            if name not in seen_header:
                seen_header.add(name)
                lines.append(help_line(name))
                lines.append(f"# TYPE {name} counter")
            lines.append(f"{name}{_render_labels(labels)} {_format(value)}")
        for (name, labels), value in sorted(gauges.items()):
            if name not in seen_header:
                seen_header.add(name)
                lines.append(help_line(name))
                lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name}{_render_labels(labels)} {_format(value)}")
        for (name, labels), state in sorted(hists.items()):
            if name not in seen_header:
                seen_header.add(name)
                lines.append(help_line(name))
                lines.append(f"# TYPE {name} histogram")
            # Prometheus histogram convention: CUMULATIVE le buckets
            # (every bucket includes all smaller ones, +Inf == _count),
            # then the _sum/_count pair
            cumulative = 0
            for i, edge in enumerate(HISTOGRAM_EDGES):
                cumulative += state["counts"][i]
                bucket_labels = labels + (("le", _format(edge)),)
                lines.append(
                    f"{name}_bucket{_render_labels(bucket_labels)} "
                    f"{cumulative}"
                )
            cumulative += state["counts"][-1]
            inf_labels = labels + (("le", "+Inf"),)
            lines.append(
                f"{name}_bucket{_render_labels(inf_labels)} {cumulative}"
            )
            lines.append(
                f"{name}_sum{_render_labels(labels)} {_format(state['sum'])}"
            )
            lines.append(
                f"{name}_count{_render_labels(labels)} {state['count']}"
            )
        return "\n".join(lines) + "\n"


def _format(value: float) -> str:
    if value != value:  # NaN
        return "NaN"
    if value == float("inf"):
        return "+Inf"  # int(inf) raises; Prometheus accepts the literal
    if value == float("-inf"):
        return "-Inf"
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(value)


class MetricsExporter:
    """Serves ``/metrics`` (Prometheus text), ``/metrics.json`` and the
    trace plane — ``/trace`` (Chrome trace-event / Perfetto-loadable JSON
    of the flight-recorder ring) and ``/trace.jsonl`` (the span journal) —
    from a daemon thread. Binds to an ephemeral port by default
    (``port=0``); the bound port is on ``.port``. The reference's
    ``/statusz`` and Arrow IPC ingest routes are not ported (ROADMAP A6)."""

    def __init__(
        self,
        metrics: ServiceMetrics,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        plane = metrics

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
                if self.path.startswith("/metrics.json"):
                    body = plane.json_text().encode()
                    ctype = "application/json"
                elif self.path.startswith("/metrics"):
                    body = plane.prometheus_text().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path.startswith("/trace.jsonl"):
                    from ..observability import export as _obs_export

                    body = _obs_export.spans_to_jsonl().encode()
                    ctype = "application/jsonl"
                elif self.path.startswith("/trace"):
                    from ..observability import export as _obs_export

                    body = _obs_export.chrome_trace_text().encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            timeout = 30

            def log_message(self, *args):  # quiet: the plane IS the log
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="deequ-metrics-exporter",
            daemon=True,
        )
        self._thread.start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
