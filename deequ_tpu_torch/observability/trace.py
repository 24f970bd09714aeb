"""Dapper-style span tracing for the verification service.

Every layer of the stack already *counts* what happened (`RunMonitor`
fields, `ServiceMetrics` series) — but counters cannot answer "which job
failed over, why, and what did it cost?". This module adds the causal
layer (Sigelman et al., 2010): a thread-safe span tree with
``trace_id``/``span_id``/``parent_id``, monotonic timestamps and typed
events, threaded through *job submit -> scheduler admit/retry -> placement
decision -> engine pass -> bundle compile+dispatch -> batch fold -> state
fetch -> metric derivation -> constraint evaluation*, so a degraded run
reads as ONE connected tree instead of disjoint counter bumps.

Design constraints that shaped the implementation:

- **Default-on, near-zero overhead.** Tracing guards the hot per-batch
  phase timers, so span creation is a slot-object + two ``perf_counter_ns``
  reads that the timer already pays. ``DEEQU_TPU_TRACE=0`` disables
  everything (spans become a shared no-op singleton); a float in (0, 1)
  samples that fraction of root traces deterministically.
- **Explicit cross-thread propagation.** Python thread pools do not
  inherit context: every pool this codebase owns (scheduler workers,
  engine prefetch, host-tier partials, watchdog daemon threads) captures
  the submitting thread's span with :func:`capture` and re-enters it with
  :func:`attach` — a span started on a worker is still a child of the job
  that queued it.
- **No wall-clock in span math.** Timestamps are ``perf_counter_ns``
  (process-monotonic, shared across threads); one wall-clock anchor is
  recorded per process so exporters can map to absolute time without any
  span ever depending on a settable clock.

Spans are lightweight records, not RAII handles over locks: ``finish`` is
idempotent, events append under the GIL, and finished spans flow into the
process-global flight-recorder ring (`recorder.py`).
"""

from __future__ import annotations

import hashlib
import itertools
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

#: env var: "0" disables tracing entirely; a float in (0, 1] samples that
#: fraction of ROOT traces (children always follow their root's decision);
#: unset / "1" traces everything.
TRACE_ENV = "DEEQU_TPU_TRACE"

#: env var: capacity of the flight-recorder ring of finished spans
#: (default 4096; see recorder.py).
TRACE_RING_ENV = "DEEQU_TPU_TRACE_RING"

#: HTTP header / RPC field carrying a serialized trace context across
#: process boundaries (front -> worker hops, the Arrow ingest wire).
TRACE_HEADER = "X-Deequ-Trace"

#: the closed set of span ``kind`` literals; statlint's span-kind-registry
#: check reads this frozenset, so a new kind MUST be registered here before
#: any ``span(..., kind=...)`` call site can use it.
SPAN_KINDS = frozenset({
    "span", "phase", "job", "verification", "analysis", "engine",
    "ingest", "stall", "cluster", "tuning", "incremental", "fleetwatch",
    "coalesce", "rpc",
})

#: wall-clock anchor: epoch seconds at (approximately) perf-counter zero,
#: recorded once per process so exporters can place the monotonic span
#: timestamps on an absolute axis.
EPOCH_ANCHOR_S = time.time() - time.perf_counter()


#: warn-once latch for an unparseable DEEQU_TPU_TRACE value
_ENV_WARNED = False


def sample_rate() -> float:
    raw = os.environ.get(TRACE_ENV)
    if raw is None or raw == "":
        return 1.0
    try:
        value = float(raw)
    except ValueError:
        # an operator who set "off"/"false" believes tracing is disabled —
        # we cannot guess intent, but silently ignoring the knob is worse:
        # warn once (the watchdog's unparseable-env convention) and keep
        # the default (tracing on)
        global _ENV_WARNED
        if not _ENV_WARNED:
            _ENV_WARNED = True
            import logging

            logging.getLogger(__name__).warning(
                "ignoring unparseable %s=%r (expected 0, 1, or a sample "
                "fraction in (0, 1)); tracing stays at the default (on)",
                TRACE_ENV, raw,
            )
        return 1.0
    return min(max(value, 0.0), 1.0)


def enabled() -> bool:
    return sample_rate() > 0.0


_IDS = itertools.count(1)
_PID = os.getpid()

_TLS = threading.local()


def _stack() -> List["Span"]:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = []
        _TLS.stack = stack
    return stack


class Span:
    """One timed node of a trace tree. Mutable only through ``set_attr`` /
    ``add_event`` / ``finish``; ``finish`` is idempotent and publishes the
    span to the flight-recorder ring exactly once."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "kind",
        "start_ns", "end_ns", "status", "thread", "attrs", "events",
        "_finished",
    )

    def __init__(
        self,
        name: str,
        kind: str,
        trace_id: str,
        span_id: str,
        parent_id: Optional[str],
        start_ns: Optional[int] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self.name = name
        self.kind = kind
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_ns = (
            start_ns if start_ns is not None else time.perf_counter_ns()
        )
        self.end_ns: Optional[int] = None
        self.status = "ok"
        self.thread = threading.get_ident()
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.events: List[Dict[str, Any]] = []
        self._finished = False

    @property
    def sampled(self) -> bool:
        return True

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def add_event(self, name: str, **attrs: Any) -> None:
        # list.append is GIL-atomic; events may arrive from threads other
        # than the span's own (the scheduler annotates a job span while a
        # worker executes it)
        self.events.append(
            {"name": name, "ts_ns": time.perf_counter_ns(), "attrs": attrs}
        )

    def finish(self, status: Optional[str] = None, end_ns: Optional[int] = None) -> None:
        if self._finished:
            return
        self._finished = True
        self.end_ns = end_ns if end_ns is not None else time.perf_counter_ns()
        if status is not None:
            self.status = status
        # import by submodule path: the package __init__ rebinds the name
        # "recorder" to the accessor function, so `from . import recorder`
        # would resolve to the function, not the module
        from .recorder import recorder as _get_recorder

        _get_recorder().on_span_finish(self)

    def duration_s(self) -> float:
        end = self.end_ns if self.end_ns is not None else time.perf_counter_ns()
        return (end - self.start_ns) / 1e9

    def to_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "kind": self.kind,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
            "status": self.status,
            "thread": self.thread,
            "attrs": self.attrs,
            "events": self.events,
        }

    def __repr__(self) -> str:  # debugging aid only
        return (
            f"Span({self.name!r}, trace={self.trace_id}, span={self.span_id}, "
            f"parent={self.parent_id}, status={self.status})"
        )


class _NullSpan:
    """Shared no-op span: returned when tracing is disabled or the root
    trace was sampled out. Attaching it SUPPRESSES descendants (a child of
    an unsampled trace must not start a fresh trace of its own)."""

    __slots__ = ()
    trace_id = None
    span_id = None
    parent_id = None
    name = "null"
    kind = "null"
    status = "ok"
    attrs: Dict[str, Any] = {}
    events: List[Dict[str, Any]] = []
    sampled = False

    def set_attr(self, key: str, value: Any) -> None:
        pass

    def add_event(self, name: str, **attrs: Any) -> None:
        pass

    def finish(self, status: Optional[str] = None, end_ns: Optional[int] = None) -> None:
        pass

    def duration_s(self) -> float:
        return 0.0


NULL = _NullSpan()


def _next_trace_id() -> str:
    return f"t{_PID:x}-{next(_IDS):x}"


def _next_span_id() -> str:
    return f"s{_PID:x}-{next(_IDS):x}"


def sampled_trace(trace_id: str, rate: Optional[float] = None) -> bool:
    """The fractional sampler: a pure function of the trace_id, so EVERY
    process holding the same id reaches the same verdict — a sampled trace
    keeps all its spans across the cluster, an unsampled one keeps none
    (no RNG, no per-process counter: cross-host propagation demands the
    decision travel with the id itself)."""
    if rate is None:
        rate = sample_rate()
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    digest = hashlib.sha256(trace_id.encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big") / 2.0 ** 64 < rate


def _top():
    stack = _stack()
    return stack[-1] if stack else None


def current_span() -> Optional[Span]:
    """The innermost REAL span on this thread (None when untraced)."""
    top = _top()
    return top if isinstance(top, Span) else None


def capture():
    """The raw current context for cross-thread propagation: a Span, the
    NULL suppressor, or None. Hand the result to :func:`attach` inside the
    worker-thread body."""
    return _top()


def start_span(
    name: str,
    kind: str = "span",
    attrs: Optional[Dict[str, Any]] = None,
    parent: Any = "auto",
) -> Any:
    """Start (but do not attach) a span. ``parent="auto"`` inherits the
    calling thread's current context; pass an explicit Span to parent it
    elsewhere, or None to force a new root trace. Returns :data:`NULL`
    when tracing is off, the root was sampled out, or the inherited
    context is suppressed."""
    if parent == "auto":
        parent = _top()
    if parent is NULL or isinstance(parent, _NullSpan):
        return NULL
    if parent is None:
        trace_id = _next_trace_id()
        if not sampled_trace(trace_id):
            return NULL
        return Span(
            name, kind, trace_id=trace_id, span_id=_next_span_id(),
            parent_id=None, attrs=attrs,
        )
    return Span(
        name, kind, trace_id=parent.trace_id, span_id=_next_span_id(),
        parent_id=parent.span_id, attrs=attrs,
    )


@contextmanager
def span(name: str, kind: str = "span", **attrs: Any):
    """Start a child of the current context, attach it for the block, and
    finish it on exit (status "error" + exception attr if the block
    raises)."""
    sp = start_span(name, kind=kind, attrs=attrs)
    stack = _stack()
    stack.append(sp)
    try:
        yield sp
    except BaseException as exc:
        if sp is not NULL:
            sp.set_attr("error", f"{type(exc).__name__}: {exc}")
            sp.finish("error")
        raise
    else:
        sp.finish()
    finally:
        stack.pop()


@contextmanager
def attach(sp) -> Any:
    """Re-enter a captured context on THIS thread (worker pools, daemon
    threads). ``attach(None)`` is a no-op — the thread keeps whatever
    context it already has; attaching :data:`NULL` suppresses descendant
    spans (the unsampled-trace contract)."""
    if sp is None:
        yield None
        return
    stack = _stack()
    stack.append(sp)
    try:
        yield sp
    finally:
        stack.pop()


def add_event(name: str, span: Optional[Any] = None, **attrs: Any) -> None:
    """Append a typed event to ``span`` (default: the current span); no-op
    when untraced."""
    target = span if span is not None else _top()
    if target is None:
        return
    target.add_event(name, **attrs)


class TraceContext:
    """The wire form of a span's identity: just enough of a remote parent
    (``trace_id`` + parent ``span_id`` + the sampling verdict) for
    :func:`start_span` to hang a child under a trace that began in another
    process. Produced by :func:`extract`, serialized by :func:`inject`."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    def to_header(self) -> str:
        return f"{self.trace_id};{self.span_id};{1 if self.sampled else 0}"

    def __repr__(self) -> str:  # debugging aid only
        return f"TraceContext({self.to_header()!r})"


def inject(span: Any = None) -> Optional[str]:
    """Serialize the current context (or ``span``) for the
    :data:`TRACE_HEADER` wire field. Three shapes, matching
    :func:`extract`'s three verdicts: a live span yields
    ``trace_id;span_id;1``; a suppressed (unsampled) context yields
    ``;;0`` so the remote side suppresses too instead of starting a fresh
    root for half a trace; no context at all yields ``None`` (send no
    header — the remote side makes its own root decision)."""
    target = span if span is not None else _top()
    if target is None:
        return None
    if target is NULL or isinstance(target, _NullSpan):
        return ";;0"
    return f"{target.trace_id};{target.span_id};1"


def extract(header: Optional[str]) -> Any:
    """Parse a :data:`TRACE_HEADER` value into something usable as the
    ``parent=`` argument of :func:`start_span`: a :class:`TraceContext`
    (sampled remote parent), :data:`NULL` (the remote root was sampled out
    — suppress descendants here too), or ``None`` (no/unparseable header —
    start a fresh root). Malformed values degrade to ``None`` rather than
    raising: a bad header must never fail the request it rode in on."""
    if not header:
        return None
    parts = str(header).split(";")
    if len(parts) != 3:
        return None
    trace_id, span_id, flag = (p.strip() for p in parts)
    if flag == "0":
        return NULL
    if flag != "1" or not trace_id or not span_id:
        return None
    return TraceContext(trace_id, span_id, sampled=True)


def record_phase(phase: str, start_ns: int, end_ns: int) -> None:
    """Publish one already-measured phase interval as a finished child span
    of the current context. This is the hot-path entry the engine's
    ``RunMonitor.timed`` phase timers call: the timestamps are the timer's
    own, so ``phase_seconds`` numbers and span durations can never
    disagree, and an untraced thread pays a single attribute read."""
    parent = _top()
    if not isinstance(parent, Span):
        return
    sp = Span(
        phase, "phase", trace_id=parent.trace_id, span_id=_next_span_id(),
        parent_id=parent.span_id, start_ns=start_ns,
    )
    sp.finish(end_ns=end_ns)
