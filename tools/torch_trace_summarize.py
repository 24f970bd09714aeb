"""Summarize a trace artifact: critical path, top self-time spans,
degradation events.

Reads either a Chrome trace-event JSON (the ``/trace`` endpoint /
``bench.py`` per-stage artifacts) or a span JSONL journal (flight-recorder
dumps, ``/trace.jsonl``), rebuilds the span tree from the embedded
``span_id``/``parent_id`` refs, and prints the three things a post-mortem
opens with:

1. **Critical path** — from the longest root, the chain of child spans
   that dominates wall time (the "why was this run slow" answer);
2. **Top 5 spans by SELF time** — duration minus direct children, so a
   parent that merely waits on its children doesn't crowd out the phase
   actually burning the time;
3. **Degradation events** — every typed failure/failover/stall/drift/
   quarantine event in the artifact, in timestamp order (the "what went
   wrong, in what order" answer).

It also reports **span accounting**: root vs ORPHANED span counts (spans
whose ``parent_id`` names a span missing from the artifact). Orphans are
still summarized as effective roots, but a non-zero orphan count on a
merged multi-host artifact is the tell of a propagation regression — a
hop that dropped its trace context instead of carrying it.

Usage: ``python -m tools.torch_trace_summarize ARTIFACT... [--top N]``.
Each ARTIFACT may be a Chrome trace JSON, a span JSONL file, or a
DIRECTORY of per-host ``spans-*.jsonl`` journals (merged onto one
timeline via :func:`deequ_tpu_torch.observability.export.merge_journals`).
``tools/torch_chaos_soak.py`` runs this on the trace artifact every soak
leaves behind, so a chaos drill always ends with a readable incident
summary. This is the PyTorch/CUDA port's copy of ``tools/trace_summarize.py``:
it reads the port's artifacts, whose format is the reference's.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Any, Dict, Iterable, List, Optional, Union

#: event names that mark a degradation (kept in sync with the emitting
#: sites in reliability/, service/ and the flight recorder)
DEGRADATION_EVENTS = frozenset(
    {
        "failure", "device_failover", "oom_bisect", "isolation_bisect",
        "analyzers_degraded", "scan_stall", "drift_degraded",
        "drift_repaired", "checkpoint_discarded", "repository_quarantined",
        "retry", "queued_past_deadline", "completed_late",
    }
)


def load_spans(path: str) -> List[Dict[str, Any]]:
    """Span dicts (trace.Span.to_dict shape) from any artifact format.
    A directory is a journal dir: every ``spans-*.jsonl`` inside is merged
    onto one rebased timeline first (cross-host clock skew matters for the
    degradation ordering). Both file formats open with "{", so detection
    parses: a single JSON document carrying ``traceEvents`` is a Chrome
    artifact; anything else is treated as one-record-per-line JSONL
    (journal or flight dump)."""
    if os.path.isdir(path):
        from deequ_tpu_torch.observability.export import merge_journals

        journals = sorted(glob.glob(os.path.join(path, "spans-*.jsonl")))
        if not journals:
            return []
        return _spans_from_chrome(merge_journals(journals))
    with open(path) as fh:
        text = fh.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None
    if isinstance(doc, dict) and "traceEvents" in doc:
        return _spans_from_chrome(doc)
    spans = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        record = json.loads(line)
        if record.get("flight_record"):
            continue  # dump header line
        spans.append(record)
    return spans


def _spans_from_chrome(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    spans: Dict[str, Dict[str, Any]] = {}
    pending_events: List[Dict[str, Any]] = []
    for ev in doc.get("traceEvents", ()):
        args = ev.get("args") or {}
        if ev.get("ph") == "X":
            span_id = args.get("span_id") or f"anon-{len(spans)}"
            attrs = {
                k: v for k, v in args.items()
                if k not in ("trace_id", "span_id", "parent_id", "status")
            }
            spans[span_id] = {
                "trace_id": args.get("trace_id"),
                "span_id": span_id,
                "parent_id": args.get("parent_id"),
                "name": ev.get("name", "?"),
                "kind": ev.get("cat", "span"),
                "start_ns": int(ev.get("ts", 0) * 1e3),
                "end_ns": int((ev.get("ts", 0) + ev.get("dur", 0)) * 1e3),
                "status": args.get("status", "ok"),
                "thread": ev.get("tid", 0),
                "attrs": attrs,
                "events": [],
            }
        elif ev.get("ph") == "i":
            pending_events.append(ev)
    for ev in pending_events:
        args = dict(ev.get("args") or {})
        owner = spans.get(args.pop("span_id", None))
        args.pop("trace_id", None)
        record = {
            "name": ev.get("name", "?"),
            "ts_ns": int(ev.get("ts", 0) * 1e3),
            "attrs": args,
        }
        if owner is not None:
            owner["events"].append(record)
        else:  # orphan instant event: synthesize a zero-length holder
            spans[f"orphan-{len(spans)}"] = {
                "trace_id": None, "span_id": f"orphan-{len(spans)}",
                "parent_id": None, "name": "(orphan events)",
                "kind": "event", "start_ns": record["ts_ns"],
                "end_ns": record["ts_ns"], "status": "ok", "thread": 0,
                "attrs": {}, "events": [record],
            }
    return list(spans.values())


def _dur_ns(span: Dict[str, Any]) -> int:
    end = span.get("end_ns")
    return max((end if end is not None else span["start_ns"]) - span["start_ns"], 0)


def _children_index(spans: List[Dict[str, Any]]) -> Dict[Optional[str], List[Dict[str, Any]]]:
    children: Dict[Optional[str], List[Dict[str, Any]]] = {}
    ids = {s["span_id"] for s in spans}
    for s in spans:
        parent = s.get("parent_id")
        # a parent outside the artifact (ring-evicted) makes this span an
        # effective root rather than an orphan
        key = parent if parent in ids else None
        children.setdefault(key, []).append(s)
    for group in children.values():
        group.sort(key=lambda s: s["start_ns"])
    return children


def critical_path(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The longest root, then greedily its longest child, recursively."""
    if not spans:
        return []
    children = _children_index(spans)
    roots = children.get(None, [])
    if not roots:
        return []
    path = [max(roots, key=_dur_ns)]
    while True:
        kids = children.get(path[-1]["span_id"], [])
        if not kids:
            return path
        path.append(max(kids, key=_dur_ns))


def self_times(spans: List[Dict[str, Any]]) -> List[tuple]:
    """(self_seconds, span) pairs, descending: duration minus direct
    children's durations (floored at 0 for overlapping children)."""
    children = _children_index(spans)
    out = []
    for s in spans:
        child_ns = sum(_dur_ns(c) for c in children.get(s["span_id"], ()))
        out.append((max(_dur_ns(s) - child_ns, 0) / 1e9, s))
    out.sort(key=lambda pair: -pair[0])
    return out


def span_accounting(spans: List[Dict[str, Any]]) -> Dict[str, int]:
    """Root / orphan / trace-id counts. An ORPHAN names a parent span the
    artifact doesn't contain — expected for a ring-evicted parent on one
    host, but on a merged multi-host artifact a systematic orphan count
    means a hop dropped its trace context (a propagation regression the
    tree rendering alone would hide, since orphans still render as
    roots)."""
    ids = {s["span_id"] for s in spans}
    roots = sum(1 for s in spans if s.get("parent_id") is None)
    orphans = sum(
        1 for s in spans
        if s.get("parent_id") is not None and s["parent_id"] not in ids
    )
    traces = {s.get("trace_id") for s in spans if s.get("trace_id")}
    return {
        "total": len(spans),
        "roots": roots,
        "orphans": orphans,
        "trace_ids": len(traces),
    }


def degradations(spans: List[Dict[str, Any]]) -> List[tuple]:
    """(ts_ns, owning span, event) for every degradation event, in order."""
    out = []
    for s in spans:
        for ev in s.get("events", ()):
            if ev.get("name") in DEGRADATION_EVENTS:
                out.append((ev.get("ts_ns", 0), s, ev))
    out.sort(key=lambda item: item[0])
    return out


def summarize(path: Union[str, Iterable[str]], top: int = 5) -> str:
    paths = [path] if isinstance(path, str) else list(path)
    spans: List[Dict[str, Any]] = []
    for p in paths:
        spans.extend(load_spans(p))
    lines = [f"trace summary: {', '.join(paths)} ({len(spans)} spans)"]
    if not spans:
        return "\n".join(lines + ["  (empty artifact)"])
    t0 = min(s["start_ns"] for s in spans)

    acct = span_accounting(spans)
    lines.append(
        f"span accounting: {acct['total']} spans, {acct['roots']} roots, "
        f"{acct['orphans']} orphaned (parent not in artifact), "
        f"{acct['trace_ids']} distinct trace_ids"
    )
    if acct["orphans"]:
        lines.append(
            "  WARNING: orphaned spans — a hop dropped its trace context "
            "or the parent was ring-evicted"
        )

    lines.append("critical path:")
    for depth, s in enumerate(critical_path(spans)):
        lines.append(
            f"  {'  ' * depth}{s['name']} [{s.get('kind', 'span')}] "
            f"{_dur_ns(s) / 1e9:.3f}s (status={s.get('status', 'ok')})"
        )

    lines.append(f"top {top} spans by self-time:")
    for self_s, s in self_times(spans)[:top]:
        lines.append(
            f"  {self_s:8.3f}s  {s['name']} [{s.get('kind', 'span')}] "
            f"trace={s.get('trace_id')}"
        )

    degrade = degradations(spans)
    lines.append(f"degradation events ({len(degrade)}):")
    if not degrade:
        lines.append("  (none — clean run)")
    for ts_ns, s, ev in degrade:
        attrs = ev.get("attrs") or {}
        detail = ", ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
        lines.append(
            f"  +{(ts_ns - t0) / 1e9:8.3f}s  {ev['name']} "
            f"(in {s['name']}) {detail}"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "artifact", nargs="+",
        help="Chrome trace JSON, span JSONL, or a journal directory",
    )
    parser.add_argument("--top", type=int, default=5)
    args = parser.parse_args(argv)
    print(summarize(args.artifact, top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
