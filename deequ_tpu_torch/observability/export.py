"""Trace exporters: Chrome trace-event JSON (Perfetto-loadable) + JSONL.

The Chrome trace-event format is the lowest-common-denominator viewer
contract (``chrome://tracing``, Perfetto, speedscope all read it): one
``traceEvents`` list of complete-duration events (``"ph": "X"``) with
microsecond timestamps, plus instant events (``"ph": "i"``) for the typed
span events (failovers, stalls, drift rejections). Span identity rides in
``args`` (``trace_id``/``span_id``/``parent_id``) so tooling — including
``tools/trace_summarize.py`` — can rebuild the tree from the artifact
alone. The JSONL journal is the lossless form: one span dict per line,
exactly what the flight recorder dumps.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Optional


def _span_dict(span: Any) -> Dict[str, Any]:
    return span if isinstance(span, dict) else span.to_dict()


def _chrome_events(
    span_dicts: Iterable[Dict[str, Any]],
    pid: int,
    offset_ns: float = 0.0,
    extra_args: Optional[Dict[str, Any]] = None,
) -> List[Dict[str, Any]]:
    """Convert span dicts to Chrome events under one ``pid`` track, with
    an optional monotonic-clock offset (journal merging rebases each
    process's perf-counter axis onto a shared one)."""
    events: List[Dict[str, Any]] = []
    for d in span_dicts:
        start_ns = d["start_ns"]
        end_ns = d["end_ns"] if d["end_ns"] is not None else start_ns
        args = dict(d.get("attrs") or {})
        if extra_args:
            args.update(extra_args)
        args.update(
            trace_id=d["trace_id"], span_id=d["span_id"],
            parent_id=d["parent_id"], status=d.get("status", "ok"),
        )
        events.append(
            {
                "name": d["name"],
                "cat": d.get("kind", "span"),
                "ph": "X",
                "ts": (start_ns + offset_ns) / 1e3,
                "dur": max(end_ns - start_ns, 0) / 1e3,
                "pid": pid,
                "tid": d.get("thread", 0),
                "args": args,
            }
        )
        for ev in d.get("events", ()):
            ev_args = dict(ev.get("attrs") or {})
            ev_args.update(trace_id=d["trace_id"], span_id=d["span_id"])
            events.append(
                {
                    "name": ev["name"],
                    "cat": "event",
                    "ph": "i",
                    "s": "t",
                    "ts": (ev["ts_ns"] + offset_ns) / 1e3,
                    "pid": pid,
                    "tid": d.get("thread", 0),
                    "args": ev_args,
                }
            )
    return events


def spans_to_chrome(spans: Iterable[Any]) -> Dict[str, Any]:
    """Chrome trace-event JSON object for ``spans`` (Span objects or their
    dicts). Timestamps convert ns -> µs; unfinished spans export with zero
    duration rather than being dropped (a crash artifact should still show
    what was in flight)."""
    events = _chrome_events((_span_dict(s) for s in spans), pid=os.getpid())
    from .trace import EPOCH_ANCHOR_S

    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        # ts values are process-monotonic µs (perf_counter); the anchor
        # maps them to wall clock for log/Prometheus correlation:
        # absolute seconds ~= epoch_anchor_s + ts / 1e6
        "otherData": {"epoch_anchor_s": EPOCH_ANCHOR_S},
    }


def load_journal(path: str):
    """Read one span-journal JSONL file. Returns ``(header, spans,
    skipped)``: the ``journal_header`` record (or None for headerless /
    flight-dump files), the span dicts in file order, and the count of
    lines that did not parse (a SIGKILLed writer legitimately leaves a
    torn final line — skipped, counted, never fatal)."""
    header: Optional[Dict[str, Any]] = None
    spans: List[Dict[str, Any]] = []
    skipped = 0
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except ValueError:
                skipped += 1
                continue
            if not isinstance(record, dict):
                skipped += 1
                continue
            if record.get("journal_header"):
                if header is None:
                    header = record
                continue
            if record.get("flight_record"):
                continue
            if "span_id" not in record or "start_ns" not in record:
                skipped += 1
                continue
            spans.append(record)
    return header, spans, skipped


def merge_journals(
    paths: Iterable[str], out_path: Optional[str] = None
) -> Dict[str, Any]:
    """Merge per-host span journals into ONE Chrome/Perfetto trace object.

    Each journal's timestamps are that process's ``perf_counter_ns`` axis;
    its header's ``epoch_anchor_s`` places the axis on wall clock. The
    merge rebases every file onto the earliest anchor, so spans from
    different hosts line up on one timeline, one ``pid`` track per journal
    (named after its host label). Cross-process causality needs no clock
    at all — it rides the shared ``trace_id``/``parent_id`` in ``args``.
    """
    journals = []
    for path in sorted(paths):
        header, spans, skipped = load_journal(path)
        if header is None:
            header = {
                "host": os.path.basename(path), "pid": 0,
                "epoch_anchor_s": 0.0,
            }
        journals.append((header, spans, skipped, path))
    anchors = [h.get("epoch_anchor_s", 0.0) or 0.0 for h, _, _, _ in journals]
    base_anchor = min(anchors) if anchors else 0.0
    events: List[Dict[str, Any]] = []
    meta = []
    for track, (header, spans, skipped, path) in enumerate(journals, 1):
        host = str(header.get("host") or f"journal{track}")
        anchor = header.get("epoch_anchor_s", 0.0) or 0.0
        offset_ns = (anchor - base_anchor) * 1e9
        events.append(
            {"name": "process_name", "ph": "M", "pid": track, "tid": 0,
             "args": {"name": host}}
        )
        events.extend(
            _chrome_events(spans, pid=track, offset_ns=offset_ns,
                           extra_args={"host": host})
        )
        meta.append(
            {"host": host, "path": path, "spans": len(spans),
             "skipped_lines": skipped, "epoch_anchor_s": anchor}
        )
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"epoch_anchor_s": base_anchor, "journals": meta},
    }
    if out_path is not None:
        _write_atomic(out_path, json.dumps(doc))
    return doc


def chrome_trace_text(spans: Optional[Iterable[Any]] = None) -> str:
    if spans is None:
        from .recorder import recorder

        spans = recorder().spans()
    return json.dumps(spans_to_chrome(spans))


def spans_to_jsonl(spans: Optional[Iterable[Any]] = None) -> str:
    if spans is None:
        from .recorder import recorder

        spans = recorder().spans()
    return "".join(json.dumps(_span_dict(s)) + "\n" for s in spans)


def write_chrome_trace(path: str, spans: Optional[Iterable[Any]] = None) -> str:
    """Write the Chrome artifact (default: the flight-recorder ring);
    returns ``path``."""
    text = chrome_trace_text(spans)
    _write_atomic(path, text)
    return path


def write_jsonl(path: str, spans: Optional[Iterable[Any]] = None) -> str:
    _write_atomic(path, spans_to_jsonl(spans))
    return path


def _write_atomic(path: str, text: str) -> None:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(text)
    os.replace(tmp, path)
