"""Render the PyTorch/CUDA port's self-tuning plane: the active substrate
profile and the live controller's experiments and decisions.

    python3 -m tools.torch_tuning_report [--dir DIR] [--json]
        [--snapshot FILE] [--device cuda|cpu]
    python3 -m tools.torch_tuning_report --bench-point [--sessions S]
        [--group-rows R] [--device cuda|cpu]

Two consumers:

- operators: the default mode loads the profile of ``--device``'s
  substrate (``deequ_tpu_torch.tuning.profile``, the loader the service
  boots through, checksum included) and prints its probes and each
  derived knob beside its static default;
- ``tools/torch_chaos_soak.py``: :func:`controller_report` renders an
  in-process service's controller (incumbent and candidate rates per
  experiment, the promotions and demotions, the four
  ``deequ_service_tuning_*`` series) into the soak's summary.

``--bench-point`` measures one streaming and one grouping rate under the
current environment and prints them as one JSON line. ``--device``
defaults to ``cuda``: without a card it raises; pass ``--device cpu`` to
run the kernels' plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

#: the controller's export series, in the report's order
TUNING_SERIES = (
    "deequ_service_tuning_proposals_total",
    "deequ_service_tuning_promotions_total",
    "deequ_service_tuning_demotions_total",
    "deequ_service_tuning_shadow_folds_total",
)


def profile_report(directory: Optional[str] = None, device=None) -> Dict[str, Any]:
    """The profile of ``device``'s substrate as a report dict; a
    :class:`CorruptStateError` becomes a ``quarantined`` note, as at the
    service's boot."""
    from deequ_tpu_torch.exceptions import CorruptStateError
    from deequ_tpu_torch.tuning import knobs, profile as prof

    out: Dict[str, Any] = {
        "substrate": prof.substrate_key(device),
        "fingerprint": prof.substrate_fingerprint(device=device),
        "profile_dir": directory or prof.profile_dir(),
    }
    try:
        loaded = prof.load_profile(directory, device=device)
    except CorruptStateError as exc:
        out["profile"] = None
        out["quarantined"] = str(exc)
        return out
    if loaded is None:
        out["profile"] = None
        return out
    out["profile"] = {
        "created_at": loaded.created_at,
        "calibration_wall_s": loaded.calibration_wall_s,
        "probes": loaded.probes,
        "knobs": {
            name: {"calibrated": value, "static": knobs.static_value(name)}
            for name, value in sorted(loaded.knob_values.items())
            if name in knobs.REGISTRY
        },
    }
    return out


def controller_report(service) -> Dict[str, Any]:
    """The live controller's decisions and the tuning series of one
    in-process ``VerificationService``."""
    controller = getattr(service, "tuning_controller", None)
    metrics = getattr(service, "metrics", None)
    out: Dict[str, Any] = {"enabled": controller is not None}
    if metrics is not None:
        out["series"] = {name: metrics.counter_value(name) for name in TUNING_SERIES}
    if controller is not None:
        out.update(controller.snapshot())
    return out


def bench_point(sessions: int = 96, rows: int = 4096, group_rows: int = 1 << 19,
                group_cardinality: int = 1 << 10, device=None) -> Dict[str, Any]:
    """One tuned-or-static measurement under the current environment:
    streaming sessions/s (``sessions`` sessions of one ``rows``-row
    micro-batch) and grouping rows/s (a warm Uniqueness run over
    ``group_rows`` keys), on ``device`` (``cuda`` unless named)."""
    import os
    import time

    import numpy as np
    import pyarrow as pa

    import deequ_tpu_torch as dq
    from deequ_tpu_torch.config import resolve_device, synchronize
    from deequ_tpu_torch.service import VerificationService
    from deequ_tpu_torch.tuning import knobs

    dev = resolve_device(device)
    rng = np.random.default_rng(0xBE9C4)
    checks = [
        dq.Check(dq.CheckLevel.ERROR, "tuning point")
        .is_complete("x")
        .has_mean("y", lambda m: -5.0 < m < 5.0)
    ]
    table = pa.table({"x": rng.normal(size=rows), "y": rng.normal(size=rows)})
    with VerificationService(background_warm=False, device=dev) as service:
        warm = service.session("tuning-point-warm", "stream", checks)
        # warm both fold routes before timing: whichever route the timed
        # loop settles on must not pay its first launch inside the window
        route_env = "DEEQU_TPU_FAST_PATH_MAX_ROWS"
        saved = os.environ.get(route_env)
        try:
            os.environ[route_env] = "0"  # the device route
            warm.ingest(table, timeout=120)
            os.environ[route_env] = str(1 << 30)  # the host fast path
            warm.ingest(table, timeout=120)
        finally:
            if saved is None:
                os.environ.pop(route_env, None)
            else:
                os.environ[route_env] = saved
        warm.ingest(table, timeout=120)  # the model's own route
        t0 = time.perf_counter()
        for i in range(sessions):
            s = service.session(f"tuning-point-{i}", "stream", checks)
            s.ingest(table, timeout=120)
        streaming = sessions / (time.perf_counter() - t0)

    gdata = dq.Dataset.from_dict({"k": rng.integers(0, group_cardinality, size=group_rows)})
    analyzers = [dq.Uniqueness(["k"])]
    dq.AnalysisRunner.do_analysis_run(gdata, analyzers, device=dev)  # warm
    synchronize(dev)
    t0 = time.perf_counter()
    dq.AnalysisRunner.do_analysis_run(gdata, analyzers, device=dev)
    synchronize(dev)
    grouping = group_rows / (time.perf_counter() - t0)

    return {
        "sessions": sessions,
        "rows": rows,
        "group_rows": group_rows,
        "sessions_per_s": streaming,
        "grouping_rows_per_s": grouping,
        "autotune": knobs.autotune_enabled(),
        "tuned_knobs": sorted(knobs.tuned_snapshot()),
    }


def _fmt(value: Any) -> str:
    if isinstance(value, float):
        return f"{value:.4g}"
    return str(value)


def render_text(report: Dict[str, Any]) -> str:
    lines: List[str] = []
    sub = report["substrate"]
    lines.append(f"substrate {report['fingerprint']}: {sub['backend']} "
                 f"{sub['device_kind']} x{sub['chip_count']} on {sub['host']}")
    lines.append(f"profile dir: {report['profile_dir']}")
    if report.get("quarantined"):
        lines.append(f"PROFILE QUARANTINED: {report['quarantined']}")
        return "\n".join(lines)
    profile = report.get("profile")
    if profile is None:
        lines.append("no profile for this substrate "
                     "(run python -m deequ_tpu_torch.tuning.calibrate)")
        return "\n".join(lines)
    lines.append(f"calibrated in {profile['calibration_wall_s']:.2f}s; "
                 f"{len(profile['probes'])} probes")
    lines.append(f"{'knob':34s} {'calibrated':>14s} {'static':>14s}")
    for name, row in profile["knobs"].items():
        lines.append(f"{name:34s} {_fmt(row['calibrated']):>14s} {_fmt(row['static']):>14s}")
    lines.append("probes:")
    for name, value in sorted(profile["probes"].items()):
        lines.append(f"  {name:34s} {_fmt(value):>14s}")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tools.torch_tuning_report",
        description="Show this substrate's calibration profile (and, with --snapshot, "
                    "a serialized controller state)",
    )
    parser.add_argument("--dir", default=None,
                        help="profile directory (default: DEEQU_TPU_TUNING_PROFILE_DIR)")
    parser.add_argument("--json", action="store_true", help="emit the report as JSON")
    parser.add_argument("--snapshot", default=None,
                        help="also render a controller snapshot JSON file "
                             "(as the chaos soak writes it)")
    parser.add_argument("--bench-point", action="store_true",
                        help="measure one streaming and one grouping rate under the "
                             "current environment and print them as a JSON line")
    parser.add_argument("--sessions", type=int, default=96,
                        help="streaming sessions for --bench-point")
    parser.add_argument("--group-rows", type=int, default=1 << 19,
                        help="grouping rows for --bench-point")
    parser.add_argument("--device", default="cuda",
                        help="the substrate's device (default cuda; cpu runs the plain "
                             "versions of the kernels)")
    args = parser.parse_args(argv)

    if args.bench_point:
        point = bench_point(sessions=args.sessions, group_rows=args.group_rows,
                            device=args.device)
        print(json.dumps(point, sort_keys=True))
        return 0

    report = profile_report(args.dir, device=args.device)
    if args.snapshot:
        with open(args.snapshot, "r", encoding="utf-8") as fh:
            report["controller"] = json.load(fh)
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True, default=str))
    else:
        print(render_text(report))
        controller = report.get("controller")
        if controller:
            print(f"controller: {len(controller.get('decisions', []))} decision(s), "
                  f"{len(controller.get('tuned', {}))} tuned knob(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
