"""Boot-time calibration: micro-probes that measure THIS substrate (the
reference's ``deequ_tpu/tuning/calibrate.py``, ported).

``calibrate()`` uses the engine's own execution paths as its measurement
harness: the host partials the CrossoverRouter's fast path runs, warm
``do_analysis_run`` passes on the device tier (kernel ``scan_reduce``),
the engine's host-to-device copy (``runners.engine.to_device``), and the
two grouping engines ``probably_low_cardinality`` routes between (kernel
``freq_keys`` against the host group-by). Each probe runs a few times and
keeps the **minimum** wall time. From the probes it derives a value for
every substrate-sensitive knob through the router's cost model
(:func:`derive_knobs`, the reference's arithmetic), clamps them to the
registry's bounds, and persists a checksummed
:class:`~deequ_tpu_torch.tuning.profile.SubstrateProfile`.

The device probes time the device tier whatever ``placement="auto"``
would pick, and a probe pass that did not run where it was asked to (a
failover to the host tier, a grouping set the probe sent to the host
group-by) raises: a host time is never recorded as the device's.
``device`` defaults to ``cuda``; without a card calibration raises unless
it is given ``"cpu"``.

CLI: ``python -m deequ_tpu_torch.tuning.calibrate --json [--no-save]
[--dir D] [--rows N] [--repeats R] [--device cuda|cpu]``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from ..config import DeviceLike
from . import knobs as _knobs
from .profile import SubstrateProfile, save_profile, substrate_key

#: default rows for the host-partial rate probes
_HOST_PROBE_ROWS = 1 << 18
#: rows for the small (fixed-cost-dominated) device probe
_DEVICE_SMALL_ROWS = 1 << 12
#: rows for the large (per-row-dominated) device probe
_DEVICE_LARGE_ROWS = 1 << 20
#: rows and distinct groups of the grouping-knee probe
_GROUP_PROBE_ROWS = 1 << 18
_GROUP_PROBE_CARDINALITY = 1 << 10


def _timed(fn: Callable[[], Any], repeats: int) -> Tuple[float, Any]:
    """Min wall seconds over ``repeats`` calls (after the caller warmed
    them), and the last result."""
    best = float("inf")
    result = None
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        result = fn()
        best = min(best, time.perf_counter() - t0)
    return best, result


def _pow2_at_most(value: float) -> int:
    """Largest power of two <= value (>= 1)."""
    return 1 << max(int(value).bit_length() - 1, 0)


def _probe_dataset(rows: int, cardinality: int = 0):
    from ..data import Dataset

    rng = np.random.default_rng(0xCA11B)
    cols: Dict[str, Any] = {"v": rng.standard_normal(rows)}
    if cardinality:
        cols["k"] = rng.integers(0, cardinality, size=rows)
    return Dataset.from_dict(cols)


def _probe_host_rates(rows: int, repeats: int) -> Dict[str, float]:
    """rows/s of each representative host-partial class on this box's
    cores: what the router's ``observe_host`` EWMAs converge to."""
    from ..analyzers import Completeness, Maximum, Mean, Minimum, Sum
    from ..analyzers.base import HostBatchContext

    data = _probe_dataset(rows)
    batch = next(data.batches(rows, pad_to_batch_size=False))
    rates: Dict[str, float] = {}
    for analyzer in (Completeness("v"), Mean("v"), Sum("v"), Minimum("v"), Maximum("v")):
        ctx = HostBatchContext(batch, batch_index=0)
        analyzer.host_partial(ctx)  # warm any lazy column materialization
        seconds, _ = _timed(lambda a=analyzer, c=ctx: a.host_partial(c), repeats)
        rates[f"host_rows_per_s_{type(analyzer).__name__}"] = rows / max(seconds, 1e-9)
    return rates


def _run_analysis(data, analyzers, device, **options) -> float:
    """Seconds of one device-tier pass in one batch of the data's rows (the
    reference's default batch for a run this small,
    deequ_tpu/runners/engine.py:938; the port's default pads every batch
    to 2^20 rows, which would make the small and the large probe the same
    work); raises unless the pass ran on the device tier."""
    from ..config import DEFAULT_BATCH_SIZE
    from ..runners.analysis_runner import AnalysisRunner
    from ..runners.engine import RunMonitor

    monitor = RunMonitor()
    t0 = time.perf_counter()
    AnalysisRunner.do_analysis_run(data, analyzers, device=device, placement="device",
                                   monitor=monitor,
                                   batch_size=min(DEFAULT_BATCH_SIZE, max(data.num_rows, 1)),
                                   **options)
    seconds = time.perf_counter() - t0
    recovered = (monitor.device_failovers or monitor.batch_bisections
                 or monitor.isolation_reruns or monitor.degraded)
    if monitor.placement != "device" or recovered:
        raise RuntimeError(
            f"calibration probe pass did not run on the device tier (placement "
            f"{monitor.placement!r}, failovers {monitor.device_failovers}, degraded "
            f"{monitor.degraded}); its time is not the device's")
    if options.get("device_freq") and monitor.device_freq_sets != 1:
        raise RuntimeError("the grouping-knee probe's device run did not take the device "
                           "frequency table")
    return seconds


def _probe_device_costs(repeats: int, device) -> Dict[str, float]:
    """Fixed dispatch seconds (small warm run), per-row rows/s (large warm
    run), and the marginal cost of stacking analyzers into one bundle."""
    from ..analyzers import Maximum, Mean, Minimum, Sum

    small = _probe_dataset(_DEVICE_SMALL_ROWS)
    large = _probe_dataset(_DEVICE_LARGE_ROWS)
    one = [Mean("v")]
    eight = [Mean("v"), Sum("v"), Minimum("v"), Maximum("v"),
             Mean("v", where="v > 0"), Sum("v", where="v > 0"),
             Minimum("v", where="v > 0"), Maximum("v", where="v > 0")]

    _run_analysis(small, one, device)  # warm-up
    fixed_s, _ = _timed(lambda: _run_analysis(small, one, device), repeats)

    _run_analysis(large, one, device)
    large_s, _ = _timed(lambda: _run_analysis(large, one, device), repeats)
    per_row_s = max(large_s - fixed_s, 1e-9) / _DEVICE_LARGE_ROWS

    _run_analysis(small, eight, device)
    stacked_s, _ = _timed(lambda: _run_analysis(small, eight, device), repeats)
    stack_slope_s = max(stacked_s - fixed_s, 0.0) / (len(eight) - len(one))

    return {
        "device_fixed_s": fixed_s,
        "device_rows_per_s": 1.0 / per_row_s,
        "device_stack_slope_s": stack_slope_s,
    }


def _probe_staging_rate(repeats: int, device) -> Dict[str, float]:
    """Host->device rows/s of the engine's feature copy (``to_device``):
    CUDA-event seconds on a card, the host clock on the CPU."""
    import torch

    from ..runners.engine import to_device

    rows = _DEVICE_LARGE_ROWS
    host = {"v": np.random.default_rng(7).standard_normal(rows).astype(np.float32)}

    if device.type == "cuda":
        def stage() -> float:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            to_device(host, device)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3

        stage()  # warm the copy machinery
        seconds = min(stage() for _ in range(max(repeats, 1)))
    else:
        to_device(host, device)
        seconds, _ = _timed(lambda: to_device(host, device), repeats)
    return {"staging_rows_per_s": rows / max(seconds, 1e-9)}


def _probe_grouping_knee(repeats: int, device) -> Dict[str, float]:
    """rows/s of the device frequency table against the host group-by on
    the same grouping workload: the knee ``probably_low_cardinality``
    routes on."""
    from ..analyzers import Uniqueness

    rows = _GROUP_PROBE_ROWS
    data = _probe_dataset(rows, cardinality=_GROUP_PROBE_CARDINALITY)
    analyzers = [Uniqueness(["k"])]
    timings = {}
    for device_freq in (True, False):
        _run_analysis(data, analyzers, device, device_freq=device_freq)
        timings[device_freq], _ = _timed(
            lambda f=device_freq: _run_analysis(data, analyzers, device, device_freq=f),
            repeats)
    return {
        "group_device_rows_per_s": rows / max(timings[True], 1e-9),
        "group_host_rows_per_s": rows / max(timings[False], 1e-9),
    }


def derive_knobs(probes: Dict[str, float]) -> Dict[str, Any]:
    """Map raw probe measurements to knob values through the router's own
    cost model (the reference's arithmetic, line for line); every output
    is clamped to its registry bounds."""
    host_rates = [v for k, v in probes.items() if k.startswith("host_rows_per_s_")]
    host_rate = float(np.median(host_rates)) if host_rates else (
        _knobs.static_value("router_host_rows_per_s"))
    fixed_s = probes.get("device_fixed_s", _knobs.static_value("router_device_fixed_s"))
    device_rate = probes.get("device_rows_per_s",
                             _knobs.static_value("router_device_rows_per_s"))

    derived: Dict[str, Any] = {
        "router_host_rows_per_s": host_rate,
        "router_device_fixed_s": fixed_s,
        "router_device_rows_per_s": device_rate,
    }

    # a fleet shard pays off once the batch amortizes a few fixed
    # dispatches of merge traffic
    derived["fleet_stream_min_rows"] = _pow2_at_most(max(0.25 * fixed_s * device_rate, 1.0))

    # stacking stops paying when the marginal bundle cost approaches the
    # fixed dispatch it amortizes; a slope below the probe's resolution
    # keeps the static width
    slope = probes.get("device_stack_slope_s", 0.0)
    if slope > 1e-7:
        derived["coalesce_max_width"] = _pow2_at_most(max(fixed_s / slope, 1.0))

    # the depth covers the staging/compute rate gap with one spare slot
    staging = probes.get("staging_rows_per_s", 0.0)
    if staging > 0:
        derived["prefetch_depth"] = int(np.clip(round(device_rate / staging) + 1, 1, 8))

    g_host = probes.get("group_host_rows_per_s", 0.0)
    g_dev = probes.get("group_device_rows_per_s", 0.0)
    if g_host > 0 and g_dev > 0:
        # the host group-by needs this many rows before its rate advantage
        # (or the device's fixed cost) buys back the probe's own cost
        derived["freq_host_route_min_rows"] = _pow2_at_most(
            max(8.0 * fixed_s * min(g_host, g_dev), 1.0))
        # scale the distinct ceiling by the measured engine ratio
        ratio = np.clip(g_host / g_dev, 0.25, 4.0)
        derived["freq_host_route_max_distinct"] = _pow2_at_most(
            _knobs.static_value("freq_host_route_max_distinct") * ratio)

    for name in list(derived):
        knob = _knobs.REGISTRY[name]
        derived[name] = min(max(knob.cast(derived[name]), knob.lo), knob.hi)
    return derived


def calibrate(save: bool = True, profile_dir: Optional[str] = None,
              rows: int = _HOST_PROBE_ROWS, repeats: int = 3,
              device: DeviceLike = None) -> SubstrateProfile:
    """Run every probe on ``device`` (default ``cuda``), derive the knob
    values and, by default, persist the substrate profile. Returns the
    profile; its ``knob_values`` are NOT applied to the live registry
    here (that is the service boot's decision)."""
    from ..config import resolve_device
    from ..observability import trace

    dev = resolve_device(device)
    t0 = time.perf_counter()
    probes: Dict[str, float] = {}
    with trace.span("tuning.calibrate", kind="tuning") as span:
        probes.update(_probe_host_rates(rows, repeats))
        probes.update(_probe_device_costs(repeats, dev))
        probes.update(_probe_staging_rate(repeats, dev))
        probes.update(_probe_grouping_knee(repeats, dev))
        profile = SubstrateProfile(
            substrate=substrate_key(dev),
            probes=probes,
            knob_values=derive_knobs(probes),
            calibration_wall_s=time.perf_counter() - t0,
        )
        span.add_event("calibrated", fingerprint=profile.fingerprint,
                       wall_s=round(profile.calibration_wall_s, 3),
                       knobs=len(profile.knob_values))
        if save:
            path = save_profile(profile, profile_dir)
            span.add_event("profile_saved", path=path)
    return profile


def _main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(
        description="Calibrate deequ_tpu_torch's tuning profile for this substrate")
    parser.add_argument("--json", action="store_true", help="print the profile as JSON")
    parser.add_argument("--no-save", action="store_true",
                        help="measure and print without persisting")
    parser.add_argument("--dir", default=None,
                        help="profile directory (default: DEEQU_TPU_TUNING_PROFILE_DIR "
                             "or the reference's default)")
    parser.add_argument("--rows", type=int, default=_HOST_PROBE_ROWS,
                        help="rows per host-partial probe")
    parser.add_argument("--repeats", type=int, default=3,
                        help="probe repeats (the min wall time wins)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    profile = calibrate(save=not args.no_save, profile_dir=args.dir, rows=args.rows,
                        repeats=args.repeats, device=args.device)
    if args.json:
        print(json.dumps({
            "substrate": profile.substrate,
            "fingerprint": profile.fingerprint,
            "probes": profile.probes,
            "knobs": profile.knob_values,
            "wall_s": profile.calibration_wall_s,
        }, sort_keys=True))
    else:
        print(f"calibrated substrate {profile.fingerprint} "
              f"in {profile.calibration_wall_s:.2f}s")
        for name, value in sorted(profile.knob_values.items()):
            print(f"  {name:32s} {value} (static {_knobs.static_value(name)})")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
