"""Scan watchdog: deadline monitoring for device and host-tier passes (the
reference's ``deequ_tpu/reliability/watchdog.py``, ported).

Isolation, failover and retry all begin when something throws. A pass that
HANGS (a wedged copy, a collective waiting on a dead peer, a kernel that
never returns) defeats all of them: the worker blocks forever and the
battery never degrades. This module is the hang analog of a thrown fault:

- every engine pass runs under a DEADLINE derived from the measured
  per-ROW rate of earlier passes on the same tier (a generous multiple,
  so normal variance never trips; per row, so micro-batch and full-batch
  passes share one rate), overridable with ``DEEQU_TPU_SCAN_DEADLINE_S``
  (<= 0 disables);
- a pass past its deadline is abandoned: the caller gets a typed
  :class:`~deequ_tpu_torch.exceptions.ScanStallError`, which classifies as
  a ``"device"`` fault and takes the tier failover and the placement
  probation (``isolation.classify_failure``); ``RunMonitor.stalls`` counts
  it, ``RunMonitor.device_stalls`` when the tier was the device;
- the service's scheduler retries an escaped stall.

Python cannot kill a thread, so the stalled pass is abandoned on its
daemon thread (named ``scan-watchdog-<site>`` while it runs a pass) while
the caller recovers. One design change from the reference: an abandoned
pass STOPS. The caller sets the cancel event it handed
:func:`run_with_deadline` (``on_stall``), and the engine's tiers and its
feed thread check it at every batch boundary: the pass then launches,
folds, checkpoints and probes no fault site again, and its thread ends at
that boundary (the reference's zombie ran on, probing the injector that
later tests armed). The threads of passes that finish are kept for later
passes (named ``deequ-pass-idle`` between them): a pass on a fresh thread
pays torch's per-thread set-up again (its intra-op thread pool), about 9
ms a pass on the CPU, a cost every fold of a streaming service would
carry.

On the card the pass body runs on the watchdog's thread, and the current
CUDA device is per thread: the body runs with the pass's device current
(``run_with_deadline(..., device=)``). Rates are kept per tier and per
kind of device (:func:`rate_key`): one process may run a tier on the card
and on the CPU, whose rates differ by orders of magnitude.

A pass that fails over to the host tier after a stall or a device fault
never runs unguarded, even before the host tier has a measured rate: the
isolation layer runs it inside :func:`failover_pass`, and its deadline is
then the one the failed tier's rate gives, or the floor when that tier
had none either (the host tier's folds launch on the same card, so a
wedged card would hang it too).
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from typing import Callable, Dict, Optional

from ..exceptions import ScanStallError

#: env var: per-pass deadline in seconds. Overrides the derived deadline;
#: "0" (or any value <= 0) disables the watchdog entirely.
SCAN_DEADLINE_ENV = "DEEQU_TPU_SCAN_DEADLINE_S"

#: multiple of the measured per-row time a pass may take before it is
#: declared stalled: a false trip (a spurious failover) costs far more
#: than a few extra seconds of waiting
DEADLINE_RATE_MULTIPLE = 10.0

#: floor on any derived deadline: warm-up costs amortize into the first
#: batches, so short passes get slack
DEADLINE_FLOOR_S = 30.0

#: the name prefix of the threads guarded passes run on
THREAD_PREFIX = "scan-watchdog-"


class RateTracker:
    """EWMA of measured per-ROW wall seconds, per tier. Fed by completed
    engine passes; consulted to derive the next pass's deadline. Per row,
    not per batch: one tier serves 4,096-row streaming micro-batches and
    1M-row verification batches, and a per-batch rate learned from the
    small ones would derive deadlines no healthy large-batch pass can
    meet. Thread-safe (service workers run passes concurrently)."""

    ALPHA = 0.3

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._per_row_s: Dict[str, float] = {}

    def observe(self, tier: str, rows: int, seconds: float) -> None:
        if rows <= 0 or seconds <= 0:
            return
        per_row = seconds / rows
        with self._lock:
            prev = self._per_row_s.get(tier)
            self._per_row_s[tier] = (
                per_row if prev is None
                else self.ALPHA * per_row + (1 - self.ALPHA) * prev
            )

    def per_row_s(self, tier: str) -> Optional[float]:
        with self._lock:
            return self._per_row_s.get(tier)

    def clear(self) -> None:
        with self._lock:
            self._per_row_s.clear()


#: the process-wide rate ledger (rates do not survive restarts: the first
#: pass of a process runs unguarded unless the env override is set)
_TRACKER = RateTracker()


def rate_tracker() -> RateTracker:
    return _TRACKER


#: warn-once latch for an unparseable env override
_ENV_WARNED = False


def rate_key(tier: str, device=None) -> str:
    """The rate tracker's key of a pass on ``tier`` run on ``device``: the
    tier's name on the card (the reference's key), ``"<tier>@cpu"`` for a
    pass on the CPU, so a rate learned on the card never gives a CPU pass
    a deadline it cannot meet."""
    kind = getattr(device, "type", None)
    return tier if kind in (None, "cuda") else f"{tier}@{kind}"


#: per thread: whether the passes started now fail over from another tier
_FAILOVER = threading.local()


@contextlib.contextmanager
def failover_pass(active: bool = True):
    """Mark the engine passes this thread starts inside the block as
    failover passes (``active``): their deadline falls back to the failed
    tier's when their own tier has no measured rate (see
    :func:`scan_deadline_s`)."""
    previous = getattr(_FAILOVER, "active", False)
    _FAILOVER.active = active
    try:
        yield
    finally:
        _FAILOVER.active = previous


def in_failover_pass() -> bool:
    return getattr(_FAILOVER, "active", False)


def scan_deadline_s(n_rows: int, tier: str, failed_tier: Optional[str] = None
                    ) -> Optional[float]:
    """The deadline for a pass over ``n_rows`` on ``tier`` (a
    :func:`rate_key`), or None (watchdog off: no override and no measured
    rate yet). A failover pass names the tier it fails over from
    (``failed_tier``, a :func:`rate_key`): with no rate of its own it takes
    that tier's derived deadline, or the floor, never None."""
    env = os.environ.get(SCAN_DEADLINE_ENV)
    if env is not None:
        try:
            value = float(env)
        except ValueError:
            # an operator who set "60s" believes hang detection is armed:
            # fall back to the derived deadline rather than silently
            # disabling both paths, and say why the value was ignored
            global _ENV_WARNED
            if not _ENV_WARNED:
                _ENV_WARNED = True
                import logging

                logging.getLogger(__name__).warning(
                    "ignoring unparseable %s=%r (expected seconds as a "
                    "number); falling back to the measured-rate deadline",
                    SCAN_DEADLINE_ENV, env,
                )
        else:
            return value if value > 0 else None
    per_row = _TRACKER.per_row_s(tier)
    if per_row is None and failed_tier is not None:
        per_row = _TRACKER.per_row_s(failed_tier)
        if per_row is None:
            return DEADLINE_FLOOR_S
    if per_row is None:
        return None
    return max(
        DEADLINE_FLOOR_S,
        DEADLINE_RATE_MULTIPLE * per_row * max(int(n_rows), 1),
    )


#: the name of a kept pass thread between passes
IDLE_NAME = "deequ-pass-idle"


class _PassThreads:
    """The daemon threads guarded passes run on: a pass takes an idle one,
    or starts one when none is idle (an abandoned pass still holds its
    own). A thread is named ``scan-watchdog-<site>`` while it runs a pass;
    after a pass it returns to the idle set, unless the pass was abandoned:
    that thread ends, so whoever joins the abandoned passes' threads sees
    them end."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._idle: list = []

    def start(self, body: Callable[[], None], site: str, abandoned: threading.Event) -> None:
        with self._lock:
            inbox = self._idle.pop() if self._idle else None
        if inbox is None:
            inbox = queue.SimpleQueue()
            threading.Thread(target=self._loop, args=(inbox,), name=IDLE_NAME,
                             daemon=True).start()
        inbox.put((body, site, abandoned))

    def _loop(self, inbox) -> None:
        me = threading.current_thread()
        while True:
            body, site, abandoned = inbox.get()
            me.name = f"{THREAD_PREFIX}{site}"
            body()
            if abandoned.is_set():
                return
            me.name = IDLE_NAME
            with self._lock:
                self._idle.append(inbox)


_THREADS = _PassThreads()


def run_with_deadline(
    fn: Callable[[], "object"],
    deadline_s: float,
    monitor,
    site: str,
    device=None,
    on_stall: Optional[Callable[[], None]] = None,
):
    """Run ``fn`` to completion or to the deadline, whichever first.

    ``fn`` runs on a kept daemon thread, named ``scan-watchdog-<site>``
    while it runs, under the caller's trace context and, for a CUDA
    ``device``, with that device current. On deadline: call ``on_stall``
    (the engine's cancel, which stops the pass at its next batch
    boundary), bump ``monitor.stalls`` (and ``device_stalls`` for ``site ==
    "device"``), abandon the thread (its eventual return value is
    discarded; it ends when the pass does) and raise
    :class:`ScanStallError`. On completion: return or raise exactly what
    ``fn`` did."""
    from ..observability import record_failure
    from ..observability import trace as _trace

    box: Dict[str, object] = {}
    done = threading.Event()
    abandoned = threading.Event()
    ctx = _trace.capture()
    index = None
    if getattr(device, "type", None) == "cuda":
        import torch

        # a bare "cuda" names the caller's current card
        index = device.index if device.index is not None else torch.cuda.current_device()

    def body() -> None:
        try:
            with _trace.attach(ctx):
                if index is None:
                    box["value"] = fn()
                else:
                    import torch

                    with torch.cuda.device(index):
                        box["value"] = fn()
        except BaseException as exc:  # noqa: BLE001 - re-raised in caller
            box["error"] = exc
        finally:
            done.set()

    t0 = time.perf_counter()
    _THREADS.start(body, site, abandoned)
    if not done.wait(deadline_s):
        waited = time.perf_counter() - t0
        abandoned.set()
        if on_stall is not None:
            on_stall()
        if monitor is not None:
            monitor.bump("stalls")
            if site == "device":
                # only DEVICE stalls teach the placement router to avoid
                # the device tier: pinning a battery to the host tier
                # because the HOST hung would put it on the sick tier
                monitor.bump("device_stalls")
        stall = ScanStallError(site, deadline_s, waited)
        _trace.add_event("scan_stall", site=site, deadline_s=deadline_s, waited_s=waited)
        record_failure(stall)
        raise stall
    if "error" in box:
        error = box.pop("error")
        try:
            raise error
        finally:
            # the traceback holds this frame: drop the frame's reference to
            # the exception, or the cycle keeps the failed pass's device
            # tensors alive until a garbage collection (an OOM's retry
            # would find them still allocated)
            del error
    return box["value"]


def join_abandoned_passes(timeout: float = 60.0) -> bool:
    """Wait for the threads running guarded passes to end: the abandoned
    passes' (an abandoned pass ends at its next batch boundary, and its
    thread with it); a drill calls it before it ends, so no pass of it
    outlives it. False when ``timeout`` ran out first."""
    deadline = time.monotonic() + timeout
    for thread in threading.enumerate():
        if thread.name.startswith(THREAD_PREFIX) and thread is not threading.current_thread():
            thread.join(max(0.0, deadline - time.monotonic()))
            if thread.is_alive():
                return False
    return True
