"""Double-buffered host-to-device feed pipeline (the reference's
``deequ_tpu/ingest/prefetch.py``, ported; its caller is the engine's device
tier, ``runners/engine.py ScanEngine._run_device_tier``).

What gates a device pass is the HOST side of each batch: the feature
build and the host-to-device copy. A dedicated feed thread builds batch
k+1's features (and with depth 2, k+2's) while the launching thread
copies batch k's to the card and launches its kernels. The engine decides the depth
once a pass (a one-batch pass stages inline, :func:`staging_depth`) and
hands it to the iterator.

``DEEQU_TPU_PREFETCH_DEPTH`` sizes the pipeline (the ``prefetch_depth``
knob of ``tuning.knobs``; 2: one batch on the card, one built, one being
built). The default is ``0``, the reference's being 2: no feed thread at
all, batches produce inline on the consumer thread. On the H100 depth 2
gained nothing measurable on a verification pass over 10M rows and took
28% longer on a column profile, whose feature build slows down on the
feed thread (``tools/torch_main_paths.py --alternate``, PERF.md). Unparseable
values warn once and keep the default.

Failure contract: an exception inside the feed thread (a poisoned batch,
an injected ``feed_stall``, a copy that raised) reaches the consumer on
its next pull, as on the inline path, and the pipeline shuts down; a feed
thread that goes SILENT (a hung copy that neither returns nor raises)
trips the consumer's stall deadline (``DEEQU_TPU_FEED_STALL_S``, default
120 s, <= 0 disables) as a typed ``FeedStallError``, a
``DeviceFailureException``: the pass fails over to the host tier exactly
like a thrown device fault. The ``prefetch`` fault site fires before each
staged batch so drills can wedge or kill the feed on demand. A pass the
watchdog abandoned sets the iterator's ``stop`` event: the feed thread
then ends at its next batch without probing or producing again.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterator, Optional

#: env var sizing the staged-batch pipeline (0 = serial, no feed thread)
PREFETCH_DEPTH_ENV = "DEEQU_TPU_PREFETCH_DEPTH"
DEFAULT_PREFETCH_DEPTH = 0

#: env var: seconds the consumer waits on a silent feed thread before
#: declaring it wedged with a typed FeedStallError (<= 0 disables).
#: Generous by default: a healthy produce is sub-second per batch, so only
#: a hung copy or a wedged source trips it.
FEED_STALL_ENV = "DEEQU_TPU_FEED_STALL_S"
DEFAULT_FEED_STALL_S = 120.0


def prefetch_depth() -> int:
    """The configured pipeline depth (env override > tuned > static 0);
    warn-and-fallback on bad values."""
    from ..tuning import knobs

    return knobs.value("prefetch_depth")


def feed_stall_s() -> float:
    """The configured feed-stall deadline (<= 0 = disabled);
    warn-and-fallback on bad values."""
    from ..utils import env_number

    return env_number(FEED_STALL_ENV, DEFAULT_FEED_STALL_S, float)


def staging_depth(n_batches: int) -> Optional[int]:
    """The pipeline depth for a pass of ``n_batches``: ``None`` (the
    configured depth) for multi-batch passes, ``0`` (inline, no feed
    thread) for a single-batch pass. A one-batch fold has nothing to
    overlap with, so the feed thread's start and teardown would be pure
    fixed cost on the streaming plane, where every micro-batch fold is a
    one-batch pass. The inline path keeps the ``prefetch`` fault site and
    the same order."""
    return 0 if n_batches <= 1 else None


#: queue entry kinds
_ITEM, _DONE, _ERROR = 0, 1, 2


class PrefetchingBatchIterator:
    """Iterate ``produce()`` results through a bounded staging pipeline.

    ``produce`` is called repeatedly on the feed thread; it returns the
    next staged item or ``None`` at the end of the input. Up to ``depth``
    finished items wait in the stage queue while the consumer folds;
    ``depth=0`` calls ``produce`` inline (no thread, the same order).

    The iterator is a context manager; exiting (or ``close()``) tears the
    feed thread down even when the consumer stopped early. ``stop`` (if
    given) is the pass's cancel event: once it is set the feed produces
    and probes nothing more."""

    def __init__(
        self,
        produce: Callable[[], Optional[Any]],
        *,
        depth: Optional[int] = None,
        stall_timeout_s: Optional[float] = None,
        name: str = "deequ-ingest-prefetch",
        stop: Optional[threading.Event] = None,
    ):
        self._produce = produce
        self._stop = stop
        self.depth = prefetch_depth() if depth is None else max(0, int(depth))
        #: how long the consumer tolerates a SILENT feed thread before
        #: raising typed FeedStallError (<= 0 disables the deadline)
        self.stall_timeout_s = (
            feed_stall_s() if stall_timeout_s is None else float(stall_timeout_s)
        )
        self._closed = threading.Event()
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._index = 0
        if self.depth > 0:
            self._queue = queue.Queue(maxsize=self.depth)
            self._thread = threading.Thread(target=self._feed_loop, name=name, daemon=True)
            self._thread.start()

    def _stopped(self) -> bool:
        return self._closed.is_set() or (self._stop is not None and self._stop.is_set())

    # -- feed thread ---------------------------------------------------------

    def _feed_loop(self) -> None:
        from ..reliability.faults import fault_point

        index = 0
        while not self._stopped():
            try:
                # fault site: an injected feed_stall wedges or kills the
                # feed exactly where a real copy thread would
                fault_point("prefetch", tag=str(index))
                if self._stopped():
                    return  # abandoned while this thread slept
                item = self._produce()
            except BaseException as exc:  # noqa: BLE001 - propagate to
                # the consumer: KeyboardInterrupt-class injections must
                # ride out exactly like on the inline path
                self._put((_ERROR, exc))
                return
            if item is None:
                self._put((_DONE, None))
                return
            if not self._put((_ITEM, item)):
                return  # the consumer closed while this batch staged
            index += 1

    def _put(self, entry) -> bool:
        """Bounded put that gives up once the consumer closed the pipeline
        (a consumer that stopped early must not leave this thread parked
        on a full queue forever)."""
        while not self._stopped():
            try:
                self._queue.put(entry, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    # -- consumer side -------------------------------------------------------

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        if self.depth == 0:
            from ..reliability.faults import fault_point

            if self._stop is not None and self._stop.is_set():
                raise StopIteration
            fault_point("prefetch", tag=str(self._index))
            self._index += 1
            item = self._produce()
            if item is None:
                raise StopIteration
            return item
        if self._closed.is_set():
            raise StopIteration
        deadline = self.stall_timeout_s
        try:
            kind, value = self._get(deadline if deadline and deadline > 0 else None)
        except queue.Empty:
            # the feed thread went SILENT past the stall deadline (a hung
            # copy, a wedged source): declare it typed, a
            # DeviceFailureException, so the pass fails over to the host
            # tier, whose chunk iteration shares none of this machinery
            from ..exceptions import FeedStallError

            # the feed thread is wedged: leave it (a daemon) rather than
            # wait for it, so the stall surfaces at its deadline
            self.close(join=False)
            raise FeedStallError(
                "prefetch", f"feed thread produced nothing for {deadline:g}s") from None
        if kind == _ITEM:
            return value
        self._closed.set()
        if kind == _ERROR:
            try:
                raise value
            finally:
                del value  # no frame-exception cycle holding the pass's tensors
        raise StopIteration

    def _get(self, timeout: Optional[float]):
        """The next queue entry, waiting at most ``timeout`` seconds (None:
        no limit); a set ``stop`` ends the wait as the end of the input
        (the stopped feed thread puts nothing more)."""
        if self._stop is None:
            return self._queue.get(timeout=timeout)
        end = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._stop.is_set():
                return _DONE, None
            wait = 0.05 if end is None else min(0.05, end - time.monotonic())
            if wait <= 0:
                raise queue.Empty
            try:
                return self._queue.get(timeout=wait)
            except queue.Empty:
                continue

    def close(self, join: bool = True) -> None:
        """Tear the pipeline down (idempotent): wakes a feed thread parked
        on a full queue and, with ``join``, joins it. Staged but unconsumed
        items are dropped, as the consumer abandoning a pass wants."""
        self._closed.set()
        if self._thread is not None:
            # drain so a blocked put's retry loop sees closed at once
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            if join:
                self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "PrefetchingBatchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
