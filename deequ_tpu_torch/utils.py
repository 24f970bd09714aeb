"""Small shared utilities."""

from __future__ import annotations

from collections import OrderedDict
from typing import Any


class BoundedLRU:
    """A bounded mapping with least-recently-USED eviction for compiled
    program caches: a hot key touched on every run stays resident while
    cold keys age out. (The previous bounded caches evicted FIFO, so a
    long-lived service could evict its hottest program while one-shot keys
    lingered.) A lock guards the compound lookup-then-reorder/evict steps
    so concurrent readers/writers (the engine's partial pool) keep plain
    dict.get semantics — get never raises."""

    def __init__(self, max_size: int):
        import threading

        self.max_size = int(max_size)
        self._lock = threading.Lock()
        self._data: "OrderedDict[Any, Any]" = OrderedDict()

    def get(self, key, default=None):
        with self._lock:
            try:
                value = self._data[key]
            except KeyError:
                return default
            self._data.move_to_end(key)
            return value

    def __setitem__(self, key, value) -> None:
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
            elif len(self._data) >= self.max_size:
                self._data.popitem(last=False)
            self._data[key] = value

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._data

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def pop(self, key, default=None):
        with self._lock:
            return self._data.pop(key, default)

    def keys(self):
        with self._lock:
            return list(self._data.keys())

    def clear(self) -> None:
        with self._lock:
            self._data.clear()


#: warn-once latch for env_number (one line per env var per process)
_ENV_WARNED: set = set()


def env_number(env: str, default, cast, minimum=None):
    """The shared "warn once, keep the default" env-knob parser (the
    DEEQU_TPU_SCAN_DEADLINE_S convention): unparseable values — and, with
    ``minimum``, out-of-range ones — log ONE warning per process per
    variable and fall back to ``default`` instead of crashing the path
    that read them. Knobs whose fallback is not a constant (the watchdog's
    derived deadline) keep their own parsers."""
    import logging
    import os

    raw = os.environ.get(env)
    if raw is None:
        return default
    try:
        value = cast(raw)
        if minimum is not None and value < minimum:
            raise ValueError(raw)
    except ValueError:
        if env not in _ENV_WARNED:
            _ENV_WARNED.add(env)
            logging.getLogger(__name__).warning(
                "ignoring invalid %s=%r; using the default %s",
                env, raw, default,
            )
        return default
    return value


def env_str(env: str, default=None):
    """Shared reader for STRING-valued env knobs (paths, placement names,
    JSON plans): no parsing to fall back from, but one choke point that
    keeps every knob read on the ``utils.env_*`` surface the invariant
    linter (tools/statlint, the env-knob-convention check) can see."""
    import os

    return os.environ.get(env, default)


def env_flag(env: str, default: bool) -> bool:
    """Shared reader for BOOLEAN env knobs following the repo's "0 means
    off" convention: unset (or empty) keeps ``default``, the literal
    ``"0"`` means False, anything else means True. Knobs with richer
    semantics (tri-state probes, strict 0/1 validation with warn-once)
    keep their own parsers and a statlint baseline entry."""
    import os

    raw = os.environ.get(env)
    if raw is None or raw == "":
        return default
    return raw != "0"
