"""Injectable clock: the port's single wall-clock boundary.

Port of ``repro.clock``. Library code reads time only through a
:class:`Clock` the caller injects (default :data:`SYSTEM`), so serving runs
replay exactly under :class:`VirtualClock`.
"""

from __future__ import annotations

import threading
import time  # repro-lint: disable-file=RL005 -- the port's clock boundary


class Clock:
    """Time source interface: monotonic ``now()`` seconds plus ``sleep``."""

    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, dt: float) -> None:
        raise NotImplementedError


class SystemClock(Clock):
    """The real wall clock (monotonic)."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, dt: float) -> None:
        time.sleep(dt)


class VirtualClock(Clock):
    """Deterministic virtual time for replayable runs.

    Each ``now()`` advances ``tick`` seconds; ``sleep(dt)`` jumps forward by
    ``max(dt, min_sleep)`` without blocking. ``now``/``sleep`` are each
    atomic under a lock.
    """

    def __init__(
        self, tick: float = 5e-4, min_sleep: float = 1e-4, start: float = 0.0
    ):
        self.tick = tick
        self.min_sleep = min_sleep
        self.t = start
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            self.t += self.tick
            return self.t

    def sleep(self, dt: float) -> None:
        with self._lock:
            self.t += max(dt, self.min_sleep)


#: process-wide default; the only place library code touches real time
SYSTEM = SystemClock()
