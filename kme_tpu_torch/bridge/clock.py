"""The clock seam: every sim-reachable wait/stamp goes through here.

FoundationDB-style deterministic simulation (the JAX package's
kme_tpu/sim/, not ported yet) runs the whole cluster in one process
under a virtual clock. That only works if no component reads wall time
or sleeps on the real OS behind the scheduler's back — a single stray
``time.sleep`` turns a reproducible interleaving into a wall-clock race.
This module is the shared seam the rest of ``bridge/``
(service retry/backoff, broker admission stamps, replica follow loop,
TCP client re-stamping) threads through, so the simulator substitutes
ONE object instead of monkeypatching four modules.

Two implementations:

- ``WallClock`` — the production default; trivial delegation to
  ``time``. Module singleton ``WALL`` so hot paths share one instance.
- ``VirtualClock`` — a manually advanced clock for the simulator and
  for unit tests. ``sleep()`` never blocks: it advances virtual time
  (standalone use) or defers to an installed scheduler hook
  (cooperative use under a simulator), so a component that naps for
  backoff costs simulated milliseconds, not real ones.

kme-lint enforces the seam: functions listed in ``CLOCK_SCOPES``
(analysis/rules.py) may not call ``time.time/monotonic/sleep/time_ns``
directly — rule KME-C001 fires on any regression.
"""

from __future__ import annotations

import time as _time
from typing import Callable, Optional


class Clock:
    """Interface + production implementation contract.

    ``time()``/``time_ns()``/``time_us()`` are the wall ("admission
    stamp") domain; ``monotonic()`` is the interval domain (heartbeats,
    backoff deadlines); ``sleep()`` is the only blocking primitive.
    """

    def time(self) -> float:
        raise NotImplementedError

    def time_ns(self) -> int:
        raise NotImplementedError

    def time_us(self) -> int:
        """Microsecond admission stamps (broker ``ats``)."""
        return self.time_ns() // 1000

    def monotonic(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError


class WallClock(Clock):
    """The real thing (production default)."""

    def time(self) -> float:
        return _time.time()

    def time_ns(self) -> int:
        return _time.time_ns()

    def monotonic(self) -> float:
        return _time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            _time.sleep(seconds)


#: Shared production instance — ``clock or WALL`` is the idiom at every
#: seam, so None-configured components never allocate.
WALL = WallClock()


class VirtualClock(Clock):
    """A deterministic clock that only moves when told to.

    Standalone (no hook): ``sleep(s)`` advances ``now`` by ``s`` — unit
    tests of backoff logic complete instantly. Under the simulator a
    ``sleep_hook`` is installed and owns the advance: the cooperative
    scheduler charges the sleeping actor virtual time without blocking
    the process.

    ``skew``: per-actor wall offset (the ``clock.skew`` fault point) —
    shifts ``time()``-domain reads only, never ``monotonic()``, exactly
    like a stepped NTP adjustment on a real host.
    """

    def __init__(self, start: float = 0.0,
                 sleep_hook: Optional[Callable[[float], None]] = None
                 ) -> None:
        self.now = float(start)
        self.skew = 0.0
        self.sleep_hook = sleep_hook
        self.slept_total = 0.0      # telemetry: virtual seconds napped

    def time(self) -> float:
        return self.now + self.skew

    def time_ns(self) -> int:
        return int((self.now + self.skew) * 1e9)

    def monotonic(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        if seconds > 0:
            self.now += seconds

    def sleep(self, seconds: float) -> None:
        if seconds <= 0:
            return
        self.slept_total += seconds
        if self.sleep_hook is not None:
            self.sleep_hook(seconds)
        else:
            self.now += seconds
