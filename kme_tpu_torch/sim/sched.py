"""The seeded virtual-clock scheduler: the sim's single source of time
and interleaving.

A ``SimScheduler`` is a priority queue of ``(vtime, seq, fn)`` events
over one virtual ``now``. ``seq`` is a monotonic insertion counter —
the tie-break for same-instant events is insertion order, never object
identity or hash order, which is what makes a run replayable.

Actors are plain objects with a ``step() -> bool`` method ("did any
work"). ``add_actor`` wraps each in a pump: after every step the actor
is re-scheduled ``quantum * (0.5 + rng.random())`` virtual seconds out
(``idle_quantum`` when it did nothing), so the seeded RNG decides the
interleaving — two seeds explore two schedules, one seed explores
exactly one, every time.

Virtual sleeps: each actor sees time through a ``SimClockView``
(``bridge/clock.Clock``). A component that naps for backoff
(``clock.sleep`` inside a service retry loop) charges the nap to the
CURRENT actor's next wake-up instead of blocking the process —
simulated milliseconds, not real ones. ``clock.skew`` (the fault
point) steps a view's wall offset without touching its monotonic
domain, like NTP on a real host.

The event trace: ``trace(actor, kind, **fields)`` appends a
deterministic tuple (virtual time, actor, kind, sorted fields) to
``events``; ``digest()`` is the sha256 over their canonical reprs.
Byte-identical digests across two runs of the same seed is the
determinism acceptance gate, so NOTHING wall-clock-derived may ever be
traced.
"""

from __future__ import annotations

import hashlib
import heapq
import random
from typing import Callable, List, Optional, Tuple

from kme_tpu_torch.bridge.clock import Clock


class SimClockView(Clock):
    """One actor's view of virtual time: shared ``now``, private skew."""

    def __init__(self, sched: "SimScheduler") -> None:
        self.sched = sched
        self.skew = 0.0

    def time(self) -> float:
        return self.sched.now + self.skew

    def time_ns(self) -> int:
        return int((self.sched.now + self.skew) * 1e9)

    def monotonic(self) -> float:
        return self.sched.now

    def sleep(self, seconds: float) -> None:
        # charged to the current actor's next wake-up by the pump
        if seconds > 0:
            self.sched.sleep_charge += seconds


class SimScheduler:
    def __init__(self, seed: int, quantum: float = 0.001,
                 idle_quantum: float = 0.005) -> None:
        self.seed = int(seed)
        self.now = 0.0
        self.quantum = quantum
        self.idle_quantum = idle_quantum
        # independent deterministic stream, insensitive to other
        # consumers of the seed (schedule generator, workload)
        self.rng = random.Random((self.seed, "sim-sched").__repr__())
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = 0
        self.sleep_charge = 0.0     # virtual sleeps of the running actor
        self.events: List[tuple] = []
        self.stopped = False
        self._actors: List[str] = []

    # -- event queue ---------------------------------------------------

    def post(self, delay: float, fn: Callable[[], None]) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (self.now + max(0.0, delay),
                                    self._seq, fn))

    def add_actor(self, name: str, actor, quantum: Optional[float] = None,
                  idle_quantum: Optional[float] = None) -> None:
        """Schedule `actor.step()` pumps under seeded jitter until
        `actor.stopped` goes true (the pump simply stops rescheduling —
        a crashed actor's queued wake-up is a no-op)."""
        q = self.quantum if quantum is None else quantum
        iq = self.idle_quantum if idle_quantum is None else idle_quantum
        self._actors.append(name)

        def pump() -> None:
            if self.stopped or getattr(actor, "stopped", False):
                return
            self.sleep_charge = 0.0
            busy = actor.step()
            base = q if busy else iq
            delay = base * (0.5 + self.rng.random()) + self.sleep_charge
            self.post(delay, pump)

        self.post(q * (0.5 + self.rng.random()), pump)

    # -- the loop ------------------------------------------------------

    def run(self, until: Callable[[], bool],
            max_vtime: float = 3600.0) -> None:
        """Pop events in (vtime, seq) order until `until()` is true,
        the queue drains, or virtual `max_vtime` passes (the runaway
        backstop — a sim that needs an hour of virtual time is wedged,
        and determinism means a wedge is a reproducible verdict, not a
        flaky timeout)."""
        while self._heap and not self.stopped:
            if until():
                break
            vtime, _seq, fn = heapq.heappop(self._heap)
            if vtime > self.now:
                self.now = vtime
            if self.now > max_vtime:
                self.trace("sim", "wedged", vtime=round(self.now, 6))
                break
            fn()

    # -- the deterministic event trace ---------------------------------

    def trace(self, actor: str, kind: str, **fields) -> None:
        self.events.append((round(self.now, 9), actor, kind,
                            tuple(sorted(fields.items()))))

    def digest(self) -> str:
        h = hashlib.sha256()
        for ev in self.events:
            h.update(repr(ev).encode("utf-8"))
            h.update(b"\n")
        return h.hexdigest()
