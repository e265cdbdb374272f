"""Phase timing spans + Chrome trace-event export.

PhaseTimer replaces the per-session `time.perf_counter()` blocks that
were triplicated across runtime/session.py, runtime/seqsession.py, and
parallel/seqmesh.py. Its `totals` dict IS the session's `phases`
attribute (same object, assigned once), and — unlike the old code —
totals ACCUMULATE across batches; callers snapshot/reset explicitly.

When a TraceRecorder is installed (module-global via install(), as
`kme-serve --trace-out` and `bench --trace-out` do), every phase span
is also emitted as a Chrome trace event; save() writes the standard
{"traceEvents": [...]} JSON that chrome://tracing / Perfetto load
directly.

GcWatch counts the interpreter's collections where they happen (a
`gc.callbacks` hook): cumulative pause seconds, collections, full
collections and a pause histogram for the registry, and one span per
collection on the `gc` track.
"""

from __future__ import annotations

import collections
import gc
import json
import os
import threading
import time


class TraceRecorder:
    """Collects Chrome trace-event "X" (complete) events.

    Timestamps are microseconds relative to recorder creation; `tid`
    groups events into named rows (one per session/component).

    A complete event is kept as a tuple and made into its dict when the
    events are read: recording sits on the serve loop's path, between
    its spans. Appends need no lock (one list append); the lock guards
    a new track's id. A collection of the interpreter may record a span
    (GcWatch) in the middle of any other call here, on the same thread:
    the lock is re-entrant, and the readers copy before they iterate."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self._mono0 = time.clock_gettime(time.CLOCK_MONOTONIC)
        self._pid = os.getpid()
        self._lock = threading.RLock()
        # (name, start_s, dur_s, tid, args) for a complete event, the
        # event's dict for the others
        self._events = []
        self._tids: dict = {}

    def _tid(self, track: str) -> int:
        t = self._tids.get(track)
        if t is None:
            with self._lock:
                t = self._tids.get(track)
                if t is None:
                    t = len(self._tids)
                    self._tids[track] = t
        return t

    def add(self, name: str, start_s: float, dur_s: float,
            track: str = "main", args: dict | None = None) -> None:
        self._events.append((name, start_s, dur_s, self._tid(track),
                             args or None))

    def flow(self, name: str, phase: str, flow_id: int,
             track: str = "main", at_s: float | None = None) -> None:
        """Chrome trace FLOW event: ph "s" starts arrow `flow_id`, ph
        "f" finishes it — the renderer draws a causality arrow from the
        span enclosing the start to the span enclosing the finish
        (bp="e": bind to the enclosing slice). Links an order batch's
        submit/engine span to its produce span across tracks."""
        if phase not in ("s", "f"):
            raise ValueError(f"flow phase must be 's' or 'f', "
                             f"got {phase!r}")
        t = at_s if at_s is not None else time.perf_counter()
        ev = {
            "name": name,
            "ph": phase,
            "cat": "flow",
            "id": int(flow_id),
            "ts": (t - self._t0) * 1e6,
            "pid": os.getpid(),
        }
        if phase == "f":
            ev["bp"] = "e"
        ev["tid"] = self._tid(track)
        self._events.append(ev)

    def instant(self, name: str, track: str = "main",
                args: dict | None = None) -> None:
        ev = {
            "name": name,
            "ph": "i",
            "ts": (time.perf_counter() - self._t0) * 1e6,
            "pid": os.getpid(),
            "s": "t",
        }
        ev["tid"] = self._tid(track)
        if args:
            ev["args"] = args
        self._events.append(ev)

    def trace_events(self) -> list:
        with self._lock:
            tids = self._tids.copy()
        events = self._events.copy()
        out = [
            {"name": "thread_name", "ph": "M", "pid": os.getpid(),
             "tid": tid, "args": {"name": track}}
            for track, tid in tids.items()
        ]
        t0, pid = self._t0, self._pid
        for ev in events:
            if type(ev) is tuple:
                name, start_s, dur_s, tid, args = ev
                ev = {"name": name, "ph": "X", "ts": (start_s - t0) * 1e6,
                      "dur": dur_s * 1e6, "pid": pid, "tid": tid}
                if args:
                    ev["args"] = args
            out.append(ev)
        return out

    def origin_us(self, at_s: float) -> float:
        """A perf_counter() time on this recorder's timeline (µs)."""
        return (at_s - self._t0) * 1e6

    def save(self, path: str) -> None:
        # the origin on both clocks, so other timelines (a device trace,
        # a client's stamps) can be laid beside this one
        doc = {"traceEvents": self.trace_events(),
               "displayTimeUnit": "ms",
               "otherData": {"origin_perf_counter_s": self._t0,
                             "origin_monotonic_s": self._mono0}}
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        os.replace(tmp, path)


# module-global recorder: CLI entry points install one so every
# PhaseTimer in the process emits trace events without plumbing
_tracer: TraceRecorder | None = None


def install(recorder: TraceRecorder | None) -> None:
    global _tracer
    _tracer = recorder


def get_tracer() -> TraceRecorder | None:
    return _tracer


class PhaseTimer:
    """Accumulating span timer.

    `totals` maps phase name -> cumulative seconds across every span
    since the last reset(). Sessions expose it directly as
    `self.phases`.

    `batch`, when set, is the ordinal of the batch the spans belong to:
    each span records it as `args["batch"]` when it ends, so the spans
    of one batch join across tracks even when its collect runs steps
    after its submit."""

    def __init__(self, track: str = "main"):
        self.totals: dict = {}
        self.track = track
        self.batch = None

    def phase(self, name: str, **args) -> "_Phase":
        """`with timer.phase(name, **args):` times one span."""
        return _Phase(self, name, args)

    def add(self, name: str, seconds: float) -> None:
        """Fold an externally-timed duration into the totals."""
        self.totals[name] = self.totals.get(name, 0.0) + seconds

    def reset(self) -> None:
        self.totals.clear()


class _Phase:
    """One span of a PhaseTimer (a plain context manager: it sits on
    the serve loop's path, between its spans)."""

    __slots__ = ("timer", "name", "args", "t0")

    def __init__(self, timer: PhaseTimer, name: str, args: dict) -> None:
        self.timer = timer
        self.name = name
        self.args = args

    def __enter__(self) -> "_Phase":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter() - self.t0
        timer, name = self.timer, self.name
        timer.totals[name] = timer.totals.get(name, 0.0) + dt
        tr = _tracer
        if tr is not None:
            args = self.args
            if timer.batch is not None:
                args["batch"] = timer.batch
            tr.add(name, self.t0, dt, timer.track, args)
        return False


class GcWatch:
    """The interpreter's collections, counted where they happen.

    A `gc.callbacks` hook: cumulative pause seconds, collections and
    full (generation 2) collections, and each pause for the
    `lat_gc_pause` histogram; with a recorder installed, each collection
    is a span on its own `gc` track (a pause stops every thread, so no
    other track can hold it) with its generation in `args`.

    The hook runs inside whatever allocation set the collection off, on
    any thread, so it takes no lock: `publish` moves its tallies into a
    registry on the reading thread (a registry collector, so every
    scrape reads them current). One per process: `kme-torch-serve`
    installs it and takes it out at exit."""

    def __init__(self) -> None:
        self.pause_s = 0.0
        self.collections = 0
        self.full_collections = 0
        self._pending = collections.deque()   # pauses not yet published
        self._start = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._start = time.perf_counter()
            return
        t0, self._start = self._start, None
        if t0 is None:
            return
        dt = time.perf_counter() - t0
        gen = info.get("generation", -1)
        self.pause_s += dt
        self.collections += 1
        if gen == 2:
            self.full_collections += 1
        self._pending.append(dt)
        tr = _tracer
        if tr is not None:
            tr.add("gc", t0, dt, track="gc", args={"gen": gen})

    def install(self) -> "GcWatch":
        if self not in gc.callbacks:
            gc.callbacks.append(self)
        return self

    def uninstall(self) -> None:
        if self in gc.callbacks:
            gc.callbacks.remove(self)

    def publish(self, registry) -> None:
        """Cumulative gauges (window deltas read them like `plan_s`) and
        the pauses since the last call into `lat_gc_pause`."""
        registry.gauge("gc_pause_s", "cumulative seconds the interpreter's "
                       "collections stopped every thread").set(
            round(self.pause_s, 6))
        registry.gauge("gc_collections_total",
                       "collections of the interpreter").set(
            self.collections)
        registry.gauge("gc_full_collections_total",
                       "full (generation 2) collections").set(
            self.full_collections)
        pend = self._pending
        pauses = [pend.popleft() for _ in range(len(pend))]
        hist = registry.latency("lat_gc_pause",
                                "pause of one collection of the "
                                "interpreter")
        if pauses:
            hist.observe_many(pauses)
