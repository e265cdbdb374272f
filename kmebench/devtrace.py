"""The traced run's device side: a `torch.profiler` window around the
measured seconds, read from its Chrome trace, and the reduction of device
intervals and the serve spans to busy time, kernel time by name and idle
time by what the host was doing.

All times here are seconds on the monotonic clock that the generator and
the consumer stamp with. The profiler's timeline is tied to it by a
`record_function` marker that the harness opens at a known time; the
serve spans (`kme_tpu_torch.telemetry.TraceRecorder`) are tied to it by
the recorder's creation time.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

MARKER = "kmebench.window"
# trace categories of device activity (lower-cased)
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset"}
# the seq engine's kernels (csrc/seq_step.cu), matched in kernel names
SEQ_KERNELS = ("seq_scan", "rows_in_use")
BIN_S = 10e-6     # resolution of the idle-time attribution


def perf_offset() -> float:
    """perf_counter() - monotonic(), for spans timed by perf_counter."""
    return time.perf_counter() - time.monotonic()


class ProfilerWindow:
    """torch.profiler from `start()` to `stop()`, with the anchor."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.anchor: Optional[float] = None
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        with record_function(MARKER):
            self.anchor = time.monotonic()

    def stop(self) -> None:
        self._prof.stop()
        self._prof.export_chrome_trace(self.path)
        self._prof = None


def load_trace(path: str, anchor: float) -> List[Tuple[str, float, float]]:
    """Device intervals (name, start, end) on the monotonic clock."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    evs = doc["traceEvents"] if isinstance(doc, dict) else doc
    mark = None
    dev = []
    for ev in evs:
        if ev.get("ph") != "X":
            continue
        cat = str(ev.get("cat", "")).lower()
        if cat in DEVICE_CATS:
            ts = float(ev["ts"])
            dev.append((ev.get("name", "?"), ts, ts + float(ev.get("dur",
                                                                    0))))
        elif ev.get("name") == MARKER and mark is None:
            mark = float(ev["ts"])
    if mark is None:
        raise ValueError("the profiler trace lacks the window marker")
    shift = anchor - mark * 1e-6
    return [(n, a * 1e-6 + shift, b * 1e-6 + shift) for n, a, b in dev]


def clip(iv, t0: float, t1: float):
    return [(n, max(a, t0), min(b, t1)) for n, a, b in iv
            if b > t0 and a < t1]


def union_seconds(iv) -> float:
    """Length of the union of intervals."""
    total, end = 0.0, -np.inf
    for _n, a, b in sorted(iv, key=lambda x: x[1]):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def by_name(iv) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for n, a, b in iv:
        out[n] = out.get(n, 0.0) + (b - a)
    return out


def seq_kernel_seconds(iv) -> float:
    return sum(b - a for n, a, b in iv
               if any(k in n for k in SEQ_KERNELS))


def idle_by_host(iv, spans, t0: float, t1: float) -> Dict[str, float]:
    """Device-idle seconds of [t0, t1) by the innermost serve span the
    host was in: the session's phases (`seq` track) inside the service's
    (`serve` track), else `outside_serve_spans` (the broker fetch, the
    TCP threads, the interpreter)."""
    nb = max(1, int(np.ceil((t1 - t0) / BIN_S)))
    busy = np.zeros(nb + 1, np.int32)
    for _n, a, b in iv:
        i, j = int((a - t0) / BIN_S), int(np.ceil((b - t0) / BIN_S))
        busy[max(i, 0)] += 1
        busy[min(j, nb)] -= 1
    idle = np.cumsum(busy)[:nb] == 0
    labels = ["outside_serve_spans"]
    lab = np.zeros(nb, np.int16)
    for track in ("serve", "seq"):     # inner spans paint over outer
        for trk, name, a, b in spans:
            if trk != track or b <= t0 or a >= t1:
                continue
            if name not in labels:
                labels.append(name)
            i = max(0, int((a - t0) / BIN_S))
            j = min(nb, int(np.ceil((b - t0) / BIN_S)))
            lab[i:j] = labels.index(name)
    counts = np.bincount(lab[idle], minlength=len(labels))
    return {labels[k]: float(c * BIN_S) for k, c in enumerate(counts) if c}


def spans_from_recorder(rec, rec_t0: float) -> List[tuple]:
    """(track, name, start, end) of a TraceRecorder's complete events,
    on the monotonic clock; `rec_t0` is the recorder's perf_counter
    origin taken as a monotonic time."""
    events = rec.trace_events()
    tracks = {ev["tid"]: ev["args"]["name"] for ev in events
              if ev.get("ph") == "M" and ev.get("name") == "thread_name"}
    out = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        a = rec_t0 + ev["ts"] * 1e-6
        out.append((tracks.get(ev["tid"], "?"), ev["name"], a,
                    a + ev["dur"] * 1e-6))
    return out
