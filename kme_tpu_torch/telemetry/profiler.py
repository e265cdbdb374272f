"""Always-on continuous profiling — host, device, and trigger planes.

The port's copy of `kme_tpu/telemetry/profiler.py`, with the device
plane and the trigger capture's device window rewritten for the card.

Following the Google-Wide Profiling discipline (Ren et al., IEEE Micro
2010; PAPERS.md), profiling here is not a tool you attach when things
are already broken: it runs continuously at negligible overhead, its
output is retained (the TSDB, telemetry/tsdb.py), and regressions are
answered from history instead of reproduced under a debugger.

Three planes:

1. HOST — `StageProfiler`, a sampling wall-clock profiler. A daemon
   thread samples every live Python stack ~200x/s and attributes each
   sample to one of the serving-pipeline stages (parse / plan /
   dispatch / collect / produce, by function name: STAGE_FUNCS);
   everything else is `other`. Per-stage sample fractions publish as
   `prof_stage_frac_<stage>` gauges, so they ride the heartbeat into the
   TSDB and kme-torch-prof reads them across windows.

2. DEVICE — `device_plane()` reads the card itself: the seq kernel's
   own time per dispatch from the session's CUDA events, the bytes one
   dispatch must move (`engine/seq.py` `dispatch_bytes`, the count the
   kernel table's byte bound uses), and a measured H2D bandwidth
   (pinned host memory to the card, CUDA events). It folds in the
   session's live `h2d_overlap_frac` / `stage_s` advisories. The result
   is a per-backend transfer-vs-compute JSON artifact
   (`write_transfer_artifact`) — merged by backend key, so a "cuda"
   entry leaves the "cpu"/"tpu" entries other runs wrote untouched.
   There is no flops count: the JAX package took it from XLA's
   `cost_analysis()`, and no compiler reports one here.

3. TRIGGER — `TriggerCapture`. SLO burn (slo.py's degradation reason)
   or a p99 exemplar past a threshold auto-records a bounded capture:
   the installed Chrome-trace recorder's current window plus the
   exemplar trace ids, written as `capture_NNN.json`, and, when a
   window is asked for, a `torch.profiler` trace of the card's kernels
   beside it. The span ids are the same deterministic `tid`s the
   journal records, so a capture links straight into `kme-torch-trace`
   waterfalls. Cooldown + max-capture bounds keep a sustained burn from
   turning the profiler into the incident.

The profiler reads wall clocks by design — it measures the serve loop,
it never participates in replay/recovery.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Dict, Optional

# stage attribution tables: function names (f_code.co_name) that mark a
# sample as belonging to a serving-pipeline stage: the JAX package's
# names, plus the port's own where they differ (the seq session's
# `_dispatch` / `seq_scan` and `_fetch`)
STAGE_FUNCS: Dict[str, tuple] = {
    "parse": ("_parse_batch", "_parse", "parse_order", "decode_frames"),
    "plan": ("_plan", "plan_batch", "pack_msgs", "route_line"),
    "dispatch": ("submit", "_stage_and_dispatch", "dispatch",
                 "build_seq_scan", "call_scan", "_dispatch", "seq_scan"),
    "collect": ("collect", "_collect_one", "_fetch_outputs", "_run",
                "_drain_pipeline", "_fetch"),
    "produce": ("_produce_out", "_produce_buffer", "_produce_xfer",
                "produce_batch", "produce_frames", "record_batch"),
}

PROF_STAGES = tuple(STAGE_FUNCS) + ("other",)

_FUNC_TO_STAGE = {fn: stage
                  for stage, fns in STAGE_FUNCS.items() for fn in fns}

# the record_function marker a capture's profiler window opens with
CAPTURE_MARKER = "kme.capture"


class StageProfiler:
    """Sampling host profiler attributing wall time to pipeline stages.

    A daemon thread walks `sys._current_frames()` every `interval_s`
    seconds; each thread's stack is attributed to the INNERMOST frame
    whose function name appears in STAGE_FUNCS (idle/unrelated stacks
    are ignored entirely, so fractions describe time spent inside the
    serving pipeline). Registry publication is cheap gauges only — the
    profiler never touches device state or takes foreign locks."""

    def __init__(self, registry=None, interval_s: float = 0.005):
        self.registry = registry
        self.interval_s = max(0.001, float(interval_s))
        self.samples: Dict[str, int] = {s: 0 for s in PROF_STAGES}
        self.total = 0              # samples that hit ANY stage scope
        self.wall_samples = 0       # sampler wakeups
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._own_ident: Optional[int] = None

    # -- sampling -------------------------------------------------------

    def _classify(self, frame) -> Optional[str]:
        while frame is not None:
            stage = _FUNC_TO_STAGE.get(frame.f_code.co_name)
            if stage is not None:
                return stage
            frame = frame.f_back
        return None

    def sample_once(self) -> None:
        self.wall_samples += 1
        frames = sys._current_frames()
        for ident, frame in frames.items():
            if ident == self._own_ident:
                continue
            stage = self._classify(frame)
            if stage is not None:
                self.samples[stage] += 1
                self.total += 1

    def _loop(self) -> None:
        self._own_ident = threading.get_ident()
        n = 0
        while not self._stop.wait(self.interval_s):
            self.sample_once()
            n += 1
            if self.registry is not None and n % 64 == 0:
                self.publish(self.registry)

    def start(self) -> "StageProfiler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="kme-torch-prof-sampler", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self.registry is not None:
            self.publish(self.registry)

    # -- reporting ------------------------------------------------------

    def stage_fractions(self) -> Dict[str, float]:
        """{stage: fraction of in-pipeline samples} (0.0 when quiet)."""
        t = self.total
        return {s: (self.samples[s] / t if t else 0.0)
                for s in PROF_STAGES if s != "other"}

    def publish(self, registry) -> None:
        registry.gauge(
            "prof_samples_total",
            "host profiler samples attributed to a pipeline stage"
        ).set(self.total)
        registry.gauge(
            "prof_wall_samples_total",
            "host profiler sampler wakeups").set(self.wall_samples)
        for stage, frac in self.stage_fractions().items():
            registry.gauge(
                f"prof_stage_frac_{stage}",
                f"fraction of in-pipeline wall samples in the "
                f"{stage} stage").set(round(frac, 4))


# -- device plane -----------------------------------------------------------


H2D_PROBE_BYTES = 8 << 20

# what a plane carries only when it measured a card
CARD_FIELDS = ("device_name", "kernel", "probe_bytes", "h2d_bytes_per_s", "transfer_s_per_batch",
               "kernel_ms_per_dispatch", "dispatches_timed",
               "bytes_per_batch", "dispatches_probed", "h2d_overlap_frac",
               "h2d_stage_s", "transfer_compute_ratio")


def _measure_h2d_bytes_per_s(device, probe_bytes: int = H2D_PROBE_BYTES,
                             repeats: int = 3) -> float:
    """Host->card copy bandwidth: a pinned host buffer copied to
    `device`, timed with CUDA events, best of `repeats`. Raises when the
    card cannot be measured."""
    import torch

    host = torch.zeros(probe_bytes // 4, dtype=torch.int32,
                       pin_memory=True)
    dev = torch.empty(host.shape, dtype=torch.int32, device=device)
    best = None
    for _ in range(repeats):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        dev.copy_(host, non_blocking=True)
        e1.record()
        e1.synchronize()
        ms = e0.elapsed_time(e1)
        if ms > 0 and (best is None or ms < best):
            best = ms
    if best is None:
        raise RuntimeError("H2D probe: no copy took measurable time")
    return probe_bytes / (best * 1e-3)


def device_plane(session=None) -> dict:
    """Transfer-vs-compute characterization of one serving run.

    The backend is the session's device ("cpu" without a session: the
    host engines use no card). On the card the plane holds the measured
    H2D bandwidth and, for a session that timed its dispatches
    (`SeqSession.enable_device_plane`), the kernel's CUDA-event ms per
    dispatch and the bytes per dispatch (`bytes_per_batch`, from
    `engine/seq.py` `dispatch_bytes`), with `transfer_s_per_batch` =
    those bytes over the H2D bandwidth; the session's
    `h2d_overlap_frac` and `stage_s` fold in as in the JAX package. A
    card plane measures or raises: a session that asked for timing but
    timed no dispatch raises ValueError. A CPU plane carries none of
    CARD_FIELDS. No flops: there is no compiler cost model."""
    dev = getattr(session, "device", None)
    backend = dev.type if dev is not None else "cpu"
    doc: dict = {"backend": backend}
    if backend != "cuda":
        return doc
    import torch

    doc["device_name"] = torch.cuda.get_device_name(dev)
    doc["probe_bytes"] = H2D_PROBE_BYTES
    h2d = _measure_h2d_bytes_per_s(dev)
    doc["h2d_bytes_per_s"] = round(h2d, 1)
    timing = getattr(session, "device_timing", None)
    if timing is not None:
        t = timing()
        if t is not None:
            if not t["dispatches_timed"]:
                raise ValueError("device plane: the session timed no "
                                 "dispatch on the card")
            doc.update(t)
            if t.get("bytes_per_batch"):
                # the autotuner's ratio: seconds moving one batch's
                # bytes over the host link vs the kernel's own time
                doc["transfer_s_per_batch"] = round(
                    t["bytes_per_batch"] / h2d, 9)
    ov = getattr(session, "h2d_overlap_frac", None)
    if ov:
        doc["h2d_overlap_frac"] = ov
    phases = getattr(session, "phases", None) or {}
    stage_s = phases.get("stage_s")
    if stage_s:
        doc["h2d_stage_s"] = round(stage_s, 6)
    disp = phases.get("dispatch_s", 0.0) + phases.get("fetch_s", 0.0)
    if stage_s and disp:
        doc["transfer_compute_ratio"] = round(stage_s / disp, 4)
    return doc


def write_transfer_artifact(path: str, plane: dict) -> dict:
    """Merge one backend's device plane into the per-backend artifact
    IN PLACE: `{backend: {...}}` keyed by backend name, other backends'
    recorded ratios untouched (a card run writes only "cuda"; the JAX
    package's "cpu"/"tpu" entries stay). Returns the full document."""
    doc = {}
    try:
        with open(path) as f:
            loaded = json.load(f)
        if isinstance(loaded, dict):
            doc = loaded
    except (OSError, ValueError):
        pass
    entry = dict(plane)
    backend = entry.pop("backend", "unknown")
    entry["recorded_at"] = time.time()
    doc[backend] = entry
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return doc


def read_transfer_artifact(path: str) -> dict:
    """The per-backend artifact, `{backend: plane}` (ROADMAP item-4
    autotuner input). Raises on a missing/undecodable file — consumers
    must know the ratio is absent, not silently assume one."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: transfer artifact must be a dict")
    return doc


# -- trigger-based capture --------------------------------------------------


class TriggerCapture:
    """Bounded auto-capture on SLO burn or a slow p99 exemplar.

    `maybe_fire(reason, exemplars)` is called from the serve loop's
    rate-limited publish path. When armed (cooldown elapsed, budget
    left) and either `reason` is set or an exemplar's `e2e_us` exceeds
    `p99_us`, one capture lands in `out_dir`:

    - `capture_NNN.json` — trigger metadata plus the exemplar list;
      each exemplar's deterministic `tid` resolves through
      `kme-torch-trace --cluster --order AID:OID` to a full waterfall;
    - the process-global Chrome-trace recorder's events at capture
      time (when one is installed via --trace-out) — the bounded
      "what was the engine doing" window;
    - with `window_s` > 0, a `torch.profiler` window (CPU and, where
      there is a card, CUDA activity) of the next `window_s` seconds of
      serving, exported as a Chrome trace `capture_NNN.torch.json`
      beside the document (key "device_trace"). The window does not
      block the serve loop: it closes at the first `maybe_fire` (or
      `close`) after it has run its time. It opens with a
      `kme.capture` marker; with a recorder installed, the marker's
      time on the recorder's timeline (µs from its origin) is the
      document's `device_trace_anchor_us`, so the recorder's spans lay
      over the device trace: shift them by the marker's `ts` less the
      anchor.
    """

    def __init__(self, out_dir: str, p99_us: Optional[int] = None,
                 cooldown_s: float = 30.0, max_captures: int = 4,
                 window_s: float = 0.0, registry=None):
        self.out_dir = out_dir
        self.p99_us = p99_us
        self.cooldown_s = float(cooldown_s)
        self.max_captures = int(max_captures)
        self.window_s = float(window_s)
        self.registry = registry
        self.captures = 0
        self._last_fire = -float("inf")
        # (profiler, trace path, monotonic end) of the open window
        self._window = None

    def _why(self, reason, exemplars) -> Optional[dict]:
        if reason:
            return {"trigger": "slo_burn", "reason": reason}
        if self.p99_us is not None:
            for ex in exemplars or ():
                if int(ex.get("e2e_us", 0)) > self.p99_us:
                    return {"trigger": "p99_exemplar",
                            "threshold_us": self.p99_us,
                            "e2e_us": int(ex["e2e_us"])}
        return None

    def maybe_fire(self, reason: Optional[str], exemplars) -> Optional[str]:
        """Returns the capture path when one fired, else None."""
        self._poll_window()
        if self.captures >= self.max_captures:
            return None
        now = time.monotonic()
        if now - self._last_fire < self.cooldown_s:
            return None
        why = self._why(reason, exemplars)
        if why is None:
            return None
        self._last_fire = now
        self.captures += 1
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir,
                            f"capture_{self.captures:03d}.json")
        doc = {"time": time.time(), **why,
               "exemplars": [dict(ex) for ex in (exemplars or ())],
               # tid is the journal's span key: kme-torch-trace joins it
               "resolve_with": "kme-torch-trace --order AID:OID "
                               "(or --cluster for grouped runs)"}
        from kme_tpu_torch.telemetry.trace import get_tracer

        tracer = get_tracer()
        if tracer is not None:
            doc["trace_events"] = tracer.trace_events()
        if self.window_s > 0 and self._window is None:
            doc["device_trace"] = path[:-5] + ".torch.json"
            at = self._open_window(doc["device_trace"])
            if tracer is not None:
                doc["device_trace_anchor_us"] = tracer.origin_us(at)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        if self.registry is not None:
            self.registry.gauge(
                "prof_captures_total",
                "trigger-fired profile captures").set(self.captures)
        return path

    def _open_window(self, trace_path: str) -> float:
        """Start the profiler window; -> the perf_counter() time of its
        `kme.capture` marker."""
        import torch
        from torch.profiler import (ProfilerActivity, profile,
                                    record_function)

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        with record_function(CAPTURE_MARKER):
            at = time.perf_counter()
        self._window = (prof, trace_path,
                        time.monotonic() + self.window_s)
        return at

    def _poll_window(self, force: bool = False) -> Optional[str]:
        """End the open profiler window once its time is up (or now,
        with `force`) and export its trace. -> the trace path."""
        if self._window is None:
            return None
        prof, path, until = self._window
        if not force and time.monotonic() < until:
            return None
        self._window = None
        prof.stop()
        prof.export_chrome_trace(path)
        return path

    def close(self) -> Optional[str]:
        """End and export an open profiler window (serve shutdown)."""
        return self._poll_window(force=True)


# ---------------------------------------------------------------------------
# capture reader (kme-torch-prof --captures): TriggerCapture and xray
# watchpoint captures share the capture_NNN.json namespace and doc shape


def list_captures(dir_path: str) -> list:
    """capture_NNN.json paths in a capture directory, index order."""
    import re

    pat = re.compile(r"^capture_(\d+)\.json$")
    try:
        names = os.listdir(dir_path)
    except OSError:
        return []
    out = []
    for n in names:
        m = pat.match(n)
        if m:
            out.append((int(m.group(1)), os.path.join(dir_path, n)))
    return [p for _i, p in sorted(out)]


def format_capture(path: str) -> str:
    """One capture doc as human-readable lines."""
    with open(path) as f:
        doc = json.load(f)
    when = time.strftime("%Y-%m-%d %H:%M:%S",
                         time.localtime(doc.get("time", 0)))
    trig = doc.get("trigger", "?")
    head = f"{os.path.basename(path)}  {when}  trigger={trig}"
    if trig == "watchpoint":
        head += (f"  predicate={doc.get('predicate')!r}"
                 f"  offset={doc.get('offset')}"
                 f"  value={doc.get('value')}")
    elif trig == "slo_burn":
        head += f"  reason={doc.get('reason')}"
    elif trig == "p99_exemplar":
        head += (f"  e2e_us={doc.get('e2e_us')}"
                 f"  threshold_us={doc.get('threshold_us')}")
    lines = [head]
    for ex in doc.get("exemplars") or []:
        lines.append(
            f"  exemplar off={ex.get('off')} oid={ex.get('oid')} "
            f"aid={ex.get('aid')} e2e_us={ex.get('e2e_us')} "
            f"tid={ex.get('tid')}")
    if doc.get("trace_events") is not None:
        lines.append(f"  trace events: {len(doc['trace_events'])}")
    if doc.get("device_trace"):
        lines.append(f"  device trace: {doc['device_trace']}")
    if doc.get("device_trace_anchor_us") is not None:
        lines.append(f"  device trace anchor: {CAPTURE_MARKER} at "
                     f"{doc['device_trace_anchor_us']:.1f} us on the "
                     f"trace recorder's timeline")
    if doc.get("repro"):
        lines.append(f"  repro: {doc['repro']}")
    if doc.get("resolve_with"):
        lines.append(f"  resolve: {doc['resolve_with']}")
    return "\n".join(lines)
