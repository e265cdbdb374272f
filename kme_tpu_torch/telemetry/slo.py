"""Service-level objectives over the live latency surface.

The port's copy of `kme_tpu/telemetry/slo.py`.

An SLO here is "p99 of stage S stays under T ms" plus an optional
throughput floor, evaluated against the same LatencyHistograms the
/metrics scrape reads. Rather than alert on a single slow scrape, the
evaluator tracks an ERROR BUDGET: every observation slower than the
target is a bad event, the budget says what fraction of events may be
bad (e.g. 0.001 = 99.9 % must meet the target), and the BURN RATE is
how fast the budget is being consumed (bad_fraction / budget — burn 1.0
means the budget exactly runs out over the window; sustained burn > 1
means the objective will be missed).

The service calls `evaluate()` once per publish interval; the returned
reason string (or None) feeds the heartbeat `degraded` field the
supervisor already watches, so an SLO breach surfaces through the same
channel as an audit violation — no new control plane.

Everything is computed from counter DELTAS between evaluations, so a
startup spike ages out instead of poisoning the objective forever.
"""

from __future__ import annotations

import time

from kme_tpu_torch.telemetry.registry import Registry

# stages the serving pipeline stamps (service.py); "e2e" spans broker
# admission -> produce visible
STAGES = ("ingress", "plan", "device", "produce", "e2e", "consume")


class SLO:
    """One latency objective (+ optional throughput floor).

    Parameters
    ----------
    registry : the Registry holding the stage LatencyHistograms
    stage : which `lat_<stage>` histogram to watch (see STAGES)
    p99_ms : latency target — an observation over this is a bad event
    budget : allowed bad-event fraction (0.001 == "99.9 % under target")
    min_ops : minimum observations per window before judging (a quiet
        service is not a degraded service)
    min_records_per_s : optional throughput floor, measured from the
        `service_records` counter
    window_s : evaluation smoothing window; burn rate is computed over
        deltas at least this old
    """

    def __init__(self, registry: Registry, stage: str = "e2e",
                 p99_ms: float = 50.0, budget: float = 0.001,
                 min_ops: int = 100, min_records_per_s: float = 0.0,
                 window_s: float = 5.0, clock=time.monotonic):
        if stage not in STAGES:
            raise ValueError(f"unknown SLO stage {stage!r}; "
                             f"expected one of {STAGES}")
        self.registry = registry
        self.stage = stage
        self.p99_ms = float(p99_ms)
        self.budget = max(1e-9, float(budget))
        self.min_ops = int(min_ops)
        self.min_records_per_s = float(min_records_per_s)
        self.window_s = float(window_s)
        self._clock = clock
        # previous window edge: (t, total_count, bad_count, records)
        self._prev = None
        self.last_reason = None

    # -- current raw readings ------------------------------------------

    def _readings(self):
        hist = self.registry.latency(f"lat_{self.stage}")
        bad = hist.count_over(self.p99_ms * 1e-3)
        total = hist.count
        recs = self.registry.counter("service_records").value
        return total, bad, recs

    def evaluate(self) -> str | None:
        """Advance the window and return a degradation reason, or None.

        Also publishes `slo_burn_rate`, `slo_bad_events_total`,
        `slo_window_ops`, and `slo_ok` into the registry so the SLO
        state is scrapeable alongside the latencies it judges."""
        now = self._clock()
        total, bad, recs = self._readings()
        reg = self.registry
        reg.counter("slo_bad_events_total",
                    "observations over the SLO latency target").set(bad)
        if self._prev is None:
            self._prev = (now, total, bad, recs)
            reg.gauge("slo_ok", "1 while the SLO holds").set(1)
            return None
        t0, total0, bad0, recs0 = self._prev
        dt = now - t0
        if dt < self.window_s:
            return self.last_reason
        d_total = total - total0
        d_bad = bad - bad0
        d_recs = recs - recs0
        self._prev = (now, total, bad, recs)

        reason = None
        if d_total >= self.min_ops:
            bad_frac = d_bad / d_total
            burn = bad_frac / self.budget
            reg.gauge("slo_burn_rate",
                      "error-budget burn rate (1.0 = budget exactly "
                      "consumed over the window)").set(round(burn, 3))
            if burn > 1.0:
                reason = (f"slo burn {burn:.1f}x: "
                          f"{self.stage} p99>{self.p99_ms}ms for "
                          f"{bad_frac:.2%} of {d_total} ops "
                          f"(budget {self.budget:.2%})")
        reg.gauge("slo_window_ops",
                  "latency observations in the last SLO window").set(d_total)
        if (reason is None and self.min_records_per_s > 0
                and d_recs / dt < self.min_records_per_s and d_recs >= 0):
            reason = (f"slo throughput {d_recs / dt:.0f} rec/s below "
                      f"floor {self.min_records_per_s:.0f}")
        reg.gauge("slo_ok", "1 while the SLO holds").set(
            0 if reason else 1)
        self.last_reason = reason
        return reason

    def describe(self) -> dict:
        return {"stage": self.stage, "p99_ms": self.p99_ms,
                "budget": self.budget, "min_ops": self.min_ops,
                "min_records_per_s": self.min_records_per_s,
                "window_s": self.window_s}
