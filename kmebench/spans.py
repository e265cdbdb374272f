"""Readings of the program's own spans and counters over the window: the
serve spans (`PhaseTimer`, on the `serve` and `seq` tracks) and the
latency histograms of `/metrics.json`."""

from __future__ import annotations

from typing import Optional

from kmebench.measure import hist_quantile, latency_delta


def span_seconds(spans, track: str, name: str, t0: float,
                 t1: float) -> float:
    """Seconds of the named spans that fall inside [t0, t1)."""
    return sum(max(0.0, min(b, t1) - max(a, t0))
               for trk, n, a, b in spans if trk == track and n == name)


def hist_p99_ms(run, name: str) -> Optional[float]:
    """p99 (ms) of what a latency histogram of the program gained in the
    window, with the program's own bucket bounds."""
    from kme_tpu_torch.telemetry.registry import LAT_BOUNDS

    counts = latency_delta(run.m0, run.m1, name)
    if counts is None:
        return None
    q = hist_quantile(counts, LAT_BOUNDS, 0.99)
    return None if q is None else q * 1e3
