"""runtime.gc_pause_pct.steady: the share of the window in which the
interpreter's collections stopped every thread of the server process:
the window's gain of the program's cumulative `gc_pause_s` gauge
(telemetry/trace.py GcWatch) over the window's seconds, in percent.

The gauge's gain between the two scrapes also holds the collections
between the first scrape and the window's start, where the harness
collects once on purpose. Those are taken out by the program's own
`gc` spans, one per collection counted, in order: the collections
past the first scrape's `gc_collections_total` that start before the
window (or at or after its end) are subtracted."""

from kmebench.measure import gauge_delta


def read(run):
    d = gauge_delta(run.m0, run.m1, "gc_pause_s")
    if d is None:
        return None
    if run.spans is not None:
        n0 = int(run.m0["gauges"].get("gc_collections_total", 0))
        n1 = int(run.m1["gauges"].get("gc_collections_total", 0))
        gcs = sorted((a, b) for trk, _n, a, b in run.spans if trk == "gc")
        if len(gcs) >= n1:
            d -= sum(b - a for a, b in gcs[n0:n1]
                     if a < run.t0 or a >= run.t1)
    return 100.0 * d / run.seconds
