"""wire.parse_us_per_msg.steady: seconds of the service's `serve_parse`
spans (bridge/service.py: the native columnar parse of a fetched batch,
`_parse_batch`) inside the window, per message completed, in
microseconds."""

from kmebench.spans import span_seconds


def read(run):
    n = run.completed()
    if run.spans is None or not n:
        return None
    s = span_seconds(run.spans, "serve", "serve_parse", run.t0, run.t1)
    return s / n * 1e6 if s > 0 else None
