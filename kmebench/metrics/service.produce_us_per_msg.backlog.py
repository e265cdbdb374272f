"""service.produce_us_per_msg.backlog: seconds of the service's
`serve_produce` spans (bridge/service.py, MatchOut produced record by
record) inside the window, per message completed, in microseconds."""

from kmebench.spans import span_seconds


def read(run):
    n = run.completed()
    if run.spans is None or not n:
        return None
    s = span_seconds(run.spans, "serve", "serve_produce", run.t0, run.t1)
    return s / n * 1e6 if s > 0 else None
