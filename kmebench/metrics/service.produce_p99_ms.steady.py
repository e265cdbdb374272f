"""service.produce_p99_ms.steady: p99 over the orders of the MatchOut
produce time of their batch (bridge/service.py): the window's gain of
the `lat_produce` histogram, in milliseconds."""

from kmebench.spans import hist_p99_ms


def read(run):
    return hist_p99_ms(run, "lat_produce")
