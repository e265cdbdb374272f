"""ingress.wait_p99_ms.steady: p99 of the orders' wait from broker
admission to the serve loop's fetch (bridge/broker.py to the service,
the queue): the window's gain of the service's `lat_ingress` histogram
on /metrics.json, in milliseconds."""

from kmebench.spans import hist_p99_ms


def read(run):
    return hist_p99_ms(run, "lat_ingress")
