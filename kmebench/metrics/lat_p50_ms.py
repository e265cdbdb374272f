"""lat_p50_ms: the median, over every message due in the window, of the
time from its due time on the mix's schedule to the consumer's receipt
of its closing OUT record, in milliseconds; a message never answered
counts as answered when the consumer gave up."""

from kmebench.measure import percentile


def read(run):
    if run.lat is None or not len(run.lat):
        return None
    return percentile(run.lat, 50) * 1e3
