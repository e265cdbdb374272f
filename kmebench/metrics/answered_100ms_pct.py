"""answered_100ms_pct: the share of the messages due in the window whose
closing OUT record reached the consumer within 100 ms of their due time
on the open-loop schedule, in percent; a message never answered is not
within. No public source fixes the 100 ms: it lies above the batch
cycle that sets the median and below the collector's pauses that set
the tail (PERF.md), and `lat_p50_ms` and `lat_p99_ms` stand beside it."""

from kmebench.measure import share_within


def read(run):
    if run.lat is None or not len(run.lat):
        return None
    return share_within(run.lat, 0.100) * 100.0
