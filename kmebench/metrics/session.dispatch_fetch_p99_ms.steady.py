"""session.dispatch_fetch_p99_ms.steady: p99 over the orders of the
device stage (runtime/seqsession.py stage, dispatch and the fetch's
wait): the window's gain of the `lat_device` histogram, in
milliseconds."""

from kmebench.spans import hist_p99_ms


def read(run):
    return hist_p99_ms(run, "lat_device")
