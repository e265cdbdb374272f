"""tcp.handler_cpu_pct.steady: the CPU the TCP handler threads took
(bridge/tcp.py: decode, broker call, encode and write of every request,
on the thread's own CPU clock, so a fetch's blocking wait is left out):
the window's gain of the program's cumulative `tcp_handler_cpu_s`
gauge, all ops, over the window's seconds, in percent."""

from kmebench.measure import gauge_delta


def read(run):
    d = gauge_delta(run.m0, run.m1, "tcp_handler_cpu_s")
    if d is None:
        return None
    return 100.0 * d / run.seconds
