"""session.plan_us_per_msg.backlog: the service's cumulative `plan_s`
gauge (native plan and runtime/seqsession.py routing; the java router is
Python) gained over the window, per message completed, in
microseconds."""

from kmebench.measure import gauge_delta


def read(run):
    n = run.completed()
    d = gauge_delta(run.m0, run.m1, "plan_s")
    if d is None or d <= 0 or not n:
        return None
    return d / n * 1e6
