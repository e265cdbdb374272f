"""device.idle_pct (read as `device.idle_pct.backlog` and
`device.idle_pct.steady`, one name for each end-to-end metric it moves):
the share of the window in which no kernel, copy or memset ran on the
card (the profiler's trace), in percent."""

from kmebench.devtrace import union_seconds


def read(run):
    if run.dev is None:
        return None
    return 100.0 * (1.0 - union_seconds(run.dev) / run.seconds)
