"""kernel.us_per_msg (read as `kernel.us_per_msg.steady`, one name for
each end-to-end metric it moves): device time of the seq engine's
kernels (csrc/seq_step.cu, matched by name in the profiler's trace)
inside the window, per message completed, in microseconds."""

from kmebench.devtrace import seq_kernel_seconds


def read(run):
    n = run.completed()
    if run.dev is None or not n:
        return None
    s = seq_kernel_seconds(run.dev)
    return s / n * 1e6 if s > 0 else None
