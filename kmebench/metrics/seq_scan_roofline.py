"""seq_scan_roofline: the seq kernels' share of the bandwidth roofline in
the window: the least bytes the window's completed messages need
(kmebench/roofline.py) at the H100's 3.35 TB/s, over the kernels' device
time, in percent. The kernels move bytes and do no floating-point work,
so bandwidth bounds them."""

from kmebench.devtrace import seq_kernel_seconds
from kmebench.roofline import PEAK_BYTES_PER_S


def read(run):
    if run.dev is None or not run.completed():
        return None
    s = seq_kernel_seconds(run.dev)
    if s <= 0:
        return None
    return run.least_bytes() / PEAK_BYTES_PER_S / s * 100.0
