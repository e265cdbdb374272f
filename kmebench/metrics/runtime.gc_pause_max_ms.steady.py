"""runtime.gc_pause_max_ms.steady: the longest pause of the interpreter's
collections that started inside the window: the program's `gc`-track
spans (telemetry/trace.py GcWatch, one per collection), in
milliseconds."""


def read(run):
    if run.spans is None:
        return None
    pauses = [b - a for trk, _n, a, b in run.spans
              if trk == "gc" and run.t0 <= a < run.t1]
    return max(pauses) * 1e3 if pauses else None
