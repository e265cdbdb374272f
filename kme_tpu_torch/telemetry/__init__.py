"""Telemetry of the port: the metric registry and phase tracing.

Copies of `kme_tpu/telemetry/registry.py` and `trace.py`:

- registry: Counter/Gauge/Histogram/LatencyHistogram + Prometheus text
  + JSON export; the sessions and the service publish into one Registry
- trace: PhaseTimer spans + Chrome trace-event recording (incl. flow
  arrows)

The rest of the JAX package's telemetry (journal, audit, slo, tsdb,
profiler, events, dtrace, xray, httpd) is not ported yet; the service's
flags that need it raise.
"""

from kme_tpu_torch.telemetry.registry import (  # noqa: F401
    BUCKET_LE,
    LAT_BOUNDS,
    LAT_N_BUCKETS,
    N_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    LatencyHistogram,
    Registry,
    bucket_index,
)
from kme_tpu_torch.telemetry.trace import (  # noqa: F401
    PhaseTimer,
    TraceRecorder,
    get_tracer,
    install,
)
