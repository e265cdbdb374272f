"""Telemetry of the port: metric registry, phase tracing, live HTTP
surface, order-lifecycle flight recorder, continuous invariant auditing,
metrics history and profiling.

The port's copies of the JAX package's single-leader telemetry
(`kme_tpu/telemetry/`), with the same file formats, so either package
reads the other's journals, repro dumps, stores and event logs:

- registry: Counter/Gauge/Histogram/LatencyHistogram + Prometheus text
  + JSON export; the sessions and the service publish into one Registry
- trace: PhaseTimer spans + Chrome trace-event recording (incl. flow
  arrows), and GcWatch, the interpreter's collections counted and
  spanned
- httpd: stdlib /metrics endpoint over a Registry
- journal: append-only lifecycle journal (jsonl/binary) + readers
- audit: shadow-ledger invariant auditor over the journal; its
  `check_engine` reads the state the card's kernels left behind
- dtrace: deterministic trace ids, span collection, the multi-leader
  stitch over the front's routing (bridge/front.py), waterfalls and the
  kme-torch-agg aggregation
- slo: error-budget objectives over the live latency histograms
- top: the kme-torch-top live operations dashboard
- tsdb: on-disk metrics history (fixed-width binary segments)
- profiler: host stage profiler, the device plane (the kernel's CUDA
  event time and bytes per dispatch, H2D bandwidth) and trigger
  captures with a torch.profiler window
- events: control-plane flight recorder (durable event timeline) + the
  kme-torch-events merge/query pipeline
- xray: offset-addressed state, divergence bisection, watchpoints
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
from kme_tpu_torch.telemetry.httpd import start_metrics_server  # noqa: F401
from kme_tpu_torch.telemetry.journal import (  # noqa: F401
    Journal,
    batch_events,
    canonical_events,
    canonical_lines,
    iter_events,
    measured_overlap_s,
    oracle_events,
    read_events,
)
from kme_tpu_torch.telemetry.audit import (  # noqa: F401
    InvariantAuditor,
    Violation,
    replay_repro,
)
from kme_tpu_torch.telemetry.slo import SLO  # noqa: F401
from kme_tpu_torch.telemetry.tsdb import (  # noqa: F401
    TSDB,
    flatten_snapshot,
    read_samples,
    window_summary,
)
from kme_tpu_torch.telemetry.events import (  # noqa: F401
    EventLog,
    merge_events,
    merge_logs,
    open_log,
    read_log,
    timeline_digest,
)
from kme_tpu_torch.telemetry.profiler import (  # noqa: F401
    StageProfiler,
    TriggerCapture,
    device_plane,
    read_transfer_artifact,
    write_transfer_artifact,
)
