"""The serve loop's spans and counters, on the CPU: the `serve` track
tiled by side-by-side spans (fetch, parse, engine, produce, observe,
publish) whose batch ordinal joins them to the session's `seq` spans;
the collector's hook (`GcWatch`: cumulative gauges, the `gc` track) and
its removal when `kme-torch-serve` exits; the TCP handlers' CPU by op;
the four benchmark readers of them; `LatencyHistogram.observe_many`;
and the capture marker that ties the recorder's timeline to the
profiler's.
"""

import gc
import json
import os
import time

import numpy as np
import pytest
import torch

from kme_tpu_torch.bridge import service as SV
from kme_tpu_torch.bridge.broker import InProcessBroker
from kme_tpu_torch.bridge.tcp import TcpBroker, serve_broker
from kme_tpu_torch.telemetry import (LAT_BOUNDS, LatencyHistogram,
                                     PhaseTimer, Registry, TraceRecorder,
                                     install)
from kme_tpu_torch.telemetry.trace import GcWatch
from kme_tpu_torch.wire import dumps_order
from kme_tpu_torch.workload import harness_stream

torch.set_num_threads(1)

SEQ_PIPE = dict(engine="seq", compat="fixed", batch=128, symbols=8,
                accounts=128, slots=128, max_fills=32, pipeline=2,
                device="cpu")
SERVE_SPANS = {"serve_fetch", "serve_parse", "serve_engine",
               "serve_produce", "serve_observe", "serve_publish"}
SEQ_SPANS = {"plan_s", "stage_s", "dispatch_s", "fetch_s", "recon_s"}


def _broker(values=()):
    b = InProcessBroker()
    b.create_topic(SV.TOPIC_IN)
    b.create_topic(SV.TOPIC_OUT)
    for v in values:
        b.produce(SV.TOPIC_IN, None, v)
    return b


def _spans(rec):
    """[(track, name, start µs, end µs, args)] of complete events."""
    evs = rec.trace_events()
    tracks = {e["tid"]: e["args"]["name"] for e in evs if e["ph"] == "M"}
    return [(tracks[e["tid"]], e["name"], e["ts"], e["ts"] + e["dur"],
             e.get("args") or {}) for e in evs if e["ph"] == "X"]


@pytest.fixture(scope="module")
def pipelined_spans():
    """A pipelined service on the CPU over 500 messages (4 batches and
    a partial one), traced."""
    values = [dumps_order(m) for m in harness_stream(
        500, seed=3, num_symbols=4, num_accounts=8,
        payout_opcode_bug=False, validate=True)]
    rec = TraceRecorder()
    install(rec)
    try:
        svc = SV.MatchService(_broker(values), **SEQ_PIPE)
        assert svc.pipeline == 2
        assert svc.run(max_messages=len(values)) == len(values)
        svc.close()
    finally:
        install(None)
    return _spans(rec)


def test_pipelined_step_tiles_the_serve_track(pipelined_spans):
    serve = sorted((s for s in pipelined_spans if s[0] == "serve"),
                   key=lambda s: s[2])
    assert SERVE_SPANS <= {s[1] for s in serve}
    # side by side: each serve span ends before the next one starts, so
    # none paints over another in the idle attribution
    for prev, nxt in zip(serve, serve[1:]):
        assert prev[3] <= nxt[2] + 1e-3, (prev, nxt)


def test_spans_of_one_batch_share_its_ordinal(pipelined_spans):
    serve = [s for s in pipelined_spans if s[0] == "serve"]
    seq = [s for s in pipelined_spans if s[0] == "seq"]
    batches = sorted({s[4]["batch"] for s in serve if "batch" in s[4]})
    assert len(batches) >= 4
    for k in batches:
        names = {s[1] for s in serve if s[4].get("batch") == k}
        assert names == SERVE_SPANS, (k, names)
        assert {s[1] for s in seq if s[4].get("batch") == k} == SEQ_SPANS
    # every session span lies inside the service's engine span of its
    # own batch: plan/stage/dispatch in the submit, fetch/recon in the
    # collect two steps later
    engine = [s for s in serve if s[1] == "serve_engine"]
    for _trk, name, a, b, args in seq:
        assert any(e[4]["batch"] == args["batch"] and e[2] <= a
                   and b <= e[3] for e in engine), (name, args)
    # no batch is known before a poll returns records
    assert all("batch" in s[4] for s in serve if s[1] != "serve_fetch")


def test_empty_poll_fetch_span_lasts_its_timeout():
    rec = TraceRecorder()
    install(rec)
    try:
        svc = SV.MatchService(_broker(), engine="oracle")
        assert svc.step(timeout=0.2) == 0
    finally:
        install(None)
    fetch = [s for s in _spans(rec) if s[1] == "serve_fetch"]
    assert len(fetch) == 1
    dur_s = (fetch[0][3] - fetch[0][2]) * 1e-6
    assert 0.19 <= dur_s < 0.5
    assert "batch" not in fetch[0][4]


def test_full_collection_counted_and_spanned():
    w = GcWatch().install()
    rec = TraceRecorder()
    install(rec)
    try:
        before = (w.collections, w.full_collections)
        gc.collect(2)
    finally:
        install(None)
        w.uninstall()
    assert w.full_collections == before[1] + 1
    assert w.collections >= before[0] + 1
    full = [s for s in _spans(rec) if s[0] == "gc" and s[4]["gen"] == 2]
    assert len(full) == 1 and full[0][1] == "gc"
    reg = Registry()
    reg.add_collector(lambda: w.publish(reg))
    snap = reg.snapshot()
    assert snap["gauges"]["gc_full_collections_total"] == w.full_collections
    assert snap["gauges"]["gc_collections_total"] == w.collections
    assert snap["gauges"]["gc_pause_s"] == pytest.approx(w.pause_s, abs=1e-6)
    assert snap["latencies"]["lat_gc_pause"]["count"] == w.collections
    assert w not in gc.callbacks


def test_serve_main_takes_its_hook_out(monkeypatch):
    from kme_tpu_torch.bridge import serve

    installed = []
    real = GcWatch.install

    def spy(self):
        installed.append(self)
        return real(self)

    monkeypatch.setattr(GcWatch, "install", spy)
    before = list(gc.callbacks)
    rc = serve.main(["--engine", "oracle", "--listen", "127.0.0.1:0",
                     "--auto-provision", "--idle-exit", "0.1"])
    assert rc == 0
    assert len(installed) == 1
    assert installed[0] not in gc.callbacks
    assert gc.callbacks == before


def _tcp(broker):
    srv, _ = serve_broker("127.0.0.1", 0, broker)
    return srv, TcpBroker(*srv.server_address[:2])


def _wait_gauge(svc, name, want, timeout=5.0):
    """The gauge once the handler thread has tallied its last request
    (it tallies after its reply is written)."""
    end = time.monotonic() + timeout
    while True:
        g = svc.telemetry.snapshot()["gauges"]
        if g.get(name, 0) >= want or time.monotonic() > end:
            return g


def test_blocking_tcp_fetch_costs_little_handler_cpu():
    b = _broker()
    svc = SV.MatchService(b, engine="oracle")
    srv, cli = _tcp(b)
    try:
        t0 = time.monotonic()
        assert cli.fetch(SV.TOPIC_IN, 0, 10, timeout=0.2) == []
        assert time.monotonic() - t0 >= 0.19
        g = _wait_gauge(svc, "tcp_requests_total.fetch", 1)
    finally:
        cli.close()
        srv.shutdown()
        srv.server_close()
    assert g["tcp_requests_total.fetch"] == 1
    assert 0 <= g["tcp_handler_cpu_s"] < 0.02
    assert g["tcp_handler_cpu_s.fetch"] <= g["tcp_handler_cpu_s"]


def test_tcp_requests_counted_by_op():
    b = _broker()
    svc = SV.MatchService(b, engine="oracle")
    srv, cli = _tcp(b)
    try:
        for i in range(3):
            cli.produce(SV.TOPIC_IN, None, f'{{"action":100,"aid":{i}}}')
        assert len(cli.fetch(SV.TOPIC_IN, 0, 10)) == 3
        cli.end_offset(SV.TOPIC_IN)
        cli.end_offset(SV.TOPIC_IN)
        g = _wait_gauge(svc, "tcp_requests_total", 6)
    finally:
        cli.close()
        srv.shutdown()
        srv.server_close()
    assert g["tcp_requests_total.produce"] == 3
    assert g["tcp_requests_total.fetch"] == 1
    assert g["tcp_requests_total.end_offset"] == 2
    assert g["tcp_requests_total"] == 6
    by_op = sum(v for k, v in g.items()
                if k.startswith("tcp_handler_cpu_s."))
    assert g["tcp_handler_cpu_s"] == pytest.approx(by_op, abs=1e-5)


def _run_data():
    """A 10 s window [100, 110) with 4 messages completed in it."""
    from kmebench.run import RunData

    spans = [
        ("serve", "serve_parse", 99.9995, 100.0005, ),   # half inside
        ("serve", "serve_parse", 101.0, 101.002),
        ("serve", "serve_parse", 110.5, 110.6),          # after it
        ("serve", "serve_fetch", 102.0, 103.0),
        # collections 1-2 before the first scrape, 3 between it and
        # the window (the harness's own), 4-5 inside, 6 after the close
        ("gc", "gc", 10.0, 10.5),
        ("gc", "gc", 20.0, 20.1),
        ("gc", "gc", 99.0, 99.1),
        ("gc", "gc", 104.0, 104.15),
        ("gc", "gc", 108.0, 108.25),
        ("gc", "gc", 111.0, 111.2),
    ]
    m0 = {"gauges": {"gc_pause_s": 0.6, "gc_collections_total": 2,
                     "tcp_handler_cpu_s": 0.2}}
    m1 = {"gauges": {"gc_pause_s": 1.1, "gc_collections_total": 5,
                     "tcp_handler_cpu_s": 0.7}}
    return RunData(t0=100.0, t1=110.0, seconds=10.0,
                   done=np.array([99.0, 100.5, 101.0, 105.0, 109.9, 110.0]),
                   spans=spans, m0=m0, m1=m1)


@pytest.mark.parametrize("name,want", [
    ("wire.parse_us_per_msg.steady", (0.0005 + 0.002) / 4 * 1e6),
    ("runtime.gc_pause_pct.steady", 100 * (0.5 - 0.1) / 10),
    ("runtime.gc_pause_max_ms.steady", 250.0),
    ("tcp.handler_cpu_pct.steady", 100 * 0.5 / 10),
])
def test_new_readers_on_a_hand_built_run(name, want):
    from kmebench import spec as S

    b = S.Benchmark()
    m = next(m for m in b.per_layer if m["name"] == name)
    assert m["workloads"] == ["serve-fixed.steady"]
    assert m["moves"] == "answered_100ms_pct"
    assert b.metric_path(name).endswith(f"metrics/{name}.py")
    read = S.load_reader(b.metric_path(name))
    assert read(_run_data()) == pytest.approx(want, rel=1e-9)
    # a program without the spans and gauges reads nothing, and the
    # reader does not raise
    empty = _run_data()
    empty.spans, empty.m0, empty.m1 = [], {"gauges": {}}, {"gauges": {}}
    assert read(empty) is None


def test_observe_many_equals_the_loop():
    rng = np.random.default_rng(7)
    vals = np.concatenate([
        rng.lognormal(-7, 3, 5000),
        np.array(LAT_BOUNDS),                  # on every bucket bound
        np.nextafter(np.array(LAT_BOUNDS), 0),
        [0.0, LAT_BOUNDS[-1] * 4, 1e-9],
    ])
    one, many = LatencyHistogram("a"), LatencyHistogram("b")
    for v in vals:
        one.observe(float(v))
    many.observe_many(vals[:100])
    many.observe_many(vals[100:])
    many.observe_many(np.array([]))
    c1, s1, b1 = one.state()
    c2, s2, b2 = many.state()
    assert b1 == b2 and c1 == c2 == len(vals)
    assert s1 == pytest.approx(s2, abs=1e-9)


def test_capture_anchor_ties_the_recorder_to_the_profiler(tmp_path):
    from kme_tpu_torch.telemetry.profiler import (CAPTURE_MARKER,
                                                  TriggerCapture,
                                                  format_capture)

    rec = TraceRecorder()
    install(rec)
    try:
        cap = TriggerCapture(str(tmp_path), window_s=0.01)
        path = cap.maybe_fire("burn", [])
        with PhaseTimer(track="t").phase("after_open"):
            pass
        cap.close()
    finally:
        install(None)
    with open(path) as f:
        doc = json.load(f)
    anchor = doc["device_trace_anchor_us"]
    assert "device trace anchor" in format_capture(path)
    with open(doc["device_trace"]) as f:
        prof = json.load(f)
    mark = [e for e in prof["traceEvents"]
            if e.get("name") == CAPTURE_MARKER and e.get("ph") == "X"]
    assert len(mark) == 1
    span = next(e for e in rec.trace_events() if e["name"] == "after_open")
    shifted = span["ts"] - anchor + float(mark[0]["ts"])
    assert abs(shifted - float(mark[0]["ts"])) < 1000.0
    # the recorder's origin on both clocks, saved with its events
    out = tmp_path / "trace.json"
    rec.save(str(out))
    other = json.loads(out.read_text())["otherData"]
    assert set(other) == {"origin_perf_counter_s", "origin_monotonic_s"}
    assert os.path.exists(doc["device_trace"])
