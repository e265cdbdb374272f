"""The port's metrics history (`kme_tpu_torch/telemetry/tsdb.py`), SLO,
control-plane event log (`events.py`, `events_cli.py`) and /metrics
endpoint against the JAX package's.

- a TSDB store or an event log written by either package verifies and
  reads in the other: equal samples, equal segment bytes (same clock),
  equal window summaries, an equal `timeline_digest`;
- rotation digests verify in both; the SLO evaluates identically on the
  same registry feed;
- the service's TSDB heartbeat and its event log (a lease grant) read in
  the JAX package; /metrics answers over HTTP.
Exact equality throughout.
"""

import json
import os
from urllib.request import urlopen

import pytest
import torch

from kme_tpu.telemetry import events as JE
from kme_tpu.telemetry import slo as JSLO
from kme_tpu.telemetry import tsdb as JT
from kme_tpu.telemetry.registry import Registry as JRegistry
from kme_tpu.workload import harness_stream
from kme_tpu_torch.bridge import service as SV
from kme_tpu_torch.bridge.broker import InProcessBroker
from kme_tpu_torch.telemetry import events as PE
from kme_tpu_torch.telemetry import slo as PSLO
from kme_tpu_torch.telemetry import start_metrics_server
from kme_tpu_torch.telemetry import tsdb as PT
from kme_tpu_torch.telemetry.registry import Registry
from kme_tpu_torch.wire import dumps_order

torch.set_num_threads(1)


def _snap(i):
    return {"counters": {"service_records": 100 * i, "fills": 7 * i},
            "gauges": {"service_offset": 100 * i, "open_orders": i % 5,
                       "h2d_overlap_frac": 0.5 + i / 100},
            "latencies": {"lat_e2e": {"count": 10 * i, "p50_ms": 0.5 * i,
                                      "p99_ms": 2.0 * i}}}


def _write_store(mod, d, rotate=None):
    kw = {} if rotate is None else {"rotate_bytes": rotate}
    db = mod.TSDB(d, source="serve", **kw)
    for i in range(60):
        db.append_snapshot(_snap(i), i, ts_us=1_000_000 + i * 500_000)
    db.append_snapshot(_snap(3), 3, ts_us=9)       # a replayed sample
    db.close()
    cl = mod.TSDB(d, source="loadgen")
    cl.append_values({"loadgen_produced_total": 5000, "flag": True},
                     cl.next_seq(), ts_us=2_000_000)
    cl.close()
    return db


@pytest.mark.parametrize("rotate", [None, 4096])
def test_tsdb_cross_package(tmp_path, rotate):
    pd, jd = str(tmp_path / "p"), str(tmp_path / "j")
    pdb = _write_store(PT, pd, rotate)
    jdb = _write_store(JT, jd, rotate)
    assert pdb.dup_skipped == jdb.dup_skipped == 1
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd))
    for name in os.listdir(pd):
        if not name.endswith(".sha256"):
            assert open(os.path.join(pd, name), "rb").read() == \
                open(os.path.join(jd, name), "rb").read(), name
    for store in (pd, jd):
        samples = list(PT.read_samples(store))
        assert samples == list(JT.read_samples(store)) and samples
        assert PT.query(store) == JT.query(store)
        assert PT.query(store, names=["lat_e2e.p99_ms"], source="serve") \
            == JT.query(store, names=["lat_e2e.p99_ms"], source="serve")
        assert PT.window_summary(store) == JT.window_summary(store)
        assert PT.verify_store(store) == JT.verify_store(store)
        assert not PT.verify_store(store)["mismatched"]
    if rotate:
        assert PT.verify_store(pd)["segments"] > 0
    assert PT.flatten_snapshot(_snap(4)) == JT.flatten_snapshot(_snap(4))


def test_tsdb_reopen_continues_cursor_across_packages(tmp_path):
    d = str(tmp_path / "s")
    _write_store(JT, d, 4096)
    db = PT.TSDB(d, source="serve", rotate_bytes=4096)
    assert db.next_seq() == 60
    assert not db.append_snapshot(_snap(59), 59)
    assert db.append_snapshot(_snap(60), 60, ts_us=99_000_000)
    db.close()
    assert [s[2] for s in JT.read_samples(d, source="serve")][-1] == 60


def _write_log(mod, d, source):
    t = [100.0]

    def clock():
        t[0] += 0.25
        return t[0]

    log = mod.open_log(d, source, clock=clock, rotate_bytes=4096)
    for i in range(80):
        log.emit("overload.transition" if i % 3 else "lease.grant",
                 severity="warn" if i % 7 == 0 else "info",
                 group=None if i % 2 else 1, epoch=i // 10, offset=i * 11,
                 from_state="normal", to_state="shedding", n=i)
    log.emit("dup", seq=5)          # at or below the cursor: dropped
    log.close()
    return log


def test_event_logs_cross_package(tmp_path):
    pd, jd = str(tmp_path / "p"), str(tmp_path / "j")
    for d in (pd, jd):
        os.makedirs(d)
    pl = _write_log(PE, pd, "serve")
    jl = _write_log(JE, jd, "serve")
    assert pl.dup_skipped == jl.dup_skipped == 1
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd))
    for name in os.listdir(pd):
        assert open(os.path.join(pd, name), "rb").read() == \
            open(os.path.join(jd, name), "rb").read(), name
    # a second writer in each dir, written by the OTHER package
    _write_log(JE, pd, "standby")
    _write_log(PE, jd, "standby")
    path = PE.log_path(pd, "serve")
    assert PE.verify_log(path) == JE.verify_log(path)
    assert PE.verify_log(path)["ok"] and PE.verify_log(path)["events"]
    for d in (pd, jd):
        pm, jm = PE.merge_logs([d]), JE.merge_logs([d])
        assert pm == jm and len(pm) == 160
        assert PE.timeline_digest(pm) == JE.timeline_digest(jm)
        assert PE.to_chrome(pm) == JE.to_chrome(jm)
        assert [PE.format_event(e) for e in pm[:10]] == \
            [JE.format_event(e) for e in jm[:10]]
    assert PE.timeline_digest(PE.merge_logs([pd])) == \
        JE.timeline_digest(JE.merge_logs([jd]))


def test_events_cli_merges_and_verifies(tmp_path, capsys):
    from kme_tpu.telemetry import events_cli as JC
    from kme_tpu_torch.telemetry import events_cli as PC

    d = str(tmp_path / "ev")
    os.makedirs(d)
    _write_log(JE, d, "serve")
    _write_log(PE, d, "supervisor")
    outs = []
    for mod in (PC, JC):
        for argv in ([d, "--json"], [d, "--kind", "lease.grant",
                                      "--tail", "5"], [d, "--severity", "warn"]):
            rc = mod.main(argv)
            outs.append((rc, capsys.readouterr().out))
    assert outs[:3] == outs[3:] and outs[0][1]


def test_slo_equal_jax():
    clock = [0.0]
    pr, jr = Registry(), JRegistry()
    ps = PSLO.SLO(pr, p99_ms=5.0, min_ops=10, window_s=1.0,
                  min_records_per_s=50.0, clock=lambda: clock[0])
    js = JSLO.SLO(jr, p99_ms=5.0, min_ops=10, window_s=1.0,
                  min_records_per_s=50.0, clock=lambda: clock[0])
    for step in range(8):
        for reg in (pr, jr):
            lat = reg.latency("lat_e2e")
            for k in range(20):
                lat.observe((k % 7) * 1e-3 * (step + 1))
            reg.counter("service_records").inc(20 * step)
        clock[0] += 0.7
        assert ps.evaluate() == js.evaluate()
    assert pr.snapshot()["gauges"] == jr.snapshot()["gauges"]
    assert ps.describe() == js.describe()


def test_service_tsdb_and_event_log_read_in_jax(tmp_path):
    msgs = harness_stream(300, seed=4, num_symbols=3, num_accounts=6,
                          payout_opcode_bug=False, validate=True)
    b = InProcessBroker()
    b.create_topic(SV.TOPIC_IN)
    b.create_topic(SV.TOPIC_OUT)
    for m in msgs:
        b.produce(SV.TOPIC_IN, None, dumps_order(m))
    ck, store = str(tmp_path / "ck"), str(tmp_path / "tsdb")
    svc = SV.MatchService(b, engine="seq", batch=64, symbols=8,
                          accounts=128, device="cpu", checkpoint_dir=ck,
                          exactly_once=True, tsdb=store,
                          slo={"p99_ms": 0.001, "min_ops": 1})
    srv = start_metrics_server(svc.telemetry, 0, host="127.0.0.1")
    try:
        svc.run(max_messages=len(msgs), health_file=str(tmp_path / "hb"),
                health_every=0.05)
        port = srv.server_address[1]
        with urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            prom = r.read().decode()
        with urlopen(f"http://127.0.0.1:{port}/metrics.json",
                     timeout=10) as r:
            doc = json.loads(r.read().decode())
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
    assert "service_records" in prom and "lat_e2e" in prom
    assert doc["counters"]["service_records"] == len(msgs)
    samples = list(JT.read_samples(store, source="serve"))
    assert samples == list(PT.read_samples(store, source="serve"))
    seqs = sorted({s[2] for s in samples})
    assert seqs == list(range(len(seqs))) and len(seqs) >= 2
    evs = JE.read_log(PE.log_path(ck, "serve"))
    assert [e["kind"] for e in evs][:1] == ["lease.grant"]
    hb = json.load(open(tmp_path / "hb"))
    assert hb["events_last_offset"] > 0 and hb["sample_seq"] >= 1
