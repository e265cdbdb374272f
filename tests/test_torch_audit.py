"""The port's invariant auditor (`kme_tpu_torch/telemetry/audit.py`) and
its service wiring against the JAX package's.

- `check_engine` against the port's SeqSession and LaneSession
  `export_state()` (CPU tensors) returns [] after an audited stream, and
  finds a shadow balance off by one;
- the `fill_qty` tamper gives the same violation kinds, counters and
  dumps in both packages' services; each package's `replay_repro`
  re-finds the other's dump;
- the service degrades (heartbeat) and raises its counter; java mode
  disables the audit; audit without a journal is refused.
Exact equality throughout.
"""

import json

import pytest
import torch

from kme_tpu.bridge import service as JSV
from kme_tpu.bridge.broker import InProcessBroker as JaxBroker
from kme_tpu.telemetry import audit as JA
from kme_tpu.telemetry.journal import oracle_events
from kme_tpu.workload import harness_stream, zipf_symbol_stream
from kme_tpu_torch.bridge import service as SV
from kme_tpu_torch.bridge.broker import InProcessBroker
from kme_tpu_torch.engine import lanes as L
from kme_tpu_torch.engine import seq as SQ
from kme_tpu_torch.runtime.seqsession import SeqSession
from kme_tpu_torch.runtime.session import LaneSession
from kme_tpu_torch.telemetry import audit as PA
from kme_tpu_torch.telemetry.journal import batch_events
from kme_tpu_torch.wire import dumps_order

torch.set_num_threads(1)


def _msgs(n=300, seed=9):
    return harness_stream(n, seed=seed, num_accounts=8, num_symbols=3,
                          payout_opcode_bug=False, validate=True)


def _audited(ses, msgs, chunk=100):
    aud = PA.InvariantAuditor()
    for lo in range(0, len(msgs), chunk):
        part = [m.copy() for m in msgs[lo:lo + chunk]]
        records = ses.process_wire(part)
        aud.observe(batch_events(records, reasons=ses.last_reasons,
                                 offsets=list(range(lo, lo + len(part)))))
    return aud


@pytest.mark.parametrize("engine", ["seq", "seq_deep", "lanes"])
def test_check_engine_against_port_sessions(engine):
    if engine == "lanes":
        ses = LaneSession(L.LaneConfig(lanes=8, slots=64, accounts=128,
                                       max_fills=16), width=8, device="cpu")
        msgs = _msgs()
    else:
        slots = 1024 if engine == "seq_deep" else 128
        ses = SeqSession(SQ.SeqConfig(lanes=8, slots=slots, accounts=128,
                                      max_fills=16, batch=128,
                                      pos_cap=1 << 11, fill_cap=1 << 12,
                                      probe_max=16,
                                      hbm_books=slots > 512), device="cpu")
        msgs = zipf_symbol_stream(600, num_symbols=6, num_accounts=40,
                                  seed=2, payout_per_mille=8)
    aud = _audited(ses, msgs)
    assert aud.violations == [] and aud.balances
    assert aud.check_engine(ses.export_state(), ses.histograms()) == []
    aid = next(iter(aud.balances))
    aud.balances[aid] += 1
    found = aud.check_engine(ses.export_state())
    assert [v["kind"] for v in found] == ["state_mismatch"]
    assert "balances differ" in found[0]["detail"]


def test_shadow_replay_equals_jax_on_payout_stream(tmp_path):
    """Per-event replay, violations and snapshots equal the JAX package's
    on a payout-heavy stream with one tampered fill."""
    msgs = zipf_symbol_stream(900, num_symbols=4, num_accounts=8, seed=4,
                              payout_per_mille=30)
    evs = oracle_events([dumps_order(m) for m in msgs])
    out = []
    for mod, tag in ((PA, "p"), (JA, "j")):
        aud = mod.InvariantAuditor(repro_dir=str(tmp_path / tag))
        batches = [[dict(ev) for ev in evs if lo <= ev.get("off", -1)
                    < lo + 90] for lo in range(0, 900, 90)]
        for ev in batches[3]:
            if ev["e"] == "fill":
                ev["qty"] += 1
                break
        for b in batches:
            aud.observe(b)
        out.append((list(aud.violations), aud._snapshot(),
                    [json.load(open(d)) for d in aud.dumps]))
    assert out[0] == out[1] and out[0][0]


def _serve(mod, mod_broker, values, tmp, **kw):
    if mod is SV:
        kw["device"] = "cpu"
    tmp.mkdir(exist_ok=True)
    b = mod_broker()
    b.create_topic(SV.TOPIC_IN)
    b.create_topic(SV.TOPIC_OUT)
    for v in values:
        b.produce(SV.TOPIC_IN, None, v)
    svc = mod.MatchService(b, journal=str(tmp / "j.bin"), audit=True,
                           audit_repro_dir=str(tmp / "repro"), **kw)
    assert svc.run(max_messages=len(values)) == len(values)
    svc.close()
    return svc


def test_service_fill_qty_tamper_equal_kinds_and_cross_replay(
        tmp_path, monkeypatch):
    monkeypatch.setenv("KME_AUDIT_TAMPER", "fill_qty")
    values = [dumps_order(m) for m in _msgs(400, seed=13)]
    kw = dict(compat="fixed", batch=80, slots=128, max_fills=32)
    ps = _serve(SV, InProcessBroker, values, tmp_path / "p",
                engine="seq", symbols=8, accounts=128, **kw)
    js = _serve(JSV, JaxBroker, values, tmp_path / "j", engine="oracle",
                **kw)
    pk = [v["kind"] for v in ps.auditor.violations]
    assert pk and pk == [v["kind"] for v in js.auditor.violations]
    assert ps.auditor.violations == js.auditor.violations
    for svc in (ps, js):
        assert svc.degraded == pk[0]
        assert svc.telemetry.counter("audit_violations").value == len(pk)
    # each package re-finds the other's dump, and its own
    for dump_p, dump_j in zip(ps.auditor.dumps, js.auditor.dumps):
        assert PA.replay_repro(dump_j) == JA.replay_repro(dump_j) != []
        assert JA.replay_repro(dump_p) == PA.replay_repro(dump_p) != []
        dp, dj = PA.load_repro(dump_p), JA.load_repro(dump_j)
        for k in ("violations", "pre_state", "batch"):
            assert dp[k] == dj[k]
        # the events, but for the journal's wall-clock stamp
        assert [dict(ev, ts=0) for ev in dp["events"]] == \
            [dict(ev, ts=0) for ev in dj["events"]]


def test_service_degrades_heartbeat(tmp_path, monkeypatch):
    monkeypatch.setenv("KME_AUDIT_TAMPER", "fill_qty")
    values = [dumps_order(m) for m in _msgs(300, seed=2)]
    svc = _serve(SV, InProcessBroker, values, tmp_path, engine="seq",
                 compat="fixed", batch=100, symbols=8, accounts=128)
    assert svc.degraded is not None
    hb = tmp_path / "hb.json"
    svc._write_heartbeat(str(hb), seen=len(values), tick=1)
    doc = json.loads(hb.read_text())
    assert doc["degraded"] == svc.degraded
    assert doc["metrics"]["counters"]["audit_violations"] > 0
    assert doc["metrics"]["gauges"]["journal_last_offset"] == len(values) - 1


def test_clean_audited_service_checks_engine_each_checkpoint(tmp_path):
    values = [dumps_order(m) for m in _msgs(500, seed=5)]
    svc = _serve(SV, InProcessBroker, values, tmp_path, engine="seq",
                 compat="fixed", batch=64, symbols=8, accounts=128,
                 pipeline=2, checkpoint_dir=str(tmp_path / "ck"),
                 checkpoint_every=128)
    assert svc.auditor.violations == [] and svc.degraded is None
    assert len(svc.engine_checks) >= 3
    assert all(v == 0 for _off, v in svc.engine_checks)
    # the resumed service seeds its shadow from the restored state
    b = InProcessBroker()
    b.create_topic(SV.TOPIC_IN)
    b.create_topic(SV.TOPIC_OUT)
    for v in values:
        b.produce(SV.TOPIC_IN, None, v)
    again = SV.MatchService(b, engine="seq", compat="fixed", batch=64,
                            symbols=8, accounts=128, device="cpu",
                            checkpoint_dir=str(tmp_path / "ck"),
                            journal=str(tmp_path / "j.bin"), audit=True)
    assert again.offset > 0
    assert again.auditor.check_engine(again._session.export_state()) == []


def test_audit_refusals_and_java_disable(tmp_path):
    b = InProcessBroker()
    with pytest.raises(ValueError, match="journal"):
        SV.MatchService(b, engine="oracle", audit=True)
    svc = SV.MatchService(b, engine="oracle", compat="java", audit=True,
                          journal=str(tmp_path / "j.jsonl"),
                          watch=["balance[1]<0"])
    assert svc.auditor is None and svc.watch is None
    svc.close()
