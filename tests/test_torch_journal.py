"""The port's flight recorder (`kme_tpu_torch/telemetry/journal.py`) and
the service's journal wiring against the JAX package's.

- the same stream through `kme_tpu`'s `MatchService(engine="seq")` and
  the port's (`device="cpu"`), serial and `pipeline=2`, journals equal
  canonical events, and each package's `read_events` reads the other's
  file (jsonl and binary), with equal events apart from the timing
  stamps inside `lat`/`span` events (excluded by name);
- the port's lanes service journals what `kme_tpu`'s oracle replay
  derives from the input (`oracle_events`, the reference's own judge);
- the watch hit sets (offset, predicate) of the seq engine are equal
  across the two packages (pipelined) and the port's serial path;
- the module functions (derivation, framing, rewind, lifecycle) equal
  the JAX package's on seeded streams. Exact equality throughout.
"""

import os

import pytest
import torch

from kme_tpu.bridge import service as JSV
from kme_tpu.bridge.broker import InProcessBroker as JaxBroker
from kme_tpu.oracle import OracleEngine as JaxOracle
from kme_tpu.telemetry import journal as JJ
from kme_tpu.workload import harness_stream
from kme_tpu_torch.bridge import service as SV
from kme_tpu_torch.bridge.broker import InProcessBroker
from kme_tpu_torch.telemetry import journal as PJ
from kme_tpu_torch.wire import dumps_order

torch.set_num_threads(1)

SEQ_KW = dict(engine="seq", compat="fixed", batch=128, symbols=8,
              accounts=128, slots=128, max_fills=32)
WATCH = ["depth[1]>=4", "balance[1]<0", "spread[1]==0",
         "position[2,1]>0"]
# timing stamps: recorder-local, different in every run
TIMING = ("ts", "in_us", "plan_us", "dev_us", "prod_us", "e2e_us", "t0",
          "t1")


def _values(n=500, seed=3):
    msgs = harness_stream(n, seed=seed, num_symbols=4, num_accounts=8,
                          payout_opcode_bug=False, validate=True)
    return [dumps_order(m) for m in msgs]


def _broker(mod_broker, values):
    b = mod_broker()
    b.create_topic(SV.TOPIC_IN)
    b.create_topic(SV.TOPIC_OUT)
    for v in values:
        b.produce(SV.TOPIC_IN, None, v)
    return b


def _serve(mod, mod_broker, values, journal, **kw):
    if mod is SV:
        kw["device"] = "cpu"
    b = _broker(mod_broker, values)
    svc = mod.MatchService(b, journal=journal, **kw)
    assert svc.run(max_messages=len(values)) == len(values)
    svc.close()
    out = [f"{r.key} {r.value}" for r in b.fetch(SV.TOPIC_OUT, 0, 10 ** 9)]
    return svc, out


def _strip(evs):
    return [{k: v for k, v in ev.items() if k not in TIMING} for ev in evs]


@pytest.mark.parametrize("ext", ["jsonl", "bin"])
@pytest.mark.parametrize("pipeline", [0, 2])
def test_service_journal_matches_jax(tmp_path, pipeline, ext):
    values = _values()
    kw = dict(SEQ_KW, pipeline=pipeline, trace_spans=True)
    if pipeline:
        kw["watch"] = WATCH     # the JAX package's serial path has none
    pj, jj = str(tmp_path / f"p.{ext}"), str(tmp_path / f"j.{ext}")
    ps, pout = _serve(SV, InProcessBroker, values, pj, **kw)
    js, jout = _serve(JSV, JaxBroker, values, jj, **kw)
    assert pout == jout
    pe, je = PJ.read_events(pj), JJ.read_events(jj)
    assert PJ.canonical_lines(pe) == JJ.canonical_lines(je)
    assert len(PJ.canonical_lines(pe)) > len(values)
    # each package reads the other's file to the same events
    assert JJ.read_events(pj) == pe and PJ.read_events(jj) == je
    # everything but the timing stamps, lat and span events included
    assert _strip(pe) == _strip(je)
    kinds = {ev["e"] for ev in pe}
    assert {"lat", "span", "fill", "rest", "accept"} <= kinds
    if pipeline:
        assert ps.watch.hits == js.watch.hits and ps.watch.hits


def test_serial_watch_hits_equal_pipelined(tmp_path):
    """The serial path (which the JAX package only wires for its oracle
    engine) fires the hit set the pipelined path fires, and the JAX
    oracle service's engine-read path fires the same."""
    values = _values()
    hits = []
    for pipeline in (0, 2):
        svc, _ = _serve(SV, InProcessBroker, values,
                        str(tmp_path / f"p{pipeline}.bin"),
                        **dict(SEQ_KW, pipeline=pipeline, watch=WATCH))
        hits.append(svc.watch.hits)
    js, _ = _serve(JSV, JaxBroker, values, None,
                   **dict(SEQ_KW, engine="oracle", watch=WATCH))
    assert hits[0] == hits[1] == js.watch.hits and hits[0]


def test_lanes_journal_matches_oracle_replay(tmp_path):
    values = _values(400, seed=9)
    jp = str(tmp_path / "lanes.bin")
    svc, _ = _serve(SV, InProcessBroker, values, jp,
                    **dict(SEQ_KW, engine="lanes", slots=64, accounts=64,
                           width=8))
    want = JJ.canonical_lines(JJ.oracle_events(values, book_slots=64,
                                               max_fills=32))
    assert PJ.canonical_lines(PJ.read_events(jp)) == want
    assert PJ.canonical_lines(PJ.oracle_events(
        values, book_slots=64, max_fills=32)) == want


def _groups(n=300, seed=11):
    msgs = harness_stream(n, seed=seed, num_accounts=6, num_symbols=2,
                          payout_opcode_bug=False, validate=True)
    lines = [dumps_order(m) for m in msgs]
    eng = JaxOracle("fixed")
    from kme_tpu.wire import parse_order as jparse

    return lines, [[r.wire() for r in eng.process(jparse(ln))]
                   for ln in lines]


def _fill(mod, path, groups, chunk=100, **kw):
    j = mod.Journal(path, clock=lambda: 1_000_000, **kw)
    for lo in range(0, len(groups), chunk):
        part = groups[lo:lo + chunk]
        j.record_batch(part, offsets=list(range(lo, lo + len(part))))
        j.record_window("submit", 0.5, 0.75, batch=lo)
        j.record_latency([{"off": lo, "oid": 1, "in_us": 3, "plan_us": 4,
                           "dev_us": 5, "prod_us": 6, "e2e_us": 18}],
                         batch=lo)
    j.close()


@pytest.mark.parametrize("ext", ["jsonl", "bin"])
def test_journal_files_byte_identical(tmp_path, ext):
    """Same batches, same clock: the two packages write the same bytes."""
    _, groups = _groups()
    pp, jp = str(tmp_path / f"p.{ext}"), str(tmp_path / f"j.{ext}")
    _fill(PJ, pp, groups)
    _fill(JJ, jp, groups)
    assert open(pp, "rb").read() == open(jp, "rb").read()


def test_derivations_equal_jax():
    lines, groups = _groups()
    reasons = [3] * len(groups)
    assert PJ.batch_events(groups, reasons=reasons, drops=[(-1, 7)]) == \
        JJ.batch_events(groups, reasons=reasons, drops=[(-1, 7)])
    assert PJ.oracle_events(lines + ["not json"]) == \
        JJ.oracle_events(lines + ["not json"])
    evs = JJ.oracle_events(lines)
    oid = next(e["oid"] for e in evs if e["e"] == "fill")
    aid = next(e["aid"] for e in evs if e["e"] == "fill")
    life = PJ.order_lifecycle(evs, oid)
    assert life == JJ.order_lifecycle(evs, oid)
    assert PJ.lifecycle_summary(life, oid) == JJ.lifecycle_summary(life, oid)
    assert PJ.account_history(evs, aid) == JJ.account_history(evs, aid)
    w = [("submit", 0, 0.0, 1.0), ("collect", 0, 2.0, 3.0),
         ("submit", 1, 1.5, 2.5), ("collect", 1, 3.0, 4.0)]
    assert PJ.measured_overlap_s(w) == JJ.measured_overlap_s(w)


def test_rewind_and_rotation_equal_jax(tmp_path):
    _, groups = _groups()
    out = []
    for mod, tag in ((PJ, "p"), (JJ, "j")):
        path = str(tmp_path / f"{tag}.bin")
        _fill(mod, path, groups, chunk=40, rotate_bytes=4096)
        j = mod.Journal(path, clock=lambda: 2_000_000)
        j.rewind_to_offset(150)
        j.record_batch(groups[150:160], offsets=list(range(150, 160)))
        j.close()
        n = 1
        while os.path.exists(f"{path}.{n}"):
            n += 1
        out.append((n, mod.read_events(path)))
    assert out[0] == out[1] and out[0][0] > 2


def test_seqsession_windows_overlap_is_the_journal_copy():
    from kme_tpu_torch.runtime import seqsession

    assert seqsession.measured_overlap_s is PJ.measured_overlap_s
