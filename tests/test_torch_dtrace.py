"""The port's tracing (`kme_tpu_torch/telemetry/dtrace.py`) against the
JAX package's.

- every trace-id function is bit-identical on seeded inputs
  (hypothesis), the vectorized client ids included;
- the spans collected from one service journal (real span events and the
  lat fallback), the waterfall text and the Chrome trace document equal
  the JAX package's;
- the kme-agg functions (merged quantiles, the aggregate, its
  rendering) equal the JAX package's on the two services' snapshots;
- over one grouped run directory (two port seq services on the CPU
  behind the port's front), `route_map`, `stitch` and
  `stitch_state_root` equal the JAX package's.
Exact equality throughout.
"""

import json

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from kme_tpu.telemetry import dtrace as JD
from kme_tpu.workload import harness_stream
from kme_tpu_torch.bridge import service as SV
from kme_tpu_torch.bridge.broker import InProcessBroker
from kme_tpu_torch.telemetry import dtrace as PD
from kme_tpu_torch.telemetry import read_events
from kme_tpu_torch.wire import dumps_order

torch.set_num_threads(1)

I64 = st.integers(min_value=-(1 << 63), max_value=(1 << 63) - 1)


@settings(max_examples=200, deadline=None)
@given(I64, I64, I64)
def test_trace_ids_equal_jax(a, b, c):
    assert PD.trace_id(a, b, c) == JD.trace_id(a, b, c)
    assert PD.local_tid(a % 64, b) == JD.local_tid(a % 64, b)
    assert PD.child_tid(a, b) == JD.child_tid(a, b)
    assert PD.client_trace_id(a, b, c) == JD.client_trace_id(a, b, c)
    for salt in (PD.TRACE_SALT, PD.LOCAL_SALT, PD.CLIENT_SALT):
        assert PD._tid_mix(salt, a, b, c) == JD._tid_mix(salt, a, b, c)
    from kme_tpu.bridge.front import _mix64
    from kme_tpu_torch.bridge import front as PF

    # the port's dtrace mixes with the port's front, as the JAX package's
    # dtrace with its front
    assert PD._mix64 is PF._mix64
    assert PD._mix64(a & PF._MASK) == _mix64(a & PF._MASK)


@settings(max_examples=40, deadline=None)
@given(st.integers(min_value=0, max_value=1 << 40),
       st.lists(st.tuples(I64, I64), min_size=1, max_size=64))
def test_client_trace_ids_equal_jax(seq0, pairs):
    aids = [p[0] for p in pairs]
    oids = [p[1] for p in pairs]
    got = PD.client_trace_ids(seq0, aids, oids)
    assert got == JD.client_trace_ids(seq0, aids, oids)
    assert got == [PD.client_trace_id(seq0 + i, a, o)
                   for i, (a, o) in enumerate(pairs)]


def _journal(tmp_path, trace_spans):
    msgs = harness_stream(300, seed=7, num_symbols=3, num_accounts=6,
                          payout_opcode_bug=False, validate=True)
    b = InProcessBroker()
    b.create_topic(SV.TOPIC_IN)
    b.create_topic(SV.TOPIC_OUT)
    for m in msgs:
        b.produce(SV.TOPIC_IN, None, dumps_order(m))
    jp = str(tmp_path / f"j{int(trace_spans)}.bin")
    svc = SV.MatchService(b, engine="seq", batch=64, symbols=8,
                          accounts=128, journal=jp, trace_spans=trace_spans,
                          pipeline=2, device="cpu")
    svc.run(max_messages=len(msgs))
    snap = svc.telemetry.snapshot()
    svc.close()
    return read_events(jp), snap, len(msgs)


def _doc(mod, spans):
    """A one-group doc in `stitch`'s shape, from collected spans."""
    orders = []
    for off in sorted({k[0] for k in spans}):
        ss = [dict(spans[(off, k)], li=off) for k in mod._STAGES
              if (off, k) in spans]
        tid = mod.local_tid(0, off)
        orders.append({"off": off, "tid": tid, "aid": 0,
                       "oid": ss[0]["oid"], "g": 0, "li": off, "legs": [],
                       "ltids": [tid], "complete": len(ss) == 4,
                       "t0": min(s["t0"] for s in ss),
                       "t1": max(s["t1"] for s in ss), "spans": ss})
    return {"groups": 1, "admitted": len(orders),
            "stitched": len(orders), "orders": orders, "counters": {}}


@pytest.mark.parametrize("trace_spans", [True, False])
def test_spans_waterfall_chrome_equal_jax(tmp_path, trace_spans):
    evs, _snap, n = _journal(tmp_path, trace_spans)
    assert any(ev["e"] == ("span" if trace_spans else "lat") for ev in evs)
    ps = PD.collect_group_spans(evs, 0)
    js = JD.collect_group_spans(evs, 0)
    assert ps == js and len(ps) == 4 * n
    for off, _k in list(ps)[:50]:
        ev = next(e for e in evs if e["e"] == "lat" and e["off"] == off)
        assert PD._spans_from_lat(ev, 0) == JD._spans_from_lat(ev, 0)
    doc = _doc(PD, ps)
    assert PD.chrome_trace_doc(doc) == JD.chrome_trace_doc(doc)
    for o in doc["orders"][:20]:
        assert PD.waterfall_text(o) == JD.waterfall_text(o)
    spec = f"{doc['orders'][3]['aid']}:{doc['orders'][3]['oid']}"
    assert PD.find_order(doc, spec) == JD.find_order(doc, spec)
    assert PD.find_order(doc, hex(doc["orders"][5]["tid"])) \
        == JD.find_order(doc, hex(doc["orders"][5]["tid"]))


def test_aggregate_equal_jax(tmp_path):
    _evs, snap, _n = _journal(tmp_path, True)
    assert snap["exemplars"] and snap["latencies"]["lat_e2e"]["count"]
    p = tmp_path / "m.json"
    p.write_text(json.dumps(snap))
    paths = [str(p), str(tmp_path / "missing.json")]
    snaps = PD.load_snapshots(paths)
    assert snaps == JD.load_snapshots(paths)
    up = [(name, sn) for name, sn in snaps if sn]
    assert PD.merge_latencies(up) == JD.merge_latencies(up)
    stale = {str(p): {"age_s": 9.0, "intervals": 9.0, "sample_seq": 3}}
    for kw in ({}, {"slo_ms": 0.5, "slo_target": 0.99},
               {"stale": stale}):
        doc = PD.aggregate(snaps, **kw)
        assert doc == JD.aggregate(snaps, **kw)
        # the same text, naming the port's tools
        assert PD.render_agg(doc).replace("kme-torch-", "kme-") \
            == JD.render_agg(doc)


def test_front_dependent_functions_raise():
    """The cluster half runs on the port's front: a malformed line maps
    to no route, and only a run dir without groups raises."""
    entries, router = PD.route_map(["x"], 2)
    assert entries == [None] == JD.route_map(["x"], 2)[0]
    assert PD.stitch(["x"], {}, 2)["admitted"] == 0
    with pytest.raises(FileNotFoundError, match="no group"):
        PD.stitch_state_root("/nonexistent")
    assert PD.SPAN_KINDS == JD.SPAN_KINDS
    assert PD.discover_groups("/nonexistent") == []


def grouped_run_dir(root, ngroups=2, events=300, seed=11):
    """A multi-leader run directory (`front.in`, `front.trace` and
    `group{k}/state/` with a journal, persisted broker log and
    checkpoints): the port's front splits a cross-account stream and
    one port seq service per group serves it on the CPU."""
    import os

    from kme_tpu_torch.bridge import front
    from kme_tpu_torch.bridge.provision import group_topics, provision
    from kme_tpu_torch.workload import cross_account_stream

    lines = [dumps_order(m) for m in cross_account_stream(
        events, 16, 12, ngroups, seed=seed, cross_frac=1.0)]
    os.makedirs(root)
    with open(os.path.join(root, "front.in"), "w") as f:
        f.write("".join(ln + "\n" for ln in lines))
    front.write_front_trace(os.path.join(root, "front.trace"), lines,
                            ngroups)
    per, _router = front.split_lines(lines, ngroups)
    for k in range(ngroups):
        gdir = os.path.join(root, f"group{k}", "state")
        br = InProcessBroker(persist_dir=os.path.join(gdir, "broker-log"))
        provision(br, topics=group_topics(k))
        for ln in per[k]:
            br.produce(f"MatchIn.g{k}", None, ln)
        svc = SV.MatchService(br, engine="seq", batch=64, symbols=16,
                              accounts=64, slots=128, max_fills=16,
                              group=(k, ngroups), checkpoint_dir=gdir,
                              checkpoint_every=128,
                              journal=os.path.join(gdir, "journal.bin"),
                              trace_spans=True, device="cpu")
        assert svc.run(max_messages=len(per[k])) == len(per[k])
        svc.close()
        br.sync()
    return lines


def test_cluster_stitch_equals_jax(tmp_path):
    root = str(tmp_path / "run")
    lines = grouped_run_dir(root)
    entries, router = PD.route_map(lines, 2)
    jentries, jrouter = JD.route_map(lines, 2)
    assert entries == jentries and router.counters == jrouter.counters
    assert any(e["legs"] for e in entries)
    doc = PD.stitch_state_root(root)
    assert doc["admitted"] == len(lines) == doc["stitched"]
    assert doc == JD.stitch_state_root(root)
    o = doc["orders"][-1]
    assert PD.find_order(doc, f"{o['aid']}:{o['oid']}") == \
        JD.find_order(doc, f"{o['aid']}:{o['oid']}")
    assert PD.waterfall_text(o) == JD.waterfall_text(o)
    assert PD.chrome_trace_doc(doc) == JD.chrome_trace_doc(doc)


@pytest.mark.parametrize("seed", range(4))
def test_slow_order_exemplars_equal_jax(seed):
    """The port's `_stamp_orders` keeps the same slow-order exemplars as
    the JAX package's over batches whose admission stamps rise, tie and
    go missing (journal off: the exemplar surface alone)."""
    import types

    import numpy as np
    from kme_tpu.bridge.service import MatchService as JService

    rng = np.random.default_rng(seed)

    class Reg:
        def __init__(self):
            self.seen = []

        def set_exemplars(self, ex):
            self.seen.append([dict(e) for e in ex])

    def svc():
        return types.SimpleNamespace(journal=None, trace_spans=False,
                                     _slow=[], telemetry=Reg(),
                                     group_id=0, _EXEMPLARS=8)

    port, ref = svc(), svc()
    off = 0
    for b in range(12):
        n = int(rng.integers(0, 40))
        offs = list(range(off, off + n))
        off += n
        ids = rng.integers(0, 1 << 40, size=(2, n)).tolist()
        atss = [None if rng.random() < 0.1 else int(a)
                for a in rng.integers(0, 50, size=n)]
        args = (offs, ids[0], ids[1], atss, 100, 100 + 10 * (b % 5),
                1, 2, 3)
        SV.MatchService._stamp_orders(port, *args, batch=b)
        JService._stamp_orders(ref, *args, batch=b)
        assert port._slow == ref._slow
    assert port.telemetry.seen == ref.telemetry.seen
    assert len(ref.telemetry.seen) > 1
