"""The port's multi-leader front (`kme_tpu_torch/bridge/front.py`) and
its grouped service, against the JAX package's, on the CPU.

Exact equality throughout (tolerance 0):
- group assignment: the scalar, numpy and native (kme_group_assign)
  passes equal `kme_tpu`'s, and each other;
- the split: every group's substream (organic lines and injected
  transfer legs) equals `kme_tpu`'s byte for byte at N in {1, 2, 4}, on
  zipf and on the cross-account profile, with the same router counters;
- the merge: `merge_records` is invariant under interleaving and
  `verify_groups` holds N oracle groups to the single leader;
- `accept_frames`, native and under KME_NATIVE=0, equals `kme_tpu`'s
  (routes, columns, and the one-call plan);
- `MatchService(group=(k, n))` of each package, seq on CPU tensors and
  the oracle, serial and pipelined: MatchOut.gK and the stamped Xfer.gK
  logs are equal, and a snapshot carrying `pending_reserve` resumes in
  the other package;
- `FrontLinks` into the port's `serve_broker`, and the `kme-torch-front`
  CLI's split / merge / verify / route.
"""

import dataclasses
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from kme_tpu import native as JN
from kme_tpu import workload as JWL
from kme_tpu.bridge import front as JF
from kme_tpu.bridge import service as JSV
from kme_tpu.bridge.broker import InProcessBroker as JaxBroker
from kme_tpu.wire import dumps_order
from kme_tpu_torch import native as PN
from kme_tpu_torch import wire as W
from kme_tpu_torch import workload as WL
from kme_tpu_torch.bridge import front as F
from kme_tpu_torch.bridge import service as SV
from kme_tpu_torch.bridge.broker import InProcessBroker
from kme_tpu_torch.bridge.provision import group_topics, provision
from kme_tpu_torch.oracle import OracleEngine

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ_KW = dict(engine="seq", compat="fixed", batch=64, symbols=16,
              accounts=64, slots=128, max_fills=16)
ORACLE_KW = dict(engine="oracle", compat="fixed", batch=64, slots=64,
                 max_fills=16)
SERVICE_MODES = {
    "seq": SEQ_KW,
    "seq_pipeline2": dict(SEQ_KW, pipeline=2),
    "lanes": dict(SEQ_KW, engine="lanes", slots=64, width=8),
    "oracle": ORACLE_KW,
    "native": dict(ORACLE_KW, engine="native"),
}


def _zipf(events=500, symbols=16, accounts=12, seed=9):
    return [dumps_order(m) for m in JWL.zipf_symbol_stream(
        events, num_symbols=symbols, num_accounts=accounts, seed=seed)]


def _cross(events=400, ngroups=2, seed=4):
    return [dumps_order(m) for m in JWL.cross_account_stream(
        events, 16, 12, ngroups, seed=seed, cross_frac=1.0)]


# -- assignment ---------------------------------------------------------


def _keys():
    rng = random.Random(11)
    keys = [rng.randrange(-(2 ** 63), 2 ** 63) for _ in range(2000)]
    return keys + [0, 1, -1, -7, 2 ** 53, (1 << 63) - 1, -(1 << 63)]


@pytest.mark.parametrize("how", ["scalar", "numpy", "native"])
def test_assignment_equals_jax(how, monkeypatch):
    keys = _keys()
    for n in (1, 2, 3, 4, 7):
        for salt in (F.SALT_SYMBOL, F.SALT_ACCOUNT):
            want = [JF.group_of(k, n, salt) for k in keys]
            if how == "scalar":
                got = [F.group_of(k, n, salt) for k in keys]
            else:
                if how == "numpy":
                    monkeypatch.setenv("KME_NATIVE", "0")
                    assert PN.load_library() is None
                else:
                    assert PN.load_library() is not None
                got = F.assign_groups(keys, n, salt).tolist()
            assert got == want, (how, n, salt)
    assert [F.symbol_group(s, 4) for s in range(-50, 50)] == \
        [JF.symbol_group(s, 4) for s in range(-50, 50)]
    assert [F.account_group(a, 3) for a in range(200)] == \
        [JF.account_group(a, 3) for a in range(200)]


# -- split and merge ----------------------------------------------------


@pytest.mark.parametrize("ngroups", [1, 2, 4])
@pytest.mark.parametrize("kind", ["zipf", "cross"])
def test_split_equals_jax(kind, ngroups):
    lines = _zipf() if kind == "zipf" else _cross(ngroups=ngroups)
    for prefund in (1, 8):
        got, pr = F.split_lines(lines, ngroups, prefund=prefund)
        want, jr = JF.split_lines(lines, ngroups, prefund=prefund)
        assert got == want
        assert pr.counters == jr.counters
        assert pr.reserve == jr.reserve
    if ngroups > 1:
        assert pr.counters["cross_shard_transfers_total"] > 0
        assert pr.counters["transfer_shortfall_total"] == 0


def test_merge_and_verify_groups():
    lines = _cross(ngroups=3)
    per, _ = F.split_lines(lines, 3)
    engines = [OracleEngine("fixed") for _ in range(3)]
    records, outs = [], [[] for _ in range(3)]
    for g in range(3):
        for seq, rec in enumerate(r for ln in per[g]
                                  for r in engines[g].process(
                                      W.parse_order(ln))):
            records.append((g, seq, rec.wire()))
            outs[g].append(rec.wire())
    want = F.merge_records(records)
    rng = random.Random(5)
    for _ in range(4):
        shuffled = records[:]
        rng.shuffle(shuffled)
        assert F.merge_records(shuffled) == want
    assert F.merge_streams(outs) == want == JF.merge_streams(outs)
    assert not any(F.is_internal_line(ln) for ln in want)
    rep = F.verify_groups(lines, outs)
    assert rep["ok"], rep["mismatches"][:1]
    assert rep == JF.verify_groups(lines, outs)
    # one wrong record is found
    outs[1][3] = outs[1][3].replace('"size":', '"size":9')
    assert not F.verify_groups(lines, outs)["ok"]


def test_internal_lines_equal_jax():
    for aid, amount, xid in ((7, -100, 0), (0, 5, 3), (2 ** 40, 1, 99)):
        assert F.make_internal_transfer(aid, amount, xid) == \
            JF.make_internal_transfer(aid, amount, xid)
        assert F.make_internal_create(aid, xid) == \
            JF.make_internal_create(aid, xid)
    assert (F.XFER_MARK, F._MARK_SUB) == (JF.XFER_MARK, JF._MARK_SUB)


def test_router_reshard_equals_jax():
    lines = _cross(ngroups=2)
    pr, jr = F.GroupRouter(2), JF.GroupRouter(2)
    assert pr.split(lines[:300]) == jr.split(lines[:300])
    assert pr.reshard(4) == jr.reshard(4)
    assert pr.split(lines[300:]) == jr.split(lines[300:])
    assert pr.counters == jr.counters


# -- the native acceptor ------------------------------------------------


def _frames(n=200, seed=1):
    rng = np.random.default_rng(seed)
    return [W.OrderMsg(
        action=int(rng.choice([0, 1, 2, 3, 4, 100, 101, 200])),
        oid=i + 1, aid=int(rng.integers(1, 64)),
        sid=int(rng.integers(-4, 9)), price=int(rng.integers(1, 100)),
        size=int(rng.integers(1, 10)), next=None if i % 3 else i + 2,
        prev=None if i % 5 else -i) for i in range(n)]


def _batch_cols(wb):
    return [np.asarray(c).tolist() for c in (
        wb.action, wb.oid, wb.aid, wb.sid, wb.price, wb.size,
        wb.hnext, wb.hprev)]


@pytest.mark.parametrize("native", [True, False])
def test_accept_frames_equals_jax(native, monkeypatch):
    if not native:
        monkeypatch.setenv("KME_NATIVE", "0")
    buf = W.encode_frames(_frames())
    for n in (1, 2, 4, 7):
        wb, groups, plan = F.accept_frames(buf, n)
        jwb, jgroups, _ = JF.accept_frames(buf, n)
        assert plan is None and groups.dtype == np.int32
        assert groups.tolist() == jgroups.tolist()
        assert _batch_cols(wb) == _batch_cols(jwb)
        assert groups.tolist() == F.accept_routes(
            wb.action, wb.oid, wb.aid, wb.sid, n).tolist()
    bad = bytearray(buf)
    bad[0] = 0x7B
    with pytest.raises(W.WireFrameError) as pe:
        F.accept_frames(bytes(bad), 2)
    from kme_tpu import wire as JW

    with pytest.raises(JW.WireFrameError) as je:
        JF.accept_frames(bytes(bad), 2)
    assert str(pe.value) == str(je.value)


def test_accept_frames_one_call_plan_equals_jax():
    from kme_tpu.runtime.seqsession import NativeSeqRouter as JRouter
    from kme_tpu_torch.native import sched
    from kme_tpu_torch.runtime.seqsession import NativeSeqRouter

    lib, jlib = PN.load_library(), JN.load_library()
    msgs = [m for m in _frames(120, seed=2) if m.action in (0, 1, 2, 3, 4)]
    buf = W.encode_frames(msgs)
    B = 16
    # the stacked planes are views of each router's pack buffer: the
    # routers stay alive while they are read
    r1, r2, jr = (NativeSeqRouter(64, 512, lib),
                  NativeSeqRouter(64, 512, lib), JRouter(64, 512, jlib))
    _wb, _g, plan = F.accept_frames(buf, 1, router=r1, B=B)
    _jwb, _jg, jplan = JF.accept_frames(buf, 1, router=jr, B=B)
    want = sched.plan_batch(r2, W.WireBatch.parse_frames(buf), B)
    for other in (jplan, want):
        cols_a, rej_a, stacked_a, cnts_a, k_a = plan
        cols_b, rej_b, stacked_b, cnts_b, k_b = other
        assert (k_a, rej_a, cnts_a) == (k_b, rej_b, cnts_b)
        assert set(stacked_a) == set(stacked_b)
        for name in stacked_a:
            assert np.array_equal(stacked_a[name], stacked_b[name]), name
        for name in cols_a:
            assert np.array_equal(cols_a[name], cols_b[name]), name


# -- the grouped service ------------------------------------------------


def _grouped_run(mod, broker_mod, glines, k, n, root, max_messages=None,
                 **kw):
    """Serve group k's substream exactly once over a persisted log;
    returns (MatchOut.gK, Xfer.gK) as (epoch, out_seq, key, value)."""
    b = broker_mod(persist_dir=os.path.join(root, "log"))
    topics = group_topics(k)
    for t in topics:
        try:
            b.create_topic(t)
        except Exception:
            pass
    if b.end_offset(topics[0]) == 0:
        for ln in glines:
            b.produce(topics[0], None, ln)
    if mod is SV:
        kw["device"] = "cpu"
    svc = mod.MatchService(b, group=(k, n), exactly_once=True,
                           checkpoint_dir=os.path.join(root, "ck"), **kw)
    todo = len(glines) - svc.offset if max_messages is None \
        else max_messages
    assert svc.run(max_messages=todo) == todo
    if max_messages is not None:
        svc.checkpoint()
    xfer = dict(svc._xfer)
    svc.close()
    recs = [[(r.epoch, r.out_seq, r.key, r.value)
             for r in b.fetch(t, 0, 10 ** 9)] for t in topics[1:]]
    close = getattr(b, "close", None)
    if close is not None:
        close()
    return recs, xfer


@pytest.mark.parametrize("mode", sorted(SERVICE_MODES))
def test_grouped_service_equals_jax(mode, tmp_path):
    kw = SERVICE_MODES[mode]
    lines = _cross(ngroups=2)
    per, router = F.split_lines(lines, 2)
    outs = []
    for k in range(2):
        got, gx = _grouped_run(SV, InProcessBroker, per[k], k, 2,
                               str(tmp_path / f"p{k}"), **kw)
        want, jx = _grouped_run(JSV, JaxBroker, per[k], k, 2,
                                str(tmp_path / f"j{k}"), **kw)
        assert got == want and gx == jx
        out, xfer = got
        assert xfer and not any(F.is_internal_line(r[3]) for r in out)
        assert all(F.is_internal_line(r[3]) for r in xfer)
        # one out_seq cursor over both topics, no stamp twice
        seqs = sorted(r[1] for r in out + xfer)
        assert seqs == list(range(len(seqs)))
        outs.append([f"{r[2]} {r[3]}" for r in out])
    assert gx["legs"] > 0
    rep = F.verify_groups(lines, outs, book_slots=kw["slots"],
                          max_fills=kw["max_fills"])
    assert rep["ok"], rep["mismatches"][:1]


@pytest.mark.parametrize("engine", ["seq", "oracle"])
@pytest.mark.parametrize("first", ["port", "jax"])
def test_grouped_snapshot_resumes_across_packages(first, engine, tmp_path):
    """A group's exactly-once snapshot carries `pending_reserve`; the
    other package resumes it from the same checkpoint dir and log, and
    finishes with the uninterrupted run's MatchOut.g0, Xfer.g0 and
    ledger."""
    kw = SEQ_KW if engine == "seq" else ORACLE_KW
    lines = _cross(ngroups=2)
    g0 = F.split_lines(lines, 2)[0][0]
    a, b = ((SV, InProcessBroker), (JSV, JaxBroker))[::1 if first == "port"
                                                     else -1]
    whole, wx = _grouped_run(*a, g0, 0, 2, str(tmp_path / "w"), **kw)
    root = str(tmp_path / "r")
    half = 2 * kw["batch"]              # a batch boundary mid-stream
    assert len(g0) > 2 * half
    _part, px = _grouped_run(*a, g0, 0, 2, root, max_messages=half, **kw)
    assert 0 < px["legs"] < wx["legs"]
    from kme_tpu_torch.runtime import checkpoint as ck

    extra = ck.snapshot_extra(os.path.join(root, "ck"), half)
    assert extra["pending_reserve"] == px
    rest, rx = _grouped_run(*b, g0, 0, 2, root, **kw)
    assert rx == wx
    # stamps carry the new epoch after the resume; values and cursor
    # positions equal the uninterrupted run's
    assert [r[1:] for t in rest for r in t] == \
        [r[1:] for t in whole for r in t]


# -- FrontLinks and the CLI ---------------------------------------------


@pytest.mark.parametrize("batch", [False, True])
def test_frontlinks_into_port_brokers(batch):
    """FrontLinks into the port's serve_broker, a record per round trip
    (`route`) or in batches (`send_batch`): each group's MatchIn.gK log
    is `kme_tpu`'s split, stamped 0..n-1; a replayed stamp (one record,
    or a batch whose prefix landed) appends nothing twice."""
    from kme_tpu_torch.bridge.tcp import serve_broker

    lines = _cross(ngroups=2)
    per, _ = JF.split_lines(lines, 2)
    servers = [serve_broker("127.0.0.1", 0) for _ in range(2)]
    try:
        addrs = ["%s:%d" % s.server_address[:2] for s, _b in servers]
        links = F.FrontLinks(addrs)
        if batch:
            for g in range(2):
                for lo in range(0, len(per[g]) - 5, 100):
                    links.send_batch(g, per[g][lo:min(lo + 100,
                                                      len(per[g]) - 5)])
            # a retried batch: its first 3 records already landed
            links.cursor[0] -= 3
            assert links.send_batch(0, per[0][-8:]) >= 0
            links.send_batch(1, per[1][-5:])
        else:
            router = F.GroupRouter(2)
            for ln in lines:
                links.route(router, ln)
            # a replayed stamp is swallowed by the broker's watermark
            links.cursor[0] -= 1
            assert links.send(0, "dup") == -1
            assert links.snapshot()["links"][0]["dup_suppressed"] == 1
        snap = links.snapshot()
        links.close()
        for g, (_s, b) in enumerate(servers):
            recs = b.fetch(f"MatchIn.g{g}", 0, 10 ** 9)
            assert [r.value for r in recs] == per[g]
            assert [r.out_seq for r in recs] == list(range(len(per[g])))
        assert snap["cursors"] == [len(p) for p in per]
        assert b.dup_suppressed == 0
        assert servers[0][1].dup_suppressed == (3 if batch else 1)
    finally:
        for s, _b in servers:
            s.shutdown()
            s.server_close()


def _cli(*args, stdin=None):
    block = ("import sys\n"
             "class B:\n"
             "    def find_spec(self, n, p=None, t=None):\n"
             "        if n.split('.')[0] in ('jax', 'kme_tpu'):\n"
             "            raise ImportError('blocked: ' + n)\n"
             "sys.meta_path.insert(0, B())\n"
             "from kme_tpu_torch.cli import main\n"
             "sys.exit(main(sys.argv[1:]))\n")
    return subprocess.run([sys.executable, "-c", block, "front", *args],
                          cwd=ROOT, capture_output=True, text=True,
                          input=stdin, timeout=120)


def test_front_cli_split_merge_verify(tmp_path):
    lines = _cross(ngroups=2)
    inp = tmp_path / "in.jsonl"
    inp.write_text("\n".join(lines) + "\n")
    d = tmp_path / "split"
    r = _cli("split", "--groups", "2", "--input", str(inp), "--out-dir",
             str(d), "--trace-out", str(tmp_path / "front.trace"))
    assert r.returncode == 0, r.stderr
    per, _ = JF.split_lines(lines, 2)
    for g in range(2):
        assert (d / f"group{g}.in").read_text().splitlines() == per[g]
        eng = OracleEngine("fixed")
        (d / f"group{g}.out").write_text("".join(
            rec.wire() + "\n" for ln in per[g]
            for rec in eng.process(W.parse_order(ln))))
    r = _cli("verify", "--groups", "2", "--input", str(inp), "--in-dir",
             str(d))
    assert r.returncode == 0 and "parity OK" in r.stderr, r.stderr
    r = _cli("merge", "--groups", "2", "--in-dir", str(d))
    assert r.returncode == 0
    outs = [(d / f"group{g}.out").read_text().splitlines()
            for g in range(2)]
    assert r.stdout.splitlines() == JF.merge_streams(outs)
    # the front's trace file equals the JAX package's
    from kme_tpu.telemetry import journal as JJ

    JF.write_front_trace(str(tmp_path / "j.trace"), lines, 2)
    strip = [{k: v for k, v in ev.items() if k not in ("t0", "t1", "ts")}
             for ev in JJ.read_events(str(tmp_path / "front.trace"))]
    assert strip == [{k: v for k, v in ev.items() if k not in ("t0", "t1", "ts")}
                     for ev in JJ.read_events(str(tmp_path / "j.trace"))]


def test_front_cli_route_to_port_serves(tmp_path):
    """`kme-torch-front route` feeds two `kme-torch-serve --group k/2`
    processes (oracle engine) over TCP; each group's MatchOut equals the
    JAX package's grouped service on the same substream."""
    lines = _zipf(300)
    inp = tmp_path / "in.jsonl"
    inp.write_text("\n".join(lines) + "\n")
    procs, addrs = [], []
    for g in range(2):
        p = subprocess.Popen(
            [sys.executable, "-m", "kme_tpu_torch.cli", "serve",
             "--listen", "127.0.0.1:0", "--engine", "oracle",
             "--group", f"{g}/2", "--auto-provision", "--idle-exit", "3",
             "--slots", "64", "--max-fills", "16",
             "--checkpoint-dir", str(tmp_path / f"group{g}")],
            cwd=ROOT, stderr=subprocess.PIPE, text=True)
        procs.append(p)
        for line in p.stderr:
            if "listening on" in line:
                addrs.append(line.rsplit(" ", 1)[1].strip())
                break
    try:
        r = _cli("route", "--groups", "2", "--brokers", ",".join(addrs),
                 "--input", str(inp))
        assert r.returncode == 0, r.stderr
    finally:
        for p in procs:
            p.stderr.read()
            assert p.wait(timeout=60) == 0
    per, _ = JF.split_lines(lines, 2)
    for g in range(2):
        b = InProcessBroker(persist_dir=str(tmp_path / f"group{g}" /
                                            "broker-log"))
        got = [f"{r.key} {r.value}"
               for r in b.fetch(f"MatchOut.g{g}", 0, 10 ** 9)]
        jb = JaxBroker()
        provision(jb, topics=group_topics(g))
        for ln in per[g]:
            jb.produce(f"MatchIn.g{g}", None, ln)
        svc = JSV.MatchService(jb, group=(g, 2), **ORACLE_KW)
        svc.run(max_messages=len(per[g]))
        assert got == [f"{r.key} {r.value}"
                       for r in jb.fetch(f"MatchOut.g{g}", 0, 10 ** 9)]


def test_workload_cross_account_equals_jax():
    a = JWL.cross_account_stream(300, 16, 12, 4, seed=2, cross_frac=0.5)
    b = WL.cross_account_stream(300, 16, 12, 4, seed=2, cross_frac=0.5)
    assert [dataclasses.astuple(m) for m in a] == \
        [dataclasses.astuple(m) for m in b]
