"""The port's hot-standby replica (`kme_tpu_torch/bridge/replica.py`)
against the JAX package's.

- the analogs of tests/test_replica.py: the _FollowBroker tail, the
  pid-addressed promote order, the leader-role bound, and the follow ->
  promote state machine end to end (exactly once across the failover),
  here for the oracle engine and for the seq engine on CPU tensors (its
  kernel's plain version), at the reference's size;
- a log written by `kme_tpu`'s InProcessBroker, tailed by both packages'
  _FollowBroker: the same records;
- the same failover through both packages' Replica (oracle engine, the
  same kill points): equal durable MatchOut rows, stamps included;
- `kme-torch-top` over a live leader / standby pair (the analog of
  tests/test_top.py's live smoke).
Tolerance 0 everywhere: lines and stamps are compared for equality.
"""

import json
import os
import threading
import time

import pytest
import torch

from kme_tpu.bridge import broker as JBR
from kme_tpu.bridge import lease as JLEASE
from kme_tpu.bridge import provision as JPROV
from kme_tpu.bridge import replica as JREP
from kme_tpu.bridge import service as JSV
from kme_tpu.workload import harness_stream
from kme_tpu_torch.bridge import broker as BR
from kme_tpu_torch.bridge import lease
from kme_tpu_torch.bridge import provision as PROV
from kme_tpu_torch.bridge import replica as REP
from kme_tpu_torch.bridge import service as SV
from kme_tpu_torch.bridge.broker import BrokerError, InProcessBroker
from kme_tpu_torch.bridge.consume import DedupRing
from kme_tpu_torch.bridge.provision import provision
from kme_tpu_torch.bridge.replica import Replica, _FollowBroker
from kme_tpu_torch.bridge.service import TOPIC_IN, TOPIC_OUT, MatchService
from kme_tpu_torch.telemetry import start_metrics_server
from kme_tpu_torch.telemetry.top import main as top_main
from kme_tpu_torch.telemetry.top import scrape
from kme_tpu_torch.wire import dumps_order

torch.set_num_threads(1)

# the two packages' pieces of one failover drill
PORT = dict(broker=BR.InProcessBroker, provision=PROV.provision,
            service=SV.MatchService, replica=REP.Replica,
            lease=lease, dev=dict(device="cpu"))
JAX = dict(broker=JBR.InProcessBroker, provision=JPROV.provision,
           service=JSV.MatchService, replica=JREP.Replica,
           lease=JLEASE, dev={})
ORACLE_KW = dict(engine="oracle", compat="fixed", batch=16, slots=64,
                 max_fills=32)
SEQ_KW = dict(engine="seq", compat="fixed", batch=16, symbols=8,
              accounts=128, slots=128, max_fills=32)


# ---------------------------------------------------------------------------
# _FollowBroker: a bounded tail over the leader's durable MatchIn log


def _log(tmp_path, lines):
    path = tmp_path / f"{TOPIC_IN}.log"
    with open(path, "ab") as f:
        for ln in lines:
            f.write(ln)
    return path


def test_follow_broker_tails_and_respects_limit(tmp_path):
    fb = _FollowBroker(str(tmp_path))
    assert fb.fetch(TOPIC_IN, 0, 10) == []      # log not created yet
    _log(tmp_path, [b'["k", "a"]\n', b'["k", "b"]\n', b'["k", "c"]\n'])
    assert fb.fetch(TOPIC_IN, 0, 10) == []      # limit still 0
    fb.limit = 2
    assert [r.value for r in fb.fetch(TOPIC_IN, 0, 10)] == ["a", "b"]
    assert fb.end_offset(TOPIC_IN) == 3         # end_offset is unbounded
    fb.limit = 10
    _log(tmp_path, [b'["k", "d", 2, 7]\n'])     # stamped row tails too
    recs = fb.fetch(TOPIC_IN, 0, 10)
    assert [r.value for r in recs] == ["a", "b", "c", "d"]
    assert (recs[3].epoch, recs[3].out_seq) == (2, 7)
    assert recs[0].epoch is None


def test_follow_broker_leaves_torn_tail_unconsumed(tmp_path):
    fb = _FollowBroker(str(tmp_path))
    fb.limit = 10
    _log(tmp_path, [b'["k", "a"]\n', b'["k", "b'])      # torn mid-append
    assert [r.value for r in fb.fetch(TOPIC_IN, 0, 10)] == ["a"]
    _log(tmp_path, [b'"]\n'])                           # append completes
    assert [r.value for r in fb.fetch(TOPIC_IN, 0, 10)] == ["a", "b"]


def test_follow_broker_resets_when_file_shrinks(tmp_path):
    fb = _FollowBroker(str(tmp_path))
    fb.limit = 10
    path = _log(tmp_path, [b'["k", "a"]\n', b'["k", "b"]\n'])
    assert len(fb.fetch(TOPIC_IN, 0, 10)) == 2
    with open(path, "wb") as f:                 # fresh run reused the dir
        f.write(b'["k", "z"]\n')
    fb.fetch(TOPIC_IN, 0, 10)                   # notices the truncation
    assert [r.value for r in fb.fetch(TOPIC_IN, 0, 10)] == ["z"]


def test_follow_broker_rejects_unknown_topic_and_counts_discards(tmp_path):
    fb = _FollowBroker(str(tmp_path))
    with pytest.raises(BrokerError):
        fb.fetch(TOPIC_OUT, 0, 10)
    assert fb.produce(TOPIC_OUT, "OUT", "x") == -1
    assert fb.produce(TOPIC_OUT, "OUT", "y") == -1
    assert fb.discarded == 2


def test_follow_broker_reads_a_jax_written_log_as_jax_does(tmp_path):
    """A log written by kme_tpu's durable broker (plain and stamped
    produces), tailed by both packages' _FollowBroker with a torn tail
    appended: the same records, field for field."""
    b = JBR.InProcessBroker(persist_dir=str(tmp_path))
    JPROV.provision(b)
    msgs = [dumps_order(m) for m in harness_stream(
        40, seed=9, num_accounts=4, num_symbols=2,
        payout_opcode_bug=False, validate=True)]
    for i, m in enumerate(msgs):
        if i % 3:
            b.produce(TOPIC_IN, None, m)
        else:
            b.produce(TOPIC_IN, "k", m, epoch=1, out_seq=i)
    _log(tmp_path, [b'["k", "torn'])
    mine, theirs = _FollowBroker(str(tmp_path)), \
        JREP._FollowBroker(str(tmp_path))
    for fb in (mine, theirs):
        fb.limit = 1 << 30
    got = [(r.offset, r.key, r.value, r.epoch, r.out_seq)
           for r in mine.fetch(TOPIC_IN, 0, 1000)]
    want = [(r.offset, r.key, r.value, r.epoch, r.out_seq)
            for r in theirs.fetch(TOPIC_IN, 0, 1000)]
    assert got == want and len(got) == len(msgs)
    assert [g[2] for g in got] == msgs
    assert mine.end_offset(TOPIC_IN) == theirs.end_offset(TOPIC_IN)


# ---------------------------------------------------------------------------
# the promote order is pid-addressed


def _mk_replica(tmp_path, **kw):
    ck = str(tmp_path / "ck")
    os.makedirs(ck, exist_ok=True)
    kw.setdefault("engine", "oracle")
    kw.setdefault("batch", 16)
    kw.setdefault("slots", 64)
    kw.setdefault("max_fills", 32)
    kw.setdefault("poll", 0.02)
    kw.setdefault("health_every", 0.05)
    kw.setdefault("device", "cpu")
    return Replica(ck, listen="127.0.0.1:0", **kw)


def test_read_promote_ignores_orders_for_other_pids(tmp_path):
    rep = _mk_replica(tmp_path)
    assert rep._read_promote() is None          # no file
    with open(rep.promote_file, "w") as f:
        json.dump({"failed_at": 1.0, "pid": os.getpid() + 1}, f)
    assert rep._read_promote() is None          # someone else's order
    assert os.path.exists(rep.promote_file)     # ...and left intact
    with open(rep.promote_file, "w") as f:
        json.dump({"failed_at": 1.0, "pid": os.getpid()}, f)
    assert rep._read_promote()["failed_at"] == 1.0
    with open(rep.promote_file, "w") as f:
        json.dump({"failed_at": 2.0}, f)        # pid-less: manual/test
    assert rep._read_promote()["failed_at"] == 2.0


def test_leader_offset_requires_leader_role(tmp_path):
    rep = _mk_replica(tmp_path)
    assert rep._leader_offset() == 0
    with open(rep.serve_health, "w") as f:
        json.dump({"role": "standby", "offset": 99}, f)
    assert rep._leader_offset() == 0            # never follow a follower
    with open(rep.serve_health, "w") as f:
        json.dump({"role": "leader", "offset": 80}, f)
    assert rep._leader_offset() == 80


# ---------------------------------------------------------------------------
# follow -> promote, end to end (threads, no subprocesses)


def _failover(pkg, root, kw, msgs):
    """The reference's drill with one package's pieces: a leader
    checkpoints at 48, keeps producing durably through 80 and dies; the
    standby (snapshot 48, holdback-bounded tail) is promoted and finishes
    the stream. -> (durable MatchOut rows, the replica, its thread's rc,
    the held offset)."""
    ck = os.path.join(root, "ck")
    os.makedirs(ck)
    log_dir = os.path.join(ck, "broker-log")
    batch = kw["batch"]
    b = pkg["broker"](persist_dir=log_dir)
    pkg["provision"](b)
    for m in msgs:
        b.produce(TOPIC_IN, None, m)
    leader = pkg["service"](b, checkpoint_dir=ck, exactly_once=True,
                            **kw, **pkg["dev"])
    assert leader.epoch == 1
    leader.run(max_messages=48)
    leader.checkpoint()
    leader.run(max_messages=32)                 # durable but un-snapshotted
    with open(os.path.join(ck, "serve.health"), "w") as f:
        json.dump({"pid": 1, "time": time.time(), "role": "leader",
                   "offset": leader.offset, "tick": 9}, f)
    assert leader.offset == 80
    del leader                                  # SIGKILL: no teardown

    rep = pkg["replica"](ck, listen="127.0.0.1:0", poll=0.02,
                         health_every=0.05, idle_exit=0.5,
                         health_file=os.path.join(ck, "standby.health"),
                         **kw, **pkg["dev"])
    assert rep.svc.offset == 48                 # restored the snapshot
    rc = [None]
    t = threading.Thread(target=lambda: rc.__setitem__(0, rep.run()),
                         daemon=True)
    t.start()
    deadline = time.monotonic() + 60.0
    while rep.svc.offset < 80 - batch and time.monotonic() < deadline:
        time.sleep(0.02)
    held = rep.svc.offset
    time.sleep(0.1)
    assert rep.svc.offset == held               # ...and it HOLDS
    assert rep.follow.discarded > 0             # output counted, not kept
    assert os.path.exists(os.path.join(ck, "standby.health"))

    with open(rep.promote_file, "w") as f:      # pid-less: test-driven
        json.dump({"failed_at": time.time()}, f)
    t.join(timeout=120.0)
    assert not t.is_alive()
    rows = [json.loads(ln) for ln in
            open(os.path.join(log_dir, f"{TOPIC_OUT}.log"))]
    return rows, rep, rc[0], held


def _reference_lines(msgs, kw):
    b = InProcessBroker()
    provision(b)
    for m in msgs:
        b.produce(TOPIC_IN, None, m)
    ref = MatchService(b, device="cpu", **kw)
    ref.run(max_messages=len(msgs))
    return [r.value for r in b.fetch(TOPIC_OUT, 0, 10 ** 6)]


def _msgs():
    return [dumps_order(m) for m in harness_stream(
        112, seed=5, num_accounts=4, num_symbols=2,
        payout_opcode_bug=False, validate=True)]


@pytest.mark.parametrize("kw", [ORACLE_KW, SEQ_KW], ids=["oracle", "seq"])
def test_failover_is_exactly_once_end_to_end(tmp_path, kw):
    """The standby is promoted: it must re-produce the checkpoint..
    durable overlap, have every duplicate stamp suppressed, and finish
    the stream byte-exact with a clean single-leader run (and the
    oracle's, for the seq engine)."""
    msgs = _msgs()
    rows, rep, rc, held = _failover(PORT, str(tmp_path), kw, msgs)
    ck = str(tmp_path / "ck")
    assert held == 80 - kw["batch"]             # the holdback bound
    assert rc == 0
    assert not os.path.exists(rep.promote_file)
    assert lease.current_epoch(ck) == 2
    gauges = rep.svc.telemetry.snapshot()["gauges"]
    assert gauges["leader_epoch"] == 2
    assert gauges["failover_seconds"] >= 0.0
    assert gauges["dup_suppressed_total"] > 0   # the overlap replayed
    ring = DedupRing()
    assert not any(ring.is_dup(r[2], r[3]) for r in rows)
    want = _reference_lines(msgs, kw)
    assert [r[1] for r in rows] == want
    if kw["engine"] == "seq":
        assert want == _reference_lines(msgs, ORACLE_KW)
    # the promotion's flight-recorder bracket
    with open(os.path.join(ck, "events-standby.jsonl")) as f:
        kinds = [json.loads(ln)["kind"] for ln in f]
    assert kinds == ["replica.promote.begin", "replica.promote.end"]


def test_failover_rows_and_stamps_match_jax(tmp_path):
    """The same drill through both packages' Replica (oracle engine):
    the durable MatchOut rows — key, value, epoch, out_seq — are equal,
    and so are the standby heartbeat's keys and the promotion events."""
    msgs = _msgs()
    out = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        os.makedirs(tmp_path / name)
        rows, rep, rc, held = _failover(pkg, str(tmp_path / name),
                                        ORACLE_KW, msgs)
        ck = str(tmp_path / name / "ck")
        with open(os.path.join(ck, "events-standby.jsonl")) as f:
            ev = [json.loads(ln) for ln in f]
        out[name] = (rows, rc, held, pkg["lease"].current_epoch(ck),
                     [(e["kind"], e.get("off"), e.get("epoch"))
                      for e in ev])
    assert out["port"] == out["jax"]
    rows = out["port"][0]
    assert {r[2] for r in rows} == {1, 2}


# ---------------------------------------------------------------------------
# kme-torch-top over a live leader + standby pair


def test_top_live_leader_standby_pair(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    os.makedirs(ck)
    log_dir = os.path.join(ck, "broker-log")
    msgs = [dumps_order(m) for m in harness_stream(
        80, seed=7, num_accounts=4, num_symbols=2,
        payout_opcode_bug=False, validate=True)]

    br = InProcessBroker(persist_dir=log_dir)
    provision(br)
    for m in msgs:
        br.produce(TOPIC_IN, None, m)
    leader = MatchService(br, checkpoint_dir=ck, exactly_once=True,
                          device="cpu", **ORACLE_KW)
    leader.run(max_messages=len(msgs))
    serve_health = os.path.join(ck, "serve.health")
    leader._write_heartbeat(serve_health, len(msgs))
    msrv = start_metrics_server(leader.telemetry, 0, host="127.0.0.1")
    lh, lp = msrv.server_address[:2]

    standby_health = os.path.join(ck, "standby.health")
    rep = Replica(ck, listen="127.0.0.1:0", poll=0.02, health_every=0.05,
                  idle_exit=0.4, health_file=standby_health,
                  metrics_port=0, device="cpu", **ORACLE_KW)
    rc = [None]
    t = threading.Thread(target=lambda: rc.__setitem__(0, rep.run()),
                         daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 10.0
        while (not os.path.exists(standby_health)
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert os.path.exists(standby_health), "standby never heartbeat"

        code = top_main(["--leader", f"http://{lh}:{lp}",
                         "--standby", standby_health,
                         "--supervisor", os.path.join(ck,
                                                      "supervisor.json"),
                         "--once", "--interval", "0.05"])
        assert code == 0
        out = capsys.readouterr().out
        # leader metrics surface: throughput + the stage table
        assert f"records={len(msgs):,}" in out
        assert "e2e" in out and "p99 ms" in out
        # standby heartbeat surfaced with applied offset + lag
        assert "standby  applied=" in out
        assert "unreachable" not in out.split("standby")[1]

        # the standby's own metrics URL also scrapes (replica gauges)
        sh, sp = rep.metrics_server.server_address[:2]
        node = scrape(f"http://{sh}:{sp}")
        assert node["ok"]
        assert "replica_applied_offset" in node["metrics"]["gauges"]
    finally:
        # the follow loop only exits via promotion: issue a pid-less
        # (manual) promote order, after which idle_exit winds it down
        leader.close()
        msrv.shutdown()
        with open(rep.promote_file, "w") as f:
            json.dump({"failed_at": time.time()}, f)
        t.join(timeout=30)
        if rep.metrics_server is not None:
            rep.metrics_server.shutdown()
    assert rc[0] == 0
