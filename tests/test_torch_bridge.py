"""The port's serving stack (`kme_tpu_torch/bridge/`) against the JAX
package's, on CPU tensors.

The same MatchIn records go through the port's MatchService and the JAX
package's on fresh in-process brokers; the MatchOut logs must be equal
byte for byte (tolerance 0), for every engine/compat combination:
- seq fixed serial and `pipeline=2`, lanes, seq java (and its degrade to
  the native engine on a barrier, tests/test_seq_java.py:150 / :184),
  oracle and native in both compat modes;
- after crash-resume with batches in flight (tests/test_host_path.py:105),
  a full-process restart over a persisted broker log
  (tests/test_checkpoint.py:300), a seq -> lanes cross-engine restore
  (tests/test_seq_engine.py:247) and an exactly-once crash whose replay
  the broker suppresses by its stamps (tests/test_exactly_once.py:196).

The real-TCP test runs the port's CLI `serve --device cpu` and `loadgen`
as subprocesses with `jax` and `kme_tpu` blocked, and holds the consumed
MatchOut against the JAX package's service on the same stream (its native
engine at the seq engine's capacity envelope, the same bytes).
"""

import os
import subprocess
import sys
import time

import pytest
import torch

from kme_tpu.bridge import service as JSV
from kme_tpu.bridge.broker import InProcessBroker as JaxBroker
from kme_tpu.oracle import OracleEngine as JaxOracle
from kme_tpu.workload import harness_stream
from kme_tpu_torch import opcodes as op
from kme_tpu_torch.bridge import service as SV
from kme_tpu_torch.bridge.broker import InProcessBroker
from kme_tpu_torch.bridge.consume import DedupRing, consume_lines
from kme_tpu_torch.bridge.tcp import TcpBroker
from kme_tpu_torch.wire import OrderMsg, dumps_order

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ_KW = dict(engine="seq", compat="fixed", batch=128, symbols=8,
              accounts=128, slots=128, max_fills=32)
JAVA_KW = dict(engine="seq", compat="java", batch=64, symbols=8,
               accounts=128, slots=256, max_fills=64)
HOST_KW = dict(batch=64, slots=64, max_fills=32)
MODES = {
    "seq_serial": SEQ_KW,
    "seq_pipeline2": dict(SEQ_KW, pipeline=2),
    "lanes": dict(SEQ_KW, engine="lanes", slots=64, accounts=64, width=8),
    "lanes_shards2": dict(SEQ_KW, engine="lanes", slots=64, accounts=64,
                          width=8, shards=2),
    "seq_java": JAVA_KW,
    "oracle_fixed": dict(HOST_KW, engine="oracle", compat="fixed"),
    "native_fixed": dict(HOST_KW, engine="native", compat="fixed"),
    "oracle_java": dict(HOST_KW, engine="oracle", compat="java"),
    "native_java": dict(HOST_KW, engine="native", compat="java"),
}


def _stream(compat, n=500, seed=3):
    if compat == "java":
        return harness_stream(n, seed=seed)
    return harness_stream(n, seed=seed, num_symbols=4, num_accounts=8,
                          payout_opcode_bug=False, validate=True)


def _broker(mod_broker, values, **kw):
    b = mod_broker(**kw)
    b.create_topic(SV.TOPIC_IN)
    b.create_topic(SV.TOPIC_OUT)
    for v in values:
        b.produce(SV.TOPIC_IN, None, v)
    return b


def _out(b):
    return [f"{r.key} {r.value}" for r in b.fetch(SV.TOPIC_OUT, 0, 10 ** 9)]


def _service(mod, broker, **kw):
    """`mod`'s MatchService; the port's on CPU tensors."""
    if mod is SV:
        kw["device"] = "cpu"
    return mod.MatchService(broker, **kw)


def _jax_serve(values, **kw):
    b = _broker(JaxBroker, values)
    svc = JSV.MatchService(b, **kw)
    assert svc.run(max_messages=len(values)) == len(values)
    svc.close()
    return _out(b)


def _port_serve(values, **kw):
    b = _broker(InProcessBroker, values)
    svc = _service(SV, b, **kw)
    assert svc.run(max_messages=len(values)) == len(values)
    svc.close()
    return _out(b), svc


@pytest.mark.parametrize("mode", sorted(MODES))
def test_service_matches_jax(mode):
    kw = MODES[mode]
    values = [dumps_order(m) for m in _stream(kw["compat"])]
    got, svc = _port_serve(values, **kw)
    want = _jax_serve(values, **kw)
    assert got == want and len(got) > 2 * len(values)
    assert svc.pipeline == kw.get("pipeline", 0)
    if kw["engine"] in ("seq", "lanes"):
        # the session's registry is the service's: engine counters and
        # the host-path gauges under the JAX package's names
        snap = svc.telemetry.snapshot()
        assert snap["counters"]["service_records"] == len(values)
        for g in ("plan_s", "recon_s", "host_path_s",
                  "device_ms_per_batch", "open_orders"):
            assert g in snap["gauges"], g


def test_java_service_degrades_on_barrier():
    """A real PAYOUT barrier mid-stream leaves the java device surface:
    the port's service converts its seq session to the port's native
    engine and continues; the MatchOut equals the JAX package's service
    and the java oracle (tests/test_seq_java.py:184)."""
    msgs = harness_stream(600, seed=21)
    barrier = OrderMsg(action=op.PAYOUT, sid=99, size=3)
    mixed = [dumps_order(m) for m in msgs[:400]] + [dumps_order(barrier)] \
        + [dumps_order(m) for m in msgs[400:]]
    got, svc = _port_serve(mixed, **JAVA_KW)
    assert svc._native is not None and svc._session is None
    assert got == _jax_serve(mixed, **JAVA_KW)
    ora = JaxOracle("java")
    from kme_tpu.wire import parse_order

    want = [r.wire() for v in mixed for r in ora.process(parse_order(v))]
    assert got == want


def _crash_resume(mod, broker_mod, values, ck_dir, **kw):
    b = _broker(broker_mod, values)
    svc = _service(mod, b, checkpoint_dir=ck_dir, checkpoint_every=300, **kw)
    # batches of 128: the snapshot fires at offset 384; crash at 512
    assert svc.run(max_messages=512) == 512
    assert (svc._last_ckpt_offset, svc.offset) == (384, 512)
    del svc
    svc2 = _service(mod, b, checkpoint_dir=ck_dir, checkpoint_every=300,
                    **kw)
    assert svc2.offset == 384
    rest = len(values) - 384
    assert svc2.run(max_messages=rest) == rest
    svc2.close()
    return _out(b)


@pytest.mark.parametrize("pipeline", [0, 2])
def test_crash_resume_with_batches_in_flight(pipeline, tmp_path):
    """tests/test_host_path.py:105: the snapshot lands at the same
    offset serially and pipelined, and the replayed at-least-once tail
    equals the JAX package's."""
    values = [dumps_order(m) for m in harness_stream(600, seed=3)]
    kw = dict(SEQ_KW, pipeline=pipeline)
    got = _crash_resume(SV, InProcessBroker, values, str(tmp_path / "p"),
                        **kw)
    want = _crash_resume(JSV, JaxBroker, values, str(tmp_path / "j"), **kw)
    assert got == want


def _restart(mod, broker_mod, values, root, **kw):
    log_dir, ck_dir = os.path.join(root, "log"), os.path.join(root, "ck")
    b1 = _broker(broker_mod, values, persist_dir=log_dir)
    svc1 = _service(mod, b1, checkpoint_dir=ck_dir, checkpoint_every=100,
                    **kw)
    assert svc1.run(max_messages=150) == 150   # snapshot at 100
    del svc1, b1                               # the whole process dies
    b2 = broker_mod(persist_dir=log_dir)       # broker log reloaded
    svc2 = _service(mod, b2, checkpoint_dir=ck_dir, checkpoint_every=100,
                    **kw)
    assert svc2.offset == 100
    assert svc2.run(max_messages=len(values) - 100) == len(values) - 100
    return _out(b2)


@pytest.mark.parametrize("engine", ["seq", "lanes"])
def test_full_process_restart_over_persisted_log(engine, tmp_path):
    """tests/test_checkpoint.py:300 on the device engines: broker log
    and snapshot on disk, a fresh broker and a fresh service resume and
    the stream completes byte-identical to the JAX package's."""
    values = [dumps_order(m) for m in _stream("fixed", 300, seed=31)]
    kw = dict(SEQ_KW, engine=engine, batch=50, slots=128 if engine == "seq"
              else 64)
    got = _restart(SV, InProcessBroker, values, str(tmp_path / "p"), **kw)
    want = _restart(JSV, JaxBroker, values, str(tmp_path / "j"), **kw)
    assert got == want


def test_seq_service_snapshot_restores_into_lanes(tmp_path):
    """tests/test_seq_engine.py:247: the seq service's snapshot resumes
    in a lanes service (and the lanes engine's state equals the seq
    engine's), byte-identical to an uninterrupted seq service."""
    values = [dumps_order(m) for m in _stream("fixed", 300, seed=13)]
    kw = dict(SEQ_KW, batch=50, symbols=8, accounts=128, slots=128)
    want, _ = _port_serve(values, **kw)
    ck_dir = str(tmp_path / "ck")
    b = _broker(InProcessBroker, values)
    svc = SV.MatchService(b, checkpoint_dir=ck_dir, checkpoint_every=100,
                          device="cpu", **kw)
    assert svc.run(max_messages=150) == 150
    snap_off = svc._last_ckpt_offset
    assert snap_off >= 100
    seq_state = svc._session.export_state() if snap_off == 150 else None
    del svc
    lanes = SV.MatchService(b, checkpoint_dir=ck_dir, checkpoint_every=10**9,
                            device="cpu", **dict(kw, engine="lanes", width=8))
    assert lanes.offset == snap_off
    if seq_state is not None:
        assert lanes._session.export_state() == seq_state
    assert lanes.run(max_messages=len(values) - snap_off) \
        == len(values) - snap_off
    got = _out(b)
    # at-least-once: the tail after the snapshot appears twice
    per = _lines_per_record(values, want)
    head = [ln for lines in per[:150] for ln in lines]
    tail = [ln for lines in per[snap_off:] for ln in lines]
    assert got == head + tail


def _lines_per_record(values, lines):
    """Split a MatchOut log into each input record's lines (every record
    opens with its IN line)."""
    out, cur = [], None
    for ln in lines:
        if ln.startswith("IN "):
            cur = []
            out.append(cur)
        cur.append(ln)
    assert len(out) == len(values)
    return out


def _eos_crash(mod, broker_mod, values, root, **kw):
    ck_dir, logd = os.path.join(root, "ck"), os.path.join(root, "log")
    b = _broker(broker_mod, values, persist_dir=logd)
    svc = _service(mod, b, checkpoint_dir=ck_dir, exactly_once=True, **kw)
    assert svc.epoch == 1
    assert svc.run(max_messages=48) == 48
    svc.checkpoint()
    seq_at_ckpt = svc.out_seq
    assert svc.run(max_messages=16) == 16     # past the snapshot...
    del svc                                   # ...then the crash
    b2 = broker_mod(persist_dir=logd)
    svc2 = _service(mod, b2, checkpoint_dir=ck_dir, exactly_once=True, **kw)
    assert svc2.epoch == 2
    assert (svc2.offset, svc2.out_seq) == (48, seq_at_ckpt)
    assert svc2.run(max_messages=len(values) - 48) == len(values) - 48
    assert b2.dup_suppressed > 0
    recs = b2.fetch(SV.TOPIC_OUT, 0, 10 ** 6)
    assert svc2.telemetry.snapshot()["gauges"]["dup_suppressed_total"] \
        == b2.dup_suppressed
    return [(r.epoch, r.out_seq, r.key, r.value) for r in recs]


@pytest.mark.parametrize("engine", ["seq", "oracle"])
def test_exactly_once_stamps_survive_a_crash(engine, tmp_path):
    """tests/test_exactly_once.py:196: the replayed tail re-produces with
    the same (epoch, out_seq) stamps, the broker suppresses it, and the
    durable log (stamps included) equals the JAX package's."""
    values = [dumps_order(m) for m in _stream("fixed", 80, seed=3)]
    kw = (dict(SEQ_KW, batch=16) if engine == "seq"
          else dict(engine="oracle", compat="fixed", batch=16, slots=64,
                    max_fills=32))
    got = _eos_crash(SV, InProcessBroker, values, str(tmp_path / "p"), **kw)
    want = _eos_crash(JSV, JaxBroker, values, str(tmp_path / "j"), **kw)
    assert got == want
    ring = DedupRing()
    assert not any(ring.is_dup(e, s) for e, s, _k, _v in got)


def test_unported_options_raise(tmp_path, monkeypatch):
    """Every serve option is ported: the observability options and the
    multi-leader group construct, kme-torch-serve takes --kafka and
    reaches the Kafka adapter (which without aiokafka raises naming it),
    and --group K/N serves. The service itself takes no Kafka option."""
    b = _broker(InProcessBroker, [])
    svc = SV.MatchService(b, engine="oracle", group=(1, 2))
    assert (svc.topic_in, svc.topic_out, svc.topic_xfer) == (
        "MatchIn.g1", "MatchOut.g1", "Xfer.g1")
    assert "Xfer.g1" in b.topics()
    svc.close()
    with pytest.raises(ValueError, match="out of range"):
        SV.MatchService(b, engine="oracle", group=(2, 2))
    with pytest.raises(TypeError, match="unexpected keyword"):
        SV.MatchService(b, engine="oracle", kafka="k:1")
    svc = SV.MatchService(b, engine="oracle",
                          journal=str(tmp_path / "j.jsonl"), audit=True,
                          tsdb=str(tmp_path / "tsdb"),
                          watch=["balance[1]<0"], trace_spans=True,
                          slo={"p99_ms": 5.0}, profile=True,
                          profile_artifact=str(tmp_path / "a.json"),
                          capture_dir=str(tmp_path / "cap"))
    assert svc.journal is not None and svc.auditor is not None
    assert svc.tsdb is not None and svc.watch is not None
    assert svc.slo is not None and svc.profiler is not None
    svc.close()
    # the sharded lanes engine is ported: the service builds it
    svc = SV.MatchService(b, engine="lanes", shards=2, symbols=8,
                          accounts=128, device="cpu")
    assert svc._session.shards == 2 and svc._session.dev_cfg.width == 0
    from kme_tpu_torch.bridge import serve
    from kme_tpu_torch.bridge.broker import BrokerError

    assert not hasattr(serve, "UNPORTED_FLAGS")
    monkeypatch.setitem(sys.modules, "aiokafka", None)
    with pytest.raises(BrokerError, match="aiokafka"):
        serve.main(["--kafka", "k:1", "--engine", "oracle"])
    assert serve.main(["--group", "0/2", "--engine", "oracle", "--listen",
                       "127.0.0.1:0", "--auto-provision",
                       "--idle-exit", "0.2"]) == 0
    assert serve.main(["--group", "2/2", "--engine", "oracle"]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SV.MatchService(b, engine="seq")


_BLOCK = ("import sys\n"
          "class B:\n"
          "    def find_spec(self, n, p=None, t=None):\n"
          "        if n.split('.')[0] in ('jax', 'kme_tpu'):\n"
          "            raise ImportError('blocked: ' + n)\n"
          "sys.meta_path.insert(0, B())\n"
          "from kme_tpu_torch.cli import main\n"
          "sys.exit(main(sys.argv[1:]))\n")


def _cli(*args, **kw):
    return subprocess.Popen([sys.executable, "-c", _BLOCK, *args], cwd=ROOT,
                            env=dict(os.environ, PYTHONPATH=ROOT), **kw)


def test_cli_serve_over_tcp_matches_jax_service():
    """`python -m kme_tpu_torch.cli serve --device cpu` (seq, pipelined)
    fed over TCP by the port's loadgen, without jax or kme_tpu
    importable: the consumed MatchOut equals the JAX package's service on
    the same stream."""
    n = 800
    msgs = harness_stream(n, seed=5, payout_opcode_bug=False, validate=True)
    from kme_tpu.wire import dumps_order as jdumps

    # the JAX package's native-engine service, with the seq engine's
    # capacity envelope (its seq service gives the same bytes,
    # test_service_matches_jax; this one needs no kernel compile)
    want = _jax_serve([jdumps(m) for m in msgs],
                      **dict(SEQ_KW, engine="native"))
    # the serve ends 5 s after its input goes idle; the loadgen (no torch
    # import) has produced before the serve's loop starts
    srv = _cli("serve", "--listen", "127.0.0.1:0", "--engine", "seq",
               "--pipeline", "2", "--device", "cpu", "--batch", "128",
               "--symbols", "8", "--accounts", "128", "--max-fills", "32",
               "--auto-provision", "--idle-exit", "5",
               stderr=subprocess.PIPE, text=True)
    try:
        addr = None
        t0 = time.time()
        while addr is None and time.time() - t0 < 60:
            line = srv.stderr.readline()
            if "broker listening on" in line:
                addr = line.rsplit(" ", 1)[1].strip()
            elif not line and srv.poll() is not None:
                break
        assert addr, "serve did not report its address"
        gen = _cli("loadgen", "--events", str(n), "--seed", "5",
                   "--validate", "--fix-payout-opcode", "--broker", addr,
                   stderr=subprocess.PIPE, text=True)
        assert gen.wait(timeout=120) == 0, gen.stderr.read()
        host, port = addr.rsplit(":", 1)
        client = TcpBroker(host, int(port))
        got = []
        try:
            for line in consume_lines(client, follow=True, poll_timeout=0.2,
                                      idle_exit=30):
                got.append(line)
                if len(got) == len(want):
                    break
        finally:
            client.close()
        assert srv.wait(timeout=120) == 0
    finally:
        if srv.poll() is None:
            srv.kill()
            srv.wait()
        srv.stderr.close()
    assert got == want and len(got) > 2 * len(msgs)


OPTION_STREAMS = {
    # malformed JSON and an out-of-envelope price mid-stream: dropped
    # with a note (the pipelined path sends such a batch through the
    # per-record path)
    "drop_malformed": lambda vals: vals[:150] + ["not json at all"]
    + vals[150:300] + ['{"action":2,"oid":1,"aid":1,"sid":1,'
                       '"price":4294967296,"size":1}'] + vals[300:],
    "annotate_rejects": lambda vals: vals,
}


@pytest.mark.parametrize("engine", ["seq", "seq_pipeline2", "lanes",
                                    "oracle_fixed"])
@pytest.mark.parametrize("option", sorted(OPTION_STREAMS))
def test_service_options_match_jax(option, engine):
    """Malformed and out-of-envelope records are dropped, and
    `annotate_rejects` adds its REJ records, as the JAX package's service
    does (tests/test_bridge.py:110, :141)."""
    kw = dict(MODES["seq_serial" if engine == "seq" else engine])
    if option == "annotate_rejects":
        kw["annotate_rejects"] = True
    values = OPTION_STREAMS[option](
        [dumps_order(m) for m in _stream("fixed", 400, seed=11)])
    got, _ = _port_serve(values, **kw)
    assert got == _jax_serve(values, **kw)
    if option == "annotate_rejects":
        assert any(ln.startswith("REJ ") for ln in got)


def test_strict_raises_and_native_death_forwards_prefix():
    b = _broker(InProcessBroker, ["not json"])
    svc = SV.MatchService(b, engine="oracle", compat="java", strict=True)
    with pytest.raises(ValueError):
        svc.step(timeout=0.0)
    # a reference-death message mid-batch: the records of the messages
    # before it reach MatchOut, then the service dies like the reference
    from kme_tpu_torch.oracle.engine import ReferenceHang

    msgs = [OrderMsg(action=op.CREATE_BALANCE, aid=1),
            OrderMsg(action=op.TRANSFER, aid=1, size=100000),
            OrderMsg(action=op.ADD_SYMBOL, sid=1),
            OrderMsg(action=op.BUY, oid=5, aid=1, sid=1, price=50, size=3),
            OrderMsg(action=op.REMOVE_SYMBOL, sid=1)]  # Q4 hang
    b = _broker(InProcessBroker, [dumps_order(m) for m in msgs])
    svc = SV.MatchService(b, engine="native", compat="java", batch=64)
    with pytest.raises(ReferenceHang):
        svc.run(max_messages=len(msgs))
    ora = JaxOracle("java")
    from kme_tpu.wire import parse_order

    assert _out(b) == [r.wire() for m in msgs[:4]
                       for r in ora.process(parse_order(dumps_order(m)))]


def test_follower_counts_but_holds_no_lease(tmp_path):
    """Follower mode: no lease, no checkpoints, and the out_seq cursor
    advances with every output record exactly as the JAX package's."""
    from kme_tpu.bridge import lease as jlease
    from kme_tpu_torch.bridge import lease

    values = [dumps_order(m) for m in _stream("fixed", 60, seed=3)]
    kw = dict(engine="oracle", compat="fixed", batch=16, slots=64,
              max_fills=32, exactly_once=True, follower=True)
    svcs = []
    for mod, broker_mod, d in ((SV, InProcessBroker, tmp_path / "p"),
                               (JSV, JaxBroker, tmp_path / "j")):
        b = _broker(broker_mod, values)
        svc = _service(mod, b, checkpoint_dir=str(d), checkpoint_every=1,
                       **kw)
        assert svc.epoch is None
        assert svc.run(max_messages=len(values)) == len(values)
        svcs.append(svc)
    assert svcs[0].out_seq == svcs[1].out_seq > 0
    assert lease.current_epoch(str(tmp_path / "p")) == 0 == \
        jlease.current_epoch(str(tmp_path / "j"))
    # a follower writes no snapshot: its checkpoint directory holds only
    # its control-plane event log, as the JAX package's follower's does
    assert sorted(os.listdir(tmp_path / "p")) == \
        sorted(os.listdir(tmp_path / "j")) == ["events-follower.jsonl"]
