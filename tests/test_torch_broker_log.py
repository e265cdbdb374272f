"""The port's broker log storage (`kme_tpu_torch/bridge/broker.py`
`_Log`): records kept as bytes segments and int64 words, never as
objects the interpreter's collector tracks.

- every way in (produce, produce_frames, a `persist_dir` reload) and
  out (fetch in process, TCP `fetch` and `fetch_bin`) gives back each
  record field by field as it was given, across segment and word-page
  boundaries and at `max_records`;
- a seeded mix of produces gives the same records, return values,
  counters and durable bytes as the JAX package's broker, which keeps
  records as `Record` objects in a list;
- producing 50,000 records adds no tracked objects;
- a log written by the list-of-Records broker reloads unchanged, and the
  bytes written for the same produces are that format's.
"""

import dataclasses
import gc
import os
import random

import pytest

from kme_tpu.bridge.broker import BrokerError as JaxBrokerError
from kme_tpu.bridge.broker import InProcessBroker as JaxBroker
from kme_tpu_torch.bridge import broker as B
from kme_tpu_torch.bridge import service as SV
from kme_tpu_torch.bridge.broker import InProcessBroker, Record
from kme_tpu_torch.bridge.tcp import TcpBroker, serve_broker
from kme_tpu_torch.wire import OrderMsg, dumps_order, encode_frames

I64_MAX = (1 << 63) - 1
# the TCP binary reply spends INT64_MIN on "absent", so the full words
# every path carries are these two
FULL_WORDS = (I64_MAX, -I64_MAX)


class _Clock:
    """A counting admission clock, so two brokers stamp alike."""

    def __init__(self) -> None:
        self.us = 1_700_000_000_000_000

    def time_us(self) -> int:
        self.us += 7
        return self.us


def _msgs(n, first=0):
    return [OrderMsg(2, first + i, 1 + i % 3, i % 2, 40 + i % 9, 1 + i % 5)
            for i in range(n)]


def _fields(r):
    return dataclasses.astuple(r)


def _given():
    """(key, value, epoch, out_seq, ats, tid) of every record, with each
    case the storage has to keep apart."""
    rows = [
        ("IN", '{"a":1}', None, None, 5, None),
        (None, "", None, None, 6, None),            # no key, empty value
        ("", "x", None, None, 7, None),             # empty key is a key
        ("kéy", "välue € \U0001F600 中", None, None, 8, None),
        ("OUT", "stamped", 3, 0, 9, FULL_WORDS[0]),
        ("OUT", "stamped", 3, 1, 10, FULL_WORDS[1]),
        ("OUT", "tid zero", 3, 2, 11, 0),
        (None, "big " + "v" * 3000, None, None, 12, None),
    ]
    # enough to cross the first segments and word pages shrunk below
    rows += [("IN" if i % 3 else None, f"rec {i} " + "é" * (i % 4),
              None if i % 5 else 4, None if i % 5 else 3 + i, 100 + i,
              None if i % 2 else i * 1_000_003)
             for i in range(300)]
    return rows


def _expected(rows, reloaded=False):
    return [Record(i, k, v, e, q, None if reloaded else a,
                   None if reloaded else t)
            for i, (k, v, e, q, a, t) in enumerate(rows)]


def _fill(b, rows):
    b.create_topic("T")
    for k, v, e, q, a, t in rows:
        assert b.produce("T", k, v, epoch=e, out_seq=q, ats=a, tid=t) >= 0


def _drain(fetch, n, step):
    """Fetch [0, n) in pieces of `step`: every piece stops at
    max_records, and their edges fall across the segment edges."""
    got, off = [], 0
    while off < n:
        recs = fetch("T", off, step)
        assert 0 < len(recs) <= step
        assert len(recs) == min(step, n - off)
        got += recs
        off += len(recs)
    assert fetch("T", n, step) == []
    return got


@pytest.fixture
def small_log(monkeypatch):
    """Segments of 64-256 bytes and pages of 4 records, so a few hundred
    records cross many of both."""
    monkeypatch.setattr(B, "_SEG_MIN", 64)
    monkeypatch.setattr(B, "_SEG_MAX", 256)
    monkeypatch.setattr(B, "_PAGE", 4)


def _round_trip_produce(tmp_path):
    rows = _given()
    b = InProcessBroker()
    _fill(b, rows)
    return b.fetch, _expected(rows)


def _round_trip_produce_frames(tmp_path):
    b = InProcessBroker()
    b.create_topic("T")
    want = []
    batches = [("IN", None, None, 21, None), (None, 4, 0, 22, "full"),
               ("ключ", 5, 50, 23, "mixed")]
    for bi, (key, epoch, seq0, ats, tids) in enumerate(batches):
        msgs = _msgs(50, first=100 * bi)
        if tids == "full":
            tid = [FULL_WORDS[i % 2] for i in range(50)]
        elif tids == "mixed":
            tid = [None if i % 3 else -(1 << 63) + i for i in range(50)]
        else:
            tid = None
        n, last = b.produce_frames("T", key, encode_frames(msgs, tid),
                                   epoch=epoch, seq0=seq0, ats=ats)
        assert (n, last) == (50, len(want) + 49)
        for i, m in enumerate(msgs):
            want.append(Record(
                len(want), key, dumps_order(m), epoch,
                None if seq0 is None else seq0 + i, ats,
                None if tid is None else tid[i]))
    return b.fetch, want


def _round_trip_reload(tmp_path):
    rows = _given()
    d = str(tmp_path / "log")
    _fill(InProcessBroker(persist_dir=d), rows)
    return InProcessBroker(persist_dir=d).fetch, _expected(rows, True)


def _round_trip_fetch_rows(tmp_path):
    rows = _given()
    b = InProcessBroker()
    _fill(b, rows)

    def fetch(topic, offset, step):
        return [Record(*r) for r in b.fetch_rows(topic, offset, step)]

    return fetch, _expected(rows)


def _served(tmp_path, rows, method):
    b = InProcessBroker()
    _fill(b, rows)
    srv, _ = serve_broker("127.0.0.1", 0, b)
    cli = TcpBroker(*srv.server_address[:2])

    def fetch(topic, offset, step):
        return getattr(cli, method)(topic, offset, step)

    fetch.close = lambda: (cli.close(), srv.shutdown(), srv.server_close())
    return fetch, _expected(rows)


def _round_trip_tcp_fetch(tmp_path):
    return _served(tmp_path, _given(), "fetch")


def _round_trip_tcp_fetch_bin(tmp_path):
    return _served(tmp_path, _given(), "fetch_bin")


@pytest.mark.parametrize("path", ["produce", "produce_frames", "reload",
                                  "fetch_rows", "tcp_fetch",
                                  "tcp_fetch_bin"])
@pytest.mark.parametrize("step", [1, 7, 1024])
def test_records_round_trip(path, step, tmp_path, small_log):
    fetch, want = globals()[f"_round_trip_{path}"](tmp_path)
    try:
        got = _drain(fetch, len(want), step)
        # a fetch from the middle that stops at max_records
        mid = fetch("T", len(want) // 3, 5)
    finally:
        getattr(fetch, "close", lambda: None)()
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert [_fields(r) for r in mid] == [
        _fields(r) for r in want[len(want) // 3:len(want) // 3 + 5]]
    if not path.startswith("tcp"):
        assert all(type(r) is Record for r in got)


def test_deliver_observer_gets_the_admission_stamps():
    b = InProcessBroker()
    _fill(b, _given()[:8])
    b.produce("T", None, "unstamped")
    b.produce_frames("T", None, encode_frames(_msgs(2)), ats=77)
    clock = b.fetch("T", 8, 1)[0].ats         # stamped by the broker
    seen = []
    b.deliver_observer = lambda topic, ats, now: seen.append((topic, ats))
    b.fetch("T", 6, 3)
    b.fetch_rows("T", 9, 9)
    b.fetch("T", 50, 9)                   # nothing delivered, no call
    assert seen == [("T", [11, 12, clock]),
                    ("T", [77, 77])]


def test_lone_surrogates_and_bad_stamps(tmp_path):
    """Any str a JSON produce carries round-trips, through a reload too;
    a key, value or stamp the log cannot hold is refused whole."""
    d = str(tmp_path / "log")
    b = InProcessBroker(persist_dir=d)
    b.create_topic("T")
    b.produce("T", "\udc80k", "v \ud800 \udfff", epoch=2, out_seq=0)
    for kw in (dict(value=b"bytes"), dict(key=5), dict(tid=1 << 63),
               dict(tid=-(1 << 63) - 1), dict(ats="soon"),
               dict(epoch=2.0, out_seq=1)):
        args = dict(key="k", value="v")
        args.update(kw)
        with pytest.raises(B.BrokerError):
            b.produce("T", **args)
    assert b.end_offset("T") == 1
    want = (0, "\udc80k", "v \ud800 \udfff", 2, 0)
    assert _fields(b.fetch("T", 0, 9)[0])[:5] == want
    assert _fields(InProcessBroker(persist_dir=d).fetch("T", 0, 9)[0])[:5] \
        == want


def _script(rng, n_ops):
    """A seeded mix of produces: JSON and binary, keyed or not, stamped
    or not (duplicates and a stale epoch among them), ASCII or not."""
    ops, seq, epoch = [], -1, 1
    for _ in range(n_ops):
        kind = rng.random()
        key = rng.choice([None, "IN", "OUT", "XFER", "ü"])
        if kind < 0.55:
            value = "".join(rng.choice("ab{}\":,0123456789é€") for _ in
                            range(rng.randrange(0, 60)))
            stamped = rng.random() < 0.4
            if stamped:
                seq = seq + 1 if rng.random() < 0.85 else max(seq - 2, 0)
            ops.append(("produce", key, value,
                        epoch if stamped else None,
                        seq if stamped else None,
                        rng.choice([None, rng.randrange(1 << 40)]),
                        rng.choice([None, 0, FULL_WORDS[0],
                                    rng.randrange(-(1 << 62), 1 << 62)])))
        elif kind < 0.9:
            k = rng.randrange(1, 40)
            msgs = _msgs(k, first=rng.randrange(1 << 20))
            tids = [rng.choice([None, rng.randrange(1 << 63)])
                    for _ in range(k)]
            stamped = rng.random() < 0.4
            seq0 = None
            if stamped:
                seq0 = seq + 1 if rng.random() < 0.8 else max(seq - 3, 0)
                seq = max(seq, seq0 + k - 1)
            ops.append(("frames", key, encode_frames(msgs, tids),
                        epoch if stamped else None, seq0))
        elif kind < 0.97 or epoch == 1:
            epoch += 1
            ops.append(("fence", epoch))
        else:
            ops.append(("stale", epoch - 1))
    return ops


def _play(b, ops):
    """Run `ops` on broker `b`; every return value or refusal."""
    b.create_topic("T")
    out = []
    for op in ops:
        try:
            if op[0] == "produce":
                _, key, value, epoch, seq, ats, tid = op
                out.append(b.produce("T", key, value, epoch=epoch,
                                     out_seq=seq, ats=ats, tid=tid))
            elif op[0] == "frames":
                _, key, buf, epoch, seq0 = op
                out.append(b.produce_frames("T", key, buf, epoch=epoch,
                                            seq0=seq0, ats=42))
            elif op[0] == "fence":
                b.fence(op[1])
                out.append(b.fence_epoch)
            else:
                out.append(b.produce("T", "OUT", "zombie", epoch=op[1]))
        except (B.BrokerError, JaxBrokerError) as e:
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("seed", [0, 1, 20260527])
def test_same_records_as_the_jax_broker(seed, tmp_path):
    ops = _script(random.Random(seed), 400)
    ours = InProcessBroker(persist_dir=str(tmp_path / "port"),
                           clock=_Clock())
    theirs = JaxBroker(persist_dir=str(tmp_path / "jax"), clock=_Clock())
    assert _play(ours, ops) == _play(theirs, ops)
    n = theirs.end_offset("T")
    assert ours.end_offset("T") == n > 100
    for b in (ours, theirs):
        b.sync()
    for off, step in ((0, 10 ** 6), (0, 13), (n // 2, 1024), (n - 1, 5)):
        assert [_fields(r) for r in ours.fetch("T", off, step)] == \
            [_fields(r) for r in theirs.fetch("T", off, step)]
    assert (ours.dup_suppressed, ours.fenced_produces, ours.fence_epoch) \
        == (theirs.dup_suppressed, theirs.fenced_produces,
            theirs.fence_epoch)
    with open(tmp_path / "port" / "T.log", "rb") as f:
        mine = f.read()
    with open(tmp_path / "jax" / "T.log", "rb") as f:
        assert mine == f.read()
    again = InProcessBroker(persist_dir=str(tmp_path / "port"))
    assert [_fields(r) for r in again.fetch("T", 0, 10 ** 6)] == [
        _fields(r) for r in JaxBroker(persist_dir=str(
            tmp_path / "jax")).fetch("T", 0, 10 ** 6)]
    assert again.fence_epoch == theirs.fence_epoch


def test_log_totals_count_records_and_bytes():
    b = InProcessBroker()
    assert b.log_totals() == (0, 0)
    b.create_topic("A")
    b.create_topic("B")
    b.produce("A", "IN", "abc")
    b.produce("A", None, "é")             # 2 bytes
    b.produce_frames("B", "OUT", encode_frames(_msgs(3)))
    vals = b.fetch("B", 0, 9)
    assert b.log_totals() == (
        5, 2 + 3 + 2 + 3 * 3 + sum(len(r.value) for r in vals))


def test_service_publishes_the_log_gauges():
    b = InProcessBroker()
    b.create_topic(SV.TOPIC_IN)
    b.create_topic(SV.TOPIC_OUT)
    for m in _msgs(20):
        b.produce(SV.TOPIC_IN, None, dumps_order(m))
    svc = SV.MatchService(b, engine="oracle", device="cpu")
    assert svc.run(max_messages=20) == 20
    g = svc.telemetry.snapshot()["gauges"]
    assert (g["broker_log_records"], g["broker_log_bytes"]) == \
        b.log_totals()
    assert g["broker_log_records"] == 20 + b.end_offset(SV.TOPIC_OUT)


def _tracked_gain(fn):
    gc.collect()
    before = len(gc.get_objects())
    keep = fn()
    gc.collect()
    gain = len(gc.get_objects()) - before
    del keep
    return gain


def test_producing_adds_no_tracked_objects():
    """50,000 records through produce and produce_frames: the log holds
    them as bytes and words, so the collector's heap does not grow with
    it (a Record a record would add 50,000)."""
    b = InProcessBroker()
    b.create_topic("J")
    b.create_topic("F")
    value = ('{"action":2,"oid":123456,"aid":7,"sid":2,"price":51,'
             '"size":47,"next":null,"prev":null}')
    frames = encode_frames(_msgs(1000), [7] * 1000)

    def produce():
        for i in range(25_000):
            b.produce("J", "IN" if i % 2 else None, value,
                      epoch=1 if i % 3 else None,
                      out_seq=i if i % 3 else None)
        for i in range(25):
            b.produce_frames("F", "IN", frames)

    assert _tracked_gain(produce) < 500
    assert b.log_totals()[0] == 50_000
    # what a fetch builds dies with the caller's reference
    assert _tracked_gain(lambda: len(b.fetch("J", 0, 10 ** 6))) < 500


# `T.log` as the broker that kept records as a list of Record objects
# wrote it for _old_script's produces (its own run, not hand-made)
OLD_LOG = (
    '["IN","{\\"a\\":1}"]\n'
    '[null,""]\n'
    '["k\\u00e9y","v\\u00e4lue \\u20ac \\ud83d\\ude00"]\n'
    '["OUT","\\ud800 lone",3,0]\n'
    '["OUT","stamped",3,1]\n'
    '["IN","{\\"action\\":2,\\"oid\\":10,\\"aid\\":1,\\"sid\\":0,'
    '\\"price\\":50,\\"size\\":5,\\"next\\":null,\\"prev\\":null}",4,2]\n'
    '["IN","{\\"action\\":2,\\"oid\\":11,\\"aid\\":1,\\"sid\\":0,'
    '\\"price\\":50,\\"size\\":5,\\"next\\":null,\\"prev\\":null}",4,3]\n'
    '["IN","{\\"action\\":2,\\"oid\\":12,\\"aid\\":1,\\"sid\\":0,'
    '\\"price\\":50,\\"size\\":5,\\"next\\":null,\\"prev\\":null}",4,4]\n'
    '[null,"{\\"action\\":2,\\"oid\\":10,\\"aid\\":1,\\"sid\\":0,'
    '\\"price\\":50,\\"size\\":5,\\"next\\":null,\\"prev\\":null}"]\n'
    '[null,"{\\"action\\":2,\\"oid\\":11,\\"aid\\":1,\\"sid\\":0,'
    '\\"price\\":50,\\"size\\":5,\\"next\\":null,\\"prev\\":null}"]\n'
).encode("ascii")


def _old_script(b):
    b.create_topic("T")
    b.produce("T", "IN", '{"a":1}')
    b.produce("T", None, "")
    b.produce("T", "kéy", "välue € \U0001F600")
    b.produce("T", "OUT", "\ud800 lone", epoch=3, out_seq=0)
    b.produce("T", "OUT", "stamped", epoch=3, out_seq=1, ats=123,
              tid=-(1 << 63))
    msgs = [OrderMsg(2, 10 + i, 1, 0, 50, 5) for i in range(3)]
    b.produce_frames("T", "IN", encode_frames(msgs, [7, None, 1 << 62]),
                     epoch=4, seq0=2, ats=99)
    b.produce_frames("T", None, encode_frames(msgs[:2]))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_durable_log_format_unchanged(writer, tmp_path):
    d = str(tmp_path / "log")
    _old_script(InProcessBroker(persist_dir=d) if writer == "port"
                else JaxBroker(persist_dir=d))
    with open(os.path.join(d, "T.log"), "rb") as f:
        assert f.read() == OLD_LOG
    # the old format's file, reloaded, with a torn tail to repair
    old = str(tmp_path / "old")
    os.makedirs(old)
    with open(os.path.join(old, "T.log"), "wb") as f:
        f.write(OLD_LOG + b'["IN","to')
    b = InProcessBroker(persist_dir=old)
    want = [(0, "IN", '{"a":1}', None, None), (1, None, "", None, None),
            (2, "kéy", "välue € \U0001F600", None, None),
            (3, "OUT", "\ud800 lone", 3, 0), (4, "OUT", "stamped", 3, 1)]
    got = b.fetch("T", 0, 100)
    assert [_fields(r)[:5] for r in got[:5]] == want
    assert [(r.epoch, r.out_seq, r.ats, r.tid) for r in got[5:]] == [
        (4, 2, None, None), (4, 3, None, None), (4, 4, None, None),
        (None, None, None, None), (None, None, None, None)]
    assert [_fields(r) for r in got] == [
        _fields(r) for r in JaxBroker(persist_dir=old).fetch("T", 0, 100)]
    assert b.fence_epoch == 4
    assert b.produce("T", "OUT", "dup", epoch=4, out_seq=4) == -1
    assert b.produce("T", None, "next") == 10
    with open(os.path.join(old, "T.log"), "rb") as f:
        assert f.read() == OLD_LOG + b'[null,"next"]\n'


def test_fetch_during_concurrent_produces(small_log):
    """Fetchers decode outside the broker lock while producers append:
    every record read carries what its producer was told landed at that
    offset, across segment and page edges."""
    import sys
    import threading

    b = InProcessBroker()
    b.create_topic("T")
    landed, seen, errors = {}, {}, []
    n_prod, per = max(8, 2 * (os.cpu_count() or 1)), 300

    def produce(p):
        try:
            for i in range(per):
                v = f"p{p} r{i} " + "ü" * (i % 7) + "x" * (i * p % 90)
                landed[b.produce("T", f"k{p}", v, ats=i, tid=p)] = (
                    f"k{p}", v, i, p)
        except Exception as e:        # noqa: BLE001 - asserted below
            errors.append(e)

    def fetch():
        off = 0
        try:
            while off < n_prod * per:
                for r in b.fetch("T", off, 17, timeout=0.05):
                    seen[r.offset] = (r.key, r.value, r.ats, r.tid)
                    off = r.offset + 1
        except Exception as e:        # noqa: BLE001 - asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=produce, args=(p,))
                   for p in range(n_prod)]
        threads += [threading.Thread(target=fetch) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    assert sorted(landed) == list(range(n_prod * per))
    assert seen == landed
