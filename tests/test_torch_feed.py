"""The port's market-data feed (`kme_tpu_torch/feed/`) against the JAX
package's, on the CPU.

Exact equality throughout (tolerance 0):
- the frame codec: every kind's bytes, and the error reason of every
  malformed buffer, equal `kme_tpu`'s;
- the deriver: over the same MatchOut (fixed and java oracle streams,
  and a grouped seq service's MatchOut.gK) the frame bytes equal
  `kme_tpu`'s `FeedDeriver`, and the rebuilt books equal
  `books_from_oracle`;
- feed snapshots: a `feed-%09d.json` written by either package loads in
  the other and continues with the same bytes; a subscriber spliced at
  a checkpoint boundary rebuilds the oracle's books;
- the server: `FeedServer.step()` driven from the test thread by a
  bounded loop fans out to a wildcard and a filtered subscriber.
"""

import os
import random
import struct
import time

import pytest
import torch

from kme_tpu.feed import derive as JD
from kme_tpu.feed import frames as JFF
from kme_tpu.feed import snapshot as JS
from kme_tpu.oracle import OracleEngine as JaxOracle
from kme_tpu.workload import harness_stream, storm_stream
from kme_tpu_torch.feed import derive as PD
from kme_tpu_torch.feed import frames as ff
from kme_tpu_torch.feed import snapshot as S
from kme_tpu_torch.feed.derive import (BookBuilder, FeedDeriver,
                                       books_from_oracle, canonical_books)
from kme_tpu_torch.oracle import OracleEngine
from kme_tpu_torch.wire import parse_order

torch.set_num_threads(1)


def _oracle_lines(msgs, compat="fixed", engine=OracleEngine):
    eng = engine(compat)
    lines = []
    for m in msgs:
        lines.extend(r.wire() for r in eng.process(parse_order(
            _dumps(m))))
    return eng, lines


def _dumps(m):
    from kme_tpu.wire import dumps_order

    return dumps_order(m)


def _derive(mod, lines, **kw):
    d = mod.FeedDeriver(**kw)
    return d, b"".join(f.raw for i, ln in enumerate(lines)
                       for f in d.on_line(ln, 1, i))


# -- the codec ----------------------------------------------------------


def _encodings(mod):
    return [
        mod.encode_delta(3, 7, 2, 99, 11, 1, 500, 40),
        mod.encode_tob(0, 1, 5, 6, 9, 100, 2, 101, 3, conflated=True),
        mod.encode_tob(0, 1, 5, 6, 9, 0, 0, 0, 0),
        mod.encode_depth(1, 4, 5, 6, 9, [(100, 2), (99, 1)], [(101, 7)],
                         refresh=True),
        mod.encode_depth(1, 4, 5, 6, -3, [], []),
        mod.encode_snap_begin(2, 5, 6, 12, depth=8),
        mod.encode_snap_end(2, 5, 6, 12, b"payload"),
        mod.encode_resync(0, 9, 5, 6, -1),
    ]


def test_codec_bytes_equal_jax():
    got, want = _encodings(ff), _encodings(JFF)
    assert got == want
    buf = b"".join(got)
    mine = ff.decode_feed_frames(buf)
    theirs = JFF.decode_feed_frames(buf)
    assert [(f.kind, f.raw) for f in mine] == \
        [(f.kind, f.raw) for f in theirs]
    off = 0
    for raw in got:
        assert ff.feed_frame_length(buf, off) == len(raw) == \
            JFF.feed_frame_length(buf, off)
        off += len(raw)
    assert (ff.WIRE_MAGIC, ff.WIRE_VERSION) == (JFF.WIRE_MAGIC,
                                                JFF.WIRE_VERSION)


def _reason(mod, buf):
    try:
        mod.decode_feed(buf)
    except mod.FeedFrameError as e:
        return e.reason, str(e)
    return None


def test_codec_error_reasons_equal_jax():
    good = ff.encode_delta(0, 1, 1, 0, 1, 0, 10, 1)
    bad = [good[:4], good[:-1], b"\x00" + good[1:],
           good[:1] + b"\xfe" + good[2:]]
    kind = bytearray(good)
    kind[2] = 0
    length = bytearray(good)
    struct.pack_into("<I", length, 4, 8)
    mixed = bytearray(ff.encode_tob(0, 1, 1, 0, 1, 1, 1, 2, 2))
    mixed[2] = ff.FEED_DELTA
    dep = bytearray(ff.encode_depth(0, 1, 1, 0, 1, [(1, 1)], []))
    struct.pack_into("<I", dep, 44, 2)
    bad += [bytes(kind), bytes(length), bytes(mixed), bytes(dep)]
    reasons = [_reason(ff, b) for b in bad]
    assert [r[0] for r in reasons] == [
        "truncated", "truncated", "bad_magic", "version_skew", "bad_kind",
        "bad_length", "bad_length", "bad_length"]
    assert reasons == [_reason(JFF, b) for b in bad]
    # random corruption: the same verdict, frame by frame
    rng = random.Random(13)
    base = b"".join(_encodings(ff))
    for _ in range(200):
        buf = bytearray(base)
        for _k in range(rng.randint(1, 4)):
            buf[rng.randrange(len(buf))] = rng.randrange(256)
        got = _reason(ff, bytes(buf))
        assert got == _reason(JFF, bytes(buf))


# -- the deriver --------------------------------------------------------


@pytest.mark.parametrize("compat", ["fixed", "java"])
def test_deriver_bytes_equal_jax(compat):
    msgs = harness_stream(600, seed=11, num_accounts=8, num_symbols=4,
                          payout_opcode_bug=(compat == "java"),
                          validate=(compat == "fixed"))
    eng, lines = _oracle_lines(msgs, compat)
    _jeng, jlines = _oracle_lines(msgs, compat, JaxOracle)
    assert lines == jlines
    for kw in (dict(), dict(depth_every=16, depth_levels=4, group=1)):
        d, raw = _derive(PD, lines, **kw)
        _jd, jraw = _derive(JD, lines, **kw)
        assert raw == jraw and raw
        assert d.frames_out == _jd.frames_out
    bb = BookBuilder()
    assert bb.apply_buffer(raw) == len(raw)
    assert not bb.errors and not bb.gaps and bb.dups == 0
    assert canonical_books(bb.book) == canonical_books(
        books_from_oracle(eng))
    assert canonical_books(bb.book) == JD.canonical_books(
        JD.books_from_oracle(_jeng))


def test_deriver_under_storm_equals_jax():
    msgs = storm_stream("payout-storm-wide", 500, num_symbols=12, seed=3)
    eng, lines = _oracle_lines(msgs)
    _d, raw = _derive(JD, lines, depth_every=32)
    d = FeedDeriver(depth_every=32)
    assert b"".join(f.raw for i, ln in enumerate(lines)
                    for f in d.on_line(ln, 1, i)) == raw
    bb = BookBuilder()
    bb.apply_buffer(raw)
    assert not bb.gaps and bb.dups == 0
    assert canonical_books(bb.book) == canonical_books(
        books_from_oracle(eng))


def test_deriver_over_grouped_seq_service():
    """A group's MatchOut.gK from the port's seq service (CPU tensors):
    the port's and `kme_tpu`'s derivers emit the same bytes, and the
    books equal the ones aggregated from the session's resting orders."""
    from kme_tpu.workload import zipf_symbol_stream
    from kme_tpu_torch.bridge import front as F
    from kme_tpu_torch.bridge.broker import InProcessBroker
    from kme_tpu_torch.bridge.provision import group_topics, provision
    from kme_tpu_torch.bridge.service import MatchService

    lines = [_dumps(m) for m in zipf_symbol_stream(
        500, num_symbols=16, num_accounts=12, seed=5)]
    per, _ = F.split_lines(lines, 2)
    b = InProcessBroker()
    provision(b, topics=group_topics(1))
    for ln in per[1]:
        b.produce("MatchIn.g1", None, ln)
    svc = MatchService(b, engine="seq", batch=64, symbols=16,
                       accounts=64, slots=128, max_fills=16,
                       group=(1, 2), device="cpu")
    svc.run(max_messages=len(per[1]))
    out = [f"{r.key} {r.value}" for r in b.fetch("MatchOut.g1", 0, 10 ** 6)]
    d, raw = _derive(JD, out, group=1, depth_every=64)
    _pd, praw = _derive(PD, out, group=1, depth_every=64)
    assert praw == raw
    bb = BookBuilder()
    bb.apply_buffer(raw)
    assert not bb.gaps and bb.dups == 0
    assert canonical_books(bb.book) == canonical_books(
        books_from_oracle(_resting(svc._session.export_state())))
    svc.close()


def _resting(state):
    """An oracle-shaped view (`.orders` of records with action, sid,
    price, size) of a seq session's exported resting orders."""
    from types import SimpleNamespace

    from kme_tpu_torch import opcodes as op

    return SimpleNamespace(orders={oid: SimpleNamespace(
        action=op.BUY if o["is_buy"] else op.SELL, sid=o["sid"],
        price=o["price"], size=o["size"])
        for oid, o in state["orders"].items()})


# -- snapshots ----------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_feed_snapshot_reads_across_packages(writer, tmp_path):
    msgs = harness_stream(500, seed=2, num_accounts=6, num_symbols=3,
                          payout_opcode_bug=False, validate=True)
    _eng, lines = _oracle_lines(msgs)
    cut = len(lines) // 2
    w, r = (S, JS) if writer == "port" else (JS, S)
    d = (FeedDeriver if writer == "port" else JD.FeedDeriver)(
        depth_every=16)
    for i, ln in enumerate(lines[:cut]):
        d.on_line(ln, 1, i)
    path = w.save_feed_snapshot(str(tmp_path), d, cut)
    assert os.path.basename(path) == f"feed-{cut:09d}.json"
    assert r.list_feed_snapshots(str(tmp_path)) == \
        w.list_feed_snapshots(str(tmp_path))
    off, restored = r.load_feed_snapshot(str(tmp_path))
    assert off == cut
    assert r.snapshot_frames(restored) == w.snapshot_frames(d)
    tail = b"".join(f.raw for i, ln in enumerate(lines[cut:], start=cut)
                    for f in d.on_line(ln, 1, i))
    tail2 = b"".join(f.raw for i, ln in enumerate(lines[cut:], start=cut)
                     for f in restored.on_line(ln, 1, i))
    assert tail == tail2
    # the two derivers, now at the same state, save the same file in
    # either package
    other = str(tmp_path / "other")
    r.save_feed_snapshot(other, restored, len(lines))
    w.save_feed_snapshot(str(tmp_path / "same"), d, len(lines))
    with open(os.path.join(other, f"feed-{len(lines):09d}.json"),
              "rb") as fa, open(os.path.join(
                  str(tmp_path / "same"),
                  f"feed-{len(lines):09d}.json"), "rb") as fb:
        assert fa.read() == fb.read()


def test_splice_at_checkpoint_boundary(tmp_path):
    msgs = harness_stream(600, seed=9, num_accounts=8, num_symbols=4,
                          payout_opcode_bug=False, validate=True)
    eng, lines = _oracle_lines(msgs)
    cut = len(lines) // 3
    live = FeedDeriver(depth_every=16)
    for i, ln in enumerate(lines[:cut]):
        live.on_line(ln, 1, i)
    S.save_feed_snapshot(str(tmp_path), live, cut)
    _off, restored = S.load_feed_snapshot(str(tmp_path))
    handover = S.snapshot_frames(restored)
    assert handover == S.snapshot_frames(live) == JS.snapshot_frames(live)
    for sids in (None, {1}):
        bb = BookBuilder()
        hand = S.snapshot_frames(restored, sids=sids)
        assert bb.apply_buffer(hand) == len(hand)
        assert bb.watermark == (1, cut - 1)
        server = FeedDeriver(depth_every=16)
        for i, ln in enumerate(lines[:cut]):
            server.on_line(ln, 1, i)
        tail = b"".join(
            f.raw for i, ln in enumerate(lines[cut:], start=cut)
            for f in server.on_line(ln, 1, i)
            if sids is None or f.sid in sids)
        assert bb.apply_buffer(tail) == len(tail)
        assert not bb.errors and not bb.gaps and bb.dups == 0
        want = books_from_oracle(eng)
        if sids is not None:
            want = {k: v for k, v in want.items() if k[0] in sids}
        assert canonical_books(bb.book) == canonical_books(want)


# -- the server ---------------------------------------------------------


def test_feed_server_step_fanout(tmp_path):
    """The fan-out loop driven from this thread: `step()` in a bounded
    loop, subscribers read with FeedClient after the server closes."""
    import json

    from kme_tpu_torch.bridge.broker import InProcessBroker
    from kme_tpu_torch.feed.client import FeedClient
    from kme_tpu_torch.feed.server import FeedServer, write_health

    msgs = harness_stream(300, seed=4, num_accounts=6, num_symbols=3,
                          payout_opcode_bug=False, validate=True)
    eng, lines = _oracle_lines(msgs)
    books = books_from_oracle(eng)
    sids = sorted({s for s, _side in books})
    broker = InProcessBroker()
    broker.create_topic("MatchOut")
    srv = FeedServer(broker, port=0, topic="MatchOut", depth_every=64,
                     queue_bytes=1 << 20)
    host, port = srv.address
    clients = [FeedClient(host, port, symbols=None, timeout=5.0),
               FeedClient(host, port, symbols={sids[0]}, timeout=5.0)]
    try:
        for _ in range(2000):
            srv.step(0.005)
            if srv.stats()["subscribers"] == 2 and all(
                    s.live for s in srv._subs.values()):
                break
        assert srv.stats()["subscribers"] == 2
        for i, ln in enumerate(lines):
            broker.produce("MatchOut", None, ln, epoch=1, out_seq=i,
                           ats=time.time_ns() // 1000)
        for _ in range(20000):
            srv.step(0.0)
            if srv.offset >= len(lines):
                break
        assert srv.offset == len(lines)
        assert srv.drain(10.0)
        write_health(str(tmp_path / "feed.health"), srv)
        stats = srv.stats()
    finally:
        srv.close()
    for c in clients:
        c.drain()
        c.close()
        bb = c.builder
        assert not bb.errors and not bb.gaps and bb.dups == 0
    assert canonical_books(clients[0].builder.book) == canonical_books(
        books)
    assert canonical_books(clients[1].builder.book) == canonical_books(
        {k: v for k, v in books.items() if k[0] == sids[0]})
    _jd, jraw = _derive(JD, lines, depth_every=64)
    assert stats["frames"] == len(JFF.decode_feed_frames(jraw))
    doc = json.load(open(tmp_path / "feed.health"))
    assert doc["role"] == "feed"
    assert doc["metrics"]["gauges"]["feed_offset"] == len(lines)


def test_feed_cli_help():
    from kme_tpu_torch.cli import feed_main

    with pytest.raises(SystemExit) as e:
        feed_main(["--help"])
    assert e.value.code == 0
