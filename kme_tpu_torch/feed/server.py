"""`kme-torch-feed`: the market-data fan-out tier (sibling of kme-torch-consume).

One single-threaded selectors loop per group does everything:

  broker fetch (MatchOut / MatchOut.gK, nonblocking)
    -> DedupRing on the (epoch, out_seq) produce stamps (replayed
       failover tails vanish here, exactly like kme-torch-consume)
    -> FeedDeriver (pure; byte-identical frames on any replica)
    -> per-symbol fan-out to subscribers
    -> socket pump

A subscriber connects, sends ONE JSON line
`{"op":"subscribe","symbols":[...]|null}` (null = wildcard), and
receives the snapshot-then-deltas handover: SNAP_BEGIN / REFRESH depth
images at the current per-symbol seqs / SNAP_END carrying the
(group, epoch, out_seq) watermark, then the live frame stream.

Slow consumers are never buffered unboundedly (the broker's overload-shedding
philosophy applied to readers): past `queue_bytes` of backlog the
queue is DROPPED and the subscriber degrades to conflated top-of-book
— only the latest TOB per touched symbol is retained — until its
socket drains, at which point the server emits RESYNC + a full REFRESH
depth image per conflated symbol and resumes the live stream. The
subscriber's book is correct again after the resync; what it lost is
intermediate states, never the end state.

Feed lag is measured with the admission-stamp convention
(broker-admission `ats` -> frame derivation) into a LatencyHistogram
on /metrics, next to the write-path stages; the heartbeat file
(`feed.health` under --state-root) embeds the registry snapshot so
kme-torch-top / kme-torch-agg discover the feed tier like any other node.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import selectors
import socket
import sys
import time
from typing import Dict, Optional, Set

from kme_tpu_torch.bridge.consume import DedupRing
from kme_tpu_torch.bridge.service import TOPIC_OUT
from kme_tpu_torch.feed import frames as ff
from kme_tpu_torch.feed.derive import FeedDeriver
from kme_tpu_torch.feed.snapshot import (load_feed_snapshot,
                                   save_feed_snapshot, snapshot_frames)
from kme_tpu_torch.telemetry import LatencyHistogram, Registry
from kme_tpu_torch.wire import parse_order

_FETCH_BATCH = 2048
_SEND_CHUNK = 1 << 16


class _Sub:
    __slots__ = ("sock", "addr", "symbols", "live", "rbuf", "queue",
                 "qbytes", "conflating", "dirty", "ctob", "sent_frames")

    def __init__(self, sock, addr) -> None:
        self.sock = sock
        self.addr = addr
        self.symbols: Optional[Set[int]] = None   # None = wildcard
        self.live = False
        self.rbuf = b""
        self.queue = collections.deque()          # (bytes, ) payloads
        self.qbytes = 0
        self.conflating = False
        self.dirty: Set[int] = set()
        self.ctob: Dict[int, tuple] = {}
        self.sent_frames = 0

    def wants(self, sid: int) -> bool:
        return self.symbols is None or sid in self.symbols


class FeedServer:
    """One feed fan-out loop. `broker` is anything with
    fetch(topic, offset, max, timeout) — a TcpBroker for real
    deployments, an InProcessBroker in benches/tests. `reconnect` (a
    zero-arg factory returning a fresh broker) arms failover survival:
    on a broker error the server reconnects and resumes from its
    offset, with the DedupRing suppressing the replayed tail."""

    def __init__(self, broker, host: str = "127.0.0.1", port: int = 0,
                 group: int = 0, topic: str = TOPIC_OUT,
                 depth_every: int = 256, depth_levels: int = 8,
                 queue_bytes: int = 256 * 1024,
                 registry: Optional[Registry] = None,
                 ckpt_dir: Optional[str] = None,
                 snapshot_every: int = 0,
                 reconnect=None, events=None) -> None:
        self.broker = broker
        self.topic = topic
        self.group = group
        self.queue_bytes = int(queue_bytes)
        self.ckpt_dir = ckpt_dir
        self.snapshot_every = int(snapshot_every)
        self.reconnect = reconnect
        self.registry = registry or Registry()
        self.offset = 0
        self.deriver = FeedDeriver(group=group, depth_every=depth_every,
                                   depth_levels=depth_levels)
        if ckpt_dir:
            loaded = load_feed_snapshot(ckpt_dir)
            if loaded is not None:
                self.offset, self.deriver = loaded
        self.dedup = DedupRing()
        self.lag = self.registry.latency("feed_lag")
        r = self.registry
        self.c_frames = r.counter("feed_frames_total")
        self.c_delivered = r.counter("feed_delivered_total")
        self.c_conflations = r.counter("feed_conflations_total")
        self.c_conflated_drop = r.counter("feed_conflated_frames_total")
        self.c_resyncs = r.counter("feed_resyncs_total")
        self.c_snapshots = r.counter("feed_snapshots_served_total")
        self.c_disconnects = r.counter("feed_disconnects_total")
        self.g_subs = r.gauge("feed_subscribers")
        self.g_group = r.gauge("feed_group")
        self.g_offset = r.gauge("feed_offset")
        self.g_group.set(group)
        self._subs: Dict[int, _Sub] = {}          # fd -> sub
        self._by_sid: Dict[int, Set[_Sub]] = {}
        self._wild: Set[_Sub] = set()
        self._sel = selectors.DefaultSelector()
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(1024)
        self._lsock.setblocking(False)
        self._sel.register(self._lsock, selectors.EVENT_READ, None)
        self.address = self._lsock.getsockname()
        self._stop = False
        self._snap_countdown = self.snapshot_every
        # control-plane flight recorder (telemetry/events.py): each
        # slow-consumer degradation and its heal is a timeline event
        self.events = events

    def _event(self, kind: str, severity: str = "info", **kw) -> None:
        if self.events is None:
            return
        try:
            self.events.emit(kind, severity=severity, group=self.group,
                             offset=self.offset, **kw)
        except Exception:
            pass

    # -- subscriber management ------------------------------------------

    def _accept(self) -> None:
        while True:
            try:
                sock, addr = self._lsock.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            sub = _Sub(sock, addr)
            self._subs[sock.fileno()] = sub
            self._sel.register(sock, selectors.EVENT_READ, sub)
            self.g_subs.set(len(self._subs))

    def _drop(self, sub: _Sub) -> None:
        try:
            self._sel.unregister(sub.sock)
        except (KeyError, ValueError):
            pass
        self._subs.pop(sub.sock.fileno(), None)
        if sub.symbols is None:
            self._wild.discard(sub)
        else:
            for sid in sub.symbols:
                peers = self._by_sid.get(sid)
                if peers is not None:
                    peers.discard(sub)
                    if not peers:
                        self._by_sid.pop(sid, None)
        try:
            sub.sock.close()
        except OSError:
            pass
        self.c_disconnects.inc()
        self.g_subs.set(len(self._subs))

    def _handshake(self, sub: _Sub) -> None:
        try:
            data = sub.sock.recv(4096)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._drop(sub)
            return
        if not data:
            self._drop(sub)
            return
        sub.rbuf += data
        if b"\n" not in sub.rbuf:
            if len(sub.rbuf) > 65536:
                self._drop(sub)
            return
        line, _, sub.rbuf = sub.rbuf.partition(b"\n")
        try:
            req = json.loads(line)
            syms = req.get("symbols")
            if syms is not None:
                syms = {int(s) for s in syms}
        except (ValueError, TypeError):
            self._drop(sub)
            return
        sub.symbols = syms
        sub.live = True
        if syms is None:
            self._wild.add(sub)
        else:
            for sid in syms:
                self._by_sid.setdefault(sid, set()).add(sub)
        self._enqueue_bytes(sub, snapshot_frames(self.deriver, syms))
        self.c_snapshots.inc()

    # -- queueing / conflation ------------------------------------------

    def _enqueue_bytes(self, sub: _Sub, payload: bytes) -> None:
        sub.queue.append(payload)
        sub.qbytes += len(payload)
        self._want_write(sub, True)

    def _want_write(self, sub: _Sub, on: bool) -> None:
        ev = selectors.EVENT_READ | (selectors.EVENT_WRITE if on else 0)
        try:
            self._sel.modify(sub.sock, ev, sub)
        except (KeyError, ValueError):
            pass

    def _fan_out(self, frame) -> None:
        sid = frame.sid
        targets = self._by_sid.get(sid, ())
        for group in (targets, self._wild):
            for sub in group:
                if not sub.live:
                    continue
                if sub.conflating:
                    self.c_conflated_drop.inc()
                    if frame.kind == ff.FEED_TOB:
                        sub.ctob[sid] = (frame.seq, frame.src_epoch,
                                         frame.src_seq, frame.bid_price,
                                         frame.bid_size, frame.ask_price,
                                         frame.ask_size)
                    sub.dirty.add(sid)
                    continue
                self._enqueue_bytes(sub, frame.raw)
                self.c_delivered.inc()
                if sub.qbytes > self.queue_bytes:
                    # slow consumer: drop the backlog, remember which
                    # symbols it covered, degrade to conflated TOB
                    for payload in sub.queue:
                        for f in ff.decode_feed_frames(payload):
                            sub.dirty.add(f.sid)
                    sub.queue.clear()
                    sub.qbytes = 0
                    sub.conflating = True
                    self.c_conflations.inc()
                    self._event("feed.conflate", severity="warn",
                                peer=f"{sub.addr[0]}:{sub.addr[1]}",
                                dirty=len(sub.dirty))
                    # keep WRITE interest: the next writable event with
                    # an empty queue IS the drain signal that triggers
                    # the resync
                    self._want_write(sub, True)

    def _resync(self, sub: _Sub) -> None:
        """The socket drained while conflated: ship the latest TOB per
        touched symbol (CONFLATED flag), then RESYNC + an authoritative
        REFRESH image per symbol, and go live again."""
        ep, sq = self.deriver.watermark
        out = b""
        for sid in sorted(sub.ctob):
            seq, fep, fsq, bp, bs, ap, asz = sub.ctob[sid]
            out += ff.encode_tob(self.group, seq, fep, fsq, sid,
                                 bp, bs, ap, asz, conflated=True)
        for sid in sorted(sub.dirty):
            seq = self.deriver._seqs.get(sid, 0)
            bids, asks = self.deriver.book.depth(sid, 0)
            out += ff.encode_resync(self.group, seq, ep, sq, sid)
            out += ff.encode_depth(self.group, seq, ep, sq, sid,
                                   bids, asks, refresh=True)
        healed = len(sub.dirty)
        sub.ctob.clear()
        sub.dirty.clear()
        sub.conflating = False
        self.c_resyncs.inc()
        self._event("feed.resync", epoch=ep,
                    peer=f"{sub.addr[0]}:{sub.addr[1]}",
                    symbols=healed, src_seq=sq)
        if out:
            self._enqueue_bytes(sub, out)

    def _pump(self, sub: _Sub) -> None:
        try:
            while sub.queue:
                head = sub.queue[0]
                n = sub.sock.send(head[:_SEND_CHUNK])
                sub.sent_frames += 1
                if n < len(head):
                    sub.queue[0] = head[n:]
                    sub.qbytes -= n
                    return
                sub.queue.popleft()
                sub.qbytes -= n
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._drop(sub)
            return
        if sub.conflating:
            self._resync(sub)
        if not sub.queue:
            self._want_write(sub, False)

    # -- source consumption ---------------------------------------------

    def _reconnect_broker(self) -> None:
        try:
            self.broker.close()
        except Exception:
            pass
        while not self._stop:
            try:
                self.broker = self.reconnect()
                return
            except Exception:
                time.sleep(0.1)

    def _poll_source(self) -> int:
        from kme_tpu_torch.bridge.broker import BrokerError

        try:
            recs = self.broker.fetch(self.topic, self.offset,
                                     _FETCH_BATCH, timeout=0.0)
        except BrokerError as e:
            if "unknown topic" in str(e):
                return 0              # not provisioned yet: keep waiting
            if self.reconnect is None:
                raise
            self._reconnect_broker()
            return 0
        except OSError:
            if self.reconnect is None:
                raise
            self._reconnect_broker()
            return 0
        if not recs:
            return 0
        now_us = time.time_ns() // 1000
        for r in recs:
            if self.dedup.is_dup(getattr(r, "epoch", None),
                                 getattr(r, "out_seq", None)):
                continue
            key, _, rest = r.value.partition(" ") if r.key is None \
                else (r.key, None, r.value)
            msg = parse_order(rest) if key == "OUT" else None
            frames = self.deriver.on_record(
                key, msg, epoch=getattr(r, "epoch", None),
                src_seq=(r.out_seq if getattr(r, "out_seq", None)
                         is not None else r.offset))
            ats = getattr(r, "ats", None)
            if ats is not None:
                self.lag.observe(max(0, now_us - ats) * 1e-6)
            for f in frames:
                self.c_frames.inc()
                self._fan_out(f)
        self.offset = recs[-1].offset + 1
        self.g_offset.set(self.offset)
        if self.ckpt_dir and self.snapshot_every > 0:
            self._snap_countdown -= len(recs)
            if self._snap_countdown <= 0:
                save_feed_snapshot(self.ckpt_dir, self.deriver,
                                   self.offset)
                self._snap_countdown = self.snapshot_every
        return len(recs)

    # -- main loop ------------------------------------------------------

    def step(self, select_timeout: float = 0.01) -> int:
        """One loop iteration: poll the source, then pump sockets.
        Returns the number of source records consumed."""
        n = self._poll_source()
        events = self._sel.select(timeout=0 if n else select_timeout)
        for key, mask in events:
            if key.data is None:
                self._accept()
                continue
            sub = key.data
            if mask & selectors.EVENT_READ:
                if not sub.live:
                    self._handshake(sub)
                else:
                    # live subscribers never send again; readable
                    # means EOF/garbage -> drop
                    try:
                        data = sub.sock.recv(4096)
                    except (BlockingIOError, InterruptedError):
                        data = b"\x00"
                    except OSError:
                        data = b""
                    if not data:
                        self._drop(sub)
                        continue
            if mask & selectors.EVENT_WRITE and sub.live:
                self._pump(sub)
        return n

    def serve_forever(self, stop=None) -> None:
        while not self._stop and (stop is None or not stop.is_set()):
            self.step()

    def stop(self) -> None:
        self._stop = True

    def drain(self, timeout: float = 10.0) -> bool:
        """Pump until every subscriber queue is empty (bench shutdown:
        everything derived has hit the sockets). Source polling
        continues, so only call once the write path is quiescent."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.step(select_timeout=0.005)
            if not any(s.queue or s.conflating
                       for s in self._subs.values()):
                return True
        return False

    def close(self) -> None:
        self._stop = True
        for sub in list(self._subs.values()):
            self._drop(sub)
        try:
            self._sel.unregister(self._lsock)
        except (KeyError, ValueError):
            pass
        self._lsock.close()
        self._sel.close()

    def stats(self) -> dict:
        return {"offset": self.offset,
                "subscribers": len(self._subs),
                "frames": int(self.c_frames.value),
                "delivered": int(self.c_delivered.value),
                "conflations": int(self.c_conflations.value),
                "resyncs": int(self.c_resyncs.value),
                "dup_suppressed": self.dedup.suppressed}


def write_health(path: str, server: FeedServer) -> None:
    """Heartbeat + embedded registry snapshot (the scrape() shape
    kme-torch-top/kme-torch-agg already understand), atomically."""
    doc = {"t": time.time(), "role": "feed", "group": server.group,
           "addr": list(server.address),
           "metrics": server.registry.snapshot()}
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kme-torch-feed", description=__doc__)
    p.add_argument("--broker", default="127.0.0.1:9092",
                   metavar="HOST:PORT")
    p.add_argument("--listen", default="127.0.0.1:9310",
                   metavar="HOST:PORT",
                   help="subscriber-facing address")
    p.add_argument("--topic", default=None,
                   help="source topic (default MatchOut, or "
                        "MatchOut.gK with --group k/n)")
    p.add_argument("--group", default="0/1", metavar="K/N",
                   help="group index / count (selects MatchOut.gK "
                        "when N > 1)")
    p.add_argument("--depth-every", type=int, default=256,
                   help="advisory depth frame cadence (input messages)")
    p.add_argument("--depth-levels", type=int, default=8)
    p.add_argument("--queue-bytes", type=int, default=256 * 1024,
                   help="per-subscriber backlog bound before "
                        "conflation")
    p.add_argument("--metrics-port", type=int, default=None)
    p.add_argument("--state-root", default=None, metavar="DIR",
                   help="write feed.health heartbeats here "
                        "(kme-torch-top/kme-torch-agg discovery)")
    p.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                   help="feed snapshot directory (cold-start resume)")
    p.add_argument("--snapshot-every", type=int, default=0,
                   metavar="RECORDS")
    p.add_argument("--tsdb", default=None, metavar="DIR",
                   help="append the fan-out metrics snapshot to the "
                        "shared on-disk time-series store every "
                        "heartbeat (source 'feed'; kme-torch-prof queries "
                        "it)")
    args = p.parse_args(argv)
    from kme_tpu_torch.bridge.tcp import TcpBroker, parse_addr

    bhost, bport = parse_addr(args.broker)
    lhost, lport = parse_addr(args.listen)
    k, _, n = args.group.partition("/")
    k, n = int(k), int(n or 1)
    topic = args.topic or (f"{TOPIC_OUT}.g{k}" if n > 1 else TOPIC_OUT)
    registry = Registry()
    evlog = None
    if args.state_root:
        from kme_tpu_torch.telemetry import events as cpevents

        os.makedirs(args.state_root, exist_ok=True)
        try:
            evlog = cpevents.open_log(
                args.state_root, f"feed.g{k}" if n > 1 else "feed")
        except OSError:
            evlog = None
    server = FeedServer(
        TcpBroker(bhost, bport), host=lhost, port=lport, group=k,
        topic=topic, depth_every=args.depth_every,
        depth_levels=args.depth_levels, queue_bytes=args.queue_bytes,
        registry=registry, ckpt_dir=args.checkpoint_dir,
        snapshot_every=args.snapshot_every,
        reconnect=lambda: TcpBroker(bhost, bport), events=evlog)
    httpd = None
    if args.metrics_port is not None:
        from kme_tpu_torch.telemetry.httpd import start_metrics_server

        httpd = start_metrics_server(registry, args.metrics_port)
        print(f"kme-torch-feed: metrics on "
              f"http://127.0.0.1:{httpd.server_address[1]}/metrics",
              file=sys.stderr)
    health = None
    if args.state_root:
        os.makedirs(args.state_root, exist_ok=True)
        health = os.path.join(args.state_root, "feed.health")
    tsdb = None
    tsdb_seq = 0
    if args.tsdb is not None:
        from kme_tpu_torch.telemetry import TSDB

        source = f"feed.g{k}" if n > 1 else "feed"
        try:
            tsdb = TSDB(args.tsdb, source=source)
            tsdb_seq = tsdb.next_seq()  # no durable cursor: adopt disk
        except (OSError, ValueError) as e:
            print(f"kme-torch-feed: TSDB disabled: {e}", file=sys.stderr)
    print(f"kme-torch-feed: group {k} serving {topic} on "
          f"{server.address[0]}:{server.address[1]}", file=sys.stderr)
    last_hb = 0.0
    try:
        while True:
            server.step()
            if health is not None or tsdb is not None:
                now = time.monotonic()
                if now - last_hb >= 1.0:
                    if health is not None:
                        write_health(health, server)
                    if tsdb is not None:
                        try:
                            tsdb.append_snapshot(registry.snapshot(),
                                                 tsdb_seq)
                            tsdb_seq += 1
                        except OSError:
                            tsdb = None   # history is best-effort
                    last_hb = now
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
        if evlog is not None:
            evlog.close()
        if tsdb is not None:
            tsdb.close()
        if httpd is not None:
            httpd.shutdown()
    return 0
