"""kme-torch-standby: hot-standby replica with bounded-failover promotion.

The port of `kme_tpu/bridge/replica.py`, with the same files
(`promote.json`, `standby.health`, the `replica.promote.begin/end`
events), so either package's supervisor can promote either package's
standby. The standby's engine runs on `device` (default the card): a seq
standby is a second SeqSession beside the leader's, which follows the
leader through the same B1 dispatches and, once promoted, serves from the
state it built itself. `--device cpu` runs the kernels' plain versions.

The reference gets warm spares from Kafka Streams standby replicas
(num.standby.replicas — state restored from changelogs on another
instance, promoted by the group coordinator when the active dies). Here
the same role is a second process sharing the leader's durable state
root read-only:

- it restores the NEWEST snapshot at startup (the ordinary resume path)
  and then TAILS the leader's durable MatchIn topic log
  (<checkpoint-dir>/broker-log/MatchIn.log) through _FollowBroker,
  applying input through the same MatchService the leader runs — so its
  engine state stays within one batch of the leader's;
- application is BOUNDED by the leader's heartbeat offset
  (serve.health) MINUS one batch: output the follower generates is
  discarded but still COUNTED into the (epoch, out_seq) produce-stamp
  cursor, and counting output the leader never confirmed would
  desynchronize that cursor from the durable MatchOut log. The one-
  batch holdback is deliberate: it keeps the follower's cursor STRICTLY
  BEHIND the leader's durable output, so every promotion re-produces at
  least the last confirmed batch — stamps the broker's idempotent-
  produce watermark suppresses. Broker-side dedup is therefore
  exercised on every real failover (dup_suppressed_total > 0), at the
  cost of replaying at most one batch at promotion time;
- when the supervisor detects leader death and the standby looks ready,
  it writes <checkpoint-dir>/promote.json; the follower notices within
  one poll, acquires the NEXT leader epoch, fences every predecessor at
  the broker, reopens the durable topic logs as a real broker, binds
  the leader's TCP endpoint and keeps serving from its applied offset.
  The overlap between its applied offset and whatever the dead leader
  already produced replays through the broker's idempotent-produce
  watermark, which suppresses the duplicate stamps — the visible
  MatchOut stream stays exactly-once across the failover.

The old leader, should it still be alive (a stall, not a death), is
FENCED: its next stamped produce carries a stale epoch and the broker
rejects it (BrokerFenced -> kme-torch-serve exits 75 -> its supervisor
gives it a fresh epoch — but by then this replica owns the stream).

The follower and the promoted leader serve serially (`--pipeline`, a
serve flag, is ignored like the other serve-only flags): the same bytes.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from typing import List, Optional

from kme_tpu_torch import faults
from kme_tpu_torch.bridge.broker import (BrokerError, BrokerFenced,
                                         InProcessBroker, Record)
from kme_tpu_torch.bridge.service import TOPIC_IN, MatchService

PROMOTE_FILE = "promote.json"


class _FollowBroker:
    """Read-only broker facade over the leader's durable MatchIn log.

    fetch() serves records parsed straight from the append-only JSONL
    file, never past `limit` (the leader's last heartbeat offset — see
    the module docstring for why running ahead is unsafe). produce() is
    a counting discard: MatchService's follower mode only needs the
    call to succeed so its out_seq cursor advances. A torn tail (the
    leader died mid-append) is left unconsumed and re-read on the next
    poll; a file that SHRANK (a fresh run reusing the directory) resets
    the tail cursor entirely.
    """

    def __init__(self, log_dir: str, topic: str = TOPIC_IN,
                 clock=None) -> None:
        from kme_tpu_torch.bridge.clock import WALL

        self._clock = clock or WALL
        self._path = os.path.join(log_dir, f"{topic}.log")
        self._topic = topic
        self._recs: List[Record] = []
        self._pos = 0           # bytes of fully-parsed log lines
        self.limit = 0          # leader-confirmed applied offset bound
        self.discarded = 0      # produces swallowed while following

    def _poll(self) -> None:
        try:
            with open(self._path, "rb") as f:
                f.seek(self._pos)
                data = f.read()
        except OSError:
            return              # leader has not created the topic yet
        if not data:
            with contextlib.suppress(OSError):
                if os.path.getsize(self._path) < self._pos:
                    self._recs, self._pos = [], 0   # truncated: re-read
            return
        consumed = 0
        while True:
            nl = data.find(b"\n", consumed)
            if nl < 0:
                break           # torn tail: retry once it completes
            try:
                row = json.loads(data[consumed:nl].decode("utf-8"))
                if not isinstance(row, list) or len(row) not in (2, 4):
                    raise ValueError("bad log row arity")
            except (ValueError, UnicodeDecodeError):
                break           # torn mid-file line: stop, re-read later
            consumed = nl + 1
            self._recs.append(Record(
                len(self._recs), row[0], row[1],
                row[2] if len(row) > 2 else None,
                row[3] if len(row) > 3 else None))
        self._pos += consumed

    def fetch(self, topic: str, offset: int, max_records: int,
              timeout: float = 0.0) -> List[Record]:
        if topic != self._topic:
            raise BrokerError(f"unknown topic {topic!r}")
        self._poll()
        end = min(len(self._recs), self.limit, offset + max_records)
        recs = self._recs[offset:end]
        if not recs and timeout > 0:
            self._clock.sleep(min(timeout, 0.1))
        return recs

    def end_offset(self, topic: str) -> int:
        self._poll()
        return len(self._recs)

    def produce(self, topic: str, key, value) -> int:
        self.discarded += 1
        return -1


class Replica:
    """The follow -> promote state machine around one MatchService."""

    def __init__(self, checkpoint_dir: str,
                 listen: str = "127.0.0.1:9092",
                 engine: str = "seq", compat: str = "fixed",
                 batch: int = 1024, symbols: int = 1024,
                 accounts: int = 4096, slots: int = 128,
                 max_fills: int = 16, width: int = 8, shards: int = 1,
                 checkpoint_every: int = 4096,
                 checkpoint_keep: Optional[int] = None,
                 max_lag: Optional[int] = None,
                 promote_file: Optional[str] = None,
                 health_file: Optional[str] = None,
                 serve_health: Optional[str] = None,
                 poll: float = 0.2, health_every: float = 1.0,
                 max_messages: Optional[int] = None,
                 idle_exit: Optional[float] = None,
                 metrics_port: Optional[int] = None,
                 group=None, journal_out: Optional[str] = None,
                 trace_spans: bool = False,
                 tsdb: Optional[str] = None, clock=None,
                 device="cuda") -> None:
        from kme_tpu_torch.bridge.clock import WALL

        # the clock seam (bridge/clock.py): the follow loop's poll
        # cadence, heartbeat gating and promotion deadline all run off
        # this object so a simulated standby never blocks real time
        self.clock = clock or WALL
        self.group = group
        # armed at PROMOTION only: a follower's output is discarded, so
        # journaling its stages would double-record every offset the
        # leader already covered — the promoted leader resumes the
        # leader's journal and continues the same per-order span stream
        # (a gap during the outage, not a fork)
        self.journal_out = journal_out
        self.trace_spans = trace_spans
        self.checkpoint_dir = checkpoint_dir
        self.listen = listen
        self.max_lag = max_lag
        self.poll = poll
        self.health_every = health_every
        self.health_file = health_file
        self.max_messages = max_messages
        self.idle_exit = idle_exit
        self.promote_file = promote_file or os.path.join(
            checkpoint_dir, PROMOTE_FILE)
        self.serve_health = serve_health or os.path.join(
            checkpoint_dir, "serve.health")
        self.log_dir = os.path.join(checkpoint_dir, "broker-log")
        self.holdback = max(1, batch)   # stay one batch behind (docstring)
        self._ppid = os.getppid()   # orphan detection (follow loop)
        topic_in = TOPIC_IN
        if group is not None and group[1] > 1:
            # shard-group mode: follow the group's namespaced input log
            topic_in = f"{TOPIC_IN}.g{group[0]}"
        self.follow = _FollowBroker(self.log_dir, topic=topic_in,
                                    clock=self.clock)
        self.svc = MatchService(
            self.follow, engine=engine, compat=compat, batch=batch,
            symbols=symbols, accounts=accounts, slots=slots,
            max_fills=max_fills, width=width, shards=shards,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            checkpoint_keep=checkpoint_keep,
            exactly_once=True, follower=True, group=group,
            clock=self.clock, device=device)
        self.tsdb = None
        self._tsdb_dir = tsdb
        if tsdb is not None:
            # the standby writes its own per-source history next to the
            # leader's in the shared TSDB dir; no checkpoint carries a
            # follower's sample cursor, so it adopts the store's
            # next_seq (replays after a standby restart would otherwise
            # dedup against its own history forever)
            from kme_tpu_torch.telemetry import TSDB
            source = "standby"
            if group is not None and group[1] > 1:
                source = f"standby.g{group[0]}"
            try:
                self.tsdb = TSDB(tsdb, source=source)
                self._tsdb_seq = self.tsdb.next_seq()
            except (OSError, ValueError) as e:
                print(f"kme-standby: TSDB disabled: {e}",
                      file=sys.stderr)
        self.metrics_server = None
        if metrics_port is not None:
            # the standby's own metrics surface (kme-torch-top scrapes
            # it next to the leader's to show replica lag live)
            from kme_tpu_torch.telemetry import start_metrics_server

            self.metrics_server = start_metrics_server(
                self.svc.telemetry, metrics_port)
            print(f"kme-standby: metrics on http://"
                  f"{self.metrics_server.server_address[0]}:"
                  f"{self.metrics_server.server_address[1]}/metrics",
                  file=sys.stderr)

    # -- following ------------------------------------------------------

    def _read_promote(self) -> Optional[dict]:
        """The promotion order — only if addressed to THIS process (a
        replacement standby spawned behind a promotion must never act
        on, or delete, the adoptee's order). pid-less promote files are
        honored for manual/test-driven promotion."""
        try:
            with open(self.promote_file) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return None
        pid = data.get("pid")
        if pid is not None and pid != os.getpid():
            return None
        return data

    def _leader_offset(self) -> int:
        """The leader's last confirmed applied offset — the follower
        must never apply input beyond it (module docstring)."""
        try:
            with open(self.serve_health) as f:
                hb = json.load(f)
            if hb.get("role") == "leader":
                return int(hb.get("offset", 0))
        except (OSError, ValueError, TypeError):
            pass
        return 0

    def _write_heartbeat(self, applied: int, tick: int) -> None:
        snap = self.svc.telemetry.snapshot()
        if self.tsdb is not None:
            try:
                seq = self._tsdb_seq
                self._tsdb_seq = seq + 1
                self.tsdb.append_snapshot(snap, seq)
            except OSError:
                self.tsdb = None    # history is best-effort
        if self.health_file is None:
            return
        tmp = self.health_file + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump({"pid": os.getpid(),
                           "time": self.clock.time(),
                           "role": "standby", "applied": applied,
                           "tick": tick,
                           "out_seq": self.svc.out_seq,
                           "discarded": self.follow.discarded,
                           "leader_offset": self._leader_offset(),
                           "metrics": snap}, f)
            os.replace(tmp, self.health_file)
        except OSError:
            pass        # reporting surface only

    def run(self) -> int:
        svc = self.svc
        print(f"kme-standby: following {self.log_dir} from offset "
              f"{svc.offset} (out_seq {svc.out_seq})", file=sys.stderr)
        tick = 0
        last_hb = 0.0
        while True:
            promote = self._read_promote()
            if promote is not None:
                return self._promote(promote)
            if os.getppid() != self._ppid:
                # reparented: the supervisor that would ever promote us
                # is gone — a follower with no path to leadership is an
                # orphan, not a service
                print("kme-standby: supervisor died; exiting",
                      file=sys.stderr)
                return 0
            self.follow.limit = max(self.follow.limit,
                                    self._leader_offset() - self.holdback)
            n = svc.step(timeout=self.poll)
            tick += 1
            if n and faults.should("standby.lag", offset=svc.offset):
                print(f"kme-faults: standby stalled at offset "
                      f"{svc.offset}", file=sys.stderr)
                self.clock.sleep(1.0)
            now = self.clock.monotonic()
            if now - last_hb >= self.health_every:
                last_hb = now
                lead = self._leader_offset()
                t = svc.telemetry
                t.gauge("replica_applied_offset").set(svc.offset)
                t.gauge("replica_leader_offset").set(lead)
                t.gauge("replica_lag_records",
                        "input records the leader confirmed but this "
                        "standby has not applied").set(
                    max(0, lead - svc.offset))
                self._write_heartbeat(svc.offset, tick)

    # -- promotion ------------------------------------------------------

    def _promote(self, promote: dict) -> int:
        """Become the leader: next epoch, real broker over the durable
        logs, the leader's TCP endpoint, and the ordinary serve loop.
        The applied-offset .. dead-leader-output overlap replays through
        the broker's idempotent-produce watermark (see module
        docstring)."""
        from kme_tpu_torch.bridge.provision import group_topics, provision
        from kme_tpu_torch.bridge.tcp import parse_addr, serve_broker
        # flight recorder: promotion begin/end bracket the whole
        # takeover (broker reopen, endpoint rebind, epoch fence) so the
        # merged timeline shows the failover window, not just its end.
        # The standby's own source name keeps it distinct from the
        # supervisor's promote decision in the merged view.
        from kme_tpu_torch.telemetry import events as cpevents

        svc = self.svc
        evlog = cpevents.open_log(self.checkpoint_dir, "standby",
                                  clock=self.clock.time)
        try:
            evlog.emit("replica.promote.begin",
                       group=(self.group[0] if self.group else None),
                       offset=svc.offset,
                       failed_at=promote.get("failed_at"))
        except Exception:
            pass
        if self.tsdb is not None:
            # hand history over to the serve path: the promoted leader
            # continues the LEADER's source series (adopting its
            # next_seq cursor from disk), not the standby's
            self.tsdb.close()
            self.tsdb = None
            svc._tsdb_arg = self._tsdb_dir
            svc.follower = False    # source name resolves to "serve"
            svc._init_profiling(resumed=False)
        with contextlib.suppress(OSError):
            os.unlink(self.promote_file)
        broker = InProcessBroker(persist_dir=self.log_dir,
                                 max_lag=self.max_lag)
        provision(broker, topics=(group_topics(self.group[0])
                                  if self.group is not None
                                  and self.group[1] > 1 else None))
        # ^ idempotent; logs already reloaded
        host, port = parse_addr(self.listen)
        deadline = self.clock.monotonic() + 10.0
        while True:
            try:
                # the dead leader's socket may linger in TIME_WAIT for
                # a moment even with SO_REUSEADDR; retry briefly
                srv, broker = serve_broker(host, port, broker)
                break
            except OSError:
                if self.clock.monotonic() >= deadline:
                    raise
                self.clock.sleep(0.1)
        svc.broker = broker
        svc.follower = False
        svc._init_exactly_once(resumed=False)   # next epoch + fence
        if self.journal_out is not None and svc.journal is None:
            # resume the dead leader's journal so the per-order span
            # stream CONTINUES across the failover (rewound to our
            # applied offset exactly like the serve resume path — the
            # overlap we re-process re-journals, and the stitcher
            # dedups it by (group, local_off, kind))
            from kme_tpu_torch.telemetry import Journal

            svc.journal = Journal(self.journal_out)
            svc.journal.rewind_to_offset(svc.offset)
            svc.trace_spans = bool(self.trace_spans)
        failover = None
        try:
            failed_at = float(promote["failed_at"])
            failover = round(max(0.0, self.clock.time() - failed_at), 3)
            svc.telemetry.gauge("failover_seconds").set(failover)
        except (KeyError, TypeError, ValueError):
            pass
        print(f"kme-standby: PROMOTED to leader epoch {svc.epoch} at "
              f"offset {svc.offset} (out_seq {svc.out_seq}, "
              f"failover {failover if failover is not None else '?'}s)",
              file=sys.stderr)
        try:
            evlog.emit("replica.promote.end",
                       group=(self.group[0] if self.group else None),
                       epoch=svc.epoch, offset=svc.offset,
                       out_seq=svc.out_seq,
                       failover_seconds=failover)
            evlog.close()
        except Exception:
            pass
        try:
            seen = svc.run(max_messages=self.max_messages,
                           idle_exit=self.idle_exit,
                           health_file=self.serve_health,
                           health_every=self.health_every)
            svc.checkpoint()
            print(f"kme-standby: processed {seen} records as leader",
                  file=sys.stderr)
            return 0
        finally:
            svc.close()
            srv.shutdown()
            srv.server_close()
            if hasattr(broker, "close"):
                broker.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kme-torch-standby",
                                description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint-dir", required=True,
                   help="the LEADER's state root (snapshots, broker "
                        "logs, lease, promote file) — shared read-only "
                        "until promotion")
    p.add_argument("--listen", default="127.0.0.1:9092",
                   metavar="HOST:PORT",
                   help="the leader's broker endpoint, bound at "
                        "promotion")
    p.add_argument("--engine", choices=("seq", "lanes", "oracle",
                                        "native"), default="seq")
    p.add_argument("--compat", choices=("java", "fixed"),
                   default="fixed")
    p.add_argument("--device", default="cuda",
                   help="where the seq and lanes engines run (default "
                        "the card; 'cpu' runs the kernels' plain "
                        "PyTorch versions), as for kme-torch-serve")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--symbols", type=int, default=1024)
    p.add_argument("--accounts", type=int, default=4096)
    p.add_argument("--slots", type=int, default=128)
    p.add_argument("--max-fills", type=int, default=16)
    p.add_argument("--width", type=int, default=8)
    p.add_argument("--shards", type=int, default=1)
    p.add_argument("--checkpoint-every", type=int, default=4096)
    p.add_argument("--checkpoint-keep", type=int, default=None)
    p.add_argument("--max-lag", type=int, default=None)
    p.add_argument("--idle-exit", type=float, default=None,
                   help="applies AFTER promotion (a follower waits "
                        "indefinitely)")
    p.add_argument("--max-messages", type=int, default=None)
    p.add_argument("--health-file", default=None, metavar="PATH",
                   help="standby heartbeat JSON ({pid, time, role, "
                        "applied, tick}); the supervisor requires it "
                        "before promoting")
    p.add_argument("--health-every", type=float, default=1.0)
    p.add_argument("--promote-file", default=None, metavar="PATH",
                   help="promotion trigger written by "
                        "kme-torch-supervise (default "
                        "<checkpoint-dir>/promote.json)")
    p.add_argument("--serve-health-file", default=None, metavar="PATH",
                   help="the LEADER's heartbeat to bound application "
                        "by (default <checkpoint-dir>/serve.health); "
                        "reused as this process's own heartbeat after "
                        "promotion")
    p.add_argument("--poll", type=float, default=0.2,
                   help="follow-loop poll interval (also the promote-"
                        "file detection latency bound)")
    p.add_argument("--metrics-port", type=int, default=None,
                   metavar="PORT",
                   help="serve this standby's own /metrics + "
                        "/metrics.json (0 picks a free port); "
                        "kme-torch-top scrapes it next to the leader's")
    p.add_argument("--group", default=None, metavar="K/N",
                   help="follow shard group K of N (namespaced "
                        "MatchIn.gK log; promotion rebinds the group's "
                        "own topics)")
    p.add_argument("--journal-out", default=None, metavar="PATH",
                   help="armed at PROMOTION: resume the dead leader's "
                        "journal at this path and keep recording "
                        "(same spelling as kme-torch-serve, so "
                        "forwarded serve_args just work)")
    p.add_argument("--trace-spans", action="store_true",
                   help="armed at PROMOTION: continue the leader's "
                        "per-order span stream (requires "
                        "--journal-out)")
    p.add_argument("--tsdb", default=None, metavar="DIR",
                   help="append this standby's heartbeat metrics to "
                        "the shared on-disk time-series store (source "
                        "'standby'); at promotion the store is handed "
                        "to the serve path and history continues under "
                        "the leader's source")
    args, unknown = p.parse_known_args(argv)
    if unknown:
        # the supervisor forwards the leader's serve_args verbatim;
        # serve-only flags (pipeline, journal, metrics, strict, ...)
        # don't apply to a follower and are ignored loudly rather than
        # fatally
        print(f"kme-standby: ignoring serve-only flag(s): "
              f"{' '.join(unknown)}", file=sys.stderr)
    group = None
    if args.group is not None:
        try:
            gk, gn = (int(x) for x in args.group.split("/", 1))
        except ValueError:
            print(f"kme-standby: --group wants K/N, got {args.group!r}",
                  file=sys.stderr)
            return 2
        group = (gk, gn)
    rep = Replica(args.checkpoint_dir, listen=args.listen,
                  engine=args.engine, compat=args.compat,
                  batch=args.batch, symbols=args.symbols,
                  accounts=args.accounts, slots=args.slots,
                  max_fills=args.max_fills, width=args.width,
                  shards=args.shards,
                  checkpoint_every=args.checkpoint_every,
                  checkpoint_keep=args.checkpoint_keep,
                  max_lag=args.max_lag,
                  promote_file=args.promote_file,
                  health_file=args.health_file,
                  serve_health=args.serve_health_file,
                  poll=args.poll, health_every=args.health_every,
                  max_messages=args.max_messages,
                  idle_exit=args.idle_exit,
                  metrics_port=args.metrics_port,
                  group=group, journal_out=args.journal_out,
                  trace_spans=args.trace_spans, tsdb=args.tsdb,
                  device=args.device)
    try:
        return rep.run()
    except BrokerFenced as e:
        print(f"kme-standby: FENCED: {e}", file=sys.stderr)
        return 75
    except KeyboardInterrupt:
        return 0
    finally:
        if rep.tsdb is not None:
            rep.tsdb.close()
        if rep.metrics_server is not None:
            rep.metrics_server.shutdown()


if __name__ == "__main__":
    sys.exit(main())
