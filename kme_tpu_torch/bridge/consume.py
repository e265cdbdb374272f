"""Fill-stream consumer — the consumer.js role
(the reference's consumer.js:10-20): subscribe to `MatchOut` from the
beginning and print one `<key> <value>` line per record.

Under the exactly-once output path every MatchOut record carries an
`(epoch, out_seq)` produce stamp (wire.ProduceStamp) and the broker
already suppresses replayed stamps before they reach the log; the
DedupRing here is the consumer's defense-in-depth for streams that
bypassed broker dedup (a log written before fencing was enabled, or a
transport without stamp support) — it drops any stamp it has already
seen and counts the drop in `dup_suppressed_total`."""

from __future__ import annotations

import argparse
import collections
import sys

from kme_tpu_torch.bridge.service import TOPIC_OUT


class DedupRing:
    """Ring of the most recent `capacity` (epoch, out_seq) produce
    stamps. Replay after a crash is CONTIGUOUS (the post-snapshot tail),
    so a ring bounded well above the checkpoint interval catches every
    real duplicate without unbounded memory; unstamped records pass
    through untouched."""

    def __init__(self, capacity: int = 65536) -> None:
        self.capacity = max(1, int(capacity))
        self._order = collections.deque()
        self._seen = set()
        self.suppressed = 0

    def is_dup(self, epoch, out_seq) -> bool:
        """True (and counted) when this stamp was already seen."""
        if epoch is None or out_seq is None:
            return False
        stamp = (epoch, out_seq)
        if stamp in self._seen:
            self.suppressed += 1
            return True
        self._seen.add(stamp)
        self._order.append(stamp)
        if len(self._order) > self.capacity:
            self._seen.discard(self._order.popleft())
        return False


def consume_lines(broker, offset: int = 0, follow: bool = True,
                  poll_timeout: float = 0.5, idle_exit: float = None,
                  dedup: DedupRing = None, latency=None,
                  topic: str = TOPIC_OUT):
    """Yield `<key> <value>` lines from `topic` (MatchOut, or a group's
    MatchOut.gK) starting at `offset`.
    follow=False stops at the current end; idle_exit stops after that
    many idle seconds. While following, a missing topic is polled for
    (subscribe-and-wait, like the reference consumer and
    MatchService.step) instead of crashing a consumer that was started
    before provisioning. `dedup` suppresses records whose produce stamp
    the ring has already seen.

    `latency` (a telemetry LatencyHistogram, or any object with
    observe(seconds)) receives the receipt latency — now minus the
    record's broker-admission stamp `ats` — for every delivered record
    that carries one. This measures from intended start (produce
    admission), not from this consumer's dequeue, so a stalled consumer
    shows its backlog as latency instead of hiding it."""
    import time

    from kme_tpu_torch.bridge.broker import BrokerError

    idle_since = time.monotonic()
    while True:
        try:
            recs = broker.fetch(topic, offset, 4096,
                                timeout=poll_timeout if follow else 0.0)
        except BrokerError as e:
            # only a not-yet-provisioned topic is waited for; anything
            # else (dead broker, protocol error) stays fatal so a
            # follower doesn't silently busy-loop on a lost broker
            if not follow or "unknown topic" not in str(e):
                raise
            if (idle_exit is not None
                    and time.monotonic() - idle_since >= idle_exit):
                return
            time.sleep(min(poll_timeout, 0.05))
            continue
        if not recs:
            if not follow:
                return
            if (idle_exit is not None
                    and time.monotonic() - idle_since >= idle_exit):
                return
            continue
        idle_since = time.monotonic()
        now_us = time.time_ns() // 1000
        for r in recs:
            if dedup is not None and dedup.is_dup(
                    getattr(r, "epoch", None), getattr(r, "out_seq", None)):
                continue
            ats = getattr(r, "ats", None)
            if latency is not None and ats is not None:
                latency.observe(max(0, now_us - ats) * 1e-6)
            yield f"{r.key} {r.value}"
        offset = recs[-1].offset + 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kme-torch-consume", description=__doc__)
    p.add_argument("--broker", default="127.0.0.1:9092", metavar="HOST:PORT")
    p.add_argument("--topic", default=TOPIC_OUT,
                   help="the output topic to read (a multi-leader group "
                        "K's is MatchOut.gK)")
    p.add_argument("--no-follow", action="store_true",
                   help="stop at the current end of the topic")
    p.add_argument("--idle-exit", type=float, default=None, metavar="SECS",
                   help="exit after this many seconds with no new records")
    p.add_argument("--no-dedup", action="store_true",
                   help="print replayed stamped records too (raw "
                        "at-least-once view of the log)")
    p.add_argument("--latency", action="store_true",
                   help="print a receipt-latency summary (produce "
                        "admission -> consumer delivery) on exit")
    p.add_argument("--tsdb-out", default=None, metavar="DIR",
                   help="append delivery counters (and, with "
                        "--latency, receipt-latency quantiles) to the "
                        "shared on-disk time-series store every second "
                        "(source 'consume'; kme-torch-prof queries it)")
    args = p.parse_args(argv)
    import time

    from kme_tpu_torch.bridge.tcp import TcpBroker, parse_addr
    from kme_tpu_torch.telemetry import LatencyHistogram

    host, port = parse_addr(args.broker)
    client = TcpBroker(host, port)
    ring = None if args.no_dedup else DedupRing()
    lat = LatencyHistogram("consume_receipt") if args.latency else None
    tsdb = None
    tsdb_seq = 0
    if args.tsdb_out is not None:
        from kme_tpu_torch.telemetry import TSDB

        try:
            tsdb = TSDB(args.tsdb_out, source="consume")
            tsdb_seq = tsdb.next_seq()  # no durable cursor: adopt disk
        except (OSError, ValueError) as e:
            print(f"kme-consume: TSDB disabled: {e}", file=sys.stderr)
    delivered = 0
    last_sample = time.monotonic()

    def _tsdb_sample():
        nonlocal tsdb, tsdb_seq
        if tsdb is None:
            return
        vals = {"consume_delivered_total": delivered,
                "consume_dup_suppressed_total":
                    ring.suppressed if ring is not None else 0}
        if lat is not None and lat.count:
            qs = lat.quantiles()
            vals["consume_receipt.count"] = lat.count
            vals["consume_receipt.p50_ms"] = qs[0.5] * 1e3
            vals["consume_receipt.p99_ms"] = qs[0.99] * 1e3
            vals["consume_receipt.p999_ms"] = qs[0.999] * 1e3
        try:
            tsdb.append_values(vals, tsdb_seq)
            tsdb_seq += 1
        except OSError:
            tsdb = None         # history is best-effort

    try:
        for line in consume_lines(client, follow=not args.no_follow,
                                  idle_exit=args.idle_exit, dedup=ring,
                                  latency=lat, topic=args.topic):
            print(line, flush=True)
            delivered += 1
            now = time.monotonic()
            if tsdb is not None and now - last_sample >= 1.0:
                last_sample = now
                _tsdb_sample()
    except KeyboardInterrupt:
        pass
    finally:
        client.close()
        if delivered or lat is not None:
            _tsdb_sample()      # final cumulative sample
        if tsdb is not None:
            tsdb.close()
        if ring is not None and ring.suppressed:
            print(f"kme-consume: suppressed {ring.suppressed} duplicate "
                  f"record(s)", file=sys.stderr)
        if lat is not None and lat.count:
            qs = lat.quantiles()
            print("kme-consume: receipt latency "
                  f"n={lat.count} "
                  f"p50={qs[0.5] * 1e3:.3f}ms "
                  f"p99={qs[0.99] * 1e3:.3f}ms "
                  f"p999={qs[0.999] * 1e3:.3f}ms", file=sys.stderr)
    return 0
