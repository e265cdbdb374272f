"""The simulated front→group transport: in-memory FrontLinks.

Models what `bridge/front.FrontLinks` gives the real cluster — one
ordered, stamped produce link per group — under the scheduler's
control:

- per-link FIFO: a group's durable MatchIn order always equals its
  routed substream order, so `verify_groups` parity holds under ANY
  fault schedule.  The guarantee is structural, not scheduling luck:
  arrivals land in a per-link reorder buffer and are produced strictly
  in stamp order (`next_deliver`), so a crash window — during which
  earlier records park while later ones keep arriving — can never let
  a later stamp reach the broker first and dup-suppress the earlier
  ones into silent input loss;
- idempotent stamps: every delivery carries the link's monotone
  `out_seq` cursor (epoch-less, like the live front), so duplicate
  re-sends vanish at the broker's watermark — which is exactly what
  the `net.reorder` fault exercises: it re-sends an EARLIER record
  after newer ones (the out-of-order-duplicate shape a buggy retry
  path would produce) and the verdicts prove the broker swallowed it;
- `net.partition` severs a link for the rule's `ms` virtual
  milliseconds (deliveries queue and flush in order on heal — never
  drop, like a sender with a deep retry budget);
- `net.delay` stalls a link by `ms` (everything behind shifts too);
- a crashed leader's deliveries park in the reorder buffer and flush
  in stamp order on restart (connection-refused + retry, collapsed to
  its effect).

Faults are drawn from the process-global `faults` plan (the KME_FAULTS
grammar — clauses generated per seed by `schedule.py`), with the
delivery ordinal as the `at=` offset domain.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from kme_tpu_torch import faults


class _Link:
    __slots__ = ("g", "next_free", "down_until", "seq", "pending",
                 "next_deliver", "delivered", "dup_resends", "last")

    def __init__(self, g: int, cursor: int = 0) -> None:
        self.g = g
        self.next_free = 0.0        # link-FIFO serialization point
        self.down_until = 0.0       # net.partition window end
        self.seq = cursor           # per-link idempotent produce cursor
        self.pending: Dict[int, tuple] = {}  # arrived, not yet produced
        self.next_deliver = cursor  # the stamp the broker gets next
        self.delivered = 0
        self.dup_resends = 0
        self.last: Optional[tuple] = None   # last sent (for net.reorder)


class SimTransport:
    """`send()` at route time, scheduled arrival at virtual delivery
    time, strictly stamp-ordered produce. `broker_for(g)` comes from
    the cluster and returns None while group g's leader is down."""

    def __init__(self, sched, ngroups: int, broker_for: Callable,
                 topic_for: Callable[[int], str],
                 base_latency: float = 0.0005) -> None:
        self.sched = sched
        self.broker_for = broker_for
        self.topic_for = topic_for
        self.base = base_latency
        self.links = [_Link(g) for g in range(ngroups)]
        self.sent = 0               # global delivery ordinal (at= domain)
        self.in_flight = 0

    def reshape(self, ngroups: int,
                cursors: Optional[List[int]] = None) -> None:
        """New topology after a reshard: fresh links. `cursors` is the
        coordinator's settle-phase `resume_cursors` — the new MatchIn
        logs already hold that many stamped settlement legs, so each
        link's produce cursor must START above them or the first real
        delivery would be dup-suppressed (silent input loss)."""
        assert all(not l.pending for l in self.links), \
            "reshard barrier requires a drained transport"
        self.links = [_Link(g, int(cursors[g]) if cursors else 0)
                      for g in range(ngroups)]

    def idle(self) -> bool:
        return self.in_flight == 0

    # -- send path -----------------------------------------------------

    def send(self, g: int, key: Optional[str], value: str) -> None:
        link = self.links[g]
        self.sent += 1
        ordinal = self.sent
        stamped = (key, value, link.seq)
        link.seq += 1
        rule = faults.fire("net.partition", offset=ordinal)
        if rule is not None:
            link.down_until = max(link.down_until,
                                  self.sched.now + rule.ms / 1000.0)
            self.sched.trace(f"link{g}", "partition", ms=rule.ms)
        extra = 0.0
        rule = faults.fire("net.delay", offset=ordinal)
        if rule is not None:
            extra = rule.ms / 1000.0
            self.sched.trace(f"link{g}", "delay", ms=rule.ms)
        self._enqueue(link, stamped, extra)
        if link.last is not None \
                and faults.fire("net.reorder", offset=ordinal) is not None:
            # out-of-order duplicate: the previous record rides AGAIN
            # behind this one with its ORIGINAL stamp — the broker's
            # idempotence watermark must swallow it
            link.dup_resends += 1
            self.sched.trace(f"link{g}", "reorder_dup",
                             seq=link.last[2])
            self._enqueue(link, link.last, 0.0)
        link.last = stamped

    def _enqueue(self, link: _Link, stamped: tuple,
                 extra: float) -> None:
        at = max(self.sched.now, link.next_free, link.down_until) \
            + self.base + extra
        link.next_free = at
        self.in_flight += 1
        self.sched.post(at - self.sched.now,
                        lambda: self._arrive(link, stamped))

    # -- delivery ------------------------------------------------------

    def _arrive(self, link: _Link, stamped: tuple) -> None:
        if self.sched.now < link.down_until:
            # partitioned after scheduling: requeue at heal, preserving
            # FIFO (next_free only grows)
            delay = link.down_until - self.sched.now
            link.next_free = max(link.next_free,
                                 link.down_until + self.base)
            self.sched.post(delay,
                            lambda: self._arrive(link, stamped))
            return
        seq = stamped[2]
        if seq < link.next_deliver:
            # a re-sent duplicate of an ALREADY-produced stamp: goes
            # straight to the broker for watermark suppression
            self._produce_dup(link, stamped)
            return
        if seq in link.pending:
            # duplicate of a stamp still waiting in the buffer —
            # collapses into the one pending entry
            self.in_flight -= 1
        else:
            link.pending[seq] = stamped
        self._drain(link)

    def _drain(self, link: _Link) -> None:
        """Produce pending records strictly in stamp order; stop at a
        gap (an earlier stamp still in transit), a downed leader, or
        an injected broker error (which reposts the drain)."""
        from kme_tpu_torch.bridge.broker import BrokerError

        while link.next_deliver in link.pending:
            broker = self.broker_for(link.g)
            if broker is None:
                return          # parked: flush_held drains on restart
            key, value, seq = link.pending[link.next_deliver]
            try:
                off = broker.produce(self.topic_for(link.g), key,
                                     value, out_seq=seq)
            except BrokerError:
                # injected broker.produce fault (or overload): retry
                # the SAME stamped record shortly, like FrontLinks
                self.sched.trace(f"link{link.g}", "produce_retry",
                                 seq=seq)
                self.sched.post(0.01, lambda: self._drain(link))
                return
            del link.pending[link.next_deliver]
            link.next_deliver += 1
            self.in_flight -= 1
            link.delivered += 1
            if off < 0:
                self.sched.trace(f"link{link.g}", "dup_suppressed",
                                 seq=seq)

    def _produce_dup(self, link: _Link, stamped: tuple) -> None:
        from kme_tpu_torch.bridge.broker import BrokerError

        broker = self.broker_for(link.g)
        if broker is None:
            # leader down mid-duplicate: retry after a beat (the sim
            # never drops — determinism over realism of loss, which
            # the broker watermark would mask anyway)
            self.sched.post(0.05,
                            lambda: self._produce_dup(link, stamped))
            return
        key, value, seq = stamped
        try:
            off = broker.produce(self.topic_for(link.g), key, value,
                                 out_seq=seq)
        except BrokerError:
            self.sched.trace(f"link{link.g}", "produce_retry", seq=seq)
            self.sched.post(0.01,
                            lambda: self._produce_dup(link, stamped))
            return
        self.in_flight -= 1
        link.delivered += 1
        if off < 0:
            self.sched.trace(f"link{link.g}", "dup_suppressed", seq=seq)

    def flush_held(self, g: int) -> None:
        """Leader back up: drain the records parked in stamp order."""
        link = self.links[g]
        n = len(link.pending)
        self._drain(link)
        if n:
            self.sched.trace(f"link{g}", "flush_held", n=n)
