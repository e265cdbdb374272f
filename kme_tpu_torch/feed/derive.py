"""Deterministic book-delta derivation from the MatchOut stream.

`FeedDeriver` is a PURE function of the MatchOut record sequence: no
clock, no RNG, no I/O (enforced by the kme-lint FEED_SCOPES table),
so any two derivers at the same `(group, out_seq)` watermark emit
byte-identical frames — which is what makes feed failover trivial: a
promoted leader's deriver regenerates the exact frames the dead one
would have sent, and the consumer-side DedupRing plus per-symbol
sequence numbers absorb the overlap.

The deriver never talks to the engine. It reconstructs resting-order
state purely from the `<key> <value>` output records, using invariants
of the reference output shape (oracle/engine.py is the executable
spec):

  * every input message produces `IN <echo>`, zero or more fill pairs
    `OUT <maker>` / `OUT <taker>` (actions SOLD/BOUGHT, maker first,
    maker fill price always 0), then exactly one `OUT <result>` echo
    whose action is the ORIGINAL action on success or REJECT on
    failure. A result echo can therefore never carry BOUGHT/SOLD —
    those actions mark fill events unambiguously.
  * fills alternate maker (even position) / taker (odd position)
    within a message; the IN record resets the parity. The maker fill
    reduces the resting order `oid` by the fill size (Java int
    arithmetic) and the engine deletes it at exactly zero; the taker
    fill never touches the book (the taker is the in-flight message).
  * a BUY/SELL result echo with size != 0 rested exactly `size` at
    (sid, action, price) — tryMatch returns taker.size == 0, so a
    non-zero echo size is equivalent to "the residual rested". A
    duplicate oid overwrites the stored order, like the store does.
  * a CANCEL success echo removed `oid` from the store.
  * a REMOVE_SYMBOL or PAYOUT success echo wiped every resting order
    with abs(sid) == abs(echo.sid) (vacuous under java compat, where
    removal only succeeds on empty books; exact in fixed mode).
  * REJECT / ADD_SYMBOL / CREATE_BALANCE / TRANSFER echoes never
    touch a book. The capacity-envelope rollback emits only
    [IN, OUT REJECT], so it needs no special case.

Frames are sequenced PER SYMBOL (frames.py) and emitted in a sorted,
restore-invariant order, so a deriver restored from a feed snapshot
continues the exact byte stream the original would have produced.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Set, Tuple

from kme_tpu_torch import opcodes as op
from kme_tpu_torch.feed import frames as ff
from kme_tpu_torch.feed.frames import FeedFrame, decode_feed
from kme_tpu_torch.oracle import javalong as jl
from kme_tpu_torch.wire import OrderMsg, parse_order

SIDE_BUY = 0
SIDE_SELL = 1

# resting-order tuple indices (oid -> (sid, side, price, size))
_R_SID, _R_SIDE, _R_PRICE, _R_SIZE = range(4)

_EMPTY_TOB = (0, 0, 0, 0)


class BookState:
    """Aggregated price levels: (sid, side) -> {price: total_size}.
    Levels are deleted at a total of exactly 0 (Java int sums can pass
    through 0 with negative-size java-mode orders; the engine's store
    view and this one agree because both apply the same arithmetic)."""

    def __init__(self) -> None:
        self.levels: Dict[Tuple[int, int], Dict[int, int]] = {}

    def set_level(self, sid: int, side: int, price: int,
                  size: int) -> None:
        key = (sid, side)
        if size == 0:
            lv = self.levels.get(key)
            if lv is not None:
                lv.pop(price, None)
                if not lv:
                    del self.levels[key]
            return
        self.levels.setdefault(key, {})[price] = size

    def get_level(self, sid: int, side: int, price: int) -> int:
        return self.levels.get((sid, side), {}).get(price, 0)

    def tob(self, sid: int) -> Tuple[int, int, int, int]:
        """(bid_price, bid_size, ask_price, ask_size); size 0 = side
        empty (price then 0). Best bid = highest buy price, best ask =
        lowest sell price."""
        bids = self.levels.get((sid, SIDE_BUY))
        asks = self.levels.get((sid, SIDE_SELL))
        bp = bs = ap = asz = 0
        if bids:
            bp = max(bids)
            bs = bids[bp]
        if asks:
            ap = min(asks)
            asz = asks[ap]
        return (bp, bs, ap, asz)

    def depth(self, sid: int, n: int = 0
              ) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
        """(bids, asks) as (price, size) lists, best price first;
        n = 0 returns the full book."""
        bids = sorted(self.levels.get((sid, SIDE_BUY), {}).items(),
                      key=lambda kv: -kv[0])
        asks = sorted(self.levels.get((sid, SIDE_SELL), {}).items())
        if n:
            bids, asks = bids[:n], asks[:n]
        return bids, asks

    def sids(self) -> List[int]:
        return sorted({sid for sid, _side in self.levels})


def canonical_books(book) -> bytes:
    """Canonical byte encoding of a book state (BookState or a raw
    levels dict): one sorted `sid side price size` line per level.
    THE byte-exactness comparator — deriver, subscribers and the
    oracle aggregate are all reduced to this before comparison, at
    every depth (it IS the full depth)."""
    levels = book.levels if isinstance(book, BookState) else book
    rows = []
    for (sid, side), lv in levels.items():
        for price, size in lv.items():
            if size != 0:
                rows.append((sid, side, price, size))
    rows.sort()
    return "\n".join(f"{s} {d} {p} {z}" for s, d, p, z in rows).encode()


def books_from_oracle(engine) -> Dict[Tuple[int, int], Dict[int, int]]:
    """Aggregate an OracleEngine's resting-order store into the
    (sid, side) -> {price: size} level view — the independent ground
    truth the deriver is pinned against (it sums the store directly,
    never the MatchOut stream)."""
    levels: Dict[Tuple[int, int], Dict[int, int]] = {}
    for o in engine.orders.values():
        side = SIDE_SELL if o.action == op.SELL else SIDE_BUY
        lv = levels.setdefault((o.sid, side), {})
        lv[o.price] = lv.get(o.price, 0) + o.size
    for key in [k for k, lv in levels.items()
                if not any(v != 0 for v in lv.values())]:
        del levels[key]
    for lv in levels.values():
        for price in [p for p, v in lv.items() if v == 0]:
            del lv[price]
    return levels


class FeedDeriver:
    """Incremental MatchOut -> feed-frame derivation for one group.

    depth_every > 0 additionally emits an advisory top-`depth_levels`
    depth frame for every touched symbol each `depth_every` input
    messages — periodic by MESSAGE COUNT, never by clock, so the
    emission schedule replays identically."""

    def __init__(self, group: int = 0, depth_every: int = 0,
                 depth_levels: int = 8) -> None:
        self.group = int(group)
        self.depth_every = int(depth_every)
        self.depth_levels = int(depth_levels)
        self.book = BookState()
        # oid -> (sid, side, price, size): mirror of the engine's
        # resting-order store, rebuilt purely from output records
        self.resting: Dict[int, Tuple[int, int, int, int]] = {}
        self._seqs: Dict[int, int] = {}      # sid -> last seq assigned
        self._tob: Dict[int, Tuple[int, int, int, int]] = {}
        self._fills = 0                      # fill parity in this message
        self.groups_seen = 0                 # input messages (IN records)
        self._dirty_depth: Set[int] = set()
        self.watermark = (-1, -1)            # (src_epoch, src_seq)
        self.frames_out = 0

    # -- frame emission -------------------------------------------------

    def _next_seq(self, sid: int) -> int:
        seq = self._seqs.get(sid, 0) + 1
        self._seqs[sid] = seq
        self.frames_out += 1
        return seq

    def _frame(self, raw: bytes) -> FeedFrame:
        f, _ = decode_feed(raw)
        return f

    def _emit_delta(self, out: List[FeedFrame], sid: int, side: int,
                    price: int, size: int) -> None:
        ep, sq = self.watermark
        out.append(self._frame(ff.encode_delta(
            self.group, self._next_seq(sid), ep, sq, sid, side, price,
            size)))

    def _emit_tob(self, out: List[FeedFrame], sid: int) -> None:
        view = self.book.tob(sid)
        if view == self._tob.get(sid, _EMPTY_TOB):
            return
        self._tob[sid] = view
        ep, sq = self.watermark
        out.append(self._frame(ff.encode_tob(
            self.group, self._next_seq(sid), ep, sq, sid, *view)))

    def _emit_depth(self, out: List[FeedFrame], sid: int,
                    refresh: bool = False) -> None:
        bids, asks = self.book.depth(
            sid, 0 if refresh else self.depth_levels)
        ep, sq = self.watermark
        out.append(self._frame(ff.encode_depth(
            self.group, self._next_seq(sid), ep, sq, sid, bids, asks,
            refresh=refresh)))

    # -- book mutation --------------------------------------------------

    def _level_add(self, sid: int, side: int, price: int, delta: int,
                   touched: Dict[Tuple[int, int, int], int]) -> None:
        """Apply a signed size delta to a level, remembering the
        pre-record total on first touch so the record's net effect is
        emitted once per level."""
        pre = self.book.get_level(sid, side, price)
        tkey = (sid, side, price)
        if tkey not in touched:
            touched[tkey] = pre
        self.book.set_level(sid, side, price, pre + delta)

    def _drop_resting(self, oid: int,
                      touched: Dict[Tuple[int, int, int], int]) -> None:
        r = self.resting.pop(oid, None)
        if r is not None and r[_R_SIZE] != 0:
            self._level_add(r[_R_SID], r[_R_SIDE], r[_R_PRICE],
                            -r[_R_SIZE], touched)

    def _apply_out(self, m: OrderMsg,
                   touched: Dict[Tuple[int, int, int], int]) -> None:
        a = m.action
        if a in (op.BOUGHT, op.SOLD):
            parity = self._fills
            self._fills += 1
            if parity % 2:
                return              # taker fill: never on the book
            r = self.resting.get(m.oid)
            if r is None:
                return              # unreachable on well-formed streams
            new_size = jl.jint(r[_R_SIZE] - m.size)
            if new_size == 0:
                self.resting.pop(m.oid, None)
            else:
                self.resting[m.oid] = (r[_R_SID], r[_R_SIDE],
                                       r[_R_PRICE], new_size)
            self._level_add(r[_R_SID], r[_R_SIDE], r[_R_PRICE],
                            new_size - r[_R_SIZE], touched)
        elif a in (op.BUY, op.SELL):
            if m.size == 0:
                return              # fully filled, nothing rested
            side = SIDE_SELL if a == op.SELL else SIDE_BUY
            self._drop_resting(m.oid, touched)   # duplicate-oid overwrite
            self.resting[m.oid] = (m.sid, side, m.price, m.size)
            self._level_add(m.sid, side, m.price, m.size, touched)
        elif a == op.CANCEL:
            self._drop_resting(m.oid, touched)
        elif a in (op.REMOVE_SYMBOL, op.PAYOUT):
            target = abs(m.sid)
            for oid in sorted(self.resting):
                if abs(self.resting[oid][_R_SID]) == target:
                    self._drop_resting(oid, touched)
        # REJECT / ADD_SYMBOL / CREATE_BALANCE / TRANSFER: no book effect

    # -- record entry points --------------------------------------------

    def on_record(self, key: str, msg: Optional[OrderMsg],
                  epoch: Optional[int] = None,
                  src_seq: Optional[int] = None) -> List[FeedFrame]:
        """Process one MatchOut record; returns the frames it caused,
        in emission order. `msg` may be None for non-OUT keys (their
        payload is never inspected)."""
        self.watermark = (-1 if epoch is None else int(epoch),
                          -1 if src_seq is None else int(src_seq))
        out: List[FeedFrame] = []
        if key == "IN":
            self._fills = 0
            self.groups_seen += 1
            if (self.depth_every > 0 and self._dirty_depth
                    and self.groups_seen % self.depth_every == 0):
                for sid in sorted(self._dirty_depth):
                    self._emit_depth(out, sid)
                self._dirty_depth.clear()
            return out
        if key != "OUT" or msg is None:
            return out
        touched: Dict[Tuple[int, int, int], int] = {}
        self._apply_out(msg, touched)
        changed_sids: Set[int] = set()
        for tkey in sorted(touched):
            sid, side, price = tkey
            now = self.book.get_level(sid, side, price)
            if now != touched[tkey]:
                self._emit_delta(out, sid, side, price, now)
                changed_sids.add(sid)
        for sid in sorted(changed_sids):
            self._emit_tob(out, sid)
            self._dirty_depth.add(sid)
        return out

    def on_line(self, line: str, epoch: Optional[int] = None,
                src_seq: Optional[int] = None) -> List[FeedFrame]:
        """`<key> <value>` consumer-line entry point (the kme-torch-consume
        stream shape). Only OUT payloads are parsed."""
        key, _, rest = line.partition(" ")
        msg = parse_order(rest) if key == "OUT" else None
        return self.on_record(key, msg, epoch, src_seq)

    # -- snapshot state -------------------------------------------------

    def state(self) -> dict:
        """Restore-complete state: everything frame emission depends
        on, in sorted (insertion-order-free) form, so a restored
        deriver continues the byte-identical frame stream."""
        return {
            "group": self.group,
            "depth_every": self.depth_every,
            "depth_levels": self.depth_levels,
            "groups_seen": self.groups_seen,
            "fills": self._fills,
            "frames_out": self.frames_out,
            "watermark": list(self.watermark),
            "resting": [[oid] + list(self.resting[oid])
                        for oid in sorted(self.resting)],
            "seqs": [[sid, self._seqs[sid]]
                     for sid in sorted(self._seqs)],
            "tob": [[sid] + list(self._tob[sid])
                    for sid in sorted(self._tob)],
            "dirty": sorted(self._dirty_depth),
        }

    @classmethod
    def from_state(cls, st: dict) -> "FeedDeriver":
        d = cls(st["group"], st["depth_every"], st["depth_levels"])
        d.groups_seen = st["groups_seen"]
        d._fills = st["fills"]
        d.frames_out = st["frames_out"]
        d.watermark = tuple(st["watermark"])
        for oid, sid, side, price, size in st["resting"]:
            d.resting[oid] = (sid, side, price, size)
            lv = d.book.levels.setdefault((sid, side), {})
            lv[price] = lv.get(price, 0) + size
        for key in [k for k, lv in d.book.levels.items()
                    if not any(v != 0 for v in lv.values())]:
            del d.book.levels[key]
        for lv in d.book.levels.values():
            for price in [p for p, v in lv.items() if v == 0]:
                del lv[price]
        d._seqs = {sid: seq for sid, seq in st["seqs"]}
        d._tob = {row[0]: tuple(row[1:]) for row in st["tob"]}
        d._dirty_depth = set(st["dirty"])
        return d


class BookBuilder:
    """Subscriber-side reconstruction: applies feed frames, tracks
    per-symbol sequence continuity (gap/dup detection survives
    server-side symbol filtering because seq is per-symbol), and
    understands the three server-originated repair shapes — snapshot
    (SNAP_BEGIN / REFRESH depth images / SNAP_END with crc), resync
    after conflation (RESYNC + REFRESH image), and conflated
    top-of-book frames (advisory: never touch levels or seq
    accounting)."""

    def __init__(self) -> None:
        self.book = BookState()
        self.tob: Dict[int, Tuple[int, int, int, int]] = {}
        self.last_seq: Dict[int, int] = {}
        self.gaps: List[Tuple[int, int, int]] = []   # (sid, expected, got)
        self.dups = 0
        self.conflated_tobs = 0
        self.resyncs = 0
        self.snapshots = 0
        self.frames = 0
        self.watermark = (-1, -1)
        self.errors: List[str] = []
        self._snap_left = 0
        self._snap_payload = b""

    # -- helpers --------------------------------------------------------

    def _seq_ok(self, f: FeedFrame) -> bool:
        """Advance per-symbol seq accounting; False = duplicate (drop)."""
        last = self.last_seq.get(f.sid, 0)
        if f.seq <= last:
            self.dups += 1
            return False
        if f.seq != last + 1:
            self.gaps.append((f.sid, last + 1, f.seq))
        self.last_seq[f.sid] = f.seq
        return True

    def _apply_image(self, f: FeedFrame) -> None:
        """Replace a symbol's whole book with a REFRESH depth image."""
        for key in ((f.sid, SIDE_BUY), (f.sid, SIDE_SELL)):
            self.book.levels.pop(key, None)
        for price, size in f.bids:
            self.book.set_level(f.sid, SIDE_BUY, price, size)
        for price, size in f.asks:
            self.book.set_level(f.sid, SIDE_SELL, price, size)
        self.last_seq[f.sid] = f.seq
        self.tob[f.sid] = self.book.tob(f.sid)

    # -- frame application ----------------------------------------------

    def apply(self, f: FeedFrame) -> None:
        self.frames += 1
        k = f.kind
        if k == ff.FEED_SNAP_BEGIN:
            self.snapshots += 1
            self._snap_left = f.count
            self._snap_payload = b""
            return
        if k == ff.FEED_SNAP_END:
            if self._snap_left != 0:
                self.errors.append(
                    f"snapshot ended with {self._snap_left} image(s) "
                    f"missing")
            crc = zlib.crc32(self._snap_payload) & 0xFFFFFFFF
            if f.count and crc != f.crc:
                self.errors.append(
                    f"snapshot crc mismatch: got {crc:#x}, frame says "
                    f"{f.crc:#x}")
            self.watermark = (f.src_epoch, f.src_seq)
            self._snap_left = 0
            return
        if k == ff.FEED_RESYNC:
            self.resyncs += 1
            return
        if k == ff.FEED_DEPTH:
            if f.refresh:
                if self._snap_left > 0:
                    self._snap_left -= 1
                    self._snap_payload += f.raw
                self._apply_image(f)
            else:
                self._seq_ok(f)      # advisory: seq accounting only
            return
        if k == ff.FEED_TOB:
            if f.conflated:
                self.conflated_tobs += 1
                self.tob[f.sid] = (f.bid_price, f.bid_size,
                                   f.ask_price, f.ask_size)
                return
            if self._seq_ok(f):
                self.tob[f.sid] = (f.bid_price, f.bid_size,
                                   f.ask_price, f.ask_size)
            return
        if k == ff.FEED_DELTA:
            if self._seq_ok(f):
                self.book.set_level(f.sid, f.side, f.price, f.size)
            return

    def apply_buffer(self, buf) -> int:
        """Decode and apply a contiguous frame buffer; returns the
        number of bytes consumed (a trailing partial frame stays for
        the caller to re-buffer)."""
        off = 0
        n = len(buf)
        while True:
            length = ff.feed_frame_length(buf, off)
            if length is None or off + length > n:
                return off
            f, off = decode_feed(buf, off)
            self.apply(f)
