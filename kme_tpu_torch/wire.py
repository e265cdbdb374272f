"""Wire schema: the reference's JSON Order message, byte-compatible.

The JSON half of `kme_tpu/wire.py`, copied so the port imports nothing of
`kme_tpu`. The reference's serde is Jackson over a POJO with public
fields declared in the order action, oid, aid, sid, price, size, next,
prev (KProcessor.java:448-475), serialized compactly with fields in
declaration order and `next`/`prev` always present (null when unset —
quirk Q9). Incoming messages are parsed by field name; missing fields
default to 0 / null (Jackson primitive defaults).

`WireBatch` is the columnar batch of the native host path; the binary
order frames come with the service.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterator, Optional

import numpy as np

_FIELDS = ("action", "oid", "aid", "sid", "price", "size")

# Per-order reject reason codes (the value space of the opt-in REJ
# annotation records and of SeqSession.last_reasons).
REJ_NONE = 0
REJ_CAPACITY = 1
REJ_RISK = 2
REJ_CANCEL = 3
REJ_UNROUTABLE = 4
REJ_BARRIER = 5
REJ_MALFORMED = 6
REJ_OTHER = 7
REJ_UNSPECIFIED = 8
REJ_OVERLOAD = 9

REJ_NAMES = {
    REJ_NONE: "ok",
    REJ_CAPACITY: "rej_capacity",
    REJ_RISK: "rej_risk",
    REJ_CANCEL: "rej_cancel",
    REJ_UNROUTABLE: "rej_unroutable",
    REJ_BARRIER: "rej_barrier",
    REJ_MALFORMED: "rej_malformed",
    REJ_OTHER: "rej_other",
    REJ_UNSPECIFIED: "rej_unspecified",
    REJ_OVERLOAD: "rej_overload",
}


def reject_reason_codes(nmsg, msg_index, act, ok, cap_reject, host_rejects):
    """Vectorized per-message reason codes from one device batch's
    routing + results: host-resolved rejects are unroutable; a device
    not-ok is capacity when the cap flag fired, else classified by the
    internal lane act (1/2 trade -> risk, 3 cancel, 7/8/9 barrier,
    other device ops -> other). Returns a (nmsg,) uint8 array."""
    reasons = np.zeros(nmsg, np.uint8)
    if host_rejects:
        reasons[list(host_rejects)] = REJ_UNROUTABLE
    if len(msg_index):
        act = np.asarray(act)
        bad = ~np.asarray(ok, bool)
        by_act = np.where(
            (act == 1) | (act == 2), REJ_RISK,
            np.where(act == 3, REJ_CANCEL,
                     np.where((act >= 7) & (act <= 9), REJ_BARRIER,
                              REJ_OTHER)))
        r = np.where(np.asarray(cap_reject, bool), REJ_CAPACITY,
                     by_act).astype(np.uint8)
        mi = np.asarray(msg_index)
        reasons[mi[bad]] = r[bad]
    return reasons


@dataclasses.dataclass
class OrderMsg:
    """One wire message. Mirrors the reference Order POJO
    (KProcessor.java:448-475)."""

    action: int = 0
    oid: int = 0
    aid: int = 0
    sid: int = 0
    price: int = 0
    size: int = 0
    next: Optional[int] = None
    prev: Optional[int] = None

    def copy(self) -> "OrderMsg":
        return dataclasses.replace(self)


def parse_order(data: bytes | str) -> OrderMsg:
    """Parse an input JSON message the way Jackson does on the reference
    POJO: creator-bound value fields default to 0 when absent; the
    public `next`/`prev` fields are bound by name when present
    (null/absent -> None)."""
    obj = json.loads(data)
    if not isinstance(obj, dict):
        raise ValueError(f"order message must be a JSON object, got {type(obj)}")
    kw = {}
    for f in _FIELDS:
        v = obj.get(f, 0)
        if v is None:
            v = 0
        kw[f] = _as_int(f, v)
    msg = OrderMsg(**kw)
    for f in ("next", "prev"):
        v = obj.get(f)
        if v is not None:
            setattr(msg, f, _as_int(f, v))
    return msg


def _as_int(field: str, v) -> int:
    if not isinstance(v, int) or isinstance(v, bool):
        # Jackson would coerce or throw; we accept exact ints only
        # (floats with integral value are coerced like Jackson does).
        if isinstance(v, float) and v.is_integer():
            return int(v)
        raise ValueError(f"field {field!r} must be an integer, got {v!r}")
    return v


def order_json(action: int, oid, aid, sid, price, size,
               next: Optional[int] = None,
               prev: Optional[int] = None) -> str:
    """THE Jackson wire template (compact, declaration field order,
    next/prev always present — KProcessor.java:488). dumps_order and the
    session's reconstruction both go through it."""
    nxt = "null" if next is None else str(next)
    prv = "null" if prev is None else str(prev)
    return (
        f'{{"action":{action},"oid":{oid},"aid":{aid},"sid":{sid},'
        f'"price":{price},"size":{size},"next":{nxt},"prev":{prv}}}'
    )


def dumps_order(o: OrderMsg) -> str:
    """Serialize exactly like Jackson on the reference POJO."""
    return order_json(o.action, o.oid, o.aid, o.sid, o.price, o.size,
                      o.next, o.prev)


@dataclasses.dataclass(frozen=True)
class OutRecord:
    """One record on the output stream: key is "IN" (pre-processing echo,
    KProcessor.java:97) or "OUT" (result echo / fill event,
    KProcessor.java:124, 272-273)."""

    key: str
    value: OrderMsg

    def wire(self) -> str:
        """The `<key> <value>` line the reference consumer prints."""
        return f"{self.key} {dumps_order(self.value)}"


def wire_lines(records: Iterator[OutRecord]) -> Iterator[str]:
    for r in records:
        yield r.wire()


class WireBatch:
    """Columnar view of a message batch: the input format of the native
    host path (SeqSession.process_wire_buffer and submit consume it
    directly — router and reconstructor read the columns, so no
    per-message attribute walk runs on the hot path).

    Columns (numpy): action/oid/aid/sid/price/size/next/prev int64,
    hnext/hprev uint8 (1 = pointer present — Jackson binds next/prev from
    input too), plus tid int64 / htid uint8 for the additive trace word
    (zeros when no frame carried one). Values beyond int64 cannot be
    represented; builders raise OverflowError and callers stay on the
    OrderMsg-list path (which carries arbitrary ints)."""

    __slots__ = ("n", "action", "oid", "aid", "sid", "price", "size",
                 "next", "prev", "hnext", "hprev", "tid", "htid",
                 "_msgs")

    _COLS = ("action", "oid", "aid", "sid", "price", "size", "next",
             "prev")

    def __init__(self, n, cols, hnext, hprev, msgs=None, tid=None,
                 htid=None):
        self.n = n
        for f, v in zip(self._COLS, cols):
            setattr(self, f, v)
        self.hnext = hnext
        self.hprev = hprev
        if tid is None or htid is None:
            tid = np.zeros(n, np.int64)
            htid = np.zeros(n, np.uint8)
        self.tid = tid
        self.htid = htid
        self._msgs = msgs

    def record_tid(self, i: int) -> Optional[int]:
        """The trace word carried by row `i`, or None."""
        return int(self.tid[i]) if self.htid[i] else None

    def __len__(self) -> int:
        return self.n

    @classmethod
    def from_msgs(cls, msgs) -> "WireBatch":
        """OrderMsg sequence -> columns (ONE attribute walk; raises
        OverflowError on values beyond int64)."""
        n = len(msgs)
        cols = [np.fromiter((m.action for m in msgs), np.int64, n),
                np.fromiter((m.oid for m in msgs), np.int64, n),
                np.fromiter((m.aid for m in msgs), np.int64, n),
                np.fromiter((m.sid for m in msgs), np.int64, n),
                np.fromiter((m.price for m in msgs), np.int64, n),
                np.fromiter((m.size for m in msgs), np.int64, n),
                np.fromiter((0 if m.next is None else m.next
                             for m in msgs), np.int64, n),
                np.fromiter((0 if m.prev is None else m.prev
                             for m in msgs), np.int64, n)]
        hnext = np.fromiter((m.next is not None for m in msgs), np.uint8, n)
        hprev = np.fromiter((m.prev is not None for m in msgs), np.uint8, n)
        return cls(n, cols, hnext, hprev,
                   msgs if isinstance(msgs, list) else list(msgs))

    @classmethod
    def parse_buffer(cls, buf: bytes) -> "WireBatch":
        """Newline-separated order JSON -> columns, via the native parser
        (kme_wire.cpp kme_parse_*); a buffer with any line outside its
        integer/null subset is parsed whole through parse_order, so
        coercions and errors are exactly the Python authority's. Under
        KME_NATIVE=0 every buffer takes parse_order."""
        from kme_tpu_torch.native import load_library

        if not buf:
            # empty payload = zero messages (the native column pointers
            # are unallocated at n == 0)
            return cls._empty()
        lib = load_library()
        if lib is not None:
            h = lib.kme_parse_new()
            try:
                rc = lib.kme_parse_lines(h, buf, len(buf))
                if rc >= 0:
                    n = int(rc)
                    cols = [np.ctypeslib.as_array(
                        lib.kme_parse_col(h, i), (max(n, 1),))[:n].copy()
                        for i in range(8)]
                    hnext = np.ctypeslib.as_array(
                        lib.kme_parse_hnext(h), (max(n, 1),))[:n].copy()
                    hprev = np.ctypeslib.as_array(
                        lib.kme_parse_hprev(h), (max(n, 1),))[:n].copy()
                    return cls(n, cols, hnext, hprev)
            finally:
                lib.kme_parse_free(h)
        msgs = [parse_order(ln) for ln in buf.split(b"\n") if ln]
        return cls.from_msgs(msgs)

    @classmethod
    def _empty(cls) -> "WireBatch":
        return cls(0, [np.zeros(0, np.int64) for _ in range(8)],
                   np.zeros(0, np.uint8), np.zeros(0, np.uint8), [])

    def msgs(self) -> list:
        """Materialize the OrderMsg view (lazily, for the Python paths;
        the native path never calls this)."""
        if self._msgs is None:
            act, oid, aid = self.action, self.oid, self.aid
            sid, pr, sz = self.sid, self.price, self.size
            nx, pv = self.next, self.prev
            hn, hp = self.hnext, self.hprev
            self._msgs = [
                OrderMsg(int(act[i]), int(oid[i]), int(aid[i]),
                         int(sid[i]), int(pr[i]), int(sz[i]),
                         int(nx[i]) if hn[i] else None,
                         int(pv[i]) if hp[i] else None)
                for i in range(self.n)]
        return self._msgs
