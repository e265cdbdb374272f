"""Wire schema: the reference's JSON Order message, byte-compatible.

The JSON half of `kme_tpu/wire.py`, copied so the port imports nothing of
`kme_tpu`. The reference's serde is Jackson over a POJO with public
fields declared in the order action, oid, aid, sid, price, size, next,
prev (KProcessor.java:448-475), serialized compactly with fields in
declaration order and `next`/`prev` always present (null when unset —
quirk Q9). Incoming messages are parsed by field name; missing fields
default to 0 / null (Jackson primitive defaults).

The binary order frames and `WireBatch` belong to the serving slice.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterator, Optional

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
    import numpy as np

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
