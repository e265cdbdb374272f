"""The message record and the MatchOut line encoder of the Python
reference: a frozen copy of `OrderMsg`, `OutRecord` and the Jackson
template of `kme_tpu_torch/wire.py`."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class OrderMsg:
    """One wire message (the reference's Order POJO,
    KProcessor.java:448-475)."""

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


def dumps_order(o: OrderMsg) -> str:
    """Jackson's serialisation of the POJO: compact, in declaration
    order, next/prev always present (KProcessor.java:488)."""
    nxt = "null" if o.next is None else str(o.next)
    prv = "null" if o.prev is None else str(o.prev)
    return (f'{{"action":{o.action},"oid":{o.oid},"aid":{o.aid},'
            f'"sid":{o.sid},"price":{o.price},"size":{o.size},'
            f'"next":{nxt},"prev":{prv}}}')


@dataclasses.dataclass(frozen=True)
class OutRecord:
    """One MatchOut record: key "IN" (the pre-processing echo) or "OUT"
    (a fill or the result echo)."""

    key: str
    value: OrderMsg

    def wire(self) -> str:
        """The `<key> <value>` line the reference consumer prints."""
        return f"{self.key} {dumps_order(self.value)}"
