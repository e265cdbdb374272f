"""The least bytes a window's messages need from device memory, counted
from the messages and the reference's MatchOut records, at widths fixed
here: the same count whatever program serves them.

Each message is read once. Each distinct book entry, balance and
position the messages touch is read once and written once; an order
that comes to rest inside the window is only written. Each OUT record
(a fill or a result echo, what the engine itself emits) is written once.
IN echoes repeat the input and are not counted. Touches are read off the
records: a BUY or SELL reads its account's balance for the margin check
and rests if its echo is accepted with size left; each fill touches the
filled account's position in the symbol and its balance, and the maker's
book entry; an accepted CANCEL touches the order and its account's
balance; an accepted CREATE_BALANCE or TRANSFER touches the balance.
What PAYOUT and ADD_SYMBOL touch is left out, so the count stays a lower
bound. H100 SXM peak bandwidth: 3.35 TB/s (NVIDIA data sheet).
"""

from __future__ import annotations

import json
from typing import List

import numpy as np

from kmebench.reference import opcodes as op

PEAK_BYTES_PER_S = 3.35e12
MSG_BYTES = 28       # oid int64 + action, aid, sid, price, size int32
ENTRY_BYTES = 24     # oid int64 + aid, price, size, link int32
BALANCE_BYTES = 8    # int64
POSITION_BYTES = 16  # amount, available int64
OUT_BYTES = 28       # one output record, the width of a message


def least_bytes(cols: dict, recs: List[bytes], counts: np.ndarray,
                lo: int, hi: int) -> int:
    """Bytes for messages [lo, hi) of a stream whose reference records
    are `recs`, `counts[i]` of them for message i."""
    starts = np.concatenate([[0], np.cumsum(counts)])
    act = cols["action"]
    oid = cols["oid"]
    aid = cols["aid"]
    balances, positions, entries, created = set(), set(), set(), set()
    nout = 0
    for i in range(lo, hi):
        s, e = int(starts[i]), int(starts[i + 1])
        if e - s < 2:
            continue
        outs = [json.loads(r[4:]) for r in recs[s + 1:e]]
        nout += len(outs)
        echo = outs[-1]
        ok = echo["action"] != op.REJECT
        a = int(act[i])
        if a in (op.BUY, op.SELL):
            balances.add(int(aid[i]))
            if ok and echo["size"] > 0:
                created.add(int(oid[i]))
                entries.add(int(oid[i]))
            for k in range(0, len(outs) - 1, 2):
                maker, taker = outs[k], outs[k + 1]
                entries.add(maker["oid"])
                for f in (maker, taker):
                    positions.add((f["aid"], f["sid"]))
                    balances.add(f["aid"])
        elif a == op.CANCEL and ok:
            entries.add(int(oid[i]))
            balances.add(int(aid[i]))
        elif a in (op.CREATE_BALANCE, op.TRANSFER) and ok:
            balances.add(int(aid[i]))
    old = len(entries - created)
    return ((hi - lo) * MSG_BYTES + nout * OUT_BYTES
            + 2 * BALANCE_BYTES * len(balances)
            + 2 * POSITION_BYTES * len(positions)
            + ENTRY_BYTES * (2 * old + len(created)))
