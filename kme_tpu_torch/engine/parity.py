"""Serial replica of the reference matching engine — the port of
`kme_tpu/engine/parity.py`.

The whole of `KProcessor.MatchingEngine` (KProcessor.java:63-445),
message by message in arrival order (the reference's single-StreamThread
semantics), with every store replaced by a dense associative table on
the device (ops/tables.py) and every bitmap and bucket codec by the
java-exact integer ops (ops/bits.py).

Semantics contract: for any message stream whose price and size fields
fit in int32 and ids in int64 (the Jackson envelope), the records equal
`kme_tpu_torch.oracle.OracleEngine`'s, in both compat modes, quirks
Q1..Q11 included. Where the reference dies (NPE crashes, the Q4 infinite
loop) the replica sets a sticky error code at that message instead of
raising; the host wrapper truncates there and raises DeviceParityError,
as the oracle raises ReferenceCrash / ReferenceHang. Capacity is the one
new degree of freedom: tables are fixed-size and a message emits at most
`max_events` fills; running out is an error code of its own.

ROLE: this engine is not a serving path (java mode serves on the seq
kernel). Its job is cross-evidence: a third implementation of the
quirk-exact semantics, structurally independent of the oracle and of the
seq kernel, so that a bug in the seq kernel's java mode and a matching
bug in the oracle cannot hide each other.

How the JAX package's one `lax.scan` becomes torch:

- Predication instead of selection. The JAX package computes each
  alternative path on a copy of the whole store pytree and selects one
  with `jnp.where` (`_sel`), about 30 full-table copies per message.
  Here the tables are updated in place, and every mutator takes an
  enable mask `en`: it writes, and its error guard fires, only where
  `en` holds and the sticky error is still 0. The alternatives of one
  choice get exclusive enables, so the enabled one reads the state its
  own path left and the others write nothing; that is the same state the
  selection gives. Once the error is set every later write is
  suppressed, which keeps the writes made earlier in the failing message
  and freezes every later message, as the scan's sticky error does.
- Dispatch on the host. The op code, the taker's side and fixed mode's
  price/size validity come from the message, which the host holds, so
  the host chooses the message's work and no device value is read for
  it.
- Loops. `tryMatch` and the fixed-mode book wipe are `lax.while_loop`s
  whose condition reads device state; here each test of the condition is
  one read of two device scalars (a sync on the card), counted in
  `ParityEngine.syncs`. The wipe's iteration budget (`max_iters`) is a
  host count.
- Segments and graphs. A message is cut at those reads into segments of
  straight-line device work (`_seg_*`), each a function of the stores,
  the message's carry and the host's choices. One segment with one set
  of choices always runs the same ops, so on the card each is captured
  into a CUDA graph after its first run and replayed from then on
  (`_Segments`): a message costs a few launches instead of one per op.
  On the CPU the same functions run eagerly.
- Rows. Each store is one int64 table of rows (key and value columns)
  beside its bool `used` column, so a put is one row write instead of
  one write per field; `state_to_numpy` / `state_from_numpy` convert to
  and from the JAX package's state (one array per field).
- Output. Each message's results go to a (7, batch) device table and
  its fills to a (batch, max_events, 6) grid; at the end of a batch the
  used fill rows are packed on the device (the JAX package's event
  compaction) and two plain copies bring the results and the packed
  rows to the host. The JAX package's pipelined fetch (a window of
  eight batches in flight, `async_prefetch`) has no counterpart: one
  batch at a time.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from kme_tpu_torch import opcodes as op
from kme_tpu_torch.engine.lanes import resolve_device
from kme_tpu_torch.oracle import javalong as jl
from kme_tpu_torch.ops import bits, tables
from kme_tpu_torch.wire import OrderMsg, OutRecord

_I64 = torch.int64
_I32 = torch.int32

# Error codes (sticky; 0 = ok)
ERR_OK = 0
ERR_HANG = 1          # Q4 removeAllOrders infinite loop (ReferenceHang)
ERR_CRASH = 2         # reference NPE / death (ReferenceCrash / KeyError)
ERR_TABLE_FULL = 3    # store capacity exhausted (device-only envelope)
ERR_EVENTS_FULL = 4   # fill buffer exhausted (device-only envelope)

_ERR_NAMES = {
    ERR_HANG: "reference-hang (Q4 removeAllOrders loop)",
    ERR_CRASH: "reference-crash (NPE path)",
    ERR_TABLE_FULL: "device store capacity exhausted",
    ERR_EVENTS_FULL: "device fill-event buffer exhausted",
}


class DeviceParityError(RuntimeError):
    """Raised by the host wrapper when the replica flags an error.

    `index` is the position (within the process_batch call) of the
    message on which the reference would have died or the device ran out
    of capacity; `records` holds the records of every earlier message."""

    def __init__(self, code: int, index: int,
                 records: Optional[List[List["OutRecord"]]] = None) -> None:
        self.code = int(code)
        self.index = int(index)
        self.records = records or []
        super().__init__(
            f"device engine error at message {index}: "
            f"{_ERR_NAMES.get(self.code, self.code)}")


@dataclasses.dataclass(frozen=True)
class ParityCaps:
    """Table capacities."""

    balances: int = 64        # AB — accounts
    positions: int = 4096     # PB — (aid,sid) pairs incl. Q11 garbage keys
    books: int = 64           # BB — 2 per symbol
    buckets: int = 1024       # KB — occupied price levels
    orders: int = 8192        # OB — resting orders
    max_events: int = 64      # E — fill events per message (2/trade)
    batch: int = 256          # T — messages per fetch


# ---------------------------------------------------------------------------
# state: one int64 row table per store beside its used column

# column of each field in its table, in the JAX package's field names
BAL_COLS = ("bal_key", "bal_val")
POS_COLS = ("pos_ka", "pos_ks", "pos_amt", "pos_avail")
BOOK_COLS = ("book_key", "book_msb", "book_lsb")
BKT_COLS = ("bkt_key", "bkt_first", "bkt_last")
ORD_COLS = ("ord_oid", "ord_action", "ord_aid", "ord_sid", "ord_price",
            "ord_size", "ord_next", "ord_next_has", "ord_prev",
            "ord_prev_has")
O_OID, O_ACT, O_AID, O_SID, O_PRICE, O_SIZE, O_NEXT, O_NEXT_HAS, O_PREV, \
    O_PREV_HAS = range(len(ORD_COLS))
_TABLES = (("bal", BAL_COLS, "balances"), ("pos", POS_COLS, "positions"),
           ("book", BOOK_COLS, "books"), ("bkt", BKT_COLS, "buckets"),
           ("ord", ORD_COLS, "orders"))
# the JAX package's int32 and bool fields (all others are int64)
_I32_FIELDS = ("ord_action", "ord_price", "ord_size")
_BOOL_FIELDS = ("ord_next_has", "ord_prev_has")


def make_state(caps: ParityCaps, device="cuda") -> Dict[str, torch.Tensor]:
    """Fresh empty stores (the reference's five empty stores) on
    `device`."""
    dev = resolve_device(device)
    st = {}
    for name, cols, cap in _TABLES:
        n = getattr(caps, cap)
        st[name] = torch.zeros((n, len(cols)), dtype=_I64, device=dev)
        st[name + "_used"] = torch.zeros((n,), dtype=torch.bool, device=dev)
    # sticky error, carried across batches so messages after a death stay
    # frozen whatever batch they come in
    st["err"] = torch.zeros((), dtype=_I32, device=dev)
    return st


def state_to_numpy(st: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The state as the JAX package's `make_state` pytree: one numpy
    array per field, its names and dtypes."""
    out = {}
    for name, cols, _ in _TABLES:
        tab = st[name].cpu().numpy()
        for j, col in enumerate(cols):
            v = tab[:, j]
            if col in _I32_FIELDS:
                v = v.astype(np.int32)
            elif col in _BOOL_FIELDS:
                v = v != 0
            out[col] = np.ascontiguousarray(v)
        out[name + "_used"] = st[name + "_used"].cpu().numpy().copy()
    out["err"] = np.asarray(int(st["err"]), dtype=np.int32)
    return out


def state_from_numpy(caps: ParityCaps, arrays, device="cuda"
                     ) -> Dict[str, torch.Tensor]:
    """A state of the JAX package (its pytree as numpy arrays, or one
    from state_to_numpy) as the port's tensors on `device`."""
    dev = resolve_device(device)
    st = {}
    for name, cols, cap in _TABLES:
        n = getattr(caps, cap)
        tab = np.stack([np.asarray(arrays[c]).astype(np.int64)
                        for c in cols], axis=1)
        used = np.asarray(arrays[name + "_used"]).astype(bool)
        if tab.shape != (n, len(cols)) or used.shape != (n,):
            raise ValueError(f"{name}: shape {tab.shape} does not fit "
                             f"{cap}={n}")
        st[name] = torch.from_numpy(tab).to(dev)
        st[name + "_used"] = torch.from_numpy(used.copy()).to(dev)
    st["err"] = torch.tensor(int(np.asarray(arrays["err"])), dtype=_I32,
                             device=dev)
    return st


# ---------------------------------------------------------------------------
# small store helpers. Every mutator takes the sticky error and an enable
# mask and returns the new error; it writes only where `en` holds and the
# error is 0.

@functools.lru_cache(maxsize=None)
def _onehot(device: torch.device):
    """column -> (10,) bool mask of that order column on `device`."""
    eye = torch.eye(len(ORD_COLS), dtype=torch.bool, device=device)
    return [eye[j] for j in range(len(ORD_COLS))]


def _guard(err, en, cond, code):
    return torch.where((err == ERR_OK) & en & cond, code, err)


def _at(t, idx):
    """t[idx] for a 0-d index tensor, read on the device."""
    return t.index_select(0, idx.reshape(1))[0]


def _write(t, idx, val, do):
    """t[idx] = val where `do`, in place (val: a row of t, or a scalar
    of a 1-D t)."""
    i = idx.reshape(1)
    t.index_put_((i,), torch.where(do, val, t.index_select(0, i)))


def _put(st, err, en, name, idx, ok, row):
    """Write `row` at the slot `idx` that a put chose (`ok`: a slot was
    there); a full table sets ERR_TABLE_FULL."""
    err = _guard(err, en, ~ok, ERR_TABLE_FULL)
    do = en & (err == ERR_OK)
    _write(st[name], idx, row, do)
    _write(st[name + "_used"], idx, do, do)
    return err


def _delete(st, err, en, name, idx, found):
    tables.delete_at(st[name + "_used"], idx, found & en & (err == ERR_OK))


def _find(st, name, key):
    return tables.find(st[name][:, 0], st[name + "_used"], key)


def _put_idx(st, name, key):
    return tables.put_idx(st[name][:, 0], st[name + "_used"], key)


def _bal_get(st, aid):
    idx, found = _find(st, "bal", aid)
    return _at(st["bal"], idx)[1], found


def _bal_put(st, err, en, aid, val):
    idx, ok = _put_idx(st, "bal", aid)
    return _put(st, err, en, "bal", idx, ok, torch.stack((aid, val)))


def _pos_find(st, ka, ks):
    p = st["pos"]
    return tables.find2(p[:, 0], p[:, 1], st["pos_used"], ka, ks)


def _pos_get(st, ka, ks):
    idx, found = _pos_find(st, ka, ks)
    row = _at(st["pos"], idx)
    return row[2], row[3], found


def _pos_put(st, err, en, ka, ks, amt, avail):
    p = st["pos"]
    idx, ok = tables.put2_idx(p[:, 0], p[:, 1], st["pos_used"], ka, ks)
    return _put(st, err, en, "pos", idx, ok,
                torch.stack((ka, ks, amt, avail)))


def _pos_del(st, err, en, ka, ks):
    """positions.delete(key): no-op when absent (RocksDB delete semantics,
    KProcessor.java:283 — the oracle's dict .pop(key, None))."""
    idx, found = _pos_find(st, ka, ks)
    _delete(st, err, en, "pos", idx, found)


def _book_get(st, key):
    idx, found = _find(st, "book", key)
    row = _at(st["book"], idx)
    return row[1], row[2], found


def _book_put(st, err, en, key, msb, lsb):
    idx, ok = _put_idx(st, "book", key)
    return _put(st, err, en, "book", idx, ok, torch.stack((key, msb, lsb)))


def _book_del(st, err, en, key):
    idx, found = _find(st, "book", key)
    _delete(st, err, en, "book", idx, found)


def _bkt_get(st, key):
    idx, found = _find(st, "bkt", key)
    row = _at(st["bkt"], idx)
    return row[1], row[2], found


def _bkt_put(st, err, en, key, first, last):
    idx, ok = _put_idx(st, "bkt", key)
    return _put(st, err, en, "bkt", idx, ok, torch.stack((key, first, last)))


def _bkt_del(st, err, en, key):
    idx, found = _find(st, "bkt", key)
    _delete(st, err, en, "bkt", idx, found)


def _ord_get(st, oid):
    """-> (order row, found). The row is gathered at the hit slot (slot
    0's when not found — callers gate on `found`)."""
    idx, found = _find(st, "ord", oid)
    return _at(st["ord"], idx), found


def _ord_put(st, err, en, row):
    idx, ok = _put_idx(st, "ord", row[O_OID])
    return _put(st, err, en, "ord", idx, ok, row)


def _ord_del(st, err, en, oid):
    idx, found = _find(st, "ord", oid)
    _delete(st, err, en, "ord", idx, found)


def _with(row, cols):
    """A copy of an order row with the columns in `cols` (column ->
    value) replaced."""
    hot = _onehot(row.device)
    for j, v in cols.items():
        row = torch.where(hot[j], v, row)
    return row


# ---------------------------------------------------------------------------
# key codecs (oracle._order_book_key / _bucket_key)

def _order_book_key(sid, is_buy, java: bool):
    """Java: sid * (+1|-1) with long wrap (Q1: -0 == 0 merges sid=0's
    sides, KProcessor.java:201/227/292). Fixed: 2*sid + side. `is_buy`
    is a host bool (the taker's side) or a device bool (a stored
    order's)."""
    if isinstance(is_buy, bool):
        if java:
            return sid if is_buy else -sid
        return 2 * sid + (0 if is_buy else 1)
    if java:
        return torch.where(is_buy, sid, -sid)
    return 2 * sid + torch.where(is_buy, 0, 1)


# ---------------------------------------------------------------------------
# handlers — pieces of a message's work on (st, err, ...). `msg` holds the
# message's fields as 0-d device tensors (_msg); an echo is the (size,
# prev, prev_has) the OUT echo carries; `p` holds the host's choices
# (_Path), `k` the device's constants.

def _echo_of(msg):
    return msg["size"], msg["prev"], msg["prev_has"]


def _h_create_balance(st, err, msg, k, p):
    """createBalance (KProcessor.java:131-138): idempotent create at 0."""
    _, found = _bal_get(st, msg["aid"])
    err = _bal_put(st, err, ~found, msg["aid"], k.zero64)
    return err, ~found, _echo_of(msg)


def _h_transfer(st, err, msg, k, p):
    """transfer (KProcessor.java:140-146): balance += size, withdrawal
    guarded by `balance < -size`."""
    bal, found = _bal_get(st, msg["aid"])
    size = msg["size"].to(_I64)
    # `-order.size` is Java int negation: wraps at int32 before promotion
    neg_size = (-msg["size"]).to(_I64)
    ok = found & ~(bal < neg_size)
    err = _bal_put(st, err, ok, msg["aid"], bal + size)
    return err, ok, _echo_of(msg)


def _h_add_symbol(st, err, msg, k, p):
    """addSymbol (KProcessor.java:184-191): empty books at ±sid (java) or
    2*sid+side (fixed; sid < 0 rejected)."""
    sid = msg["sid"]
    if p.java:
        k1, k2 = sid, -sid
        _, _, exists = _book_get(st, k1)
        ok = ~exists
    else:
        k1, k2 = 2 * sid, 2 * sid + 1
        _, _, exists = _book_get(st, k1)
        ok = (sid >= 0) & ~exists
    err = _book_put(st, err, ok, k1, k.zero64, k.zero64)
    err = _book_put(st, err, ok, k2, k.zero64, k.zero64)
    return err, ok, _echo_of(msg)


def _h_reject(st, err, msg, k, p):
    """An unknown op code, or a fixed-mode order outside the price/size
    domain: REJECT, reading and writing nothing."""
    return err, k.false, _echo_of(msg)


def _check_balance(st, err, en, aid, sid, price, is_buy, size_in):
    """checkBalance (KProcessor.java:167-182): margin reserve with netting
    against the opposite 'available' position -> (err, ok)."""
    bal, found = _bal_get(st, aid)
    size32 = size_in if is_buy else -size_in
    size = size32.to(_I64)
    # `-size` is Java int negation: wraps at int32 before promotion
    neg_size = (-size32).to(_I64)
    amt, avail, pos_found = _pos_get(st, aid, sid)
    avail = torch.where(pos_found, avail, 0)
    if is_buy:
        adj = torch.maximum(avail.clamp(max=0), neg_size)
        unit = price.to(_I64)
    else:
        adj = torch.minimum(avail.clamp(min=0), neg_size)
        unit = (price - 100).to(_I64)
    risk = (size + adj) * unit
    ok = found & ~(bal < risk)
    en_ok = en & ok
    err = _bal_put(st, err, en_ok, aid, bal - risk)
    adj_write = en_ok & (adj != 0)
    # adj != 0 with no position (negative size): getPositionAmount(null)
    # NPE (KProcessor.java:179-180) — after the balance debit persisted
    err = _guard(err, adj_write, ~pos_found, ERR_CRASH)
    # adj-write uses the REAL key (3-arg setPosition, KProcessor.java:179)
    err = _pos_put(st, err, adj_write, aid, sid, amt, avail - adj)
    return err, ok


def _post_remove_adjustments(st, err, en, rec, java):
    """postRemoveAdjustments (KProcessor.java:325-333): margin release;
    Q11 in java mode — the adj-write keys by the position VALUE."""
    is_buy = rec[O_ACT] == op.BUY
    osize = rec[O_SIZE].to(_I32)
    size32 = torch.where(is_buy, osize, -osize)
    size = size32.to(_I64)
    neg_size = (-size32).to(_I64)  # Java int negation (wraps at int32)
    aid, sid = rec[O_AID], rec[O_SID]
    amt, avail, pos_found = _pos_get(st, aid, sid)
    blocked = torch.where(pos_found, amt - avail, 0)
    adj = torch.where(is_buy,
                      torch.maximum(blocked.clamp(max=0), neg_size),
                      torch.minimum(blocked.clamp(min=0), neg_size))
    bal, found = _bal_get(st, aid)
    err = _guard(err, en, ~found, ERR_CRASH)  # NPE: release with no balance
    price = rec[O_PRICE].to(_I32)
    unit = torch.where(is_buy, price, price - 100).to(_I64)
    err = _bal_put(st, err, en, aid, bal + (size + adj) * unit)
    adj_write = en & (adj != 0)
    # adj != 0 with no position (negative-size rec): the JVM NPEs at
    # getPositionAmount(null) (KProcessor.java:332) after the credit above
    err = _guard(err, adj_write, ~pos_found, ERR_CRASH)
    tka, tks = (amt, avail) if java else (aid, sid)   # Q11 target
    return _pos_put(st, err, adj_write, tka, tks, amt, avail + adj)


def _fill_order(st, err, en, c, action, oid, aid, sid, price, size, java,
                max_events):
    """fillOrder (KProcessor.java:276-287) + the event forward
    (KProcessor.java:272-273) into the message's fill rows c["ev"] (count
    c["n"]). Q11 in java mode: update/delete of an existing position keys
    by the VALUE pair."""
    n = c["n"]
    err = _guard(err, en, n >= max_events, ERR_EVENTS_FULL)
    row = torch.stack((action.to(_I64), oid, aid, sid, price.to(_I64),
                       size.to(_I64)))
    do = en & (err == ERR_OK)
    _write(c["ev"], n.clamp(0, max_events - 1), row, do)
    c["n"] = torch.where(do, n + 1, n)

    signed32 = torch.where(action == op.BOUGHT, size, -size)
    signed = signed32.to(_I64)
    amt, avail, found = _pos_get(st, aid, sid)
    # create path
    err = _pos_put(st, err, en & ~found, aid, sid, signed, signed)
    # update/delete path (java: garbage target = old value pair)
    new_amt = amt + signed
    tka, tks = (amt, avail) if java else (aid, sid)
    old = en & found
    gone = new_amt == 0
    _pos_del(st, err, old & gone, tka, tks)
    err = _pos_put(st, err, old & ~gone, tka, tks, new_amt, avail + signed)

    bal, bfound = _bal_get(st, aid)
    err = _guard(err, en, ~bfound, ERR_CRASH)  # NPE: fill with no balance
    # `size * order.price` is int*int — int32 wrap before the long add
    # (KProcessor.java:286)
    credit = (signed32 * price).to(_I64)
    return _bal_put(st, err, en, aid, bal + credit)


def _execute_trade(st, err, en, c, taker, maker, trade_size, taker_is_buy,
                   java, max_events, k):
    """executeTrade (KProcessor.java:265-274): maker fill at price 0 first,
    taker fill at the price improvement second."""
    maker_action = k.sold if taker_is_buy else k.bought
    taker_action = k.bought if taker_is_buy else k.sold
    improvement = taker["price"] - maker[O_PRICE].to(_I32)
    err = _fill_order(st, err, en, c, maker_action, maker[O_OID],
                      maker[O_AID], maker[O_SID], k.zero32, trade_size,
                      java, max_events)
    return _fill_order(st, err, en, c, taker_action, taker["oid"],
                       taker["aid"], taker["sid"], improvement, trade_size,
                       java, max_events)


def _h_cancel(st, err, msg, k, p):
    """removeOrder (KProcessor.java:289-323): ownership check, 4-case
    doubly-linked unlink, margin release."""
    java = p.java
    rec, found = _ord_get(st, msg["oid"])
    ok = found & (rec[O_AID] == msg["aid"])

    is_buy = rec[O_ACT] == op.BUY
    bkey = _order_book_key(rec[O_SID], is_buy, java)
    price = rec[O_PRICE].to(_I32)
    msb, lsb, book_found = _book_get(st, bkey)
    bkt_key = bits.bucket_key(bkey, price)
    bfirst, blast, bkt_found = _bkt_get(st, bkt_key)
    has_prev, has_next = rec[O_PREV_HAS] != 0, rec[O_NEXT_HAS] != 0
    nxt, nxt_found = _ord_get(st, rec[O_NEXT])
    prv, prv_found = _ord_get(st, rec[O_PREV])

    # case only: delete bucket, clear bit (NPE if book missing)
    only = ok & ~has_prev & ~has_next
    err = _guard(err, only, ~book_found, ERR_CRASH)
    _bkt_del(st, err, only, bkt_key)
    umsb, ulsb = bits.book_with_bit_unset(msb, lsb, price)
    err = _book_put(st, err, only, bkey, umsb, ulsb)

    # case head: bucket first = next; next.prev = null (NPE if bucket/next
    # missing)
    head = ok & ~has_prev & has_next
    err = _guard(err, head, ~bkt_found, ERR_CRASH)
    err = _bkt_put(st, err, head, bkt_key, rec[O_NEXT], blast)
    err = _guard(err, head, ~nxt_found, ERR_CRASH)
    err = _ord_put(st, err, head, _with(nxt, {O_PREV: k.zero64,
                                               O_PREV_HAS: k.zero64}))

    # case tail: bucket last = prev; prev.next = null
    tail = ok & has_prev & ~has_next
    err = _guard(err, tail, ~bkt_found, ERR_CRASH)
    err = _bkt_put(st, err, tail, bkt_key, bfirst, rec[O_PREV])
    err = _guard(err, tail, ~prv_found, ERR_CRASH)
    err = _ord_put(st, err, tail, _with(prv, {O_NEXT: k.zero64,
                                               O_NEXT_HAS: k.zero64}))

    # case middle: prev.next = next; next.prev = prev
    mid = ok & has_prev & has_next
    err = _guard(err, mid, ~prv_found | ~nxt_found, ERR_CRASH)
    err = _ord_put(st, err, mid, _with(prv, {O_NEXT: rec[O_NEXT],
                                              O_NEXT_HAS: k.one64}))
    err = _ord_put(st, err, mid, _with(nxt, {O_PREV: rec[O_PREV],
                                              O_PREV_HAS: k.one64}))

    _ord_del(st, err, ok, msg["oid"])
    err = _post_remove_adjustments(st, err, ok, rec, java)
    return err, ok, _echo_of(msg)


def _remove_all_orders_java(st, err, en, book_key):
    """removeAllOrders java semantics (KProcessor.java:335-357, Q4): any
    non-empty book loops forever -> ERR_HANG. Returns (err, exists). A
    book is non-empty exactly where its min-price scan is not -1: where
    either half of its bitmap is non-zero."""
    msb, lsb, found = _book_get(st, book_key)
    nonempty = (msb != 0) | (lsb != 0)
    return _guard(err, en, found & nonempty, ERR_HANG), found


def _h_remove_symbol_java(st, err, msg, k, p):
    """removeSymbol in java mode (KProcessor.java:193-198): Q3 inverted
    return + Q4 hang; the short-circuit `or` replicated."""
    sid = msg["sid"]
    err, exists1 = _remove_all_orders_java(st, err, k.true, sid)
    # short-circuit: -sid side only evaluated when +sid side absent
    # (KProcessor.java:194 `if (a || b)`) — its hang can't fire then
    err, exists2 = _remove_all_orders_java(st, err, ~exists1, -sid)
    ok = ~exists1 & ~exists2
    _book_del(st, err, ok, sid)
    _book_del(st, err, ok, -sid)
    return err, ok, _echo_of(msg)


def _payout_credit(st, err, msg, removed, k, p):
    """payout (KProcessor.java:148-165) after its removeSymbol: credit
    `amount * order.size` per matching position and delete it (over the
    whole positions table — order-insensitive since mod-2^64 adds
    commute). Java: Q3 makes this reachable only for missing books; Q5/Q6
    the result is discarded by the dispatcher. Fixed: sid>=0 YES credits
    longs, sid<0 NO deletes uncredited."""
    sid = msg["sid"]
    match_sid = sid if p.java else torch.abs(sid)
    pos, bal = st["pos"], st["bal"]
    pmask = st["pos_used"] & (pos[:, 1] == match_sid)
    # per-balance-slot credit: sum over matching positions owned by that key
    hit = (pmask[:, None] & (pos[:, 0][:, None] == bal[:, 0][None, :])
           & st["bal_used"][None, :])
    credit_amt = torch.where(hit, pos[:, 2][:, None] * msg["size"].to(_I64),
                             0).sum(0)
    orphan = pmask & ~hit.any(1)  # NPE: position w/o balance
    do = removed & (err == ERR_OK)
    if p.credit:
        err = _guard(err, do, orphan.any(), ERR_CRASH)
        apply = do & (err == ERR_OK)
        bal[:, 1] = torch.where(apply, bal[:, 1] + credit_amt, bal[:, 1])
    st["pos_used"] &= ~(pmask & do & (err == ERR_OK))
    # Q5/Q6: java discards payout's result (KProcessor.java:113-115)
    return err, (k.false if p.java else removed), _echo_of(msg)


def _h_payout_java(st, err, msg, k, p):
    err, removed, _ = _h_remove_symbol_java(st, err, msg, k, p)
    return _payout_credit(st, err, msg, removed, k, p)


# ---------------------------------------------------------------------------
# messages as segments. A message is one or more segments: straight-line
# device work between two reads of the card. A segment is a function
# (st, c, p): `st` the stores, `c` the message's carry (name -> tensor:
# "m" its fields as an int64 row, "err" the sticky error, "ev"/"n" its
# fill rows and their count, "flag" the (err, done) pair a loop test
# reads), `p` the host's choices (_Path). One (segment, path) always runs
# the same ops, so on the card each is captured into a CUDA graph at its
# first run and replayed after (_Segments).

@dataclasses.dataclass(frozen=True)
class _Path:
    java: bool
    max_events: int
    max_iters: int
    is_buy: bool = False      # the taker's side
    credit: bool = False      # PAYOUT credits (java, or sid >= 0)
    payout: bool = False      # a fixed PAYOUT (its REMOVE_SYMBOL first)
    handler: object = None    # the one-segment message's handler


def _msg(c):
    """The message's fields as 0-d device tensors, from its int64 row."""
    m = c["m"]
    return {"action": m[0].to(_I32), "oid": m[1], "aid": m[2], "sid": m[3],
            "price": m[4].to(_I32), "size": m[5].to(_I32), "next": m[6],
            "next_has": m[7] != 0, "prev": m[8], "prev_has": m[9] != 0}


def _start(c, k):
    """What every message's first segment does first: keep the error the
    message starts with, and clear its fills."""
    c["err0"] = c["err"]
    c["n"] = k.zero32
    c["ev"].zero_()


def _finish(c, msg, err, ok, echo):
    """What every message's last segment does last: its result row (R_*).
    A message that started after the sticky error is frozen: no output
    but the error."""
    action_out = torch.where(ok, msg["action"], op.REJECT)  # KProcessor:123
    row = torch.stack((ok.to(_I64), action_out.to(_I64), echo[0].to(_I64),
                       echo[1], echo[2].to(_I64), c["n"].to(_I64)))
    row = torch.where(c["err0"] != ERR_OK, 0, row)
    c["row"] = torch.cat((row, err.to(_I64).reshape(1)))
    c["err"] = err


def _flag(c, err, done):
    """The end of a segment before a loop test: the pair the host reads."""
    c["err"] = err
    c["flag"] = torch.stack((err, done.to(_I32)))


def _seg_one(st, c, p):
    """A message of one segment: the handler `p.handler`."""
    k = _consts(c["m"].device)
    _start(c, k)
    msg = _msg(c)
    err, ok, echo = p.handler(st, c["err"], msg, k, p)
    _finish(c, msg, err, ok, echo)


# -- BUY/SELL: addOrder (KProcessor.java:200-223) around tryMatch
# (KProcessor.java:225-263), whose loop is one segment per iteration

def _seg_trade_pre(st, c, p):
    """The margin check and the match loop's entry: the best opposite
    level and its first maker."""
    k = _consts(c["m"].device)
    _start(c, k)
    msg = _msg(c)
    java, is_buy = p.java, p.is_buy
    bkey = _order_book_key(msg["sid"], is_buy, java)
    _, _, book_found = _book_get(st, bkey)
    err, bal_ok = _check_balance(st, c["err"], book_found, msg["aid"],
                                 msg["sid"], msg["price"], is_buy,
                                 msg["size"])
    en = book_found & bal_ok          # pre_ok: the match runs
    c["pre_ok"], c["bkey"] = en, bkey

    opp_key = _order_book_key(msg["sid"], not is_buy, java)
    scan = bits.book_min_price if is_buy else bits.book_max_price
    msb, lsb, opp_found = _book_get(st, opp_key)
    err = _guard(err, en, ~opp_found, ERR_CRASH)  # NPE: opposite book missing
    price_bit = scan(msb, lsb)
    empty = price_bit == -1
    mbkey = bits.bucket_key(opp_key, price_bit)
    bfirst, blast, bfound = _bkt_get(st, mbkey)
    err = _guard(err, en, ~empty & ~bfound, ERR_CRASH)  # Q7 overshoot NPE
    maker, mfound = _ord_get(st, bfirst)
    err = _guard(err, en, ~empty & bfound & ~mfound, ERR_CRASH)
    c.update(opp_key=opp_key, empty=empty, tsize=msg["size"], maker=maker,
             maker_ptr=bfirst, mbkey=mbkey, blast=blast, msb=msb, lsb=lsb)
    # When the book is non-empty the loop runs; a guard-false first
    # iteration still does the post-loop writeback (KProcessor.java:259-261)
    c["writeback"] = en & ~empty & (err == ERR_OK)
    _flag(c, err, empty | ~en | (err != ERR_OK))


def _seg_trade_iter(st, c, p):
    """One iteration of the match loop. The Q2 guard precedence is
    replicated in java mode. Each iteration emits 2 events or exits."""
    k = _consts(c["m"].device)
    msg = _msg(c)
    java, is_buy, E = p.java, p.is_buy, p.max_events
    limit = msg["price"]
    opp_key = c["opp_key"]
    scan = bits.book_min_price if is_buy else bits.book_max_price
    err0 = err = c["err"]
    maker, tsize = c["maker"], c["tsize"]
    msb, lsb, mbkey = c["msb"], c["lsb"], c["mbkey"]
    mprice = maker[O_PRICE].to(_I32)
    if java:  # Q2: (size>0 && isBuy) ? (mp <= limit) : (mp >= limit)
        guard = (torch.where(tsize > 0, mprice <= limit, mprice >= limit)
                 if is_buy else mprice >= limit)
    else:
        guard = (tsize > 0) & ((mprice <= limit) if is_buy
                               else (mprice >= limit))

    # --- trade at maker price (KProcessor.java:238-241)
    msize = maker[O_SIZE].to(_I32)
    trade_size = torch.minimum(tsize, msize)
    maker_sz = msize - trade_size
    maker_traded = _with(maker, {O_SIZE: maker_sz.to(_I64)})
    err = _execute_trade(st, err, guard, c, msg, maker_traded, trade_size,
                         is_buy, java, E, k)

    # exhausted maker? delete and advance (KProcessor.java:242-257)
    exhausted = maker_sz == 0
    gx = guard & exhausted
    _ord_del(st, err, gx, maker[O_OID])

    # advance within the bucket, or to the next price level: delete the
    # bucket, clear the bit, rescan
    has_next = maker[O_NEXT_HAS] != 0
    nl = gx & ~has_next
    _bkt_del(st, err, nl, mbkey)
    nmsb, nlsb = bits.book_with_bit_unset(msb, lsb, mprice)
    err = _book_put(st, err, nl, opp_key, nmsb, nlsb)
    nprice = scan(nmsb, nlsb)
    book_empty = nprice == -1
    nbkey = bits.bucket_key(opp_key, nprice)
    nbfirst, nblast, nbfound = _bkt_get(st, nbkey)
    err = _guard(err, nl, ~book_empty & ~nbfound, ERR_CRASH)

    adv_ptr = torch.where(has_next, maker[O_NEXT], nbfirst)
    nmaker, nmfound = _ord_get(st, adv_ptr)
    fetch_ok = has_next | ~book_empty
    err = _guard(err, gx, fetch_ok & ~nmfound, ERR_CRASH)

    # --- the iteration's outcome
    # 1. guard false -> done, exit with writeback (state untouched)
    # 2. traded, maker not exhausted -> done, writeback, maker mutated
    # 3. exhausted, book empty after level clear -> done, NO writeback
    # 4. advanced -> continue
    done = ~(gx & fetch_ok)
    no_wb = nl & book_empty
    c["writeback"] = torch.where(done, ~no_wb & (err0 == ERR_OK)
                                 & (err == ERR_OK), c["writeback"])
    c["tsize"] = torch.where(guard, tsize - trade_size, tsize)
    c["maker"] = torch.where(guard, torch.where(exhausted, nmaker,
                                                maker_traded), maker)
    c["maker_ptr"] = torch.where(gx, adv_ptr, c["maker_ptr"])
    c["mbkey"] = torch.where(nl, nbkey, mbkey)
    c["blast"] = torch.where(nl, nblast, c["blast"])
    c["msb"] = torch.where(nl, nmsb, msb)
    c["lsb"] = torch.where(nl, nlsb, lsb)
    _flag(c, err, done)


def _seg_trade_post(st, c, p):
    """The match loop's writeback, then the rest of the order rested."""
    k = _consts(c["m"].device)
    msg = _msg(c)
    err, pre_ok = c["err"], c["pre_ok"]
    # post-loop writeback: buckets[bkey] = (maker_ptr, blast); maker.prev
    # = null; orders[maker_ptr] = maker (KProcessor.java:259-261)
    wb = c["writeback"] & (err == ERR_OK)
    err = _bkt_put(st, err, wb, c["mbkey"], c["maker_ptr"], c["blast"])
    err = _ord_put(st, err, wb, _with(c["maker"], {O_PREV: k.zero64,
                                                   O_PREV_HAS: k.zero64}))
    # the empty-book early exit returns False unconditionally
    # (KProcessor.java:232-235), even for a zero-size taker
    matched = ~c["empty"] & (c["tsize"] == 0)
    residual = torch.where(pre_ok, c["tsize"], msg["size"])

    # rest the remainder (KProcessor.java:205-222)
    rest = pre_ok & ~matched
    bkey = c["bkey"]
    msb, lsb, _ = _book_get(st, bkey)  # reload: tryMatch may have mutated it
    bit_set = bits.book_check_bit(msb, lsb, msg["price"])
    bkt_key = bits.bucket_key(bkey, msg["price"])
    oid = msg["oid"]

    # fresh bucket path: bucket=(oid,oid), set bitmap bit
    fresh = rest & ~bit_set
    err = _bkt_put(st, err, fresh, bkt_key, oid, oid)
    smsb, slsb = bits.book_with_bit_set(msb, lsb, msg["price"])
    err = _book_put(st, err, fresh, bkey, smsb, slsb)

    # append path: link onto tail (mutates echoed prev — Q9)
    app = rest & bit_set
    bfirst, blast, bfound = _bkt_get(st, bkt_key)
    err = _guard(err, app, ~bfound, ERR_CRASH)  # NPE: bit set, bucket missing
    tail, tail_found = _ord_get(st, blast)
    err = _guard(err, app, bfound & ~tail_found, ERR_CRASH)
    err = _ord_put(st, err, app, _with(tail, {O_NEXT: oid,
                                              O_NEXT_HAS: k.one64}))
    err = _bkt_put(st, err, app, bkt_key, bfirst, oid)

    prev_out = torch.where(bit_set, tail[O_OID], msg["prev"])
    prev_has_out = bit_set | msg["prev_has"]
    rec = torch.stack((oid, msg["action"].to(_I64), msg["aid"], msg["sid"],
                       msg["price"].to(_I64), residual.to(_I64), msg["next"],
                       msg["next_has"].to(_I64), prev_out,
                       prev_has_out.to(_I64)))
    err = _ord_put(st, err, rest, rec)
    echo = (residual,
            torch.where(rest, prev_out, msg["prev"]),
            torch.where(rest, prev_has_out, msg["prev_has"]))
    _finish(c, msg, err, pre_ok, echo)


# -- fixed-mode REMOVE_SYMBOL (and PAYOUT's first half): both sides' books
# wiped (oracle._wipe_book_fixed), each wipe a loop of one segment per
# resting order or level

def _wipe_enter(st, c, en, book_key):
    """A wipe's entry: the book's bitmap, nothing walked yet."""
    msb, lsb, found = _book_get(st, book_key)
    c.update(w_key=book_key, w_en=en, w_found=found, w_msb=msb, w_lsb=lsb,
             w_walking=found & False, w_ptr=book_key * 0,
             w_price=(book_key * 0).to(_I32) - 1)
    _flag(c, c["err"], ~found | ~en)


def _wipe_exit(st, c):
    """A wipe's exit: the cleared bitmap written back."""
    return _book_put(st, c["err"], c["w_en"] & c["w_found"], c["w_key"],
                     c["w_msb"], c["w_lsb"])


def _seg_wipe_iter(st, c, p):
    """One step of a wipe: pop a level's bucket, or release one resting
    order's margin and move to the next."""
    err, walking = c["err"], c["w_walking"]
    msb, lsb, book_key = c["w_msb"], c["w_lsb"], c["w_key"]
    # fetch level head if not walking a list
    price = torch.where(walking, c["w_price"], bits.book_min_price(msb, lsb))
    level_done = ~walking & (price == -1)

    bkey = bits.bucket_key(book_key, price)
    bfirst, _, bfound = _bkt_get(st, bkey)
    # entering a level: pop bucket (oracle .pop raises when missing)
    entering = ~walking & ~level_done
    err = _guard(err, entering, ~bfound, ERR_CRASH)
    _bkt_del(st, err, entering, bkey)

    ptr = torch.where(walking, c["w_ptr"], bfirst)
    rec, rfound = _ord_get(st, ptr)
    act = ~level_done
    err = _guard(err, act, ~rfound, ERR_CRASH)
    _ord_del(st, err, act, ptr)
    err = _post_remove_adjustments(st, err, act, rec, p.java)

    has_next = rec[O_NEXT_HAS] != 0
    # level finished: clear bit
    level_end = act & ~has_next
    nmsb, nlsb = bits.book_with_bit_unset(msb, lsb, price)
    c["w_msb"] = torch.where(level_end, nmsb, msb)
    c["w_lsb"] = torch.where(level_end, nlsb, lsb)
    c["w_walking"] = act & has_next
    c["w_ptr"] = torch.where(c["w_walking"], rec[O_NEXT], 0)
    c["w_price"] = price
    _flag(c, err, level_done)


def _seg_wipe_cap(st, c, p):
    """A wipe past its iteration budget: the reference would not end."""
    _flag(c, _guard(c["err"], c["w_en"], c["w_en"], ERR_CRASH), c["w_en"])


def _seg_remove_pre(st, c, p):
    k = _consts(c["m"].device)
    _start(c, k)
    sid = _msg(c)["sid"]
    s = torch.abs(sid)
    _, _, found = _book_get(st, 2 * s)
    c["found"], c["s"] = found, s
    _wipe_enter(st, c, found, 2 * s)


def _seg_remove_mid(st, c, p):
    c["err"] = _wipe_exit(st, c)
    _wipe_enter(st, c, c["found"], 2 * c["s"] + 1)


def _seg_remove_post(st, c, p):
    k = _consts(c["m"].device)
    msg = _msg(c)
    found, s = c["found"], c["s"]
    err = _wipe_exit(st, c)
    _book_del(st, err, found, 2 * s)
    _book_del(st, err, found, 2 * s + 1)
    ok, echo = found, _echo_of(msg)
    if p.payout:
        err, ok, echo = _payout_credit(st, err, msg, found, k, p)
    _finish(c, msg, err, ok, echo)


class _Segments:
    """Runs the segments of messages: eagerly on the CPU, or on the card
    each (segment, path) as a CUDA graph captured after its first, eager,
    run and replayed from then on.

    On the card the carry maps each name to one static tensor for all
    messages: a graph reads its inputs there and copies its outputs back
    at its end. A value passed through under another name is cloned
    before those copies (a message's starting error), so no copy reads a
    static tensor another copy already overwrote."""

    def __init__(self, st, caps: ParityCaps, device):
        self.graphs = device.type == "cuda"
        self.graph = {}
        self.static = {}
        if self.graphs:
            self.static = {
                "m": torch.zeros((len(M_FIELDS),), dtype=_I64,
                                 device=device),
                "ev": torch.zeros((caps.max_events, 6), dtype=_I64,
                                  device=device),
                "err": st["err"].clone()}
            # the constants every segment reads, made before any capture
            _consts(device)
            _onehot(device)
            bits._consts(device)

    def carry(self, m, ev, err):
        """A message's carry: its fields, fill rows and starting error."""
        if not self.graphs:
            return {"m": m, "ev": ev, "err": err}
        self.static["m"].copy_(m)
        return dict(self.static)

    def run(self, fn, st, c, p) -> None:
        if not self.graphs:
            fn(st, c, p)
            return
        g = self.graph.get((fn, p))
        if g is not None:
            g.replay()
            return
        fn(st, c, p)
        self._store(c)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="thread_local"):
            cap = dict(self.static)
            fn(st, cap, p)
            self._store(cap)
        self.graph[(fn, p)] = g

    def _store(self, c) -> None:
        """Copy the carry's new values into the static tensors (made at a
        name's first value) and point `c` at them."""
        ids = {id(t): name for name, t in self.static.items()}
        src = {}
        for name, t in c.items():
            if self.static.get(name) is t:
                continue
            other = ids.get(id(t))
            src[name] = t.clone() if other is not None else t
        for name, t in src.items():
            if name in self.static:
                self.static[name].copy_(t)
            else:
                self.static[name] = t.clone()
        c.update(self.static)


# ---------------------------------------------------------------------------
# the host side

@functools.lru_cache(maxsize=None)
def _consts(device: torch.device):
    def c(v, dt):
        return torch.tensor(v, dtype=dt, device=device)

    return _K(zero64=c(0, _I64), one64=c(1, _I64), zero32=c(0, _I32),
              bought=c(op.BOUGHT, _I32), sold=c(op.SOLD, _I32),
              true=c(True, torch.bool), false=c(False, torch.bool))


@dataclasses.dataclass(frozen=True)
class _K:
    zero64: torch.Tensor
    one64: torch.Tensor
    zero32: torch.Tensor
    bought: torch.Tensor
    sold: torch.Tensor
    true: torch.Tensor
    false: torch.Tensor


# rows of the per-batch result table
R_RESULT, R_ACTION, R_SIZE, R_PREV, R_PREV_HAS, R_NEV, R_ERR = range(7)
# rows of the per-batch message table (int64; a segment narrows the int32
# and bool fields)
M_FIELDS = ("action", "oid", "aid", "sid", "price", "size", "next",
            "next_has", "prev", "prev_has")

_ONE_SEGMENT = {op.ADD_SYMBOL: _h_add_symbol, op.CANCEL: _h_cancel,
                op.CREATE_BALANCE: _h_create_balance,
                op.TRANSFER: _h_transfer}


def msgs_to_array(msgs: Sequence[OrderMsg], batch: int) -> np.ndarray:
    """(len(M_FIELDS), batch) int64: each field Java-wrapped (jint for
    int fields, jlong for ids), absent next/prev as 0 with has = 0."""
    arr = np.zeros((len(M_FIELDS), batch), np.int64)
    for i, m in enumerate(msgs):
        arr[:, i] = (jl.jint(m.action), jl.jlong(m.oid), jl.jlong(m.aid),
                     jl.jlong(m.sid), jl.jint(m.price), jl.jint(m.size),
                     0 if m.next is None else jl.jlong(m.next),
                     m.next is not None,
                     0 if m.prev is None else jl.jlong(m.prev),
                     m.prev is not None)
    return arr


class ParityEngine:
    """Host wrapper: the device-backed equivalent of OracleEngine.

    process()/process_batch() return the OutRecord stream the oracle
    produces (IN echo, fills, OUT echo per message — KProcessor.java:97,
    272-273, 124). On a reference-death path it raises DeviceParityError
    after the records of every message before the death point.

    The state lives on `device` (the card unless the caller passes
    "cpu") across batches. On the card each segment of a message runs as
    a CUDA graph; on the CPU its ops run one by one. `syncs` counts the
    reads of device values
    the host made: each test of a loop's condition, and two or three per
    batch (the sticky error, the result table, the packed fill rows when
    there are any)."""

    def __init__(self, compat: str = "java",
                 caps: Optional[ParityCaps] = None, device="cuda") -> None:
        if compat not in ("java", "fixed"):
            raise ValueError(compat)
        self.compat = compat
        self.caps = caps or ParityCaps()
        self.device = resolve_device(device)
        self.state = make_state(self.caps, self.device)
        self.syncs = 0
        self.messages = 0

    @property
    def state(self) -> Dict[str, torch.Tensor]:
        return self._state

    @state.setter
    def state(self, st: Dict[str, torch.Tensor]) -> None:
        # graphs read the tables they were captured over: new tables, new
        # graphs
        self._state = st
        self._segs = None

    @property
    def captured(self) -> int:
        """Segment graphs captured on the card so far (0 eagerly)."""
        return len(self._segs.graph) if self._segs else 0

    def process(self, msg: OrderMsg) -> List[OutRecord]:
        return self.process_batch([msg])[0]

    def process_batch(self, msgs: Sequence[OrderMsg]
                      ) -> List[List[OutRecord]]:
        """Process messages strictly in order, `caps.batch` at a time;
        returns per-message record lists."""
        out: List[List[OutRecord]] = []
        for lo in range(0, len(msgs), self.caps.batch):
            chunk = list(msgs[lo:lo + self.caps.batch])
            h, ev = self._run_batch(chunk)
            recs, bad = self._records_batch(chunk, h, ev)
            out.extend(recs)
            if bad is not None:
                raise DeviceParityError(int(h[R_ERR][bad]), lo + bad, out)
        return out

    def _loop_runs(self, c) -> bool:
        """One loop test: read (err, done) -> whether the loop runs on.
        An error read here stops the batch after this message."""
        e, d = c["flag"].tolist()
        self.syncs += 1
        if e != ERR_OK:
            self._dead = e
        return e == ERR_OK and not d

    def _message(self, st, c, m: OrderMsg) -> None:
        """One message's segments, chosen on the host from its fields."""
        caps = self.caps
        java = self.compat == "java"
        run = self._segs.run
        action = jl.jint(m.action)
        path = _Path(java, caps.max_events, caps.orders + 130)
        if action in _ONE_SEGMENT:
            run(_seg_one, st, c, dataclasses.replace(
                path, handler=_ONE_SEGMENT[action]))
        elif action in (op.BUY, op.SELL):
            price, size = jl.jint(m.price), jl.jint(m.size)
            if not java and not (0 <= price < 126 and size > 0):
                # fixed mode's domain check: a reject that touches nothing
                run(_seg_one, st, c, dataclasses.replace(
                    path, handler=_h_reject))
                return
            path = dataclasses.replace(path, is_buy=action == op.BUY)
            run(_seg_trade_pre, st, c, path)
            while self._loop_runs(c):
                run(_seg_trade_iter, st, c, path)
            run(_seg_trade_post, st, c, path)
        elif action in (op.REMOVE_SYMBOL, op.PAYOUT):
            payout = action == op.PAYOUT
            path = dataclasses.replace(
                path, payout=payout,
                credit=java or jl.jlong(m.sid) >= 0)
            if java:
                run(_seg_one, st, c, dataclasses.replace(
                    path, handler=(_h_payout_java if payout
                                   else _h_remove_symbol_java)))
                return
            run(_seg_remove_pre, st, c, path)
            self._wipe(st, c, path)
            run(_seg_remove_mid, st, c, path)
            self._wipe(st, c, path)
            run(_seg_remove_post, st, c, path)
        else:
            run(_seg_one, st, c, dataclasses.replace(path,
                                                     handler=_h_reject))

    def _wipe(self, st, c, path) -> None:
        iters = 0
        while self._loop_runs(c):
            self._segs.run(_seg_wipe_iter, st, c, path)
            iters += 1
            if iters >= path.max_iters:
                self._segs.run(_seg_wipe_cap, st, c, path)

    def _run_batch(self, chunk):
        """One batch through the step -> (result table on the host,
        packed fill rows as lists)."""
        caps, dev, st = self.caps, self.device, self.state
        T, E = caps.batch, caps.max_events
        if self._segs is None:
            self._segs = _Segments(st, caps, dev)
        a = torch.from_numpy(msgs_to_array(chunk, T)).to(dev)
        res = torch.zeros((7, T), dtype=_I64, device=dev)
        grid = torch.zeros((T, E, 6), dtype=_I64, device=dev)
        # a state that died in an earlier batch freezes every message of
        # this one (one read of the sticky error per batch)
        self._dead = int(st["err"])
        self.syncs += 1
        if self._dead != ERR_OK:
            res[R_ERR] = self._dead
        err = st["err"]
        for i, m in enumerate(chunk):
            if self._dead != ERR_OK:
                # a loop read the sticky error: every later message is
                # frozen, and the records stop at the first error
                break
            c = self._segs.carry(a[:, i], grid[i], err)
            self._message(st, c, m)
            res[:, i] = c["row"]
            if self._segs.graphs:
                grid[i] = c["ev"]
            err = c["err"]
        st["err"] = err.clone()
        self.messages += len(chunk)

        # the used fill rows packed into one prefix on the device (the
        # JAX package's event compaction), then two plain copies
        h = res.cpu().numpy()
        self.syncs += 1
        nev = res[R_NEV]
        tot = int(h[R_NEV].sum())
        if not tot:
            return h, []
        offs = torch.cumsum(nev, 0) - nev
        eidx = torch.arange(E, dtype=_I64, device=dev)[None, :]
        pos = torch.where(eidx < nev[:, None], offs[:, None] + eidx, T * E)
        packed = torch.zeros((T * E + 1, 6), dtype=_I64, device=dev)
        packed.index_put_((pos.reshape(-1),), grid.reshape(T * E, 6))
        ev = packed[:tot].cpu().tolist()
        self.syncs += 1
        return h, ev

    @staticmethod
    def _records_batch(chunk, h, ev_rows):
        """Per-batch record construction from the host copies. Returns
        (records, first_error_index_or_None)."""
        errs = h[R_ERR].tolist()
        n_events = h[R_NEV].tolist()
        action_out = h[R_ACTION].tolist()
        size_out = h[R_SIZE].tolist()
        prev_out = h[R_PREV].tolist()
        prev_has = h[R_PREV_HAS].tolist()
        out = []
        off = 0
        for i, m in enumerate(chunk):
            if errs[i] != ERR_OK:
                return out, i
            recs = [OutRecord("IN", m.copy())]
            for e in range(n_events[i]):
                a, oid, aid, sid, price, size = ev_rows[off + e]
                recs.append(OutRecord("OUT", OrderMsg(
                    action=a, oid=oid, aid=aid, sid=sid, price=price,
                    size=size)))
            off += n_events[i]
            echo = m.copy()
            echo.action = action_out[i]
            echo.size = size_out[i]
            echo.prev = prev_out[i] if prev_has[i] else None
            recs.append(OutRecord("OUT", echo))
            out.append(recs)
        return out, None

    # -- state export for deep-equality tests ---------------------------------

    def export_state(self) -> Dict[str, dict]:
        """Host-side dict view of the five stores, directly comparable to
        the oracle's dicts."""
        s = state_to_numpy(self.state)

        def live(name):
            return np.flatnonzero(s[name + "_used"]).tolist()

        balances = {int(s["bal_key"][i]): int(s["bal_val"][i])
                    for i in live("bal")}
        positions = {(int(s["pos_ka"][i]), int(s["pos_ks"][i])):
                     (int(s["pos_amt"][i]), int(s["pos_avail"][i]))
                     for i in live("pos")}
        books = {int(s["book_key"][i]): (int(s["book_msb"][i]),
                                         int(s["book_lsb"][i]))
                 for i in live("book")}
        buckets = {int(s["bkt_key"][i]): (int(s["bkt_first"][i]),
                                          int(s["bkt_last"][i]))
                   for i in live("bkt")}
        orders = {}
        for i in live("ord"):
            orders[int(s["ord_oid"][i])] = {
                "action": int(s["ord_action"][i]),
                "aid": int(s["ord_aid"][i]), "sid": int(s["ord_sid"][i]),
                "price": int(s["ord_price"][i]),
                "size": int(s["ord_size"][i]),
                "next": int(s["ord_next"][i]) if s["ord_next_has"][i]
                else None,
                "prev": int(s["ord_prev"][i]) if s["ord_prev_has"][i]
                else None,
            }
        return {"balances": balances, "positions": positions, "books": books,
                "buckets": buckets, "orders": orders}
