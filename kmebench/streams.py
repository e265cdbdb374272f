"""The benchmark's one message generator: seeded streams of the upstream
JSON wire schema, made in NumPy from the parameters of a configuration's
`"stream"`.

The parameters, each defaulting to the upstream load generator
(exchange_test.js:4-37, 48-61, 106-117, with its knobs :18-20):

- `accounts` (10): each is created and funded in the preamble with
  `deposit`: floor(N(mean, sd)) for a pair `[50000, 25000]`, or a whole
  number;
- `preamble_symbols` (3): symbols 0 .. n-1 added in the preamble
  (exchange_test.js:29 adds 0 .. S/2);
- `symbols` (3): events draw their symbol from 0 .. S-1 by
  `symbol_draw`: `"uniform"`, or `{"hot": share}` (symbol 0 with that
  share, else uniform);
- `per_mille` (`{"add_symbol": 1, "payout": 1, "transfer": 2,
  "buy": 332, "sell": 332, "cancel": 332}`): the event mix, summing to
  1000; an event draws e in [0, 1000) and takes the kind whose range
  holds it, in that order;
- `payout_opcode` (`"cancel"`, the harness's bug; or `"payout"`), a
  payout's sid signed by a fair coin and its size 100 - `rake` (3);
  with `payout_readd` each payout is followed by an ADD of its symbol;
- `price`, `size` (`[50, 10]`): floor(N(mean, sd)); with `clamp`, prices
  are clipped to [0, 125] and sizes to at least 1;
- `transfer` (`[0, 12500]`): a transfer's amount, floor(N(mean, sd)),
  to a uniformly drawn account.

Buys and sells are by uniformly drawn accounts. Cancels name a uniformly
drawn open order id with its account (oid 0 while none is open), which
then leaves the pool. Order ids are uniform in [0, 2^53).

A stream is made in chunks of a fixed number of events, so the messages
of a seed are the same however a caller slices them: the generator
child sends them and the harness makes them again for the reference.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from kmebench.reference import opcodes as op

CHUNK = 256                       # events drawn per step
COLS = ("action", "oid", "aid", "sid", "price", "size")
# the upstream JSON wire schema (exchange_test.js:63-66)
_JSON = ('{"action":%d,"oid":%d,"aid":%d,"sid":%d,"price":%d,'
         '"size":%d}')
KINDS = ("add_symbol", "payout", "transfer", "buy", "sell", "cancel")
DEFAULTS = {
    "accounts": 10, "deposit": [50000, 25000], "preamble_symbols": 3,
    "symbols": 3, "symbol_draw": "uniform",
    "per_mille": {"add_symbol": 1, "payout": 1, "transfer": 2, "buy": 332,
                  "sell": 332, "cancel": 332},
    "payout_opcode": "cancel", "payout_readd": False, "rake": 3,
    "price": [50, 10], "size": [50, 10], "transfer": [0, 12500],
    "clamp": False,
}


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per (seed, purpose); any whole seed."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) & (2**64 - 1), stream]))


def _cols(rows: List[tuple]) -> Dict[str, np.ndarray]:
    if not rows:
        return {k: np.zeros(0, np.int64) for k in COLS}
    a = np.array(rows, dtype=np.int64).reshape(len(rows), 6)
    return {k: np.ascontiguousarray(a[:, i]) for i, k in enumerate(COLS)}


def _floor_normal(g, pair, n: int) -> np.ndarray:
    mean, sd = pair
    return np.floor(g.standard_normal(n) * float(sd) + float(mean))


class MessageStream:
    """The messages of one stream's parameters and seed, in order:
    `take(n)` returns the next n as int64 columns."""

    def __init__(self, spec: dict, seed: int) -> None:
        unknown = set(spec) - set(DEFAULTS)
        if unknown:
            raise ValueError(f"unknown stream parameters {sorted(unknown)}")
        p = dict(DEFAULTS, **spec)
        self.p = p
        self.accounts = int(p["accounts"])
        self.symbols = int(p["symbols"])
        mix = p["per_mille"]
        if set(mix) - set(KINDS) or sum(mix.values()) != 1000:
            raise ValueError(f"per_mille {mix} is not a mix of {KINDS} "
                             "summing to 1000")
        # e < edge[k] picks kind k, kinds in KINDS order
        self._edges = np.cumsum([int(mix.get(k, 0)) for k in KINDS])
        draw = p["symbol_draw"]
        self._hot = None
        if isinstance(draw, dict) and "hot" in draw:
            self._hot = float(draw["hot"])
        elif draw != "uniform":
            raise ValueError(f"unknown symbol_draw {draw!r}")
        self.payout_action = {"cancel": op.CANCEL,
                              "payout": op.PAYOUT}[p["payout_opcode"]]
        self._rng = rng_for(seed, 1)
        self._pool_oid: List[int] = []     # open order ids (upstream pool)
        self._pool_aid: List[int] = []
        self._buf: List[tuple] = self._preamble()
        self._pos = 0
        self.preamble_len = len(self._buf)

    def _preamble(self) -> List[tuple]:
        dep = self.p["deposit"]
        if isinstance(dep, list):
            dep = _floor_normal(self._rng, dep, self.accounts)
            dep = dep.astype(np.int64).tolist()
        else:
            dep = [int(dep)] * self.accounts
        rows = []
        for aid in range(self.accounts):
            rows.append((op.CREATE_BALANCE, 0, aid, 0, 0, 0))
            rows.append((op.TRANSFER, 0, aid, 0, 0, dep[aid]))
        for sid in range(int(self.p["preamble_symbols"])):
            rows.append((op.ADD_SYMBOL, 0, 0, sid, 0, 0))
        return rows

    def _sids(self, g, n: int) -> np.ndarray:
        s = g.integers(0, self.symbols, n)
        if self._hot is not None:
            s = np.where(g.random(n) < self._hot, 0, s)
        return s

    def _cancel(self, u: float) -> tuple:
        pool = self._pool_oid
        if not pool:
            return (op.CANCEL, 0, 0, 0, 0, 0)
        j = int(u * len(pool))
        oid, aid = pool[j], self._pool_aid[j]
        pool[j] = pool[-1]
        pool.pop()
        self._pool_aid[j] = self._pool_aid[-1]
        self._pool_aid.pop()
        return (op.CANCEL, oid, aid, 0, 0, 0)

    def _chunk(self) -> None:
        g, n, p = self._rng, CHUNK, self.p
        kind = np.searchsorted(self._edges, g.integers(0, 1000, n),
                               side="right").tolist()
        acct = g.integers(0, self.accounts, n).tolist()
        sym = self._sids(g, n).tolist()
        price = _floor_normal(g, p["price"], n)
        size = _floor_normal(g, p["size"], n)
        if p["clamp"]:
            price = np.clip(price, 0, 125)
            size = np.maximum(size, 1)
        price = price.astype(np.int64).tolist()
        size = size.astype(np.int64).tolist()
        amount = _floor_normal(g, p["transfer"], n).astype(np.int64)
        amount = amount.tolist()
        coin = g.integers(0, 2, n).tolist()
        oids = g.integers(0, 2**53 - 1, n).tolist()
        cu = g.random(n).tolist()
        out = self._buf
        pay = 100 - int(p["rake"])
        readd = bool(p["payout_readd"])
        for i in range(n):
            k, s = kind[i], sym[i]
            if k == 0:
                out.append((op.ADD_SYMBOL, 0, 0, s, 0, 0))
            elif k == 1:
                out.append((self.payout_action, 0, 0,
                            s if coin[i] == 0 else -s, 0, pay))
                if readd:
                    out.append((op.ADD_SYMBOL, 0, 0, s, 0, 0))
            elif k == 2:
                out.append((op.TRANSFER, 0, acct[i], 0, 0, amount[i]))
            elif k <= 4:
                self._pool_oid.append(oids[i])
                self._pool_aid.append(acct[i])
                out.append((op.BUY if k == 3 else op.SELL, oids[i],
                            acct[i], s, price[i], size[i]))
            else:
                out.append(self._cancel(cu[i]))

    def take(self, n: int) -> Dict[str, np.ndarray]:
        """The next n messages as int64 columns."""
        need = self._pos + n
        while len(self._buf) < need:
            self._chunk()
        rows = self._buf[self._pos:need]
        # drop what was read, keep the unread tail
        self._buf = self._buf[need:]
        self._pos = 0
        return _cols(rows)


def encode(cols: Dict[str, np.ndarray]) -> List[str]:
    """JSON values of the upstream wire schema, one per message."""
    return [_JSON % t for t in zip(*(cols[k].tolist() for k in COLS))]


def concat(parts: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    if not parts:
        return _cols([])
    return {k: np.concatenate([p[k] for p in parts]) for k in COLS}
