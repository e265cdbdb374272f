"""Workload generation — a seeded port of the reference's e2e load
generator (exchange_test.js).

The port's own copy of `WorkloadGen`, `harness_stream` and
`zipf_symbol_stream` from `kme_tpu/workload.py`: for a seed they yield
the same streams (tests/test_torch_port.py holds them equal), so the
port's smoke run and benchmarks need no `kme_tpu` import.

Faithful details of the reference distribution:
  - seeding preamble: per account CREATE_BALANCE + TRANSFER of
    N(50000, 25000), then `i < numSymbols/2+1` ADD_SYMBOLs (a float
    loop bound, exchange_test.js:29-32)
  - event mix per mille (exchange_test.js:106-117): 1 add-symbol,
    1 payout, 2 transfer N(0, 12500), 332 buy, 332 sell, ~334 cancel
  - prices and sizes are floor(N(50, 10)) — occasionally zero or
    negative (the Q2 trigger)
  - payouts are sent with action=4 (CANCEL) — the harness's opcode bug,
    Q5; pass payout_opcode_bug=False to emit the real PAYOUT opcode
  - cancels pick a uniformly random previously-submitted oid and remove
    it from the pool whether or not the cancel succeeds; an empty pool
    yields the oid=0 cancel
  - oids are uniform in [0, 2^53)
"""

from __future__ import annotations

import bisect
import math
import random
from typing import Iterator, List

from kme_tpu_torch import opcodes as op
from kme_tpu_torch.wire import OrderMsg


class WorkloadGen:
    """Deterministic re-implementation of exchange_test.js's generator."""

    def __init__(
        self,
        num_accounts: int = 10,
        num_symbols: int = 3,
        rake: int = 3,
        seed: int = 0,
        payout_opcode_bug: bool = True,
        validate: bool = False,
    ) -> None:
        self.num_accounts = num_accounts
        self.num_symbols = num_symbols
        self.rake = rake
        self.rng = random.Random(seed)
        self.payout_opcode_bug = payout_opcode_bug
        # validate=True clamps prices/sizes into the fixed-mode domain
        # (price 0..125, size >= 1) for clean-semantics workloads.
        self.validate = validate
        self.open_orders: dict[int, int] = {}  # oid -> aid
        # sorted oid pool kept in lockstep with open_orders: cancels
        # select by SORTED position (bisect keeps the order at O(n))
        self._pool: list[int] = []

    # -- primitive distributions (exchange_test.js:48-61) --

    def _random_normal(self) -> float:
        u = 0.0
        v = 0.0
        while u == 0.0:
            u = self.rng.random()
        while v == 0.0:
            v = self.rng.random()
        return math.sqrt(-2.0 * math.log(u)) * math.cos(2.0 * math.pi * v)

    def _uniform(self, rng_range: int) -> int:
        return math.floor(self.rng.random() * rng_range)

    def _normal_param(self, mean: float, std: float) -> int:
        return math.floor(self._random_normal() * std + mean)

    def _clamp_price(self, p: int) -> int:
        return min(125, max(0, p)) if self.validate else p

    def _clamp_size(self, s: int) -> int:
        return max(1, s) if self.validate else s

    # -- message constructors (exchange_test.js:63-104) --

    def create_account(self, aid: int) -> OrderMsg:
        return OrderMsg(action=op.CREATE_BALANCE, aid=aid)

    def create_symbol(self, sid: int) -> OrderMsg:
        return OrderMsg(action=op.ADD_SYMBOL, sid=sid)

    def create_transfer(self, aid: int, amount: int) -> OrderMsg:
        return OrderMsg(action=op.TRANSFER, aid=aid, size=amount)

    def create_payout(self, sid: int, success: bool) -> OrderMsg:
        action = op.CANCEL if self.payout_opcode_bug else op.PAYOUT
        return OrderMsg(
            action=action, sid=sid * (1 if success else -1),
            size=100 - self.rake)

    def _new_oid(self, aid: int) -> int:
        oid = math.floor(self.rng.random() * (2 ** 53 - 1))
        if oid not in self.open_orders:
            bisect.insort(self._pool, oid)
        self.open_orders[oid] = aid
        return oid

    def create_buy(self, aid: int, sid: int, price: int, size: int) -> OrderMsg:
        return OrderMsg(action=op.BUY, oid=self._new_oid(aid), aid=aid,
                        sid=sid, price=self._clamp_price(price),
                        size=self._clamp_size(size))

    def create_sell(self, aid: int, sid: int, price: int, size: int) -> OrderMsg:
        return OrderMsg(action=op.SELL, oid=self._new_oid(aid), aid=aid,
                        sid=sid, price=self._clamp_price(price),
                        size=self._clamp_size(size))

    def create_cancel(self) -> OrderMsg:
        if not self.open_orders:
            return OrderMsg(action=op.CANCEL)
        i = math.floor(self.rng.random() * len(self._pool))
        oid = self._pool.pop(i)
        aid = self.open_orders.pop(oid)
        return OrderMsg(action=op.CANCEL, oid=oid, aid=aid)

    # -- event stream (exchange_test.js:4-37, 106-117) --

    def preamble(self) -> List[OrderMsg]:
        msgs: List[OrderMsg] = []
        for aid in range(self.num_accounts):
            msgs.append(self.create_account(aid))
            msgs.append(self.create_transfer(
                aid, self._normal_param(500 * 100, 250 * 100)))
        i = 0
        while i < self.num_symbols / 2 + 1:  # float bound, exchange_test.js:29
            msgs.append(self.create_symbol(i))
            i += 1
        return msgs

    def gen_event(self) -> OrderMsg:
        e = self._uniform(1000)
        if e == 0:
            return self.create_symbol(self._uniform(self.num_symbols))
        if e == 1:
            return self.create_payout(
                self._uniform(self.num_symbols), self._uniform(2) == 0)
        if e in (2, 3):
            return self.create_transfer(
                self._uniform(self.num_accounts), self._normal_param(0, 125 * 100))
        if 3 < e <= 335:
            return self.create_buy(
                self._uniform(self.num_accounts), self._uniform(self.num_symbols),
                self._normal_param(50, 10), self._normal_param(50, 10))
        if 335 < e <= 667:
            return self.create_sell(
                self._uniform(self.num_accounts), self._uniform(self.num_symbols),
                self._normal_param(50, 10), self._normal_param(50, 10))
        return self.create_cancel()

    def stream(self, num_events: int, include_preamble: bool = True
               ) -> Iterator[OrderMsg]:
        if include_preamble:
            yield from self.preamble()
        for _ in range(num_events):
            yield self.gen_event()


def harness_stream(num_events: int = 100_000, seed: int = 0,
                   num_accounts: int = 10, num_symbols: int = 3,
                   rake: int = 3, payout_opcode_bug: bool = True,
                   validate: bool = False) -> List[OrderMsg]:
    """The full reference harness workload: preamble + num_events random
    events (exchange_test.js:23-36 with the default knobs :18-20)."""
    gen = WorkloadGen(num_accounts, num_symbols, rake, seed,
                      payout_opcode_bug, validate)
    return list(gen.stream(num_events))


def zipf_symbol_stream(num_events: int, num_symbols: int, num_accounts: int,
                       seed: int = 0, zipf_a: float = 1.2,
                       deposit: int = 10_000_000,
                       payout_per_mille: int = 0) -> List[OrderMsg]:
    """Scale workload: Zipf-skewed symbol arrival over many
    symbols/accounts, valid-domain prices/sizes. payout_per_mille > 0
    mixes in real PAYOUT barriers (each immediately followed by a re-ADD
    of the settled symbol so its lane stays live)."""
    gen = WorkloadGen(num_accounts, num_symbols, seed=seed, validate=True,
                      payout_opcode_bug=False)
    msgs: List[OrderMsg] = []
    for aid in range(num_accounts):
        msgs.append(gen.create_account(aid))
        msgs.append(gen.create_transfer(aid, deposit))
    for sid in range(num_symbols):
        msgs.append(gen.create_symbol(sid))
    # Zipf ranks over symbols, uniform accounts
    weights = [1.0 / (r + 1) ** zipf_a for r in range(num_symbols)]
    total = sum(weights)
    cdf = []
    acc = 0.0
    for w in weights:
        acc += w / total
        cdf.append(acc)
    for _ in range(num_events):
        u = gen.rng.random()
        sid = bisect.bisect_left(cdf, u)
        aid = gen._uniform(num_accounts)
        e = gen._uniform(1000)
        if e < payout_per_mille:
            msgs.append(gen.create_payout(sid, gen.rng.random() < 0.5))
            msgs.append(gen.create_symbol(sid))
        elif e < 450:
            msgs.append(gen.create_buy(aid, sid, gen._normal_param(50, 10),
                                       gen._normal_param(50, 10)))
        elif e < 900:
            msgs.append(gen.create_sell(aid, sid, gen._normal_param(50, 10),
                                        gen._normal_param(50, 10)))
        else:
            msgs.append(gen.create_cancel())
    return msgs


def deep_book_stream(depth: int, num_accounts: int = 64, sid: int = 5,
                     seed: int = 0, barrier: bool = True,
                     max_take: int = 15) -> List[OrderMsg]:
    """A hand-built stream that drives ONE symbol's book `depth` orders
    deep on its sell side (the zipf stream never gets past a few hundred):
    funded accounts and the symbol; `depth` resting sells at 60..100 and
    depth/8 resting buys at 10..40, so the k-th rest of a side lands in
    slot k; cancels of the last-rested tenth of the sells (the top rows)
    and of every 7th of the first third (holes in the low rows); rests
    into those holes; buys at 100 and sells at 5 that sweep the best
    prices, which lie scattered over all rows; with `barrier`, takers
    larger than any max_fills, a PAYOUT that wipes the book, the symbol's
    re-ADD, and rests and sweeps on the fresh book. Every size is in
    1..max_take, so an ordinary taker has at most max_take fills."""
    gen = WorkloadGen(num_accounts, sid + 1, seed=seed, validate=True,
                      payout_opcode_bug=False)
    rng = gen.rng
    msgs: List[OrderMsg] = []
    for aid in range(num_accounts):
        msgs.append(gen.create_account(aid))
        msgs.append(gen.create_transfer(aid, 100_000_000))
    msgs.append(gen.create_symbol(sid))

    def rest(n: int, buy: bool) -> List[OrderMsg]:
        make = gen.create_buy if buy else gen.create_sell
        lo, hi = (10, 40) if buy else (60, 100)
        return [make(rng.randrange(num_accounts), sid, rng.randint(lo, hi),
                     rng.randint(1, max_take)) for _ in range(n)]

    def take(n: int, size: int = 0) -> List[OrderMsg]:
        out = []
        for i in range(n):
            make, price = ((gen.create_sell, 5) if i % 8 == 7
                           else (gen.create_buy, 100))
            out.append(make(rng.randrange(num_accounts), sid, price,
                            size or rng.randint(1, max_take)))
        return out

    def cancel(m: OrderMsg) -> OrderMsg:
        return OrderMsg(action=op.CANCEL, oid=m.oid, aid=m.aid)

    sells = rest(depth, buy=False)
    msgs += sells + rest(depth // 8, buy=True)
    msgs += [cancel(m) for m in reversed(sells[depth - depth // 10:])]
    msgs += [cancel(m) for m in sells[:depth // 3:7]]
    msgs += rest(depth // 20, buy=False) + take(depth // 20)
    if barrier:
        msgs += take(8, size=40 * max_take)
        msgs.append(gen.create_payout(sid, True))
        msgs.append(gen.create_symbol(sid))
        msgs += rest(depth // 10, buy=False) + rest(depth // 40, buy=True)
        msgs += take(depth // 40)
    return msgs
