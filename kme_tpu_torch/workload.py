"""Workload generation — a seeded port of the reference's e2e load
generator (exchange_test.js).

The port's own copy of `WorkloadGen`, `harness_stream`,
`zipf_symbol_stream`, `zipf_hot_stream`, `payout_storm_stream`,
`cancel_heavy_stream`, `cross_account_stream`, the five storm profiles
(`STORM_PROFILES`, `storm_stream`, `storm_windows`) and
`spliced_stream` from `kme_tpu/workload.py`: for a seed they yield the
same streams, and the profiles the same burst windows
(tests/test_torch_port.py holds them equal), so the port's smoke run,
chaos harness and benchmarks need no `kme_tpu` import.

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
from typing import Callable, Iterator, List, NamedTuple, Sequence, Tuple

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


def _funded(gen: WorkloadGen, num_accounts: int, num_symbols: int,
            deposit: int) -> List[OrderMsg]:
    """The scale profiles' preamble: every account created and funded
    with `deposit`, then every symbol added."""
    msgs: List[OrderMsg] = []
    for aid in range(num_accounts):
        msgs.append(gen.create_account(aid))
        msgs.append(gen.create_transfer(aid, deposit))
    for sid in range(num_symbols):
        msgs.append(gen.create_symbol(sid))
    return msgs


def _zipf_cdf(n: int, zipf_a: float) -> List[float]:
    """Cumulative Zipf weights over ranks 0..n-1."""
    weights = [1.0 / (r + 1) ** zipf_a for r in range(n)]
    total = sum(weights)
    cdf = []
    acc = 0.0
    for w in weights:
        acc += w / total
        cdf.append(acc)
    return cdf


def _trade_or_cancel(gen: WorkloadGen, aid: int, sid: int,
                     e: int) -> OrderMsg:
    """The scale profiles' event mix per mille `e`: 450 buys, 450 sells,
    100 cancels."""
    if e < 450:
        return gen.create_buy(aid, sid, gen._normal_param(50, 10),
                              gen._normal_param(50, 10))
    if e < 900:
        return gen.create_sell(aid, sid, gen._normal_param(50, 10),
                               gen._normal_param(50, 10))
    return gen.create_cancel()


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
    msgs = _funded(gen, num_accounts, num_symbols, deposit)
    # Zipf ranks over symbols, uniform accounts
    cdf = _zipf_cdf(num_symbols, zipf_a)
    for _ in range(num_events):
        u = gen.rng.random()
        sid = bisect.bisect_left(cdf, u)
        aid = gen._uniform(num_accounts)
        e = gen._uniform(1000)
        if e < payout_per_mille:
            msgs.append(gen.create_payout(sid, gen.rng.random() < 0.5))
            msgs.append(gen.create_symbol(sid))
        else:
            msgs.append(_trade_or_cancel(gen, aid, sid, e))
    return msgs


def zipf_hot_stream(num_events: int, num_symbols: int, num_accounts: int,
                    seed: int = 0, hot_frac: float = 0.7,
                    zipf_a: float = 1.2,
                    deposit: int = 10_000_000) -> List[OrderMsg]:
    """Adversarial profile for static sharding: ONE hot book. Symbol 0
    takes `hot_frac` of all events outright; the remainder is
    Zipf-distributed over symbols 1..n-1, so there is a distinctly WARM
    second-ranked book — the shape that defeats `lane % shards`
    placement twice over (the hot symbol saturates its shard AND the
    static hash co-locates the warm book with it, which an elastic
    planner migrates away). Seed-deterministic."""
    if num_symbols < 2:
        raise ValueError("zipf-hot needs >= 2 symbols (hot + cold set)")
    gen = WorkloadGen(num_accounts, num_symbols, seed=seed, validate=True,
                      payout_opcode_bug=False)
    msgs = _funded(gen, num_accounts, num_symbols, deposit)
    cdf = _zipf_cdf(num_symbols - 1, zipf_a)
    for _ in range(num_events):
        if gen.rng.random() < hot_frac:
            sid = 0
        else:
            sid = 1 + bisect.bisect_left(cdf, gen.rng.random())
        aid = gen._uniform(num_accounts)
        msgs.append(_trade_or_cancel(gen, aid, sid, gen._uniform(1000)))
    return msgs


def payout_storm_stream(num_events: int, num_symbols: int,
                        num_accounts: int, seed: int = 0,
                        storms: int = 3,
                        deposit: int = 10_000_000) -> List[OrderMsg]:
    """Mass-settlement burst profile: steady Zipf trading punctuated by
    `storms` evenly-spaced bursts in which EVERY symbol is paid out
    (real PAYOUT opcode) and immediately re-ADDed. Each payout is a
    barrier window in the fleet's planner, so the profile stresses the
    flush/rebind path and collapses then rebuilds every book at once.
    Seed-deterministic."""
    if storms < 1:
        raise ValueError("payout-storm needs storms >= 1")
    gen = WorkloadGen(num_accounts, num_symbols, seed=seed, validate=True,
                      payout_opcode_bug=False)
    msgs = _funded(gen, num_accounts, num_symbols, deposit)
    cdf = _zipf_cdf(num_symbols, 1.2)
    storm_at = {max(1, (i + 1) * num_events // (storms + 1))
                for i in range(storms)}
    for k in range(num_events):
        if k in storm_at:
            for sid in range(num_symbols):
                msgs.append(gen.create_payout(sid,
                                              gen.rng.random() < 0.5))
                msgs.append(gen.create_symbol(sid))
            continue
        sid = bisect.bisect_left(cdf, gen.rng.random())
        aid = gen._uniform(num_accounts)
        msgs.append(_trade_or_cancel(gen, aid, sid, gen._uniform(1000)))
    return msgs


def _buy_or_sell(gen: WorkloadGen, aid: int, sid: int) -> OrderMsg:
    """A buy or a sell, one chance in two, at N(50, 10) price and size."""
    make = gen.create_buy if gen.rng.random() < 0.5 else gen.create_sell
    return make(aid, sid, gen._normal_param(50, 10), gen._normal_param(50, 10))


def cancel_heavy_stream(num_events: int, num_symbols: int, num_accounts: int,
                        seed: int = 0, cancel_ratio: float = 0.8,
                        deposit: int = 10_000_000) -> List[OrderMsg]:
    """BASELINE.md's bursty cancel/replace config: attempts a cancel with
    probability cancel_ratio whenever the open-order pool is non-empty.
    Steady-state cancels are structurally bounded near 50% of events (each
    cancel consumes one prior resting submit), matching the reference
    harness's own cancel-vs-submit equilibrium (exchange_test.js:106-117)."""
    gen = WorkloadGen(num_accounts, num_symbols, seed=seed, validate=True)
    msgs = _funded(gen, num_accounts, num_symbols, deposit)
    for _ in range(num_events):
        if gen.rng.random() < cancel_ratio and gen.open_orders:
            msgs.append(gen.create_cancel())
        else:
            aid = gen._uniform(num_accounts)
            sid = gen._uniform(num_symbols)
            msgs.append(_buy_or_sell(gen, aid, sid))
    return msgs


def cross_account_stream(num_events: int, num_symbols: int,
                         num_accounts: int, ngroups: int,
                         seed: int = 0, cross_frac: float = 0.5,
                         zipf_a: float = 1.2,
                         deposit: int = 10_000_000) -> List[OrderMsg]:
    """Transfer-path sizing profile for the multi-leader topology
    (bridge/front.py): Zipf-skewed symbol arrival where a configurable
    fraction of orders is FORCED onto a non-home account — an account
    whose home group (rendezvous hash of aid) differs from the order's
    symbol group — so every such order costs the front door a
    reserve->settle transfer pair. cross_frac=1.0 is the degenerate
    worst case (100% cross-shard). Seed-deterministic; with ngroups=1
    there are no non-home accounts and the stream degenerates to plain
    Zipf traffic."""
    from kme_tpu_torch.bridge.front import account_group, symbol_group

    gen = WorkloadGen(num_accounts, num_symbols, seed=seed, validate=True,
                      payout_opcode_bug=False)
    msgs = _funded(gen, num_accounts, num_symbols, deposit)
    # account pools keyed by home group: same[g] lives on g, cross[g]
    # anywhere else (empty pools fall back to the full range)
    same = {g: [] for g in range(ngroups)}
    cross = {g: [] for g in range(ngroups)}
    for aid in range(num_accounts):
        h = account_group(aid, ngroups)
        for g in range(ngroups):
            (same if g == h else cross)[g].append(aid)
    cdf = _zipf_cdf(num_symbols, zipf_a)
    for _ in range(num_events):
        sid = bisect.bisect_left(cdf, gen.rng.random())
        g = symbol_group(sid, ngroups)
        pool = cross[g] if gen.rng.random() < cross_frac else same[g]
        aid = (pool[gen._uniform(len(pool))] if pool
               else gen._uniform(num_accounts))
        msgs.append(_trade_or_cancel(gen, aid, sid, gen._uniform(1000)))
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


# ---------------------------------------------------------------------------
# adversarial storm profiles. Each is a pure function of its arguments;
# its burst windows are absolute message-index ranges offered at a
# multiple of the base pacing (wire messages carry no timestamps, so rate
# lives in the producer). The chaos harness paces with these windows; the
# overload controller's simulation (bridge/broker.py simulate_overload)
# replays the same windows. Every profile opens with `_funded`'s flat
# preamble of 2*accounts + symbols messages, so the windows follow from
# the profile's arguments alone.


def _preamble_len(num_accounts: int, num_symbols: int) -> int:
    return 2 * num_accounts + num_symbols


def _burst_ranges(num_events: int, bursts: int,
                  frac: float) -> List[Tuple[int, int]]:
    """`bursts` evenly-spaced event-index ranges, each ~frac of the
    stream (the same arithmetic shape as payout_storm_stream's
    storm_at, so window placement is deterministic)."""
    width = max(1, int(num_events * frac))
    out: List[Tuple[int, int]] = []
    for i in range(bursts):
        c = (i + 1) * num_events // (bursts + 1)
        lo = max(0, c - width // 2)
        out.append((lo, min(num_events, lo + width)))
    return out


def _settle_all(gen: WorkloadGen, num_symbols: int,
                success=None) -> List[OrderMsg]:
    """A PAYOUT of every symbol, each followed by its re-ADD; a coin
    flip per symbol decides the side unless `success` is given."""
    msgs: List[OrderMsg] = []
    for sid in range(num_symbols):
        ok = gen.rng.random() < 0.5 if success is None else success
        msgs.append(gen.create_payout(sid, ok))
        msgs.append(gen.create_symbol(sid))
    return msgs


def payout_storm_wide_stream(num_events: int, num_symbols: int,
                             num_accounts: int, seed: int = 0,
                             deposit: int = 10_000_000) -> List[OrderMsg]:
    """The event boundary itself: steady Zipf trading until ONE contiguous
    burst settles the ENTIRE symbol space (real PAYOUT per symbol, each
    immediately re-ADDed). At full scale that is ~1k symbols' worth of
    barrier ops arriving back-to-back — the all-at-once settlement shape
    KProcessor.java:148-165 implies but the reference harness never
    generates. One message per steady event, so the storm block sits at
    exactly preamble + num_events//2."""
    gen = WorkloadGen(num_accounts, num_symbols, seed=seed, validate=True,
                      payout_opcode_bug=False)
    msgs = _funded(gen, num_accounts, num_symbols, deposit)
    cdf = _zipf_cdf(num_symbols, 1.2)
    storm_k = max(1, num_events // 2)
    for k in range(num_events):
        if k == storm_k:
            msgs += _settle_all(gen, num_symbols)
        sid = bisect.bisect_left(cdf, gen.rng.random())
        aid = gen._uniform(num_accounts)
        msgs.append(_trade_or_cancel(gen, aid, sid, gen._uniform(1000)))
    return msgs


def flash_crowd_stream(num_events: int, num_symbols: int,
                       num_accounts: int, seed: int = 0,
                       bursts: int = 3, burst_frac: float = 0.08,
                       hot_frac: float = 0.9,
                       deposit: int = 10_000_000) -> List[OrderMsg]:
    """Flash crowd: a breaking-news spike. Outside the burst windows the
    stream is ordinary Zipf trading; inside them everyone piles onto
    symbol 0 (probability hot_frac), the order mix collapses to pure
    buy/sell (nobody cancels during a rush), and the flow comes from a
    small flooder clique (num_accounts//8 accounts) — the per-account
    fairness adversary. The producer offers these windows at ~100x
    pacing (storm_windows), which is what makes it a rate storm."""
    gen = WorkloadGen(num_accounts, num_symbols, seed=seed, validate=True,
                      payout_opcode_bug=False)
    msgs = _funded(gen, num_accounts, num_symbols, deposit)
    cdf = _zipf_cdf(num_symbols, 1.2)
    ranges = _burst_ranges(num_events, bursts, burst_frac)
    flooders = max(1, num_accounts // 8)
    for k in range(num_events):
        if any(lo <= k < hi for lo, hi in ranges):
            sid = (0 if gen.rng.random() < hot_frac
                   else bisect.bisect_left(cdf, gen.rng.random()))
            msgs.append(_buy_or_sell(gen, gen._uniform(flooders), sid))
            continue
        sid = bisect.bisect_left(cdf, gen.rng.random())
        aid = gen._uniform(num_accounts)
        msgs.append(_trade_or_cancel(gen, aid, sid, gen._uniform(1000)))
    return msgs


def cancel_storm_stream(num_events: int, num_symbols: int,
                        num_accounts: int, seed: int = 0,
                        cancel_ratio: float = 0.75,
                        bogus_frac: float = 0.85,
                        deposit: int = 10_000_000) -> List[OrderMsg]:
    """Cancel blizzard (HFT quote-stuffing shape): ~3/4 of events are
    cancels, and most of those target oids that were never submitted —
    driving the engine's rej_cancel ratio to ~10x the reference
    harness's steady state. The remaining events are fresh buy/sell
    flow, so cancels and new orders arrive interleaved — the stream the
    priority-aware shedder must split (cancels drain the book: admit;
    new orders grow it: shed)."""
    gen = WorkloadGen(num_accounts, num_symbols, seed=seed, validate=True,
                      payout_opcode_bug=False)
    msgs = _funded(gen, num_accounts, num_symbols, deposit)
    for _ in range(num_events):
        if gen.rng.random() < cancel_ratio:
            if gen.rng.random() < bogus_frac or not gen.open_orders:
                # a cancel for an oid nobody submitted: always rej_cancel
                msgs.append(OrderMsg(
                    action=op.CANCEL,
                    oid=math.floor(gen.rng.random() * (2 ** 53 - 1)),
                    aid=gen._uniform(num_accounts)))
            else:
                msgs.append(gen.create_cancel())
            continue
        aid = gen._uniform(num_accounts)
        sid = gen._uniform(num_symbols)
        msgs.append(_buy_or_sell(gen, aid, sid))
    return msgs


def hot_book_stream(num_events: int, num_symbols: int,
                    num_accounts: int, seed: int = 0,
                    hot_frac: float = 0.97,
                    deposit: int = 10_000_000) -> List[OrderMsg]:
    """One-symbol pathology: hot_frac of ALL flow lands on symbol 0 with
    a tight price band (N(50, 3) — nearly every arrival crosses), and
    cancels are rare so the book only deepens. Unlike zipf-hot there is
    no warm cold-set for a rebalancer to migrate: a single book takes
    the whole storm, which no symbol-sharding layout can split — the
    overload controller is the only defense left."""
    if num_symbols < 2:
        raise ValueError("hot-book needs >= 2 symbols (hot + background)")
    gen = WorkloadGen(num_accounts, num_symbols, seed=seed, validate=True,
                      payout_opcode_bug=False)
    msgs = _funded(gen, num_accounts, num_symbols, deposit)
    for _ in range(num_events):
        sid = (0 if gen.rng.random() < hot_frac
               else 1 + gen._uniform(num_symbols - 1))
        aid = gen._uniform(num_accounts)
        e = gen._uniform(1000)
        if e < 950:
            make = gen.create_buy if e < 475 else gen.create_sell
            msgs.append(make(aid, sid, gen._normal_param(50, 3),
                             gen._normal_param(50, 10)))
        else:
            msgs.append(gen.create_cancel())
    return msgs


def liquidation_cascade_stream(num_events: int, num_symbols: int,
                               num_accounts: int, seed: int = 0,
                               cascades: int = 2,
                               deposit: int = 40_000) -> List[OrderMsg]:
    """Balance-exhaustion cascade: accounts are funded thinly (~16
    orders' margin), the mix is buy-heavy so margin locks up fast, and
    at each cascade point EVERY symbol is settled long-side (PAYOUT
    success=True, then re-ADDed) while orders are still resting — the
    mass-liquidation-against-open-interest interaction. Losers come out
    of each cascade with exhausted balances, so the post-cascade flow
    turns into a rej_risk wave. One message per steady event: cascade
    block c sits at exactly preamble + (c+1)*num_events//(cascades+1)
    + 2*num_symbols*c."""
    if cascades < 1:
        raise ValueError("liquidation-cascade needs cascades >= 1")
    gen = WorkloadGen(num_accounts, num_symbols, seed=seed, validate=True,
                      payout_opcode_bug=False)
    msgs = _funded(gen, num_accounts, num_symbols, deposit)
    cdf = _zipf_cdf(num_symbols, 1.2)
    cascade_at = {max(1, (i + 1) * num_events // (cascades + 1))
                  for i in range(cascades)}
    for k in range(num_events):
        if k in cascade_at:
            msgs += _settle_all(gen, num_symbols, success=True)
        sid = bisect.bisect_left(cdf, gen.rng.random())
        aid = gen._uniform(num_accounts)
        e = gen._uniform(1000)
        if e < 900:
            make = gen.create_buy if e < 650 else gen.create_sell
            msgs.append(make(aid, sid, gen._normal_param(50, 10),
                             gen._normal_param(50, 10)))
        else:
            msgs.append(gen.create_cancel())
    return msgs


class StormProfile(NamedTuple):
    """Registry row: generator + full-scale defaults + burst windows.

    windows(num_events, num_symbols, num_accounts) returns absolute
    message-index ranges [(lo, hi, mult), ...]: offer messages in
    [lo, hi) at mult x the base pacing."""

    name: str
    summary: str
    symbols: int
    accounts: int
    fn: Callable[..., List[OrderMsg]]
    windows: Callable[[int, int, int], List[Tuple[int, int, int]]]


def _w_payout_wide(ev: int, sy: int, ac: int) -> List[Tuple[int, int, int]]:
    lo = _preamble_len(ac, sy) + max(1, ev // 2)
    return [(lo, lo + 2 * sy, 100)]


def _w_flash_crowd(ev: int, sy: int, ac: int) -> List[Tuple[int, int, int]]:
    pre = _preamble_len(ac, sy)
    return [(pre + lo, pre + hi, 100)
            for lo, hi in _burst_ranges(ev, 3, 0.08)]


def _w_cancel_storm(ev: int, sy: int, ac: int) -> List[Tuple[int, int, int]]:
    pre = _preamble_len(ac, sy)
    return [(pre + lo, pre + hi, 20)
            for lo, hi in _burst_ranges(ev, 2, 0.10)]


def _w_hot_book(ev: int, sy: int, ac: int) -> List[Tuple[int, int, int]]:
    pre = _preamble_len(ac, sy)
    return [(pre + lo, pre + hi, 10)
            for lo, hi in _burst_ranges(ev, 1, 0.20)]


def _w_cascade(ev: int, sy: int, ac: int) -> List[Tuple[int, int, int]]:
    pre = _preamble_len(ac, sy)
    out = []
    for c in range(2):
        lo = pre + max(1, (c + 1) * ev // 3) + 2 * sy * c
        out.append((lo, lo + 2 * sy + max(1, ev // 20), 50))
    return out


STORM_PROFILES = {
    "payout-storm-wide": StormProfile(
        "payout-storm-wide",
        "settle the entire symbol space (~1k symbols) in one contiguous "
        "PAYOUT+re-ADD burst mid-stream",
        1000, 64, payout_storm_wide_stream, _w_payout_wide),
    "flash-crowd": StormProfile(
        "flash-crowd",
        "100x-rate burst windows where a small flooder clique piles "
        "onto one symbol (per-account fairness adversary)",
        64, 64, flash_crowd_stream, _w_flash_crowd),
    "cancel-storm": StormProfile(
        "cancel-storm",
        "~75% cancels, mostly for never-submitted oids: rej_cancel at "
        "~10x the reference harness ratio, interleaved with fresh flow",
        16, 32, cancel_storm_stream, _w_cancel_storm),
    "hot-book": StormProfile(
        "hot-book",
        "97% of flow on ONE tight-priced symbol — the pathology no "
        "symbol-sharding layout can split",
        8, 32, hot_book_stream, _w_hot_book),
    "liquidation-cascade": StormProfile(
        "liquidation-cascade",
        "thin funding + buy-heavy flow, then mass long-side settlement "
        "against open interest: a rej_risk exhaustion wave",
        32, 48, liquidation_cascade_stream, _w_cascade),
}


def storm_stream(name: str, num_events: int, *, num_symbols: int = None,
                 num_accounts: int = None, seed: int = 0) -> List[OrderMsg]:
    """Generate a named storm profile (registry defaults unless the
    caller scales symbols/accounts down, e.g. for CI)."""
    p = STORM_PROFILES[name]
    return p.fn(num_events,
                p.symbols if num_symbols is None else num_symbols,
                p.accounts if num_accounts is None else num_accounts,
                seed=seed)


def storm_windows(name: str, num_events: int, num_symbols: int = None,
                  num_accounts: int = None) -> List[Tuple[int, int, int]]:
    """Burst windows for a named profile at the given scale: absolute
    message-index ranges [(lo, hi, mult), ...]."""
    p = STORM_PROFILES[name]
    return p.windows(num_events,
                     p.symbols if num_symbols is None else num_symbols,
                     p.accounts if num_accounts is None else num_accounts)


def spliced_stream(num_events: int, seed: int = 0,
                   splices: Sequence[Tuple[int, str, int]] = (),
                   num_accounts: int = 10,
                   num_symbols: int = 3,
                   prefund_cash: int = 0) -> List[OrderMsg]:
    """Generative scenario composition: the reference harness baseline
    with named storm bursts spliced in at stream positions. `splices` is
    [(at, profile, n), ...] — insert an `n`-event `profile` burst
    (STORM_PROFILES) before baseline position `at`. Bursts keep their
    registry symbol/account spaces, so a spliced storm brings its own
    preamble and collides with the baseline's id space only where the
    registry says it does; everything stays a pure function of
    (num_events, seed, splices), which is what lets a shrunk fault
    schedule regenerate its input byte-identically.

    `prefund_cash` > 0 prepends a CREATE_BALANCE + TRANSFER(cash) pair
    for every account the composed stream can touch (baseline space ∪
    spliced profiles' registry spaces). Grouped serving's parity
    contract requires the funded envelope — the front's shadow-cash
    margin bound is a conservative LOWER bound that never models
    releases, so a depleted account can see a cross-shard grant fall
    short and the group engine reject what the single oracle accepts
    (`transfer_shortfall_total`). The deposits ride IN the stream, seen
    identically by the oracle and the cluster."""
    base = harness_stream(num_events, seed=seed,
                          num_accounts=num_accounts,
                          num_symbols=num_symbols)
    # apply back-to-front so earlier positions stay valid
    for at, name, n in sorted(splices, key=lambda s: s[0], reverse=True):
        burst = storm_stream(name, n, seed=seed ^ 0x5EED)
        at = max(0, min(len(base), int(at)))
        base[at:at] = burst
    if prefund_cash > 0:
        space = max([num_accounts]
                    + [STORM_PROFILES[name].accounts
                       for _, name, _ in splices])
        base[0:0] = [m for aid in range(space)
                     for m in (OrderMsg(action=op.CREATE_BALANCE,
                                        aid=aid),
                               OrderMsg(action=op.TRANSFER, aid=aid,
                                        size=int(prefund_cash)))]
    return base
