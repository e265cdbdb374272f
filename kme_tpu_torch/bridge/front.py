"""kme-torch-front: the multi-leader front door.

The port of `kme_tpu/bridge/front.py`: the same assignment, split,
merge, parity and produce links, byte for byte, so either package's
groups can be fed by the other's front. The native acceptor is the
copied kme_front.cpp; the Python paths run only under KME_NATIVE=0.

PAPER.md §7's scale-out shape: symbols are independent books with
exactly one cross-symbol coupling (account balances), so the symbol
space partitions across N leader/standby groups. This module is the
seam between "one stream" and "N groups":

- **Assignment** — rendezvous (highest-random-weight) hashing over a
  shared splitmix64 mixer maps `abs(sid) -> group` (orders, symbol
  lifecycle) and `aid -> home group` (balance custody). The C++
  columnar twin is `kme_group_assign` (native/kme_router.cpp); the two
  are bit-identical and pinned by tests/test_torch_front.py.
- **Split** — `GroupRouter.route_line` turns one MatchIn line into
  per-group substream lines. The original line lands on exactly ONE
  group; everything else it emits is *internal plumbing* marked with
  `prev == XFER_MARK` (a value no organic stream carries — oids from
  the reference harness are < 2^53):
    * CREATE_BALANCE broadcasts marked copies to the non-home groups
      (every group must know the account exists),
    * a BUY/SELL whose account home differs from its symbol group gets
      a reserve→settle TRANSFER pair injected ahead of it: a debit leg
      (-grant) into the home group and a credit leg (+grant) into the
      symbol group, `grant = min(worst_case_margin, shadow_home_cash)`.
  Injected lines are ordinary durable MatchIn records in each group's
  topic, so a crash-replay regenerates the identical transfers with
  the identical `(epoch, out_seq)` stamps — the broker's idempotent
  dedup layer is the cross-shard dedup key, exactly as KIP-98
  uses it.
- **Merge** — per-group MatchOut streams concatenate in group-id order
  (≡ a stable sort on `(group, out_seq)`), with internal-marked lines
  filtered. This is THE documented global-order convention (COMPAT.md
  "Multi-leader global ordering").
- **Parity** — `oracle_partition` computes the single-leader oracle's
  output restricted to each group's assigned messages; `verify_groups`
  byte-compares a real N-group run against it. Exact whenever accounts
  stay funded at or above their worst-case open margin (all shipped
  workloads); when the shadow ledger cannot cover a grant the front
  counts a `transfer_shortfall_total` instead of guessing.

The worst-case margin bound is exact, not heuristic: checkBalance
reserves `(size + adj) * price` for buys and `(size - adj) * (100 -
price)` for sells with `adj` netting against opposite holdings, so
`size * price` (buy) / `size * (100 - price)` (sell) always dominates
the reserve. The shadow ledger debits that bound for EVERY valid order
(home or cross) and never credits fills back, so it is a conservative
lower bound on the home group's real cash.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from kme_tpu_torch import opcodes as op
from kme_tpu_torch.wire import order_json, parse_order

# distinct salts keep the symbol->group and account->group spaces
# independently balanced (same key, different map)
SALT_SYMBOL = 0x53594D42    # "SYMB"
SALT_ACCOUNT = 0x41434354   # "ACCT"

# internal-line marker: rides the POJO's pass-through `prev` pointer
# field, which the engine echoes unmodified for TRANSFER and
# CREATE_BALANCE (no book interaction ever mutates them). Outside the
# organic oid range (reference harness oids are < 2^53), so no stream
# the reference can produce collides with it.
XFER_MARK = 0x4B4D452D46524E54   # "KME-FRNT"

_MASK = (1 << 64) - 1
_INT64_MIN = -(1 << 63)
_MARK_SUB = f'"prev":{XFER_MARK}'
# records per round trip on each link in `kme-torch-front route`
# (FrontLinks.send_batch: the log and stamps of one record per trip)
_ROUTE_BATCH = 1024


def _mix64(z: int) -> int:
    """splitmix64 finalizer — bit-identical twin of mix64 in
    native/kme_router.cpp (see the warning there: assignment is part of
    the durable stream split, the two must never drift)."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def group_of(key: int, ngroups: int, salt: int) -> int:
    """Rendezvous choice: argmax over per-(key, group) scores, ties to
    the smaller group id (C++ uses strict `>` replacement)."""
    if ngroups <= 1:
        return 0
    key &= _MASK
    best, best_score = 0, -1
    for g in range(ngroups):
        score = _mix64(key ^ _mix64((salt + g) & _MASK))
        if score > best_score:
            best, best_score = g, score
    return best


def assign_groups(keys, ngroups: int, salt: int):
    """Columnar assignment over an int64 array: the native pass when
    the library is built, the vectorized numpy twin otherwise. Returns
    int32 group ids."""
    import ctypes

    import numpy as np

    from kme_tpu_torch.native import check_buffer, load_library

    keys = np.ascontiguousarray(keys, np.int64)
    out = np.zeros(len(keys), np.int32)
    if ngroups <= 1 or not len(keys):
        return out
    lib = load_library()
    if lib is not None:
        check_buffer("keys", keys, np.int64, len(keys))
        lib.kme_group_assign(
            len(keys), keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ngroups, salt,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out

    def mix(z):
        z = z + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))

    with np.errstate(over="ignore"):
        k = keys.view(np.uint64)
        scores = np.stack([
            mix(k ^ mix(np.uint64((salt + g) & _MASK)))
            for g in range(ngroups)])
    # np.argmax takes the FIRST max — same tie-break as the scalar/C++
    return scores.argmax(axis=0).astype(np.int32)


def symbol_key(sid: int) -> int:
    """The symbol identity a payout shares with its book: abs(sid),
    except INT64_MIN (un-negatable; the engines host-reject it, we just
    need a deterministic bucket)."""
    return sid if sid == _INT64_MIN or sid >= 0 else -sid


def symbol_group(sid: int, ngroups: int) -> int:
    return group_of(symbol_key(sid), ngroups, SALT_SYMBOL)


def account_group(aid: int, ngroups: int) -> int:
    return group_of(aid, ngroups, SALT_ACCOUNT)


def accept_routes(action, oid, aid, sid, ngroups: int):
    """Vectorized stateless group routing over batch columns: account
    ops (CREATE/TRANSFER) by aid under SALT_ACCOUNT; CANCEL by oid and
    everything else by symbol_key(sid) under SALT_SYMBOL — the same
    bucket route_line uses for records it has no per-oid state for, so
    duplicates and replays land identically. Returns int32 group ids.
    This is the semantics authority for the native acceptor's routing
    select (kme_front.cpp)."""
    import numpy as np

    action = np.asarray(action)
    keys = np.where(
        action == op.CANCEL, oid,
        np.where(np.asarray(sid) == _INT64_MIN, sid, np.abs(sid)))
    gsym = assign_groups(keys, ngroups, SALT_SYMBOL)
    gacct = assign_groups(np.ascontiguousarray(aid, np.int64), ngroups,
                          SALT_ACCOUNT)
    return np.where((action == op.CREATE_BALANCE)
                    | (action == op.TRANSFER), gacct, gsym).astype(
                        np.int32)


def accept_frames(buf: bytes, ngroups: int, router=None, B: int = 0):
    """The front door: one buffer of binary order frames -> (WireBatch,
    int32 group route per row, plan-or-None), taking the GIL once per
    batch. With the native library this is a single kme_front_accept
    call that validates, decodes, group-routes and — when `router` (a
    NativeSeqRouter) is given — chains kme_plan_batch to pack the
    (K, B) scan planes in the same call; `plan` is then the
    (cols, host_rejects, stacked, cnts, K) tuple with
    sched.plan_batch's exact contract. Without the library the
    byte-exact fallback is parse_frames + accept_routes (plan comes
    back None and callers use their numpy plan path, as everywhere
    else). Raises wire.WireFrameError on the first invalid frame —
    always through the Python authority, so native and fallback
    surface identical errors."""
    import numpy as np

    from kme_tpu_torch.native import load_library
    from kme_tpu_torch.wire import WireBatch, decode_frames

    lib = load_library()
    if lib is None:
        # only under KME_NATIVE=0: a failed build raises in load_library
        wb = WireBatch.parse_frames(buf)
        return wb, accept_routes(wb.action, wb.oid, wb.aid, wb.sid,
                                 ngroups), None
    pack = rh = None
    if router is not None:
        from kme_tpu_torch.native import sched as _sched

        pack, rh = _sched.ensure_pack(router), router._h
    h = lib.kme_front_new()
    try:
        rc = lib.kme_front_accept(h, buf, len(buf), ngroups,
                                  SALT_SYMBOL, SALT_ACCOUNT, pack, rh,
                                  B)
        if rc < 0:
            decode_frames(buf)  # raises the authoritative error
            raise AssertionError(
                "native rejected a buffer the authority accepts "
                f"(code {rc} at offset {lib.kme_front_err_off(h)})")
        n = int(rc)
        if n == 0:
            return WireBatch._empty(), np.zeros(0, np.int32), None
        cols = [np.ctypeslib.as_array(
            lib.kme_front_col(h, i), (n,)).copy() for i in range(8)]
        hnext = np.ctypeslib.as_array(lib.kme_front_hnext(h),
                                      (n,)).copy()
        hprev = np.ctypeslib.as_array(lib.kme_front_hprev(h),
                                      (n,)).copy()
        wb = WireBatch(n, cols, hnext, hprev)
        groups = np.ctypeslib.as_array(lib.kme_front_groups(h),
                                       (n,)).copy()
        plan = None
        if router is not None:
            from kme_tpu_torch.native import sched as _sched

            plan = _sched.collect_plan(lib, router, pack,
                                       int(lib.kme_front_plan_k(h)), B,
                                       wb.price, wb.size)
        return wb, groups, plan
    finally:
        lib.kme_front_free(h)


def make_internal_transfer(aid: int, amount: int, xid: int) -> str:
    """One leg of a reserve→settle pair: an ordinary TRANSFER wire line
    carrying the internal marker (prev) and the deterministic transfer
    ordinal (next) for post-mortem attribution."""
    return order_json(op.TRANSFER, 0, aid, 0, 0, amount,
                      next=xid, prev=XFER_MARK)


def make_internal_create(aid: int, xid: int) -> str:
    return order_json(op.CREATE_BALANCE, 0, aid, 0, 0, 0,
                      next=xid, prev=XFER_MARK)


def is_internal_line(line: str) -> bool:
    """True for front-injected plumbing — input lines AND the engine's
    IN/OUT echoes of them (the marker rides into both)."""
    return _MARK_SUB in line


class GroupRouter:
    """Stateful splitter: MatchIn lines -> per-group substream lines.

    Every decision is a pure function of the input prefix (no clock, no
    RNG), so re-running the split from offset 0 regenerates the
    byte-identical substreams — which is what makes the injected
    transfer legs replay-safe: they are durable MatchIn records in each
    group's topic, regenerated identically by any crash-replay.
    """

    def __init__(self, ngroups: int, transfers: bool = True,
                 prefund: int = 8) -> None:
        self.n = max(1, int(ngroups))
        self.transfers = transfers
        # chunked reserve→settle: each transfer pair grants up to
        # `prefund` orders' worth of worst-case margin, and the
        # UNCONSUMED remainder is tracked per (account, group) so
        # repeat cross-shard traffic rides the residual instead of
        # paying a fresh pair per order (the dominant transfer-path
        # cost — see bench_groups' transfer_frac). prefund=1 degrades
        # to exact per-order grants.
        self.prefund = max(1, int(prefund))
        self.oid_group: Dict[int, int] = {}    # oid -> routed group
        self.oid_sid: Dict[int, int] = {}      # oid -> its symbol (reshard)
        self.home: Dict[int, int] = {}         # aid -> home group
        self.cash: Dict[int, int] = {}         # aid -> shadow home cash
        self.reserve: Dict[Tuple[int, int], int] = {}  # (aid, g) -> margin
        self.xid = 0                           # injected-line ordinal
        self.counters = {
            "cross_shard_transfers_total": 0,
            "transfer_shortfall_total": 0,
            "transfer_volume_total": 0,
            "balance_broadcasts_total": 0,
        }

    def account_home(self, aid: int) -> int:
        h = self.home.get(aid)
        if h is None:
            h = account_group(aid, self.n)
            self.home[aid] = h
        return h

    def _margin_bound(self, msg) -> int:
        """Worst-case reserve of a valid order (dominates checkBalance's
        adj-netted reserve; see module docstring). 0 for orders fixed
        mode rejects before the balance check."""
        if not (0 <= msg.price < 126) or msg.size <= 0:
            return 0
        if msg.action == op.BUY:
            return msg.size * msg.price
        return msg.size * (100 - msg.price)

    def route_line(self, line: str) -> List[Tuple[int, str]]:
        """One input line -> [(group, line), ...] in substream order.
        The original line appears exactly once; every other entry is an
        internal-marked injection. Raises ValueError on malformed input
        (callers own the strict/drop decision, like the service does)."""
        msg = parse_order(line)
        a, n = msg.action, self.n
        if n <= 1:
            return [(0, line)]
        if a in (op.BUY, op.SELL):
            g = symbol_group(msg.sid, n)
            self.oid_group[msg.oid] = g
            self.oid_sid[msg.oid] = msg.sid
            h = self.account_home(msg.aid)
            out: List[Tuple[int, str]] = []
            w = self._margin_bound(msg) if self.transfers else 0
            if w > 0:
                have = self.cash.get(msg.aid, 0)
                if h != g:
                    r = self.reserve.get((msg.aid, g), 0)
                    if r >= w:
                        # residual from an earlier chunked grant covers
                        # this order outright — no legs injected
                        self.reserve[(msg.aid, g)] = r - w
                    else:
                        need = w - r
                        grant = min(have, need + (self.prefund - 1) * w)
                        if grant < need:
                            self.counters[
                                "transfer_shortfall_total"] += 1
                        self.reserve[(msg.aid, g)] = max(
                            0, r + grant - w)
                        if grant > 0:
                            self.cash[msg.aid] = have - grant
                            out.append((h, make_internal_transfer(
                                msg.aid, -grant, self.xid)))
                            out.append((g, make_internal_transfer(
                                msg.aid, grant, self.xid + 1)))
                            self.xid += 2
                            self.counters[
                                "cross_shard_transfers_total"] += 1
                            self.counters[
                                "transfer_volume_total"] += grant
                else:
                    # a home-group order consumes home cash directly —
                    # debit the shadow too, or a later grant could
                    # exceed what the home engine really holds
                    self.cash[msg.aid] = have - min(w, have)
            out.append((g, line))
            return out
        if a == op.CANCEL:
            g = self.oid_group.get(msg.oid)
            if g is None:
                # unknown oid: the engine rejects it wherever it lands —
                # pick the bucket its oid hashes to so duplicates and
                # replays route identically
                g = group_of(msg.oid, n, SALT_SYMBOL)
            return [(g, line)]
        if a == op.CREATE_BALANCE:
            h = self.account_home(msg.aid)
            self.cash.setdefault(msg.aid, 0)
            out = []
            for g in range(n):
                if g == h:
                    out.append((g, line))
                else:
                    out.append((g, make_internal_create(msg.aid,
                                                        self.xid)))
                    self.xid += 1
                    self.counters["balance_broadcasts_total"] += 1
            return out
        if a == op.TRANSFER:
            h = self.account_home(msg.aid)
            # deposits raise the shadow; withdrawals lower it (clamped —
            # the engine never lets a balance go negative)
            self.cash[msg.aid] = max(
                0, self.cash.get(msg.aid, 0) + msg.size)
            return [(h, line)]
        # symbol lifecycle (and unknown actions, which every engine
        # rejects): bucket by symbol identity
        return [(symbol_group(msg.sid, n), line)]

    def split(self, lines: Iterable[str]) -> List[List[str]]:
        """Whole-stream convenience: per-group substream line lists."""
        per: List[List[str]] = [[] for _ in range(self.n)]
        for line in lines:
            for g, ln in self.route_line(line):
                per[g].append(ln)
        return per

    def reshard(self, m: int) -> dict:
        """Re-point this router at an M-group topology IN PLACE,
        carrying the split state across the boundary (live N→M
        re-splitting). Matches what the reshard
        coordinator does to the engines at the same barrier:

        - resting orders follow their symbol: `oid -> group` remaps via
          `symbol_group(oid_sid[oid], m)` (a CANCEL for a pre-reshard
          order must land where the coordinator moved its book);
        - account custody remaps to `account_group(aid, m)`;
        - the coordinator consolidates EVERY account's full cash at its
          new home (bridge/reshard.py settlement legs), so unconsumed
          reserve residuals parked at old symbol groups fold back into
          home shadow cash — the shadow stays a conservative lower
          bound on the new home engine's real balance.

        Deterministic (pure function of prior routing state + m), so a
        replay of the same prefix + the same reshard barrier regenerates
        byte-identical post-reshard substreams. Returns a summary of
        moved keys for reports."""
        m = max(1, int(m))
        old_n, moved_oids, moved_homes = self.n, 0, 0
        for oid, g in list(self.oid_group.items()):
            sid = self.oid_sid.get(oid)
            ng = (symbol_group(sid, m) if sid is not None
                  else group_of(oid, m, SALT_SYMBOL))
            if ng != g:
                moved_oids += 1
            self.oid_group[oid] = ng
        for aid, h in list(self.home.items()):
            nh = account_group(aid, m)
            if nh != h:
                moved_homes += 1
            self.home[aid] = nh
        for (aid, _g), r in self.reserve.items():
            if r > 0:
                self.cash[aid] = self.cash.get(aid, 0) + r
        self.reserve.clear()
        self.n = m
        return {"old_groups": old_n, "new_groups": m,
                "moved_oids": moved_oids, "moved_homes": moved_homes,
                "tracked_oids": len(self.oid_group),
                "tracked_accounts": len(self.home)}


def split_lines(lines: Iterable[str], ngroups: int,
                transfers: bool = True, prefund: int = 8):
    """(per_group substreams, the router that built them)."""
    router = GroupRouter(ngroups, transfers=transfers, prefund=prefund)
    return router.split(lines), router


def merge_records(records: Iterable[Tuple[int, int, str]]) -> List[str]:
    """THE global-order convention (COMPAT.md): stable sort on
    `(group, out_seq)`, internal-marked lines dropped. `records` may
    arrive in any interleaving — per-group consumers race — and the
    result is identical."""
    recs = sorted(records, key=lambda r: (r[0], r[1]))
    return [r[2] for r in recs if not is_internal_line(r[2])]


def merge_streams(per_group: Sequence[Sequence[str]]) -> List[str]:
    """Merge per-group MatchOut streams already in per-group order:
    concatenation in group-id order ≡ merge_records with out_seq = the
    line's index in its group stream."""
    out: List[str] = []
    for lines in per_group:
        out.extend(ln for ln in lines if not is_internal_line(ln))
    return out


def oracle_partition(lines: Sequence[str], ngroups: int,
                     compat: str = "fixed",
                     book_slots: Optional[int] = None,
                     max_fills: Optional[int] = None,
                     transfers: bool = True, prefund: int = 8):
    """Single-leader ground truth, partitioned by the front's own
    assignment: per_group[g] is the single oracle's output stream
    restricted to the messages the front routes to g. Returns
    (per_group expected wire lines, the GroupRouter used). The injected
    internal legs have no expected lines — their echoes are suppressed
    on merge."""
    from kme_tpu_torch.oracle import OracleEngine

    router = GroupRouter(ngroups, transfers=transfers, prefund=prefund)
    eng = OracleEngine(compat, book_slots, max_fills)
    per: List[List[str]] = [[] for _ in range(max(1, ngroups))]
    for line in lines:
        routed = router.route_line(line)
        prim = [g for g, ln in routed if not is_internal_line(ln)]
        assert len(prim) == 1, "input line carries the internal marker"
        per[prim[0]].extend(
            rec.wire() for rec in eng.process(parse_order(line)))
    return per, router


def verify_groups(lines: Sequence[str],
                  actual_per_group: Sequence[Sequence[str]],
                  compat: str = "fixed",
                  book_slots: Optional[int] = None,
                  max_fills: Optional[int] = None,
                  prefund: int = 8) -> dict:
    """Byte-compare an N-group run against the partitioned single-leader
    oracle. `actual_per_group[g]` is group g's raw MatchOut lines
    (internal echoes still present — filtered here). Returns a report;
    report["ok"] is the parity verdict."""
    ngroups = len(actual_per_group)
    want, router = oracle_partition(lines, ngroups, compat=compat,
                                    book_slots=book_slots,
                                    max_fills=max_fills,
                                    prefund=prefund)
    report: dict = {"groups": ngroups, "ok": True, "mismatches": [],
                    "counters": dict(router.counters)}
    for g in range(ngroups):
        got = [ln for ln in actual_per_group[g]
               if not is_internal_line(ln)]
        if got == want[g]:
            continue
        report["ok"] = False
        n = min(len(got), len(want[g]))
        div = next((i for i in range(n) if got[i] != want[g][i]), n)
        report["mismatches"].append({
            "group": g, "at": div, "got_lines": len(got),
            "want_lines": len(want[g]),
            "got": got[div] if div < len(got) else None,
            "want": want[g][div] if div < len(want[g]) else None})
    merged = merge_streams(actual_per_group)
    report["merged_lines"] = len(merged)
    report["expected_merged_lines"] = sum(len(w) for w in want)
    return report


def oracle_partition_reshard(lines: Sequence[str], n: int, m: int,
                             split_at: int, compat: str = "fixed",
                             book_slots: Optional[int] = None,
                             max_fills: Optional[int] = None,
                             transfers: bool = True, prefund: int = 8):
    """Ground truth for a live N→M reshard at a batch barrier: ONE
    single-leader oracle processes the whole stream, and its output is
    partitioned by the routed group of each message — `lines[:split_at]`
    under the N-topology router, `lines[split_at:]` under the SAME
    router re-pointed at M groups (`GroupRouter.reshard`, mirroring the
    coordinator's state migration). Because resharding is pure topology
    (COMPAT.md), the oracle's wire bytes are untouched; only their
    group attribution changes. Returns (pre_per_group[n],
    post_per_group[m], router)."""
    from kme_tpu_torch.oracle import OracleEngine

    split_at = max(0, min(int(split_at), len(lines)))
    router = GroupRouter(n, transfers=transfers, prefund=prefund)
    eng = OracleEngine(compat, book_slots, max_fills)
    pre: List[List[str]] = [[] for _ in range(max(1, n))]
    post: List[List[str]] = [[] for _ in range(max(1, m))]
    for i, line in enumerate(lines):
        if i == split_at:
            router.reshard(m)
        routed = router.route_line(line)
        prim = [g for g, ln in routed if not is_internal_line(ln)]
        assert len(prim) == 1, "input line carries the internal marker"
        dest = pre if i < split_at else post
        dest[prim[0]].extend(
            rec.wire() for rec in eng.process(parse_order(line)))
    if split_at >= len(lines) and router.n != max(1, m):
        router.reshard(m)
    return pre, post, router


def verify_groups_reshard(lines: Sequence[str], split_at: int,
                          actual_pre: Sequence[Sequence[str]],
                          actual_post: Sequence[Sequence[str]],
                          compat: str = "fixed",
                          book_slots: Optional[int] = None,
                          max_fills: Optional[int] = None,
                          prefund: int = 8) -> dict:
    """Byte-compare a live N→M reshard run against the partitioned
    single-leader oracle: `actual_pre[g]` is old-generation group g's
    raw MatchOut lines (everything it emitted before the barrier
    drained it), `actual_post[g]` the new generation's. Internal-marked
    echoes — including the coordinator's settlement legs — are filtered
    before comparison, exactly like `verify_groups`. report["ok"] is
    the parity verdict across BOTH generations."""
    n, m = len(actual_pre), len(actual_post)
    want_pre, want_post, router = oracle_partition_reshard(
        lines, n, m, split_at, compat=compat, book_slots=book_slots,
        max_fills=max_fills, prefund=prefund)
    report: dict = {"old_groups": n, "new_groups": m,
                    "split_at": int(split_at), "ok": True,
                    "mismatches": [],
                    "counters": dict(router.counters)}
    for gen, want, actual in (("pre", want_pre, actual_pre),
                              ("post", want_post, actual_post)):
        for g in range(len(want)):
            got = [ln for ln in actual[g] if not is_internal_line(ln)]
            if got == want[g]:
                continue
            report["ok"] = False
            k = min(len(got), len(want[g]))
            div = next((i for i in range(k) if got[i] != want[g][i]), k)
            report["mismatches"].append({
                "generation": gen, "group": g, "at": div,
                "got_lines": len(got), "want_lines": len(want[g]),
                "got": got[div] if div < len(got) else None,
                "want": want[g][div] if div < len(want[g]) else None})
    report["merged_lines"] = (len(merge_streams(actual_pre))
                              + len(merge_streams(actual_post)))
    report["expected_merged_lines"] = (
        sum(len(w) for w in want_pre) + sum(len(w) for w in want_post))
    return report


class FrontLinks:
    """Front-door produce links to per-group `kme-torch-serve` brokers over
    real TCP (bridge/tcp.py) — the multi-host half of the front.

    One `TcpBroker` client per group. Link g's produces into its
    MatchIn topic carry a monotone per-link `out_seq` cursor, which is
    exactly the broker's idempotent dedup key: on a transport
    fault the client invalidates the connection, reconnects on the next
    call, and re-sends the SAME stamped record — if the first attempt
    actually landed before the link died, the durable watermark
    suppresses the copy. That is reconnect-with-resume off the
    `(epoch, out_seq)` cursor with zero duplicate records.

    The live front leaves `epoch=None` (a sequence-only stamp): the
    broker's fence is BROKER-WIDE and owned by the serving leader's
    lease epoch, so a front-door epoch would either get fenced or —
    worse — advance the fence under the leader. The reshard
    coordinator, which runs while no leader is up, is the one caller
    that passes an epoch (it stamps settlement legs at epoch 1 on the
    fresh logs, below any future leader's lease). Exactly one stamping
    front per group topic: the cursor is a per-topic watermark, not a
    per-producer one."""

    def __init__(self, addrs: Sequence, topic_fmt: str = "MatchIn.g{g}",
                 epoch: Optional[int] = None, timeout: float = 10.0,
                 provision: bool = True, retries: int = 8,
                 backoff_s: float = 0.05,
                 cursors: Optional[Sequence[int]] = None) -> None:
        from kme_tpu_torch.bridge.tcp import parse_addr

        self.addrs = [parse_addr(a) if isinstance(a, str)
                      else (a[0], int(a[1])) for a in addrs]
        self.n = len(self.addrs)
        self.topics = [topic_fmt.format(g=g) for g in range(self.n)]
        self.epoch = epoch
        self._timeout = timeout
        self._provision = provision
        self._retries = max(1, int(retries))
        self._backoff = backoff_s
        self.cursor = ([int(c) for c in cursors] if cursors is not None
                       else [0] * self.n)
        if len(self.cursor) != self.n:
            raise ValueError("cursors must match the address count")
        self._clients: List[Optional[object]] = [None] * self.n
        self.health = [{"addr": f"{h}:{p}", "topic": self.topics[g],
                        "connects": 0, "transport_faults": 0,
                        "produced": 0, "dup_suppressed": 0,
                        "overload_waits": 0, "last_error": None}
                       for g, (h, p) in enumerate(self.addrs)]

    def _client(self, g: int):
        if self._clients[g] is None:
            from kme_tpu_torch.bridge.broker import BrokerError
            from kme_tpu_torch.bridge.tcp import TcpBroker

            c = TcpBroker(*self.addrs[g], timeout=self._timeout)
            if self._provision:
                try:
                    c.create_topic(self.topics[g])
                except BrokerError:
                    pass    # already provisioned
            self._clients[g] = c
            self.health[g]["connects"] += 1
        return self._clients[g]

    def send(self, g: int, line: str) -> int:
        """Produce one substream line on link g with the next cursor
        stamp; retries transport faults and overload pushback with the
        same stamp. Returns the broker offset (-1 when the dedup
        watermark swallowed a replayed copy). BrokerFenced propagates —
        it is a topology verdict, not a link fault."""
        return self._produce(g, 1, lambda c, seq: c.produce(
            self.topics[g], None, line, epoch=self.epoch, out_seq=seq))

    def send_batch(self, g: int, lines: Sequence[str]) -> int:
        """`send` for many lines in one round trip: line i carries the
        stamp cursor + i, and the broker dedups each stamp on its own,
        so a retried batch whose prefix already landed (a transport
        fault, or overload pushback mid-batch) appends only the rest.
        The log is the one a loop of `send` writes. Returns the last
        record's offset (-1 when its stamp was a replay)."""
        lines = list(lines)
        if not lines:
            return -1
        return self._produce(g, len(lines), lambda c, seq: c.produce_batch(
            self.topics[g], [(None, ln, self.epoch, seq + i)
                             for i, ln in enumerate(lines)]))

    def _produce(self, g: int, n: int, call) -> int:
        """Run `call(client, first stamp)` for n records on link g with
        the retry policy of `send`; the cursor advances by n once it
        succeeds."""
        import time as _time

        from kme_tpu_torch.bridge.broker import (BrokerError, BrokerFenced,
                                                 BrokerOverload)

        h = self.health[g]
        seq = self.cursor[g]
        last: Optional[Exception] = None
        for attempt in range(self._retries):
            try:
                off = call(self._client(g), seq)
            except BrokerOverload as e:
                h["overload_waits"] += 1
                back = getattr(e, "backoff_ms", None)
                _time.sleep((back or 50) / 1000.0)
                last = e
                continue
            except BrokerFenced:
                raise
            except (BrokerError, OSError) as e:
                # transport fault (or the serve is still coming up — the
                # client connects eagerly, so a refused connect surfaces
                # as a raw OSError): the client invalidates itself and
                # reconnects on the next call; the retry re-sends the
                # SAME (epoch, out_seq) records, so an attempt that
                # landed before the fault dedups instead of duplicating
                h["transport_faults"] += 1
                h["last_error"] = str(e)
                last = e
                _time.sleep(self._backoff * (attempt + 1))
                continue
            self.cursor[g] = seq + n
            h["produced"] += n
            if off < 0:
                h["dup_suppressed"] += 1
            return off
        raise (last if last is not None else
               BrokerError(f"link {g}: produce failed"))

    def route(self, router: GroupRouter,
              line: str) -> List[Tuple[int, int]]:
        """Split one MatchIn line through `router` and produce every
        substream record on its group link. Returns [(group, offset)]."""
        return [(g, self.send(g, ln))
                for g, ln in router.route_line(line)]

    def end_offsets(self) -> List[int]:
        """Per-link topic end offsets (drain-barrier probe)."""
        return [self._client(g).end_offset(self.topics[g])
                for g in range(self.n)]

    def snapshot(self) -> dict:
        """Per-link health + cursors, for reports and health files."""
        return {"groups": self.n, "epoch": self.epoch,
                "cursors": list(self.cursor),
                "links": [dict(h) for h in self.health]}

    def close(self) -> None:
        for c in self._clients:
            if c is not None:
                try:
                    c.close()
                except OSError:
                    pass
        self._clients = [None] * self.n


def write_front_trace(path: str, lines: Sequence[str], ngroups: int,
                      transfers: bool = True, prefund: int = 8) -> int:
    """Record the front door's own trace spans: one front_accept and
    one route span per input line, stamped with the order's GLOBAL
    deterministic trace id and its routed (group, local index) — the
    anchor `kme-torch-trace --cluster` joins group-side spans against. Spans
    are zero-width position marks (the split is a deterministic
    function, not a runtime hop); what matters is the identity they
    carry. Returns the number of spans written."""
    import time

    from kme_tpu_torch.telemetry.dtrace import route_map
    from kme_tpu_torch.telemetry.journal import Journal

    entries, _router = route_map(lines, ngroups, transfers=transfers,
                                 prefund=prefund)
    now = time.time_ns() // 1000
    spans = []
    for ent in entries:
        if ent is None:
            continue
        base = {"g": -1, "off": ent["off"], "oid": ent["oid"],
                "aid": ent["aid"], "tid": ent["tid"], "ptid": 0,
                "t0": now, "t1": now, "li": ent["li"]}
        spans.append(dict(base, kind="front_accept"))
        spans.append(dict(base, kind="route", g=ent["g"],
                          ptid=ent["tid"]))
    j = Journal(path, resume=False)
    try:
        j.record_spans(spans)
    finally:
        j.close()
    return len(spans)


# -- CLI ---------------------------------------------------------------


def _read_lines(path: Optional[str]):
    fh = sys.stdin if path in (None, "-") else open(path)
    try:
        return [ln.strip() for ln in fh if ln.strip()]
    finally:
        if fh is not sys.stdin:
            fh.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="kme-torch-front",
        description="multi-leader front door: split a MatchIn stream "
                    "into per-group substreams (with cross-shard "
                    "balance-transfer injection), merge per-group "
                    "MatchOut streams into the canonical global feed, "
                    "or verify an N-group run against the single-leader "
                    "oracle")
    p.add_argument("mode", choices=("split", "merge", "verify", "route"))
    p.add_argument("--groups", type=int, required=True, metavar="N")
    p.add_argument("--brokers", default=None, metavar="H:P,H:P,...",
                   help="route: comma-separated per-group broker "
                        "addresses (group k feeds the k-th address over "
                        "real TCP with reconnect-with-resume off the "
                        "idempotent out_seq cursor)")
    p.add_argument("--input", default=None, metavar="PATH",
                   help="order-JSONL input stream (default stdin; "
                        "split and verify)")
    p.add_argument("--out-dir", default=None, metavar="DIR",
                   help="split: write group{K}.in substream files here")
    p.add_argument("--in-dir", default=None, metavar="DIR",
                   help="merge/verify: read group{K}.out per-group "
                        "MatchOut line files from here")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="split: record front_accept/route trace spans "
                        "(deterministic per-order trace ids, "
                        "telemetry/dtrace.py) to this journal; "
                        "kme-torch-trace --cluster reads it as "
                        "<state-root>/front.trace")
    p.add_argument("--no-transfers", action="store_true",
                   help="split symbols only; skip balance-transfer "
                        "injection (parity then requires every account "
                        "to be funded in every group)")
    p.add_argument("--compat", choices=("java", "fixed"),
                   default="fixed", help="oracle compat for verify")
    p.add_argument("--slots", type=int, default=None,
                   help="capacity envelope for verify (match the "
                        "serving engines' --slots)")
    p.add_argument("--max-fills", type=int, default=None)
    p.add_argument("--tsdb", default=None, metavar="DIR",
                   help="route: sample the per-link routing counters "
                        "into the shared on-disk time-series store "
                        "every 1000 routed lines (source 'front')")
    p.add_argument("--prefund", type=int, default=8,
                   help="orders' worth of worst-case margin granted "
                        "per reserve->settle transfer pair (residual "
                        "tracked per account x group; 1 = exact "
                        "per-order grants)")
    args = p.parse_args(argv)
    import json

    n = args.groups
    if n < 1:
        p.error("--groups must be >= 1")
    if args.mode == "split":
        lines = _read_lines(args.input)
        per, router = split_lines(lines, n,
                                  transfers=not args.no_transfers,
                                  prefund=args.prefund)
        if args.out_dir is None:
            p.error("split needs --out-dir")
        os.makedirs(args.out_dir, exist_ok=True)
        for g in range(n):
            with open(os.path.join(args.out_dir,
                                   f"group{g}.in"), "w") as f:
                f.write("\n".join(per[g]) + ("\n" if per[g] else ""))
        if args.trace_out is not None:
            write_front_trace(args.trace_out, lines, n,
                              transfers=not args.no_transfers,
                              prefund=args.prefund)
        doc = {"groups": n, "input_lines": len(lines),
               "per_group": [len(x) for x in per]}
        doc.update(router.counters)
        print(json.dumps(doc), file=sys.stderr)
        return 0
    if args.mode == "route":
        if args.brokers is None:
            p.error("route needs --brokers")
        addrs = [a for a in args.brokers.split(",") if a]
        if len(addrs) != n:
            p.error(f"--brokers lists {len(addrs)} addresses for "
                    f"--groups {n}")
        lines = _read_lines(args.input)
        router = GroupRouter(n, transfers=not args.no_transfers,
                             prefund=args.prefund)
        links = FrontLinks(addrs)
        tsdb = None
        tsdb_seq = 0
        if args.tsdb is not None:
            from kme_tpu_torch.telemetry import TSDB

            try:
                tsdb = TSDB(args.tsdb, source="front")
                tsdb_seq = tsdb.next_seq()
            except (OSError, ValueError) as e:
                print(f"kme-torch-front: TSDB disabled: {e}",
                      file=sys.stderr)

        def _tsdb_sample(routed):
            nonlocal tsdb, tsdb_seq
            if tsdb is None:
                return
            snap = links.snapshot()
            vals = {"front_routed_lines_total": routed,
                    "front_epoch": snap["epoch"]}
            for g, cur in enumerate(snap["cursors"]):
                vals[f"front_cursor.g{g}"] = cur
            for g, h in enumerate(snap["links"]):
                for hk, hv in h.items():
                    if isinstance(hv, (int, float)) \
                            and not isinstance(hv, bool):
                        vals[f"front_{hk}.g{g}"] = hv
            try:
                tsdb.append_values(vals, tsdb_seq)
                tsdb_seq += 1
            except OSError:
                tsdb = None     # history is best-effort

        pend: List[List[str]] = [[] for _ in range(n)]

        def _flush(g):
            links.send_batch(g, pend[g])
            pend[g] = []

        try:
            for i, line in enumerate(lines):
                for g, ln in router.route_line(line):
                    pend[g].append(ln)
                    if len(pend[g]) == _ROUTE_BATCH:
                        _flush(g)
                if (i + 1) % 1000 == 0:
                    # the front door is a batch process, not a serve
                    # loop: history samples ride routing progress
                    # instead of wall-clock heartbeats
                    _tsdb_sample(i + 1)
            for g in range(n):
                _flush(g)
        finally:
            doc = links.snapshot()
            doc["input_lines"] = len(lines)
            doc.update(router.counters)
            _tsdb_sample(len(lines))
            if tsdb is not None:
                tsdb.close()
            print(json.dumps(doc), file=sys.stderr)
            links.close()
        return 0
    if args.in_dir is None:
        p.error(f"{args.mode} needs --in-dir")
    per_out = []
    for g in range(n):
        path = os.path.join(args.in_dir, f"group{g}.out")
        per_out.append(_read_lines(path) if os.path.exists(path) else [])
    if args.mode == "merge":
        for ln in merge_streams(per_out):
            print(ln)
        return 0
    # verify
    lines = _read_lines(args.input)
    report = verify_groups(lines, per_out, compat=args.compat,
                           book_slots=args.slots,
                           max_fills=args.max_fills,
                           prefund=args.prefund)
    print(json.dumps(report, indent=2), file=sys.stderr)
    print(f"kme-torch-front: parity "
          f"{'OK' if report['ok'] else 'DIVERGED'}", file=sys.stderr)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
