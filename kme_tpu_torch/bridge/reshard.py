"""Live N→M group re-splitting: the reshard coordinator.

The port of `kme_tpu/bridge/reshard.py`: host code over oracle
snapshots, byte for byte the same plan, legs and `reshard.json`.

A grouped deployment fixes its group count at startup; this module makes the topology
breathe. The life of a reshard (drain → fence → migrate → settle →
resume) is split so every step is either PURE or IDEMPOTENT, and a
coordinator SIGKILL at any byte re-runs to the identical result:

- **Drain** is the caller's job (the chaos drill, an operator): stop
  feeding, wait until every old group's heartbeat offset reaches its
  substream end, let the serves `--idle-exit` cleanly. The coordinator
  only ever touches checkpoints of STOPPED groups — a batch barrier,
  exactly like the paper's device step boundary.
- **Fence** steals each old group's lease (bridge/lease.py) and appends
  one stamped tombstone to a `Retired` topic in the old broker log.
  The broker's fence is recovered from log stamps, so the tombstone
  makes the re-fence DURABLE: any zombie leader replaying its old
  epoch against the retired log raises BrokerFenced forever after.
- **Migrate** is a pure function: load every old group's oracle
  snapshot, partition the five stores by the NEW rendezvous topology
  (`partition_engines` — the canonical codec is the checkpoint codec,
  runtime/checkpoint.py), write each new group's snapshot at offset 0.
  Balances are NOT copied: every new engine gets a zero balance for
  every known account (the CREATE-broadcast invariant), and the per
  account totals come back as...
- **Settle**: one internal-marked TRANSFER leg per account, stamped
  `(epoch, out_seq)` and produced straight into the new home group's
  durable MatchIn log over the fenced idempotent produce path. Stamps
  are a deterministic function of the consolidation map, so a crashed
  settle re-runs byte-identically and the broker watermark suppresses
  every leg that already landed — transfers are exactly-once across
  any number of coordinator deaths. The serving side counts them into
  the `pending_reserve` checkpoint ledger like any other cross-shard
  leg (bridge/service.py).

Ordering matters once: settle stamps epoch 1 (after the coordinator's
own lease acquire) and the first new leader acquires epoch >= 2 and
fences the broker BROKER-WIDE — so the coordinator must finish before
the new generation starts. The journal (reshard.json, fsync'd after
every phase) records where a dead coordinator got to; `run()` resumes
from there and refuses topologies that do not match it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from kme_tpu_torch.bridge.front import (account_group, make_internal_transfer,
                                  symbol_group)

JOURNAL = "reshard.json"
RETIRED_TOPIC = "Retired"
# settlement xids live far outside the front door's injected-line
# ordinals (router.xid counts from 0) so post-mortem attribution can
# tell a migration leg from an organic reserve->settle leg
XID_BASE = 1 << 40


def rendezvous_minimal_frac(n: int, m: int) -> float:
    """Expected moved-key fraction of a minimal (rendezvous) N→M
    re-split over a uniform key space: growing to a superset of group
    ids moves a key iff its argmax lands on a NEW id — (m-n)/m; a merge
    moves the keys whose old argmax disappeared — (n-m)/n."""
    n, m = max(1, int(n)), max(1, int(m))
    if m >= n:
        return (m - n) / m
    return (n - m) / n


def plan_reshard(n: int, m: int, symbols: Sequence[int],
                 accounts: Sequence[int]) -> dict:
    """Deterministic re-split plan over explicit key universes: which
    symbols change their book's group, which accounts change custody,
    and the headline `moved_key_frac` the multihost bench gates against
    the rendezvous-minimal expectation (a consistent-hashing regression
    — e.g. a salt drift remapping everything — shows up here as
    moved_key_frac ≈ 1)."""
    moved_symbols = [int(s) for s in symbols
                     if symbol_group(s, n) != symbol_group(s, m)]
    moved_accounts = [int(a) for a in accounts
                      if account_group(a, n) != account_group(a, m)]
    total = len(symbols) + len(accounts)
    moved = len(moved_symbols) + len(moved_accounts)
    return {
        "old_groups": int(n), "new_groups": int(m),
        "symbols": len(symbols), "accounts": len(accounts),
        "moved_symbols": moved_symbols,
        "moved_accounts": moved_accounts,
        "moved_key_frac": (moved / total) if total else 0.0,
        "rendezvous_minimal_frac": rendezvous_minimal_frac(n, m),
    }


def partition_engines(engines: Sequence, m: int):
    """The canonical state codec of a reshard: old fixed-mode oracle
    engines -> (new_engines[m], consolidation {aid: total cash}).

    Books, buckets, resting orders and positions follow their symbol to
    `symbol_group(sid, m)` — each symbol's state lives in exactly one
    old engine, so the move is a disjoint re-bucketing, byte-identical
    values. Balances are deliberately NOT moved here: every new engine
    gets a zero balance for every account either generation has ever
    seen (the CREATE-broadcast invariant — margin releases and fill
    credits at a symbol group need the key to exist), and the summed
    cash comes back as the consolidation map for `settlement_legs`.

    Fixed-mode only: java mode's Q11 garbage position keys make
    symbol attribution ill-defined (COMPAT.md), and grouped serving is
    a fixed-mode deployment anyway."""
    from kme_tpu_torch.oracle import OracleEngine

    m = max(1, int(m))
    for eng in engines:
        if eng.java:
            raise ValueError("reshard surgery is fixed-mode only "
                             "(java position keys are untyped, Q11)")
    slots = engines[0].book_slots if engines else None
    fills = engines[0].max_fills if engines else None
    new = [OracleEngine("fixed", slots, fills) for _ in range(m)]
    consolidation: Dict[int, int] = {}
    for eng in engines:
        for aid, bal in eng.balances.items():
            consolidation[aid] = consolidation.get(aid, 0) + bal
        for bk, bits in eng.books.items():
            # fixed-mode book key is 2*sid + side (engine.py codec)
            new[symbol_group(bk // 2, m)].books[bk] = bits
        for bkt, ptrs in eng.buckets.items():
            # bucket key is book_key*256 + price, price in [0, 126)
            new[symbol_group((bkt // 256) // 2, m)].buckets[bkt] = ptrs
        for oid, rec in eng.orders.items():
            new[symbol_group(rec.sid, m)].orders[oid] = rec.copy()
        for key, pos in eng.positions.items():
            new[symbol_group(key[1], m)].positions[key] = pos
    for aid in consolidation:
        for eng in new:
            eng.balances[aid] = 0
    return new, consolidation


def settlement_legs(consolidation: Dict[int, int],
                    m: int) -> List[List]:
    """Deterministic settlement plan: one internal-marked TRANSFER
    crediting each account's consolidated cash at its NEW home group.
    Entries are [group, out_seq, xid, aid, amount, line]; out_seq is
    the leg's position within its group's MatchIn stamp sequence —
    replay-stable, so a re-run regenerates identical stamps and the
    broker dedups instead of doubling."""
    per_seq = [0] * max(1, int(m))
    legs: List[List] = []
    for i, aid in enumerate(sorted(consolidation)):
        amount = consolidation[aid]
        if amount <= 0:
            continue        # engine balances are never negative
        g = account_group(aid, m)
        xid = XID_BASE + i
        legs.append([g, per_seq[g], xid, aid, amount,
                     make_internal_transfer(aid, amount, xid)])
        per_seq[g] += 1
    return legs


def probe_fenced(gdir: str, epoch: int = 1) -> bool:
    """Post-mortem stale-epoch probe against a retired group's durable
    broker log: True when a produce at `epoch` raises BrokerFenced
    (the re-fence held). Never appends: an unfenced probe's stamp
    collides with the tombstone's watermark and is dedup-suppressed."""
    from kme_tpu_torch.bridge.broker import (BrokerError, BrokerFenced,
                                       InProcessBroker)

    log_dir = os.path.join(gdir, "broker-log")
    b = InProcessBroker(persist_dir=log_dir)
    try:
        b.produce(RETIRED_TOPIC, None, "probe", epoch=epoch, out_seq=0)
    except BrokerFenced:
        return True
    except BrokerError:
        return False    # tombstone topic missing: fence never ran
    return False


class ReshardCoordinator:
    """Journaled fence → migrate → settle executor over STOPPED groups.

    `old_root`/`new_root` are supervisor state roots (group k at
    <root>/group{k}); every phase is recorded in <new_root>/reshard.json
    with an fsync before the next phase starts, so a coordinator killed
    at any point re-runs to the identical end state: fence re-steals
    (epochs only grow), migrate is a pure overwrite of offset-0
    snapshots, and settle's stamped legs dedup on the broker watermark.
    """

    def __init__(self, old_root: str, new_root: str, old_groups: int,
                 new_groups: int, clock=None) -> None:
        self.old_root, self.new_root = old_root, new_root
        self.n, self.m = int(old_groups), int(new_groups)
        if self.n < 1 or self.m < 1:
            raise ValueError("group counts must be >= 1")
        self.journal_path = os.path.join(new_root, JOURNAL)
        # injected clock (zero-arg seconds float) stamps the phase
        # events and measures the phase walls; the sim passes its
        # virtual clock so the timeline digest stays seed-stable
        if clock is None:
            import time as _time

            clock = _time.time
        self._clock = clock

    def _old_dir(self, k: int) -> str:
        return os.path.join(self.old_root, f"group{k}")

    def _new_dir(self, k: int) -> str:
        return os.path.join(self.new_root, f"group{k}")

    def _load_journal(self) -> dict:
        try:
            with open(self.journal_path, encoding="utf-8") as f:
                j = json.load(f)
        except (OSError, ValueError):
            return {}
        if (j.get("old_root") != self.old_root
                or j.get("new_root") != self.new_root
                or j.get("old_groups") != self.n
                or j.get("new_groups") != self.m):
            raise ValueError(
                f"{self.journal_path} records a different reshard "
                f"({j.get('old_groups')}→{j.get('new_groups')}); "
                f"refusing to mix topologies")
        return j

    def _save_journal(self, j: dict) -> None:
        os.makedirs(self.new_root, exist_ok=True)
        tmp = self.journal_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(j, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.journal_path)

    # -- phases --------------------------------------------------------

    def _fence_old(self) -> dict:
        from kme_tpu_torch.bridge import lease
        from kme_tpu_torch.bridge.broker import BrokerError, InProcessBroker

        out = {"stolen_epochs": [], "done": True}
        for k in range(self.n):
            gdir = self._old_dir(k)
            prev = lease.current_epoch(gdir)
            epoch = lease.steal(gdir)
            log_dir = os.path.join(gdir, "broker-log")
            if os.path.isdir(log_dir):
                b = InProcessBroker(persist_dir=log_dir)
                try:
                    b.create_topic(RETIRED_TOPIC)
                except BrokerError:
                    pass
                # durable re-fence: the tombstone's epoch stamp is
                # recovered into the broker-wide fence on every future
                # reload of this log (re-runs dedup on out_seq 0)
                b.produce(RETIRED_TOPIC, None,
                          json.dumps({"retired_by": "reshard",
                                      "new_root": self.new_root,
                                      "epoch": epoch}),
                          epoch=epoch, out_seq=0)
                b.sync()
            out["stolen_epochs"].append({"group": k, "prev": prev,
                                         "epoch": epoch})
        return out

    def _migrate(self) -> Tuple[dict, List[List]]:
        from kme_tpu_torch.runtime import checkpoint as ck

        engines, offsets = [], []
        for k in range(self.n):
            eng, off = ck.load_oracle(self._old_dir(k))
            if eng is None:
                raise ValueError(
                    f"no oracle snapshot in {self._old_dir(k)} — "
                    f"reshard needs cleanly drained old groups")
            engines.append(eng)
            offsets.append(off)
        new_engines, consolidation = partition_engines(engines, self.m)
        zero = {"legs": 0, "credits": 0, "debits": 0, "rejected": 0,
                "broadcasts": 0}
        for k, eng in enumerate(new_engines):
            gdir = self._new_dir(k)
            os.makedirs(gdir, exist_ok=True)
            ck.save_oracle(gdir, eng, 0,
                           extra={"epoch": 0, "out_seq": 0,
                                  "pending_reserve": dict(zero)})
        legs = settlement_legs(consolidation, self.m)
        plan = plan_reshard(
            self.n, self.m,
            sorted({bk // 2 for e in engines for bk in e.books}),
            sorted(consolidation))
        info = {"done": True, "old_offsets": offsets,
                "accounts": len(consolidation),
                "cash_total": sum(consolidation.values()),
                "per_group": [
                    {"orders": len(e.orders), "books": len(e.books),
                     "positions": len(e.positions)}
                    for e in new_engines],
                "plan": plan, "legs": legs}
        return info, legs

    def _settle(self, legs: List[List],
                kill_after_legs: Optional[int] = None) -> dict:
        import signal

        from kme_tpu_torch.bridge import lease
        from kme_tpu_torch.bridge.broker import BrokerError, InProcessBroker

        armed = (kill_after_legs is not None
                 and os.environ.get("KME_TEST_HOOKS") == "1")
        produced = suppressed = 0
        epochs = []
        for k in range(self.m):
            gdir = self._new_dir(k)
            # the coordinator's own lease grant: settle stamps ride
            # this epoch, and the first new leader's acquire lands
            # strictly above it — its broker-wide fence then retires
            # any still-running coordinator instead of racing it
            epoch = lease.acquire(gdir)
            epochs.append(epoch)
            log_dir = os.path.join(gdir, "broker-log")
            os.makedirs(log_dir, exist_ok=True)
            b = InProcessBroker(persist_dir=log_dir)
            try:
                b.create_topic(f"MatchIn.g{k}")
            except BrokerError:
                pass
            for g, seq, _xid, _aid, _amt, line in legs:
                if g != k:
                    continue
                off = b.produce(f"MatchIn.g{k}", None, line,
                                epoch=epoch, out_seq=seq)
                if off < 0:
                    suppressed += 1
                produced += 1
                if armed and produced >= kill_after_legs:
                    # the drill's mid-migration SIGKILL: a real kill -9
                    # of the coordinator process, nothing staged
                    os.kill(os.getpid(), signal.SIGKILL)
            b.sync()
        return {"done": True, "legs": produced,
                "dup_suppressed": suppressed, "epochs": epochs,
                "resume_cursors": [
                    sum(1 for leg in legs if leg[0] == k)
                    for k in range(self.m)]}

    # one canonical ordinal per coordinator phase: the flight-recorder
    # event seq IS the ordinal (durable identity, never a counter), so
    # a SIGKILL'd coordinator's re-run re-emits every completed phase
    # and the log's replay dedup keeps the first copy — the merged
    # timeline shows each phase exactly once however many times the
    # coordinator died (the reshard-under-storm drill asserts this)
    PHASES = ("fence", "migrate", "settle", "done")

    def _phase_event(self, evlog, phase: str, j: dict) -> None:
        info = j.get(phase) or {}
        offsets = (j.get("migrate") or {}).get("old_offsets") or []
        detail = {"old_groups": self.n, "new_groups": self.m}
        wall = (j.get("walls") or {}).get(f"{phase}_s")
        if wall is not None:
            detail["wall_s"] = wall
        epoch = None
        if phase == "fence":
            detail["stolen"] = [e["epoch"] for e in
                                info.get("stolen_epochs", [])]
            epoch = max(detail["stolen"], default=None)
        elif phase == "migrate":
            detail["accounts"] = info.get("accounts")
            detail["moved_key_frac"] = (info.get("plan") or {}).get(
                "moved_key_frac")
        elif phase == "settle":
            detail["legs"] = info.get("legs")
            detail["dup_suppressed"] = info.get("dup_suppressed")
            epoch = max(info.get("epochs", []), default=None)
        try:
            evlog.emit(f"reshard.{phase}",
                       seq=self.PHASES.index(phase), epoch=epoch,
                       offset=(max(offsets) if offsets
                               and phase != "fence" else None),
                       **{k: v for k, v in detail.items()
                          if v is not None})
        except Exception:
            pass    # the recorder never blocks a reshard

    def run(self, kill_after_legs: Optional[int] = None) -> dict:
        from kme_tpu_torch.telemetry import events as cpevents

        os.makedirs(self.new_root, exist_ok=True)
        evlog = cpevents.open_log(self.new_root, "reshard",
                                  clock=self._clock)
        j = self._load_journal()
        j.update({"old_root": self.old_root, "new_root": self.new_root,
                  "old_groups": self.n, "new_groups": self.m})
        # per-phase walls (reshard_pause_ms decomposed): each phase
        # that RUNS in this incarnation records its wall into the
        # journal; a completed phase's wall survives a coordinator
        # SIGKILL via the journal, so the final document always carries
        # the wall of the run that actually did the work
        walls = j.setdefault("walls", {})
        if not j.get("fence", {}).get("done"):
            t0 = self._clock()
            j["fence"] = self._fence_old()
            walls["fence_s"] = round(self._clock() - t0, 6)
            self._save_journal(j)
        self._phase_event(evlog, "fence", j)
        if not j.get("migrate", {}).get("done"):
            t0 = self._clock()
            info, legs = self._migrate()
            j["migrate"] = info
            walls["migrate_s"] = round(self._clock() - t0, 6)
            self._save_journal(j)
        else:
            legs = j["migrate"]["legs"]
        self._phase_event(evlog, "migrate", j)
        if not j.get("settle", {}).get("done"):
            t0 = self._clock()
            j["settle"] = self._settle(legs,
                                       kill_after_legs=kill_after_legs)
            walls["settle_s"] = round(self._clock() - t0, 6)
            self._save_journal(j)
        self._phase_event(evlog, "settle", j)
        j["done"] = True
        self._save_journal(j)
        self._phase_event(evlog, "done", j)
        evlog.close()
        return j


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="kme-torch-reshard",
        description="re-split N stopped leader groups into M: fence the "
                    "old epochs, migrate book/position state through "
                    "the checkpoint codec, settle balances with stamped "
                    "exactly-once transfer legs, journal every phase")
    p.add_argument("--old-root", required=True,
                   help="supervisor state root of the drained old "
                        "generation (group k at <root>/group{k})")
    p.add_argument("--new-root", required=True,
                   help="state root the new generation will start from")
    p.add_argument("--old-groups", type=int, required=True, metavar="N")
    p.add_argument("--new-groups", type=int, required=True, metavar="M")
    p.add_argument("--test-kill-after-legs", type=int, default=None,
                   metavar="J",
                   help="chaos hook (armed only under KME_TEST_HOOKS=1):"
                        " SIGKILL this process after producing J "
                        "settlement legs — the drill's crash-during-"
                        "migration fault")
    args = p.parse_args(argv)
    try:
        coord = ReshardCoordinator(args.old_root, args.new_root,
                                   args.old_groups, args.new_groups)
        j = coord.run(kill_after_legs=args.test_kill_after_legs)
    except (ValueError, OSError) as e:
        print(f"kme-torch-reshard: {e}", file=sys.stderr)
        return 2
    doc = {k: j[k] for k in ("old_groups", "new_groups", "done")
           if k in j}
    doc["moved_key_frac"] = j.get("migrate", {}).get(
        "plan", {}).get("moved_key_frac")
    doc["legs"] = j.get("settle", {}).get("legs")
    doc["resume_cursors"] = j.get("settle", {}).get("resume_cursors")
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
