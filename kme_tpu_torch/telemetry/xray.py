"""Time-travel state inspection, divergence bisection and live
watchpoints (kme-torch-xray).

The port's copy of `kme_tpu/telemetry/xray.py`. Replays run through the
port's own oracle, broker log reader and snapshot loaders, so either
package's durable logs and snapshots anchor here. `cluster_cut` re-runs
the multi-leader front's `GroupRouter`, which the port does not have
yet: it raises naming it.

The engine is a deterministic state machine over a durable input log
(the SMR framing): any historical state is `nearest retained snapshot
<= target offset` + `replay of the MatchIn tail` — so "what was
account 7's balance at offset 90_000" is a query, not an archaeology
project. Three tools share that primitive:

* **materialize(log_dir, at, ...)** — offset-addressed state. Anchors
  on the nearest snapshot (any kind: .pkl oracle snapshots restore the
  exact engine; .npz canonical snapshots restore into a SeqSession and
  are adopted by `OracleEngine.from_export`), replays the durable
  MatchIn log forward through the Python oracle with the service's
  exact drop policy, and answers point queries (`balance`, `book`,
  `order`) — optionally entered through a Dapper-style trace id
  (`resolve_trace`, scanning the deterministic dtrace id space).

* **bisect(journal, log_dir, ...)** — first-divergent-batch search.
  The journal is the engine's *claimed* history; the oracle replay of
  the input log is the *truth*. When they disagree (an audit violation,
  a KME_AUDIT_TAMPER drill, a real engine bug), binary-search the
  batch boundary where canonical state projections first differ:
  O(log N) oracle replays, each anchored on the nearest checkpoint at
  or below the current known-good watermark (so checkpoints written
  *after* a real divergence can never mask it). Emits a minimized
  repro in the audit.py format plus the exact field-level diff;
  `replay_bisect_repro` re-derives the same diff offline.

* **WatchEngine** — live watchpoints. A tiny deterministic predicate
  grammar (`balance[AID]<0`, `position[AID,SID]>X`, `depth[SID]>=N`,
  `spread[SID]==0`) evaluated at batch barriers against an
  InvariantAuditor shadow ledger fed from the batch's own output
  lines. Pure functions of exported state — no clock, no RNG
  (kme-lint's WATCH_SCOPES enforces it) — so two seeded runs fire
  identical (offset, predicate) hit sets. Hits write bounded
  TriggerCapture-compatible `capture_NNN.json` files carrying the
  offset, the batch's trace exemplars and the `kme-torch-xray` one-liner
  that reproduces the hit offline. Watchpoints never gate admission
  and never touch MatchOut bytes (COMPAT.md).

Cluster mode (`cluster_cut`) materializes every group of a multi-group
run at a consistent cut — per-group local offsets derived by re-running
the front's deterministic router over the merged input prefix — and
checks global cash conservation (balances + open-order margin, with the
router's unconsumed `pending_reserve` residuals reported) byte-for-byte
against the single-leader oracle at the same merge watermark.
"""

from __future__ import annotations

import json
import os
import re
import sys
from typing import Dict, List, Optional, Sequence, Tuple

_J = dict(sort_keys=True, separators=(",", ":"))


class XrayError(ValueError):
    """Unmaterializable request — target outside the replay window,
    missing durable log, malformed predicate. The message names the
    actionable fix (e.g. the oldest materializable offset)."""


# ---------------------------------------------------------------------------
# offset-addressed state materialization


def oldest_materializable(ckpt_dir: Optional[str]) -> int:
    """The replay-window floor: with retained snapshots, the oldest
    snapshot offset (the journal's retention guard prunes rotated
    segments below it, so nothing older can be cross-checked); with no
    snapshots at all, 0 — the durable log replays from the start."""
    if not ckpt_dir:
        return 0
    from kme_tpu_torch.runtime import checkpoint as ck

    off = ck.oldest_retained_offset(ckpt_dir)
    return 0 if off is None else int(off)


def _fetch_records(log_dir: str, topic: str, start: int, end: int):
    """Records [start, end) from a durable broker log directory."""
    from kme_tpu_torch.bridge.broker import BrokerError, InProcessBroker

    if not os.path.isdir(log_dir):
        raise XrayError(f"no durable broker log directory: {log_dir}")
    br = InProcessBroker(persist_dir=log_dir)
    try:
        have = br.end_offset(topic)
    except BrokerError:
        raise XrayError(
            f"topic {topic!r} has no durable log under {log_dir}")
    if end > have:
        raise XrayError(
            f"durable log for {topic!r} ends at offset {have}; cannot "
            f"materialize offset {end}")
    out, off = [], start
    while off < end:
        recs = br.fetch(topic, off, max_records=min(4096, end - off))
        if not recs:
            break
        out.extend(recs)
        off = recs[-1].offset + 1
    return out


def _parse_replay(value: str):
    """The service's drop policy (bridge/service.py _parse): malformed
    or out-of-int32 records never reach the engine — None here."""
    from kme_tpu_torch.wire import parse_order

    try:
        m = parse_order(value)
        if not (-2**31 <= m.price < 2**31 and -2**31 <= m.size < 2**31):
            return None
        return m
    except ValueError:
        return None


def _engine_from_snapshot(path: str, book_slots: Optional[int],
                          max_fills: Optional[int]):
    """One snapshot file -> a fixed-mode OracleEngine holding its state.
    .pkl restores the exact pickled engine (envelope included); .npz
    restores the canonical form into a SeqSession and adopts its export
    (envelope defaults to the snapshot's own cfg)."""
    from kme_tpu_torch.oracle import OracleEngine
    from kme_tpu_torch.runtime import checkpoint as ck

    if path.endswith(".pkl"):
        eng = ck.load_oracle_file(path)
        if getattr(eng, "java", False):
            raise XrayError(
                "java-mode oracle snapshot: xray materializes fixed-mode "
                "state only")
        return eng
    if path.endswith(".npz"):
        # the canonical planes are only decoded here (no kernel runs),
        # so the session that carries them lives on the host
        ses = ck.restore_seq_snapshot(path, None, device="cpu")
        if ses.cfg.compat != "fixed":
            raise XrayError(
                "java-mode snapshot: xray materializes fixed-mode state "
                "only")
        return OracleEngine.from_export(
            ses.export_state(),
            book_slots=(book_slots if book_slots is not None
                        else ses.cfg.slots),
            max_fills=(max_fills if max_fills is not None
                       else ses.cfg.max_fills))
    raise XrayError(
        f"snapshot kind of {os.path.basename(path)} is not anchorable "
        f"here (native .nat dumps need the native engine library)")


def materialize(log_dir: str, at: Optional[int], topic: str = "MatchIn",
                ckpt_dir: Optional[str] = None,
                allow_cold: bool = False,
                max_anchor: Optional[int] = None,
                book_slots: Optional[int] = None,
                max_fills: Optional[int] = None):
    """State at input offset `at` (exclusive: all records with offset
    < at applied — the checkpoint offset convention; None = log end).
    Returns (OracleEngine, anchor_offset, replayed_count).

    Replay-window policy: when `ckpt_dir` holds snapshots, targets
    below `oldest_materializable` raise XrayError naming the floor —
    the journal retention guard has already released history below the
    oldest snapshot, so nothing there can be cross-checked.
    `allow_cold=True` overrides (bisect probes and cluster cuts replay
    from offset 0 off the never-pruned broker log). `max_anchor` caps
    the anchor offset (bisect: only checkpoints at or below the
    known-good watermark are trusted)."""
    from kme_tpu_torch.oracle import OracleEngine
    from kme_tpu_torch.bridge.broker import InProcessBroker
    from kme_tpu_torch.runtime import checkpoint as ck

    if at is None:
        if not os.path.isdir(log_dir):
            raise XrayError(
                f"no durable broker log directory: {log_dir}")
        at = InProcessBroker(persist_dir=log_dir).end_offset(topic)
    at = int(at)
    if at < 0:
        raise XrayError("target offset must be >= 0")
    engine, anchor_off = None, 0
    if ckpt_dir:
        snaps = ck.all_snapshots(ckpt_dir)
        if snaps:
            oldest = oldest_materializable(ckpt_dir)
            if at < oldest and not allow_cold:
                raise XrayError(
                    f"offset {at} predates the replay window: the oldest "
                    f"materializable offset is {oldest} (snapshots below "
                    f"it were pruned — raise --checkpoint-keep / "
                    f"KME_CKPT_KEEP and the journal rotate_keep to retain "
                    f"deeper history)")
        bound = at if max_anchor is None else min(at, int(max_anchor))
        for off, path in snaps:      # newest first, all kinds
            if off > bound:
                continue
            try:
                engine = _engine_from_snapshot(path, book_slots,
                                               max_fills)
                anchor_off = off
                break
            except Exception as e:   # corrupt/foreign: older anchor
                print(f"kme-torch-xray: skipping snapshot {path}: {e}",
                      file=sys.stderr)
    if engine is None:
        kw = {}
        if book_slots is not None:
            kw = {"book_slots": book_slots,
                  "max_fills": max_fills or 16}
        engine = OracleEngine("fixed", **kw)
        anchor_off = 0
    replayed = 0
    for rec in _fetch_records(log_dir, topic, anchor_off, at):
        msg = _parse_replay(rec.value)
        if msg is None:
            continue
        engine.process(msg)
        replayed += 1
    return engine, anchor_off, replayed


def resolve_trace(tid, log_dir: str, topic: str = "MatchIn",
                  ngroups: int = 1) -> Optional[int]:
    """Trace id -> input offset. The dtrace ids are splitmix64 mixes
    (NOT invertible), so resolution scans the offset space recomputing
    them: group-local ids (`local_tid`) need only the log length;
    order-identity ids (`trace_id(off, aid, oid)`) re-parse the line at
    each offset. Returns the first matching offset or None."""
    from kme_tpu_torch.telemetry import dtrace

    if isinstance(tid, str):
        tid = int(tid, 0)
    tid = int(tid)
    from kme_tpu_torch.bridge.broker import BrokerError, InProcessBroker

    br = InProcessBroker(persist_dir=log_dir)
    try:
        end = br.end_offset(topic)
    except BrokerError:
        raise XrayError(
            f"topic {topic!r} has no durable log under {log_dir}")
    for off in range(end):
        for g in range(max(1, ngroups)):
            if dtrace.local_tid(g, off) == tid:
                return off
    off = 0
    while off < end:
        for rec in br.fetch(topic, off, max_records=4096):
            m = _parse_replay(rec.value)
            if m is not None and dtrace.trace_id(
                    rec.offset, m.aid, m.oid) == tid:
                return rec.offset
            off = rec.offset + 1
    return None


# ---------------------------------------------------------------------------
# watchpoint predicate grammar (pure: no clock, no RNG — lint-enforced)

_PRED_RE = re.compile(
    r"^\s*(balance|position|depth|spread)\s*\[\s*(-?\d+)\s*"
    r"(?:,\s*(-?\d+)\s*)?\]\s*(<=|>=|==|!=|<|>)\s*(-?\d+)\s*$")

_GRAMMAR = ("balance[AID] | position[AID,SID] | depth[SID] | "
            "spread[SID], compared with < <= > >= == != to an integer")


class Watchpoint:
    """One parsed predicate: kind, index tuple, comparator, rhs."""

    __slots__ = ("expr", "kind", "a", "b", "op", "rhs")

    def __init__(self, expr: str, kind: str, a: int, b: Optional[int],
                 op: str, rhs: int) -> None:
        self.expr, self.kind, self.a, self.b = expr, kind, a, b
        self.op, self.rhs = op, rhs


def parse_watch(expr: str) -> Watchpoint:
    m = _PRED_RE.match(expr)
    if not m:
        raise XrayError(
            f"unparseable watch predicate {expr!r}; grammar: {_GRAMMAR}")
    kind, a, b, cmp_op, rhs = m.groups()
    if kind == "position" and b is None:
        raise XrayError(
            f"watch predicate {expr!r}: position takes [AID,SID]")
    if kind != "position" and b is not None:
        raise XrayError(
            f"watch predicate {expr!r}: {kind} takes a single index")
    return Watchpoint(expr.strip(), kind, int(a),
                      int(b) if b is not None else None,
                      cmp_op, int(rhs))


def _cmp(op_s: str, lhs: int, rhs: int) -> bool:
    if op_s == "<":
        return lhs < rhs
    if op_s == "<=":
        return lhs <= rhs
    if op_s == ">":
        return lhs > rhs
    if op_s == ">=":
        return lhs >= rhs
    if op_s == "==":
        return lhs == rhs
    return lhs != rhs


def measure(pred: Watchpoint, ledger) -> Optional[int]:
    """Evaluate a predicate's left-hand side against an
    InvariantAuditor-shaped shadow ledger. None = unmeasurable
    (unknown account; one-sided or absent book for spread) — the
    predicate does not fire."""
    if pred.kind == "balance":
        return ledger.balances.get(pred.a)
    if pred.kind == "position":
        pos = ledger.positions.get((pred.a, pred.b))
        return pos[0] if pos is not None else 0
    book = ledger.books.get(pred.a)
    if pred.kind == "depth":
        if book is None:
            return 0
        return sum(len(oids) for side in book for oids in side.values())
    if book is None:
        return None
    bids = [px for px, oids in book[0].items() if oids]
    asks = [px for px, oids in book[1].items() if oids]
    if not bids or not asks:
        return None
    return min(asks) - max(bids)


def eval_predicate(pred: Watchpoint, ledger
                   ) -> Tuple[bool, Optional[int]]:
    val = measure(pred, ledger)
    if val is None:
        return False, None
    return _cmp(pred.op, val, pred.rhs), val


def measure_engine(pred: Watchpoint, engine) -> Optional[int]:
    """Same measurement over a materialized OracleEngine (the offline
    `kme-torch-xray eval` path)."""
    if pred.kind == "balance":
        return engine.balances.get(pred.a)
    if pred.kind == "position":
        pos = engine.positions.get((pred.a, pred.b))
        return pos[0] if pos is not None else 0
    lv = engine.book_levels(pred.a)
    if pred.kind == "depth":
        return sum(len(rows) for _px, rows in lv["buys"] + lv["sells"])
    if not lv["buys"] or not lv["sells"]:
        return None
    return lv["sells"][0][0] - lv["buys"][0][0]


def eval_engine(pred: Watchpoint, engine) -> Tuple[bool, Optional[int]]:
    """eval_predicate over a materialized engine instead of a shadow
    ledger — the `kme-torch-xray eval` path."""
    val = measure_engine(pred, engine)
    if val is None:
        return False, None
    return _cmp(pred.op, val, pred.rhs), val


def book_summary(engine, sid: int) -> dict:
    """JSON-safe ladder view of one symbol plus the derived depth and
    spread the watchpoint grammar measures."""
    lv = engine.book_levels(sid)
    buys = [[int(px), [[int(o), int(a), int(s)] for o, a, s in rows]]
            for px, rows in lv["buys"]]
    sells = [[int(px), [[int(o), int(a), int(s)] for o, a, s in rows]]
             for px, rows in lv["sells"]]
    depth = sum(len(rows) for _px, rows in buys + sells)
    spread = (sells[0][0] - buys[0][0]) if buys and sells else None
    return {"sid": int(sid), "exists": bool(lv["exists"]),
            "buys": buys, "sells": sells,
            "depth": depth, "spread": spread}


class WatchEngine:
    """Armed watchpoints + the shadow ledger they read.

    Fed at batch barriers (bridge/service.py) either inline from the
    batch's output line groups or as a journal observer sharing the
    already-derived lifecycle events. Edge-triggered: a predicate fires
    when it transitions false->true and re-arms when it goes false
    again, so hit sets are bounded and deterministic. Firing writes a
    TriggerCapture-compatible capture_NNN.json (same reader:
    `kme-torch-prof --captures`)."""

    def __init__(self, exprs: Sequence[str],
                 out_dir: Optional[str] = None, registry=None,
                 max_captures: int = 16,
                 repro: Optional[dict] = None) -> None:
        from kme_tpu_torch.telemetry.audit import InvariantAuditor

        self.preds = [parse_watch(e) for e in exprs]
        self._shadow = InvariantAuditor()
        self._armed = [True] * len(self.preds)
        # (batch-end input offset, predicate expr, measured value)
        self.hits: List[Tuple[int, str, int]] = []
        self.out_dir = out_dir
        self.max_captures = int(max_captures)
        self.capture_paths: List[str] = []
        self._next_capture = 0
        self._repro = dict(repro or {})
        self._counter = None
        if registry is not None:
            self._counter = registry.counter(
                "watch_hits_total",
                help="watchpoint predicates transitioned to true")

    def seed(self, state: dict) -> None:
        """Adopt an engine export on resume, like the auditor does."""
        self._shadow.seed(state)

    def observe_lines(self, lines_per_msg, reasons=None, offsets=None,
                      drops=(), exemplars=None) -> List[tuple]:
        from kme_tpu_torch.telemetry.journal import batch_events

        evs = batch_events(lines_per_msg, reasons=reasons,
                           offsets=offsets, drops=drops)
        return self.observe_events(evs, exemplars=exemplars)

    def observe_engine(self, engine, off: int,
                       exemplars=None) -> List[tuple]:
        """One batch barrier read DIRECTLY off the live OracleEngine —
        the zero-derivation path bridge/service.py uses when the
        serving engine is itself the deterministic truth (no lifecycle
        re-parse, no shadow ledger; the 3% always-on budget). Hit sets
        are identical to the event-fed path: both read the same state
        machine at the same barrier."""
        fired: List[tuple] = []
        for i, pred in enumerate(self.preds):
            hit, val = eval_engine(pred, engine)
            if hit and self._armed[i]:
                self._armed[i] = False
                rec = (off, pred.expr, val)
                self.hits.append(rec)
                fired.append(rec)
            elif not hit:
                self._armed[i] = True
        if fired and self._counter is not None:
            self._counter.inc(len(fired))
        for rec in fired:
            self._write_capture(rec[0], rec[1], rec[2], exemplars)
        return fired

    def observe_events(self, events: List[dict],
                       exemplars=None) -> List[tuple]:
        """One batch barrier: apply the lifecycle deltas, evaluate every
        armed predicate, record edge-triggered hits. Pure function of
        the event stream — the capture write is observability on the
        side and never feeds back into the decision."""
        sh = self._shadow
        if events:
            sh.observe(events)
            # the shadow is a ledger here, not a judge — its violation
            # log is the auditor's job and must not grow unbounded
            sh.violations.clear()
        off = -1
        for ev in events:
            o = ev.get("off", -1)
            if o > off:
                off = o
        fired: List[tuple] = []
        for i, pred in enumerate(self.preds):
            hit, val = eval_predicate(pred, sh)
            if hit and self._armed[i]:
                self._armed[i] = False
                rec = (off, pred.expr, val)
                self.hits.append(rec)
                fired.append(rec)
            elif not hit:
                self._armed[i] = True
        if fired and self._counter is not None:
            self._counter.inc(len(fired))
        for rec in fired:
            self._write_capture(rec[0], rec[1], rec[2], exemplars)
        return fired

    # -- capture emission (TriggerCapture-compatible doc + naming) -----

    def _repro_line(self, off: int, expr: str) -> Optional[str]:
        log_dir = self._repro.get("log_dir")
        if not log_dir:
            return None
        cmd = f"kme-torch-xray eval '{expr}' --at {off + 1} --log-dir {log_dir}"
        topic = self._repro.get("topic")
        if topic and topic != "MatchIn":
            cmd += f" --topic {topic}"
        ckd = self._repro.get("checkpoint_dir")
        if ckd:
            cmd += f" --checkpoint-dir {ckd}"
        return cmd

    def _write_capture(self, off: int, expr: str, val: int,
                       exemplars) -> Optional[str]:
        if self.out_dir is None or len(
                self.capture_paths) >= self.max_captures:
            return None
        import time

        try:
            os.makedirs(self.out_dir, exist_ok=True)
            n = self._next_capture
            while True:   # share the namespace with TriggerCapture
                path = os.path.join(self.out_dir,
                                    f"capture_{n:03d}.json")
                if not os.path.exists(path):
                    break
                n += 1
            doc = {"time": time.time(), "trigger": "watchpoint",
                   "predicate": expr, "offset": off, "value": val,
                   "exemplars": [dict(e) for e in (exemplars or [])],
                   "repro": self._repro_line(off, expr),
                   "resolve_with": ("kme-torch-prof --captures DIR to list; "
                                    "run the 'repro' line to "
                                    "re-materialize the hit offline")}
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1)
            os.replace(tmp, path)
            self._next_capture = n + 1
            self.capture_paths.append(path)
            return path
        except OSError:      # disk trouble must never stall the barrier
            return None


# ---------------------------------------------------------------------------
# divergence bisection

_TIMING_EVENTS = ("win", "lat", "span")


def _journal_batches(events: List[dict]) -> List[Tuple[int, List[dict]]]:
    """[(batch_id, lifecycle events), ...] in stream order."""
    out: List[Tuple[int, List[dict]]] = []
    cur = None
    for ev in events:
        if ev.get("e") in _TIMING_EVENTS:
            continue
        b = ev.get("b", -1)
        if cur is None or b != cur:
            out.append((b, []))
            cur = b
        out[-1][1].append(ev)
    return out


def _batch_end_off(evs: List[dict]) -> int:
    off = -1
    for ev in evs:
        o = ev.get("off", -1)
        if o > off:
            off = o
    return off


def _canon(balances, positions, orders, books) -> dict:
    """Canonical-codec projection of a ledger: the JSON-stable shape
    both bisect sides are diffed in. Orders normalize to the auditor's
    [aid, sid, is_buy, price, size] rows; books to the sorted sid set
    (FIFO order inside a bucket is not part of the projection — audit's
    check_engine draws the same line)."""
    return {
        "balances": {str(a): int(v) for a, v in balances.items()},
        "positions": {f"{a}:{s}": [int(x) for x in v]
                      for (a, s), v in positions.items()},
        "orders": {str(o): [int(v[0]), int(v[1]), bool(v[2]),
                            int(v[3]), int(v[4])]
                   for o, v in orders.items()},
        "books": sorted(int(s) for s in books),
    }


def shadow_canon(aud) -> dict:
    return _canon(aud.balances, aud.positions, aud.orders, aud.books)


def engine_canon(engine) -> dict:
    ex = engine.export_state()
    orders = {o: [v["aid"], v["sid"], v["is_buy"], v["price"],
                  v["size"]] for o, v in ex["orders"].items()}
    return _canon(ex["balances"], ex["positions"], orders, ex["books"])


def state_diff(want: dict, got: dict) -> Dict[str, str]:
    """Field-level diff between two canonical projections (want =
    oracle truth, got = journal shadow)."""
    from kme_tpu_torch.telemetry.audit import _dict_diff

    out: Dict[str, str] = {}
    for store in ("balances", "positions", "orders"):
        if want.get(store) != got.get(store):
            out[store] = _dict_diff(want.get(store, {}),
                                    got.get(store, {}), limit=8)
    if want.get("books") != got.get("books"):
        out["books"] = (f"oracle={want.get('books')} "
                        f"journal={got.get('books')}")
    return out


def bisect(journal_path: str, log_dir: str, topic: str = "MatchIn",
           ckpt_dir: Optional[str] = None,
           lo: Optional[int] = None, hi: Optional[int] = None,
           hi_batch: Optional[int] = None,
           book_slots: Optional[int] = None,
           max_fills: Optional[int] = None,
           repro_dir: Optional[str] = None) -> dict:
    """Binary-search the first batch where the journal's claimed state
    diverges from the oracle replay of the durable input.

    `lo`/`hi` bound the search window in input offsets (lo known-good,
    hi known- or suspected-bad); `hi_batch` names the upper bound by
    journal batch id instead (what audit repro dumps carry). Each probe
    is ONE oracle replay, anchored on the nearest checkpoint at or
    below the known-good watermark — total replays <=
    ceil(log2(window_batches)) + 1, asserted by the CI drill."""
    from kme_tpu_torch.telemetry.audit import InvariantAuditor
    from kme_tpu_torch.telemetry.journal import read_events

    events = read_events(journal_path)
    batches = _journal_batches(events)
    if not batches:
        raise XrayError(f"journal {journal_path} holds no batches")

    ends = [_batch_end_off(evs) for _b, evs in batches]
    hi_i = len(batches) - 1
    if hi_batch is not None:
        hi_i = next((i for i, (b, _e) in enumerate(batches)
                     if b == int(hi_batch)), None)
        if hi_i is None:
            raise XrayError(
                f"batch {hi_batch} is not in journal {journal_path}")
    elif hi is not None:
        hi_i = max((i for i, e in enumerate(ends) if e < int(hi)),
                   default=len(batches) - 1)
    lo_i = -1
    if lo is not None:
        lo_i = max((i for i, e in enumerate(ends) if e < int(lo)),
                   default=-1)
    if lo_i >= hi_i:
        raise XrayError(f"empty bisect window: lo batch index {lo_i} "
                        f">= hi batch index {hi_i}")

    def shadow_at(i: int) -> dict:
        aud = InvariantAuditor()
        for k in range(i + 1):
            aud.observe(batches[k][1])
            aud.violations.clear()
        return shadow_canon(aud)

    replays = 0

    def oracle_at(i: int, good_i: int) -> dict:
        nonlocal replays
        end = ends[i] + 1 if i >= 0 else 0
        good_off = ends[good_i] + 1 if good_i >= 0 else 0
        eng, _anchor, _n = materialize(
            log_dir, end, topic=topic, ckpt_dir=ckpt_dir,
            allow_cold=True, max_anchor=good_off,
            book_slots=book_slots, max_fills=max_fills)
        replays += 1
        return engine_canon(eng)

    span = hi_i - lo_i
    want_hi = oracle_at(hi_i, lo_i)
    got_hi = shadow_at(hi_i)
    result = {"journal": journal_path, "log_dir": log_dir,
              "topic": topic, "n_batches": len(batches),
              "window_batches": span}
    if want_hi == got_hi:
        result.update(divergent=False, replays=replays)
        return result
    div_want, div_got = want_hi, got_hi
    while hi_i - lo_i > 1:
        mid = (lo_i + hi_i) // 2
        want_m = oracle_at(mid, lo_i)
        got_m = shadow_at(mid)
        if want_m == got_m:
            lo_i = mid
        else:
            hi_i, div_want, div_got = mid, want_m, got_m

    b, evs = batches[hi_i]
    first_off = min((ev.get("off", -1) for ev in evs
                     if ev.get("off", -1) >= 0), default=-1)
    diff = state_diff(div_want, div_got)
    result.update(
        divergent=True, batch=b, batch_index=hi_i,
        first_divergent_offset=first_off, end_offset=ends[hi_i],
        replays=replays, diff=diff)

    # minimized repro in the audit.py dump format, replayable offline
    pre_aud = InvariantAuditor()
    for k in range(hi_i):
        pre_aud.observe(batches[k][1])
        pre_aud.violations.clear()
    inputs = None
    try:
        inputs = [r.value for r in _fetch_records(
            log_dir, topic, max(0, first_off), ends[hi_i] + 1)]
    except XrayError:
        pass
    doc = {
        "violations": [{"kind": "bisect_divergence",
                        "detail": "; ".join(
                            f"{k}: {v}" for k, v in sorted(diff.items())),
                        "batch": b, "seq": -1}],
        "batch": b, "pre_state": pre_aud._snapshot(),
        "events": evs, "inputs": inputs, "checkpoint_ref": ckpt_dir,
        "oracle_state": div_want, "shadow_state": div_got,
        "diff": diff,
        "xray": (f"kme-torch-xray --bisect --journal {journal_path} "
                 f"--log-dir {log_dir} --hi-batch {b}"
                 + (f" --checkpoint-dir {ckpt_dir}" if ckpt_dir else "")),
    }
    out_dir = repro_dir or os.path.dirname(os.path.abspath(journal_path))
    path = os.path.join(out_dir, f"xray_bisect_b{b}.json")
    try:
        os.makedirs(out_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f, **_J)
        result["repro"] = path
    except OSError:
        result["repro"] = None
    return result


def replay_bisect_repro(path: str) -> dict:
    """Offline repro replay: seed the journal shadow from the dumped
    pre-batch state, re-apply the dumped events, re-derive the diff
    against the dumped oracle state. `match` is True when it equals the
    dumped diff — the bisect verdict reproduces from the dump alone."""
    from kme_tpu_torch.telemetry.audit import auditor_from_pre

    with open(path) as f:
        doc = json.load(f)
    aud = auditor_from_pre(doc["pre_state"])
    aud.observe(doc["events"])
    aud.violations.clear()
    got = shadow_canon(aud)
    diff = state_diff(doc["oracle_state"], got)
    return {"batch": doc["batch"], "diff": diff,
            "match": diff == doc.get("diff")}


# ---------------------------------------------------------------------------
# cluster mode: consistent cut + global cash conservation


def cluster_cut(state_root: str, at: Optional[int] = None,
                input_path: Optional[str] = None,
                prefund: int = 8, transfers: bool = True,
                book_slots: Optional[int] = None,
                max_fills: Optional[int] = None) -> dict:
    """Materialize every group of a multi-group run at a consistent
    cut and check global cash conservation against the single-leader
    oracle. The cut re-runs the front's GroupRouter over the merged
    input: it needs the JAX package's bridge/front.py, which the port
    does not have yet."""
    raise NotImplementedError(
        "cluster_cut re-runs the multi-leader front's GroupRouter, which "
        "needs the JAX package's bridge/front.py; kme_tpu_torch does not "
        "have it yet (ROADMAP.md, Queue A item 6)")
