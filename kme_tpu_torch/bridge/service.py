"""MatchService: the engine service behind the MatchIn/MatchOut topics.

The port of `kme_tpu/bridge/service.py`. The reference role: Kafka
Streams pulls records from `MatchIn`, the processor forwards the
pre-image with key "IN", processes, and forwards the result/fill stream
with key "OUT" to `MatchOut` (the reference's KProcessor.java:96-126).
Here the same contract is a poll loop over the broker API with a
pluggable engine:

- engine="seq"    — the sequential seq kernel on the card (fixed or
  java compat; deep books above 512 slots); `pipeline=N` keeps N
  batches in flight through SeqSession.submit/collect.
- engine="lanes"  — the sweep engine on the card (fixed-mode semantics,
  its step replayed from a CUDA graph). The batch boundary replaces the
  reference's per-record commit (KProcessor.java:125): offsets advance
  only after a batch's outputs are produced.
- engine="oracle" — the scalar reference replica (compat java|fixed),
  quirk-exact per message.
- engine="native" — the C++ port of the same quirk-exact semantics
  (native/oracle.py), and the java seq service's degrade target.

The device engines run on `device` (default the card; without one they
raise). The host engines ignore it.

Malformed values (JSON Jackson would reject) kill the reference's
stream thread (KProcessor.java:513-517); the service instead drops the
record with a stderr note — a deliberate fix, flagged by `strict=True`
which replicates the reference behavior by raising.

Output contract: by default AT-LEAST-ONCE (the reference, with Kafka's
exactly-once commented out at KProcessor.java:29 — crash + resume
replays the post-snapshot tail). `exactly_once=True` upgrades that to
exactly-once VISIBLE output: the service acquires a leader epoch
(bridge/lease.py), stamps every MatchOut produce with
`(epoch, out_seq)` (wire.ProduceStamp), and the broker fences stale
epochs and suppresses replayed stamps (bridge/broker.py), so the
durable MatchOut log itself carries each record exactly once.
`follower=True` runs the service as a hot-standby replica: produces are
discarded (but out_seq still counts them), checkpoints are skipped, and
no lease is held.

Observability, as in the JAX package: the flight-recorder journal
(`journal=`), the invariant auditor over it (`audit=`; its
`check_engine` reads the state the card's kernels left at every
checkpoint), per-order latency stamps and trace spans, SLOs, the
metrics history (`tsdb=`), the host profiler, the device plane
(`profile_artifact=`: the seq kernel's CUDA-event time and bytes per
dispatch), trigger captures with a torch.profiler window, live
watchpoints and, with a checkpoint dir, the control-plane event log.

Multi-leader groups (`group=(k, n)`, bridge/front.py): the service
serves one symbol partition behind the front door — topics
`MatchIn.gK` / `MatchOut.gK`, and the front-injected transfer legs
diverted, stamped, to `Xfer.gK` with their `pending_reserve` ledger in
the snapshot — on every engine.
"""

from __future__ import annotations

import heapq
import sys
from operator import itemgetter
from typing import Optional

from kme_tpu_torch import faults

TOPIC_IN = "MatchIn"    # topic.js:17
TOPIC_OUT = "MatchOut"  # topic.js:21
# seconds of torch.profiler trace a capture records on a card session
_CAPTURE_WINDOW_S = 0.5


class MatchService:
    def __init__(self, broker, engine: str = "lanes",
                 compat: str = "fixed", batch: int = 1024,
                 symbols: int = 1024, accounts: int = 4096,
                 slots: int = 128, max_fills: int = 16,
                 width: int = 8, shards: int = 1,
                 strict: bool = False,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 4096,
                 checkpoint_keep: Optional[int] = None,
                 journal=None, journal_rotate_mb: Optional[int] = None,
                 journal_fsync: str = "off",
                 journal_keep: Optional[int] = None,
                 audit: bool = False,
                 audit_repro_dir: Optional[str] = None,
                 annotate_rejects: bool = False,
                 exactly_once: bool = False,
                 follower: bool = False,
                 pipeline: int = 0,
                 group=None,
                 slo=None,
                 trace_spans: bool = False,
                 tsdb: Optional[str] = None,
                 profile: bool = False,
                 profile_artifact: Optional[str] = None,
                 capture_dir: Optional[str] = None,
                 capture_p99_us: Optional[int] = None,
                 watch=None, clock=None, device="cuda") -> None:
        if engine not in ("lanes", "seq", "oracle", "native"):
            raise ValueError(f"unknown engine {engine!r}")
        if compat not in ("java", "fixed"):
            raise ValueError(f"unknown compat {compat!r}")
        if engine == "lanes" and compat != "fixed":
            raise ValueError("the lanes engine is fixed-mode only; use "
                             "engine='seq' (stock wire surface), "
                             "'native' or 'oracle' for compat='java'")
        self.broker = broker
        # the clock seam (bridge/clock.py): every sleep/backoff and
        # interval read below goes through this object
        from kme_tpu_torch.bridge.clock import WALL

        self.clock = clock or WALL
        # multi-leader shard group: group=(k, n) namespaces every
        # durable artifact this service touches on the broker — its
        # input/output topics become "MatchIn.g{k}"/"MatchOut.g{k}" and
        # front-injected cross-shard transfer legs are diverted to a
        # stamped per-group "Xfer.g{k}" topic (the durable dedup
        # evidence) instead of the merged MatchOut feed. Lease, journal
        # and checkpoint namespacing happens one level up: kme-torch-serve
        # gives each group its own --checkpoint-dir root.
        if group is not None:
            gk, gn = int(group[0]), int(group[1])
            if gn < 1 or not (0 <= gk < gn):
                raise ValueError(f"group {gk}/{gn} out of range")
        else:
            gk, gn = 0, 1
        self.group_id, self.group_count = gk, gn
        grouped = group is not None and gn > 1
        self.topic_in = f"{TOPIC_IN}.g{gk}" if grouped else TOPIC_IN
        self.topic_out = f"{TOPIC_OUT}.g{gk}" if grouped else TOPIC_OUT
        self.topic_xfer = f"Xfer.g{gk}" if grouped else None
        # cross-shard balance-transfer ledger (checkpointed in the
        # snapshot's extra meta so a resume reports continuous totals):
        # legs = applied transfer legs, credits/debits = amounts moved
        # in/out of this group's accounts, rejected = legs the engine
        # refused (shadow-ledger shortfall at the front door),
        # broadcasts = CREATE_BALANCE copies suppressed here
        self._xfer = {"legs": 0, "credits": 0, "debits": 0,
                      "rejected": 0, "broadcasts": 0}
        self._xfer_mark = None
        if grouped:
            from kme_tpu_torch.bridge.front import _MARK_SUB

            self._xfer_mark = _MARK_SUB
            create = getattr(broker, "create_topic", None)
            if create is not None:
                from kme_tpu_torch.bridge.broker import BrokerError

                try:
                    create(self.topic_xfer)
                except BrokerError:
                    pass    # already provisioned
        self.engine_kind = engine
        self._compat = compat
        self.device = device
        self.batch = batch
        self.strict = strict
        self.offset = 0
        self._session = self._oracle = self._native = None
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.checkpoint_keep = checkpoint_keep
        self._last_ckpt_offset = 0
        self._req_symbols, self._req_accounts = symbols, accounts
        self._req_slots, self._req_max_fills = slots, max_fills
        self._last_engine_pub = 0.0
        self._journal_arg = journal
        self._journal_rotate_mb = journal_rotate_mb
        self._journal_fsync = journal_fsync
        self._journal_keep = journal_keep
        self._audit_arg = audit
        self._audit_repro_dir = audit_repro_dir
        self.annotate_rejects = annotate_rejects
        self.exactly_once = exactly_once
        self.follower = follower
        # double-buffered serving: up to `pipeline` batches stay in
        # flight — batch N+1's parse/plan/dispatch runs under batch N's
        # kernel; offsets/checkpoints advance only at collect time, so
        # the durability contract is unchanged. Needs the seq engine
        # (submit/collect), fixed mode and the native host runtime
        # (buffer reconstruction); anything else serves serial with a
        # note.
        self.pipeline = 0
        self._pipe = None
        if pipeline:
            from kme_tpu_torch.native import load_library

            if (engine == "seq" and compat == "fixed"
                    and not annotate_rejects
                    and load_library() is not None):
                import collections

                self.pipeline = int(pipeline)
                self._pipe = collections.deque()
            else:
                print("kme-serve: --pipeline needs engine=seq, "
                      "compat=fixed, the native host runtime and no "
                      "--annotate-rejects; serving serial",
                      file=sys.stderr)
        self.epoch: Optional[int] = None  # leader fencing token
        self.out_seq = 0                  # next MatchOut produce stamp
        if exactly_once and checkpoint_dir is None:
            raise ValueError("exactly_once needs checkpoint_dir (the "
                             "leader-epoch lease lives there)")
        if exactly_once and annotate_rejects:
            # REJ annotations interleave at BATCH boundaries, and batch
            # boundaries are not deterministic across a resume — the
            # out_seq stamp stream would diverge from the original and
            # the broker would dedup the wrong records
            raise ValueError("exactly_once is incompatible with "
                             "annotate_rejects (REJ records interleave "
                             "at non-deterministic batch boundaries)")
        self.degraded = None        # set by the invariant auditor
        # distributed tracing (telemetry/dtrace.py): journal per-order
        # "span" events keyed by local_tid(group, broker offset)
        self.trace_spans = bool(trace_spans)
        # continuous profiling & history: metrics history on disk at
        # heartbeat cadence, the sampling host profiler, the
        # per-backend transfer/compute artifact, trigger captures
        self._tsdb_arg = tsdb
        self._profile_arg = bool(profile)
        self._profile_artifact = profile_artifact
        self._capture_dir = capture_dir
        self._capture_p99_us = capture_p99_us
        self.tsdb = None
        self.profiler = None
        self.capture = None
        # live watchpoints: deterministic predicates over the shadow
        # ledger, evaluated at every batch barrier. Read-only: they
        # never gate admission and never touch MatchOut bytes
        self._watch_arg = list(watch or [])
        self.watch = None
        # monotonic heartbeat-sample sequence, persisted across restart
        # in the checkpoint's additive `extra` meta, so TSDB ingestion
        # dedups replayed samples
        self.sample_seq = 0
        self._slo_arg = slo         # dict of SLO kwargs, or None
        self.slo = None
        self._slo_reason = None
        # adaptive-shed annotations: controller sheds happen on the TCP
        # produce thread; queue the details and emit REJ rows (with
        # backlog/threshold/state) from the poll thread
        self._shed_pending = None
        if (annotate_rejects
                and getattr(broker, "overload", None) is not None
                and hasattr(broker, "shed_observer")):
            import collections

            q = collections.deque(maxlen=65536)
            self._shed_pending = q
            broker.shed_observer = lambda _topic, d: q.append(d)
        # control-plane flight recorder (telemetry/events.py): the serve
        # process's own durable event stream — lease grants, overload
        # state transitions — next to the checkpoints, so kme-torch-events
        # merges it with other processes' logs. The heartbeat exports
        # its committed-bytes cursor (events_last_offset/lag_bytes)
        self.events = None
        if checkpoint_dir is not None:
            from kme_tpu_torch.telemetry import events as cpevents

            src = "follower" if self.follower else "serve"
            if self.group_count > 1:
                src = f"{src}.g{self.group_id}"
            try:
                self.events = cpevents.open_log(
                    checkpoint_dir, src, clock=self.clock.time)
            except OSError:
                self.events = None
            ctl = getattr(broker, "overload", None)
            if self.events is not None and ctl is not None:
                ev = self.events
                gid = self.group_id if self.group_count > 1 else None
                names = type(ctl).STATE_NAMES

                def _overload_event(prev, new):
                    ev.emit("overload.transition",
                            severity="warn" if new else "info",
                            group=gid, from_state=names[prev],
                            to_state=names[new],
                            backoff_ms=ctl.backoff_ms)

                ctl.on_transition = _overload_event
        resumed = False
        if checkpoint_dir is not None:
            resumed = self._try_resume(engine, compat, shards, width)
        if not resumed:
            if engine == "lanes":
                from kme_tpu_torch.engine.lanes import LaneConfig
                from kme_tpu_torch.runtime.session import LaneSession

                cfg = LaneConfig(lanes=symbols, slots=slots,
                                 accounts=accounts, max_fills=max_fills)
                self._session = LaneSession(cfg, shards=shards, width=width,
                                            device=device)
            elif engine == "seq":
                self._session = self._make_seq_session()
            elif engine == "native":
                from kme_tpu_torch.native.oracle import NativeOracleEngine

                kw = ({"book_slots": slots, "max_fills": max_fills}
                      if compat == "fixed" else {})
                self._native = NativeOracleEngine(compat, **kw)
            else:
                from kme_tpu_torch.oracle import OracleEngine

                # the capacity envelope is a fixed-mode concept; java
                # compat replicates the reference's unbounded stores
                kw = ({"book_slots": slots, "max_fills": max_fills}
                      if compat == "fixed" else {})
                self._oracle = OracleEngine(compat, **kw)
        else:
            self._restore_sample_seq()
        self._init_exactly_once(resumed=resumed)
        self._init_telemetry()
        self._init_observability(resumed=resumed)
        self._commit_watermark()

    def _restore_sample_seq(self) -> None:
        """Heartbeat sample_seq continuation across a resume, read from
        the snapshot's additive extra meta."""
        from kme_tpu_torch.runtime import checkpoint as ck

        extra = ck.snapshot_extra(self.checkpoint_dir, self.offset)
        try:
            self.sample_seq = max(0, int(extra.get("sample_seq", 0)))
        except (TypeError, ValueError):
            self.sample_seq = 0

    def _init_exactly_once(self, resumed: bool) -> None:
        """Exactly-once startup: restore the produce-stamp cursor from
        the snapshot's extra meta, then (leaders only) acquire the next
        leader epoch and fence every predecessor at the broker. The
        explicit fence matters: a restarted broker reload only learns
        PRIOR epochs from the log stamps, so without it a zombie old
        leader holding the previous epoch would still get through. A
        follower restores the cursor but holds no lease."""
        if not self.exactly_once:
            return
        if resumed:
            from kme_tpu_torch.runtime import checkpoint as ck

            extra = ck.snapshot_extra(self.checkpoint_dir, self.offset)
            try:
                self.out_seq = int(extra.get("out_seq", 0))
            except (TypeError, ValueError):
                self.out_seq = 0
            pending = extra.get("pending_reserve")
            if isinstance(pending, dict):
                # cross-shard transfer ledger survives the restart so
                # replayed legs regenerate the same totals (the broker
                # watermark suppresses their duplicate stamps)
                for k in self._xfer:
                    try:
                        self._xfer[k] = int(pending.get(k, 0))
                    except (TypeError, ValueError):
                        pass
        if self.follower:
            return
        import inspect

        from kme_tpu_torch.bridge import lease

        try:
            params = inspect.signature(self.broker.produce).parameters
        except (TypeError, ValueError):
            params = {}
        if "out_seq" not in params:
            # a transport without produce stamps: no fencing — fall back
            # loudly to the at-least-once contract
            print("kme-serve: broker transport has no produce stamps; "
                  "exactly-once disabled (at-least-once output)",
                  file=sys.stderr)
            self.exactly_once = False
            return
        self.epoch = lease.acquire(self.checkpoint_dir,
                                   events=self.events)
        fence = getattr(self.broker, "fence", None)
        if fence is not None:
            fence(self.epoch)
        print(f"kme-serve: leader epoch {self.epoch} (out_seq resumes "
              f"at {self.out_seq})", file=sys.stderr)

    def _commit_watermark(self) -> None:
        """Advance the broker's consumer watermark for MatchIn — this
        arms (and continuously re-arms) the bounded-ingress max_lag
        check."""
        commit = getattr(self.broker, "commit", None)
        if commit is None:
            return
        from kme_tpu_torch.bridge.broker import BrokerError

        try:
            commit(self.topic_in, self.offset)
        except BrokerError:
            pass        # topic not provisioned yet / transport blip

    def _init_observability(self, resumed: bool) -> None:
        """Flight recorder + invariant auditor wiring. The journal
        subscribes the auditor as an observer, so the shadow replay
        sees exactly what lands in the journal file; on resume the
        journal is rewound to the snapshot offset (the at-least-once
        tail replay would otherwise journal twice) and the auditor is
        seeded from the restored engine state."""
        import os

        from kme_tpu_torch.telemetry import InvariantAuditor, Journal

        self.journal = None
        self.auditor = None
        # (offset, violations found) of each checkpoint's check_engine
        self.engine_checks: list = []
        j = self._journal_arg
        if isinstance(j, str):
            rb = (self._journal_rotate_mb * (1 << 20)
                  if self._journal_rotate_mb else None)
            guard = None
            if self.checkpoint_dir is not None:
                # retention coupling: rotated journal segments may only
                # be pruned once every event in them is older than the
                # oldest retained snapshot
                ckpt_dir = self.checkpoint_dir

                def guard():
                    from kme_tpu_torch.runtime import checkpoint as ck

                    return ck.oldest_retained_offset(ckpt_dir)
            j = Journal(j, rotate_bytes=rb, fsync=self._journal_fsync,
                        rotate_keep=self._journal_keep,
                        retention_guard=guard)
        self.journal = j
        if j is not None and resumed:
            j.rewind_to_offset(self.offset)
        # journal-side corruption drill (KME_AUDIT_TAMPER=
        # journal_fill_qty[@K]): one-shot, bumps the first journaled
        # fill's taker quantity, from the K-th journaled batch on, in a
        # COPY of the output line groups — the journal then LIES about a
        # batch while MatchOut stays untouched, the divergence class
        # `kme-torch-xray --bisect` must pin to a batch
        self._journal_tamper = None
        self._tampered_batch = None
        tamper_env = os.environ.get("KME_AUDIT_TAMPER", "")
        if j is not None and tamper_env.startswith("journal_fill_qty"):
            import json as _json

            from kme_tpu_torch import opcodes as op

            _, _, at_s = tamper_env.partition("@")
            arm_batch = int(at_s) if at_s.isdigit() else 0
            done = []
            seen = [0]     # record_batch calls == journal batch ids

            def line_tamper(out):
                b = seen[0]
                seen[0] += 1
                if done or b < arm_batch:
                    return out
                for gi, grp in enumerate(out):
                    if len(grp) < 4:   # no fill pairs (IN + result echo)
                        continue
                    for k in range(1, len(grp) - 1, 2):
                        key, _, val = grp[k + 1].partition(" ")
                        try:
                            tk = _json.loads(val)
                        except ValueError:
                            continue
                        if tk.get("action") not in (op.BOUGHT, op.SOLD):
                            continue   # not a fill-pair taker echo
                        tk["size"] = int(tk["size"]) + 1
                        new = list(grp)
                        new[k + 1] = (f"{key} " + _json.dumps(
                            tk, separators=(",", ":")))
                        out = list(out)
                        out[gi] = new
                        done.append(True)
                        self._tampered_batch = b
                        return out
                return out

            self._journal_tamper = line_tamper
        self._init_profiling(resumed)
        self._init_watch(resumed)
        if not self._audit_arg:
            return
        if self._compat != "fixed":
            print("kme-serve: --audit needs fixed-mode money semantics; "
                  "auditing disabled for compat=java", file=sys.stderr)
            return
        if j is None:
            raise ValueError("--audit requires --journal-out (the "
                             "auditor replays the journal stream)")

        def on_violation(violations, dump):
            self.degraded = violations[0]["kind"]
            where = f" (repro: {dump})" if dump else ""
            print(f"kme-serve: AUDIT VIOLATION {violations[0]}{where}",
                  file=sys.stderr)

        self.auditor = InvariantAuditor(
            registry=self.telemetry, repro_dir=self._audit_repro_dir,
            on_violation=on_violation,
            checkpoint_ref=self.checkpoint_dir,
            journal_ref=getattr(j, "path", None),
            log_ref=getattr(self.broker, "_persist_dir", None))
        if resumed and self._session is not None:
            self.auditor.seed(self._session.export_state(),
                              self._session.histograms())
        # deliberate-corruption drill: KME_AUDIT_TAMPER=fill_qty bumps
        # the first journaled fill's quantity by one, which must trip
        # the auditor
        if os.environ.get("KME_AUDIT_TAMPER") == "fill_qty":
            done = []

            def tamper(events):
                if not done:
                    for ev in events:
                        if ev.get("e") == "fill":
                            ev["qty"] += 1
                            done.append(True)
                            break
                return events

            self.auditor.tamper = tamper
        j.observers.append(self.auditor.observe)

    def _init_watch(self, resumed: bool) -> None:
        """Live watchpoint wiring. Predicates evaluate inline at the
        batch barrier — directly against the serving OracleEngine when
        that IS the engine, else against an auditor-shaped shadow
        ledger fed from the batch's own (untampered) output lines. Both
        are pure functions of exported state, so two seeded runs fire
        identical (offset, predicate) hit sets. Hits write bounded
        captures into `capture_dir` carrying the offset, the batch's
        slow-order trace exemplars and the `kme-torch-xray` line that
        reproduces the hit offline."""
        self.watch = None
        if not self._watch_arg:
            return
        if self._compat != "fixed":
            print("kme-serve: --watch needs fixed-mode money "
                  "semantics; watchpoints disabled for compat=java",
                  file=sys.stderr)
            return
        from kme_tpu_torch.telemetry.xray import WatchEngine

        repro = {"log_dir": getattr(self.broker, "_persist_dir", None),
                 "topic": self.topic_in,
                 "checkpoint_dir": self.checkpoint_dir}
        self.watch = WatchEngine(
            self._watch_arg, out_dir=self._capture_dir,
            registry=self.telemetry, repro=repro)
        if resumed:
            state = None
            if self._session is not None:
                state = self._session.export_state()
            elif self._oracle is not None and not self._oracle.java:
                state = self._oracle.export_state()
            if state is not None:
                self.watch.seed(state)
            else:
                print("kme-serve: --watch cannot seed its shadow from "
                      "a resumed native engine; watchpoints disabled",
                      file=sys.stderr)
                self.watch = None

    def _init_profiling(self, resumed: bool) -> None:
        """Continuous profiling & history wiring: the TSDB heartbeat
        feed, the sampling host profiler, the device plane and the
        SLO/p99 trigger capture. All additive: a failure to open the
        history store degrades the observability surface, never the
        engine."""
        if self._tsdb_arg is not None:
            from kme_tpu_torch.telemetry.tsdb import TSDB

            source = "follower" if self.follower else "serve"
            if self.group_count > 1:
                source = f"{source}.g{self.group_id}"
            try:
                self.tsdb = TSDB(self._tsdb_arg, source=source)
            except (OSError, ValueError) as e:
                print(f"kme-serve: TSDB disabled ({e})", file=sys.stderr)
            if self.tsdb is not None and not resumed:
                # no checkpoint cursor to continue: adopt the store's
                # high-water mark so a plain restart keeps appending
                self.sample_seq = max(self.sample_seq,
                                      self.tsdb.next_seq())
        if self._profile_arg:
            from kme_tpu_torch.telemetry.profiler import StageProfiler

            self.profiler = StageProfiler(registry=self.telemetry)
            self.profiler.start()
        if (self._profile_artifact is not None
                and getattr(self._session, "_staging", None) is not None):
            # the seq session on the card times its dispatches with
            # CUDA events and counts the bytes of a sample of them
            self._session.enable_device_plane()
        if self._capture_dir is not None:
            import torch
            from kme_tpu_torch.telemetry.profiler import TriggerCapture

            # on the card a capture also records a torch.profiler
            # window of the serving that follows it (the kernels' own
            # timeline); a CPU session has no device activity to add
            on_card = torch.device(self.device).type == "cuda"
            self.capture = TriggerCapture(
                self._capture_dir, p99_us=self._capture_p99_us,
                window_s=_CAPTURE_WINDOW_S if on_card else 0.0,
                registry=self.telemetry)

    def close(self) -> None:
        """Finish the in-flight batches, then flush + close the
        observability surfaces (serve shutdown path)."""
        if getattr(self, "_pipe", None):
            self._drain_pipeline()
        if getattr(self, "profiler", None) is not None:
            self.profiler.stop()
        if getattr(self, "capture", None) is not None:
            self.capture.close()
        if getattr(self, "_profile_artifact", None) is not None:
            from kme_tpu_torch.telemetry.profiler import (
                device_plane, write_transfer_artifact)

            try:
                # a session-less engine (oracle/native) records a host
                # plane: backend "cpu"
                plane = device_plane(session=self._session)
                write_transfer_artifact(self._profile_artifact, plane)
                print(f"kme-serve: transfer/compute artifact written to "
                      f"{self._profile_artifact}", file=sys.stderr)
            except (OSError, ValueError) as e:
                print(f"kme-serve: transfer artifact failed ({e})",
                      file=sys.stderr)
        if getattr(self, "tsdb", None) is not None:
            self.tsdb.close()
        if getattr(self, "events", None) is not None:
            self.events.close()
        if getattr(self, "journal", None) is not None:
            self.journal.close()

    def _init_telemetry(self) -> None:
        """The service's metrics surface. Session engines own a
        Registry — share it so engine counters, histograms and service
        counters expose through ONE snapshot; host-only engines
        (native/oracle) get a service-local one.

        Supervision provenance rides in via environment: a supervisor
        stamps each incarnation with its restart ordinal and the wall
        time of the failure it is recovering from."""
        import os

        from kme_tpu_torch.telemetry import Registry

        self.telemetry = (self._session.telemetry
                          if self._session is not None else Registry())
        try:
            ordinal = int(os.environ.get("KME_RESTART_ORDINAL", "0"))
        except ValueError:
            ordinal = 0
        self.telemetry.gauge("restarts_total").set(ordinal)
        failed_at = os.environ.get("KME_FAILED_AT")
        if failed_at:
            try:
                self.telemetry.gauge("recovery_seconds").set(
                    round(max(0.0, self.clock.time() - float(failed_at)),
                          3))
            except ValueError:
                pass
        self._init_latency()

    def _init_latency(self) -> None:
        """End-to-end latency attribution: one streaming quantile
        histogram per pipeline stage (telemetry/registry.py
        LatencyHistogram), all measured from the broker-admission stamp
        (Record.ats):
          ingress — admission -> the serve loop fetches the record
          plan    — host batch planning (session plan_s delta)
          device  — dispatch + device fetch (dispatch_s + fetch_s)
          produce — MatchOut produce wall time for the batch
          e2e     — admission -> the batch's outputs are visible
          consume — admission -> a consumer's fetch delivers the
                    MatchOut record (observed broker-side)
        """
        from kme_tpu_torch.telemetry import PhaseTimer

        t = self.telemetry
        self._lat = {
            s: t.latency(f"lat_{s}", h) for s, h in (
                ("ingress", "broker admission to serve-loop fetch"),
                ("plan", "host batch planning"),
                ("device", "device dispatch + fetch"),
                ("produce", "MatchOut produce wall time"),
                ("e2e", "broker admission to produce visible"),
                ("consume", "broker admission to consumer delivery"),
            )}
        if self.topic_xfer is not None:
            self._lat["transfer"] = t.latency(
                "transfer_rtt", "cross-shard transfer leg: durable "
                "stamped produce to the group Xfer topic")
        # serve-side spans land on their own trace track when a
        # TraceRecorder is installed (kme-torch-serve --trace-out)
        self._ptimer = PhaseTimer(track="serve")
        self._batch_ordinal = 0
        self._last_produce_s = 0.0
        # slowest recent orders, worst first: published as registry
        # exemplars so a p99 outlier resolves to a concrete waterfall
        # (kme-torch-trace --order)
        self._slow: list = []
        if self._slo_arg is not None:
            from kme_tpu_torch.telemetry.slo import SLO

            self.slo = SLO(t, **self._slo_arg)
        if getattr(self.broker, "deliver_observer", None) is None \
                and hasattr(self.broker, "deliver_observer"):
            lat_consume = self._lat["consume"]
            topic_out = self.topic_out

            def _on_deliver(topic, recs, now_us):
                if topic != topic_out:
                    return
                for r in recs:
                    ats = getattr(r, "ats", None)
                    if ats is not None:
                        lat_consume.observe(max(0, now_us - ats) * 1e-6)

            self.broker.deliver_observer = _on_deliver

    _EXEMPLARS = 8

    def _stamp_orders(self, offs, oids, aids, atss, fetch_us, done_us,
                      plan_us, dev_us, prod_us, batch) -> None:
        """Per-order stage attribution, shared by the serial and
        pipelined collect paths: journal "lat" stamps, "span" events
        when tracing is on (trace_spans), and the slow-order exemplar
        surface. Span bounds are contiguous from the admission stamp —
        the layout telemetry/dtrace.py synthesizes from "lat" events.
        Span identity is local_tid(group, broker offset): durable
        identity, so a crash-replay re-emits the SAME ids."""
        n = len(offs)
        if not n:
            return
        from kme_tpu_torch.telemetry.dtrace import local_tid

        g = self.group_id
        if self.journal is not None:
            self.journal.record_latency(
                [{"off": offs[i], "oid": oids[i],
                  "in_us": (max(0, fetch_us - atss[i])
                            if atss[i] is not None else 0),
                  "plan_us": plan_us, "dev_us": dev_us,
                  "prod_us": prod_us,
                  "e2e_us": (max(0, done_us - atss[i])
                             if atss[i] is not None else 0)}
                 for i in range(n)], batch=batch)
            if self.trace_spans:
                spans = []
                for i in range(n):
                    t = atss[i] if atss[i] is not None else fetch_us
                    tid = local_tid(g, offs[i])
                    for kind, dur in (
                            ("ingress", (max(0, fetch_us - atss[i])
                                         if atss[i] is not None
                                         else 0)),
                            ("plan", plan_us), ("device", dev_us),
                            ("produce", prod_us)):
                        spans.append(
                            {"kind": kind, "g": g, "off": offs[i],
                             "oid": oids[i], "aid": aids[i],
                             "tid": tid, "ptid": 0, "t0": t,
                             "t1": t + dur, "li": -1})
                        t += dur
                self.journal.record_spans(spans, batch=batch)
        cap = self._EXEMPLARS
        floor = (self._slow[-1]["e2e_us"]
                 if len(self._slow) >= cap else -1)
        # only this batch's `cap` slowest orders past the floor can stay
        # in the list: pick them (ties in batch order, as the stable sort
        # below keeps them) before building their records. In a backlog
        # every order beats the floor, and a trace id and a record for
        # each order were most of what the stamping cost.
        top = heapq.nlargest(
            cap, (c for c in ((max(0, done_us - a), i)
                              for i, a in enumerate(atss) if a is not None)
                  if c[0] > floor), key=itemgetter(0))
        for e2e, i in top:
            self._slow.append(
                {"tid": local_tid(g, offs[i]), "off": offs[i],
                 "oid": oids[i], "aid": aids[i], "g": g, "e2e_us": e2e})
        if top:
            self._slow.sort(key=lambda x: -x["e2e_us"])
            del self._slow[cap:]
            self.telemetry.set_exemplars(self._slow)

    # ------------------------------------------------------------------
    # durability: snapshot at batch boundaries, resume = load + replay
    # the MatchIn tail from the snapshot offset (at-least-once, like the
    # reference with exactly-once commented out — KProcessor.java:29)

    def _make_seq_session(self):
        from kme_tpu_torch.runtime.seqsession import SeqSession

        return SeqSession(self._seq_cfg(), device=self.device)

    def _seq_cfg(self):
        from kme_tpu_torch.engine import seq as SQ

        slots = self._req_slots
        if slots % 128 != 0:
            raise ValueError(
                f"the seq engine needs slots % 128 == 0, got {slots}")
        return SQ.SeqConfig(
            lanes=self._req_symbols, slots=slots,
            accounts=-(-self._req_accounts // 128) * 128,
            max_fills=self._req_max_fills, hbm_books=slots > 512,
            compat=self._compat)

    def _try_resume(self, engine: str, compat: str, shards: int,
                    width: int) -> bool:
        from kme_tpu_torch.runtime import checkpoint as ck

        if engine == "seq":
            if compat == "java":
                # the previous incarnation may have DEGRADED to the
                # native engine mid-stream (a barrier left the java
                # device surface, _degrade_to_native) and checkpointed
                # there — the NEWEST snapshot across kinds wins; the
                # .npz offsets are listed WITHOUT restoring so the
                # degraded-restart path never pays the device import
                seq_snaps = ck.list_snapshots(self.checkpoint_dir)
                seq_off = seq_snaps[0][0] if seq_snaps else -1
                nat, noff = ck.load_native(self.checkpoint_dir)
                if nat is not None and nat.java and noff > seq_off:
                    self._native = nat
                    self.offset = self._last_ckpt_offset = noff
                    print(f"kme-serve: resumed DEGRADED (native) "
                          f"java continuation at offset {noff}",
                          file=sys.stderr)
                    return True
            ses, offset = ck.load_seq_session(
                self.checkpoint_dir, self._seq_cfg(), device=self.device)
            if ses is None:
                return False
            self._session = ses
        elif engine == "lanes":
            # elastic restore onto the REQUESTED topology (snapshots are
            # canonical across width)
            ses, offset = ck.load_session(self.checkpoint_dir,
                                          shards=shards, width=width,
                                          device=self.device)
            if ses is None:
                return False
            want = {"lanes": self._req_symbols, "accounts": self._req_accounts,
                    "slots": self._req_slots, "max_fills": self._req_max_fills}
            have = {k: getattr(ses.cfg, k) for k in want}
            if want != have:
                raise ValueError(
                    f"snapshot in {self.checkpoint_dir} has capacity "
                    f"config {have}, but {want} was requested — capacity "
                    f"changes need a state migration, not a resume")
            self._session = ses
        elif engine == "native":
            nat, offset = ck.load_native(self.checkpoint_dir)
            if nat is None:
                return False
            self._check_resume_compat(nat, compat)
            if not nat.java:
                want = (self._req_slots, self._req_max_fills)
                have = (nat.book_slots, nat.max_fills)
                if want != have:
                    raise ValueError(
                        f"snapshot in {self.checkpoint_dir} has envelope "
                        f"(slots, max_fills)={have}, but {want} was "
                        f"requested — capacity changes need a state "
                        f"migration, not a resume")
            self._native = nat
        else:
            ora, offset = ck.load_oracle(self.checkpoint_dir)
            if ora is None:
                return False
            self._check_resume_compat(ora, compat)
            self._oracle = ora
        self.offset = self._last_ckpt_offset = offset
        print(f"kme-serve: resumed from snapshot at offset {offset}",
              file=sys.stderr)
        return True

    def _check_resume_compat(self, engine_obj, compat: str) -> None:
        snap_compat = "java" if engine_obj.java else "fixed"
        if snap_compat != compat:
            raise ValueError(
                f"snapshot in {self.checkpoint_dir} was taken with "
                f"compat={snap_compat!r}, but compat={compat!r} was "
                f"requested")

    def _maybe_checkpoint(self) -> None:
        if self.checkpoint_dir is None or self.follower:
            # a follower shares the leader's checkpoint dir read-only:
            # writing snapshots from two processes would race the prune
            return
        if self.offset - self._last_ckpt_offset < self.checkpoint_every:
            return
        self.checkpoint()

    def checkpoint(self) -> None:
        """Snapshot engine state + input offset (batch boundary)."""
        from kme_tpu_torch.runtime import checkpoint as ck

        if getattr(self, "_pipe", None):
            # a snapshot must capture engine state at a committed
            # offset boundary — collect every in-flight batch first
            self._drain_pipeline()
        # make the input log durable BEFORE committing an offset into it:
        # the snapshot is fsync'd, so without this a power loss could
        # leave an offset addressing MatchIn records the OS never wrote
        sync = getattr(self.broker, "sync", None)
        if sync is not None:
            from kme_tpu_torch.bridge.broker import BrokerError

            try:
                sync()
            except (BrokerError, OSError) as e:
                # OSError covers the in-process broker's own fsync
                # failing (disk full / EIO) — defer, don't die
                print(f"kme-serve: broker sync failed before checkpoint "
                      f"({e}); snapshot deferred", file=sys.stderr)
                return
        extra = {"sample_seq": self.sample_seq}
        if self.epoch is not None:
            from kme_tpu_torch.bridge import lease
            from kme_tpu_torch.bridge.broker import BrokerFenced

            if faults.should("lease.steal", offset=self.offset):
                # split-brain drill: another incarnation grabs the next
                # epoch (and, like any real new leader, fences us at
                # the broker)
                stolen = lease.steal(self.checkpoint_dir)
                fence = getattr(self.broker, "fence", None)
                if fence is not None:
                    fence(stolen)
                print(f"kme-faults: lease stolen (epoch {stolen}) at "
                      f"offset {self.offset}", file=sys.stderr)
            cur = lease.current_epoch(self.checkpoint_dir)
            if cur > self.epoch:
                # self-fence before writing anything: a newer leader
                # owns the stream; our snapshot would roll ITS state
                # machine back
                raise BrokerFenced(
                    f"fenced: leader epoch {self.epoch} superseded by "
                    f"{cur}; refusing to checkpoint")
            extra.update(epoch=self.epoch, out_seq=self.out_seq)
            if self.topic_xfer is not None:
                # the pending_reserve ledger rides the snapshot so a
                # resumed leader reports continuous cross-shard totals;
                # the transfer LEGS themselves regenerate from MatchIn
                # replay and dedup on their (epoch, out_seq) stamps
                extra["pending_reserve"] = dict(self._xfer)
        if self._session is not None:
            from kme_tpu_torch.runtime.seqsession import SeqSession

            if isinstance(self._session, SeqSession):
                ck.save_seq_session(self.checkpoint_dir, self._session,
                                    self.offset, keep=self.checkpoint_keep,
                                    extra=extra)
            else:
                ck.save_session(self.checkpoint_dir, self._session,
                                self.offset, keep=self.checkpoint_keep,
                                extra=extra)
        elif self._native is not None:
            ck.save_native(self.checkpoint_dir, self._native, self.offset,
                           keep=self.checkpoint_keep, extra=extra)
        else:
            ck.save_oracle(self.checkpoint_dir, self._oracle, self.offset,
                           keep=self.checkpoint_keep, extra=extra)
        self._last_ckpt_offset = self.offset
        if self.journal is not None:
            # the journal is best-effort relative to the broker log, but
            # a snapshot is a natural durability point for it too
            self.journal.flush()
        if self.auditor is not None and self._session is not None:
            # checkpoint-cadence cross-check: the shadow ledger against
            # the state the card's kernels left (exported) + the
            # device histograms
            found = self.auditor.check_engine(
                self._session.export_state(), self._session.histograms())
            self.engine_checks.append((self.offset, len(found)))

    # ------------------------------------------------------------------

    def _parse(self, value: str):
        from kme_tpu_torch.wire import EnvelopeError, parse_order

        try:
            m = parse_order(value)
            # the Jackson envelope: price/size are Java int fields, so
            # out-of-int32 values kill the reference's deserializer
            # (KProcessor.java:513-517) exactly like non-JSON input —
            # same drop/strict policy, for every engine
            if not (-2**31 <= m.price < 2**31 and -2**31 <= m.size < 2**31):
                raise EnvelopeError(
                    f"price/size outside int32 (price={m.price}, "
                    f"size={m.size})")
            return m
        except (ValueError, EnvelopeError):
            if self.strict:
                raise
            print(f"kme-serve: dropping malformed record: {value[:120]!r}",
                  file=sys.stderr)
            return None

    def step(self, timeout: float = 0.5) -> int:
        """Poll once: fetch up to `batch` records, process, produce the
        record stream. Returns the number of input records consumed."""
        if self._pipe is not None and self._session is not None:
            return self._step_pipelined(timeout)
        from kme_tpu_torch.bridge.broker import BrokerError

        try:
            recs = self.broker.fetch(self.topic_in, self.offset, self.batch,
                                     timeout=timeout)
        except BrokerError:
            # topics not provisioned yet — keep polling, like a Streams
            # app waiting for its source topic
            self.clock.sleep(min(timeout, 0.05))
            return 0
        if not recs:
            return 0
        return self._process_batch(recs)

    def _observe_batch(self, n, atss, done_us, plan_d, dev_d) -> None:
        """Charge a batch's stage wall times to every order in it, e2e
        from each record's own admission stamp (shared by the serial and
        pipelined paths)."""
        lat = self._lat
        if plan_d > 0:
            lat["plan"].observe(plan_d, n)
        if dev_d > 0:
            lat["device"].observe(dev_d, n)
            self.telemetry.gauge(
                "device_ms_per_batch",
                "device wall time of the last batch").set(
                round(dev_d * 1e3, 3))
        if self._last_produce_s > 0:
            lat["produce"].observe(self._last_produce_s, n)
        e2e_hot = 0.0
        for ats in atss:
            if ats is not None:
                d = max(0, done_us - ats) * 1e-6
                lat["e2e"].observe(d)
                if d > e2e_hot:
                    e2e_hot = d
        ctl = getattr(self.broker, "overload", None)
        if ctl is not None and e2e_hot > 0:
            # admission-to-produce feed for the degradation state
            # machine (latency can trip shedding before backlog does)
            ctl.observe_latency(e2e_hot)

    def _process_batch(self, recs) -> int:
        """Serial batch processing: parse, engine, produce, commit —
        the per-record authority every engine/compat combination
        supports (the pipelined path delegates here for batches with
        malformed or out-of-envelope records)."""
        import time as _t

        fetch_us = self.clock.time_us()
        msgs, offs, drops, atss = [], [], [], []
        for r in recs:
            ats = getattr(r, "ats", None)
            if ats is not None:
                self._lat["ingress"].observe(max(0, fetch_us - ats) * 1e-6)
            m = self._parse(r.value)
            if m is not None:
                msgs.append(m)
                offs.append(r.offset)
                atss.append(ats)
            else:
                drops.append((-1, r.offset))
        out = reasons = None
        self._batch_ordinal += 1
        self._last_produce_s = 0.0
        phases = getattr(self._session, "phases", None)
        p0 = dict(phases) if phases is not None else {}
        t_engine0 = _t.perf_counter()
        if msgs:
            if self._native is not None:
                with self._ptimer.phase("serve_engine"):
                    self._flow("s")
                    out = self._native_produce(msgs)
            elif self._session is not None:
                try:
                    with self._ptimer.phase("serve_engine"):
                        self._flow("s")
                        out = self._session.process_wire(msgs)
                except Exception as e:
                    from kme_tpu_torch.runtime.seqsession import \
                        UnsupportedJavaOp

                    if not isinstance(e, UnsupportedJavaOp):
                        raise
                    # a java-mode stream left the device surface
                    # (barrier / negative-sid symbol, COMPAT.md): the
                    # router raises BEFORE any device mutation, so the
                    # session's state converts losslessly to the native
                    # engine (runtime/javasnap.py) and serving
                    # continues there — the batch replays on the
                    # native engine from the same state
                    self._degrade_to_native(str(e))
                    out = self._native_produce(msgs)
                else:
                    reasons = self._session.last_reasons
                    self._produce_lines(out)
            else:
                from kme_tpu_torch.wire import dumps_order

                with self._ptimer.phase("serve_engine"):
                    self._flow("s")
                    out = [[f"{rec.key} {dumps_order(rec.value)}"
                            for rec in self._oracle.process(m)]
                           for m in msgs]
                self._produce_lines(out)
            if self.annotate_rejects and out is not None:
                self._produce_rej_annotations(out, reasons)
        done_us = self.clock.time_us()
        n = len(msgs)
        plan_d = dev_d = 0.0
        if n:
            if phases is not None and self._session is not None:
                p1 = self._session.phases
                plan_d = p1.get("plan_s", 0.0) - p0.get("plan_s", 0.0)
                dev_d = (p1.get("dispatch_s", 0.0) + p1.get("fetch_s", 0.0)
                         - p0.get("dispatch_s", 0.0) - p0.get("fetch_s", 0.0))
            else:
                # host engines (native/oracle) have no plan/device
                # split; the whole engine wall is "device" time
                dev_d = max(0.0, _t.perf_counter() - t_engine0
                            - self._last_produce_s)
            self._observe_batch(n, atss, done_us, plan_d, dev_d)
        with self._ptimer.phase("serve_observe"):
            self._observe_serial(out, reasons, msgs, offs, drops, atss,
                                 fetch_us, done_us, plan_d, dev_d)
        # batch-boundary commit: offsets advance only after the outputs
        # for the whole batch are on MatchOut
        self.offset = recs[-1].offset + 1
        # crash window: outputs are on MatchOut but the snapshot has not
        # caught up — recovery MUST replay from the last checkpoint and
        # reproduce these bytes (leader only)
        if not self.follower:
            faults.kill_now("serve.kill", offset=self.offset)
        self._maybe_checkpoint()
        self._commit_watermark()
        self._publish_batch(len(recs), len(recs) - len(msgs))
        return len(recs)

    def _observe_serial(self, out, reasons, msgs, offs, drops, atss,
                        fetch_us, done_us, plan_d, dev_d) -> None:
        """The serial path's observability at the batch barrier: the
        journal (and the auditor, its observer), per-order stamps and
        spans, watchpoints (the `serve_observe` span)."""
        n = len(msgs)
        if self.journal is not None and (out or drops):
            jout = out or []
            if self._journal_tamper is not None:
                jout = self._journal_tamper(jout)
            self.journal.record_batch(jout, reasons=reasons,
                                      offsets=offs[:len(out or [])],
                                      drops=drops)
        if n:
            # full batch wall per order (what the order EXPERIENCED),
            # not an amortized per-order share
            self._stamp_orders(
                offs[:n], [int(m.oid) for m in msgs],
                [int(m.aid) for m in msgs], atss, fetch_us, done_us,
                int(plan_d * 1e6), int(dev_d * 1e6),
                int(self._last_produce_s * 1e6),
                batch=self._batch_ordinal)
        if self.watch is not None and n:
            # batch barrier, after _stamp_orders so a firing capture
            # embeds this batch's trace exemplars; never the
            # journal-tamper copy. The serving oracle IS the state
            # machine and is read directly; every other engine feeds
            # the shadow ledger from the batch's own output lines.
            if self._oracle is not None:
                self.watch.observe_engine(self._oracle, offs[n - 1],
                                          exemplars=self._slow)
            elif out:
                self.watch.observe_lines(out, reasons=reasons,
                                         offsets=offs[:len(out)],
                                         drops=drops,
                                         exemplars=self._slow)

    # -- pipelined serving: submit N+1 while N runs on the card

    def _parse_batch(self, recs):
        """Columnar parse of a fetched batch (native kme_parse). Returns
        a WireBatch when EVERY record parses clean and passes the
        reference's int32 price/size envelope — the hot case; None
        sends the batch through the per-record _parse path (whose
        drop/strict policy is the authority for bad input)."""
        import numpy as np

        from kme_tpu_torch.wire import WireBatch

        try:
            payload = b"\n".join(
                v if isinstance(v, bytes) else v.encode()
                for v in (r.value for r in recs))
            wb = WireBatch.parse_buffer(payload)
        except (ValueError, OverflowError, UnicodeEncodeError,
                AttributeError):
            return None
        if wb.n != len(recs):
            return None  # embedded newlines / empty values
        lim = 1 << 31
        if not (np.all(wb.price >= -lim) and np.all(wb.price < lim)
                and np.all(wb.size >= -lim) and np.all(wb.size < lim)):
            return None
        return wb

    def _step_pipelined(self, timeout: float = 0.5) -> int:
        """Poll once in pipelined mode: parse + plan + DISPATCH this
        batch without waiting on the card, then retire the oldest
        in-flight batch once the window exceeds `pipeline`. The fetch
        cursor runs ahead of the committed offset by the in-flight
        window; self.offset still advances only at collect time."""
        from kme_tpu_torch.bridge.broker import BrokerError

        fetch_off = self._pipe[-1][0] if self._pipe else self.offset
        try:
            recs = self.broker.fetch(self.topic_in, fetch_off, self.batch,
                                     timeout=timeout)
        except BrokerError:
            self.clock.sleep(min(timeout, 0.05))
            return 0
        if not recs:
            # idle input: finish the in-flight window so output
            # visibility and offsets never stall behind an empty poll
            self._drain_pipeline()
            return 0
        wb = self._parse_batch(recs)
        if wb is None:
            # malformed / out-of-envelope records: drain, then run the
            # batch through the exact per-record path (drops, strict)
            self._drain_pipeline()
            return self._process_batch(recs)
        fetch_us = self.clock.time_us()
        atss = []
        for r in recs:
            ats = getattr(r, "ats", None)
            atss.append(ats)
            if ats is not None:
                self._lat["ingress"].observe(max(0, fetch_us - ats) * 1e-6)
        end_off = recs[-1].offset + 1
        if (self.checkpoint_dir is not None and not self.follower
                and self._pipe
                and end_off - self._last_ckpt_offset
                >= self.checkpoint_every):
            # a due snapshot needs a drained pipeline (engine state at
            # a committed offset boundary); drain BEFORE submitting so
            # the cadenced checkpoint fires at this batch's collect
            self._drain_pipeline()
        self._batch_ordinal += 1
        phases = self._session.phases
        p0 = dict(phases)
        with self._ptimer.phase("serve_engine"):
            self._flow("s")
            handle = self._session.submit(wb)
        plan_d = phases.get("plan_s", 0.0) - p0.get("plan_s", 0.0)
        self._pipe.append((end_off, handle, wb,
                           [r.offset for r in recs], atss, fetch_us,
                           plan_d, self._batch_ordinal))
        while len(self._pipe) > self.pipeline:
            self._collect_one()
        return len(recs)

    def _collect_one(self) -> None:
        """Retire the oldest in-flight batch: fetch + reconstruct its
        outputs, produce, and only THEN advance the committed offset.
        Checkpoints wait for an empty pipeline: a snapshot must pair
        engine state with an offset whose every predecessor is visible
        on MatchOut."""
        (end_off, handle, wb, offs, atss, fetch_us, plan_d,
         ordinal) = self._pipe.popleft()
        self._last_produce_s = 0.0
        phases = self._session.phases
        p0 = dict(phases)
        with self._ptimer.phase("serve_engine"):
            buf, line_off, msg_lines = self._session.collect(handle)
        reasons = self._session.last_reasons
        # device attribution under pipelining: what the batch WAITED at
        # fetch time (overlapped device work the host never sees is the
        # point of the pipeline)
        dev_d = phases.get("fetch_s", 0.0) - p0.get("fetch_s", 0.0)
        self._produce_buffer(buf, line_off, ordinal)
        done_us = self.clock.time_us()
        n = wb.n
        self._observe_batch(n, atss, done_us, plan_d, dev_d)
        with self._ptimer.phase("serve_observe"):
            out = None
            if (self.journal is not None or self.watch is not None) and n:
                out = self._lines_of(buf, line_off, msg_lines)
            if self.journal is not None and n:
                jout = out
                if self._journal_tamper is not None:
                    jout = self._journal_tamper(jout)
                self.journal.record_batch(jout, reasons=reasons,
                                          offsets=offs, drops=[])
            if n:
                self._stamp_orders(
                    offs, wb.oid.tolist(), wb.aid.tolist(), atss,
                    fetch_us, done_us, int(plan_d * 1e6),
                    int(dev_d * 1e6), int(self._last_produce_s * 1e6),
                    batch=ordinal)
            if self.watch is not None and out:
                self.watch.observe_lines(out, reasons=reasons,
                                         offsets=offs, drops=[],
                                         exemplars=self._slow)
        self.offset = end_off
        if not self.follower:
            faults.kill_now("serve.kill", offset=self.offset)
        if not self._pipe:
            # engine state now equals the committed offset — the only
            # point where a snapshot is coherent under pipelining
            self._maybe_checkpoint()
        self._commit_watermark()
        self._publish_batch(n, 0)

    def _drain_pipeline(self) -> None:
        """Collect every in-flight batch (idle input, a slow-path
        batch, a due checkpoint, shutdown)."""
        while self._pipe:
            self._collect_one()

    @staticmethod
    def _lines_of(buf, line_off, msg_lines):
        """Reconstruction buffer -> per-message line lists (the journal
        and watch surfaces speak lines)."""
        text = buf.decode("ascii")
        lo = line_off.tolist()
        out, li = [], 0
        for nl in msg_lines.tolist():
            out.append([text[lo[li + k]:lo[li + k + 1]]
                        for k in range(nl)])
            li += nl
        return out

    def _produce_buffer(self, buf, line_off, ordinal=None) -> None:
        """Produce a reconstructed record buffer line by line — the
        collect-side twin of _produce_lines."""
        import time as _t

        t0 = _t.perf_counter()
        with self._ptimer.phase("serve_produce"):
            self._flow("f", ordinal)
            text = buf.decode("ascii")
            lo = line_off.tolist()
            for i in range(len(lo) - 1):
                key, _, value = text[lo[i]:lo[i + 1]].partition(" ")
                self._produce_out(key, value)
        self._last_produce_s += _t.perf_counter() - t0

    def _publish_batch(self, nrecs: int, ndropped: int) -> None:
        """Per-batch service counters + a rate-limited engine refresh.
        Runs on the POLL THREAD only: the engine refresh reads device
        state, which the heartbeat thread must never do — it reads
        registry snapshots."""
        t = self.telemetry
        t.counter("service_batches").inc()
        t.counter("service_records").inc(nrecs)
        t.counter("service_dropped").inc(ndropped)
        t.gauge("service_offset").set(self.offset)
        if faults.active():
            t.gauge("faults_injected").set(faults.fired_total())
        shed = getattr(self.broker, "overload_rejects", None)
        if shed is not None:
            t.gauge("overload_rejects").set(shed)
        nbin = getattr(self.broker, "wire_binary_records", None)
        if nbin is not None:
            njson = self.broker.wire_json_records
            total = nbin + njson
            t.gauge("wire_binary_frac",
                    "fraction of ingress records that arrived as "
                    "binary wire frames").set(
                round(nbin / total, 6) if total else 0.0)
            t.gauge("parse_ns_per_msg",
                    "mean wire-frame decode cost per binary "
                    "record (ns)").set(
                round(self.broker.wire_parse_ns / nbin) if nbin else 0)
        ov = getattr(self._session, "h2d_overlap_frac", None)
        if ov:
            t.gauge("h2d_overlap_frac",
                    "fraction of host->device staging time "
                    "overlapped with device execution").set(ov)
        ctl = getattr(self.broker, "overload", None)
        if ctl is not None:
            t.gauge("overload_state",
                    "degradation state: 0 normal / 1 shedding / "
                    "2 draining").set(ctl.state)
            t.gauge("overload_backoff_ms",
                    "AIMD producer backoff hint carried on "
                    "rej_overload").set(ctl.backoff_ms)
            t.gauge("overload_transitions",
                    "degradation state-machine transitions").set(
                ctl.transitions)
            t.gauge("overload_fairness_sheds",
                    "class-2 sheds forced by the per-account "
                    "fairness cap").set(ctl.fairness_sheds)
            for cls in range(3):
                t.gauge(f"shed_by_class{cls}").set(
                    ctl.shed_by_class[cls])
                t.gauge(f"admitted_by_class{cls}").set(
                    ctl.admitted_by_class[cls])
            if self._shed_pending is not None:
                self._drain_shed_annotations()
        self._publish_eos_gauges()
        if self.journal is not None:
            t.gauge("journal_last_offset",
                    "input offset of the newest committed journal "
                    "record").set(self.journal.last_offset)
            t.gauge("journal_lag_bytes",
                    "bytes accepted by the journal but not yet "
                    "committed by its writer").set(self.journal.lag_bytes)
        ph = getattr(self._session, "phases", None) \
            if self._session is not None else None
        if ph:
            # host-path attribution: cumulative wall seconds the serve
            # loop spent OFF the device
            plan = ph.get("plan_s", 0.0)
            recon = ph.get("recon_s", 0.0)
            t.gauge("plan_s",
                    "cumulative host planning wall (s)").set(
                round(plan, 6))
            t.gauge("recon_s",
                    "cumulative output reconstruction wall (s)").set(
                round(recon, 6))
            t.gauge("host_path_s",
                    "cumulative host-path wall: plan + "
                    "reconstruction (s)").set(round(plan + recon, 6))
        if self._pipe is not None:
            t.gauge("pipeline_depth",
                    "in-flight pipelined batches").set(len(self._pipe))
        now = self.clock.monotonic()
        if now - self._last_engine_pub >= 1.0:
            self._last_engine_pub = now
            if self._session is not None:
                self._session.metrics()   # publishes counters + gauges
                self._session.histograms()  # publishes bucket counts
            if self.slo is not None:
                # SLO degradation rides the same heartbeat channel as
                # an audit violation; the auditor's verdict wins
                self._slo_reason = self.slo.evaluate()
            if self.profiler is not None:
                self.profiler.publish(t)
            if self.capture is not None:
                # trigger-based capture: SLO burn or a p99 exemplar
                # past threshold records a bounded profile window whose
                # span ids resolve through kme-torch-trace
                fired = self.capture.maybe_fire(self._slo_reason,
                                                t.exemplars())
                if fired:
                    print(f"kme-serve: profile capture {fired}",
                          file=sys.stderr)

    def _publish_eos_gauges(self) -> None:
        """Exactly-once observability (cheap broker-attribute reads;
        safe from the heartbeat thread too)."""
        t = self.telemetry
        for name, attr in (("dup_suppressed_total", "dup_suppressed"),
                           ("fenced_produces_total", "fenced_produces")):
            v = getattr(self.broker, attr, None)
            if v is not None:
                t.gauge(name).set(v)
        if self.epoch is not None:
            t.gauge("leader_epoch").set(self.epoch)
        if self.topic_xfer is not None:
            self._publish_group_gauges()

    def _publish_group_gauges(self) -> None:
        """Per-group scale-out surface: identity, input lag behind the
        group's own MatchIn topic, and the cross-shard transfer ledger.
        Gauges (not counters) so a resumed leader republishes the
        checkpointed totals without double counting."""
        t = self.telemetry
        gk = self.group_id
        t.gauge("group_id").set(gk)
        t.gauge("group_count").set(self.group_count)
        end = getattr(self.broker, "end_offset", None)
        if end is not None:
            from kme_tpu_torch.bridge.broker import BrokerError

            try:
                t.gauge(f"group{gk}_lag",
                        "input records admitted to this group's "
                        "MatchIn topic but not yet applied").set(
                    max(0, end(self.topic_in) - self.offset))
            except BrokerError:
                pass    # topic not provisioned yet
        x = self._xfer
        t.gauge("cross_shard_transfers_total",
                "applied cross-shard balance-transfer legs").set(
            x["legs"])
        t.gauge("cross_shard_transfer_volume",
                "cents moved across groups (credits+debits)").set(
            x["credits"] + x["debits"])
        t.gauge("cross_shard_rejected_total").set(x["rejected"])
        t.gauge("balance_broadcasts_total").set(x["broadcasts"])

    def _produce_retry(self, topic: str, key, value,
                       stamp: bool = False) -> None:
        """Produce with bounded exponential backoff. A transport blip
        (socket reset, injected broker.produce fault) must not kill the
        serve loop mid-batch: the offset has NOT advanced yet, so a
        retry is safe — at worst the record lands twice, which the
        at-least-once contract allows and the exactly-once stamp path
        dedups broker-side. `stamp=True` marks an output-stream record:
        a leader sends it with its `(epoch, out_seq)` stamp; a follower
        only COUNTS it. BrokerFenced is never retried — a newer leader
        owns the stream and this process must die."""
        from kme_tpu_torch.bridge.broker import BrokerError, BrokerFenced

        stamped = stamp and self.epoch is not None
        counted = stamp and (stamped
                             or (self.follower and self.exactly_once))
        delay = 0.05
        for attempt in range(6):
            try:
                if stamped:
                    self.broker.produce(topic, key, value,
                                        epoch=self.epoch,
                                        out_seq=self.out_seq)
                else:
                    self.broker.produce(topic, key, value)
                if counted:
                    self.out_seq += 1
                return
            except BrokerFenced:
                raise
            except BrokerError as e:
                if attempt == 5:
                    raise
                self.telemetry.counter("broker_retries").inc()
                print(f"kme-serve: produce to {topic} failed ({e}); "
                      f"retry {attempt + 1}/5 in {delay:.2f}s",
                      file=sys.stderr)
                self.clock.sleep(delay)
                delay = min(delay * 2, 1.0)

    def _produce_out(self, key, value) -> None:
        """Route one output line: organic records go to this group's
        MatchOut stream; front-injected cross-shard lines (the
        XFER_MARK passthrough stamp in `prev` — bridge/front.py) are
        suppressed from the merged feed and land STAMPED on the
        per-group Xfer topic instead, so every applied transfer leg
        leaves one fenced `(epoch, out_seq)` row of durable dedup
        evidence. Both paths consume the same out_seq cursor, keeping
        the stamp stream deterministic across crash-replay."""
        if self._xfer_mark is not None and self._xfer_mark in value:
            self._produce_xfer(key, value)
        else:
            self._produce_retry(self.topic_out, key, value, stamp=True)

    def _produce_xfer(self, key, value) -> None:
        import json
        import time as _t

        t0 = _t.perf_counter()
        self._produce_retry(self.topic_xfer, key, value, stamp=True)
        lat = self._lat.get("transfer")
        if lat is not None:
            lat.observe(_t.perf_counter() - t0)
        if key != "OUT":
            return      # ledger counts each leg once, on its result
        try:
            msg = json.loads(value)
            action, size = int(msg["action"]), int(msg["size"])
        except (ValueError, KeyError, TypeError):
            return
        x = self._xfer
        from kme_tpu_torch import opcodes as op

        if action == op.TRANSFER:
            x["legs"] += 1
            if size >= 0:
                x["credits"] += size
            else:
                x["debits"] -= size
        elif action == op.CREATE_BALANCE:
            x["broadcasts"] += 1
        elif action == op.REJECT:
            x["rejected"] += 1

    def _flow(self, phase: str, ordinal: Optional[int] = None) -> None:
        """Trace flow arrow endpoint for the current batch: "s" inside
        the engine span, "f" inside the produce span. Pipelined
        collects pass their submit-time ordinal explicitly."""
        from kme_tpu_torch.telemetry import get_tracer

        tr = get_tracer()
        if tr is not None:
            tr.flow("batch", phase,
                    self._batch_ordinal if ordinal is None else ordinal,
                    track="serve")

    def _produce_lines(self, out) -> None:
        import time as _t

        t0 = _t.perf_counter()
        with self._ptimer.phase("serve_produce"):
            self._flow("f")
            for lines in out:
                for ln in lines:
                    key, _, value = ln.partition(" ")
                    self._produce_out(key, value)
        # accumulates across the branch paths that produce more than
        # once per step (native partial + REJ annotations)
        self._last_produce_s += _t.perf_counter() - t0

    def _native_produce(self, msgs):
        # byte-faithful death handling: forward every completed
        # message's records, THEN die like the reference thread
        out, exc = self._native.process_wire_partial(msgs)
        self._produce_lines(out)
        if exc is not None:
            raise exc
        return out

    def _produce_rej_annotations(self, out, reasons) -> None:
        """Opt-in per-order reject causes as ADDITIVE "REJ"-keyed
        MatchOut records (wire.rej_record_json) — the IN/OUT stream
        stays byte-identical to the reference. Engines without exact
        codes (native/oracle) get the action heuristic."""
        import json

        from kme_tpu_torch.wire import (REJ_UNSPECIFIED, reason_for_reject,
                                        rej_record_json)

        for i, lines in enumerate(out):
            if not lines or '"action":7,' not in lines[-1]:
                continue
            m = json.loads(lines[0].partition(" ")[2])
            code = (int(reasons[i]) if reasons is not None
                    else reason_for_reject(m["action"]))
            if code == 0:
                code = REJ_UNSPECIFIED
            self._produce_retry(self.topic_out, "REJ", rej_record_json(
                m["oid"], m["aid"], code))

    def _drain_shed_annotations(self) -> None:
        """REJ rows for controller sheds: the shed never reached the
        engine, so the annotation is its only durable trace."""
        from kme_tpu_torch.wire import REJ_OVERLOAD, rej_record_json

        q = self._shed_pending
        while True:
            try:
                d = q.popleft()
            except IndexError:
                break
            self._produce_retry(self.topic_out, "REJ", rej_record_json(
                d.get("oid", 0), d.get("aid", 0), REJ_OVERLOAD,
                detail={"backlog": d["backlog"],
                        "threshold": d["threshold"],
                        "state": d["state"],
                        "backoff_ms": d["backoff_ms"]}))

    def _degrade_to_native(self, reason: str) -> None:
        """One-way engine degradation for java-mode streams that leave
        the device surface (COMPAT.md): the seq session's state
        converts losslessly to the native engine (runtime/javasnap.py)
        and serving continues there — the full java wire surface incl.
        barriers. Checkpoints switch to native snapshots; a restart
        resumes the degraded continuation (_try_resume)."""
        from kme_tpu_torch.native.oracle import NativeOracleEngine, \
            native_available
        from kme_tpu_torch.runtime.javasnap import export_seqjava, \
            to_native_dump

        if not native_available():
            raise RuntimeError(
                f"java stream left the device surface ({reason}) and "
                f"the native engine is unavailable to degrade onto "
                f"(KME_NATIVE=0) — serve this stream with "
                f"engine='native' or 'oracle'")
        print(f"kme-serve: java stream left the device surface "
              f"({reason}); continuing on the native engine",
              file=sys.stderr)
        eng = NativeOracleEngine("java")
        eng.load_state(to_native_dump(export_seqjava(self._session)))
        self._native = eng
        self._session = None

    def metrics(self) -> Optional[dict]:
        """On-device counters+gauges (session engines; None otherwise)."""
        return self._session.metrics() if self._session is not None else None

    def run(self, max_messages: Optional[int] = None,
            idle_exit: Optional[float] = None,
            poll_timeout: float = 0.5,
            health_file: Optional[str] = None,
            health_every: float = 1.0) -> int:
        """Serve until max_messages consumed (None = forever) or the
        input topic stays idle for `idle_exit` seconds.

        health_file: heartbeat surface for a supervisor — a JSON
        snapshot {pid, time, seen, offset, tick} atomically replaced
        every `health_every` seconds FROM A BACKGROUND THREAD (which
        reads registry snapshots only, never the card), so a long step
        does not read as a hang; a stale mtime means the PROCESS froze
        or died."""
        import threading
        import time

        seen = 0
        beat_stop = None
        seen_box = [0]
        tick_box = [0]
        # the beater thread also runs when only a TSDB is configured
        # (health_file=None): metrics history wants the same heartbeat
        # cadence whether or not a supervisor is watching
        if health_file is not None or self.tsdb is not None:
            beat_stop = threading.Event()
            self._hb_every = float(health_every)
            state = self

            def beater():
                while not beat_stop.wait(health_every):
                    state._write_heartbeat(health_file, seen_box[0],
                                           tick_box[0])

            self._write_heartbeat(health_file, 0, 0)
            beat = threading.Thread(target=beater, daemon=True)
            beat.start()
        try:
            idle_since = self.clock.monotonic()
            while max_messages is None or seen < max_messages:
                n = self.step(timeout=poll_timeout)
                tick_box[0] += 1
                now = self.clock.monotonic()
                if n == 0:
                    if idle_exit is not None \
                            and now - idle_since >= idle_exit:
                        break
                else:
                    idle_since = now
                    seen += n
                    seen_box[0] = seen
                if n and not self.follower \
                        and faults.should("serve.stuck",
                                          offset=self.offset):
                    # stuck step(): the loop tick freezes while the
                    # heartbeat thread keeps the mtime fresh — the hang
                    # shape a supervisor's stall detector looks for
                    print(f"kme-faults: serve loop stuck at offset "
                          f"{self.offset}", file=sys.stderr)
                    while True:
                        time.sleep(0.5)
        finally:
            try:
                if self._pipe:
                    # in-flight batches hold committed-but-invisible
                    # work — finish them before the final heartbeat
                    self._drain_pipeline()
            finally:
                if beat_stop is not None:
                    beat_stop.set()
                    # the beater's last write (heartbeat file, TSDB
                    # append) must land before the closing one
                    beat.join()
                    self._write_heartbeat(health_file, seen,
                                          tick_box[0], closing=True)
        return seen

    def _write_heartbeat(self, path: Optional[str], seen: int,
                         tick: int = 0, closing: bool = False) -> None:
        import json
        import os

        # refresh broker-side exactly-once counters HERE, not only on
        # the batch path: the final heartbeat after run() drains must
        # capture post-batch suppressions/fences
        self._publish_eos_gauges()
        seq = self.sample_seq
        self.sample_seq = seq + 1
        snap = self.telemetry.snapshot()
        if path is None:       # TSDB-only heartbeat (no supervisor)
            self._append_tsdb(snap, seq)
            return
        # additive events-log keys: the committed-bytes cursor of this
        # process's control-plane event log (kme-torch-agg flags a
        # recorder that froze while the heartbeat kept advancing)
        ev = getattr(self, "events", None)
        evkeys = ({"events_last_offset": ev.last_offset,
                   "events_lag_bytes": ev.lag_bytes}
                  if ev is not None else {})
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            # "metrics" is ADDITIVE — the supervisor keys
            # (pid/time/seen/offset/tick) are load-bearing; "closing"
            # says the serve loop ended on purpose (idle-exit /
            # max-messages)
            json.dump({"pid": os.getpid(), "time": self.clock.time(),
                       "seen": seen, "offset": self.offset,
                       "tick": tick, "closing": closing,
                       "degraded": self.degraded or self._slo_reason,
                       "role": "follower" if self.follower else "leader",
                       "epoch": self.epoch,
                       "sample_seq": seq,
                       "every": getattr(self, "_hb_every", 1.0),
                       **evkeys,
                       "metrics": snap}, f)
        os.replace(tmp, path)
        self._append_tsdb(snap, seq)

    def _append_tsdb(self, snap: dict, seq: int) -> None:
        if self.tsdb is None:
            return
        try:
            self.tsdb.append_snapshot(snap, seq)
        except OSError as e:
            # history is best-effort; the live heartbeat is not
            print(f"kme-serve: TSDB append failed: {e}",
                  file=sys.stderr)
            self.tsdb = None
