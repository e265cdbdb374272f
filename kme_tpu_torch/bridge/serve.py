"""Engine service — the KProcessor.main role: host the broker endpoint
and pump MatchIn -> engine -> MatchOut.

The port of `kme_tpu/bridge/serve.py`, with the same argument set plus
`--device`. `kme-torch-serve` hosts both the broker and the engine: it
listens on --listen for the bridge's TCP broker protocol (provisioner /
load generator / consumer connect there) and runs the MatchService poll
loop in the foreground. Unlike `kme-serve` it binds the listener only
once the engine is built (a snapshot restored, the state on the card),
so no record is admitted to wait out the engine's start-up. Use
--auto-provision to create the topics at startup (else run
kme-torch-provision first).

The observability flags (journal, audit, SLO, span tracing, TSDB,
profiler and captures, watchpoints, /metrics) are served as in the JAX
package, and so is `--group K/N`, one group of the multi-leader
deployment behind `kme-torch-front`. `--kafka BOOTSTRAP` serves against
a Kafka cluster through the aiokafka transport (bridge/kafka.py): the
topics live there, no TCP listener is bound, `--listen`/`--log-dir` are
ignored, and the output is at-least-once (the transport carries no
produce stamps)."""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kme-torch-serve", description=__doc__)
    p.add_argument("--listen", default="127.0.0.1:9092", metavar="HOST:PORT")
    p.add_argument("--kafka", default=None, metavar="BOOTSTRAP",
                   help="serve against a REAL Kafka cluster through the "
                        "aiokafka transport (bridge/kafka.py) instead of "
                        "hosting the in-process broker: topics/offsets "
                        "live in Kafka (durable there), --listen/--log-dir "
                        "are ignored, and the reference's unmodified Node "
                        "harness can drive the engine")
    p.add_argument("--engine", choices=("seq", "lanes", "oracle",
                                        "native"),
                   default="seq",
                   help="seq = the sequential seq kernel on the card "
                        "(fixed or java compat, the flagship); lanes = "
                        "the sweep engine on the card (fixed mode); "
                        "native = C++ quirk-exact engine (fast java "
                        "compat); oracle = Python reference replica")
    p.add_argument("--compat", choices=("java", "fixed"), default="fixed")
    p.add_argument("--device", default="cuda",
                   help="where the seq and lanes engines run (default "
                        "the card; 'cpu' runs the kernels' plain "
                        "PyTorch versions); the host engines ignore it")
    p.add_argument("--batch", type=int, default=1024,
                   help="max records per engine micro-batch")
    p.add_argument("--symbols", type=int, default=1024)
    p.add_argument("--accounts", type=int, default=4096)
    p.add_argument("--slots", type=int, default=128)
    p.add_argument("--max-fills", type=int, default=16)
    p.add_argument("--width", type=int, default=8)
    p.add_argument("--shards", type=int, default=1)
    p.add_argument("--strict", action="store_true",
                   help="die on malformed input records like the "
                        "reference's serde does (KProcessor.java:513-517)")
    p.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                   help="snapshot engine state + input offset here at "
                        "batch boundaries; resume from the newest valid "
                        "snapshot at startup (at-least-once replay)")
    p.add_argument("--checkpoint-every", type=int, default=4096,
                   metavar="N", help="records between snapshots")
    p.add_argument("--checkpoint-keep", type=int, default=None,
                   metavar="N",
                   help="snapshots retained per kind (default 3, or "
                        "KME_CKPT_KEEP); deeper retention survives "
                        "multi-snapshot corruption (load falls back "
                        "newest -> older on digest/parse failure)")
    p.add_argument("--max-lag", type=int, default=None, metavar="N",
                   help="bounded ingress: reject produces to MatchIn "
                        "with a wire-level rej_overload once the "
                        "unconsumed backlog reaches N records (shed "
                        "load instead of stalling); in-process broker "
                        "only")
    p.add_argument("--overload-high-lag", type=int, default=None,
                   metavar="N",
                   help="adaptive overload control: instead of the "
                        "binary --max-lag shed, run the normal -> "
                        "shedding -> draining degradation state machine "
                        "with priority-aware admission (cancels/payouts "
                        "pass while new orders shed, per-account "
                        "fairness caps) once the MatchIn backlog "
                        "reaches N; in-process broker only")
    p.add_argument("--overload-low-lag", type=int, default=None,
                   metavar="N",
                   help="hysteresis low-water mark: leave shedding once "
                        "the backlog falls to N (default high/2)")
    p.add_argument("--overload-drain-lag", type=int, default=None,
                   metavar="N",
                   help="draining high-water mark: admit ONLY book-"
                        "shrinking traffic (cancel/payout/remove) past "
                        "N (default 2*high)")
    p.add_argument("--overload-p99-ms", type=float, default=None,
                   metavar="MS",
                   help="also enter shedding when the admission-to-"
                        "produce latency EWMA exceeds MS ms, even "
                        "below the backlog threshold")
    p.add_argument("--overload-account-cap", type=float, default=0.5,
                   metavar="FRAC",
                   help="per-account fairness cap: shed an account's "
                        "new orders while it holds more than FRAC of "
                        "the recent admitted-order window (default 0.5)")
    p.add_argument("--log-dir", default=None, metavar="DIR",
                   help="persist topic logs here (append-only JSONL) so "
                        "the broker survives restarts; defaults to "
                        "<checkpoint-dir>/broker-log when checkpointing "
                        "is on — the restored input offset must address "
                        "the same MatchIn records after a restart")
    p.add_argument("--auto-provision", action="store_true")
    p.add_argument("--max-messages", type=int, default=None)
    p.add_argument("--idle-exit", type=float, default=None, metavar="SECS")
    p.add_argument("--health-file", default=None, metavar="PATH",
                   help="write a {pid, time, seen, offset} heartbeat JSON "
                        "here (atomic replace) every --health-every "
                        "seconds; kme-supervise watches its mtime")
    p.add_argument("--health-every", type=float, default=1.0)
    p.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                   help="serve Prometheus text exposition on "
                        "http://0.0.0.0:PORT/metrics (and JSON on "
                        "/metrics.json) while the service runs; 0 picks "
                        "a free port (printed to stderr)")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="write a Chrome trace-event JSON (chrome://"
                        "tracing / Perfetto) of the engine phase "
                        "timeline here at exit")
    p.add_argument("--journal-out", default=None, metavar="PATH",
                   help="order-lifecycle flight recorder: append every "
                        "order's journey (submit/accept/reject/fills/"
                        "rest/cancel/payout with provenance stamps) "
                        "here; .bin/.kmej selects the compact binary "
                        "framing, anything else JSONL. Query with "
                        "kme-trace")
    p.add_argument("--trace-spans", action="store_true",
                   help="journal distributed-tracing span events "
                        "(ingress/plan/device/produce per order, keyed "
                        "by the deterministic group-local trace id) "
                        "alongside the lifecycle stream; needs "
                        "--journal-out. Stitch cluster-wide waterfalls "
                        "with kme-trace --cluster")
    p.add_argument("--journal-rotate-mb", type=int, default=None,
                   metavar="MB", help="rotate the journal (logrotate-"
                        "style PATH -> PATH.1 shifts) once the live "
                        "file exceeds MB MiB")
    p.add_argument("--journal-fsync", choices=("off", "batch"),
                   default="off",
                   help="batch = fsync the journal after every batch "
                        "(bounds loss to one batch); off = OS "
                        "buffering, flushed at checkpoints and exit")
    p.add_argument("--journal-keep", type=int, default=None, metavar="N",
                   help="retain at most N rotated journal segments — "
                        "but NEVER prune one newer than the oldest "
                        "retained snapshot (a standby restoring it "
                        "must still replay to the tip)")
    p.add_argument("--at-least-once", action="store_true",
                   help="disable the exactly-once output path (leader "
                        "epoch + fenced idempotent produce stamps) "
                        "that is otherwise on whenever "
                        "--checkpoint-dir is set: replayed post-"
                        "snapshot tails land on MatchOut again instead "
                        "of being suppressed broker-side")
    p.add_argument("--audit", action="store_true",
                   help="run the continuous invariant auditor in-"
                        "process: a shadow ledger replays the journal "
                        "stream per batch and checks conservation "
                        "invariants; violations increment "
                        "audit_violations, mark the heartbeat degraded "
                        "and dump a minimized repro (fixed mode only; "
                        "requires --journal-out)")
    p.add_argument("--audit-repro-dir", default=None, metavar="DIR",
                   help="write audit violation repro dumps here "
                        "(replayable with kme-trace --replay-repro)")
    p.add_argument("--slo-p99-ms", type=float, default=None,
                   metavar="MS",
                   help="latency SLO: keep the p99 of --slo-stage under "
                        "MS ms; sustained error-budget burn > 1 marks "
                        "the heartbeat degraded (the supervisor channel "
                        "audit violations already use) and flips the "
                        "slo_ok gauge")
    p.add_argument("--slo-stage", default="e2e",
                   choices=("ingress", "plan", "device", "produce",
                            "e2e", "consume"),
                   help="which latency stage the SLO judges")
    p.add_argument("--slo-budget", type=float, default=0.001,
                   metavar="FRAC",
                   help="allowed bad-event fraction (0.001 = 99.9%% of "
                        "orders must meet the target)")
    p.add_argument("--slo-min-ops", type=int, default=100, metavar="N",
                   help="observations per window before the SLO judges "
                        "(a quiet service is not a degraded one)")
    p.add_argument("--slo-min-records-per-sec", type=float, default=0.0,
                   metavar="R", help="optional throughput floor")
    p.add_argument("--pipeline", type=int, default=0, metavar="N",
                   help="double-buffered serving: keep up to N batches "
                        "in flight — batch N+1's parse/plan/dispatch "
                        "runs under batch N's device step; offsets and "
                        "checkpoints still advance only once a batch's "
                        "outputs are visible (needs engine=seq, "
                        "compat=fixed and the native host runtime; "
                        "anything else serves serial with a note)")
    p.add_argument("--group", default=None, metavar="K/N",
                   help="serve shard group K of an N-group multi-leader "
                        "topology: the service consumes "
                        "MatchIn.gK, produces MatchOut.gK, and lands "
                        "front-injected cross-shard transfer legs on "
                        "the stamped Xfer.gK evidence topic; pair with "
                        "a per-group --checkpoint-dir so the lease/"
                        "journal/snapshot roots are disjoint (kme-"
                        "supervise --groups N wires all of this)")
    p.add_argument("--tsdb", default=None, metavar="DIR",
                   help="append every heartbeat's metrics snapshot to "
                        "an on-disk time-series store in DIR (kme-prof "
                        "queries it); samples carry a monotonic "
                        "sample_seq persisted with the checkpoint so a "
                        "crash-resume dedups replayed heartbeats")
    p.add_argument("--profile", action="store_true",
                   help="always-on host sampling profiler: attributes "
                        "serve-loop wall time to pipeline stages "
                        "(parse/plan/dispatch/collect/produce) as "
                        "prof_stage_frac_* gauges")
    p.add_argument("--profile-artifact", default=None, metavar="PATH",
                   help="on close, write the per-backend transfer-vs-"
                        "compute JSON artifact merged in place by "
                        "backend key: on the card the seq kernel's "
                        "CUDA-event ms and bytes per dispatch and the "
                        "measured H2D bandwidth")
    p.add_argument("--capture-dir", default=None, metavar="DIR",
                   help="trigger-based capture: on SLO burn or a p99 "
                        "exemplar past --capture-p99-us, record a "
                        "bounded profile window to DIR (span ids "
                        "resolve through kme-trace; on the card also "
                        "a torch.profiler trace of the next 0.5 s)")
    p.add_argument("--capture-p99-us", type=int, default=None,
                   metavar="US", help="exemplar e2e threshold that "
                        "fires a capture even without SLO burn")
    p.add_argument("--watch", action="append", default=None,
                   metavar="EXPR",
                   help="arm a live watchpoint evaluated at every "
                        "batch barrier (repeatable): balance[AID]<0, "
                        "position[AID,SYM]>X, depth[SYM]>=N, "
                        "spread[SYM]==0. Read-only — never gates "
                        "admission, never touches MatchOut; hits "
                        "write bounded captures to --capture-dir")
    p.add_argument("--annotate-rejects", action="store_true",
                   help="emit an ADDITIVE 'REJ'-keyed MatchOut record "
                        "naming each rejected order's rej_* reason "
                        "code (the IN/OUT stream stays byte-identical "
                        "to the reference)")
    args = p.parse_args(argv)

    import os

    if args.watch:
        # fail fast on grammar errors instead of a mid-run warning
        from kme_tpu_torch.telemetry.xray import XrayError, parse_watch

        try:
            for expr in args.watch:
                parse_watch(expr)
        except XrayError as e:
            print(f"kme-serve: {e}", file=sys.stderr)
            return 2

    group = None
    if args.group is not None:
        try:
            gk, gn = (int(x) for x in args.group.split("/", 1))
        except ValueError:
            print(f"kme-serve: --group wants K/N, got {args.group!r}",
                  file=sys.stderr)
            return 2
        if not (0 <= gk < gn):
            print(f"kme-serve: --group {gk}/{gn} out of range",
                  file=sys.stderr)
            return 2
        group = (gk, gn)

    from kme_tpu_torch.bridge.broker import BrokerFenced, InProcessBroker
    from kme_tpu_torch.bridge.provision import group_topics, provision
    from kme_tpu_torch.bridge.service import MatchService
    from kme_tpu_torch.bridge.tcp import parse_addr, serve_broker

    if args.kafka is not None:
        from kme_tpu_torch.bridge.kafka import KafkaBroker

        broker = KafkaBroker(args.kafka)
        print(f"kme-serve: using Kafka at {args.kafka}", file=sys.stderr)
    else:
        log_dir = args.log_dir
        if log_dir is None and args.checkpoint_dir is not None:
            log_dir = os.path.join(args.checkpoint_dir, "broker-log")
        overload = None
        if args.overload_high_lag is not None:
            from kme_tpu_torch.bridge.broker import OverloadController

            overload = OverloadController(
                high_lag=args.overload_high_lag,
                low_lag=args.overload_low_lag,
                drain_lag=args.overload_drain_lag,
                p99_budget_ms=args.overload_p99_ms,
                account_cap=args.overload_account_cap)
        broker = InProcessBroker(persist_dir=log_dir, max_lag=args.max_lag,
                                 overload=overload)
        host, port = parse_addr(args.listen)
    if args.auto_provision:
        provision(broker, topics=(group_topics(group[0])
                                  if group is not None and group[1] > 1
                                  else None))
    # exactly-once is the DEFAULT served contract once durability is on
    # (the reference shipped with it commented out, KProcessor.java:29);
    # --at-least-once opts back into the historical behavior. The Kafka
    # transport has no produce stamps and REJ annotations interleave at
    # non-deterministic batch boundaries: both fall back loudly.
    exactly_once = (args.checkpoint_dir is not None
                    and not args.at_least_once)
    if exactly_once and args.kafka is not None:
        print("kme-serve: the Kafka transport carries no produce stamps; "
              "falling back to at-least-once output", file=sys.stderr)
        exactly_once = False
    if exactly_once and args.annotate_rejects:
        print("kme-serve: --annotate-rejects interleaves REJ records at "
              "batch boundaries, which replay differently across a "
              "resume; falling back to at-least-once output",
              file=sys.stderr)
        exactly_once = False
    tracer = None
    if args.trace_out is not None:
        from kme_tpu_torch.telemetry import TraceRecorder, install

        tracer = TraceRecorder()
        install(tracer)   # PhaseTimers pick it up process-wide
    svc = msrv = srv = None
    rc = 0
    try:
        svc = MatchService(
            broker, engine=args.engine, compat=args.compat,
            batch=args.batch, symbols=args.symbols,
            accounts=args.accounts, slots=args.slots,
            max_fills=args.max_fills, width=args.width,
            shards=args.shards, strict=args.strict,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            checkpoint_keep=args.checkpoint_keep,
            journal=args.journal_out,
            journal_rotate_mb=args.journal_rotate_mb,
            journal_fsync=args.journal_fsync,
            journal_keep=args.journal_keep,
            audit=args.audit, audit_repro_dir=args.audit_repro_dir,
            annotate_rejects=args.annotate_rejects,
            exactly_once=exactly_once, pipeline=args.pipeline,
            group=group, trace_spans=args.trace_spans, tsdb=args.tsdb,
            profile=args.profile,
            profile_artifact=args.profile_artifact,
            capture_dir=args.capture_dir,
            capture_p99_us=args.capture_p99_us,
            watch=args.watch,
            slo=(None if args.slo_p99_ms is None else {
                "stage": args.slo_stage,
                "p99_ms": args.slo_p99_ms,
                "budget": args.slo_budget,
                "min_ops": args.slo_min_ops,
                "min_records_per_s": args.slo_min_records_per_sec}),
            device=args.device)
        # listen only once the engine is built: a record admitted before
        # would wait out the engine's start-up (on the card the CUDA
        # context, the state and a snapshot restore: seconds) inside its
        # admission-to-output latency
        if args.kafka is None:
            srv = serve_broker(host, port, broker)[0]
            real_host, real_port = srv.server_address[:2]
            print(f"kme-serve: broker listening on {real_host}:{real_port}",
                  file=sys.stderr, flush=True)
        if args.metrics_port is not None:
            from kme_tpu_torch.telemetry import start_metrics_server

            msrv = start_metrics_server(svc.telemetry, args.metrics_port)
            print(f"kme-serve: metrics on "
                  f"http://{msrv.server_address[0]}:"
                  f"{msrv.server_address[1]}/metrics", file=sys.stderr,
                  flush=True)
        seen = svc.run(max_messages=args.max_messages,
                       idle_exit=args.idle_exit,
                       health_file=args.health_file,
                       health_every=args.health_every)
        if args.checkpoint_dir is not None:
            svc.checkpoint()
        print(f"kme-serve: processed {seen} records", file=sys.stderr)
        met = svc.metrics()
        if met is not None:
            import json

            print(f"kme-serve: metrics {json.dumps(met)}", file=sys.stderr)
    except BrokerFenced as e:
        # a newer leader epoch owns the stream (failover promotion or a
        # lease steal): nothing this incarnation could write will ever
        # be visible. Exit 75 (EX_TEMPFAIL) — a supervisor restarts us
        # and the fresh incarnation acquires the NEXT epoch.
        print(f"kme-serve: FENCED: {e}", file=sys.stderr)
        rc = 75
    except KeyboardInterrupt:
        pass
    finally:
        if svc is not None:
            svc.close()     # finish the in-flight batches, flush + close
            if args.journal_out is not None and os.path.exists(
                    args.journal_out):
                print(f"kme-serve: journal written to {args.journal_out}",
                      file=sys.stderr)
        if msrv is not None:
            msrv.shutdown()
            msrv.server_close()
        if tracer is not None:
            tracer.save(args.trace_out)
            print(f"kme-serve: trace written to {args.trace_out}",
                  file=sys.stderr)
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        if hasattr(broker, "close"):
            broker.close()
    return rc


if __name__ == "__main__":
    sys.exit(main())
