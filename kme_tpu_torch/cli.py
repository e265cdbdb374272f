"""Command-line entry points of the port.

`python -m kme_tpu_torch.cli <command>` or the `kme-torch-*` scripts:

- serve     — the engine service (bridge/serve.py): hosts the broker
              and runs the seq or lanes engine on the card
              (`--device cpu` for the plain versions), or the oracle /
              native host engines, with the observability surfaces
- loadgen   — the exchange_test.js role: a seeded harness stream to
              stdout or produced to a broker's MatchIn (`--connections`
              simulates AIMD-paced clients)
- consume   — the consumer.js role: MatchOut lines to stdout
- provision — the topic.js role: create MatchIn/MatchOut
- trace     — flight-recorder queries, oracle verification, repro replay
- prof      — TSDB history, segment digests, the transfer artifact,
              captures, and `--diff`: the stage that moved between two
              stores or artifacts
- top       — the live operations dashboard
- xray      — offset-addressed state, bisection, offline watchpoints
- events    — the control-plane event timeline
- agg       — the SLO plane over /metrics.json snapshots
- front     — the multi-leader front door (bridge/front.py): split,
              merge, verify, or route a stream to N group services
- reshard   — the live N->M re-split over drained groups
- feed      — the market-data fan-out tier (feed/server.py)
- supervise — failure detection and restart of serve, with a hot
              standby (`--standby`) and multi-leader groups
              (`--groups N|auto`, the autoscale policy)
- standby   — the hot-standby replica: follows the leader's durable
              input on the card and takes over when promoted
- chaos     — fault-injection drills and overload storms against
              supervised serve children (bridge/chaos.py), which run
              the seq engine on the card unless `--device cpu` or
              `--engine oracle` says otherwise
- oracle    — the reference replica over stdin/stdout (host only)
- sim       — the deterministic whole-cluster simulation (sim/): seeded
              virtual-clock runs, seed sweeps, shrunk repros (host only:
              its leaders and standbys run the oracle engine)
- bench     — the benchmark suites (benchmarks.py, `kme-torch-bench`):
              one JSON line on stdout, the detail on stderr; `--device
              cpu` for the plain versions; `--baseline/--gate` and
              `--gate-current` through perfgate.py
- lint      — the repo-native static analysis over kme_tpu_torch/
              (analysis/cli.py, `kme-torch-lint`): `--gate` fails only on
              findings not in LINT_BASELINE_TORCH.json

`trace --cluster` and `xray --cluster` read a multi-leader run
directory. `prof --diff BASE CUR` names the pipeline stage that moved
between two TSDB stores or two benchmark artifacts (perfgate.py, which
is also `python -m kme_tpu_torch.perfgate BASELINE CURRENT
[--attribute]`).
"""

from __future__ import annotations

import argparse
import sys


def loadgen_main(argv=None) -> int:
    """Workload generator — the exchange_test.js role: emit a seeded wire
    stream (JSON lines) to stdout or a transport."""
    p = argparse.ArgumentParser(prog="kme-torch-loadgen", description=loadgen_main.__doc__)
    p.add_argument("--events", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--accounts", type=int, default=10)
    p.add_argument("--symbols", type=int, default=3)
    p.add_argument("--validate", action="store_true",
                   help="clamp prices/sizes to the fixed-mode domain")
    p.add_argument("--fix-payout-opcode", action="store_true",
                   help="emit real PAYOUT (200) instead of the reference "
                        "harness's action=4 bug (Q5)")
    p.add_argument("--broker", default=None, metavar="HOST:PORT",
                   help="produce to MatchIn on this broker instead of "
                        "printing to stdout (the exchange_test.js role)")
    p.add_argument("--connections", type=int, default=None, metavar="N",
                   help="simulate N independent AIMD-paced clients "
                        "multiplexed over --pool sockets (requires "
                        "--broker); client i owns every N-th event")
    p.add_argument("--binary", action="store_true",
                   help="send 72-byte binary wire frames (produce_frames)"
                        " instead of JSON records")
    p.add_argument("--pool", type=int, default=4,
                   help="real sockets backing the simulated clients")
    p.add_argument("--client-batch", type=int, default=64,
                   help="max records per simulated-client send")
    p.add_argument("--epoch", type=int, default=1,
                   help="producer epoch for exactly-once stamps "
                        "(--connections mode stamps every record)")
    p.add_argument("--report", default=None, metavar="PATH",
                   help="write a JSON run report (throughput, AIMD "
                        "rates, observed backoff_ms decay)")
    p.add_argument("--tsdb-out", default=None, metavar="DIR",
                   help="append a final client-side sample (produced, "
                        "rate, sheds, worst RTT) to the shared on-disk "
                        "time-series store (source 'loadgen')")
    p.add_argument("--trace-sample", type=int, default=10, metavar="N",
                   help="--connections mode: keep the N slowest sends "
                        "by RTT in the report, each with the "
                        "deterministic client trace id it carried on "
                        "the wire (dtrace.client_trace_id; resolve "
                        "server-side with kme-torch-trace)")
    args = p.parse_args(argv)
    if args.connections is not None and args.broker is None:
        p.error("--connections requires --broker")
    from kme_tpu_torch.wire import dumps_order
    from kme_tpu_torch.workload import harness_stream

    msgs = harness_stream(args.events, seed=args.seed,
                          num_accounts=args.accounts,
                          num_symbols=args.symbols,
                          payout_opcode_bug=not args.fix_payout_opcode,
                          validate=args.validate)
    if args.connections is not None:
        return _loadgen_connections(args, msgs)
    if args.broker is not None:
        from kme_tpu_torch.bridge.provision import provision
        from kme_tpu_torch.bridge.service import TOPIC_IN
        from kme_tpu_torch.bridge.tcp import TcpBroker, parse_addr

        import time

        from kme_tpu_torch.bridge.broker import BrokerOverload

        host, port = parse_addr(args.broker)
        client = TcpBroker(host, port)
        shed = 0
        try:
            provision(client)  # idempotent: both topics must exist
            lo = 0
            while lo < len(msgs):
                try:
                    client.produce_batch(
                        TOPIC_IN, [(None, dumps_order(m))
                                   for m in msgs[lo:lo + 4096]])
                except BrokerOverload as e:
                    # bounded ingress (kme-torch-serve --max-lag) or adaptive
                    # shedding (--overload-high-lag): the broker sheds
                    # load instead of growing the backlog — treat as
                    # backpressure, honoring the AIMD backoff hint when
                    # the controller sent one, and re-offer the batch
                    # from the broker's durable high-water mark
                    shed += 1
                    hint = getattr(e, "backoff_ms", None)
                    time.sleep(hint / 1e3 if hint else 0.1)
                    lo = client.end_offset(TOPIC_IN)
                    continue
                lo += 4096
        finally:
            client.close()
        note = f" ({shed} overload backoffs)" if shed else ""
        print(f"kme-torch-loadgen: produced {len(msgs)} records to MatchIn"
              f"{note}", file=sys.stderr)
        _tsdb_append_once(args.tsdb_out, "loadgen",
                          {"loadgen_produced_total": len(msgs),
                           "loadgen_sheds_total": shed},
                          "kme-torch-loadgen")
        return 0
    for m in msgs:
        print(dumps_order(m))
    return 0


def _tsdb_append_once(store, source: str, vals: dict,
                      tool: str) -> None:
    """One-shot client-side history sample (kme-torch-loadgen): open the
    shared store, adopt its cursor, append, close. Best-effort — a
    client must never die because the history disk filled."""
    if store is None:
        return
    from kme_tpu_torch.telemetry import TSDB

    try:
        db = TSDB(store, source=source)
        db.append_values(vals, db.next_seq())
        db.close()
    except (OSError, ValueError) as e:
        print(f"{tool}: TSDB write failed: {e}", file=sys.stderr)


def _loadgen_connections(args, msgs) -> int:
    """--connections N: N simulated clients share --pool sockets, each
    with its own AIMD pacer (additive rate increase on success,
    multiplicative decrease on rej_overload, honoring the broker's
    backoff_ms hint before the next send). Every record carries an
    exactly-once (epoch, out_seq) stamp assigned at send time from one
    global sequence, so transport-fault retries are dup-suppressed by
    the broker and the admitted stream stays duplicate-free; a shed
    batch resumes from the admitted prefix (.admitted on the binary
    path, the per-record send count on the JSON path)."""
    import json as _json
    import time

    import numpy as np

    from kme_tpu_torch.bridge.broker import (BrokerError, BrokerFenced,
                                       BrokerOverload)
    from kme_tpu_torch.bridge.provision import provision
    from kme_tpu_torch.bridge.service import TOPIC_IN
    from kme_tpu_torch.bridge.tcp import TcpBroker, parse_addr
    from kme_tpu_torch.telemetry.dtrace import (client_trace_id,
                                          client_trace_ids)
    from kme_tpu_torch.wire import dumps_order, encode_frames

    host, port = parse_addr(args.broker)
    ncli = max(1, args.connections)
    pool = [TcpBroker(host, port)
            for _ in range(max(1, min(args.pool, ncli)))]
    transport_retries = 0

    def call_rt(fn, *a, **kw):
        # transport faults retry the SAME record/stamps immediately (the
        # broker dedups by out_seq; TcpBroker preserves the ats stamp),
        # broker verdicts (overload/fence) propagate to the pacer
        nonlocal transport_retries
        for _ in range(100):
            try:
                return fn(*a, **kw)
            except (BrokerOverload, BrokerFenced):
                raise
            except BrokerError:
                transport_retries += 1
                time.sleep(0.01)
        raise BrokerError("transport retry budget exhausted")

    try:
        provision(pool[0])
        # client i owns msgs[i::ncli]; heads[] walks each queue
        sizes = (len(msgs) - np.arange(ncli) + ncli - 1) // ncli
        sizes = np.maximum(sizes, 0)
        heads = np.zeros(ncli, dtype=np.int64)
        remaining = sizes.copy()
        rate = np.full(ncli, 1000.0)    # records/s; AI +10, MD x0.5
        next_at = np.zeros(ncli)
        next_seq = 0
        sheds = dup = 0
        backoff_samples = []
        # sampled tracing: every send carries a deterministic client
        # trace id (pure mix of out_seq/aid/oid — replayable, never a
        # clock); the N slowest RTTs keep theirs so a tail spike in
        # this report resolves server-side via kme-torch-trace
        nslow = max(0, getattr(args, "trace_sample", 0))
        slow = []

        def note_slow(rtt_us, seq, m, tid, nrec):
            if nslow == 0:
                return
            if len(slow) >= nslow and rtt_us <= slow[-1]["rtt_us"]:
                return
            slow.append({"rtt_us": int(rtt_us), "out_seq": int(seq),
                         "aid": int(m.aid), "oid": int(m.oid),
                         "records": int(nrec),
                         "trace_id": f"0x{tid:016x}"})
            slow.sort(key=lambda s: -s["rtt_us"])
            del slow[nslow:]

        t0 = time.monotonic()
        while True:
            active = np.flatnonzero(remaining > 0)
            if active.size == 0:
                break
            now = time.monotonic() - t0
            due = active[next_at[active] <= now]
            if due.size == 0:
                time.sleep(max(1e-4,
                               float(next_at[active].min()) - now))
                continue
            for ci in due:
                ci = int(ci)
                k = int(min(args.client_batch, remaining[ci]))
                h = int(heads[ci])
                batch = [msgs[ci + (h + j) * ncli] for j in range(k)]
                cli = pool[ci % len(pool)]
                seq0 = next_seq
                sent = 0
                now = time.monotonic() - t0
                try:
                    if args.binary:
                        tids = client_trace_ids(
                            seq0, [m.aid for m in batch],
                            [m.oid for m in batch])
                        buf = encode_frames(batch, tids=tids)
                        bt = time.monotonic()
                        n, _ = call_rt(cli.produce_frames, TOPIC_IN,
                                       None, buf, epoch=args.epoch,
                                       seq0=seq0)
                        note_slow((time.monotonic() - bt) * 1e6,
                                  seq0, batch[0], tids[0], k)
                        dup += k - n    # transport-retry suppressions
                        ok_n = k
                    else:
                        for m in batch:
                            tid = client_trace_id(seq0 + sent,
                                                  m.aid, m.oid)
                            bt = time.monotonic()
                            r = call_rt(cli.produce, TOPIC_IN, None,
                                        dumps_order(m),
                                        epoch=args.epoch,
                                        out_seq=seq0 + sent,
                                        tid=tid)
                            note_slow((time.monotonic() - bt) * 1e6,
                                      seq0 + sent, m, tid, 1)
                            if r == -1:
                                dup += 1
                            sent += 1
                        ok_n = k
                except BrokerOverload as e:
                    ok_n = ((getattr(e, "admitted", None) or 0)
                            if args.binary else sent)
                    sheds += 1
                    hint = getattr(e, "backoff_ms", None)
                    backoff_samples.append(
                        [round(now, 4),
                         None if hint is None else int(hint)])
                    next_at[ci] = now + ((hint / 1e3) if hint else 0.1)
                    rate[ci] = max(1.0, rate[ci] * 0.5)
                else:
                    rate[ci] = min(10000.0, rate[ci] + 10.0)
                    next_at[ci] = now + k / rate[ci]
                next_seq += ok_n
                heads[ci] += ok_n
                remaining[ci] -= ok_n
        dur = time.monotonic() - t0
    finally:
        for cli in pool:
            cli.close()
    hints = [h for _, h in backoff_samples if h is not None]
    mask = sizes > 0
    report = {
        "connections": ncli,
        "events": len(msgs),
        "binary": bool(args.binary),
        "epoch": args.epoch,
        "produced": int(next_seq),
        "dup_suppressed": int(dup),
        "sheds": int(sheds),
        "transport_retries": int(transport_retries),
        "duration_s": round(dur, 3),
        "rate_rps": round(next_seq / dur, 1) if dur > 0 else None,
        "aimd": {
            "rate_mean": round(float(rate[mask].mean()), 1)
            if mask.any() else None,
            "rate_min": round(float(rate[mask].min()), 1)
            if mask.any() else None,
            "rate_max": round(float(rate[mask].max()), 1)
            if mask.any() else None,
        },
        # the controller's AIMD hint should decay as pressure falls —
        # the raw samples let CI (and humans) see the curve
        "backoff_ms_samples": backoff_samples[:1000],
        "backoff_ms_max": max(hints) if hints else None,
        "backoff_ms_last": hints[-1] if hints else None,
        # slowest sends observed client-side; the binary path samples
        # per batch ("records" > 1), JSON per record — either way the
        # trace id matches what the broker recorded, so
        # `kme-torch-trace --cluster --order AID:OID` shows the server half
        "slow_samples": slow,
    }
    if args.report:
        with open(args.report, "w") as f:
            _json.dump(report, f, indent=1)
    vals = {"loadgen_produced_total": int(next_seq),
            "loadgen_sheds_total": int(sheds),
            "loadgen_dup_suppressed_total": int(dup),
            "loadgen_transport_retries_total": int(transport_retries)}
    if report["rate_rps"] is not None:
        vals["loadgen_rate_rps"] = report["rate_rps"]
    if slow:
        vals["loadgen_slowest_rtt_us"] = slow[0]["rtt_us"]
    if report["backoff_ms_last"] is not None:
        vals["loadgen_backoff_ms_last"] = report["backoff_ms_last"]
    _tsdb_append_once(args.tsdb_out, "loadgen", vals, "kme-torch-loadgen")
    print(f"kme-torch-loadgen: {next_seq} records from {ncli} simulated "
          f"clients ({'binary' if args.binary else 'json'}) in "
          f"{dur:.2f}s, {sheds} sheds, {transport_retries} transport "
          f"retries", file=sys.stderr)
    return 0


def _fmt_event(ev: dict) -> str:
    from kme_tpu_torch.wire import rej_name

    bits = [f"seq={ev.get('seq', '?')}",
            f"b={ev.get('b', '?')}:{ev.get('i', '?')}",
            f"off={ev.get('off', -1)}",
            f"{ev['e']:<13s}"]
    for k in ("oid", "aid", "sid", "px", "qty", "moid", "maid",
              "in_us", "plan_us", "dev_us", "prod_us", "e2e_us"):
        if k in ev:
            bits.append(f"{k}={ev[k]}")
    if ev.get("rej"):
        bits.append(f"rej={rej_name(ev['rej'])}")
    if "ts" in ev:
        import datetime

        t = datetime.datetime.fromtimestamp(ev["ts"] / 1e6,
                                            datetime.timezone.utc)
        bits.append(t.strftime("%H:%M:%S.%f"))
    return "  ".join(bits)


def _trace_self_check() -> int:
    """Synthetic end-to-end smoke: journal a canned stream through both
    framings, reconstruct a lifecycle, and byte-compare against the
    oracle replay. Exit 0 only if every step agrees (used by CI)."""
    import os
    import tempfile

    from kme_tpu_torch.oracle import OracleEngine
    from kme_tpu_torch.telemetry.journal import (
        Journal, canonical_lines, lifecycle_summary, oracle_events,
        order_lifecycle, read_events)
    from kme_tpu_torch.wire import dumps_order, parse_order
    from kme_tpu_torch.workload import harness_stream

    msgs = harness_stream(400, seed=7, num_accounts=6, num_symbols=2,
                          payout_opcode_bug=False, validate=True)
    lines = [dumps_order(m) for m in msgs]
    eng = OracleEngine("fixed")
    out = [[rec.wire() for rec in eng.process(parse_order(ln))]
           for ln in lines]
    ok = True
    with tempfile.TemporaryDirectory() as td:
        for ext in ("jsonl", "bin"):
            path = os.path.join(td, f"sc.{ext}")
            j = Journal(path)
            for lo in range(0, len(out), 100):
                j.record_batch(out[lo:lo + 100],
                               offsets=list(range(lo, lo + 100)))
            j.close()
            evs = read_events(path)
            want = canonical_lines(oracle_events(lines))
            got = canonical_lines(evs)
            if got != want:
                print(f"kme-torch-trace --self-check: {ext} journal does not "
                      f"match oracle replay ({len(got)} vs {len(want)} "
                      "events)", file=sys.stderr)
                ok = False
                continue
            seqs = [e["seq"] for e in evs]
            if seqs != sorted(set(seqs)):
                print(f"kme-torch-trace --self-check: {ext} seq numbers not "
                      "strictly monotonic", file=sys.stderr)
                ok = False
                continue
            oids = [e["oid"] for e in evs
                    if e["e"] == "fill" and "oid" in e]
            if oids:
                life = order_lifecycle(evs, oids[0])
                summ = lifecycle_summary(life, oids[0])
                if not life or summ["filled"] <= 0:
                    print("kme-torch-trace --self-check: lifecycle "
                          "reconstruction came back empty",
                          file=sys.stderr)
                    ok = False
    print("kme-torch-trace --self-check: "
          + ("OK" if ok else "FAILED"), file=sys.stderr)
    return 0 if ok else 1


def agg_main(argv=None) -> int:
    """Cluster SLO plane: aggregate the front's and every group's
    /metrics.json into cluster-wide end-to-end latency (exact merged
    quantiles from raw histogram buckets), global SLO burn rate, a
    per-group health table, and p99 exemplars that resolve to
    waterfalls via kme-torch-trace --cluster --order AID:OID."""
    p = argparse.ArgumentParser(prog="kme-torch-agg",
                                description=agg_main.__doc__)
    p.add_argument("sources", nargs="*", metavar="URL|PATH",
                   help="metrics sources: http://host:port endpoints "
                        "(scraped via /metrics.json), heartbeat files, "
                        "or saved snapshot JSON files")
    p.add_argument("--state-root", default=None, metavar="DIR",
                   help="discover group health surfaces under a "
                        "multi-leader run dir (top.discover_endpoints) "
                        "and scrape those too")
    p.add_argument("--slo-ms", type=float, default=None, metavar="MS",
                   help="cluster e2e SLO threshold; reports the global "
                        "burn rate against --slo-target")
    p.add_argument("--slo-target", type=float, default=0.999,
                   help="SLO attainment target (default 0.999)")
    p.add_argument("--json", action="store_true",
                   help="emit the full aggregate document as JSON")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="also write the aggregate JSON here")
    p.add_argument("--history", default=None, metavar="DIR",
                   help="on-disk TSDB store (kme-torch-serve --tsdb et al.): "
                        "append per-source history — sparkline "
                        "look-back in the text view, window summaries "
                        "under a 'history' key in --json/--out")
    args = p.parse_args(argv)
    import json

    from kme_tpu_torch.telemetry import dtrace
    from kme_tpu_torch.telemetry.top import discover_endpoints, scrape

    sources = list(args.sources)
    if args.state_root:
        import os

        eps = discover_endpoints(args.state_root)
        sources.extend(g["health"] for g in eps["groups"])
        # feed-tier heartbeats are optional surfaces: only scrape the
        # ones that exist, so absent feeds don't add DEGRADED rows
        for fp in [eps["feed"]] + [g["feed"] for g in eps["groups"]]:
            if os.path.exists(fp):
                sources.append(fp)
    if not sources:
        p.error("no sources: give URLs/paths or --state-root")
    import time as _time

    snaps = []
    stale = {}
    now = _time.time()
    for src in sources:
        node = scrape(src)      # same path as kme-torch-top: never raises
        snaps.append((src, node["metrics"] if node["ok"] else None))
        # staleness: a heartbeat FILE that scraped fine but whose
        # writer stopped advancing (sample_seq/mtime frozen for more
        # than 3 write intervals) describes the past, not the present.
        # Live HTTP scrapes are fresh by construction; a heartbeat
        # that says "closing" froze on purpose.
        hb = node.get("hb")
        if (node["ok"] and hb and not hb.get("closing")
                and not src.startswith(("http://", "https://"))):
            every = float(hb.get("every") or 1.0)
            age = None
            if isinstance(hb.get("time"), (int, float)):
                age = now - float(hb["time"])
            else:
                try:
                    import os as _os

                    age = now - _os.path.getmtime(src)
                except OSError:
                    pass
            if age is not None and age > 3.0 * every:
                stale[src] = {"age_s": round(age, 3),
                              "intervals": round(age / every, 2),
                              "sample_seq": hb.get("sample_seq")}
            elif (isinstance(hb.get("events_lag_bytes"), (int, float))
                    and hb["events_lag_bytes"] > 0):
                # heartbeat is live but the control-plane event
                # recorder has unflushed bytes: the process advances
                # while its timeline froze — a distinct STALE variant
                # (the inverse of a stalled heartbeat)
                stale[src] = {
                    "sample_seq": hb.get("sample_seq"),
                    "events_frozen": True,
                    "events_lag_bytes": int(hb["events_lag_bytes"])}
    doc = dtrace.aggregate(snaps, slo_ms=args.slo_ms,
                           slo_target=args.slo_target,
                           stale=stale or None)
    hist_sources = []
    if args.history:
        import os as _os

        from kme_tpu_torch.telemetry import tsdb as _tsdb

        try:
            hist_sources = sorted(
                {e[:-len(".kmet")] for e in _os.listdir(args.history)
                 if e.endswith(".kmet")})
        except OSError as e:
            print(f"kme-torch-agg: history store unreadable: {e}",
                  file=sys.stderr)
        doc["history"] = {
            src: _tsdb.window_summary(args.history, source=src)
            for src in hist_sources}
    recent = []
    if args.state_root:
        # recent control-plane events ride the aggregate: the tail of
        # the merged cluster timeline in the text view, the full merged
        # timeline (+ its digest) under an "events" key in --json/--out
        from kme_tpu_torch.telemetry import events as cpevents

        try:
            recent = cpevents.merge_logs([args.state_root])
        except OSError:
            recent = []
        if recent:
            doc["events"] = {
                "count": len(recent),
                "digest": cpevents.timeline_digest(recent),
                "timeline": recent}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
    if args.json:
        print(json.dumps(doc, indent=1))
    else:
        print(dtrace.render_agg(doc))
        if hist_sources:
            from kme_tpu_torch.telemetry.top import history_lines

            for src in hist_sources:
                for ln in history_lines(args.history, source=src):
                    print(ln)
        if recent:
            from kme_tpu_torch.telemetry import events as cpevents

            print(f"  recent events (last {min(8, len(recent))} of "
                  f"{len(recent)} — kme-torch-events for the full timeline):")
            for ev in recent[-8:]:
                print(f"    {cpevents.format_event(ev)}")
    return 0 if any(s for _n, s in snaps) else 1


def prof_main(argv=None) -> int:
    """Profiling & telemetry-history query tool over the on-disk TSDB
    (kme-torch-serve --tsdb and friends): list/plot/export metric series,
    verify segment digests, inspect the transfer-vs-compute artifact and
    the trigger captures, and attribute a regression to a pipeline stage
    with --diff between two history windows or recorded benchmark
    artifacts."""
    p = argparse.ArgumentParser(prog="kme-torch-prof",
                                description=prof_main.__doc__)
    p.add_argument("store", nargs="?", default=None, metavar="DIR",
                   help="TSDB store directory (or one .kmet segment)")
    p.add_argument("--source", default=None, metavar="NAME",
                   help="only this writer's series (serve, standby, "
                        "feed, front, consume, loadgen, ...; default "
                        "all)")
    p.add_argument("--names", default=None, metavar="A,B,...",
                   help="only these series (exact names, comma-"
                        "separated)")
    p.add_argument("--last", type=int, default=None, metavar="N",
                   help="keep only the newest N points per series")
    p.add_argument("--csv", action="store_true",
                   help="emit ts_us,source-agnostic CSV rows instead "
                        "of the sparkline table")
    p.add_argument("--json", action="store_true",
                   help="emit machine-readable JSON")
    p.add_argument("--verify", action="store_true",
                   help="audit the sha256 sidecars of every finalized "
                        "segment (exit 1 on any mismatch)")
    p.add_argument("--artifact", default=None, metavar="PATH",
                   help="print the per-backend transfer-vs-compute "
                        "artifact (kme-torch-serve --profile-artifact) "
                        "instead of querying a store")
    p.add_argument("--diff", nargs=2, default=None,
                   metavar=("BASE", "CUR"),
                   help="stage-level regression attribution between "
                        "two TSDB stores (window summaries) or two "
                        "recorded benchmark/driver artifacts — each "
                        "operand may be either")
    p.add_argument("--captures", default=None, metavar="DIR",
                   help="list and pretty-print the capture_NNN.json "
                        "trigger captures in DIR (kme-torch-serve "
                        "--capture-dir: SLO/p99 TriggerCaptures and "
                        "kme-torch-xray watchpoint hits share the format)")
    args = p.parse_args(argv)
    import json
    import os

    from kme_tpu_torch.telemetry import tsdb

    if args.captures is not None:
        from kme_tpu_torch.telemetry.profiler import (format_capture,
                                                list_captures)

        paths = list_captures(args.captures)
        if not paths:
            print(f"kme-torch-prof: no captures under {args.captures}",
                  file=sys.stderr)
            return 1
        if args.json:
            docs = []
            for pth in paths:
                with open(pth) as f:
                    docs.append(dict(json.load(f), path=pth))
            print(json.dumps(docs, indent=1, sort_keys=True))
            return 0
        for pth in paths:
            try:
                print(format_capture(pth))
            except (OSError, ValueError) as e:
                print(f"kme-torch-prof: unreadable capture {pth}: {e}",
                      file=sys.stderr)
        return 0
    if args.artifact is not None:
        from kme_tpu_torch.telemetry import read_transfer_artifact

        try:
            doc = read_transfer_artifact(args.artifact)
        except (OSError, ValueError) as e:
            print(f"kme-torch-prof: {e}", file=sys.stderr)
            return 2
        print(json.dumps(doc, indent=1, sort_keys=True))
        return 0
    if args.diff is not None:
        from kme_tpu_torch import perfgate

        def _metrics(operand: str):
            if os.path.isdir(operand):
                return tsdb.window_summary(operand,
                                           source=args.source)
            return perfgate.load_artifact(operand)["metrics"]

        base, cur = (_metrics(x) for x in args.diff)
        if not base or not cur:
            print("kme-torch-prof: no metrics on one side of --diff",
                  file=sys.stderr)
            return 2
        att = perfgate.attribute_regression(base, cur)
        if args.json:
            print(json.dumps(att, indent=1))
        else:
            print(perfgate.format_attribution(att))
        return 0
    if args.store is None:
        p.error("give a store dir (or --artifact / --diff)")
    if args.verify:
        rep = tsdb.verify_store(args.store)
        print(json.dumps(rep) if args.json else
              f"kme-torch-prof: {rep['verified']}/{rep['segments']} "
              f"segment digests verified"
              + (f"; MISMATCHED: {', '.join(rep['mismatched'])}"
                 if rep["mismatched"] else ""))
        return 1 if rep["mismatched"] else 0
    names = ([n for n in args.names.split(",") if n]
             if args.names else None)
    series = tsdb.query(args.store, names=names, source=args.source)
    if args.last:
        series = {k: v[-args.last:] for k, v in series.items()}
    if not series:
        print("kme-torch-prof: no samples matched", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps({k: [[ts, v] for ts, v in pts]
                          for k, pts in series.items()},
                         sort_keys=True))
        return 0
    if args.csv:
        print("name,ts_us,value")
        for name in sorted(series):
            for ts, v in series[name]:
                print(f"{name},{ts},{v:g}")
        return 0
    from kme_tpu_torch.telemetry.top import sparkline

    w = max(len(n) for n in series)
    for name in sorted(series):
        pts = series[name]
        vals = [v for _ts, v in pts]
        shown = vals
        if tsdb._is_monotonic_name(name) and len(vals) > 1:
            shown = [b - a for a, b in zip(vals, vals[1:])]
        print(f"{name:<{w}s}  n={len(pts):<6d} "
              f"{sparkline(shown):<24s} last={vals[-1]:g}")
    return 0


def trace_main(argv=None) -> int:
    """Flight-recorder query tool: reconstruct one order's or account's
    lifecycle from a journal written by kme-torch-serve --journal-out
    (either package's journal), verify a journal against the reference
    oracle replay, or replay an audit violation repro dump."""
    p = argparse.ArgumentParser(prog="kme-torch-trace",
                                description=trace_main.__doc__)
    p.add_argument("journal", nargs="?", default=None,
                   help="journal path (.jsonl or .bin/.kmej; rotated "
                        "PATH.N siblings are read automatically)")
    p.add_argument("--order", default=None, metavar="OID|AID:OID",
                   help="print every event touching this order id "
                        "(taker or resting maker side) plus a terminal-"
                        "state summary; with --cluster, AID:OID (or a "
                        "trace id) selects the per-order waterfall")
    p.add_argument("--account", type=int, default=None, metavar="AID",
                   help="print every event touching this account id")
    p.add_argument("--limit", type=int, default=None, metavar="N",
                   help="print at most the last N matching events")
    p.add_argument("--json", action="store_true",
                   help="emit raw event JSON lines instead of the "
                        "pretty rendering")
    p.add_argument("--no-rotated", action="store_true",
                   help="read only the live file, ignore PATH.N "
                        "rotation siblings")
    p.add_argument("--verify", default=None, metavar="INPUT",
                   help="replay this order-JSONL input through the "
                        "Python oracle and byte-compare the canonical "
                        "event stream against the journal (exit 1 on "
                        "divergence)")
    p.add_argument("--compat", choices=("java", "fixed"),
                   default="fixed", help="oracle compat for --verify")
    p.add_argument("--book-slots", type=int, default=None,
                   help="capacity envelope for --verify (match the "
                        "serving engine's --slots)")
    p.add_argument("--max-fills", type=int, default=None,
                   help="per-order fill cap for --verify (match the "
                        "serving engine's --max-fills)")
    p.add_argument("--replay-repro", default=None, metavar="DUMP",
                   help="re-run the invariant auditor over an "
                        "audit_repro_*.json violation dump (exit 1 if "
                        "the violation reproduces)")
    p.add_argument("--self-check", action="store_true",
                   help="synthetic round-trip smoke test (no journal "
                        "needed); exit 0 iff journal/oracle/lifecycle "
                        "machinery agrees")
    p.add_argument("--cluster", action="store_true",
                   help="stitch cluster-wide per-order waterfalls from "
                        "a multi-leader run dir (--state-root): merges "
                        "every group's journal spans with the "
                        "deterministic front routing (transfer legs "
                        "linked parent/child, failover replay deduped)")
    p.add_argument("--state-root", default=None, metavar="DIR",
                   help="--cluster: run dir with group{k}/ children "
                        "(the kme-chaos shard-failover layout)")
    p.add_argument("--input", default=None, metavar="PATH",
                   help="--cluster: the front's global input stream "
                        "(default <state-root>/front.in)")
    p.add_argument("--prefund", type=int, default=8,
                   help="--cluster: the front's --prefund (the routing "
                        "re-run must match the original split)")
    p.add_argument("--chrome-out", default=None, metavar="PATH",
                   help="--cluster: write a Chrome trace-event JSON "
                        "(flow arrows across groups) here")
    args = p.parse_args(argv)
    import json

    if args.self_check:
        return _trace_self_check()
    if args.cluster:
        if args.state_root is None:
            p.error("--cluster needs --state-root")
        return _trace_cluster(args)
    if args.replay_repro is not None:
        from kme_tpu_torch.telemetry.audit import replay_repro

        found = replay_repro(args.replay_repro)
        for v in found:
            print(json.dumps(v))
        print(f"kme-torch-trace: repro {'REPRODUCED' if found else 'clean'} "
              f"({len(found)} violation(s))", file=sys.stderr)
        return 1 if found else 0
    if args.journal is None:
        p.error("a journal path is required (or --self-check / "
                "--replay-repro)")
    from kme_tpu_torch.telemetry.journal import (
        account_history, canonical_lines, lifecycle_summary,
        oracle_events, order_lifecycle, read_events)

    events = read_events(args.journal,
                         include_rotated=not args.no_rotated)
    if args.verify is not None:
        with open(args.verify) as fh:
            lines = [ln.strip() for ln in fh if ln.strip()]
        want = canonical_lines(oracle_events(
            lines, compat=args.compat, book_slots=args.book_slots,
            max_fills=args.max_fills))
        got = canonical_lines(events)
        if got == want:
            print(f"kme-torch-trace: journal matches oracle replay "
                  f"({len(got)} events)", file=sys.stderr)
            return 0
        n = min(len(got), len(want))
        div = next((k for k in range(n) if got[k] != want[k]), n)
        print(f"kme-torch-trace: DIVERGENCE at canonical event {div} "
              f"(journal {len(got)} events, oracle {len(want)})",
              file=sys.stderr)
        if div < len(got):
            print(f"  journal: {got[div]}", file=sys.stderr)
        if div < len(want):
            print(f"  oracle:  {want[div]}", file=sys.stderr)
        return 1
    if args.order is not None:
        try:
            oid = int(args.order)
        except ValueError:
            p.error("--order takes AID:OID only with --cluster; "
                    "on a single journal give the integer OID")
        picked = order_lifecycle(events, oid)
        summary = lifecycle_summary(picked, oid)
    elif args.account is not None:
        picked = account_history(events, args.account)
        summary = None
    else:
        picked, summary = events, None
    if args.limit is not None:
        picked = picked[-args.limit:]
    for ev in picked:
        print(json.dumps(ev) if args.json else _fmt_event(ev))
    if summary is not None:
        print(f"kme-torch-trace: order {summary['oid']} state="
              f"{summary['state']} filled={summary['filled']} "
              f"rested={summary['rested']} "
              f"events={summary['events']}", file=sys.stderr)
    elif args.order is None and args.account is None:
        from collections import Counter as _Counter

        kinds = _Counter(e["e"] for e in events)
        print("kme-torch-trace: " + " ".join(
            f"{k}={kinds[k]}" for k in sorted(kinds)), file=sys.stderr)
    return 0


def _trace_cluster(args) -> int:
    """kme-torch-trace --cluster: stitch per-order waterfalls across
    front, groups, transfer legs and merge from a multi-leader run
    directory (telemetry/dtrace.py). Exit 0 iff every admitted order
    stitched to a complete waterfall."""
    import json

    from kme_tpu_torch.telemetry import dtrace

    doc = dtrace.stitch_state_root(args.state_root,
                                   input_path=args.input,
                                   prefund=args.prefund)
    if args.chrome_out is not None:
        with open(args.chrome_out, "w") as f:
            json.dump(dtrace.chrome_trace_doc(doc), f)
        print(f"kme-torch-trace: Chrome trace written to {args.chrome_out}",
              file=sys.stderr)
    if args.order is not None:
        o = dtrace.find_order(doc, args.order)
        if o is None:
            print(f"kme-torch-trace: no stitched order matches "
                  f"{args.order!r}", file=sys.stderr)
            return 1
        print(dtrace.waterfall_text(o))
        return 0
    orders = doc["orders"]
    if args.json:
        for o in orders[:args.limit] if args.limit else orders:
            print(json.dumps(o, sort_keys=True))
    elif args.limit:
        for o in orders[:args.limit]:
            print(dtrace.waterfall_text(o))
            print()
    frac = (doc["stitched"] / doc["admitted"]) if doc["admitted"] else 0
    legs = sum(len(o["legs"]) for o in orders)
    print(f"kme-torch-trace: {doc['admitted']} orders admitted across "
          f"{doc['groups']} groups, {doc['stitched']} stitched "
          f"({frac:.2%}), {legs} transfer/broadcast legs linked, "
          f"counters={doc['counters']}", file=sys.stderr)
    return 0 if doc["admitted"] and doc["stitched"] == doc["admitted"] \
        else (1 if doc["admitted"] else 2)


def xray_main(argv=None) -> int:
    """Time-travel state inspection over the durable MatchIn log:
    materialize oracle state at any retained offset (nearest snapshot +
    deterministic replay), bisect the first divergent batch between a
    journal and a fresh replay, evaluate watchpoint predicates offline,
    and take a consistent cross-group cut. Strictly read-only: MatchIn
    and MatchOut bytes are never touched."""
    p = argparse.ArgumentParser(prog="kme-torch-xray",
                                description=xray_main.__doc__)
    p.add_argument("query", nargs="*", metavar="QUERY",
                   help="point query: 'balance AID' | 'order AID:OID' "
                        "| 'book SID' | 'state' | \"eval 'EXPR'\" "
                        "(EXPR uses the watchpoint grammar, e.g. "
                        "balance[3]<0, depth[1]>=8, spread[2]==0)")
    p.add_argument("--log-dir", default=None,
                   help="broker persist dir holding the durable topic "
                        "logs (default: <checkpoint-dir>/broker-log)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="snapshot dir to anchor replays (kme-torch-serve "
                        "--checkpoint-dir); omit to replay cold from "
                        "offset 0 (requires --allow-cold)")
    p.add_argument("--topic", default="MatchIn")
    p.add_argument("--at", type=int, default=None, metavar="OFFSET",
                   help="materialize state AFTER the MatchIn record at "
                        "this offset (default: log end)")
    p.add_argument("--at-trace", default=None, metavar="0xTID",
                   help="resolve a dtrace trace id to its MatchIn "
                        "offset and materialize there")
    p.add_argument("--groups", type=int, default=1,
                   help="group count used when resolving --at-trace "
                        "ids minted by a grouped deployment")
    p.add_argument("--allow-cold", action="store_true",
                   help="permit a full replay from offset 0 when no "
                        "snapshot covers the target")
    p.add_argument("--book-slots", type=int, default=None)
    p.add_argument("--max-fills", type=int, default=None)
    p.add_argument("--bisect", action="store_true",
                   help="binary-search the journal for the first batch "
                        "whose recorded effects diverge from a fresh "
                        "oracle replay; writes a minimized repro")
    p.add_argument("--journal", default=None, metavar="PATH",
                   help="journal file for --bisect")
    p.add_argument("--lo", type=int, default=None, metavar="BATCH",
                   help="--bisect window start (journal batch id)")
    p.add_argument("--hi", type=int, default=None, metavar="BATCH",
                   help="--bisect window end (inclusive batch id)")
    p.add_argument("--repro-dir", default=None,
                   help="where --bisect writes its repro dump "
                        "(default: next to the journal)")
    p.add_argument("--replay-repro", default=None, metavar="PATH",
                   help="re-run a bisect repro dump offline and check "
                        "the recorded diff reproduces")
    p.add_argument("--cluster", action="store_true",
                   help="consistent cut across every group under "
                        "--state-root: per-group cash + open margin, "
                        "pending transfer reserve, and global cash "
                        "conservation vs a single-leader replay")
    p.add_argument("--state-root", default=None,
                   help="chaos/cluster layout root (front.in + "
                        "group<k>/state/) for --cluster")
    p.add_argument("--input", default=None, metavar="PATH",
                   help="merged pre-split input for --cluster "
                        "(default: <state-root>/front.in)")
    p.add_argument("--prefund", type=int, default=8,
                   help="per-group transfer prefund the deployment "
                        "ran with (--cluster; must match kme-front)")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    import json

    from kme_tpu_torch.telemetry import xray

    try:
        if args.replay_repro is not None:
            res = xray.replay_bisect_repro(args.replay_repro)
            if args.json:
                print(json.dumps(res, indent=1, sort_keys=True))
            else:
                print(f"repro batch {res['batch']}: "
                      f"{'reproduces' if res['match'] else 'DOES NOT reproduce'}")
                for store, line in sorted(res["diff"].items()):
                    print(f"  {store}: {line}")
            return 0 if res["match"] else 1

        if args.cluster:
            if not args.state_root:
                p.error("--cluster requires --state-root")
            rep = xray.cluster_cut(
                args.state_root, at=args.at, input_path=args.input,
                prefund=args.prefund, book_slots=args.book_slots,
                max_fills=args.max_fills)
            if args.json:
                print(json.dumps(rep, indent=1, sort_keys=True))
            else:
                print(f"cut @ {rep['watermark']} input lines "
                      f"({len(rep['groups'])} groups)")
                for k in sorted(rep["groups"]):
                    g = rep["groups"][k]
                    print(f"  group{k}: cut={g['cut']} "
                          f"cash={g['cash']} margin={g['open_margin']} "
                          f"accounts={g['accounts']} "
                          f"resting={g['resting_orders']} "
                          f"(anchor={g['anchor']} "
                          f"replayed={g['replayed']})")
                print(f"  pending transfer reserve: "
                      f"{rep['pending_reserve_total']} "
                      f"(shortfalls={rep['transfer_shortfalls']})")
                print(f"  cluster cash+reserve={rep['cluster']['cash']}"
                      f" margin={rep['cluster']['open_margin']} "
                      f"gross={rep['cluster']['gross']}")
                print(f"  single-leader  cash="
                      f"{rep['single_leader']['cash']} "
                      f"margin={rep['single_leader']['open_margin']} "
                      f"gross={rep['single_leader']['gross']}")
                print("  conserved: "
                      + ("yes" if rep["conserved"]
                         else f"NO — {rep['delta']}"))
            return 0 if rep["conserved"] else 1

        # Point queries and bisection both need the log location.
        log_dir = args.log_dir
        if log_dir is None and args.checkpoint_dir:
            import os as _os
            log_dir = _os.path.join(args.checkpoint_dir, "broker-log")
        if log_dir is None:
            p.error("--log-dir (or --checkpoint-dir) is required")

        if args.bisect:
            if not args.journal:
                p.error("--bisect requires --journal")
            res = xray.bisect(
                args.journal, log_dir, topic=args.topic,
                ckpt_dir=args.checkpoint_dir, lo=args.lo, hi=args.hi,
                book_slots=args.book_slots, max_fills=args.max_fills,
                repro_dir=args.repro_dir)
            if args.json:
                print(json.dumps(res, indent=1, sort_keys=True))
            elif not res["divergent"]:
                print(f"no divergence across {res['window_batches']} "
                      f"journal batches ({res['replays']} replays)")
            else:
                print(f"first divergent batch: {res['batch']} "
                      f"(offset {res['first_divergent_offset']}, "
                      f"{res['replays']} replays)")
                for store, line in sorted(res["diff"].items()):
                    print(f"  {store}: {line}")
                if res.get("repro"):
                    print(f"repro: {res['repro']}")
            return 1 if res["divergent"] else 0

        at = args.at
        if args.at_trace is not None:
            tid = int(args.at_trace, 0)
            off = xray.resolve_trace(tid, log_dir, topic=args.topic,
                                     ngroups=args.groups)
            if off is None:
                raise xray.XrayError(
                    f"trace id {args.at_trace} not found in "
                    f"{args.topic} under {log_dir}")
            at = off + 1
            if not args.json:
                print(f"# trace {args.at_trace} -> offset {off}")

        engine, anchor, replayed = xray.materialize(
            log_dir, at, topic=args.topic,
            ckpt_dir=args.checkpoint_dir,
            allow_cold=args.allow_cold or not args.checkpoint_dir,
            book_slots=args.book_slots, max_fills=args.max_fills)

        q = args.query or ["state"]
        what = q[0]
        out = {"topic": args.topic, "at": at, "anchor": anchor,
               "replayed": replayed}
        if what == "balance":
            if len(q) != 2:
                p.error("usage: balance AID")
            aid = int(q[1])
            bal = engine.balances.get(aid)
            out.update(query=f"balance[{aid}]",
                       value=None if bal is None else int(bal))
        elif what == "order":
            if len(q) != 2 or ":" not in q[1]:
                p.error("usage: order AID:OID")
            aid_s, _, oid_s = q[1].partition(":")
            rec = engine.export_state()["orders"].get(int(oid_s))
            if rec is not None and rec["aid"] != int(aid_s):
                rec = None
            out.update(query=f"order[{q[1]}]", value=rec)
        elif what == "book":
            if len(q) != 2:
                p.error("usage: book SID")
            sid = int(q[1])
            out.update(query=f"book[{sid}]",
                       value=xray.book_summary(engine, sid))
        elif what == "eval":
            if len(q) != 2:
                p.error("usage: eval 'EXPR'")
            pred = xray.parse_watch(q[1])
            fired, val = xray.eval_engine(pred, engine)
            out.update(query=q[1], value=val, fired=fired)
        elif what == "state":
            out.update(query="state",
                       value=xray.engine_canon(engine))
        else:
            p.error(f"unknown query {what!r} (balance | order | "
                    f"book | state | eval)")
        if args.json:
            print(json.dumps(out, indent=1, sort_keys=True))
        else:
            print(f"# {out['query']} @ {args.topic}"
                  f"[{'end' if at is None else at}] "
                  f"(anchor={anchor} replayed={replayed})")
            print(json.dumps(out["value"], indent=1, sort_keys=True))
            if "fired" in out:
                print(f"fired: {out['fired']}")
        return 1 if out.get("fired") else 0
    except xray.XrayError as e:
        print(f"kme-torch-xray: {e}", file=sys.stderr)
        return 2


def serve_main(argv=None) -> int:
    from kme_tpu_torch.bridge.serve import main as _main

    return _main(argv)


def consume_main(argv=None) -> int:
    from kme_tpu_torch.bridge.consume import main as _main

    return _main(argv)


def provision_main(argv=None) -> int:
    from kme_tpu_torch.bridge.provision import main as _main

    return _main(argv)


def front_main(argv=None) -> int:
    """Multi-leader front door: split MatchIn into per-group substreams
    (cross-shard balance transfers injected), merge per-group MatchOut
    streams into the canonical global feed, verify vs the oracle, or
    route a stream to N group services over TCP."""
    from kme_tpu_torch.bridge.front import main as _main

    return _main(argv)


def reshard_main(argv=None) -> int:
    """Live N->M group re-split over drained leaders: fence the old
    epochs durably, migrate book/position state through the checkpoint
    codec, settle balances with stamped exactly-once transfer legs."""
    from kme_tpu_torch.bridge.reshard import main as _main

    return _main(argv)


def feed_main(argv=None) -> int:
    """Market-data fan-out server: book deltas, depth snapshots,
    subscriber filtering, conflation."""
    from kme_tpu_torch.feed.server import main as _main

    return _main(argv)


def supervise_main(argv=None) -> int:
    """Failure detection + supervised restart of kme-torch-serve."""
    from kme_tpu_torch.bridge.supervise import main as _main

    return _main(argv)


def standby_main(argv=None) -> int:
    """Hot-standby replica: tail the leader's durable input, stay one
    batch behind, take over (next leader epoch, old one fenced) when
    kme-torch-supervise writes the promote file."""
    from kme_tpu_torch.bridge.replica import main as _main

    return _main(argv)


def chaos_main(argv=None) -> int:
    """Deterministic fault-injection drills against supervised serve
    children: every fault class, hot-standby failover, the multi-leader
    and feed drills, live resharding and the overload storms, each
    verified byte for byte. Runs the seq engine on the card unless told
    `--device cpu` or `--engine oracle`."""
    from kme_tpu_torch.bridge.chaos import main as _main

    return _main(argv)


def top_main(argv=None) -> int:
    """Live operations dashboard over the /metrics.json surfaces of a
    leader, an optional standby, and the supervisor state file."""
    from kme_tpu_torch.telemetry.top import main as _main

    return _main(argv)


def events_main(argv=None) -> int:
    """Control-plane flight recorder query tool: merge per-process
    event logs into one causally-ordered timeline, filter or follow it,
    explain one event from the TSDB history (--why), or render it as
    Chrome trace-events."""
    from kme_tpu_torch.telemetry.events_cli import main as _main

    return _main(argv)


def oracle_main(argv=None) -> int:
    """Reference-replica engine over stdin/stdout: read order JSON lines,
    print the 'IN {...}' / 'OUT {...}' stream consumer.js would show."""
    p = argparse.ArgumentParser(prog="kme-torch-oracle",
                                description=oracle_main.__doc__)
    p.add_argument("--compat", choices=("java", "fixed"), default="java")
    args = p.parse_args(argv)
    from kme_tpu_torch.oracle import OracleEngine
    from kme_tpu_torch.wire import parse_order

    eng = OracleEngine(args.compat)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        for rec in eng.process(parse_order(line)):
            print(rec.wire())
    return 0


def sim_main(argv=None) -> int:
    """Deterministic whole-cluster simulation: seeded virtual-clock
    runs, seed sweeps, shrinking repros (kme_tpu_torch/sim/)."""
    from kme_tpu_torch.sim.cli import sim_main as _main

    return _main(argv)


def lint_main(argv=None) -> int:
    """Repo-native static analysis over kme_tpu_torch/: hot-path,
    determinism, clock-seam, event-identity, dtype and lock rules."""
    from kme_tpu_torch.analysis.cli import main as _main

    return _main(argv)


def bench_main(argv=None) -> int:
    """Benchmark suites of the port (benchmarks.py): the card by default,
    `--device cpu` for the plain versions."""
    from kme_tpu_torch.benchmarks import main as _main

    return _main(argv)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m kme_tpu_torch.cli")
    p.add_argument("command", choices=(
        "serve", "loadgen", "consume", "provision", "trace", "prof",
        "top", "xray", "events", "agg", "front", "reshard", "feed",
        "supervise", "standby", "chaos", "oracle", "sim", "lint",
        "bench"))
    args, rest = p.parse_known_args(argv)
    try:
        return {"serve": serve_main, "loadgen": loadgen_main,
                "consume": consume_main, "provision": provision_main,
                "trace": trace_main, "prof": prof_main, "top": top_main,
                "xray": xray_main, "events": events_main,
                "agg": agg_main, "front": front_main,
                "reshard": reshard_main,
                "feed": feed_main, "supervise": supervise_main,
                "standby": standby_main, "chaos": chaos_main,
                "oracle": oracle_main, "sim": sim_main,
                "lint": lint_main, "bench": bench_main}[args.command](rest)
    except BrokenPipeError:
        # downstream closed the pipe (e.g. `| head`): point both std
        # streams at devnull so interpreter-shutdown flushes cannot
        # re-raise on the broken descriptors
        import os

        fd = os.open(os.devnull, os.O_WRONLY)
        os.dup2(fd, sys.stdout.fileno())
        os.dup2(fd, sys.stderr.fileno())
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
