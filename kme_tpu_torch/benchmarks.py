"""Benchmark suite of the PyTorch/CUDA port (BASELINE.md matrix).

The port's counterpart of the JAX package's `kme_tpu/benchmarks.py`:
the same suites, flags, defaults, workloads, detail keys and in-run
exactness checks, driving the port's sessions and services on the card
(`device="cuda"`, the default; `device="cpu"` runs the kernels' plain
PyTorch versions and is what the tests use). `kme-torch-bench` /
`python -m kme_tpu_torch.benchmarks` print ONE JSON line
(`metric`/`value`/`unit`/`vs_baseline`) on stdout and the detail JSON on
stderr.

The reference publishes no numbers (BASELINE.md); its structural bound is
single-digit-thousands of orders/sec (serial awaited produce per order,
commit per record, JSON serde, RocksDB round-trips — BASELINE.md table).
`REFERENCE_BASELINE_OPS` pins the top of that band (5k orders/sec) as the
denominator for `vs_baseline`. The environment has no JVM (no `java` on
PATH), so the reference cannot be measured here; the assumption and its
basis are documented in BASELINE.md and printed in the detail line.

Headline metric: END-TO-END orders/sec bytes in to bytes out through the
seq engine (`--suite lanes`, `--engine seq`) — native parse, plan and
pack, one dispatch of the CUDA chain kernel over the whole stream,
output fetch and native reconstruction — with the full stream held
byte for byte against the quirk-exact judge inside the run. The device
time is CUDA-event time of one `seq_scan` call over all chunks of the
planned stream. Phase timings are reported in the detail line.

`backend` in a detail names the device type that ran the suite's engine
(`cuda` on the card, `cpu` for the plain versions and for the suites
whose engines run on the host), as the port's perfgate reads it.
"""

from __future__ import annotations

import json
import sys
import time

REFERENCE_BASELINE_OPS = 5_000.0  # orders/sec, derived bound (BASELINE.md)

# Bench-default compaction width of the sweep engine (hot-lane depth
# bounds the step count on the Zipf-1.2 headline config, so narrow steps
# win; on un-skewed workloads wider steps amortize better — LaneSession's
# own default stays 16 for that reason).
DEFAULT_WIDTH = 4

# Latency-suite micro-batch size (one constant for the function, the
# CLI, and the BASELINE.md row).
DEFAULT_LATENCY_BATCH = 2048

# the five adversarial storm profiles (workload.STORM_PROFILES), usable
# as --workload names on the engine suites and driven deterministically
# end-to-end by --suite storms
STORM_WORKLOADS = ("payout-storm-wide", "flash-crowd", "cancel-storm",
                   "hot-book", "liquidation-cascade")

# the wire suite's floor on the binary/JSON ingress ratio, asserted in the
# run on the CPU backend (the floor the binary path exists to clear)
WIRE_SPEEDUP_FLOOR = 1.5

# the multihost suite's serve children exit after this many idle seconds.
# The front feeds the groups one after another, so a child waits for its
# input while the groups before it are fed; 3 s (the JAX package's value)
# is shorter than feeding 6,000 events' first group on a shared host, and
# a child that idles out before its first record fails the run
MULTIHOST_IDLE_EXIT_S = 10


def _judge_wire(msgs, prefix: int, kw: dict):
    """The quirk-exact judge's wire stream for a message prefix: the
    native C++ replica when available (itself pinned byte+store-exact
    against the Python oracle), else the Python oracle. The native
    library is absent only under KME_NATIVE=0; a failed build raises,
    and a native-engine failure must SURFACE, not silently fall back —
    the judge's health is part of what the check verifies."""
    from kme_tpu_torch.native.oracle import NativeOracleEngine, \
        native_available

    if native_available():
        judge = NativeOracleEngine("fixed", **kw)
        return judge.process_wire([m.copy() for m in msgs[:prefix]])
    from kme_tpu_torch.oracle import OracleEngine

    print("bench: native judge unavailable; using the Python oracle",
          file=sys.stderr)
    ora = OracleEngine("fixed", **kw)
    return [[r.wire() for r in ora.process(msgs[i].copy())]
            for i in range(prefix)]


def _assert_parity_prefix(msgs, cfg, shards, prefix: int,
                          width: int, device: str = "cuda") -> None:
    """Replay `prefix` messages through a throwaway session and the
    quirk-exact reference replica (with the matching capacity envelope);
    require byte-identical wire streams."""
    from kme_tpu_torch.runtime.session import LaneSession

    ses = LaneSession(cfg, shards=shards, width=width, device=device)
    want = _judge_wire(msgs, prefix,
                       dict(book_slots=cfg.slots, max_fills=cfg.max_fills))
    got = ses.process_wire(msgs[:prefix])
    for i in range(prefix):
        assert got[i] == want[i], \
            f"bench parity prefix diverged at message {i}"


SEQ_DEFAULT_SLOTS = 8192   # deep books: the Zipf hot lane rests ~2k
                           # orders at 100k events; 8192 leaves the
                           # envelope a non-story (rej_capacity == 0)


def _wire_buffer(msgs) -> bytes:
    """The stream as newline-separated order JSON — the engine's real
    input boundary (the reference consumes JSON bytes from Kafka,
    KProcessor.java:96)."""
    from kme_tpu_torch.wire import dumps_order

    return ("\n".join(dumps_order(m) for m in msgs)).encode()


def _sync(dev) -> None:
    """Wait for the work queued on `dev` (nothing to wait for on the
    CPU, where every op has run when it returns)."""
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def _scan_time(cfg, batch, reps: int, device: str):
    """Best-of-`reps` time of ONE `seq_scan` call over all K chunks of
    `batch` as one fresh session plans it (after one warm call).
    -> (seconds, K).

    `seq_scan` updates the state in place, so every call starts from its
    own clone of the empty state, made outside the timed window. On the
    card the window is a pair of CUDA events around the call (its
    rows-in-use launch included, at more than one row per side); on the
    CPU the host clock times the plain version."""
    import numpy as np
    import torch

    from kme_tpu_torch.engine import seq as SQ
    from kme_tpu_torch.runtime.seqsession import SeqSession

    ses = SeqSession(cfg, device=device)
    _cols, _hr, stacked, _cnts, K = ses._plan(batch)
    dev = ses.device
    inp = {f: torch.from_numpy(np.ascontiguousarray(stacked[f], np.int32))
           .to(dev) for f in SQ.msg_fields(cfg)}
    state0 = ses.state

    def timed() -> float:
        st = {k: v.clone() for k, v in state0.items()}
        _sync(dev)
        if dev.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            SQ.seq_scan(cfg, st, inp)
            e1.record()
            e1.synchronize()
            return e0.elapsed_time(e1) * 1e-3
        t0 = time.perf_counter()
        SQ.seq_scan(cfg, st, inp)
        return time.perf_counter() - t0

    timed()   # warm: the first call builds or loads the kernel
    return min(timed() for _ in range(max(reps, 1))), K


def _device_method(device: str) -> str:
    if device == "cpu":
        return ("host clock around one seq_scan call over all chunks (the "
                "plain PyTorch version), fresh state clone per rep outside "
                "the window; best of reps")
    return ("CUDA events around one seq_scan call over all chunks (chain "
            "kernel + rows-in-use), fresh state clone per rep outside the "
            "window; best of reps; covers all chunks incl. padding")


def _device_path(cfg, batch, reps: int = 3, device: str = "cuda") -> dict:
    """Transfer-free device-path time of ONE full-stream scan dispatch:
    the inputs are on the device before the window opens and no output
    leaves it (see _scan_time)."""
    t, K = _scan_time(cfg, batch, reps, device)
    n = len(batch)
    dev_s = max(t, 1e-9)
    return {"device_path_s": round(dev_s, 4),
            "device_path_msgs_per_sec": round(n / dev_s, 1),
            "method": _device_method(device), "chunks": K}


def _judge_seq_full(msgs, cfg, compat: str):
    """The quirk-exact judge's FULL wire stream as one byte buffer
    (concatenated lines, the exact layout process_wire_buffer emits)."""
    if compat == "java":
        from kme_tpu_torch.native.oracle import NativeOracleEngine, \
            native_available

        if native_available():
            judge = NativeOracleEngine("java")
            lines = judge.process_wire([m.copy() for m in msgs])
        else:
            from kme_tpu_torch.oracle import OracleEngine

            print("bench: native judge unavailable; using the Python "
                  "oracle", file=sys.stderr)
            ora = OracleEngine("java")
            lines = [[r.wire() for r in ora.process(m.copy())]
                     for m in msgs]
    else:
        lines = _judge_wire(msgs, len(msgs),
                            dict(book_slots=cfg.slots,
                                 max_fills=cfg.max_fills))
    return "".join(ln for per in lines for ln in per).encode()


def _bench_seq_latency(symbols: int, accounts: int, seed: int,
                       zipf_a: float, events: int = 40_960,
                       batch: int = DEFAULT_LATENCY_BATCH,
                       device: str = "cuda") -> dict:
    """Streaming micro-batch latency on the seq engine, double-buffered
    (SURVEY.md §7 H5): batch N+1 DISPATCHES before batch N's outputs
    fetch/reconstruct (SeqSession.submit/collect), so device execution
    overlaps host recon. Reported per 2048-msg batch:

    - engine-side p50/p99 = per-batch host work (route+pack measured
      per batch, recon measured per batch) + the device time per batch
      (one timed `seq_scan` over the whole stream's K chunks, over K —
      an average: per-batch device variance is below the host jitter on
      this homogeneous mix); fetch is excluded.
    - streamed_orders_per_sec: the pipelined wall-clock rate, with the
      serial rate alongside as the overlap evidence. The `tunnel_wall_*`
      keys keep the JAX package's names: here they are each batch's
      submit-to-collected wall.
    """
    from kme_tpu_torch.engine import seq as SQ
    from kme_tpu_torch.runtime.seqsession import SeqSession
    from kme_tpu_torch.wire import WireBatch
    from kme_tpu_torch.workload import zipf_symbol_stream

    msgs = zipf_symbol_stream(events, num_symbols=symbols,
                              num_accounts=accounts, seed=seed,
                              zipf_a=zipf_a)
    cfg = SQ.SeqConfig(lanes=symbols, slots=128, accounts=accounts,
                       max_fills=16, batch=batch)
    batches = [WireBatch.from_msgs(msgs[lo:lo + batch])
               for lo in range(0, len(msgs), batch)]

    # device time per batch: one timed scan over the whole stream's K
    # chunks (events/batch chunks, padded to a power of two), over K
    t_dev, K = _scan_time(cfg, WireBatch.from_msgs(msgs), 2, device)
    dev_batch_s = t_dev / K

    def run(pipelined: bool):
        # drives the REAL serving surface (SeqSession.submit/collect —
        # the same calls kme-torch-serve --pipeline makes); the session's
        # flight-recorder windows feed measured_overlap_s
        ses = SeqSession(cfg, device=device)
        walls, per_batch, pend = [], [], []

        def collect_one():
            nb2, t_sub, handle = pend.pop(0)
            p0 = dict(ses.phases)
            ses.collect(handle)
            p1 = ses.phases
            walls.append(time.perf_counter() - t_sub)
            per_batch[nb2]["fetch_ms"] = round(
                (p1.get("fetch_s", 0.0) - p0.get("fetch_s", 0.0)) * 1e3,
                3)
            per_batch[nb2]["recon_ms"] = round(
                (p1.get("recon_s", 0.0) - p0.get("recon_s", 0.0)) * 1e3,
                3)

        t_all = time.perf_counter()
        for nb, bt in enumerate(batches):
            t_sub = time.perf_counter()
            p0 = dict(ses.phases)
            handle = ses.submit(bt)
            p1 = ses.phases
            per_batch.append({
                "plan_ms": round((p1.get("plan_s", 0.0)
                                  - p0.get("plan_s", 0.0)) * 1e3, 3),
                "dispatch_ms": round(
                    (p1.get("dispatch_s", 0.0)
                     - p0.get("dispatch_s", 0.0)) * 1e3, 3)})
            pend.append((nb, t_sub, handle))
            while len(pend) > (1 if pipelined else 0):
                collect_one()
        while pend:
            collect_one()
        return time.perf_counter() - t_all, per_batch, walls, ses

    run(True)   # warm: the kernel build and the allocator
    t_serial, _pb0, _w0, _ses0 = run(False)
    t_pipe, per_batch, walls, ses_pipe = run(True)

    from kme_tpu_torch.telemetry.journal import measured_overlap_s

    windows = ses_pipe.windows
    overlap_s = measured_overlap_s(windows)
    collect_wall = sum(t1 - t0 for kind, _b, t0, t1 in windows
                      if kind == "collect")

    eng = sorted((pb["plan_ms"] + pb["recon_ms"]) * 1e-3 + dev_batch_s
                 for pb in per_batch)

    def pct(xs, p):
        import math

        return xs[max(0, min(len(xs) - 1, math.ceil(p * len(xs)) - 1))]

    ph = ses_pipe.phases
    res = {
        "batch": batch, "batches": len(batches), "events": len(msgs),
        "engine_side_p50_ms": round(pct(eng, 0.50) * 1e3, 2),
        "engine_side_p90_ms": round(pct(eng, 0.90) * 1e3, 2),
        "engine_side_p99_ms": round(pct(eng, 0.99) * 1e3, 2),
        "device_ms_per_batch": round(dev_batch_s * 1e3, 2),
        "tunnel_wall_p50_ms": round(
            pct(sorted(walls), 0.50) * 1e3, 1),
        "tunnel_wall_p99_ms": round(
            pct(sorted(walls), 0.99) * 1e3, 1),
        "streamed_orders_per_sec": round(len(msgs) / t_pipe, 1),
        "serial_orders_per_sec": round(len(msgs) / t_serial, 1),
        "pipeline_speedup": round(t_serial / t_pipe, 2),
        # measured from the recorded submit/collect windows: wall time
        # a collect actually ran while another batch was in flight on
        # device. The FRACTION is over the total collect wall — the
        # host-side work the pipeline exists to hide — so it converges
        # structurally to 1.0 under working double-buffering and is
        # gateable, unlike the t_serial/t_pipe ratio, which rides two
        # wall clocks
        "measured_overlap_s": round(overlap_s, 4),
        "collect_wall_s": round(collect_wall, 4),
        "measured_overlap_frac": round(
            overlap_s / max(collect_wall, 1e-9), 4),
        # cumulative phase walls of the pipelined run (mirrors the
        # java sub-dict's field names for artifact-diffing)
        "plan_s": round(ph.get("plan_s", 0.0), 4),
        "dispatch_s": round(ph.get("dispatch_s", 0.0), 4),
        "fetch_s": round(ph.get("fetch_s", 0.0), 4),
        "recon_s": round(ph.get("recon_s", 0.0), 4),
        "per_batch": per_batch,
        "method": "double-buffered submit/collect (the serving API); "
                  "engine-side = per-batch plan+recon (measured) + "
                  "device/batch (" + _device_method(device) + ", over "
                  "K); tunnel_wall = each batch's submit-to-collected "
                  "wall; measured_overlap_frac = overlap / collect wall "
                  "is the gateable overlap evidence",
    }
    res["backend"] = ses_pipe.device.type
    if res["measured_overlap_frac"] < 0.5:
        res["pipeline_warning"] = (
            f"measured_overlap_frac {res['measured_overlap_frac']} "
            "< 0.5 — less than half the collect wall was hidden under "
            "device execution; the double-buffer is not overlapping "
            "(host-bound batches or a serializing transport)")
        print(f"kme-torch-bench: WARNING {res['pipeline_warning']}",
              file=sys.stderr)
    publish_pipeline_gauges(ses_pipe.telemetry, res)
    return res


def publish_pipeline_gauges(registry, detail: dict) -> None:
    """Pipeline health as LIVE gauges (the same registry a
    --metrics-port scrape or heartbeat snapshot reads). The warning
    travels as a numeric 0/1 gauge — Prometheus carries no strings —
    with the prose staying in the detail dict."""
    g = registry.gauge
    for k in ("pipeline_speedup", "device_ms_per_batch",
              "measured_overlap_frac", "local_s"):
        if k in detail:
            g(k).set(detail[k])
    g("pipeline_warning",
      "1 when measured_overlap_frac fell under 0.5 (the collect wall "
      "is not being hidden under device execution)").set(
        1 if detail.get("pipeline_warning") else 0)


def bench_pipeline(events: int = 40_960, symbols: int = 32,
                   accounts: int = 256, seed: int = 0,
                   zipf_a: float = 1.2, batch: int = 1024,
                   depth: int = 2, device: str = "cuda") -> dict:
    """IN-PROCESS pipelined serving bench (no TCP, no broker): the
    serve hot path — bytes parse -> native plan+pack -> async dispatch
    under the previous batch's device step -> fetch -> native
    reconstruction — driven through SeqSession.submit/collect exactly
    as `kme-torch-serve --pipeline` drives it, against the serial
    submit+collect-immediately loop over the SAME byte stream.

    Because no transport round trips serialize the loop, this is the
    suite where the double-buffer's wall-clock win is actually
    measurable (pipeline_speedup > 1) and where the host-path gate
    metrics are recorded: `local_s` (parse + plan + recon — the wall
    the host spends OFF the device) and `measured_overlap_frac`
    (fraction of the collect wall hidden under device execution).
    Output parity between the two runs is asserted byte-for-byte. On the
    CPU (`device="cpu"`) a submit runs its batch before it returns, so
    the overlap figures there measure no device concurrency."""
    from kme_tpu_torch.engine import seq as SQ
    from kme_tpu_torch.native import load_library
    from kme_tpu_torch.runtime.seqsession import SeqSession
    from kme_tpu_torch.wire import WireBatch, dumps_order
    from kme_tpu_torch.workload import zipf_symbol_stream

    if load_library() is None:
        raise RuntimeError(
            "the pipeline suite needs the native host runtime "
            "(KME_NATIVE=0 or no toolchain?) — the buffer serving "
            "path under test is native-only")
    msgs = zipf_symbol_stream(events, num_symbols=symbols,
                              num_accounts=accounts, seed=seed,
                              zipf_a=zipf_a)
    slots = 128
    accounts_eff = -(-accounts // 128) * 128
    cfg = SQ.SeqConfig(lanes=symbols, slots=slots,
                       accounts=accounts_eff, max_fills=16,
                       batch=max(128, min(4096,
                                          1 << (batch - 1).bit_length())))
    # the serve loop's input: newline-framed wire bytes per batch
    bufs = []
    for lo in range(0, len(msgs), batch):
        bufs.append("\n".join(dumps_order(m)
                              for m in msgs[lo:lo + batch]).encode())

    def run(pipelined: bool):
        ses = SeqSession(cfg, device=device)
        parse_s = 0.0
        pend, outs, per_batch = [], [], []

        def collect_one():
            nb2, handle = pend.pop(0)
            p0 = dict(ses.phases)
            buf, _lo, _ml = ses.collect(handle)
            p1 = ses.phases
            outs.append(buf)
            per_batch[nb2]["fetch_ms"] = round(
                (p1.get("fetch_s", 0.0) - p0.get("fetch_s", 0.0)) * 1e3,
                3)
            per_batch[nb2]["recon_ms"] = round(
                (p1.get("recon_s", 0.0) - p0.get("recon_s", 0.0)) * 1e3,
                3)

        t_all = time.perf_counter()
        for nb, raw in enumerate(bufs):
            t0 = time.perf_counter()
            wb = WireBatch.parse_buffer(raw)
            tp = time.perf_counter() - t0
            parse_s += tp
            p0 = dict(ses.phases)
            handle = ses.submit(wb)
            p1 = ses.phases
            per_batch.append({
                "parse_ms": round(tp * 1e3, 3),
                "plan_ms": round((p1.get("plan_s", 0.0)
                                  - p0.get("plan_s", 0.0)) * 1e3, 3),
                "dispatch_ms": round(
                    (p1.get("dispatch_s", 0.0)
                     - p0.get("dispatch_s", 0.0)) * 1e3, 3)})
            pend.append((nb, handle))
            while len(pend) > (depth if pipelined else 0):
                collect_one()
        while pend:
            collect_one()
        return (time.perf_counter() - t_all, parse_s, per_batch,
                b"".join(outs), ses)

    run(True)   # warm: the kernel build, the allocator, the host runtime
    # best-of-two per mode: the hideable host wall is a few percent of
    # the CPU device wall, so a single-run ratio flaps on scheduler
    # noise; the systematic win survives a min-of-2
    s_runs = [run(False) for _ in range(2)]
    t_serial = min(r[0] for r in s_runs)
    out_serial = s_runs[0][3]
    p_runs = [run(True) for _ in range(2)]
    t_pipe, parse_s, per_batch, out_pipe, ses = min(
        p_runs, key=lambda r: r[0])
    assert out_pipe == out_serial, (
        f"pipelined output diverged from serial "
        f"({len(out_pipe)} vs {len(out_serial)} bytes)")

    from kme_tpu_torch.telemetry.journal import measured_overlap_s

    windows = ses.windows
    overlap_s = measured_overlap_s(windows)
    collect_wall = sum(t1 - t0 for kind, _b, t0, t1 in windows
                       if kind == "collect")
    ph = ses.phases
    n = len(msgs)
    local_s = (parse_s + ph.get("plan_s", 0.0) + ph.get("recon_s", 0.0))
    ops = n / t_pipe
    detail = {
        "engine": "seq (submit/collect, in-process)",
        "events": n, "symbols": symbols, "accounts": accounts_eff,
        "batch": batch, "depth": depth, "batches": len(bufs),
        "serial_wall_s": round(t_serial, 4),
        "pipelined_wall_s": round(t_pipe, 4),
        "pipelined_orders_per_sec": round(ops, 1),
        "serial_orders_per_sec": round(n / t_serial, 1),
        "pipeline_speedup": round(t_serial / t_pipe, 4),
        "measured_overlap_s": round(overlap_s, 4),
        "collect_wall_s": round(collect_wall, 4),
        "measured_overlap_frac": round(
            overlap_s / max(collect_wall, 1e-9), 4),
        # fraction of the H2D staging wall that ran while an earlier
        # batch was still in flight on the device (the double-buffer's
        # staging surface; advisory-up in the gate — it rides wall
        # clocks)
        "h2d_overlap_frac": ses.h2d_overlap_frac,
        # the host-path wall the native layer exists to shrink:
        # bytes->columns parse + route/pack plan + output recon
        "local_s": round(local_s, 4),
        "local_orders_per_sec": round(n / max(local_s, 1e-9), 1),
        "parse_s": round(parse_s, 4),
        "plan_s": round(ph.get("plan_s", 0.0), 4),
        "dispatch_s": round(ph.get("dispatch_s", 0.0), 4),
        "fetch_s": round(ph.get("fetch_s", 0.0), 4),
        "recon_s": round(ph.get("recon_s", 0.0), 4),
        "per_batch": per_batch,
        "out_mb": round(len(out_pipe) / 1e6, 2),
        "parity": "pipelined byte stream == serial byte stream",
        "backend": ses.device.type,
        "method": "same byte stream through submit/collect twice: "
                  "serial (collect immediately) vs depth-N pipelined "
                  "(parse+plan+dispatch of batch N+1 under batch N's "
                  "device step); no transport in the loop",
    }
    if detail["measured_overlap_frac"] < 0.5:
        detail["pipeline_warning"] = (
            f"measured_overlap_frac {detail['measured_overlap_frac']} "
            "< 0.5 — less than half the collect wall was hidden under "
            "device execution")
        print(f"kme-torch-bench: WARNING {detail['pipeline_warning']}",
              file=sys.stderr)
    if detail["h2d_overlap_frac"] < 0.5:
        detail["h2d_warning"] = (
            f"h2d_overlap_frac {detail['h2d_overlap_frac']} < 0.5 — "
            "most input staging ran with the device idle")
        print(f"kme-torch-bench: WARNING {detail['h2d_warning']}",
              file=sys.stderr)
    publish_pipeline_gauges(ses.telemetry, detail)
    return {
        "metric": "pipelined_orders_per_sec",
        "value": round(ops, 1),
        "unit": "orders/s",
        "vs_baseline": round(ops / REFERENCE_BASELINE_OPS, 3),
        "detail": detail,
    }


def bench_seq_engine(events: int = 100_000, symbols: int = 1024,
                     accounts: int = 2048, seed: int = 0,
                     zipf_a: float = 1.2, slots: int = SEQ_DEFAULT_SLOTS,
                     max_fills: int = 16, batch: int = 4096,
                     workload: str = "zipf",
                     compat: str = "fixed",
                     with_java: bool = None,
                     journal_out: str = None,
                     audit: bool = False,
                     device: str = "cuda") -> dict:
    """End-to-end throughput of the SEQUENTIAL engine
    (kme_tpu_torch/engine/seq.py, the CUDA chain kernel) on the headline
    row, measured BYTES-IN to BYTES-OUT: native JSON parse -> columnar
    route + pack -> one dispatch over the whole stream -> fetch ->
    native C++ wire reconstruction. Parity is asserted on the FULL
    stream: the timed run's output buffer must equal the quirk-exact
    replica's, byte for byte.

    Also measured and reported:
    - device_path: transfer-free device time of one full-stream scan
      (see _scan_time: CUDA events on the card, best of
      KME_BENCH_DEV_REPS).
    - local_orders_per_sec: n / (parse + plan + recon + device_path) —
      the host phases plus the kernel, fetch excluded (its
      device->host traffic is reported as fetched_mb).

    On the card the function launches the chain kernel
    KME_BENCH_DEV_REPS + 1 times for the device path, once for the warm
    session and once per timed run (each run is one dispatch), plus the
    java sub-run's and the latency row's when they run.
    """
    import os

    from kme_tpu_torch.engine import seq as SQ
    from kme_tpu_torch.runtime.seqsession import SeqSession
    from kme_tpu_torch.wire import WireBatch
    from kme_tpu_torch.workload import cancel_heavy_stream, zipf_symbol_stream

    # `hbm_books` is passed as the JAX package sets it; the port's kernel
    # takes its deep-book route from `slots` alone (more than one row per
    # side: the rows-in-use kernel first) and ignores the flag
    if compat == "java":
        # quirk-exact java mode ON the kernel: the STOCK harness shape
        # (10 accounts, 3 symbols, Q5 payouts-as-cancels, sid=0
        # trading); unbounded reference stores need deep device
        # capacity (max_fills rides one (1,128) row, E <= 128)
        symbols, accounts = 8, 128
        max_fills = 128
        workload = "harness"
        eff_slots = max(slots, 8192)
        cfg = SQ.SeqConfig(lanes=symbols, slots=eff_slots,
                           accounts=accounts, max_fills=max_fills,
                           batch=batch, pos_cap=1 << 17,
                           probe_max=64, compat="java",
                           hbm_books=eff_slots > 8192)
    else:
        cfg = SQ.SeqConfig(lanes=symbols, slots=slots, accounts=accounts,
                           max_fills=max_fills, batch=batch,
                           hbm_books=slots > 512)
    if workload == "harness":
        from kme_tpu_torch.workload import harness_stream

        msgs = harness_stream(events, seed=seed)
    elif workload == "cancel":
        msgs = cancel_heavy_stream(events, num_symbols=symbols,
                                   num_accounts=accounts, seed=seed)
    elif workload == "zipf-hot":
        from kme_tpu_torch.workload import zipf_hot_stream

        msgs = zipf_hot_stream(events, num_symbols=symbols,
                               num_accounts=accounts, seed=seed)
    elif workload == "payout-storm":
        from kme_tpu_torch.workload import payout_storm_stream

        msgs = payout_storm_stream(events, num_symbols=symbols,
                                   num_accounts=accounts, seed=seed)
    elif workload in STORM_WORKLOADS:
        from kme_tpu_torch.workload import storm_stream

        msgs = storm_stream(workload, events, num_symbols=symbols,
                            num_accounts=accounts, seed=seed)
    else:
        msgs = zipf_symbol_stream(events, num_symbols=symbols,
                                  num_accounts=accounts, seed=seed,
                                  zipf_a=zipf_a)
    n = len(msgs)
    in_buf = _wire_buffer(msgs)
    batch0 = WireBatch.parse_buffer(in_buf)

    # transfer-free device path first (it builds or loads the kernel)
    dev = _device_path(cfg, batch0,
                       reps=int(os.environ.get("KME_BENCH_DEV_REPS",
                                               "3")), device=device)

    warm = SeqSession(cfg, device=device)   # warmup: allocator, LUTs
    native_ok = warm.process_wire_buffer(batch0) is not None
    if not native_ok:
        warm.process_wire(msgs)     # KME_NATIVE=0: warm the Python path
    # a shared host varies run to run; report the best of three timed
    # runs as steady-state and disclose every run's wall
    runs = []
    best = None
    for _rep in range(3):
        ses = SeqSession(cfg, device=device)
        ses._ghint = getattr(warm, "_ghint", ses._ghint)
        t0 = time.perf_counter()
        bt = WireBatch.parse_buffer(in_buf)
        t_parse = time.perf_counter() - t0
        if native_ok:
            r = ses.process_wire_buffer(bt)
            total = time.perf_counter() - t0
            out_buf, line_off, _ml = r
            n_records = len(line_off) - 1
            split = (line_off, _ml)
        else:
            records = ses.process_wire(bt)
            total = time.perf_counter() - t0
            out_buf = "".join(ln for per in records
                              for ln in per).encode()
            n_records = sum(len(x) for x in records)
            split = records
        runs.append(round(total, 3))
        if best is None or total < best[0]:
            best = (total, n_records, dict(ses.phases, parse_s=t_parse),
                    ses.metrics(), out_buf, split)
    total, n_records, ph, metrics, out_buf, split = best
    # FULL-STREAM parity: the timed run's byte stream vs the judge
    want_buf = _judge_seq_full(msgs, cfg, compat)
    assert out_buf == want_buf, (
        f"seq bench FULL-STREAM parity diverged "
        f"(got {len(out_buf)} bytes, want {len(want_buf)})")
    parity_checked = n
    ops = n / total
    local_s = (ph.get("parse_s", 0.0) + ph.get("plan_s", 0.0)
               + ph.get("recon_s", 0.0) + dev["device_path_s"])
    HR = SQ.hdr_rows(cfg)
    ghint = getattr(warm, "_ghint", 8)
    fetched_mb = (dev["chunks"] * (HR + 5 * ghint) * 128 * 4) / 1e6
    detail = {
        "engine": "seq (sequential CUDA chain kernel)",
        "compat": compat,
        "events": n, "symbols": symbols, "accounts": accounts,
        "workload": workload, "zipf_a": zipf_a, "slots": slots,
        "max_fills": max_fills, "batch": batch,
        "parse_s": round(ph.get("parse_s", 0.0), 3),
        "plan_s": round(ph.get("plan_s", 0.0), 3),
        "dispatch_s": round(ph.get("dispatch_s", 0.0), 3),
        "fetch_s": round(ph.get("fetch_s", 0.0), 3),
        "recon_s": round(ph.get("recon_s", 0.0), 3),
        "total_s": round(total, 3),
        "all_run_walls_s": runs,
        # transfer-free device path, measured in-run (see _scan_time)
        "device_path_s": dev["device_path_s"],
        "device_path_msgs_per_sec": dev["device_path_msgs_per_sec"],
        "device_path_method": dev["method"],
        # the host phases plus the kernel (fetch excluded; the fetch
        # moves fetched_mb of output)
        "local_orders_per_sec": round(n / max(local_s, 1e-9), 1),
        "local_s": round(local_s, 4),
        "fetched_mb": round(fetched_mb, 2),
        "out_records": n_records,
        "out_mb": round(len(out_buf) / 1e6, 2),
        "accepted_orders_per_sec": round(
            (n - int(metrics.get("rej_capacity", 0))) / total, 1),
        "cap_rejects": int(metrics.get("rej_capacity", 0)),
        "parity_checked_msgs": parity_checked,
        "parity": "full-stream byte-exact vs native judge",
        "backend": ses.device.type,
        "baseline_assumption_ops": REFERENCE_BASELINE_OPS,
        "vs_baseline_note": "vs_baseline divides by the ASSUMED 5k "
                            "orders/s reference bound (BASELINE.md) — "
                            "no measured JVM baseline exists in this "
                            "environment",
        "device_metrics": metrics,
    }
    if (journal_out is not None or audit) and compat == "fixed":
        # flight-recorder overhead row: journal + audit the BEST run's
        # byte stream POST-HOC (the timed runs stay untouched — the
        # parity assert above proves the stream is the engine's), and
        # report the cost as a fraction of the run wall, i.e. the
        # overhead kme-torch-serve pays doing the same work inline per batch
        from kme_tpu_torch.telemetry.audit import InvariantAuditor
        from kme_tpu_torch.telemetry.journal import Journal, batch_events

        if native_ok:
            # native output is one flat buffer; line_off marks record
            # boundaries, ml counts records per input message
            line_off, ml = split
            text = out_buf.decode()
            lines = [text[line_off[k]:line_off[k + 1]]
                     for k in range(len(line_off) - 1)]
            per_msg, k = [], 0
            for c in ml:
                per_msg.append(lines[k:k + int(c)])
                k += int(c)
        else:
            per_msg = split
        jd = {"events": n}
        if journal_out is not None:
            t0 = time.perf_counter()
            j = Journal(journal_out)
            for lo in range(0, len(per_msg), batch):
                chunk = per_msg[lo:lo + batch]
                j.record_batch(chunk,
                               offsets=list(range(lo, lo + len(chunk))))
            j.close()
            journal_s = time.perf_counter() - t0
            jd.update({"path": journal_out,
                       "journal_s": round(journal_s, 3),
                       "journal_overhead_frac":
                           round(journal_s / total, 4)})
        if audit:
            aud = InvariantAuditor()
            t0 = time.perf_counter()
            for lo in range(0, len(per_msg), batch):
                aud.observe(batch_events(per_msg[lo:lo + batch]))
            audit_s = time.perf_counter() - t0
            jd.update({"audit_s": round(audit_s, 3),
                       "audit_overhead_frac": round(audit_s / total, 4),
                       "audit_violations": len(aud.violations)})
        detail["journal"] = jd
    if compat == "fixed" and n >= 50_000 and native_ok \
            and os.environ.get("KME_BENCH_LATENCY", "1") != "0":
        # the streaming-latency row: engine-side per-batch latency +
        # double-buffered serving overlap, in the same artifact
        detail["latency"] = _bench_seq_latency(symbols, accounts, seed,
                                               zipf_a, device=device)
    if with_java is None:
        with_java = (compat == "fixed"
                     and os.environ.get("KME_BENCH_JAVA", "1") != "0")
    if with_java:
        # the quirk-exact java lane as a sub-run, so that one artifact
        # carries BOTH headline rows
        sub = bench_seq_engine(events=100_000, seed=seed, batch=batch,
                               compat="java", with_java=False,
                               device=device)
        keep = ("events", "device_path_s", "device_path_msgs_per_sec",
                "local_orders_per_sec", "parse_s", "plan_s",
                "dispatch_s", "fetch_s", "recon_s", "total_s",
                "parity_checked_msgs", "cap_rejects", "out_records")
        detail["java"] = {k: sub["detail"][k] for k in keep}
        detail["java"]["orders_per_sec_e2e"] = sub["value"]
    return {
        "metric": ("orders_per_sec_java_exact_tpu" if compat == "java"
                   else "orders_per_sec_e2e"),
        "value": round(ops, 1),
        "unit": "orders/s",
        "vs_baseline": round(ops / REFERENCE_BASELINE_OPS, 3),
        "detail": detail,
    }


def bench_lane_engine(events: int = 100_000, symbols: int = 1024,
                      accounts: int = 2048, seed: int = 0,
                      zipf_a: float = 1.2, steps: int = 64,
                      slots: int = 128, max_fills: int = 16,
                      shards: int = 1, parity_prefix: int = 20000,
                      width: int = DEFAULT_WIDTH,
                      workload: str = "zipf", window: int = 1024,
                      profile_dir: str = None,
                      device: str = "cuda") -> dict:
    """End-to-end throughput of the sweep (lanes) engine, phase by phase:
    plan, pack + dispatch (on the card each padded step replays the step
    graph, with one launch of each row-copy kernel, B4 gather and B5
    scatter, under pos_dma), fetch, reconstruction; fill parity vs the
    quirk-exact judge on a stream prefix inside the run.
    workload: 'zipf' (the headline row), 'cancel' (the bursty
    cancel/replace BASELINE.md row) or a storm profile. `profile_dir`
    gets a torch.profiler Chrome trace (`trace.json`) of the timed run."""
    import os

    from kme_tpu_torch.engine.lanes import LaneConfig
    from kme_tpu_torch.runtime.session import LaneSession
    from kme_tpu_torch.workload import cancel_heavy_stream, zipf_symbol_stream

    cfg = LaneConfig(lanes=symbols, slots=slots, accounts=accounts,
                     max_fills=max_fills, steps=steps, window=window)
    if workload == "cancel":
        msgs = cancel_heavy_stream(events, num_symbols=symbols,
                                   num_accounts=accounts, seed=seed)
    elif workload in STORM_WORKLOADS:
        from kme_tpu_torch.workload import storm_stream

        msgs = storm_stream(workload, events, num_symbols=symbols,
                            num_accounts=accounts, seed=seed)
    else:
        msgs = zipf_symbol_stream(events, num_symbols=symbols,
                                  num_accounts=accounts, seed=seed,
                                  zipf_a=zipf_a)

    # correctness inside the bench: oracle parity on a stream prefix that
    # extends past the preamble into the trade mix
    preamble = 2 * accounts + symbols
    prefix = min(preamble + parity_prefix, len(msgs))
    _assert_parity_prefix(msgs, cfg, shards, prefix, width, device)

    # warmup run on a fresh session: builds the kernels, the allocator's
    # pool and the window buffers of every (T, M) bucket
    LaneSession(cfg, shards=shards, width=width,
                device=device).process(msgs)

    # timed run, phase by phase (sum = the honest end-to-end number)
    ses = LaneSession(cfg, shards=shards, width=width, device=device)
    prof = None
    if profile_dir:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if ses.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    try:
        t0 = time.perf_counter()
        sched = ses.scheduler.plan(msgs)
        t_plan = time.perf_counter() - t0

        t0 = time.perf_counter()
        runs, barrier_ok = ses._dispatch(sched)   # pack + async dispatch
        _sync(ses.device)
        t_disp = time.perf_counter() - t0

        t0 = time.perf_counter()
        fills = ses._fetch(runs)
        t_fetch = time.perf_counter() - t0

        t0 = time.perf_counter()
        records = ses._reconstruct_wire(msgs, sched, runs, barrier_ok, fills)
        t_recon = time.perf_counter() - t0
    finally:
        if prof is not None:
            prof.stop()
            prof.export_chrome_trace(os.path.join(profile_dir,
                                                  "trace.json"))

    n = len(msgs)
    total = t_plan + t_disp + t_fetch + t_recon
    # the serving number: one unphased process_wire call on a fresh
    # session — device compute, transfers and reconstruction overlap
    # naturally there, unlike the phase-separated sum above
    ses2 = LaneSession(cfg, shards=shards, width=width, device=device)
    t0 = time.perf_counter()
    ses2.process_wire(msgs)
    t_unphased = time.perf_counter() - t0
    metrics = ses.metrics()
    nfills = sum(int(r.host["nfill_total"]) for r in runs)
    # slice to the real placements: the M bucket is padded and padding
    # entries report ok=False
    cap_rejects = sum(int(r.host["cap_reject"][:len(r.idx)].sum())
                      for r in runs)
    rejects = sum(int((~r.host["ok"][:len(r.idx)]).sum())
                  for r in runs)
    n_records = sum(len(r) for r in records)
    steps_total = sum(sched.segment_steps)
    ops = n / total
    return {
        "metric": "orders_per_sec_e2e",
        "value": round(ops, 1),
        "unit": "orders/s",
        "vs_baseline": round(ops / REFERENCE_BASELINE_OPS, 3),
        "detail": {
            "events": n, "symbols": symbols, "accounts": accounts,
            "workload": workload,
            "zipf_a": zipf_a, "shards": shards, "slots": slots,
            "max_fills": max_fills, "width": width,
            "plan_s": round(t_plan, 3), "dispatch_s": round(t_disp, 3),
            "fetch_s": round(t_fetch, 3), "recon_s": round(t_recon, 3),
            "total_s": round(total, 3),
            "device_orders_per_sec": round(n / max(t_disp + t_fetch, 1e-9), 1),
            "unphased_orders_per_sec": round(n / max(t_unphased, 1e-9), 1),
            "sched_steps": steps_total,
            "msgs_per_step": round(n / max(steps_total, 1), 1),
            "trades": nfills, "out_records": n_records,
            "cap_rejects": cap_rejects, "rejects": rejects,
            "parity_checked_msgs": prefix,
            "backend": ses.device.type,
            "baseline_assumption_ops": REFERENCE_BASELINE_OPS,
            # on-device counters (scan-carry accumulated) + gauges
            "device_metrics": metrics,
            # utilization: device-busy fraction of the e2e wall, and an
            # HBM-traffic estimate for the scan (dominant modeled terms:
            # the two position-array scatter copies r+w per step, plus
            # the gathered/scattered book rows) — integer workload, so
            # bandwidth-bound utilization is the honest analog of MFU
            "device_busy_frac": round((t_disp + t_fetch) / total, 3),
            "per_step_us": round(t_disp / max(steps_total, 1) * 1e6, 1),
            # MODELED, not measured: derived from the _est_step_bytes
            # bytes-per-step formula, like baseline_assumption_ops
            "modeled_hbm_gbps": round(
                _est_step_bytes(
                    symbols + (1 if shards == 1 and width > 0 else 0),
                    accounts, slots, max_fills,
                    width if shards == 1 and width > 0 else symbols)
                * steps_total / max(t_disp, 1e-9) / 1e9, 1),
        },
    }


def _est_step_bytes(S, A, N, E, W) -> int:
    """Modeled HBM bytes touched per scan step (see bench detail note):
    position traffic, 6 slot-row arrays gathered + scattered at width W,
    fill outputs. With pos_dma active (compact width and accounts % 64
    == 0 — mirrors LaneSession's enable rule) positions move as row
    copies (W rows x 2A i32, in+out, two arrays: the B4 gather and B5
    scatter kernels) instead of full-array scatter rewrites."""
    if W < S and (2 * A) % 128 == 0:  # pos_dma row DMA
        pos = 2 * 2 * W * 2 * A * 4
    else:  # full-array scatter rewrite, read+write, 8B each
        pos = 2 * 2 * 8 * S * A
    rows = 2 * 6 * W * 2 * N * 4
    fills = 4 * W * E * 8
    return pos + rows + fills


def bench_native_engine(events: int = 100_000, seed: int = 0,
                        batch: int = 8192, compat: str = "java") -> dict:
    """Quirk-exact throughput of the NATIVE C++ engine on the stock
    harness workload — the fast java-compat serving path (COMPAT.md:
    quirk-exact parallelism is impossible under Q11, so this host-native
    engine plays the role the reference's own JVM stack plays)."""
    from kme_tpu_torch.native.oracle import NativeOracleEngine
    from kme_tpu_torch.workload import harness_stream

    msgs = harness_stream(events, seed=seed)
    if len(msgs) <= batch:
        raise ValueError(
            f"events ({len(msgs)} incl. preamble) must exceed the warmup "
            f"batch ({batch}) — nothing would be timed")
    eng = NativeOracleEngine(compat)
    eng.process_wire(msgs[:batch])  # warmup (allocator, caches)
    t0 = time.perf_counter()
    nlines = 0
    for lo in range(batch, len(msgs), batch):
        out = eng.process_wire(msgs[lo:lo + batch])
        nlines += sum(len(x) for x in out)
    dt = time.perf_counter() - t0
    n = len(msgs) - batch
    ops = n / dt
    return {
        "metric": "orders_per_sec_native_quirk_exact",
        "value": round(ops, 1),
        "unit": "orders/s",
        "vs_baseline": round(ops / REFERENCE_BASELINE_OPS, 3),
        "detail": {
            "events": n, "seconds": round(dt, 3), "batch": batch,
            "compat": compat, "out_lines": nlines,
            "engine": "native C++ (kme_tpu_torch/native/kme_oracle.cpp)",
            "baseline_assumption_ops": REFERENCE_BASELINE_OPS,
        },
    }


def bench_parity_engine(events: int = 4096, seed: int = 0, batch: int = 2048,
                        compat: str = "java", device: str = "cuda") -> dict:
    """Throughput of the serial device parity engine on the stock harness
    workload (the quirk-exact replica — correctness path, not the
    performance path; on the card each message's segments replay CUDA
    graphs, engine/parity.py)."""
    from kme_tpu_torch.engine.parity import ParityCaps, ParityEngine
    from kme_tpu_torch.workload import harness_stream

    caps = ParityCaps(balances=32, positions=8192, books=32, buckets=1024,
                      orders=16384, max_events=64, batch=batch)
    msgs = harness_stream(events, seed=seed)
    eng = ParityEngine(compat, caps, device=device)
    eng.process_batch(msgs[:batch])  # warmup: graph captures
    t0 = time.perf_counter()
    eng.process_batch(msgs[batch:])
    _sync(eng.device)
    dt = time.perf_counter() - t0
    n = len(msgs) - batch
    ops = n / dt
    return {
        "metric": "orders_per_sec_serial_parity",
        "value": round(ops, 1),
        "unit": "orders/s",
        "vs_baseline": round(ops / REFERENCE_BASELINE_OPS, 3),
        "detail": {
            "events": n, "seconds": round(dt, 3), "batch": batch,
            "compat": compat, "backend": eng.device.type,
            "baseline_assumption_ops": REFERENCE_BASELINE_OPS,
        },
    }


def bench_latency(events: int = 20_000, symbols: int = 1024,
                  accounts: int = 2048, seed: int = 0, zipf_a: float = 1.2,
                  slots: int = 128, max_fills: int = 16,
                  width: int = DEFAULT_WIDTH, shards: int = 1,
                  batch: int = DEFAULT_LATENCY_BATCH,
                  engine: str = "seq", device: str = "cuda") -> dict:
    """Streaming latency (BASELINE.md p99 column): the stream is served
    in micro-batches of `batch` messages through process_wire; a
    message's fill latency is bounded by its batch's wall time, so the
    per-batch wall distribution IS the latency envelope. engine='seq'
    (default) serves each micro-batch as ONE kernel dispatch + one
    fetch round; 'sweep' is the lanes path."""
    from kme_tpu_torch.workload import zipf_symbol_stream

    msgs = zipf_symbol_stream(events, num_symbols=symbols,
                              num_accounts=accounts, seed=seed,
                              zipf_a=zipf_a)

    if engine == "seq":
        from kme_tpu_torch.engine import seq as SQ
        from kme_tpu_torch.runtime.seqsession import SeqSession

        # the seq kernel's plane layout needs 128-multiples; the
        # EFFECTIVE envelope is reported in the detail dict (hbm_books
        # is passed as the JAX package sets it; the port ignores it)
        slots = -(-max(slots, 128) // 128) * 128
        accounts = -(-accounts // 128) * 128
        scfg = SQ.SeqConfig(
            lanes=symbols, slots=slots, accounts=accounts,
            max_fills=max_fills, hbm_books=slots > 512,
            batch=max(128, min(4096, 1 << (batch - 1).bit_length())))
        mk = lambda: SeqSession(scfg, device=device)
    else:
        from kme_tpu_torch.engine.lanes import LaneConfig
        from kme_tpu_torch.runtime.session import LaneSession

        cfg = LaneConfig(lanes=symbols, slots=slots, accounts=accounts,
                         max_fills=max_fills)
        mk = lambda: LaneSession(cfg, shards=shards, width=width,
                                 device=device)
    warm = mk()  # kernel builds, allocator, every shape bucket
    for lo in range(0, len(msgs), batch):
        warm.process_wire(msgs[lo:lo + batch])
    ses = mk()
    walls = []
    t_all = time.perf_counter()
    for lo in range(0, len(msgs), batch):
        t0 = time.perf_counter()
        ses.process_wire(msgs[lo:lo + batch])   # returns fetched lines
        walls.append(time.perf_counter() - t0)
    t_all = time.perf_counter() - t_all
    walls.sort()

    def pct(p):
        # nearest-rank percentile; with few batches high percentiles
        # degenerate to the worst batch — `batches` is reported so the
        # sample size is visible
        import math

        return walls[max(0, min(len(walls) - 1,
                                math.ceil(p * len(walls)) - 1))]

    return {
        "metric": "p99_batch_latency_ms",
        "value": round(pct(0.99) * 1e3, 2),
        "unit": "ms",
        "vs_baseline": round((len(msgs) / t_all) / REFERENCE_BASELINE_OPS, 3),
        "detail": {
            "events": len(msgs), "batch": batch, "engine": engine,
            "slots": slots,
            # topology flags only apply to the sweep engine; the seq
            # path is single-device with no compaction width
            "width": width if engine != "seq" else 0,
            "shards": shards if engine != "seq" else 1,
            "p50_ms": round(pct(0.50) * 1e3, 2),
            "p90_ms": round(pct(0.90) * 1e3, 2),
            "p99_ms": round(pct(0.99) * 1e3, 2),
            "max_ms": round(walls[-1] * 1e3, 2),
            "batches": len(walls),
            "streamed_orders_per_sec": round(len(msgs) / t_all, 1),
            "backend": ses.device.type,
        },
    }


def bench_shards(events: int = 4000, symbols: int = 8,
                 accounts: int = 32, seed: int = 0,
                 workload: str = "zipf-hot",
                 shards_list=(1, 2, 4), slots: int = 128,
                 max_fills: int = 16, slice_size: int = 500,
                 dispatch: str = "auto", device: str = "cuda") -> dict:
    """Elastic-sharding suite (`--suite shards`): the skewed workload
    through SeqMeshSession at every shard count, with byte parity
    asserted against the scalar fixed-mode oracle and MIGRATIONS
    REQUIRED at shards > 1 (the stream is fed in slices, because
    rebalancing happens between process_wire calls only — a single
    giant batch would never migrate). At the top shard count a
    rebalance=False control run records the static-hash placement's
    imbalance, so the report carries both `shard_imbalance` (elastic,
    perfgate-gated, down-is-better) and `shard_imbalance_static` (the
    adversary's score the elastic planner must beat).

    Per-shard async dispatch grows the suite three ways, all at
    the top shard count: a `--dispatch lockstep` control run re-asserts
    byte parity for the legacy mesh scan (the async-vs-lockstep parity
    leg CI runs), the report carries `chip_stall_frac` /
    `chip_stall_frac_lockstep` from the deterministic dispatch
    simulation (replay-stable — chip_stall_frac is perfgate-GATED
    down, and on zipf-hot async must strictly beat lockstep), and a
    wall_feed=True advisory run exercises the wall-fed rebalancer EWMA
    (parity asserted; its imbalance is reported but never gated — the
    fed walls are real clocks, so its placement drifts run to run).

    The port's shards share the session's one device (on the card each
    shard is a state and a CUDA stream, parallel/seqmesh.py), so the
    suite needs no device per shard: its check is SeqMeshSession's own,
    every shard count dividing the symbol lanes."""
    from kme_tpu_torch.engine import seq as SQ
    from kme_tpu_torch.oracle import OracleEngine
    from kme_tpu_torch.parallel.seqmesh import SeqMeshSession
    from kme_tpu_torch.workload import (payout_storm_stream, zipf_hot_stream,
                                  zipf_symbol_stream)

    need = max(shards_list)
    bad = [s for s in shards_list if s < 1 or symbols % s]
    if bad:
        raise RuntimeError(
            f"--suite shards: shard counts {bad} do not divide the "
            f"{symbols} symbol lanes (each shard holds lanes/shards of "
            f"them on the session's device)")
    if workload == "zipf-hot":
        msgs = zipf_hot_stream(events, num_symbols=symbols,
                               num_accounts=accounts, seed=seed)
    elif workload == "payout-storm":
        msgs = payout_storm_stream(events, num_symbols=symbols,
                                   num_accounts=accounts, seed=seed)
    else:
        msgs = zipf_symbol_stream(events, num_symbols=symbols,
                                  num_accounts=accounts, seed=seed)
    oracle = OracleEngine("fixed", book_slots=slots,
                          max_fills=max_fills)
    want = [r.wire() for m in msgs for r in oracle.process(m.copy())]
    cfg = SQ.SeqConfig(lanes=symbols, slots=slots,
                       accounts=-(-max(accounts, 128) // 128) * 128,
                       max_fills=max_fills, pos_cap=1 << 10,
                       probe_max=8)

    def run(shards, rebalance, mode=dispatch, wall_feed=False):
        ses = SeqMeshSession(cfg, shards, rebalance=rebalance,
                             dispatch=mode, wall_feed=wall_feed,
                             device=device)
        got = []
        t0 = time.perf_counter()
        for lo in range(0, len(msgs), slice_size):
            for per in ses.process_wire(msgs[lo:lo + slice_size]):
                got.extend(per)
        wall = time.perf_counter() - t0
        if got != want:
            raise AssertionError(
                f"shards={shards} rebalance={rebalance} "
                f"dispatch={ses.dispatch}: MatchOut diverged from the "
                f"single-chip oracle "
                f"({sum(a != b for a, b in zip(got, want))} lines + "
                f"{abs(len(got) - len(want))} length delta)")
        return ses, wall

    per_shards = []
    elastic_top = None
    top_ses = None
    for shards in shards_list:
        ses, wall = run(shards, rebalance=True)
        stats = ses.shard_stats()
        if shards > 1 and stats["migrations"] <= 0:
            raise AssertionError(
                f"shards={shards}: no migrations observed on the "
                f"skewed workload — the elastic planner never fired")
        # key is NOT "orders_per_sec" on purpose: the gate regex-scrapes
        # artifact text for GATED_METRICS names, and CI wall-clock
        # throughput would flap the shards gate — only the
        # deterministic shard_imbalance is meant to enforce here
        rec = {"shards": shards, "wall_s": round(wall, 3),
               "msgs_per_sec": round(len(msgs) / wall, 1),
               "parity": "byte-exact", "dispatch": ses.dispatch,
               **stats}
        if ses.dispatch == "async":
            # per-shard-count copies use NON-gated names on purpose:
            # per_shards serializes before the top-level detail keys
            # and the gate regex takes the FIRST occurrence of each
            # GATED_METRICS name in the artifact text
            rec.update({f"run_{k}": v
                        for k, v in ses.stall_stats().items()})
        per_shards.append(rec)
        if shards == need:
            elastic_top = rec
            top_ses = ses
    _static_ses, static_wall = run(need, rebalance=False)
    static = _static_ses.shard_stats()
    detail = {
        "suite": "shards", "workload": workload, "events": len(msgs),
        "slice_size": slice_size, "shard_counts": list(shards_list),
        "dispatch": elastic_top["dispatch"],
        "per_shards": per_shards,
        "shard_imbalance": elastic_top["imbalance"],
        "shard_imbalance_static": static["imbalance"],
        "static_wall_s": round(static_wall, 3),
        "migrations": elastic_top["migrations"],
        "rebalances": elastic_top["rebalances"],
        "backend": top_ses.device.type,
        "note": "byte parity asserted vs the scalar oracle at every "
                "shard count; migrations required at shards > 1",
    }
    if top_ses is not None and top_ses.dispatch == "async":
        stall = top_ses.stall_stats()
        # the stall fractions come from the deterministic dispatch
        # simulation (weighted message costs, both schedules replayed
        # on the same placements) — replay-stable, so chip_stall_frac
        # is safe to gate and safe to hard-assert against its own
        # lockstep twin on the skewed workload
        detail.update(stall)
        if (workload == "zipf-hot" and need > 1
                and stall["chip_stall_frac"]
                >= stall["chip_stall_frac_lockstep"]):
            raise AssertionError(
                f"async dispatch did not reduce chip stall on "
                f"zipf-hot at shards={need}: async "
                f"{stall['chip_stall_frac']} >= lockstep "
                f"{stall['chip_stall_frac_lockstep']}")
        # async-vs-lockstep parity leg: the legacy mesh scan must still
        # produce the same bytes (run() asserts vs the oracle, which
        # both modes must match — transitively async == lockstep)
        _lock_ses, lock_wall = run(need, rebalance=True,
                                   mode="lockstep")
        detail["lockstep_wall_s"] = round(lock_wall, 3)
        # wall_feed advisory leg: real per-shard walls folded into the
        # rebalancer EWMA; parity holds (placement-independent), but
        # the resulting imbalance rides wall clocks so it is reported,
        # never gated
        _wf_ses, wf_wall = run(need, rebalance=True, wall_feed=True)
        detail["wall_feed_wall_s"] = round(wf_wall, 3)
        detail["wall_feed_imbalance"] = _wf_ses.shard_stats()[
            "imbalance"]
    if detail["shard_imbalance"] >= detail["shard_imbalance_static"]:
        detail["imbalance_warning"] = (
            f"elastic imbalance {detail['shard_imbalance']} did not "
            f"beat static {detail['shard_imbalance_static']}")
        print(f"kme-torch-bench: WARNING {detail['imbalance_warning']}",
              file=sys.stderr)
    return {
        "metric": "shard_imbalance",
        "value": elastic_top["imbalance"],
        "unit": "max/mean",
        "vs_baseline": round(
            elastic_top["msgs_per_sec"] / REFERENCE_BASELINE_OPS, 3),
        "detail": detail,
    }


def bench_groups(events: int = 20_000, symbols: int = 1024,
                 accounts: int = 256, seed: int = 0,
                 workload: str = "zipf", cross_frac: float = 0.5,
                 group_counts=(1, 2, 4), slots: int = 128,
                 max_fills: int = 16, prefund: int = 8,
                 reps: int = 3) -> dict:
    """Multi-leader scale-out suite (`--suite groups`): the
    stream is split by the front door (bridge/front.py — rendezvous
    symbol routing + chunked reserve→settle transfer injection) and
    each group's substream runs through its own fresh engine. In the
    deployed topology the N groups are N separate leader HOSTS, so the
    deployment's throughput is bounded by its critical path — the
    slowest group. The bench models exactly that: per-group walls are
    measured SERIALLY (best of `reps`, after a process-level warmup
    run) and accepted-orders/s = accepted / max(per-group wall). A CI
    box with one core measures the same thing a multi-host deployment
    would, without pretending threads on one core are machines. At
    every group count the merged MatchOut is byte-compared against the
    single-leader oracle partitioned by the same router
    (front.verify_groups: THE COMPAT.md global-order convention).

    Deterministic seed-derived metrics (transfer fraction, shortfalls,
    parity) are the gated surface — wall-clock accepted-orders/s is
    reported per count (the ≥ 2x acceptance check at the top group
    count) but deliberately NOT under a GATED_METRICS name, same
    policy as bench_shards."""
    from kme_tpu_torch.bridge import front
    from kme_tpu_torch.native.oracle import NativeOracleEngine, \
        native_available
    from kme_tpu_torch.oracle import OracleEngine
    from kme_tpu_torch.wire import dumps_order, parse_order
    from kme_tpu_torch.workload import cross_account_stream, \
        zipf_symbol_stream

    top = max(group_counts)
    if workload == "cross-account":
        msgs = cross_account_stream(events, symbols, accounts, top,
                                    seed=seed, cross_frac=cross_frac)
    else:
        msgs = zipf_symbol_stream(events, num_symbols=symbols,
                                  num_accounts=accounts, seed=seed)
    lines = [dumps_order(m) for m in msgs]
    native = native_available()

    def make_engine():
        if native:
            return NativeOracleEngine("fixed", book_slots=slots,
                                      max_fills=max_fills)
        return OracleEngine("fixed", book_slots=slots,
                            max_fills=max_fills)

    def run_engine(eng, parsed):
        if native:
            out = eng.process_wire(parsed)
            return [ln for per_msg in out for ln in per_msg]
        return [r.wire() for m in parsed for r in eng.process(m)]

    # one throwaway run pays the process-level first-call costs
    # (library load, allocator growth) so no group count eats them
    run_engine(make_engine(),
               [parse_order(ln) for ln in lines[:2000]])

    per_counts = []
    base_ops = None
    accepted = None
    for n in group_counts:
        per_group, router = front.split_lines(lines, n,
                                              prefund=prefund)
        # parse is front-door work, identical at every group count —
        # kept outside the timed engine region
        parsed = [[parse_order(ln) for ln in sub] for sub in per_group]
        outs = [None] * n
        walls = []
        for k in range(n):
            best = None
            for _ in range(max(1, reps)):
                eng = make_engine()
                t0 = time.perf_counter()
                out = run_engine(eng, parsed[k])
                w = time.perf_counter() - t0
                best = w if best is None else min(best, w)
                outs[k] = out
            walls.append(best)
        wall = max(walls)
        rep = front.verify_groups(lines, outs, compat="fixed",
                                  book_slots=slots,
                                  max_fills=max_fills,
                                  prefund=prefund)
        if not rep["ok"]:
            raise AssertionError(
                f"groups={n}: merged MatchOut diverged from the "
                f"single-leader oracle: {rep['mismatches'][:1]}")
        if accepted is None:
            # accepted orders are identical at every group count (the
            # parity assertion above pins that) — count once
            accepted = sum(
                1 for g in outs for ln in g
                if ln.startswith("OUT ")
                and not front.is_internal_line(ln)
                and any(f'"action":{a},' in ln for a in (2, 3, 5, 6)))
        ops = accepted / wall
        if base_ops is None:
            base_ops = ops
        per_counts.append({
            "groups": n,
            "group_walls_s": [round(w, 4) for w in walls],
            "wall_s": round(wall, 4),
            "accepted_per_sec": round(ops, 1),
            "speedup": round(ops / base_ops, 2),
            "substream_lines": [len(s) for s in per_group],
            "transfers": router.counters["cross_shard_transfers_total"],
            "shortfalls": router.counters["transfer_shortfall_total"],
            "parity": "byte-exact"})
    topc = per_counts[-1]
    orders = sum(1 for m in msgs if m.action in (2, 3))
    frac = round(topc["transfers"] / max(1, orders), 4)
    detail = {
        "suite": "groups", "workload": workload, "events": len(msgs),
        "orders": orders, "group_counts": list(group_counts),
        "prefund": prefund, "engine": "native" if native else "oracle",
        "per_groups": per_counts,
        "cross_shard_transfer_frac": frac,
        "transfer_shortfalls": topc["shortfalls"],
        "accepted_orders": accepted,
        "speedup_top": topc["speedup"],
        "note": "byte parity vs the partitioned single-leader oracle "
                "asserted at every group count; accepted-orders/s is "
                "wall-clock (ungated), transfer metrics deterministic "
                "(gated)",
        # engine identity doubles as the perfgate backend marker: a
        # python-oracle run is not comparable to a native baseline, so
        # a mismatch demotes the gate to advisory (same rule as
        # card-vs-CPU elsewhere)
        "backend": "native" if native else "oracle",
    }
    if topc["speedup"] < 2.0 and native:
        detail["speedup_warning"] = (
            f"groups={topc['groups']} accepted-orders/s only "
            f"{topc['speedup']}x the single-leader run")
        print(f"kme-torch-bench: WARNING {detail['speedup_warning']}",
              file=sys.stderr)
    return {
        "metric": "cross_shard_transfer_frac",
        "value": frac,
        "unit": "transfers/order",
        "vs_baseline": round(
            topc["accepted_per_sec"] / REFERENCE_BASELINE_OPS, 3),
        "detail": detail,
    }


def bench_multihost(events: int = 6000, symbols: int = 512,
                    accounts: int = 128, seed: int = 0,
                    groups: int = 2, groups_to: int = 4,
                    cross_frac: float = 0.5, slots: int = 128,
                    max_fills: int = 16, prefund: int = 8) -> dict:
    """Multi-host transport suite (`--suite multihost`, ROADMAP item
    2a): the same split workload is run twice —

    - IN-PROCESS: per-group fresh oracle engines over the front split,
      serially timed (the bench_groups model: deployment throughput is
      the slowest group);
    - CROSS-HOST: one real `kme-torch-serve --engine oracle` subprocess
      (`python -m kme_tpu_torch.cli serve`; a host engine, no card) per
      group on its own
      TCP port, fed over `front.FrontLinks` (the stamped multi-host
      produce path with reconnect-with-resume off the out_seq cursor),
      timed from first produce to every group's heartbeat reporting
      its substream drained, then byte-verified from the durable logs
      against the partitioned single-leader oracle.

    The throughput pair (and their ratio — what the wire, framing and
    checkpoint machinery cost over raw engines) is reported but NOT
    gated: it is wall-clock. The gated surface is deterministic:
    `moved_key_frac`, the fraction of the symbol+account key universe
    the N→M reshard plan moves (bridge/reshard.plan_reshard). Rendez-
    vous assignment keeps it at the minimal (m-n)/m; a consistent-
    hashing regression (salt drift, modulo hashing) jumps it toward
    1.0 and fails the gate long before a live reshard would hurt."""
    import json as _json
    import os
    import shutil
    import socket
    import subprocess
    import tempfile

    from kme_tpu_torch.bridge import front
    from kme_tpu_torch.bridge.provision import group_topics
    from kme_tpu_torch.bridge.reshard import plan_reshard
    from kme_tpu_torch.oracle import OracleEngine
    from kme_tpu_torch.wire import dumps_order, parse_order
    from kme_tpu_torch.workload import cross_account_stream

    msgs = cross_account_stream(events, symbols, accounts, groups,
                                seed=seed, cross_frac=cross_frac)
    lines = [dumps_order(m) for m in msgs]
    per_group, router = front.split_lines(lines, groups,
                                          prefund=prefund)
    sizes = [len(s) for s in per_group]

    # -- leg 1: in-process per-group engines (the raw-engine bound) ---
    outs = []
    walls = []
    for k in range(groups):
        parsed = [parse_order(ln) for ln in per_group[k]]
        eng = OracleEngine("fixed", book_slots=slots,
                           max_fills=max_fills)
        t0 = time.perf_counter()
        out = [r.wire() for m in parsed for r in eng.process(m)]
        walls.append(time.perf_counter() - t0)
        outs.append(out)
    rep = front.verify_groups(lines, outs, compat="fixed",
                              book_slots=slots, max_fills=max_fills,
                              prefund=prefund)
    if not rep["ok"]:
        raise AssertionError(f"in-process groups diverged from the "
                             f"single-leader oracle: "
                             f"{rep['mismatches'][:1]}")
    accepted = sum(
        1 for g in outs for ln in g
        if ln.startswith("OUT ") and not front.is_internal_line(ln)
        and any(f'"action":{a},' in ln for a in (2, 3, 5, 6)))
    inproc_ops = accepted / max(walls)

    # -- leg 2: per-group kme-torch-serve processes over real TCP -----------
    def _free_port() -> int:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    work = tempfile.mkdtemp(prefix="kme-torch-bench-multihost-")
    ports = [_free_port() for _ in range(groups)]
    env = dict(os.environ)
    env.pop("KME_FAULTS", None)
    srvs = []
    try:
        for k in range(groups):
            gdir = os.path.join(work, f"group{k}")
            os.makedirs(gdir, exist_ok=True)
            srvs.append(subprocess.Popen(
                [sys.executable, "-m", "kme_tpu_torch.cli", "serve",
                 "--engine", "oracle", "--compat", "fixed",
                 "--batch", "64", "--slots", str(slots),
                 "--max-fills", str(max_fills),
                 "--group", f"{k}/{groups}",
                 "--checkpoint-dir", gdir,
                 "--checkpoint-every", "600",
                 "--auto-provision",
                 "--listen", f"127.0.0.1:{ports[k]}",
                 "--idle-exit", str(MULTIHOST_IDLE_EXIT_S),
                 "--health-file", os.path.join(gdir, "serve.health"),
                 "--health-every", "0.1"],
                env=env))
        links = front.FrontLinks(
            [f"127.0.0.1:{p}" for p in ports], retries=200,
            backoff_s=0.1)
        t0 = time.perf_counter()
        for k in range(groups):
            for ln in per_group[k]:
                links.send(k, ln)
        # drained = every group's heartbeat reports its full substream
        # consumed (outputs are produced before the offset advances)
        deadline = time.time() + 300.0
        drained = [False] * groups
        while time.time() < deadline and not all(drained):
            for k in range(groups):
                if drained[k]:
                    continue
                try:
                    with open(os.path.join(work, f"group{k}",
                                           "serve.health")) as f:
                        hb = _json.load(f)
                    drained[k] = int(hb.get("offset", 0)) >= sizes[k]
                except (OSError, ValueError):
                    pass
            if not all(drained):
                time.sleep(0.05)
        tcp_wall = time.perf_counter() - t0
        if not all(drained):
            raise AssertionError(
                f"cross-host groups never drained: {drained}")
        link_state = links.snapshot()
        links.close()
        for s in srvs:     # idle-exit lapses, clean shutdown
            if s.wait(timeout=60) != 0:
                raise AssertionError(
                    f"kme-torch-serve exited rc={s.returncode}")
        srvs = []
        # byte parity from the durable logs (crossing the wire must
        # change nothing)
        from kme_tpu_torch.bridge.broker import BrokerError, InProcessBroker
        actual = []
        for k in range(groups):
            b = InProcessBroker(persist_dir=os.path.join(
                work, f"group{k}", "broker-log"))
            merged = []
            for topic in (group_topics(k)[1], group_topics(k)[2]):
                off = 0
                try:
                    while True:
                        recs = b.fetch(topic, off, 4096, timeout=0.0)
                        if not recs:
                            break
                        merged.extend(recs)
                        off += len(recs)
                except BrokerError:
                    pass
            merged.sort(key=lambda r: (r.out_seq
                                       if r.out_seq is not None
                                       else -1))
            actual.append([f"{r.key} {r.value}" for r in merged])
        trep = front.verify_groups(lines, actual, compat="fixed",
                                   book_slots=slots,
                                   max_fills=max_fills,
                                   prefund=prefund)
        if not trep["ok"]:
            raise AssertionError(
                f"cross-host run diverged from the single-leader "
                f"oracle: {trep['mismatches'][:1]}")
    finally:
        for s in srvs:
            s.kill()
            s.wait()
        shutil.rmtree(work, ignore_errors=True)
    tcp_ops = accepted / tcp_wall

    # -- the gated deterministic surface: the reshard move plan -------
    plan = plan_reshard(groups, groups_to, range(symbols),
                        range(accounts))
    detail = {
        "suite": "multihost", "events": len(msgs),
        "groups": groups, "groups_to": groups_to,
        "symbols": symbols, "accounts": accounts,
        "prefund": prefund, "seed": seed,
        "substream_lines": sizes,
        "accepted_orders": accepted,
        "inproc_accepted_per_sec": round(inproc_ops, 1),
        "tcp_accepted_per_sec": round(tcp_ops, 1),
        "tcp_over_inproc": round(tcp_ops / inproc_ops, 4),
        "tcp_wall_s": round(tcp_wall, 3),
        "front_links": link_state,
        "moved_key_frac": round(plan["moved_key_frac"], 6),
        "rendezvous_minimal_frac": plan["rendezvous_minimal_frac"],
        "moved_symbols": len(plan["moved_symbols"]),
        "moved_accounts": len(plan["moved_accounts"]),
        "parity": "byte-exact",
        "note": "throughput pair is wall-clock (ungated); "
                "moved_key_frac is the deterministic gated surface — "
                "rendezvous keeps it minimal, hashing regressions "
                "push it toward 1.0",
        "backend": "oracle",
    }
    return {
        "metric": "moved_key_frac",
        "value": detail["moved_key_frac"],
        "unit": f"keys moved, {groups}->{groups_to}",
        "vs_baseline": round(tcp_ops / REFERENCE_BASELINE_OPS, 3),
        "detail": detail,
    }


def bench_storms(events: int = 4000, seed: int = 0,
                 high_lag: int = 32,
                 drain_per_msg: float = 2.0) -> dict:
    """Adversarial-storm shed-policy suite (`--suite storms`): run every
    STORM_PROFILES stream through the broker's deterministic overload
    replay (bridge/broker.simulate_overload — no wall clock, no RNG, no
    threads) and report each profile's shed fraction as a gated metric
    `shed_frac_<profile>` (perfgate, down-is-better, CPU-deterministic
    like shard_imbalance). A drift in admission policy, priority
    classing or the profile generators moves these numbers; nothing
    else can.

    Each profile's admitted stream is also replayed through the Python
    oracle — shedding must be a pure input filter, so the surviving
    sequence has to be processable without crash for every profile (the
    byte-parity end-to-end proof lives in the kme-torch-chaos storm
    scenarios; this is the fast in-process survival check), and the
    whole simulation is run twice to assert determinism.
    """
    from kme_tpu_torch.bridge.broker import OverloadController, simulate_overload
    from kme_tpu_torch.oracle import OracleEngine
    from kme_tpu_torch.wire import dumps_order, parse_order
    from kme_tpu_torch.workload import (STORM_PROFILES, storm_stream,
                                  storm_windows)

    # reduced-but-sheds scale: small enough for CI seconds, large
    # enough that EVERY profile's burst overwhelms the modeled drain
    # (perfgate skips zero baselines, so shed_frac must be > 0)
    scale = {"payout-storm-wide": (64, 32),
             "flash-crowd": (32, 32),
             "cancel-storm": (16, 32),
             "hot-book": (8, 32),
             "liquidation-cascade": (32, 32)}
    t0 = time.perf_counter()
    per_profile: dict = {}
    metrics: dict = {}
    for name in STORM_PROFILES:
        symbols, accounts = scale[name]
        msgs = storm_stream(name, events, num_symbols=symbols,
                            num_accounts=accounts, seed=seed)
        lines = [dumps_order(m) for m in msgs]
        windows = storm_windows(name, events, num_symbols=symbols,
                                num_accounts=accounts)
        runs = []
        for _rep in range(2):       # determinism: identical twice
            ctl = OverloadController(high_lag=high_lag)
            runs.append(simulate_overload(lines, windows, ctl,
                                          drain_per_msg=drain_per_msg))
        sim, sim2 = runs
        assert sim["admitted_idx"] == sim2["admitted_idx"] \
            and sim["shed_frac"] == sim2["shed_frac"], (
                f"simulate_overload is nondeterministic for {name}")
        if sim["shed"] == 0:
            raise AssertionError(
                f"storm profile {name} shed nothing at the suite "
                f"scale — the gate would silently skip it")
        # oracle survival of the admitted stream (pure input filter)
        eng = OracleEngine("fixed")
        out_lines = 0
        for i in sim["admitted_idx"]:
            out_lines += len(eng.process(parse_order(lines[i])))
        mname = "shed_frac_" + name.replace("-", "_")
        metrics[mname] = sim["shed_frac"]
        per_profile[name] = {
            "records": sim["total"],
            "admitted": sim["admitted"],
            "shed": sim["shed"],
            "shed_frac": sim["shed_frac"],
            "max_backlog": sim["max_backlog"],
            "windows": [list(w) for w in windows],
            "symbols": symbols, "accounts": accounts,
            "oracle_out_lines": out_lines,
            "controller": sim["controller"],
        }
    elapsed = time.perf_counter() - t0
    worst = max(metrics.values())
    detail = {
        "suite": "storms", "events": events, "seed": seed,
        "high_lag": high_lag, "drain_per_msg": drain_per_msg,
        "elapsed_s": round(elapsed, 3),
        "profiles": per_profile,
        **{k: round(v, 4) for k, v in metrics.items()},
    }
    print(f"kme-torch-bench storms: "
          + " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()))
          + f" ({elapsed:.1f}s)", file=sys.stderr)
    return {
        "metric": "storm_shed_frac_max",
        "value": round(worst, 4),
        "unit": "shed fraction",
        "vs_baseline": 0.0,
        "detail": detail,
    }


def bench_wire(events: int = 20_000, seed: int = 0,
               batch: int = 512, repeats: int = 3) -> dict:
    """Binary-wire ingress suite (`--suite wire`): the SAME seeded
    harness stream is driven into a real loopback kme TCP broker twice
    at matched batching — once as JSON `produce_batch` rows (the
    older bulk path), once as 72-byte binary frames through
    `produce_frames` — and the suite reports both ingress rates.
    `ingress_msgs_per_sec` (binary, up-is-better) and `wire_parse_s`
    (cumulative frame-decode wall for the timed binary run,
    down-is-better) are perfgate-gated vs BASELINE_wire.json on CPU.

    Parity is structural, not statistical: both modes must leave the
    broker with BYTE-IDENTICAL stored values (the binary path decodes
    to the canonical order_json before anything durable sees it), and
    the stored stream replays through the Python oracle to identical
    MatchOut lines — so the speedup can never come from changing what
    gets admitted. The binary/JSON ratio is also asserted >=
    WIRE_SPEEDUP_FLOOR (1.5) on the CPU backend, which this host-only
    suite always names.

    A third timed pass drives the SAME frames with per-order client
    trace ids attached (80-byte FLAG_TID frames, dtrace
    client_trace_id): `trace_overhead_frac` is the ingress-rate cost
    of tracing, reported as an ADVISORY in the tail (soft 5% budget —
    printed, never gated) with the sample trace ids a kme-torch-loadgen run
    over the same stream would report."""
    import tempfile

    from kme_tpu_torch.bridge import tcp as tcpmod
    from kme_tpu_torch.bridge.broker import InProcessBroker
    from kme_tpu_torch.oracle import OracleEngine
    from kme_tpu_torch.telemetry.dtrace import (client_trace_id,
                                          client_trace_ids)
    from kme_tpu_torch.wire import dumps_order, encode_frames, parse_order
    from kme_tpu_torch.workload import harness_stream

    msgs = harness_stream(events, seed=seed, num_accounts=64,
                          num_symbols=16, validate=True)
    n = len(msgs)
    lines = [dumps_order(m) for m in msgs]
    chunks = [(lo, msgs[lo:lo + batch]) for lo in range(0, n, batch)]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        broker = InProcessBroker(persist_dir=td)
        srv, _ = tcpmod.serve_broker(port=0, broker=broker)
        host, port = srv.server_address
        cli = tcpmod.TcpBroker(host, port)
        runs = {"json": [], "binary": [], "traced": []}
        parse_s = None
        stored = {}
        try:
            for rep in range(repeats):
                for mode in ("json", "binary", "traced"):
                    topic = f"wire_{mode}_r{rep}"
                    cli.create_topic(topic)
                    pns0 = broker.wire_parse_ns
                    t1 = time.perf_counter()
                    if mode == "json":
                        for _, ch in chunks:
                            cli.produce_batch(
                                topic,
                                [(None, dumps_order(m)) for m in ch])
                    elif mode == "binary":
                        for _, ch in chunks:
                            cli.produce_frames(topic, None,
                                               encode_frames(ch))
                    else:
                        # the traced pass pays the FULL client cost:
                        # minting the ids (vectorized, like loadgen)
                        # and the wider 80-byte frames
                        for lo, ch in chunks:
                            tids = client_trace_ids(
                                lo, [m.aid for m in ch],
                                [m.oid for m in ch])
                            cli.produce_frames(
                                topic, None,
                                encode_frames(ch, tids=tids))
                    dt = time.perf_counter() - t1
                    assert broker.end_offset(topic) == n, (
                        f"{mode} ingress lost records: "
                        f"{broker.end_offset(topic)} != {n}")
                    runs[mode].append(dt)
                    if mode == "binary" and (parse_s is None
                                             or dt <= min(runs["binary"])):
                        parse_s = (broker.wire_parse_ns - pns0) / 1e9
                    if rep == 0:
                        vals = []
                        off = 0
                        while off < n:
                            recs = broker.fetch(topic, off, 4096)
                            vals.extend(r.value for r in recs)
                            off = recs[-1].offset + 1
                        stored[mode] = vals
        finally:
            cli.close()
            srv.shutdown()
    # byte parity: the encoding must be invisible past admission —
    # including the trace words (tid is transport metadata, never part
    # of the stored value)
    assert stored["json"] == stored["binary"], (
        "binary ingress altered the stored record bytes")
    assert stored["json"] == stored["traced"], (
        "trace-id carriage altered the stored record bytes")
    oracle_out = {}
    for mode, vals in stored.items():
        eng = OracleEngine("fixed")
        out = []
        for v in vals:
            out.extend(eng.process(parse_order(v)))
        oracle_out[mode] = out
    assert oracle_out["json"] == oracle_out["binary"], (
        "oracle replay diverged between ingress encodings")
    json_s = min(runs["json"])
    bin_s = min(runs["binary"])
    traced_s = min(runs["traced"])
    json_mps = n / json_s
    bin_mps = n / bin_s
    traced_mps = n / traced_s
    speedup = bin_mps / json_mps
    overhead = max(0.0, 1.0 - traced_mps / bin_mps)
    # the broker, the codecs and the oracle all run on the host
    backend = "cpu"
    if backend == "cpu" and speedup < WIRE_SPEEDUP_FLOOR:
        raise AssertionError(
            f"binary ingress speedup {speedup:.2f}x < "
            f"{WIRE_SPEEDUP_FLOOR}x floor "
            f"(json {json_mps:,.0f} msg/s, binary {bin_mps:,.0f} msg/s)")
    elapsed = time.perf_counter() - t0
    detail = {
        "suite": "wire", "events": events, "records": n,
        "seed": seed, "batch": batch, "repeats": repeats,
        "backend": backend,
        "elapsed_s": round(elapsed, 3),
        "json_s": round(json_s, 4), "binary_s": round(bin_s, 4),
        "json_msgs_per_sec": round(json_mps, 1),
        "speedup_binary": round(speedup, 3),
        "oracle_out_lines": len(oracle_out["binary"]),
        # gated metrics (perfgate reads the detail root)
        "ingress_msgs_per_sec": round(bin_mps, 1),
        "wire_parse_s": round(parse_s, 6),
        # advisory, never gated: the cost of carrying client trace ids
        # (80-byte FLAG_TID frames) on the binary ingress path, plus
        # the ids the tail quotes — the SAME deterministic
        # client_trace_id values a kme-torch-loadgen run over this stream
        # reports in its slow_samples section
        "traced_msgs_per_sec": round(traced_mps, 1),
        "trace_overhead_frac": round(overhead, 4),
        "trace_sample_ids": [
            f"0x{client_trace_id(j, msgs[j].aid, msgs[j].oid):016x}"
            for j in range(min(4, n))],
    }
    over_tag = (" ** over 5% advisory budget **"
                if overhead > 0.05 else "")
    print(f"kme-torch-bench wire: json={json_mps:,.0f} msg/s "
          f"binary={bin_mps:,.0f} msg/s ({speedup:.2f}x) "
          f"traced={traced_mps:,.0f} msg/s "
          f"(overhead {overhead:.1%}{over_tag}) "
          f"parse={parse_s:.4f}s ({elapsed:.1f}s)", file=sys.stderr)
    print(f"kme-torch-bench wire: sample trace ids "
          f"{' '.join(detail['trace_sample_ids'])}", file=sys.stderr)
    return {
        "metric": "ingress_msgs_per_sec",
        "value": round(bin_mps, 1),
        "unit": "msgs/sec",
        "vs_baseline": round(bin_mps / REFERENCE_BASELINE_OPS, 3),
        "detail": detail,
    }


def bench_feed(events: int = 20_000, seed: int = 0,
               subs: int = 10_000, symbols: int = 1_000,
               profile: str = "flash-crowd",
               queue_bytes: int = 64 * 1024,
               depth_every: int = 256, depth_levels: int = 8) -> dict:
    """Market-data fan-out suite (`--suite feed`): a storm write
    profile replays through the Python oracle into an in-process
    broker, one FeedServer derives sequenced book frames from the
    MatchOut stream, and `subs` TCP subscribers (each pinned to one
    symbol, plus two wildcard auditors that take the whole feed)
    reconstruct their books from the wire bytes.

    Correctness is structural, not statistical:

      * the deriver is run TWICE from scratch over the same stream and
        must emit byte-identical concatenated frames (determinism —
        the failover guarantee);
      * every subscriber's reconstructed book must be byte-exact
        (`canonical_books`) against the oracle's resting-order store
        restricted to its subscription — including subscribers that
        went through conflation/resync cycles;
      * the wildcard auditors are additionally checked level-by-level
        at every depth (top-1, top-`depth_levels`, full) and on their
        top-of-book view;
      * per-symbol sequence accounting must show zero gaps and zero
        duplicates on every subscriber.

    `feed_msgs_per_sec` (frames delivered to subscriber sockets per
    second of fan-out wall, up-is-better) and `feed_lag_p99_ms`
    (admission-stamp -> frame-derivation p99, down-is-better) are
    perfgate-gated vs BASELINE_feed.json on CPU."""
    import resource
    import selectors
    import socket
    import tempfile

    from kme_tpu_torch import opcodes as op
    from kme_tpu_torch.bridge.broker import InProcessBroker
    from kme_tpu_torch.feed.client import subscribe_line
    from kme_tpu_torch.feed.derive import (BookBuilder, BookState, FeedDeriver,
                                     books_from_oracle, canonical_books)
    from kme_tpu_torch.feed.server import FeedServer
    from kme_tpu_torch.oracle import OracleEngine
    from kme_tpu_torch.telemetry import Registry
    from kme_tpu_torch.workload import storm_stream

    # fd headroom: every subscriber is TWO sockets (client + accepted
    # server end). Never silently shrink the fleet — print what was
    # dropped when the rlimit wins.
    try:
        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        want = 2 * subs + 512
        if soft < want:
            lift = want if hard == resource.RLIM_INFINITY \
                else min(want, hard)
            resource.setrlimit(resource.RLIMIT_NOFILE, (lift, hard))
            soft = lift
        cap = max(16, (soft - 256) // 2)
        if subs > cap:
            print(f"kme-torch-bench feed: RLIMIT_NOFILE={soft} caps "
                  f"subscribers at {cap} (asked {subs})",
                  file=sys.stderr)
            subs = cap
    except (ValueError, OSError):
        pass

    msgs = storm_stream(profile, events, num_symbols=symbols, seed=seed)
    eng = OracleEngine("fixed")
    lines = []
    for m in msgs:
        lines.extend(r.wire() for r in eng.process(m))
    oracle_levels = books_from_oracle(eng)
    oracle_state = BookState()
    oracle_state.levels = oracle_levels
    all_sids = sorted({m.sid for m in msgs
                       if m.action == op.ADD_SYMBOL}) or [1]

    # determinism: two fresh derivers over the same stream must emit
    # byte-identical frames — this IS the failover guarantee
    streams = []
    for _ in range(2):
        d = FeedDeriver(depth_every=depth_every,
                        depth_levels=depth_levels)
        streams.append(b"".join(
            f.raw for i, ln in enumerate(lines)
            for f in d.on_line(ln, 1, i)))
    assert streams[0] == streams[1], (
        "feed derivation is nondeterministic: two derivers over the "
        "same MatchOut stream emitted different bytes")
    ref_deriver = d

    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        broker = InProcessBroker(persist_dir=td)
        topic = "MatchOut"
        broker.create_topic(topic)
        registry = Registry()
        srv = FeedServer(broker, port=0, topic=topic,
                         depth_every=depth_every,
                         depth_levels=depth_levels,
                         queue_bytes=queue_bytes, registry=registry)
        host, port = srv.address

        # subscriber fleet: mostly 1-symbol subs spread round-robin,
        # plus two wildcard auditors holding the full feed
        plan = [None, None] + [
            {all_sids[i % len(all_sids)]} for i in range(max(0, subs - 2))]
        plan = plan[:max(2, subs)]
        csel = selectors.DefaultSelector()
        clients = []

        class _C:
            __slots__ = ("sock", "symbols", "out", "buf", "live", "eof")

            def __init__(self, symbols) -> None:
                self.symbols = symbols
                self.out = subscribe_line(symbols)
                self.buf = []
                self.live = False
                self.eof = False
                self.sock = socket.socket(socket.AF_INET,
                                          socket.SOCK_STREAM)
                self.sock.setblocking(False)
                self.sock.connect_ex((host, port))

        def pump_clients(timeout: float) -> int:
            moved = 0
            for key, mask in csel.select(timeout=timeout):
                c = key.data
                if not c.live:
                    if mask & selectors.EVENT_WRITE:
                        try:
                            n = c.sock.send(c.out)
                        except (BlockingIOError, InterruptedError):
                            continue
                        c.out = c.out[n:]
                        if not c.out:
                            c.live = True
                            csel.modify(c.sock, selectors.EVENT_READ, c)
                    continue
                try:
                    data = c.sock.recv(1 << 16)
                except (BlockingIOError, InterruptedError):
                    continue
                except OSError:
                    data = b""
                if not data:
                    c.eof = True
                    csel.unregister(c.sock)
                    continue
                c.buf.append(data)
                moved += len(data)
            return moved

        try:
            # connect in waves so the listen backlog never overflows,
            # stepping the server so it accepts + handshakes as we go
            for lo in range(0, len(plan), 512):
                for want in plan[lo:lo + 512]:
                    c = _C(want)
                    clients.append(c)
                    csel.register(c.sock, selectors.EVENT_WRITE, c)
                for _ in range(200):
                    srv.step(0.001)
                    pump_clients(0.0)
                    if all(c.live for c in clients):
                        break
            deadline = time.monotonic() + 60
            while (len(srv._subs) < len(clients)
                   and time.monotonic() < deadline):
                srv.step(0.001)
                pump_clients(0.0)
            assert len(srv._subs) == len(clients), (
                f"only {len(srv._subs)}/{len(clients)} subscribers "
                f"live after the connect phase")

            # timed fan-out phase: produce the stamped MatchOut stream,
            # then run the (single-threaded) server + client pumps
            # until everything derived is on the wire
            t0 = time.perf_counter()
            for i, ln in enumerate(lines):
                broker.produce(topic, None, ln, epoch=1, out_seq=i,
                               ats=time.time_ns() // 1000)
            end = len(lines)
            deadline = time.monotonic() + 600
            while time.monotonic() < deadline:
                n = srv.step(0.0)
                pump_clients(0.0)
                if (n == 0 and srv.offset >= end
                        and not any(s.queue or s.conflating
                                    for s in srv._subs.values())):
                    break
            elapsed = time.perf_counter() - t0
            assert srv.offset >= end, (
                f"feed server stalled at offset {srv.offset}/{end}")
            stats = srv.stats()
            lag = registry.latency("feed_lag").quantiles()
        finally:
            srv.close()   # EOF to every subscriber
        # drain the client side to EOF: TCP buffers may still hold
        # frames the server already counted as delivered
        deadline = time.monotonic() + 60
        while (any(not c.eof for c in clients)
               and time.monotonic() < deadline):
            if pump_clients(0.05) == 0 and all(
                    not c.live or c.eof for c in clients):
                break
        csel.close()
        for c in clients:
            try:
                c.sock.close()
            except OSError:
                pass

    # reconstruction: every subscriber's book must be byte-exact vs
    # the oracle store restricted to its subscription
    conflated_subs = 0
    total_frames_rx = 0
    for ci, c in enumerate(clients):
        blob = b"".join(c.buf)
        bb = BookBuilder()
        used = bb.apply_buffer(blob)
        assert used == len(blob), (
            f"sub {ci}: {len(blob) - used} trailing bytes did not "
            f"decode as frames")
        assert not bb.errors, f"sub {ci}: {bb.errors}"
        assert not bb.gaps, f"sub {ci}: sequence gaps {bb.gaps[:4]}"
        assert bb.dups == 0, f"sub {ci}: {bb.dups} duplicate seqs"
        total_frames_rx += bb.frames
        if bb.resyncs:
            conflated_subs += 1
        if c.symbols is None:
            want_levels = oracle_levels
        else:
            want_levels = {k: v for k, v in oracle_levels.items()
                           if k[0] in c.symbols}
        assert canonical_books(bb.book) == canonical_books(
            want_levels), (
            f"sub {ci} (symbols={c.symbols}): reconstructed book "
            f"diverged from the oracle store")
        if c.symbols is None:
            # auditors: level-by-level at every depth + the TOB view
            for sid in sorted({s for s, _ in oracle_levels}):
                for nd in (1, depth_levels, 0):
                    assert bb.book.depth(sid, nd) == \
                        oracle_state.depth(sid, nd), (
                            f"auditor {ci}: depth-{nd} mismatch on "
                            f"symbol {sid}")
                assert bb.tob.get(sid) == oracle_state.tob(sid), (
                    f"auditor {ci}: TOB mismatch on symbol {sid}")
    delivered = stats["delivered"]
    fan_mps = delivered / elapsed if elapsed > 0 else 0.0
    lag_p99_ms = lag[0.99] * 1e3
    # the oracle, the deriver and the fan-out all run on the host
    backend = "cpu"
    total_s = time.perf_counter() - t_all
    detail = {
        "suite": "feed", "events": events, "records": len(lines),
        "seed": seed, "profile": profile,
        "subscribers": len(clients), "symbols": len(all_sids),
        "queue_bytes": queue_bytes, "depth_every": depth_every,
        "depth_levels": depth_levels,
        "backend": backend,
        "elapsed_s": round(total_s, 3),
        "fanout_s": round(elapsed, 4),
        "frames_derived": stats["frames"],
        "frames_delivered": delivered,
        "frames_received": total_frames_rx,
        "deriver_frames": ref_deriver.frames_out,
        "conflations": stats["conflations"],
        "resyncs": stats["resyncs"],
        "conflated_subs": conflated_subs,
        "feed_lag_p50_ms": round(lag[0.5] * 1e3, 3),
        # gated metrics (perfgate reads the detail root)
        "feed_msgs_per_sec": round(fan_mps, 1),
        "feed_lag_p99_ms": round(lag_p99_ms, 3),
    }
    print(f"kme-torch-bench feed: {len(clients)} subs x {len(all_sids)} "
          f"symbols [{profile}]: {fan_mps:,.0f} frames/s delivered "
          f"({stats['frames']} derived, {stats['conflations']} "
          f"conflations, {stats['resyncs']} resyncs) "
          f"lag p50={detail['feed_lag_p50_ms']}ms "
          f"p99={detail['feed_lag_p99_ms']}ms ({total_s:.1f}s)",
          file=sys.stderr)
    print(f"kme-torch-bench feed: all {len(clients)} books byte-exact vs "
          f"oracle (2 auditors at every depth), 0 gaps, 0 dups",
          file=sys.stderr)
    return {
        "metric": "feed_msgs_per_sec",
        "value": round(fan_mps, 1),
        "unit": "frames/sec",
        "vs_baseline": round(fan_mps / REFERENCE_BASELINE_OPS, 3),
        "detail": detail,
    }


def bench_prof(events: int = 20_000, seed: int = 0,
               batch: int = 512, repeats: int = 3,
               overhead_ceiling: float = 0.03) -> dict:
    """Continuous-profiling overhead suite (`--suite prof`):
    the SAME seeded stream is served twice through an in-process
    MatchService — once with observability off, once with the full
    always-on plane (host sampling profiler + heartbeat thread + TSDB
    history + transfer/compute artifact + an armed watchpoint) — at
    matched batching. The engine is the host oracle, so the service runs
    with `device="cpu"` and its artifact holds the host plane.

    Three hard assertions, not statistics:
    - overhead: best-of-`repeats` serve walls must agree within
      `overhead_ceiling` (3% — the "always-on" budget;
      a profiler you must turn off under load is a debugger, not
      telemetry);
    - byte parity: both runs must leave BYTE-IDENTICAL MatchOut
      values — profiling must be invisible to the matched stream
      (COMPAT.md: the wire contract does not move);
    - artifact round-trip: the per-backend transfer-vs-compute JSON
      written at close must parse back with the plane the service
      wrote (`cpu`: profiler.device_plane of a host engine).
    `prof_overhead_frac` reports ADVISORY (a ratio of two wall clocks
    on shared runners); the ceiling assert is the enforcement."""
    import os
    import tempfile

    from kme_tpu_torch.bridge.broker import InProcessBroker
    from kme_tpu_torch.bridge.provision import provision
    from kme_tpu_torch.bridge.service import (MatchService, TOPIC_IN,
                                        TOPIC_OUT)
    from kme_tpu_torch.telemetry import tsdb as tsdbmod
    from kme_tpu_torch.telemetry.profiler import read_transfer_artifact
    from kme_tpu_torch.wire import dumps_order
    from kme_tpu_torch.workload import harness_stream

    t0 = time.perf_counter()
    msgs = harness_stream(events, seed=seed, num_accounts=64,
                          num_symbols=16, validate=True)
    lines = [dumps_order(m) for m in msgs]
    n = len(lines)

    def run_once(td: str, observe: bool):
        broker = InProcessBroker()
        provision(broker)
        for ln in lines:
            broker.produce(TOPIC_IN, None, ln)
        kw = {}
        health = None
        if observe:
            kw = dict(tsdb=os.path.join(td, "tsdb"), profile=True,
                      profile_artifact=os.path.join(td, "xfer.json"),
                      # a representative armed watchpoint rides the
                      # observe run: the 3% ceiling + MatchOut parity
                      # asserts below now also bound the watch plane
                      # (watchpoints must be free)
                      watch=["balance[1]<0"],
                      capture_dir=os.path.join(td, "captures"))
            health = os.path.join(td, "serve.health")
        svc = MatchService(broker, engine="oracle", compat="fixed",
                           batch=batch, device="cpu", **kw)
        t1 = time.perf_counter()
        svc.run(max_messages=n, idle_exit=5.0, health_file=health,
                health_every=0.2)
        wall = time.perf_counter() - t1
        svc.close()
        out = []
        off = 0
        while True:
            recs = broker.fetch(TOPIC_OUT, off, 4096)
            if not recs:
                break
            out.extend(r.value for r in recs)
            off = recs[-1].offset + 1
        return wall, out

    walls = {"off": [], "on": []}
    stored = {}
    with tempfile.TemporaryDirectory() as td:
        on_dir = os.path.join(td, "on")
        os.makedirs(on_dir)
        for rep in range(repeats):
            for mode, observe in (("off", False), ("on", True)):
                wall, out = run_once(on_dir if observe else td,
                                     observe)
                walls[mode].append(wall)
                if rep == 0:
                    stored[mode] = out
        # MatchOut byte parity: the observability plane must be
        # invisible to the matched stream
        assert stored["off"] == stored["on"], (
            "profiling altered the MatchOut record bytes")
        samples = sum(1 for _ in tsdbmod.read_samples(
            os.path.join(on_dir, "tsdb"), source="serve"))
        assert samples > 0, "TSDB recorded no heartbeat samples"
        summary = tsdbmod.window_summary(os.path.join(on_dir, "tsdb"),
                                         source="serve")
        art = read_transfer_artifact(os.path.join(on_dir, "xfer.json"))
    # the plane the service wrote: its engine runs on the host
    backend = "cpu"
    assert backend in art, (
        f"transfer/compute artifact lacks the {backend!r} plane: "
        f"{sorted(art)}")
    plane = art[backend]
    off_s, on_s = min(walls["off"]), min(walls["on"])
    overhead = max(0.0, 1.0 - off_s / on_s)
    if overhead > overhead_ceiling:
        raise AssertionError(
            f"always-on profiling overhead {overhead:.1%} > "
            f"{overhead_ceiling:.0%} ceiling (off {off_s:.3f}s, "
            f"on {on_s:.3f}s)")
    mps = n / on_s
    elapsed = time.perf_counter() - t0
    detail = {
        "suite": "prof", "events": events, "records": n,
        "seed": seed, "batch": batch, "repeats": repeats,
        "backend": backend, "elapsed_s": round(elapsed, 3),
        "off_s": round(off_s, 4), "on_s": round(on_s, 4),
        "orders_per_sec": round(mps, 1),
        "tsdb_samples": samples,
        "prof_overhead_frac": round(overhead, 4),
        "overhead_ceiling": overhead_ceiling,
        # host-plane attribution from the on-run's own history
        "prof_stage_fracs": {
            s: round(summary.get(f"prof_stage_frac_{s}", 0.0), 4)
            for s in ("parse", "plan", "dispatch", "collect",
                      "produce")},
        # device-plane advisories (the host plane carries none of the
        # card fields, so these stay None)
        "h2d_bytes_per_s": plane.get("h2d_bytes_per_s"),
        "transfer_compute_ratio": plane.get("transfer_compute_ratio"),
        "h2d_overlap_frac": plane.get("h2d_overlap_frac"),
    }
    print(f"kme-torch-bench prof: off={off_s:.3f}s on={on_s:.3f}s "
          f"(overhead {overhead:.2%}, ceiling "
          f"{overhead_ceiling:.0%}) {mps:,.0f} orders/s, "
          f"{samples} history samples, artifact[{backend}] ok "
          f"({elapsed:.1f}s)", file=sys.stderr)
    return {
        "metric": "orders_per_sec",
        "value": round(mps, 1),
        "unit": "orders/sec",
        "vs_baseline": round(mps / REFERENCE_BASELINE_OPS, 3),
        "detail": detail,
    }


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="kme-torch-bench")
    p.add_argument("--suite", choices=("lanes", "parity", "native",
                                       "latency", "pipeline",
                                       "shards", "groups", "storms",
                                       "wire", "feed", "multihost",
                                       "prof"),
                   default="lanes")
    p.add_argument("--subs", type=int, default=10_000,
                   help="feed suite: subscriber count (two of them "
                        "are wildcard auditors; the rest pin one "
                        "symbol each)")
    p.add_argument("--pipeline", type=int, default=2, metavar="N",
                   help="pipeline suite: in-flight batch window depth "
                        "(how many submits may run ahead of collect)")
    p.add_argument("--engine", choices=("seq", "sweep"), default="seq",
                   help="lanes-suite engine: the sequential chain kernel "
                        "(default) or the vectorized sweep engine")
    p.add_argument("--events", type=int, default=None)
    p.add_argument("--symbols", type=int, default=1024)
    p.add_argument("--accounts", type=int, default=2048)
    p.add_argument("--zipf", type=float, default=1.2)
    p.add_argument("--shards", type=int, default=1)
    p.add_argument("--slots", type=int, default=None,
                   help="resting-order slots per book side (H2 envelope; "
                        "default: 8192 for the seq engine, 128 for sweep)")
    p.add_argument("--max-fills", type=int, default=16,
                   help="makers swept per taker (H3 envelope)")
    p.add_argument("--steps", type=int, default=64,
                   help="scan-length bucket granularity of dispatch windows")
    p.add_argument("--width", type=int, default=DEFAULT_WIDTH,
                   help="active-lane compaction: messages per scan step "
                        "(0 = full-width)")
    p.add_argument("--workload",
                   choices=("zipf", "cancel", "zipf-hot",
                            "payout-storm", "cross-account")
                   + STORM_WORKLOADS,
                   default="zipf",
                   help="stream profile: Zipf-skewed, bursty cancel/"
                        "replace (BASELINE.md rows), one-symbol hot "
                        "book (zipf-hot), mass-settlement bursts "
                        "(payout-storm), or one of the five named "
                        "adversarial storm profiles "
                        "(workload.STORM_PROFILES) — all "
                        "seed-deterministic")
    p.add_argument("--window", type=int, default=1024,
                   help="max scan steps per dispatch window")
    p.add_argument("--parity-prefix", type=int, default=20000,
                   help="sweep-suite only: post-preamble messages "
                        "checked against the quirk-exact replica (the "
                        "seq suite always checks the FULL stream)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the "
                        "sweep suite's timed run to DIR/trace.json")
    p.add_argument("--batch", type=int, default=DEFAULT_LATENCY_BATCH,
                   help="micro-batch size (latency suite batches; parity "
                        "suite scan length)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cross-frac", type=float, default=0.5,
                   help="groups suite, cross-account workload: "
                        "fraction of orders forced onto non-home "
                        "accounts (1.0 = the 100%% cross-shard worst "
                        "case)")
    p.add_argument("--prefund", type=int, default=8,
                   help="groups suite: orders' worth of worst-case "
                        "margin granted per cross-shard transfer pair "
                        "(front.py chunked reserve->settle; 1 = exact "
                        "per-order grants)")
    p.add_argument("--dispatch", choices=("auto", "async", "lockstep"),
                   default="auto",
                   help="shards suite: mesh dispatch mode (auto "
                        "resolves to per-chip async on a single-host "
                        "mesh; lockstep is the legacy barrier scan)")
    # None -> per-suite default: the native/parity suites judge java
    # (their reason to exist); the lanes/seq headline is fixed-mode
    # unless java is explicitly requested
    p.add_argument("--compat", choices=("java", "fixed"), default=None)
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="write a Chrome trace-event JSON (chrome://"
                        "tracing / Perfetto) of the session phase "
                        "timeline here at exit")
    p.add_argument("--journal-out", default=None, metavar="PATH",
                   help="seq suite: write the best run's order-"
                        "lifecycle journal here (post-hoc — the timed "
                        "runs are untouched) and report the cost as "
                        "journal_overhead_frac. Query with kme-torch-trace")
    p.add_argument("--audit", action="store_true",
                   help="seq suite: run the invariant auditor over the "
                        "best run's stream and report audit_s / "
                        "audit_overhead_frac / audit_violations")
    p.add_argument("--baseline", default=None, metavar="BENCH.json",
                   help="recorded benchmark artifact to compare "
                        "against (a recorded BENCH_r0N.json artifact, a "
                        "detail JSON, or raw bench output)")
    p.add_argument("--gate", action="store_true",
                   help="with --baseline: exit 1 when a gated metric "
                        "regressed beyond --tolerance (backend "
                        "mismatch demotes to advisory, exit 0)")
    p.add_argument("--tolerance", type=float, default=0.25,
                   metavar="FRAC",
                   help="allowed fractional degradation before the "
                        "gate fails (0.25 = 25%%)")
    p.add_argument("--gate-report", default=None, metavar="PATH",
                   help="write the gate comparison report JSON here "
                        "(CI uploads it as an artifact)")
    p.add_argument("--gate-current", default=None, metavar="PATH",
                   help="gate a PRE-RECORDED artifact against "
                        "--baseline instead of running a bench (e.g. "
                        "re-judge a CI artifact offline)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the device suites run their engines: the "
                        "card (default; without one the command exits "
                        "2) or the CPU (the kernels' plain PyTorch "
                        "versions)")
    args = p.parse_args(argv)
    if (args.gate or args.gate_current) and args.baseline is None:
        p.error("--gate/--gate-current require --baseline")
    if args.gate_current is not None:
        from kme_tpu_torch import perfgate

        current = perfgate.load_artifact(args.gate_current)
        if not current["metrics"]:
            print(f"kme-torch-bench --gate: no metrics found in "
                  f"{args.gate_current!r}", file=sys.stderr)
            return 2
        return perfgate.run_gate(args.baseline, current,
                                 tolerance=args.tolerance,
                                 report_path=args.gate_report)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("kme-torch-bench: no CUDA card is available; the "
                  "benchmark runs on the card (--device cpu runs the "
                  "plain PyTorch versions)", file=sys.stderr)
            return 2
    dev = args.device
    tracer = None
    if args.trace_out is not None:
        from kme_tpu_torch.telemetry import TraceRecorder, install

        tracer = TraceRecorder()
        install(tracer)   # session PhaseTimers pick it up process-wide
    if args.suite == "lanes" and args.engine == "seq":
        rec = bench_seq_engine(args.events or 100_000, args.symbols,
                               args.accounts, args.seed, args.zipf,
                               slots=args.slots or SEQ_DEFAULT_SLOTS,
                               max_fills=args.max_fills,
                               workload=args.workload,
                               compat=args.compat or "fixed",
                               journal_out=args.journal_out,
                               audit=args.audit, device=dev)
    elif args.suite == "lanes":
        rec = bench_lane_engine(args.events or 100_000, args.symbols,
                                args.accounts, args.seed, args.zipf,
                                steps=args.steps, slots=args.slots or 128,
                                max_fills=args.max_fills, shards=args.shards,
                                parity_prefix=args.parity_prefix,
                                width=args.width, workload=args.workload,
                                window=args.window,
                                profile_dir=args.profile, device=dev)
    elif args.suite == "native":
        rec = bench_native_engine(args.events or 100_000, args.seed,
                                  max(args.batch, 1),
                                  args.compat or "java")
    elif args.suite == "pipeline":
        rec = bench_pipeline(args.events or 40_960, args.symbols,
                             args.accounts, args.seed, args.zipf,
                             batch=args.batch, depth=args.pipeline,
                             device=dev)
    elif args.suite == "groups":
        rec = bench_groups(args.events or 20_000,
                           symbols=args.symbols,
                           accounts=min(args.accounts, 256),
                           seed=args.seed,
                           workload=args.workload,
                           cross_frac=args.cross_frac,
                           slots=args.slots or 128,
                           max_fills=args.max_fills,
                           prefund=args.prefund)
    elif args.suite == "shards":
        rec = bench_shards(args.events or 4000,
                           symbols=min(args.symbols, 8),
                           accounts=min(args.accounts, 128),
                           seed=args.seed,
                           workload=(args.workload
                                     if args.workload != "zipf"
                                     else "zipf-hot"),
                           slots=args.slots or 128,
                           max_fills=args.max_fills,
                           dispatch=args.dispatch, device=dev)
    elif args.suite == "storms":
        rec = bench_storms(args.events or 4000, seed=args.seed)
    elif args.suite == "multihost":
        rec = bench_multihost(args.events or 6000,
                              symbols=min(args.symbols, 512),
                              accounts=min(args.accounts, 128),
                              seed=args.seed,
                              cross_frac=args.cross_frac,
                              slots=args.slots or 128,
                              max_fills=args.max_fills,
                              prefund=args.prefund)
    elif args.suite == "wire":
        rec = bench_wire(args.events or 20_000, seed=args.seed,
                         batch=max(args.batch, 1))
    elif args.suite == "prof":
        rec = bench_prof(args.events or 20_000, seed=args.seed,
                         batch=max(args.batch, 1))
    elif args.suite == "feed":
        rec = bench_feed(args.events or 20_000, seed=args.seed,
                         subs=args.subs, symbols=args.symbols,
                         profile=(args.workload
                                  if args.workload in STORM_WORKLOADS
                                  else "flash-crowd"))
    elif args.suite == "latency":
        rec = bench_latency(args.events or 20_000, args.symbols,
                            args.accounts, args.seed, args.zipf,
                            slots=args.slots or 128,
                            max_fills=args.max_fills,
                            width=args.width, shards=args.shards,
                            batch=args.batch, engine=args.engine,
                            device=dev)
    else:
        rec = bench_parity_engine(args.events or 4096, args.seed,
                                  args.batch, args.compat or "java",
                                  device=dev)
    if tracer is not None:
        tracer.save(args.trace_out)
        print(f"kme-torch-bench: trace written to {args.trace_out}",
              file=sys.stderr)
    out = {k: rec[k] for k in ("metric", "value", "unit", "vs_baseline")}
    print(json.dumps(out))
    print(json.dumps(rec["detail"]), file=sys.stderr)
    if args.gate:
        from kme_tpu_torch import perfgate

        # the headline scalar participates too (it carries the suite's
        # one-number summary, e.g. orders_per_sec)
        doc = dict(rec["detail"])
        if rec.get("unit") == "orders/sec":
            doc.setdefault("orders_per_sec", rec["value"])
        return perfgate.run_gate(args.baseline,
                                 perfgate.detail_to_artifact(doc),
                                 tolerance=args.tolerance,
                                 report_path=args.gate_report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
