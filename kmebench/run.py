"""Run one cell of the port's benchmark once.

    python -m kmebench.run --workload <cell> --seed <n> --seconds <s>
                           --trace <0|1> [--rate <msgs/s>]

The system under test is `kme_tpu_torch`'s own serving entry,
`kme_tpu_torch.bridge.serve.main` (`kme-torch-serve`), run in this
process with the configuration's flags on a free local port, its broker
on its TCP listener. Two children that import no torch drive it over
TCP: the generator (`kmebench/gen.py`) produces the configuration's
stream to MatchIn under the cell's traffic mix, and the consumer
(`kmebench/consumer.py`) reads MatchOut.

Set-up runs from this process's start to the window's start: imports,
the program's kernels loaded from its build directory (built only on a
checkout's first run), the server coming up, and the stream's preamble
and a warm prefix sent and fully answered, then one full collection of
the interpreter's garbage. The window lasts `--seconds`.
Then the consumer waits for every message produced, the server stops,
the device's peak memory is read, and every MatchOut record the consumer
received is compared in order with the frozen reference
(`kmebench/reference/`) run over the same messages. `--trace 1` adds a
torch.profiler window and the program's serve spans, and reports the
per-layer metrics instead of the end-to-end ones.

The last line of standard output is the result: `correct`, `attempted`
(messages due in the window), `failed`, `metrics`, `device`, with
`--trace 1` `breakdown`, and last `checks`, each number compared beside
its limit, which are also the last lines of standard error. `--rate`
overrides an open-loop cell's rate for the knee sweep (`kmebench/sweep.py`).
"""

from __future__ import annotations

import time

T_START = time.monotonic()   # set-up is timed from here

import argparse  # noqa: E402
import gc  # noqa: E402
import http.client  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import select  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import traceback  # noqa: E402
from typing import List, Optional  # noqa: E402

import numpy as np  # noqa: E402

from kmebench import devtrace as D  # noqa: E402
from kmebench import measure as M  # noqa: E402
from kmebench import spec as S  # noqa: E402

# top-level module names that no run may load: JAX and the JAX package
# (compared whole: the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "kme_tpu")
# the program's build and kernel caches, inside the checkout
CACHE_ENV = {"TRITON_CACHE_DIR": os.path.join(S.HERE, "_build", "triton"),
             "TORCH_EXTENSIONS_DIR": os.path.join(S.HERE, "_build",
                                                  "torch_extensions")}
SERVE_START_S = 1100     # the first run of a checkout builds the kernels
WARM_S = 300
CONSUMER_EXTRA_S = 120


def forbidden_modules(names=None) -> List[str]:
    tops = {m.split(".", 1)[0] for m in (names if names is not None
                                         else list(sys.modules))}
    return sorted(tops & set(FORBIDDEN))


def serve_argv(config: dict, tmp: str, device: str) -> List[str]:
    """kme-torch-serve's arguments: the configuration's flags ("{tmp}"
    standing for the run's temporary directory), a free local port, the
    metrics endpoint the per-layer readers scrape."""
    argv = []
    for k, v in config["serve"].items():
        flag = "--" + k.replace("_", "-")
        if v is True:
            argv.append(flag)
        else:
            argv += [flag, str(v).replace("{tmp}", tmp)]
    return argv + ["--listen", "127.0.0.1:0", "--auto-provision",
                   "--metrics-port", "0", "--device", device]


class _Tee(io.TextIOBase):
    """Passes the server's standard error on and watches it for the
    addresses it binds."""

    KEYS = {"listen": "broker listening on ",
            "metrics": "metrics on http://"}

    def __init__(self, inner) -> None:
        self.inner = inner
        self.found = {}
        self.cond = threading.Condition()
        self._line = ""

    def write(self, s: str) -> int:
        self.inner.write(s)
        self._line += s
        while "\n" in self._line:
            line, self._line = self._line.split("\n", 1)
            for key, mark in self.KEYS.items():
                if mark in line:
                    addr = line.split(mark, 1)[1].split("/")[0].strip()
                    with self.cond:
                        self.found[key] = addr
                        self.cond.notify_all()
        return len(s)

    def flush(self) -> None:
        self.inner.flush()

    def wait(self, key: str, timeout: float, ctx) -> str:
        end = time.monotonic() + timeout
        with self.cond:
            while key not in self.found:
                if ctx.server_done or time.monotonic() > end:
                    raise RuntimeError(f"the server did not report its "
                                       f"{key} address")
                self.cond.wait(0.2)
            return self.found[key]


class _Lines:
    """Lines from a child's stdout, with a timeout."""

    def __init__(self, proc) -> None:
        self.proc = proc
        self.fd = proc.stdout.fileno()
        self.buf = b""

    def read(self, timeout: float) -> str:
        end = time.monotonic() + timeout
        while b"\n" not in self.buf:
            left = end - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"no line from {self.proc.args[2]} in "
                                   f"{timeout:.0f} s")
            if select.select([self.fd], [], [], min(left, 1.0))[0]:
                chunk = os.read(self.fd, 65536)
                if not chunk:
                    raise RuntimeError(f"{self.proc.args[2]} exited "
                                       f"(rc {self.proc.wait()})")
                self.buf += chunk
        line, self.buf = self.buf.split(b"\n", 1)
        return line.decode()


def scrape(addr: str) -> dict:
    """/metrics.json of the server (a local address; no proxy)."""
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(
        "127.0.0.1" if host in ("0.0.0.0", "") else host, int(port),
        timeout=30)
    try:
        conn.request("GET", "/metrics.json")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


class RunData:
    """What the metric readers read (`kmebench/metrics/<name>.py`)."""

    def __init__(self, **kw) -> None:
        self.__dict__.update(kw)
        self._bytes = None

    def completed(self) -> int:
        """Messages whose closing record reached the consumer in the
        window."""
        return M.completed_in(self.done, self.t0, self.t1)

    def least_bytes(self) -> int:
        """Least device bytes of the messages completed in the window
        (`roofline.py`)."""
        if self._bytes is None:
            from kmebench.roofline import least_bytes

            inw = np.flatnonzero((self.done >= self.t0)
                                 & (self.done < self.t1))
            lo, hi = (int(inw[0]), int(inw[-1]) + 1) if len(inw) else (0, 0)
            self._bytes = least_bytes(self.cols, self.recs, self.counts,
                                      lo, hi)
        return self._bytes


class GcPauses:
    """The interpreter's collections in this process (the server's), by
    generation: when each started and how long it held every thread."""

    def __init__(self) -> None:
        self.pauses: List[tuple] = []
        self._t = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.monotonic()
        elif self._t is not None:
            self.pauses.append((info["generation"], self._t,
                                time.monotonic() - self._t))
            self._t = None

    def summary(self, t0: float, t1: float) -> dict:
        inw = [(g, d) for g, a, d in self.pauses if t0 <= a < t1]
        full = [d for g, d in inw if g == 2]
        return {"n": len(inw), "total_ms": sum(d for _, d in inw) * 1e3,
                "full_n": len(full), "full_max_ms": max(full, default=0.0)
                * 1e3, "full_total_ms": sum(full) * 1e3}


class _Ctx:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.server_done = False
        self.in_serve = False
        self.error: Optional[BaseException] = None
        self.m1 = None


def _drive(ctx, tee, job, seconds, profile, tmp, env) -> None:
    """The orchestrating thread: children, window, stop. `profile`: hold
    torch.profiler around the window (traced runs on the card)."""
    procs = []
    try:
        addr = tee.wait("listen", SERVE_START_S, ctx)
        maddr = tee.wait("metrics", 60, ctx)
        rfd, wfd = os.pipe()
        npz = os.path.join(tmp, "consumer.npz")
        cmd = [sys.executable, "-m"]
        cons = subprocess.Popen(
            cmd + ["kmebench.consumer", "--addr", addr, "--out", npz,
                   "--progress-fd", str(wfd)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, pass_fds=(wfd,),
            env=env, cwd=S.ROOT)
        procs.append(cons)
        gen = subprocess.Popen(
            cmd + ["kmebench.gen", "--addr", addr, "--job", json.dumps(job),
                   "--progress-fd", str(rfd)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, pass_fds=(rfd,),
            env=env, cwd=S.ROOT)
        procs.append(gen)
        os.close(rfd)
        os.close(wfd)
        glines, clines = _Lines(gen), _Lines(cons)
        if glines.read(WARM_S) != "WARM":
            raise RuntimeError("the generator did not warm up")
        ctx.m0 = scrape(maddr)
        if profile:
            ctx.prof = D.ProfilerWindow(os.path.join(tmp, "device.json"))
            ctx.prof.start()
        # every window starts from the same collector state: without it
        # the full collections of the program's growing heap (the broker
        # keeps every record) fall at a different place in each window
        gc.collect()
        t0 = time.monotonic() + 0.02
        gen.stdin.write(f"GO {t0!r}\n".encode())
        gen.stdin.flush()
        ctx.t0, ctx.t1 = t0, t0 + seconds
        ctx.setup_s = t0 - T_START
        time.sleep(max(0.0, ctx.t1 - time.monotonic()))
        try:
            ctx.m1 = scrape(maddr)
        except OSError as e:     # the server is gone; judged below
            print(f"kmebench: no metrics at the window's close: {e}",
                  file=sys.stderr)
        if profile:
            ctx.prof.stop()
        ctx.gen_report = json.loads(glines.read(seconds + 120))
        gen.wait(timeout=60)
        cons.stdin.write(f"EXPECT {ctx.gen_report['produced']}\n".encode())
        cons.stdin.flush()
        if clines.read(CONSUMER_EXTRA_S) != "DONE":
            raise RuntimeError("the consumer did not finish")
        cons.wait(timeout=60)
        with np.load(npz) as z:
            ctx.consumed = {k: z[k] for k in z.files}
    except Exception as e:   # noqa: BLE001 - run_cell raises it
        ctx.error = e
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            for f in (p.stdin, p.stdout):
                if f is not None:
                    f.close()
        with ctx.lock:
            if ctx.in_serve:
                signal.pthread_kill(threading.main_thread().ident,
                                    signal.SIGINT)


def _serve(ctx, argv) -> int:
    """kme-torch-serve in this (the main) thread, until the driving
    thread interrupts it."""
    from kme_tpu_torch.bridge.serve import main as serve_main

    def on_sigint(_sig, _frame):
        if ctx.in_serve:
            raise KeyboardInterrupt

    old = signal.signal(signal.SIGINT, on_sigint)
    try:
        with ctx.lock:
            ctx.in_serve = True
        try:
            return serve_main(argv)
        except KeyboardInterrupt:
            return 0
        except Exception:   # noqa: BLE001 - the run reports it
            traceback.print_exc()
            return 1
        finally:
            with ctx.lock:
                ctx.in_serve = False
                ctx.server_done = True
    finally:
        signal.signal(signal.SIGINT, old)


def run_cell(bench: S.Benchmark, name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             rate: Optional[float] = None) -> dict:
    """One run of one cell; returns the result line's object."""
    cell = bench.cell(name)
    config, traffic = cell["config"], cell["traffic"]
    params = dict(cell["params"])
    if rate is not None:
        params["rate_per_s"] = rate
    tmp = tempfile.mkdtemp(prefix="kmebench-")
    try:
        return _run(bench, cell, config, traffic, params, seed, seconds,
                    trace, device, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(bench, cell, config, traffic, params, seed, seconds, trace,
         device, tmp) -> dict:
    import torch

    env = dict(os.environ, PYTHONPATH=S.ROOT)
    job = {"stream": config["stream"], "traffic": traffic,
           "params": params, "seed": seed, "seconds": seconds,
           "batch": config["serve"]["batch"],
           "warm": config["warm_events"]}
    rec = None
    if trace:
        from kme_tpu_torch.telemetry import TraceRecorder, install

        off = D.perf_offset()
        rec = TraceRecorder()
        rec_t0 = time.perf_counter() - off
        install(rec)
    ctx = _Ctx()
    tee = _Tee(sys.stderr)
    on_card = device != "cpu"
    driving = threading.Thread(target=_drive, name="kmebench-drive",
                              args=(ctx, tee, job, seconds,
                                    trace and on_card, tmp, env),
                              daemon=True)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    gcp = GcPauses()
    gc.callbacks.append(gcp)
    driving.start()
    sys.stderr = tee
    try:
        rc = _serve(ctx, serve_argv(config, tmp, device))
    finally:
        sys.stderr = tee.inner
        if rec is not None:
            from kme_tpu_torch.telemetry import install

            install(None)
    driving.join()
    gc.callbacks.remove(gcp)
    if ctx.error is not None:
        raise RuntimeError(f"the run failed: {ctx.error!r}") from ctx.error
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"

    # the reference, over the same messages
    from kmebench.reference.native import ReferenceDeath, replay
    from kmebench.arrivals import due_offsets
    from kmebench.streams import MessageStream

    rep = ctx.gen_report
    warm, produced = rep["warm"], rep["produced"]
    cols = MessageStream(config["stream"], seed).take(produced)
    ref = config["reference"]
    death = None
    try:
        recs, counts = replay(cols, **ref)
    except ReferenceDeath as e:
        death, recs, counts = e, [], np.zeros(0, np.int64)
    want = M.digests(recs)
    got = ctx.consumed["digests"]
    closes = ctx.consumed["closes"]
    done = M.close_times(closes, ctx.consumed["fetch_t"],
                         ctx.consumed["fetch_n"])
    last_t = (float(ctx.consumed["fetch_t"][-1])
              if len(ctx.consumed["fetch_t"]) else ctx.t1)
    lat = None
    offs = due_offsets(traffic, params, seed, seconds)
    if offs is not None:
        due = ctx.t0 + offs
        lat = M.latencies(done, warm, due, max(last_t, ctx.t1))
    checks = {
        "records_differing": {"value": M.records_differing(got, want),
                              "limit": 0},
        "messages_unanswered": {"value": max(0, produced - len(done)),
                                "limit": 0},
    }
    if config["guarantees"].get("delivery") == "exactly_once":
        checks["records_doubled"] = {
            "value": M.records_doubled(ctx.consumed["stamps"]), "limit": 0}
    if rc != 0:
        checks["server_failures"] = {"value": 1, "limit": 0}
    if death is not None:
        checks["reference_deaths"] = {"value": 1, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    failed = (checks["messages_unanswered"]["value"]
              + (M.messages_wrong(got, want, counts) if len(counts)
                 else produced))
    spans = dev = None
    if trace:
        spans = D.spans_from_recorder(rec, rec_t0)
        if on_card:
            dev = D.clip(D.load_trace(ctx.prof.path, ctx.prof.anchor),
                         ctx.t0, ctx.t1)
    run = RunData(cell=cell["name"], t0=ctx.t0, t1=ctx.t1,
                  seconds=seconds, setup_s=ctx.setup_s,
                  done=done, warm=warm, produced=produced, lat=lat,
                  m0=ctx.m0, m1=ctx.m1, spans=spans, dev=dev, cols=cols,
                  recs=recs, counts=counts, device=device)
    wanted = (bench.per_layer_for(cell["name"]) if trace
              else bench.e2e_for(cell["name"]))
    metrics = S.read_metrics(bench, wanted, run)
    devinfo = {"platform": "gpu" if on_card else "cpu", "kind": kind,
               "count": 1 if on_card else 0, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(produced - warm),
           "failed": int(min(failed, produced)), "metrics": metrics,
           "device": devinfo}
    if trace and dev is not None:
        devinfo["busy_s"] = D.union_seconds(dev)
        devinfo["window_s"] = float(seconds)
        ops = sorted(D.by_name(dev).items(), key=lambda x: -x[1])[:10]
        gaps = sorted(D.idle_by_host(dev, spans, ctx.t0, ctx.t1).items(),
                      key=lambda x: -x[1])[:10]
        out["breakdown"] = {"device_ops": [[n, s] for n, s in ops],
                            "idle_gaps": [[n, s] for n, s in gaps]}
    detail = {"produced": produced, "warm": warm,
              "completed_in_window": run.completed(),
              "gc": gcp.summary(ctx.t0, ctx.t1)}
    if lat is not None and len(lat):
        detail["lat_ms"] = {str(q): float(np.percentile(lat, q)) * 1e3
                            for q in (50, 90, 95, 99, 99.9)}
        # latency by quarter of the window and the backlog at its close:
        # what the knee sweep reads for a growing backlog
        q = np.array_split(lat, 4)
        detail["lat_p50_by_quarter_ms"] = [
            float(np.median(x)) * 1e3 for x in q if len(x)]
        detail["outstanding_at_close"] = int(
            np.count_nonzero(due < ctx.t1)
            - np.count_nonzero(done[warm:] < ctx.t1))
    if "late_ms" in rep:
        detail["late_ms"] = rep["late_ms"]
    # what the run left on disk: the broker log and snapshots of a
    # durable configuration, the consumer's arrays, the trace
    detail["tmp_bytes"] = sum(os.path.getsize(os.path.join(d, f))
                              for d, _, fs in os.walk(tmp) for f in fs)
    out["detail"] = detail
    if "late_ms" in rep:
        late = rep["late_ms"]
        print(f"kmebench: generator lateness p50 {late['p50']:.3f} ms, "
              f"p99 {late['p99']:.3f} ms, max {late['max']:.3f} ms"
              + ("  (the generator did not keep its schedule)"
                 if late["p99"] > 5.0 else ""), file=sys.stderr)
    if death is not None:
        print(f"kmebench: {death}", file=sys.stderr)
    d = M.first_difference(got, want)
    if d is not None:
        print(f"kmebench: first differing MatchOut record #{d}: reference "
              f"{recs[d].decode() if d < len(recs) else '(none)'}",
              file=sys.stderr)
    out["checks"] = checks
    return out


def print_result(out: dict) -> None:
    """The compared numbers as the last lines of standard error, the
    result as the last line of standard output."""
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kmebench.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rate", type=float, default=None,
                   help="override an open-loop cell's rate (knee sweep)")
    a = p.parse_args(argv)
    bench = S.Benchmark()
    cell = bench.cell(a.workload)
    import torch

    chips = int(cell["entry"]["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"kmebench: the cell needs {chips} CUDA device(s); {have} "
              "available", file=sys.stderr)
        return 2
    os.environ.update(CACHE_ENV)
    out = run_cell(bench, a.workload, a.seed, a.seconds, bool(a.trace),
                   rate=a.rate)
    bad = forbidden_modules()
    if bad:
        print(f"kmebench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
