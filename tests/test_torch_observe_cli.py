"""The port's observability from its command line.

- `kme-torch-serve --device cpu` with every ported observability flag on,
  fed over TCP by `kme-torch-loadgen --connections 1` with `jax` and
  `kme_tpu` blocked, writes MatchOut byte-identical to the same run with
  the flags off and to the JAX package's service; /metrics answers over
  HTTP while it serves; `kme-torch-consume --tsdb-out` and the loadgen's
  `--tsdb-out` append to the shared store;
- the query tools (`kme-torch-trace`, `-prof`, `-xray`, `-agg`, `-top`,
  `-events`) read what that serve wrote, in agreement with the JAX
  package's tools on the same files;
- what waits for the front, kafka or perfgate exits 2 naming the module.
"""

import json
import os
import subprocess
import sys
import time
from urllib.request import urlopen

import pytest
import torch

from kme_tpu import cli as JCLI
from kme_tpu.bridge import service as JSV
from kme_tpu.bridge.broker import InProcessBroker as JaxBroker
from kme_tpu.workload import harness_stream
from kme_tpu_torch import cli as PCLI
from kme_tpu_torch.bridge import serve as PSERVE
from kme_tpu_torch.bridge.service import TOPIC_IN, TOPIC_OUT
from kme_tpu_torch.wire import dumps_order

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 600
SEED = 5
SEQ = ["--engine", "seq", "--pipeline", "2", "--device", "cpu",
       "--batch", "128", "--symbols", "8", "--accounts", "128",
       "--max-fills", "32"]

_BLOCK = ("import sys\n"
          "class B:\n"
          "    def find_spec(self, n, p=None, t=None):\n"
          "        if n.split('.')[0] in ('jax', 'kme_tpu'):\n"
          "            raise ImportError('blocked: ' + n)\n"
          "sys.meta_path.insert(0, B())\n"
          "from kme_tpu_torch.cli import main\n"
          "sys.exit(main(sys.argv[1:]))\n")


def _cli(*args, **kw):
    return subprocess.Popen([sys.executable, "-c", _BLOCK, *args], cwd=ROOT,
                            env=dict(os.environ, PYTHONPATH=ROOT), **kw)


def _wait_line(proc, needle, errs, timeout=60):
    t0 = time.time()
    while time.time() - t0 < timeout:
        line = proc.stderr.readline()
        if not line:
            return None
        errs.append(line)
        if needle in line:
            return line
    return None


def _jax_matchout():
    """The JAX package's service on the same stream (its native engine at
    the seq engine's capacity envelope: the same bytes)."""
    msgs = harness_stream(N, seed=SEED, payout_opcode_bug=False,
                          validate=True)
    b = JaxBroker()
    b.create_topic(TOPIC_IN)
    b.create_topic(TOPIC_OUT)
    for m in msgs:
        b.produce(TOPIC_IN, None, dumps_order(m))
    svc = JSV.MatchService(b, engine="native", compat="fixed", batch=128,
                           slots=128, max_fills=32)
    svc.run(max_messages=len(msgs))
    return [f"{r.key} {r.value}" for r in b.fetch(TOPIC_OUT, 0, 10 ** 9)]


def _serve_run(extra, tmp, n_out, tsdb=None):
    """One CLI serve fed by the CLI loadgen and read by the CLI consumer;
    with `tsdb` the loadgen runs one simulated client (`--connections
    1`: paced and stamped, in stream order) and both clients append to
    the store. -> (MatchOut lines, /metrics text or None, serve
    stderr). The consumer reads once the serve has produced `n_out`
    MatchOut records, while the serve waits out its idle exit."""
    from kme_tpu_torch.bridge.tcp import TcpBroker

    srv = _cli("serve", "--listen", "127.0.0.1:0", *SEQ,
               "--auto-provision", "--idle-exit", "10", *extra,
               stderr=subprocess.PIPE, text=True)
    errs = []
    prom = None
    try:
        line = _wait_line(srv, "broker listening on", errs)
        assert line, "".join(errs)
        addr = line.rsplit(" ", 1)[1].strip()
        gen_args = ["loadgen", "--events", str(N), "--seed", str(SEED),
                    "--validate", "--fix-payout-opcode", "--broker", addr]
        if tsdb:
            gen_args += ["--connections", "1", "--client-batch", "32",
                         "--report", str(tmp / "report.json"),
                         "--tsdb-out", tsdb]
        gen = _cli(*gen_args, stderr=subprocess.PIPE, text=True)
        assert gen.wait(timeout=120) == 0, gen.stderr.read()
        gen.stderr.close()
        if "--metrics-port" in extra:
            line = _wait_line(srv, "metrics on http://", errs)
            assert line, "".join(errs)
            port = int(line.rsplit(":", 1)[1].split("/")[0])
            with urlopen(f"http://127.0.0.1:{port}/metrics",
                         timeout=10) as r:
                prom = r.read().decode()
        host, port = addr.rsplit(":", 1)
        client = TcpBroker(host, int(port))
        try:
            t0 = time.time()
            while (client.end_offset(TOPIC_OUT) < n_out
                   and time.time() - t0 < 120):
                time.sleep(0.1)
        finally:
            client.close()
        cons = ["consume", "--broker", addr, "--no-follow"]
        if tsdb:
            cons += ["--tsdb-out", tsdb]
        con = _cli(*cons, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                   text=True)
        out, cerr = con.communicate(timeout=120)
        assert con.returncode == 0, cerr
        assert srv.wait(timeout=120) == 0
        errs.extend(srv.stderr.readlines())
    finally:
        if srv.poll() is None:
            srv.kill()
            srv.wait()
        srv.stderr.close()
    return out.splitlines(), prom, "".join(errs)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("observe_cli")
    d = lambda *p: str(tmp.joinpath(*p))       # noqa: E731
    on = ["--checkpoint-dir", d("ck"), "--checkpoint-every", "256",
          "--journal-out", d("journal.bin"), "--journal-rotate-mb", "64",
          "--journal-fsync", "batch", "--journal-keep", "4", "--audit",
          "--audit-repro-dir", d("repro"), "--trace-spans",
          "--slo-p99-ms", "0.01", "--slo-min-ops", "1", "--tsdb",
          d("tsdb"), "--profile", "--profile-artifact", d("art.json"),
          "--capture-dir", d("cap"), "--capture-p99-us", "1",
          "--watch", "depth[1]>=3", "--watch", "balance[2]<0",
          "--metrics-port", "0", "--health-file", d("hb.json"),
          "--health-every", "0.2", "--trace-out", d("trace.json")]
    want = _jax_matchout()
    got_on, prom, errs = _serve_run(on, tmp, len(want), tsdb=d("tsdb"))
    got_off, _, _ = _serve_run([], tmp, len(want))
    return tmp, got_on, got_off, prom, errs, want


def test_cli_flags_on_matches_off_and_jax(served):
    tmp, got_on, got_off, prom, errs, want = served
    msgs = harness_stream(N, seed=SEED, payout_opcode_bug=False,
                          validate=True)
    assert got_on == got_off == want and len(want) > 2 * N
    assert "audit_batches" in prom and "lat_e2e" in prom
    assert "AUDIT VIOLATION" not in errs
    assert "journal written to" in errs and "artifact written" in errs
    report = json.load(open(tmp / "report.json"))
    assert report["produced"] == len(msgs) and report["connections"] == 1
    assert report["slow_samples"]
    hb = json.load(open(tmp / "hb.json"))
    assert hb["closing"] and "slo_ok" in hb["metrics"]["gauges"]
    assert hb["metrics"]["counters"]["audit_violations"] == 0


def _main(fn, argv, capsys):
    rc = fn(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_query_tools_read_the_serve(served, capsys):
    tmp = served[0]
    d = lambda *p: str(tmp.joinpath(*p))       # noqa: E731
    jp = d("journal.bin")
    from kme_tpu_torch.telemetry import read_events

    evs = read_events(jp)
    oid = next(e["oid"] for e in evs if e["e"] == "fill")
    # trace: summary, one order, the oracle check, self-check
    for argv in ([jp], [jp, "--order", str(oid)], [jp, "--account", "2",
                                                   "--json"]):
        p = _main(PCLI.trace_main, argv, capsys)
        j = _main(JCLI.trace_main, argv, capsys)
        assert p[:2] == j[:2] and p[1] or p[2]
    lines = [dumps_order(m) for m in harness_stream(
        N, seed=SEED, payout_opcode_bug=False, validate=True)]
    inp = tmp / "in.jsonl"
    inp.write_text("\n".join(lines) + "\n")
    rc, _o, err = _main(PCLI.trace_main, [jp, "--verify", str(inp),
                                          "--book-slots", "128",
                                          "--max-fills", "32"], capsys)
    assert rc == 0 and "matches oracle replay" in err
    assert _main(PCLI.trace_main, ["--self-check"], capsys)[0] == 0
    # prof: the store, digests, the artifact, the captures
    for argv in ([d("tsdb"), "--csv"], [d("tsdb"), "--verify", "--json"],
                 ["--artifact", d("art.json")]):
        p = _main(PCLI.prof_main, argv, capsys)
        j = _main(JCLI.prof_main, argv, capsys)
        assert p[:2] == j[:2] and p[0] == 0, argv
    rc, out, _e = _main(PCLI.prof_main, ["--captures", d("cap")], capsys)
    assert rc == 0 and "watchpoint" in out and "p99_exemplar" in out
    # xray: a point query and the offline watchpoint at the end
    log_dir = d("ck", "broker-log")
    for argv in (["balance", "2", "--log-dir", log_dir, "--json"],
                 ["book", "1", "--log-dir", log_dir, "--json"],
                 ["eval", "depth[1]>=3", "--log-dir", log_dir, "--json"]):
        p = _main(PCLI.xray_main, argv + ["--book-slots", "128",
                                          "--max-fills", "32"], capsys)
        j = _main(JCLI.xray_main, argv + ["--book-slots", "128",
                                          "--max-fills", "32"], capsys)
        assert p[:2] == j[:2], argv
    # agg over the heartbeat, top once over it, events over the ck dir
    p = _main(PCLI.agg_main, [d("hb.json"), "--json"], capsys)
    j = _main(JCLI.agg_main, [d("hb.json"), "--json"], capsys)
    assert p[0] == j[0] == 0
    assert json.loads(p[1])["e2e"] == json.loads(j[1])["e2e"]
    rc, out, _e = _main(PCLI.top_main, ["--leader", d("hb.json"), "--once",
                                        "--tsdb", d("tsdb")], capsys)
    assert rc == 0 and "e2e" in out
    p = _main(PCLI.events_main, [d("ck"), "--json"], capsys)
    j = _main(JCLI.events_main, [d("ck"), "--json"], capsys)
    assert p[:2] == j[:2] and "lease.grant" in p[1]
    # the shared store holds the serve's, the consumer's and the
    # loadgen's samples
    from kme_tpu_torch.telemetry import tsdb

    assert {"serve", "consume", "loadgen"} <= {
        s[0] for s in tsdb.read_samples(d("tsdb"))}


def test_unported_modes_exit_naming_the_module(capsys, tmp_path):
    assert set(PSERVE.UNPORTED_FLAGS) == {"--kafka", "--group"}
    for fn, argv, mod in (
            (PCLI.trace_main, ["--cluster", "--state-root", "x"],
             "bridge/front.py"),
            (PCLI.xray_main, ["--cluster", "--state-root", "x"],
             "bridge/front.py"),
            (PCLI.xray_main, ["state", "--groups", "2", "--log-dir", "x"],
             "bridge/front.py"),
            (PCLI.prof_main, ["--diff", "a", "b"], "perfgate.py"),
            (PSERVE.main, ["--kafka", "k:1"], "bridge/kafka.py"),
            (PSERVE.main, ["--group", "0/2"], "bridge/front.py")):
        with pytest.raises(SystemExit) as e:
            fn(argv)
        assert e.value.code == 2
        assert mod in capsys.readouterr().err
    assert PSERVE.main(["--watch", "balance[1]"]) == 2
    assert "unparseable watch predicate" in capsys.readouterr().err
