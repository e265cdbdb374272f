"""kme-torch-lint, the port's repo-native static analysis: the analogs of
tests/test_analysis.py with fixtures under `kme_tpu_torch/` paths in
torch's spellings (one violating and one clean source per rule ID), the
baseline semantics, the lock rules on synthetic modules, the runtime
lockcheck recorder (and its one-recorder-per-process rule beside the JAX
package's), the ctypes-boundary validators; that every scope table names
functions that exist in the port and THREADED_MODULES is the port's
threaded surface by AST; and that `kme-torch-lint --gate` is clean on
this repo against LINT_BASELINE_TORCH.json and fails on each rule's
planted violation."""

import ast
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from kme_tpu_torch.analysis import (Finding, load_baseline, repo_root,
                                    save_baseline, split_new)
from kme_tpu_torch.analysis import cli, lockcheck, lockgraph, rules

ROOT = repo_root()


@pytest.fixture(scope="module", autouse=True)
def _port_lockcheck_gate():
    """When this process runs the port's recorder (KME_LOCKCHECK=1 with
    no JAX package's recorder in front of it), fail on any lock-order
    inversion it observed."""
    yield
    if lockcheck.enabled():
        lockcheck.assert_clean()


# ---------------------------------------------------------------------------
# rule fixtures: (rule id, path the scope tables key on, violating
# source, clean source). Each violating snippet must fire EXACTLY its
# rule; each clean one must produce no findings at all.

FIXTURES = [
    ("KME-H001", "kme_tpu_torch/bridge/service.py", """
class MatchService:
    def _step_pipelined(self):
        out = self.dev_out.cpu()
""", """
class MatchService:
    def _collect_one(self):
        out = self.dev_out.cpu()
"""),
    ("KME-H001", "kme_tpu_torch/runtime/seqsession.py", """
import torch
class SeqSession:
    def submit(self, batch):
        torch.cuda.synchronize()
""", """
import torch
class SeqSession:
    def collect(self):
        torch.cuda.synchronize()
"""),
    ("KME-H001", "kme_tpu_torch/runtime/seqsession.py", """
class SeqSession:
    def _plan(self, msgs):
        n = self.fill_total.item()
        rows = self.dev_rows.to("cpu")
        ids = self.dev_ids.tolist()
""", """
class SeqSession:
    def _plan(self, msgs):
        rows = self.dev_rows.to(self.device, non_blocking=True)
"""),
    # KME-T001's check, folded into H001: a Python branch on a torch
    # expression inside the window (outside it, the branch is legal)
    ("KME-H001", "kme_tpu_torch/parallel/seqmesh.py", """
import torch
class SeqMeshSession:
    def _stage_and_dispatch(self, k):
        if torch.any(self.err[k] != 0):
            return
""", """
import torch
class SeqMeshSession:
    def _collect_merge(self, k):
        if torch.any(self.err[k] != 0):
            return
"""),
    ("KME-H002", "kme_tpu_torch/runtime/seqsession.py", """
class SeqSession:
    def _plan(self, msgs):
        self.journal_f.flush()
""", """
class SeqSession:
    def _fetch(self):
        self.journal_f.flush()
"""),
    ("KME-D001", "kme_tpu_torch/bridge/broker.py", """
import time
class Broker:
    def _load_topic(self, name):
        stamp = time.time()
""", """
import time
class Broker:
    def _segment_stats(self):
        stamp = time.time()
"""),
    ("KME-C001", "kme_tpu_torch/bridge/broker.py", """
import time
class Broker:
    def fetch(self, name, offset):
        t0 = time.monotonic()
""", """
import time
class Broker:
    def _segment_stats(self):
        t0 = time.monotonic()
"""),
    ("KME-D002", "kme_tpu_torch/telemetry/journal.py", """
import random
def iter_events(path):
    jitter = random.random()
""", """
import random
def write_events(path):
    jitter = random.random()
"""),
    ("KME-D002", "kme_tpu_torch/bridge/front.py", """
import torch
def route_line(line, n):
    return int(torch.randint(0, n, (1,), dtype=torch.int64))
""", """
import torch
def probe_lines(line, n):
    return int(torch.randint(0, n, (1,), dtype=torch.int64))
"""),
    ("KME-D002", "kme_tpu_torch/parallel/seqmesh.py", """
import torch
def plan_rebalance(loads):
    torch.manual_seed(0)
    return torch.randperm(len(loads))
""", """
import torch
def plan_rebalance(loads):
    return sorted(range(len(loads)), key=loads.__getitem__)
"""),
    ("KME-E001", "kme_tpu_torch/telemetry/events.py", """
import uuid
def make_event(source, seq, kind, ts_us):
    return {"src": source, "seq": seq, "kind": kind,
            "id": uuid.uuid4().hex}
""", """
import uuid
def write_merged(events, path):
    tmp = path + uuid.uuid4().hex
"""),
    ("KME-E001", "kme_tpu_torch/telemetry/events.py", """
import time
class EventLog:
    def emit(self, kind):
        fallback = time.time
""", """
import time
class EventLog:
    def flush(self):
        self._last_flush = time.time()
"""),
    ("KME-E001", "kme_tpu_torch/telemetry/events.py", """
import torch
def order_key(ev):
    return (ev["src"], int(torch.rand(1, dtype=torch.float32)))
""", """
def order_key(ev):
    return (ev["src"], ev["seq"])
"""),
    ("KME-T002", "kme_tpu_torch/ops/newop.py", """
import torch
def pad(n):
    return torch.zeros((n,))
""", """
import torch
def pad(n):
    return torch.zeros((n,), dtype=torch.int32)
"""),
    ("KME-T002", "kme_tpu_torch/engine/newkernel.py", """
import torch
def lanes(n, dev):
    return torch.arange(n, device=dev), torch.full((n,), 7, device=dev)
""", """
import torch
def lanes(n, dev):
    return (torch.arange(n, dtype=torch.int64, device=dev),
            torch.full((n,), 7, dtype=torch.int32, device=dev))
"""),
    ("KME-T003", "kme_tpu_torch/engine/newkernel.py", """
import torch
def widen(x):
    return x.to(float)
""", """
import torch
def widen(x):
    return x.to(torch.int64)
"""),
    ("KME-T003", "kme_tpu_torch/ops/newop.py", """
import torch
def ratio(a, b):
    return a.to(torch.float64) / b
""", """
import torch
def ratio(a, b):
    return torch.div(a, b, rounding_mode="floor")
"""),
    ("KME-T003", "kme_tpu_torch/engine/newkernel.py", """
import numpy as np
def widen(x):
    return np.zeros(4, dtype=int) + x.astype(int)
""", """
import numpy as np
def widen(x):
    return np.zeros(4, dtype=np.int32) + x.astype(np.int32)
"""),
]


@pytest.mark.parametrize(
    "rule,relpath,bad,good",
    FIXTURES, ids=[f"{r}-{i}" for i, (r, *_) in enumerate(FIXTURES)])
def test_rule_fires_on_violation_only(rule, relpath, bad, good):
    got = {f.rule for f in rules.analyze_file(relpath, bad)}
    assert got == {rule}, f"want exactly {{{rule}}}, got {got}"
    clean = rules.analyze_file(relpath, good)
    assert clean == [], [f.render() for f in clean]


def test_syntax_error_is_a_finding_not_a_crash():
    got = rules.analyze_file("kme_tpu_torch/engine/broken.py", "def f(:\n")
    assert [f.rule for f in got] == ["KME-E000"]


def test_t002_positional_dtype_and_preserving_ctors_are_clean():
    src = """
import numpy as np
import torch
def f(existing, rows):
    a = np.asarray(existing)          # dtype-preserving: clean
    b = torch.tensor(rows)            # dtype-preserving: clean
    c = np.zeros(4, np.int32)         # positional dtype: clean
    d = torch.tensor([1, 2])          # fresh literals, no dtype: BAD
    return a, b, c, d
"""
    got = rules.analyze_file("kme_tpu_torch/ops/x.py", src)
    assert [(f.rule, "torch.tensor" in f.message) for f in got] \
        == [("KME-T002", True)]


def test_t001_is_dropped_branches_outside_the_window_are_clean():
    """Eager torch has no tracer: a Python branch on a tensor in engine/
    or ops/ is legal (the parity replica's loops are such branches)."""
    src = """
import torch
def step(state, price):
    while bool((state["err"] == 0) & torch.any(price > 0)):
        price = price - 1
    if torch.sum(price) > 0:
        return state
"""
    assert rules.analyze_file("kme_tpu_torch/engine/newkernel.py",
                              src) == []
    assert "KME-T001" not in rules.RULES


# ---------------------------------------------------------------------------
# the scope tables and the threaded surface are the port's

SCOPE_TABLES = ("HOT_SCOPES", "REPLAY_SCOPES", "TRACE_SCOPES", "XRAY_SCOPES",
                "FEED_SCOPES", "CLOCK_SCOPES", "EVENTS_SCOPES",
                "PROFILER_SCOPES")


def _defined_names(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    return {n.name for n in ast.walk(tree) if isinstance(
        n, (ast.FunctionDef, ast.AsyncFunctionDef))}


@pytest.mark.parametrize("table", SCOPE_TABLES)
def test_scope_tables_name_functions_of_the_port(table):
    scopes = getattr(rules, table)
    assert scopes
    for rel, names in scopes.items():
        assert rel.startswith("kme_tpu_torch/"), rel
        path = os.path.join(ROOT, rel)
        assert os.path.exists(path), rel
        missing = sorted(set(names) - _defined_names(path))
        assert not missing, f"{rel}: {missing}"
    for d in rules.TRACED_DIRS:
        assert os.path.isdir(os.path.join(ROOT, d)), d


def test_threaded_modules_are_the_port_threaded_surface():
    """Every port module that creates a Lock/RLock/Condition or spawns a
    Thread, by AST — and nothing else."""
    found = set()
    pkg = os.path.join(ROOT, "kme_tpu_torch")
    for dirpath, dirnames, files in os.walk(pkg):
        dirnames[:] = [d for d in dirnames
                       if d not in ("_build", "__pycache__")]
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Call):
                    name = (node.func.attr if isinstance(
                        node.func, ast.Attribute) else getattr(
                        node.func, "id", None))
                    if name in ("Lock", "RLock", "Condition", "Thread"):
                        found.add(os.path.relpath(path, ROOT).replace(
                            os.sep, "/"))
    assert set(lockgraph.THREADED_MODULES) == found
    assert len(lockgraph.THREADED_MODULES) == len(found) == 13


# ---------------------------------------------------------------------------
# lock rules on synthetic threaded modules


def _write_module(tmp_path, rel, src):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(src)
    return rel


def test_l001_lock_order_cycle(tmp_path):
    rel = _write_module(tmp_path, "m/cyc.py", """
import threading

class A:
    def __init__(self):
        self.l1 = threading.Lock()
        self.l2 = threading.Lock()
    def fwd(self):
        with self.l1:
            with self.l2:
                pass
    def rev(self):
        with self.l2:
            with self.l1:
                pass
""")
    got = lockgraph.analyze_modules(str(tmp_path), (rel,))
    assert [f.rule for f in got] == ["KME-L001"]
    assert "l1" in got[0].message and "l2" in got[0].message


def test_l001_clean_when_orders_agree(tmp_path):
    rel = _write_module(tmp_path, "m/ok.py", """
import threading

class A:
    def __init__(self):
        self.l1 = threading.Lock()
        self.l2 = threading.Lock()
    def fwd(self):
        with self.l1:
            with self.l2:
                pass
    def also_fwd(self):
        with self.l1:
            with self.l2:
                pass
""")
    assert lockgraph.analyze_modules(str(tmp_path), (rel,)) == []


def test_l001_cycle_through_held_call(tmp_path):
    rel = _write_module(tmp_path, "m/call.py", """
import threading

class A:
    def __init__(self):
        self.l1 = threading.Lock()
        self.l2 = threading.Lock()
    def fwd(self):
        with self.l1:
            self._inner()
    def _inner(self):
        with self.l2:
            pass
    def rev(self):
        with self.l2:
            with self.l1:
                pass
""")
    got = lockgraph.analyze_modules(str(tmp_path), (rel,))
    assert [f.rule for f in got] == ["KME-L001"]


def test_l002_unlocked_cross_thread_store(tmp_path):
    rel = _write_module(tmp_path, "m/race.py", """
import threading

class W:
    def __init__(self):
        self.lock = threading.Lock()
        self.n = 0
        threading.Thread(target=self._work).start()
    def _work(self):
        self.n += 1
    def bump(self):
        self.n += 2
""")
    got = lockgraph.analyze_modules(str(tmp_path), (rel,))
    assert [f.rule for f in got] == ["KME-L002"]
    assert "self.n" in got[0].message


def test_l002_clean_under_common_lock_and_ctor_only(tmp_path):
    rel = _write_module(tmp_path, "m/ok2.py", """
import threading

class W:
    def __init__(self):
        self.lock = threading.Lock()
        self.n = 0
        self._restore()               # ctor-only helper: exempt
        threading.Thread(target=self._work).start()
    def _restore(self):
        self.n = -1
    def _work(self):
        with self.lock:
            self.n += 1
    def bump(self):
        with self.lock:
            self.n += 2
    def bump_via_helper(self):
        with self.lock:
            self._locked_bump()
    def _locked_bump(self):
        self.n += 3                    # guaranteed-caller-held: clean
""")
    got = lockgraph.analyze_modules(str(tmp_path), (rel,))
    assert got == [], [f.render() for f in got]


def test_l002_condition_aliases_its_wrapped_lock(tmp_path):
    rel = _write_module(tmp_path, "m/cond.py", """
import threading

class W:
    def __init__(self):
        self.lock = threading.Lock()
        self.data = threading.Condition(self.lock)
        self.n = 0
        threading.Thread(target=self._work).start()
    def _work(self):
        with self.data:
            self.n += 1
    def bump(self):
        with self.lock:
            self.n += 2
""")
    got = lockgraph.analyze_modules(str(tmp_path), (rel,))
    assert got == [], [f.render() for f in got]


# ---------------------------------------------------------------------------
# baseline semantics


def _mk(rule="KME-T002", path="kme_tpu_torch/x.py", line=10, scope="f",
        snippet="a = torch.zeros((4,))"):
    return Finding(rule=rule, path=path, line=line, col=0, scope=scope,
                   message="m", snippet=snippet)


def test_fingerprint_is_line_shift_stable():
    assert _mk(line=10).fingerprint == _mk(line=99).fingerprint
    assert _mk().fingerprint != _mk(rule="KME-T003").fingerprint
    assert _mk().fingerprint != _mk(snippet="b = 1").fingerprint


def test_baseline_roundtrip_and_gate_budget(tmp_path):
    base = str(tmp_path / "LINT_BASELINE_TORCH.json")
    save_baseline(base, [_mk(), _mk(line=30)])   # same fp, count 2
    table = load_baseline(base)
    assert len(table) == 1
    (ent,) = table.values()
    assert ent["count"] == 2
    # two occurrences grandfathered, the third is new
    new, known = split_new([_mk(), _mk(line=30), _mk(line=50)], table)
    assert (len(new), len(known)) == (1, 2)
    # notes survive a rewrite
    table[_mk().fingerprint]["note"] = "accepted"
    with open(base, "w") as f:
        json.dump({"version": 1, "findings": table}, f)
    save_baseline(base, [_mk()])
    assert load_baseline(base)[_mk().fingerprint]["note"] == "accepted"


# ---------------------------------------------------------------------------
# runtime lockcheck


@pytest.fixture
def tracked_locks():
    # `over`: under KME_LOCKCHECK=1 the JAX package's recorder may be in
    # front; these tests need the port's own
    was = lockcheck.enabled()
    lockcheck.install(over=True)
    lockcheck.reset()
    yield
    lockcheck.reset()
    if not was:
        lockcheck.uninstall()


def test_lockcheck_detects_inversion(tracked_locks):
    a, b = threading.Lock(), threading.Lock()

    def fwd():
        with a:
            with b:
                pass

    def rev():
        with b:
            with a:
                pass

    for fn in (fwd, rev):
        t = threading.Thread(target=fn)
        t.start()
        t.join()
    assert len(lockcheck.inversions()) == 1
    with pytest.raises(AssertionError):
        lockcheck.assert_clean()
    lockcheck.reset()


def test_lockcheck_consistent_order_is_clean(tracked_locks):
    a, b = threading.Lock(), threading.Lock()
    for _ in range(3):
        with a:
            with b:
                pass
    assert lockcheck.inversions() == []
    lockcheck.assert_clean()


def test_lockcheck_condition_and_rlock(tracked_locks):
    lk = threading.Lock()
    cond = threading.Condition(lk)
    done = []

    def waiter():
        with cond:
            cond.wait(timeout=5)
            done.append(1)

    t = threading.Thread(target=waiter)
    t.start()
    # wait() must have released the tracked lock or this deadlocks
    import time
    time.sleep(0.1)
    with cond:
        cond.notify()
    t.join(timeout=5)
    assert done == [1]
    r = threading.RLock()
    with r:
        with r:          # reentry must not self-edge
            pass
    assert lockcheck.inversions() == []


def test_lockcheck_condition_over_default_rlock(tracked_locks):
    # Condition() wraps an RLock proxy: without a real _is_owned the
    # stdlib fallback (acquire(False)/release) reenters the owned
    # proxy, concludes not-owned, and wait() raises spuriously
    import time
    cond = threading.Condition()
    done = []

    def waiter():
        with cond:
            cond.wait(timeout=5)
            done.append(1)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.1)
    with cond:
        cond.notify()
    t.join(timeout=5)
    assert done == [1]


_RECORDERS = r"""
import sys, threading
order = sys.argv[1]
if order == "both":
    import kme_tpu
import kme_tpu_torch
from kme_tpu_torch.analysis import lockcheck
print(threading.Lock.__module__, lockcheck.enabled())
a, b = threading.Lock(), threading.Lock()
with a:
    with b:
        pass
with b:
    with a:
        pass
if order == "both":
    from kme_tpu.analysis import lockcheck as jl
    print(len(jl.inversions()), len(lockcheck.inversions()))
else:
    print(len(lockcheck.inversions()))
"""


def test_lockcheck_one_recorder_per_process():
    """KME_LOCKCHECK=1: the port alone installs its recorder; imported
    after the JAX package, it leaves that package's recorder in place
    (no second wrap), which then sees the port's lock orders."""
    env = dict(os.environ, KME_LOCKCHECK="1", PYTHONPATH=ROOT,
               JAX_PLATFORMS="cpu")
    out = {}
    for order in ("port", "both"):
        r = subprocess.run([sys.executable, "-c", _RECORDERS, order],
                           capture_output=True, text=True, cwd=ROOT,
                           env=env, timeout=120)
        assert r.returncode == 0, r.stderr
        out[order] = r.stdout.split("\n")[:2]
    assert out["port"] == ["kme_tpu_torch.analysis.lockcheck True", "1"]
    assert out["both"] == ["kme_tpu.analysis.lockcheck False", "1 0"]


# ---------------------------------------------------------------------------
# ctypes boundary validators


def test_check_buffer_rejections():
    from kme_tpu_torch.native import BoundaryError, check_buffer

    ok = np.zeros(8, np.int64)
    assert check_buffer("x", ok, np.int64, 8) is ok
    with pytest.raises(BoundaryError, match="dtype"):
        check_buffer("x", np.zeros(8, np.int32), np.int64, 8)
    with pytest.raises(BoundaryError, match="overread"):
        check_buffer("x", np.zeros(4, np.int64), np.int64, 8)
    with pytest.raises(BoundaryError, match="1-D"):
        check_buffer("x", np.zeros((2, 4), np.int64), np.int64)
    with pytest.raises(BoundaryError, match="contiguous"):
        check_buffer("x", np.zeros(16, np.int64)[::2], np.int64, 8)
    with pytest.raises(BoundaryError, match="ndarray"):
        check_buffer("x", [1, 2, 3], np.int64)


# ---------------------------------------------------------------------------
# self-run: the port must gate clean against its baseline


def test_repo_gates_clean_against_baseline():
    """Both entry points: the module and the port's CLI subcommand. Every
    grandfathered finding carries a note, and the baseline holds only
    findings that still exist."""
    assert os.path.exists(os.path.join(ROOT, "LINT_BASELINE_TORCH.json"))
    for argv in (["-m", "kme_tpu_torch.analysis.cli", "--gate", "--no-ruff"],
                 ["-m", "kme_tpu_torch.cli", "lint", "--gate"]):
        proc = subprocess.run(
            [sys.executable] + argv, capture_output=True, text=True,
            cwd=ROOT, timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert ", 0 new" in proc.stdout
    base = load_baseline(os.path.join(ROOT, "LINT_BASELINE_TORCH.json"))
    assert base and all(e.get("note") for e in base.values())
    live = {f.fingerprint for f in cli.run_rules(ROOT, [])}
    assert set(base) <= live


@pytest.mark.parametrize("rule,relpath,bad", [
    (r, p, b) for r, p, b, _ in FIXTURES],
    ids=[f"{r}-{i}" for i, (r, *_) in enumerate(FIXTURES)])
def test_gate_fails_on_new_violation(tmp_path, capsys, rule, relpath, bad):
    """A planted violation of each rule, linted by path and gated against
    the real baseline: it is not grandfathered, so the gate trips."""
    planted = tmp_path / relpath
    planted.parent.mkdir(parents=True)
    planted.write_text(bad)
    rc = cli.main(["--gate", "--no-ruff", str(planted)])
    out = capsys.readouterr().out
    assert rc == 1, out
    assert rule in out


def test_gate_fails_on_planted_violation_in_a_subprocess(tmp_path):
    bad = tmp_path / "kme_tpu_torch" / "engine" / "planted.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import torch\n"
                   "def f(n):\n"
                   "    return torch.zeros((n,))\n")
    proc = subprocess.run(
        [sys.executable, "-m", "kme_tpu_torch.cli", "lint", "--gate",
         "--no-ruff", str(bad)],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "KME-T002" in proc.stdout
