"""The port's supervisor as a process (`python -m
kme_tpu_torch.bridge.supervise`) over `kme_tpu_torch.cli serve --device
cpu` children: the analogs of tests/test_supervise.py's two cases.

The serve child is SIGKILLed mid-stream, or its loop freezes (the port's
`serve.stuck` fault point, once across incarnations through
KME_FAULTS_STATE: the tick stops while the heartbeat thread lives); the
supervisor must detect it, restart from the newest checkpoint, and the
completed MatchOut stream must be the documented at-least-once shape: an
uninterrupted prefix up to the crash plus a replay from the last snapshot
offset, each line equal to what the JAX package's oracle gives.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest
import torch

from kme_tpu.oracle import OracleEngine
from kme_tpu.wire import dumps_order
from kme_tpu.workload import harness_stream
from kme_tpu_torch.bridge.broker import InProcessBroker
from kme_tpu_torch.bridge.consume import consume_lines
from kme_tpu_torch.bridge.tcp import TcpBroker

torch.set_num_threads(1)

TOPIC_IN = "MatchIn"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_broker(port: int, timeout: float = 90.0) -> TcpBroker:
    t0 = time.time()
    while True:
        try:
            b = TcpBroker("127.0.0.1", port)
            b.end_offset(TOPIC_IN)
            return b
        except Exception:
            if time.time() - t0 > timeout:
                raise
            time.sleep(0.2)


@pytest.mark.slow
def test_supervised_kill9_resume_byte_exact(tmp_path):
    msgs = harness_stream(400, seed=41, num_symbols=4, num_accounts=8,
                          payout_opcode_bug=False, validate=True)
    per_msg = []
    ora = OracleEngine("fixed", book_slots=64, max_fills=32)
    for m in msgs:
        per_msg.append([r.wire() for r in ora.process(m.copy())])
    flat = [ln for lines in per_msg for ln in lines]

    ck = str(tmp_path / "root")
    os.makedirs(ck)
    port = _free_port()
    env = dict(os.environ)
    sup = subprocess.Popen(
        [sys.executable, "-m", "kme_tpu_torch.bridge.supervise",
         "--checkpoint-dir", ck, "--stale-after", "15",
         "--max-restarts", "3", "--grace", "30", "--",
         "--listen", f"127.0.0.1:{port}", "--auto-provision",
         "--engine", "oracle", "--device", "cpu", "--batch", "20",
         "--checkpoint-every", "60", "--symbols", "8", "--accounts", "16",
         "--slots", "64", "--max-fills", "32",
         "--idle-exit", "6", "--health-every", "0.2"],
        env=env, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    hb = os.path.join(ck, "serve.health")
    try:
        broker = _wait_broker(port)
        for m in msgs:
            broker.produce(TOPIC_IN, None, dumps_order(m))

        # wait until the engine is past at least one checkpoint interval
        t0 = time.time()
        child_pid = None
        while True:
            try:
                with open(hb) as f:
                    h = json.load(f)
                if h["offset"] >= 100:
                    child_pid = h["pid"]
                    break
            except (OSError, ValueError):
                pass
            assert time.time() - t0 < 60, "engine made no progress"
            time.sleep(0.1)

        os.kill(child_pid, signal.SIGKILL)     # the failure

        # the supervisor must detect, restart, and the stream must
        # complete; serve idle-exits cleanly -> supervisor exits 0
        serr = ""
        try:
            _, serr = sup.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            sup.kill()
            _, serr = sup.communicate()
            pytest.fail(f"supervisor did not finish\n{serr[-3000:]}")
        assert sup.returncode == 0, serr[-3000:]
        assert "FAILURE DETECTED" in serr
        assert "restart 1/" in serr
    finally:
        if sup.poll() is None:
            sup.kill()

    # read the completed stream back from the durable broker logs
    b = InProcessBroker(persist_dir=os.path.join(ck, "broker-log"))
    got = list(consume_lines(b, follow=False))
    # at-least-once shape: flat(per_msg[:K]) + flat(per_msg[S:]) for the
    # crash point K and snapshot offset S (a checkpoint-every multiple,
    # S <= K <= len(msgs))
    n = len(msgs)
    lens = [len(x) for x in per_msg]
    starts = [0]
    for ln in lens:
        starts.append(starts[-1] + ln)
    okshape = False
    for S in range(0, n + 1):  # checkpoint offsets need not be
        # checkpoint_every multiples (partial fetches shift them)
        tail = [ln for lines in per_msg[S:] for ln in lines]
        if len(got) < len(tail) or got[len(got) - len(tail):] != tail:
            continue
        head_len = len(got) - len(tail)
        for K in range(S, n + 1):
            if starts[K] == head_len:
                okshape = got[:head_len] == flat[:head_len]
                break
        if okshape:
            break
    assert okshape, (
        f"stream is not an at-least-once prefix+replay composition "
        f"({len(got)} lines)")


@pytest.mark.slow
def test_supervised_stall_restart_byte_exact(tmp_path):
    """The HANG branch: the serve loop freezes mid-stream (tick stops
    advancing) while the heartbeat THREAD stays alive — process-exit
    and stale-mtime detection cannot fire. The supervisor must detect
    the frozen tick (--stall-after), restart from the newest
    checkpoint, and the completed stream must be the at-least-once
    prefix+replay shape, byte-exact."""
    msgs = harness_stream(400, seed=43, num_symbols=4, num_accounts=8,
                          payout_opcode_bug=False, validate=True)
    per_msg = []
    ora = OracleEngine("fixed", book_slots=64, max_fills=32)
    for m in msgs:
        per_msg.append([r.wire() for r in ora.process(m.copy())])

    ck = str(tmp_path / "root")
    os.makedirs(ck)
    port = _free_port()
    env = dict(os.environ)
    # stall exactly once, after ~150 messages (past >= 1 checkpoint):
    # the fire count persists across incarnations in KME_FAULTS_STATE
    env["KME_FAULTS"] = "serve.stuck:at=150"
    env["KME_FAULTS_STATE"] = str(tmp_path / "faults")
    sup = subprocess.Popen(
        [sys.executable, "-m", "kme_tpu_torch.bridge.supervise",
         "--checkpoint-dir", ck,
         # the heartbeat stays FRESH during the stall: only the tick
         # branch may fire (stale-after is set far beyond the test)
         "--stale-after", "120", "--stall-after", "4",
         "--max-restarts", "3", "--grace", "30", "--",
         "--listen", f"127.0.0.1:{port}", "--auto-provision",
         "--engine", "oracle", "--device", "cpu", "--batch", "20",
         "--checkpoint-every", "60", "--symbols", "8", "--accounts", "16",
         "--slots", "64", "--max-fills", "32",
         "--idle-exit", "6", "--health-every", "0.2"],
        env=env, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        broker = _wait_broker(port)
        for m in msgs:
            broker.produce(TOPIC_IN, None, dumps_order(m))
        serr = ""
        try:
            _, serr = sup.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            sup.kill()
            _, serr = sup.communicate()
            pytest.fail(f"supervisor did not finish\n{serr[-3000:]}")
        assert sup.returncode == 0, serr[-3000:]
        assert "serve loop stalled" in serr, serr[-3000:]
        assert "restart 1/" in serr
    finally:
        if sup.poll() is None:
            sup.kill()

    b = InProcessBroker(persist_dir=os.path.join(ck, "broker-log"))
    got = list(consume_lines(b, follow=False))
    n = len(msgs)
    okshape = False
    for S in range(0, n + 1):
        tail = [ln for lines in per_msg[S:] for ln in lines]
        if len(got) < len(tail) or got[len(got) - len(tail):] != tail:
            continue
        head = got[:len(got) - len(tail)]
        want_prefix = [ln for lines in per_msg for ln in lines]
        if head == want_prefix[:len(head)]:
            okshape = True
            break
    assert okshape, "stream is not the at-least-once prefix+replay shape"
