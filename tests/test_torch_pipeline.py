"""The port's native serving path on the CPU: `process_wire_buffer` and
pipelined `submit`/`collect` against the JAX package's, the port's Python
line builder and the port's serial path; a state carried in with
`load_numpy` after the reconstructor cached its lookup tables; and the
lanes engine planned by the native scheduler.

The JAX side runs its Pallas kernel in interpret mode on the CPU. Two
configurations only, each one interpret-mode compile: tests/
test_seq_engine.py's native-wire configuration in fixed mode, and
tests/test_torch_seq_java.py's java configuration. Tolerance 0: the
output is bytes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from kme_tpu.engine import lanes as JL
from kme_tpu.engine import seq as JSQ
from kme_tpu.runtime.seqsession import SeqSession as JaxSession
from kme_tpu.runtime.session import LaneSession as JaxLanes
from kme_tpu.wire import OrderMsg as JaxOrder
from kme_tpu.wire import WireBatch as JaxBatch
from kme_tpu.workload import harness_stream, zipf_symbol_stream
from kme_tpu_torch.engine import lanes as L
from kme_tpu_torch.engine import seq as SQ
from kme_tpu_torch.native.sched import NativeScheduler
from kme_tpu_torch.runtime.seqsession import (NativeSeqRouter, SeqRouter,
                                              SeqSession, measured_overlap_s)
from kme_tpu_torch.runtime.session import LaneSession
from kme_tpu_torch.wire import OrderMsg, WireBatch

torch.set_num_threads(1)

FIXED = dict(lanes=8, slots=128, accounts=128, max_fills=64, batch=256,
             pos_cap=1 << 11, fill_cap=1 << 13, probe_max=16)
JAVA = dict(FIXED, slots=256, pos_cap=1 << 13, fill_cap=1 << 14,
            compat="java", hbm_books=True)
CFGS = {"fixed": FIXED, "java": JAVA}
STREAMS = {
    # every opcode, barriers, invalid prices and unknown cancels
    "fixed": lambda: harness_stream(700, seed=5),
    # java's device surface: no barriers (the payout opcode bug keeps
    # PAYOUT an unknown opcode)
    "java": lambda: harness_stream(600, seed=3),
}
PIPE_STREAMS = {
    "fixed": lambda: zipf_symbol_stream(1500, num_symbols=8, num_accounts=32,
                                        seed=8, zipf_a=1.1,
                                        payout_per_mille=4),
    "java": lambda: zipf_symbol_stream(1000, num_symbols=8, num_accounts=32,
                                       seed=8, zipf_a=1.1),
}


def _port(msgs):
    return [OrderMsg(**dataclasses.asdict(m)) for m in msgs]


def _lines(r):
    buf, off, _ = r
    return [buf[off[k]:off[k + 1]].decode() for k in range(len(off) - 1)]


def _pipelined(ses, batches, depth):
    """submit up to `depth` batches ahead of collect; -> the bytes."""
    parts, pend = [], []
    for b in batches:
        pend.append(ses.submit(b))
        if len(pend) >= depth:
            parts.append(ses.collect(pend.pop(0)))
    while pend:
        parts.append(ses.collect(pend.pop(0)))
    return b"".join(p[0] for p in parts)


@pytest.fixture(scope="module")
def jax_pipe():
    """kme_tpu's bytes for each pipeline stream: serial through
    process_wire_buffer, and pipelined at depth 2 (the two are equal)."""
    out = {}
    for mode, make in PIPE_STREAMS.items():
        msgs = make()
        cfg = JSQ.SeqConfig(**CFGS[mode])
        B = cfg.batch
        serial = JaxSession(cfg)
        want = b"".join(serial.process_wire_buffer(
            [m.copy() for m in msgs[lo:lo + B]])[0]
            for lo in range(0, len(msgs), B))
        got = _pipelined(JaxSession(cfg), [
            JaxBatch.from_msgs([m.copy() for m in msgs[lo:lo + B]])
            for lo in range(0, len(msgs), B)], 2)
        assert got == want
        out[mode] = (msgs, want)
    return out


@pytest.mark.parametrize("mode", ["fixed", "java"])
def test_process_wire_buffer_equals_jax_and_python_lines(mode):
    """tests/test_seq_engine.py's native-wire equivalence, across three
    calls: the buffer equals kme_tpu's (bytes, offsets, line counts,
    reason codes), and its lines equal the port's Python line builder's
    and process_wire's."""
    msgs = STREAMS[mode]()
    cfg, jcfg = SQ.SeqConfig(**CFGS[mode]), JSQ.SeqConfig(**CFGS[mode])
    nat = SeqSession(cfg, device="cpu")
    assert isinstance(nat.router, NativeSeqRouter if mode == "fixed"
                      else SeqRouter)
    py = SeqSession(cfg, device="cpu")
    py._use_native_wire = False
    lines = SeqSession(cfg, device="cpu")
    jax = JaxSession(jcfg)
    for lo in range(0, len(msgs), 256):
        part = msgs[lo:lo + 256]
        got = nat.process_wire_buffer(_port(part))
        want = jax.process_wire_buffer([m.copy() for m in part])
        assert got[0] == want[0]
        assert np.array_equal(got[1], want[1])
        assert np.array_equal(got[2], want[2])
        assert np.array_equal(nat.last_reasons, jax.last_reasons)
        pl = py.process_wire(_port(part))
        assert _lines(got) == [ln for m in pl for ln in m]
        assert [len(m) for m in pl] == got[2].tolist()
        assert lines.process_wire(_port(part)) == pl
    assert nat.phases["recon_s"] > 0 and py.phases["recon_s"] == 0


def test_process_wire_beyond_int64_takes_the_python_lines():
    """An id beyond int64 cannot ride a WireBatch: process_wire_buffer
    returns None and process_wire builds the lines in Python, as
    kme_tpu does; the next call is native again."""
    big = [JaxOrder(action=100, aid=2**64 + 1),
           JaxOrder(action=101, aid=2**64 + 1, size=500),
           JaxOrder(action=102, sid=3),
           JaxOrder(action=0, oid=2**70, aid=2**64 + 1, sid=3, price=40,
                    size=2),
           JaxOrder(action=2, oid=2**70, aid=2**64 + 1)]
    ses = SeqSession(SQ.SeqConfig(**FIXED), device="cpu")
    jax = JaxSession(JSQ.SeqConfig(**FIXED))
    assert ses.process_wire_buffer(_port(big)) is None
    assert ses.process_wire(_port(big)) == \
        jax.process_wire([m.copy() for m in big])
    tail = harness_stream(200, seed=5)
    assert ses.process_wire(_port(tail)) == \
        jax.process_wire([m.copy() for m in tail])


@pytest.mark.parametrize("mode,depth", [("fixed", 1), ("fixed", 2),
                                        ("fixed", 3), ("java", 2)])
def test_submit_collect_equals_serial_and_jax(jax_pipe, mode, depth):
    """tests/test_seq_engine.py's pipelined == serial, barriers included:
    the port's submit/collect at `depth` gives kme_tpu's bytes and the
    port's serial bytes."""
    msgs, want = jax_pipe[mode]
    cfg = SQ.SeqConfig(**CFGS[mode])
    B = cfg.batch
    parts = [_port(msgs[lo:lo + B]) for lo in range(0, len(msgs), B)]
    serial = SeqSession(cfg, device="cpu")
    assert b"".join(serial.process_wire_buffer(p)[0] for p in parts) == want
    ses = SeqSession(cfg, device="cpu")
    # OrderMsg lists and WireBatches both submit
    batches = [WireBatch.from_msgs(p) if i % 2 else p
               for i, p in enumerate(parts)]
    assert _pipelined(ses, batches, depth) == want
    for k in SQ.state_keys(cfg):
        assert torch.equal(ses.state[k], serial.state[k]), k
    n = len(parts)
    assert ses.dispatches == n
    assert [w[:2] for w in ses.windows if w[0] == "submit"] == \
        [("submit", i) for i in range(n)]
    if depth == 1:
        assert ses.h2d_overlap_frac == 0.0
    else:
        assert 0 < ses.h2d_overlap_frac <= 1
    assert measured_overlap_s(ses.windows) >= 0.0
    assert all(ses.phases[k] > 0 for k in ("plan_s", "stage_s",
                                           "dispatch_s", "fetch_s",
                                           "recon_s"))


def test_forced_hint_takes_the_second_round(monkeypatch):
    """With the first fetch cut to one fill group per call, calls with
    more fills are fetched in a second round; the bytes do not change."""
    msgs = _port(zipf_symbol_stream(1500, num_symbols=3, num_accounts=60,
                                    seed=2, payout_per_mille=8))
    parts = [msgs[lo:lo + 256] for lo in range(0, len(msgs), 256)]
    cfg = SQ.SeqConfig(**FIXED)
    ref = SeqSession(cfg, device="cpu")
    want = b"".join(ref.process_wire_buffer(p)[0] for p in parts)
    ses = SeqSession(cfg, device="cpu")
    monkeypatch.setattr(ses, "_hint", lambda: 1)
    assert _pipelined(ses, parts, 2) == want
    assert ses.overflow_fetches > 0 and ref.overflow_fetches == 0


def test_collect_out_of_submit_order_raises():
    msgs = _port(zipf_symbol_stream(600, num_symbols=4, num_accounts=16,
                                    seed=2))
    ses = SeqSession(SQ.SeqConfig(**FIXED), device="cpu")
    h0 = ses.submit(msgs[:256])
    h1 = ses.submit(msgs[256:512])
    with pytest.raises(ValueError, match="out of submit order"):
        ses.collect(h1)
    ses.collect(h0)
    with pytest.raises(ValueError, match="out of submit order"):
        ses.collect(h0)
    ses.collect(h1)
    with pytest.raises(ValueError, match="int64"):
        ses.submit([OrderMsg(action=100, aid=2**64)])


def test_measured_overlap_s():
    # batch 0 in flight [1, 4]; collect 1 spans [3, 6]: 1 s overlapped
    w = [("submit", 0, 0.0, 1.0), ("submit", 1, 1.0, 2.0),
         ("collect", 0, 4.0, 5.0), ("collect", 1, 3.0, 6.0)]
    # collect 0 [4, 5] overlaps batch 1's flight [2, 3]: none
    assert measured_overlap_s(w) == pytest.approx(1.0)
    assert measured_overlap_s([]) == 0.0


def test_load_numpy_after_cached_luts_resumes_like_jax():
    """The reconstructor caches its lane/account lookup tables by the
    native maps' sizes and an epoch. A state carried in with load_numpy
    whose maps have the same sizes and other ids must not be served the
    stale tables: the resumed bytes equal kme_tpu's."""
    msgs = zipf_symbol_stream(700, num_symbols=6, num_accounts=40, seed=9,
                              payout_per_mille=6)
    cut = 380
    jses = JaxSession(JSQ.SeqConfig(**FIXED))
    jses.process_wire_buffer([m.copy() for m in msgs[:cut]])

    port = SeqSession(SQ.SeqConfig(**FIXED), device="cpu")
    # the same head under other ids: same map sizes, other contents
    other = [dataclasses.replace(m, oid=m.oid + 10**6, aid=m.aid + 5000,
                                 sid=m.sid + 77 if m.sid >= 0 else m.sid)
             for m in _port(msgs[:cut])]
    port.process_wire_buffer(other)
    r = jses.router
    assert (len(r.sid_lane), len(r.aid_idx)) == \
        (len(port.router.sid_lane), len(port.router.aid_idx))
    port.load_numpy({k: np.asarray(jses.state[k]) for k in jses.state},
                    r.aid_idx, r.sid_lane, r.oid_sid)
    for lo in range(cut, len(msgs), 160):
        part = msgs[lo:lo + 160]
        got = port.process_wire_buffer(_port(part))
        want = jses.process_wire_buffer([m.copy() for m in part])
        assert got[0] == want[0]


def test_lanes_with_native_scheduler_equals_jax():
    """LaneSession plans with the native scheduler; its MatchOut equals
    kme_tpu's LaneSession across calls, barriers included."""
    cfg = dict(lanes=8, slots=128, accounts=64, max_fills=32, steps=32)
    msgs = zipf_symbol_stream(900, num_symbols=6, num_accounts=40, seed=4,
                              payout_per_mille=6)
    port = LaneSession(L.LaneConfig(**cfg), width=8, device="cpu")
    assert isinstance(port.scheduler, NativeScheduler)
    jax = JaxLanes(JL.LaneConfig(**cfg), width=8)
    for lo in range(0, len(msgs), 300):
        part = msgs[lo:lo + 300]
        assert port.process_wire(_port(part)) == \
            jax.process_wire([m.copy() for m in part])
    assert port.scheduler.oid_sid == jax.scheduler.oid_sid
    assert port.scheduler._rr_lane == jax.scheduler._rr_lane
