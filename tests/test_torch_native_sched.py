"""The port's native C++ scheduler (native/sched.py over kme_host.cpp)
against the port's Python Scheduler, its semantics authority, and against
kme_tpu's NativeScheduler: identical plans — every column, barrier,
reject, segment boundary and program entry — on the workloads of
tests/test_native_sched.py, the same capacity and envelope errors, and
the id-space state round trip. Tolerance 0: every value is an integer.
"""

import dataclasses

import numpy as np
import pytest
import torch

import kme_tpu.opcodes as jop
from kme_tpu.native import sched as JNS
from kme_tpu.wire import OrderMsg as JaxOrder
from kme_tpu.workload import (cancel_heavy_stream, harness_stream,
                              zipf_symbol_stream)
from kme_tpu_torch.native.sched import NativeScheduler
from kme_tpu_torch.runtime.sequencer import (CapacityError, EnvelopeError,
                                             Scheduler, make_scheduler)
from kme_tpu_torch.wire import OrderMsg

torch.set_num_threads(1)


def _port(msgs):
    return [OrderMsg(**dataclasses.asdict(m)) for m in msgs]


def _same_schedule(a, b):
    assert set(a.cols) == set(b.cols)
    for k in a.cols:
        assert a.cols[k].dtype == b.cols[k].dtype, k
        assert np.array_equal(a.cols[k], b.cols[k]), f"col {k} differs"
    assert [dataclasses.astuple(x) for x in a.barriers] == \
        [dataclasses.astuple(x) for x in b.barriers]
    assert [x.msg_index for x in a.host_rejects] == \
        [x.msg_index for x in b.host_rejects]
    assert list(a.segment_steps) == list(b.segment_steps)
    assert a.program == b.program


def _same_maps(*schedulers):
    for m in ("aid_idx", "sid_lane", "oid_sid", "_rr_lane"):
        vals = [getattr(s, m) for s in schedulers]
        assert all(v == vals[0] for v in vals), m


def assert_same_plans(msgs, lanes, accounts, width, chunk=None):
    py = Scheduler(lanes, accounts, width)
    cc = NativeScheduler(lanes, accounts, width)
    jc = JNS.NativeScheduler(lanes, accounts, width)
    chunk = chunk or len(msgs)
    plans = []
    for lo in range(0, len(msgs), chunk):   # id maps persist across plans
        part = msgs[lo:lo + chunk]
        sp = py.plan(_port(part))
        sc = cc.plan(_port(part))
        sj = jc.plan([m.copy() for m in part])
        _same_schedule(sp, sc)
        _same_schedule(sc, sj)
        _same_maps(py, cc, jc)
        plans.append(sp)
    return plans


def test_make_scheduler_is_native():
    assert isinstance(make_scheduler(8, 16, 4), NativeScheduler)


@pytest.mark.parametrize("width", [0, 1, 8])
def test_plans_identical_harness(width):
    msgs = harness_stream(1500, seed=3, num_symbols=4, num_accounts=8,
                          payout_opcode_bug=False, validate=True)
    assert_same_plans(msgs, 8, 16, width)


def test_plans_identical_zipf_with_barriers():
    msgs = zipf_symbol_stream(2000, num_symbols=16, num_accounts=32, seed=9,
                              zipf_a=1.1, payout_per_mille=5)
    plan, = assert_same_plans(msgs, 16, 64, 8)
    assert plan.barriers and plan.host_rejects


def test_plans_identical_cancel_heavy_multi_batch():
    msgs = cancel_heavy_stream(1500, num_symbols=8, num_accounts=16, seed=4)
    assert_same_plans(msgs, 8, 32, 8, chunk=400)


def test_native_errors_match():
    for lanes, accounts, msgs, err, match in (
            (2, 2, [JaxOrder(action=jop.ADD_SYMBOL, sid=s) for s in range(3)],
             CapacityError, "symbol capacity"),
            (8, 1, [JaxOrder(action=jop.CREATE_BALANCE, aid=a)
                    for a in range(2)], CapacityError, "account capacity"),
            (8, 8, [JaxOrder(action=jop.BUY, oid=1, aid=1, sid=0,
                             price=2**31, size=1)], EnvelopeError, None)):
        for sch in (Scheduler(lanes, accounts, 0),
                    NativeScheduler(lanes, accounts, 0)):
            with pytest.raises(err, match=match):
                sch.plan(_port(msgs))
        with pytest.raises(Exception, match=match) as e:
            JNS.NativeScheduler(lanes, accounts, 0).plan(msgs)
        assert type(e.value).__name__ == err.__name__
    # the native scheduler checks the envelope before touching its maps
    cc = NativeScheduler(8, 8, 0)
    with pytest.raises(EnvelopeError, match="message 1"):
        cc.plan([OrderMsg(action=jop.CREATE_BALANCE, aid=3),
                 OrderMsg(action=jop.BUY, oid=1, aid=3, sid=0, price=1,
                          size=-2**31 - 1)])
    assert cc.aid_idx == {}
    with pytest.raises(ValueError, match="width"):
        NativeScheduler(8, 8, -1)


def test_plans_identical_extreme_ids():
    """Java-long id wrapping at the scheduler boundary: out-of-int64
    aids/sids/oids and INT64_MIN payout targets plan identically."""
    big = 2**63
    msgs = [
        JaxOrder(action=jop.CREATE_BALANCE, aid=big),      # wraps to -2^63
        JaxOrder(action=jop.CREATE_BALANCE, aid=-big),     # same account
        JaxOrder(action=jop.TRANSFER, aid=big, size=1000),
        JaxOrder(action=jop.ADD_SYMBOL, sid=2**63 - 1),
        JaxOrder(action=jop.BUY, oid=2**64 + 7, aid=big, sid=2**63 - 1,
                 price=50, size=2),
        JaxOrder(action=jop.CANCEL, oid=7, aid=big),       # wrapped route
        JaxOrder(action=jop.PAYOUT, sid=-big, size=97),    # abs(INT64_MIN)
        JaxOrder(action=2**70, aid=1),                     # unknown opcode
    ]
    assert_same_plans(msgs, 4, 4, 2)


def test_native_state_roundtrip():
    """The snapshot surface: export the id maps, import into a fresh
    native scheduler, and plans continue identically."""
    msgs = _port(harness_stream(800, seed=7, num_symbols=4, num_accounts=8,
                                payout_opcode_bug=False, validate=True))
    cc = NativeScheduler(8, 16, 8)
    cc.plan(msgs[:500])
    state = (cc.aid_idx, cc.sid_lane, cc.oid_sid, cc._rr_lane)
    assert state[3] != 0 and all(state[:3])

    cc2 = NativeScheduler(8, 16, 8)
    cc2.aid_idx, cc2.sid_lane, cc2.oid_sid, cc2._rr_lane = state
    py = Scheduler(8, 16, 8)
    py.plan(msgs[:500])
    _same_maps(py, cc2)
    _same_schedule(py.plan(msgs[500:]), cc2.plan(msgs[500:]))
    _same_maps(py, cc2)
