"""The port's SeqSession (the slice end to end, on CPU tensors) against
the JAX package's SeqSession and the fixed-mode scalar oracle.

The scenario streams of tests/test_seq_engine.py run through all three.
MatchOut lines (`process_wire` and `process`), `export_state` and
`export_canonical` must be equal, with tolerance 0: every value is an
integer. A state carried from the JAX session into the port
(`load_numpy`) must compute the next batch exactly as the JAX session
does.
"""

import dataclasses

import numpy as np
import pytest
import torch

import kme_tpu.opcodes as jop
from kme_tpu.engine import seq as JSQ
from kme_tpu.oracle import OracleEngine
from kme_tpu.runtime.seqsession import SeqSession as JaxSession
from kme_tpu.runtime.session import LaneEngineError as JaxEngineError
from kme_tpu.wire import OrderMsg as JaxOrder
from kme_tpu.workload import harness_stream, zipf_symbol_stream
from kme_tpu_torch.engine import seq as SQ
from kme_tpu_torch.runtime.seqsession import SeqSession
from kme_tpu_torch.runtime.session import LaneEngineError
from kme_tpu_torch.wire import OrderMsg, wire_lines

torch.set_num_threads(1)

CFG = dict(lanes=8, slots=128, accounts=128, max_fills=32, batch=128,
           pos_cap=1 << 11, fill_cap=1 << 12, probe_max=16)
WIDE = dict(lanes=8, slots=128, accounts=128, max_fills=64, batch=256,
            pos_cap=1 << 11, fill_cap=1 << 13, probe_max=16)
# deep books (tests/test_seq_engine.py's hbm_books case): two rows per
# side, so multi-row blocks are swept, searched and filled
DEEP = dict(WIDE, slots=256, hbm_books=True)


def _port(msgs):
    return [OrderMsg(**dataclasses.asdict(m)) for m in msgs]


def _scenario():
    """Every opcode incl. barriers, double cancel, unknown oid, payout
    YES/NO, remove + re-add, negative-sid add, bad action."""
    O = JaxOrder
    msgs = []
    for a in range(4):
        msgs.append(O(action=jop.CREATE_BALANCE, aid=a))
        msgs.append(O(action=jop.TRANSFER, aid=a, size=100000))
    for s in (0, 1, 2):
        msgs.append(O(action=jop.ADD_SYMBOL, sid=s))
    msgs += [
        O(action=jop.BUY, oid=10, aid=0, sid=0, price=40, size=5),
        O(action=jop.BUY, oid=11, aid=1, sid=0, price=40, size=3),
        O(action=jop.SELL, oid=12, aid=2, sid=0, price=35, size=6),
        O(action=jop.SELL, oid=13, aid=3, sid=1, price=60, size=4),
        O(action=jop.BUY, oid=14, aid=0, sid=1, price=65, size=2),
        O(action=jop.CANCEL, oid=13, aid=3),
        O(action=jop.CANCEL, oid=13, aid=3),
        O(action=jop.CANCEL, oid=999, aid=0),
        O(action=jop.BUY, oid=15, aid=1, sid=2, price=50, size=4),
        O(action=jop.BUY, oid=16, aid=2, sid=2, price=50, size=2),
        O(action=jop.SELL, oid=17, aid=3, sid=2, price=45, size=9),
        O(action=jop.PAYOUT, sid=2, size=97),
        O(action=jop.PAYOUT, sid=-1, size=97),
        O(action=jop.REMOVE_SYMBOL, sid=0),
        O(action=jop.ADD_SYMBOL, sid=0),
        O(action=jop.BUY, oid=18, aid=0, sid=0, price=30, size=1),
        O(action=jop.ADD_SYMBOL, sid=-3),
        O(action=jop.TRANSFER, aid=9, size=5),
        O(action=99, oid=0, aid=0),
    ]
    return msgs


def _same_account_runs():
    O = JaxOrder
    msgs = [O(action=jop.CREATE_BALANCE, aid=1),
            O(action=jop.TRANSFER, aid=1, size=10**6),
            O(action=jop.CREATE_BALANCE, aid=2),
            O(action=jop.TRANSFER, aid=2, size=10**6),
            O(action=jop.ADD_SYMBOL, sid=5)]
    oid = 100
    for k in range(40):
        msgs.append(O(action=jop.BUY, oid=oid, aid=1, sid=5,
                      price=40 + (k % 7), size=1 + (k % 5)))
        oid += 1
        msgs.append(O(action=jop.SELL, oid=oid, aid=2, sid=5,
                      price=38 + (k % 9), size=1 + (k % 4)))
        oid += 1
        if k % 3 == 0:
            msgs.append(O(action=jop.CANCEL, oid=oid - 2, aid=1))
    return msgs


def _max_fills_envelope():
    O = JaxOrder
    msgs = [O(action=jop.CREATE_BALANCE, aid=1),
            O(action=jop.TRANSFER, aid=1, size=10**6),
            O(action=jop.CREATE_BALANCE, aid=2),
            O(action=jop.TRANSFER, aid=2, size=10**6),
            O(action=jop.ADD_SYMBOL, sid=1)]
    for k in range(3):
        msgs.append(O(action=jop.SELL, oid=10 + k, aid=1, sid=1, price=50,
                      size=2))
    # sweeps 3 makers -> capacity REJECT; then a 2-maker sweep passes
    msgs.append(O(action=jop.BUY, oid=20, aid=2, sid=1, price=55, size=6))
    msgs.append(O(action=jop.BUY, oid=21, aid=2, sid=1, price=55, size=4))
    return msgs


def _slots_envelope(n=129):
    O = JaxOrder
    msgs = [O(action=jop.CREATE_BALANCE, aid=1),
            O(action=jop.TRANSFER, aid=1, size=10**8),
            O(action=jop.ADD_SYMBOL, sid=1)]
    for k in range(n):   # the last one overflows the side
        msgs.append(O(action=jop.BUY, oid=100 + k, aid=1, sid=1,
                      price=1 + (k % 30), size=1))
    return msgs


SCENARIOS = {
    "end_to_end": (_scenario, CFG, {}),
    "same_account_runs": (_same_account_runs, CFG, {}),
    "max_fills_envelope": (_max_fills_envelope, dict(CFG, max_fills=2),
                           {"rej_capacity": 1, "trades_ok": 4}),
    "slots_envelope": (_slots_envelope, CFG, {"rej_capacity": 1}),
    "harness": (lambda: harness_stream(600, seed=7), WIDE, {}),
    "zipf": (lambda: zipf_symbol_stream(500, num_symbols=6, num_accounts=24,
                                        seed=3, payout_per_mille=8),
             WIDE, {}),
    # both deep cases stay within two batches: one JAX compile between them
    "deep_zipf": (lambda: zipf_symbol_stream(
        440, num_symbols=6, num_accounts=24, seed=3), DEEP, {}),
    "deep_slots_envelope": (lambda: _slots_envelope(257), DEEP,
                            {"rej_capacity": 1}),
}


def _assert_canon_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if a[k] is None:
            assert b[k] is None
        else:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_session_matches_jax_and_oracle(name):
    make, kw, want_metrics = SCENARIOS[name]
    msgs = make()
    jcfg, cfg = JSQ.SeqConfig(**kw), SQ.SeqConfig(**kw)
    jses = JaxSession(jcfg)
    ora = OracleEngine("fixed", book_slots=kw["slots"],
                       max_fills=kw["max_fills"])
    port = SeqSession(cfg, device="cpu")
    port_rec = SeqSession(cfg, device="cpu")

    want_wire = jses.process_wire([m.copy() for m in msgs])
    got_wire = port.process_wire(_port(msgs))
    got_rec = port_rec.process(_port(msgs))
    for i, m in enumerate(msgs):
        oracle = [r.wire() for r in ora.process(m.copy())]
        assert want_wire[i] == oracle, f"JAX vs oracle at message {i}"
        assert got_wire[i] == oracle, f"port wire path at message {i}: {m}"
        assert list(wire_lines(got_rec[i])) == oracle, \
            f"port record path at message {i}: {m}"
    np.testing.assert_array_equal(port.last_reasons, jses.last_reasons)

    exp = port.export_state()
    assert exp == jses.export_state()
    assert exp == port_rec.export_state()
    assert exp["balances"] == dict(ora.balances)
    assert exp["positions"] == dict(ora.positions)
    assert exp["orders"] == {
        oid: {"aid": r.aid, "sid": r.sid, "price": r.price, "size": r.size,
              "is_buy": r.action == jop.BUY}
        for oid, r in ora.orders.items()}
    assert set(exp["books"]) == {k // 2 for k in ora.books}
    _assert_canon_equal(SQ.export_canonical(cfg, port.state),
                        JSQ.export_canonical(jcfg, jses.state))
    for k in SQ.state_keys(cfg):
        assert np.array_equal(port.state[k].numpy(),
                              np.asarray(jses.state[k])), k

    met = port.metrics()
    assert met == jses.metrics()
    assert port.histograms() == jses.histograms()
    for k, v in want_metrics.items():
        assert met[k] == v, k


def test_port_session_hash_full_error_matches_jax():
    """>128 distinct positions at probe_max=1 trip the sticky HASH_FULL
    error at the same call in both packages, with equal output before it
    and equal state after it."""
    kw = dict(CFG, max_fills=8, pos_cap=128, probe_max=1)
    O = JaxOrder
    pre = [O(action=jop.CREATE_BALANCE, aid=0),
           O(action=jop.TRANSFER, aid=0, size=10**9)]
    for a in range(1, 100):
        pre.append(O(action=jop.CREATE_BALANCE, aid=a))
        pre.append(O(action=jop.TRANSFER, aid=a, size=10**9))
    for s in range(8):
        pre.append(O(action=jop.ADD_SYMBOL, sid=s))
    calls, oid = [], 1000
    for s in range(8):
        batch = []
        for a in range(32):
            batch.append(O(action=jop.SELL, oid=oid, aid=a % 99, sid=s,
                           price=50, size=1))
            batch.append(O(action=jop.BUY, oid=oid + 1, aid=(a + 1) % 99,
                           sid=s, price=55, size=1))
            oid += 2
        calls.append(pre + batch if s == 0 else batch)
    jcfg, cfg = JSQ.SeqConfig(**kw), SQ.SeqConfig(**kw)
    jses, port = JaxSession(jcfg), SeqSession(cfg, device="cpu")
    for msgs in calls:
        try:
            want = jses.process_wire([m.copy() for m in msgs])
        except JaxEngineError as e:
            with pytest.raises(LaneEngineError) as got:
                port.process_wire(_port(msgs))
            assert got.value.code == e.code == SQ.LERR_HASH_FULL
            break
        assert port.process_wire(_port(msgs)) == want
    else:
        pytest.fail("HASH_FULL never tripped")
    _assert_canon_equal(SQ.export_canonical(cfg, port.state),
                        JSQ.export_canonical(jcfg, jses.state))


def test_carry_state_from_jax_session_into_port():
    """Batch 1 on the JAX package; its planes and router maps carried
    into the port with load_numpy; batch 2 on both: equal lines, planes
    and canonical export."""
    msgs = zipf_symbol_stream(700, num_symbols=6, num_accounts=40, seed=9,
                              payout_per_mille=6)
    cut = 380
    jcfg, cfg = JSQ.SeqConfig(**WIDE), SQ.SeqConfig(**WIDE)
    jses = JaxSession(jcfg)
    jses.process_wire([m.copy() for m in msgs[:cut]])
    port = SeqSession(cfg, device="cpu")
    r = jses.router
    port.load_numpy({k: np.asarray(jses.state[k]) for k in jses.state},
                    r.aid_idx, r.sid_lane, r.oid_sid)
    want = jses.process_wire([m.copy() for m in msgs[cut:]])
    assert port.process_wire(_port(msgs[cut:])) == want
    for k in SQ.state_keys(cfg):
        assert np.array_equal(port.state[k].numpy(),
                              np.asarray(jses.state[k])), k
    _assert_canon_equal(SQ.export_canonical(cfg, port.state),
                        JSQ.export_canonical(jcfg, jses.state))


def test_canonical_snapshot_crosses_packages():
    """A JAX-package canonical snapshot imports into the port (and the
    port's into the JAX package) and both resume byte-identical."""
    msgs = zipf_symbol_stream(600, num_symbols=5, num_accounts=16, seed=11)
    cut = 300
    jcfg, cfg = JSQ.SeqConfig(**WIDE), SQ.SeqConfig(**WIDE)
    full = JaxSession(jcfg)
    want = full.process_wire([m.copy() for m in msgs])

    head = SeqSession(cfg, device="cpu")
    got = head.process_wire(_port(msgs[:cut]))
    canon = SQ.export_canonical(cfg, head.state)
    _assert_canon_equal(SQ.export_canonical(
        cfg, SQ.import_canonical(cfg, canon, "cpu")), canon)
    tail_j = JaxSession(jcfg)
    tail_j.state = JSQ.import_canonical(jcfg, canon)
    tail_j.router.aid_idx = dict(head.router.aid_idx)
    tail_j.router.sid_lane = dict(head.router.sid_lane)
    tail_j.router.oid_sid = dict(head.router.oid_sid)
    tail_p = SeqSession(cfg, device="cpu")
    tail_p.state = SQ.import_canonical(cfg, JSQ.export_canonical(
        jcfg, tail_j.state), "cpu")
    tail_p.router = head.router
    got_j = tail_j.process_wire([m.copy() for m in msgs[cut:]])
    got_p = tail_p.process_wire(_port(msgs[cut:]))
    assert got + got_p == want
    assert got + got_j == want

