"""The port's serial parity replica (engine/parity.py) and its ops
(ops/bits.py, ops/tables.py) on the CPU.

- the analogs of tests/test_parity_engine.py and tests/test_ops_bits.py,
  held against the port's oracle and its java-exact host helpers;
- the replica held against `kme_tpu`'s (JAX on the CPU, the reference
  tests' CAPS): records, death index, `export_state` (after a death
  too) and every state array, also from a state carried across the two
  packages mid-stream;
- bits and tables against `kme_tpu`'s over adversarial int64 samples,
  value for value, and the first-hit tie rule the tables rely on.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kme_tpu.engine.parity as JP
import kme_tpu.ops.bits as JB
import kme_tpu.ops.tables as JT
import kme_tpu.wire as JW
import kme_tpu_torch.opcodes as op
from kme_tpu_torch.engine import parity as P
from kme_tpu_torch.engine.parity import (
    ERR_CRASH, ERR_HANG, ERR_TABLE_FULL, DeviceParityError, ParityCaps,
    ParityEngine)
from kme_tpu_torch.ops import bits, tables
from kme_tpu_torch.oracle import OracleEngine
from kme_tpu_torch.oracle import engine as oe
from kme_tpu_torch.oracle import javalong as jl
from kme_tpu_torch.wire import OrderMsg
from kme_tpu_torch.workload import harness_stream

torch.set_num_threads(1)

CAPS = ParityCaps(balances=16, positions=1024, books=16, buckets=256,
                  orders=2048, max_events=32, batch=128)
TINY = ParityCaps(balances=2, positions=8, books=4, buckets=8,
                  orders=8, max_events=8, batch=16)


def jcaps(caps):
    return JP.ParityCaps(**{f: getattr(caps, f) for f in (
        "balances", "positions", "books", "buckets", "orders",
        "max_events", "batch")})


def run_oracle(msgs, compat):
    """-> (list of wire-line lists per message, death index or None)."""
    eng = OracleEngine(compat)
    recs, death = [], None
    for i, m in enumerate(msgs):
        try:
            recs.append([r.wire() for r in eng.process(m.copy())])
        except Exception:  # ReferenceHang/Crash and dict/None-access deaths
            death = i
            break
    return recs, death, eng


def run_device(msgs, compat, caps=CAPS, eng=None):
    eng = eng or ParityEngine(compat, caps, device="cpu")
    try:
        out = eng.process_batch(msgs)
        return [[r.wire() for r in recs] for recs in out], None, eng
    except DeviceParityError as e:
        return [[r.wire() for r in recs] for recs in e.records], e.index, eng


def run_jax(msgs, compat, caps=CAPS, eng=None):
    eng = eng or JP.ParityEngine(compat, jcaps(caps))
    jm = [JW.OrderMsg(**m.__dict__) for m in msgs]
    try:
        out = eng.process_batch(jm)
        return [[r.wire() for r in recs] for recs in out], None, eng
    except JP.DeviceParityError as e:
        return ([[r.wire() for r in recs] for recs in e.records], e.index,
                eng)


def oracle_state(ora: OracleEngine):
    orders = {oid: {"action": r.action, "aid": r.aid, "sid": r.sid,
                    "price": r.price, "size": r.size, "next": r.next,
                    "prev": r.prev}
              for oid, r in ora.orders.items()}
    return {"balances": dict(ora.balances), "positions": dict(ora.positions),
            "books": dict(ora.books), "buckets": dict(ora.buckets),
            "orders": orders}


def assert_parity(msgs, compat, caps=CAPS, check_state=True):
    ora_recs, ora_death, ora = run_oracle(msgs, compat)
    dev_recs, dev_death, dev = run_device(msgs, compat, caps)
    assert dev_death == ora_death, (
        f"death index diverged: device={dev_death} oracle={ora_death}")
    assert len(dev_recs) == len(ora_recs)
    for i, (g, w) in enumerate(zip(dev_recs, ora_recs)):
        assert g == w, f"record stream diverged at message {i}: {msgs[i]}"
    if check_state and ora_death is None:
        assert dev.export_state() == oracle_state(ora)
    return ora, dev


def assert_states_equal(port_eng, jax_eng):
    """Every array of the two states, the unused slots' stale values
    included."""
    got = P.state_to_numpy(port_eng.state)
    want = jax.tree.map(np.asarray, jax_eng.state)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the scenarios of tests/test_parity_engine.py

def _seeded(num_accounts=4, deposit=200_000, symbols=(1, 2)):
    msgs = []
    for a in range(num_accounts):
        msgs.append(OrderMsg(action=op.CREATE_BALANCE, aid=a))
        msgs.append(OrderMsg(action=op.TRANSFER, aid=a, size=deposit))
    for s in symbols:
        msgs.append(OrderMsg(action=op.ADD_SYMBOL, sid=s))
    return msgs


def _payout_and_remove():
    msgs = _seeded()
    oid = 100
    for sid in (1, 2):
        for price, size in ((40, 5), (40, 3), (55, 7), (60, 2)):
            msgs.append(OrderMsg(action=op.BUY, oid=oid, aid=oid % 4, sid=sid,
                                 price=price, size=size))
            oid += 1
        for price, size in ((70, 4), (80, 6)):
            msgs.append(OrderMsg(action=op.SELL, oid=oid, aid=oid % 4, sid=sid,
                                 price=price, size=size))
            oid += 1
    msgs.append(OrderMsg(action=op.BUY, oid=oid, aid=3, sid=1, price=75, size=5))
    msgs.append(OrderMsg(action=op.SELL, oid=oid + 1, aid=2, sid=2, price=35,
                         size=6))
    msgs += [
        OrderMsg(action=op.PAYOUT, sid=1, size=97),    # YES: credit longs
        OrderMsg(action=op.PAYOUT, sid=-2, size=97),   # NO: delete uncredited
        OrderMsg(action=op.PAYOUT, sid=1, size=97),    # symbol gone -> reject
        OrderMsg(action=op.ADD_SYMBOL, sid=1),         # re-add after payout
        OrderMsg(action=op.REMOVE_SYMBOL, sid=1),      # empty remove
        OrderMsg(action=op.REMOVE_SYMBOL, sid=9),      # missing -> reject
    ]
    return msgs


def _java_remove_quirks():
    return _seeded(symbols=(1,)) + [
        OrderMsg(action=op.REMOVE_SYMBOL, sid=1),  # exists+empty -> REJECT (Q3)
        OrderMsg(action=op.REMOVE_SYMBOL, sid=5),  # missing -> "success"
        OrderMsg(action=op.ADD_SYMBOL, sid=1),     # still exists -> reject
    ]


def _java_hang():
    return _seeded(symbols=(1,)) + [
        OrderMsg(action=op.BUY, oid=7, aid=0, sid=1, price=40, size=5),
        OrderMsg(action=op.REMOVE_SYMBOL, sid=1)]


def _java_payout_missing():
    return _seeded(symbols=(1,)) + [
        OrderMsg(action=op.BUY, oid=1, aid=0, sid=1, price=50, size=4),
        OrderMsg(action=op.SELL, oid=2, aid=1, sid=1, price=50, size=4),
        OrderMsg(action=op.PAYOUT, sid=3, size=97)]


def _q1():
    return _seeded(symbols=(0,)) + [
        OrderMsg(action=op.BUY, oid=1, aid=0, sid=0, price=40, size=5),
        OrderMsg(action=op.BUY, oid=2, aid=1, sid=0, price=45, size=5),
        OrderMsg(action=op.SELL, oid=3, aid=2, sid=0, price=80, size=2),
        OrderMsg(action=op.SELL, oid=4, aid=3, sid=0, price=10, size=2)]


def _q2():
    return _seeded(symbols=(1,)) + [
        OrderMsg(action=op.BUY, oid=1, aid=0, sid=1, price=50, size=3),
        OrderMsg(action=op.BUY, oid=2, aid=1, sid=1, price=50, size=3),
        OrderMsg(action=op.SELL, oid=3, aid=2, sid=1, price=40, size=3),
        OrderMsg(action=op.BUY, oid=4, aid=3, sid=1, price=10, size=0)]


def _q9():
    return _seeded(symbols=(1,)) + [
        OrderMsg(action=op.BUY, oid=1, aid=0, sid=1, price=50, size=3),
        OrderMsg(action=op.BUY, oid=2, aid=1, sid=1, price=50, size=3),
        OrderMsg(action=op.SELL, oid=3, aid=2, sid=1, price=45, size=10)]


def _cancels():
    msgs = _seeded(symbols=(1,))
    for i, (price, size) in enumerate(
            ((50, 1), (50, 2), (50, 3), (50, 4), (50, 5))):
        msgs.append(OrderMsg(action=op.BUY, oid=10 + i, aid=i % 4, sid=1,
                             price=price, size=size))
    return msgs + [
        OrderMsg(action=op.CANCEL, oid=12, aid=2),   # middle
        OrderMsg(action=op.CANCEL, oid=10, aid=0),   # head
        OrderMsg(action=op.CANCEL, oid=14, aid=0),   # tail, wrong owner
        OrderMsg(action=op.CANCEL, oid=14, aid=3),   # tail
        OrderMsg(action=op.CANCEL, oid=999, aid=0),  # unknown
        OrderMsg(action=op.CANCEL, oid=11, aid=1),   # head again
        OrderMsg(action=op.CANCEL, oid=13, aid=3),   # only
        OrderMsg(action=op.CANCEL, oid=13, aid=3),   # already gone
    ]


def _balance_edges():
    return [
        OrderMsg(action=op.TRANSFER, aid=1, size=100),   # no account -> reject
        OrderMsg(action=op.CREATE_BALANCE, aid=1),
        OrderMsg(action=op.CREATE_BALANCE, aid=1),       # duplicate -> reject
        OrderMsg(action=op.TRANSFER, aid=1, size=500),
        OrderMsg(action=op.TRANSFER, aid=1, size=-500),  # to exactly 0
        OrderMsg(action=op.TRANSFER, aid=1, size=-1),    # overdraft -> reject
        OrderMsg(action=op.TRANSFER, aid=1, size=0),
        OrderMsg(action=op.BUY, oid=1, aid=1, sid=9, price=50, size=1),
        OrderMsg(action=99, oid=1, aid=1),               # unknown opcode
    ]


def _int32_credit():
    msgs = []
    for a in (0, 1):
        msgs.append(OrderMsg(action=op.CREATE_BALANCE, aid=a))
        for _ in range(2):
            msgs.append(OrderMsg(action=op.TRANSFER, aid=a, size=2**30))
    msgs.append(OrderMsg(action=op.ADD_SYMBOL, sid=1))
    msgs.append(OrderMsg(action=op.SELL, oid=1, aid=0, sid=1, price=0,
                         size=65536))
    msgs.append(OrderMsg(action=op.BUY, oid=2, aid=1, sid=1, price=32768,
                         size=65536))
    return msgs


def _int_min_transfer():
    return [OrderMsg(action=op.CREATE_BALANCE, aid=1),
            OrderMsg(action=op.TRANSFER, aid=1, size=-(2**31))]


def _negative_size_npe():
    return _seeded(num_accounts=1, symbols=(1,)) + [
        OrderMsg(action=op.BUY, oid=1, aid=0, sid=1, price=50, size=-5)]


def _fixed_remove_then_trade():
    """A fixed-mode wipe of a two-level book with resting orders on both
    sides, then trading on the re-added symbol."""
    msgs = _seeded(symbols=(3,))
    for i, (act, price, size) in enumerate(
            ((op.BUY, 40, 2), (op.BUY, 40, 3), (op.BUY, 41, 1),
             (op.SELL, 60, 4), (op.SELL, 61, 2))):
        msgs.append(OrderMsg(action=act, oid=50 + i, aid=i % 4, sid=3,
                             price=price, size=size))
    return msgs + [
        OrderMsg(action=op.REMOVE_SYMBOL, sid=3),
        OrderMsg(action=op.ADD_SYMBOL, sid=3),
        OrderMsg(action=op.BUY, oid=60, aid=0, sid=3, price=55, size=3),
        OrderMsg(action=op.SELL, oid=61, aid=1, sid=3, price=50, size=5)]


SCENARIOS = {
    "payout_and_remove_symbol": (_payout_and_remove, ("fixed", "java")),
    "java_remove_symbol_quirks": (_java_remove_quirks, ("java", "fixed")),
    "java_hang_on_nonempty_remove": (_java_hang, ("java", "fixed")),
    "java_payout_on_missing_books": (_java_payout_missing,
                                     ("java", "fixed")),
    "q1_sid0_merged_book": (_q1, ("java", "fixed")),
    "q2_ghost_trades": (_q2, ("java", "fixed")),
    "q9_prev_leak": (_q9, ("java", "fixed")),
    "cancel_all_link_cases": (_cancels, ("java", "fixed")),
    "transfer_and_balance_edges": (_balance_edges, ("java", "fixed")),
    "fill_credit_wraps_at_int32": (_int32_credit, ("java", "fixed")),
    "transfer_int_min_negation": (_int_min_transfer, ("java", "fixed")),
    "negative_size_buy_npe": (_negative_size_npe, ("java", "fixed")),
    "fixed_remove_then_trade": (_fixed_remove_then_trade, ("fixed",)),
}
CASES = [(name, compat) for name, (_, modes) in SCENARIOS.items()
         for compat in modes]


# ---------------------------------------------------------------------------
# the analogs of tests/test_parity_engine.py, against the port's oracle

@pytest.mark.slow
def test_parity_java_stock_workload():
    """The reference harness distribution (exchange_test.js), java compat:
    Q1 (sid-0 trades), Q2 (unclamped sizes), Q9 (prev leaks), Q11
    (position garbage keys) on 1.5k events."""
    assert_parity(harness_stream(1500, seed=0), "java")


@pytest.mark.slow
def test_parity_fixed_stock_workload():
    """Fixed mode on the validated-domain workload with real PAYOUT
    opcodes (payout bug disabled)."""
    assert_parity(
        harness_stream(1500, seed=3, payout_opcode_bug=False, validate=True),
        "fixed")


def test_parity_payout_and_remove_symbol_fixed():
    """The fixed-mode settlement paths: resting books wiped with margin
    release, YES/NO payouts, re-add after removal."""
    assert_parity(_payout_and_remove(), "fixed")


def test_parity_java_remove_symbol_quirks():
    """Q3: removeSymbol on existing-but-empty books rejects (inverted);
    on missing books succeeds."""
    assert_parity(_java_remove_quirks(), "java")


def test_parity_java_hang_on_nonempty_remove():
    """Q4: REMOVE_SYMBOL with resting orders is the reference's infinite
    loop; both engines die at the same message index."""
    msgs = _java_hang()
    ora_recs, ora_death, _ = run_oracle(msgs, "java")
    dev_recs, dev_death, dev = run_device(msgs, "java")
    assert ora_death == dev_death == len(msgs) - 1
    assert dev_recs == ora_recs
    with pytest.raises(DeviceParityError) as ei:
        ParityEngine("java", CAPS, device="cpu").process_batch(msgs)
    assert ei.value.code == ERR_HANG


def test_parity_java_payout_credits_on_missing_books():
    """Q3+Q5/Q6: java PAYOUT proceeds only when the symbol's books are
    MISSING, and the OUT echo is still REJECT (the dispatcher drops the
    result)."""
    ora, dev = assert_parity(_java_payout_missing(), "java")
    assert any(k[1] == 1 for k in ora.positions)


def test_parity_q1_sid0_merged_book():
    """Q1: symbol 0's buy and sell sides share one book; a buy can match
    a resting buy."""
    assert_parity(_q1(), "java")


def test_parity_q2_ghost_trades():
    """Q2: a fully-filled sell taker still executes one zero-size trade
    when the next maker crosses."""
    msgs = _q2()
    assert_parity(msgs, "java")
    eng = OracleEngine("java")
    ghost = 0
    for m in msgs:
        for r in eng.process(m.copy()):
            if r.key == "OUT" and r.value.action in (op.BOUGHT, op.SOLD) \
                    and r.value.size == 0:
                ghost += 1
    assert ghost >= 2


def test_parity_q9_prev_leak_and_residual_echo():
    """Q9: the OUT echo of an order appended to a bucket carries the
    tail's oid in `prev`; a partially-filled taker echoes its residual."""
    msgs = _q9()
    assert_parity(msgs, "java")
    out = ParityEngine("java", CAPS, device="cpu").process_batch(msgs)
    assert out[len(msgs) - 2][-1].value.prev == 1
    assert out[len(msgs) - 1][-1].value.size == 10 - 6


def test_parity_cancel_all_link_cases():
    """Cancel only/head/tail/middle unlink cases + margin release, and
    cancels of unknown/foreign oids."""
    msgs = _cancels()
    assert_parity(msgs, "java")
    assert_parity(msgs, "fixed")


def test_device_capacity_overflow_is_flagged():
    msgs = [OrderMsg(action=op.CREATE_BALANCE, aid=a) for a in range(3)]
    with pytest.raises(DeviceParityError) as ei:
        ParityEngine("java", TINY, device="cpu").process_batch(msgs)
    assert ei.value.code == ERR_TABLE_FULL
    assert ei.value.index == 2


def test_parity_transfer_and_balance_edges():
    msgs = _balance_edges()
    assert_parity(msgs, "java")
    assert_parity(msgs, "fixed")


def test_parity_fill_credit_wraps_at_int32():
    """fillOrder's balance credit `size * order.price` wraps at 2^31
    before the long add (KProcessor.java:286)."""
    ora, dev = assert_parity(_int32_credit(), "java")
    assert ora.balances[1] == 2 * 2**30 - 2**31 - 2**31


def test_parity_transfer_int_min_negation_wraps():
    """`balance < -order.size` negates in 32-bit int: a withdrawal of
    2^31 is ACCEPTED by the JVM."""
    msgs = _int_min_transfer()
    ora, dev = assert_parity(msgs, "java")
    assert ora.balances[1] == -(2**31)
    assert_parity(msgs, "fixed")


def test_parity_negative_size_buy_npe():
    """A BUY with negative size and no position: checkBalance's adj-write
    NPEs after the balance debit persisted — both die at one index."""
    msgs = _negative_size_npe()
    ora_recs, ora_death, _ = run_oracle(msgs, "java")
    dev_recs, dev_death, _ = run_device(msgs, "java")
    assert ora_death == dev_death == len(msgs) - 1
    assert dev_recs == ora_recs


def test_parity_fixed_wipe_then_trade():
    assert_parity(_fixed_remove_then_trade(), "fixed")


@pytest.mark.parametrize("compat", ["java", "fixed"])
def test_parity_harness_prefix(compat):
    """600 messages of the harness streams (java: the reference's
    distribution; fixed: validated with real PAYOUTs), two batches of a
    small batch size, against the oracle."""
    msgs = (harness_stream(600, seed=0) if compat == "java" else
            harness_stream(600, seed=3, payout_opcode_bug=False,
                           validate=True))
    assert_parity(msgs, compat, caps=ParityCaps(
        balances=16, positions=1024, books=16, buckets=256, orders=2048,
        max_events=32, batch=256))


# ---------------------------------------------------------------------------
# the replica against kme_tpu's (JAX on the CPU)

@pytest.mark.parametrize("name,compat", CASES,
                         ids=[f"{n}-{c}" for n, c in CASES])
def test_replica_matches_jax(name, compat):
    """Records, death index, export_state (after a death too) and every
    state array, the unused slots included."""
    msgs = SCENARIOS[name][0]()
    got, gdeath, port = run_device(msgs, compat)
    want, wdeath, jeng = run_jax(msgs, compat)
    assert gdeath == wdeath
    assert got == want
    assert port.export_state() == jeng.export_state()
    assert_states_equal(port, jeng)


def test_replica_capacity_overflow_matches_jax():
    msgs = [OrderMsg(action=op.CREATE_BALANCE, aid=a) for a in range(3)]
    got, gdeath, port = run_device(msgs, "java", TINY)
    want, wdeath, jeng = run_jax(msgs, "java", TINY)
    assert gdeath == wdeath == 2 and got == want
    assert_states_equal(port, jeng)


@pytest.mark.parametrize("compat", ["java", "fixed"])
def test_replica_matches_jax_from_carried_state(compat):
    """kme_tpu runs the first 300 messages; its state goes into the port
    (state_from_numpy), both run the next 300; the port's state goes back
    into kme_tpu (state_to_numpy) and both run the rest."""
    msgs = (harness_stream(800, seed=4) if compat == "java" else
            harness_stream(800, seed=4, payout_opcode_bug=False,
                           validate=True))
    _, d0, jeng = run_jax(msgs[:300], compat)
    assert d0 is None
    port = ParityEngine(compat, CAPS, device="cpu")
    port.state = P.state_from_numpy(
        CAPS, jax.tree.map(np.asarray, jeng.state), "cpu")
    assert_states_equal(port, jeng)
    got, gd, _ = run_device(msgs[300:600], compat, eng=port)
    want, wd, _ = run_jax(msgs[300:600], compat, eng=jeng)
    assert gd == wd and got == want
    assert_states_equal(port, jeng)
    # and back: the port's state into a fresh kme_tpu engine
    j2 = JP.ParityEngine(compat, jcaps(CAPS))
    j2.state = jax.tree.map(jnp.asarray, P.state_to_numpy(port.state))
    got, gd, _ = run_device(msgs[600:], compat, eng=port)
    want, wd, _ = run_jax(msgs[600:], compat, eng=j2)
    assert gd == wd and got == want
    assert port.export_state() == j2.export_state()
    assert_states_equal(port, j2)


def test_dead_state_stays_dead_across_batches_and_packages():
    """After a death the sticky error freezes the state: the next call
    raises at its first message with the same code, in both packages,
    and a dead state carried across packages is as dead."""
    msgs = _java_hang()
    _, gd, port = run_device(msgs, "java")
    _, wd, jeng = run_jax(msgs, "java")
    assert gd == wd == len(msgs) - 1
    before = port.export_state()
    more = [OrderMsg(action=op.CREATE_BALANCE, aid=9)]
    for eng in (port, jeng):
        with pytest.raises((DeviceParityError, JP.DeviceParityError)) as ei:
            eng.process_batch([m if eng is port else JW.OrderMsg(**m.__dict__)
                               for m in more])
        assert (ei.value.code, ei.value.index) == (ERR_HANG, 0)
    assert port.export_state() == before == jeng.export_state()
    carried = ParityEngine("java", CAPS, device="cpu")
    carried.state = P.state_from_numpy(
        CAPS, jax.tree.map(np.asarray, jeng.state), "cpu")
    with pytest.raises(DeviceParityError) as ei:
        carried.process_batch(more)
    assert (ei.value.code, ei.value.index, ei.value.records) == (ERR_HANG, 0,
                                                                 [])


def test_syncs_counted_per_batch_and_loop():
    """A batch without a match or wipe loop reads the device twice (the
    sticky error, the result table); every test of a loop condition is
    one more read."""
    eng = ParityEngine("java", CAPS, device="cpu")
    eng.process_batch(_seeded(symbols=(1,)))
    assert eng.syncs == 2
    eng.process_batch([OrderMsg(action=op.BUY, oid=1, aid=0, sid=1,
                                price=50, size=2)])
    # the empty opposite book: one test of the match loop's condition
    assert eng.syncs == 2 + 3
    eng.process_batch([OrderMsg(action=op.SELL, oid=2, aid=1, sid=1,
                                price=50, size=2)])
    # one trade (two fills: one more read, of the packed rows) that
    # exhausts the only maker: two tests
    assert eng.syncs == 5 + 5
    assert eng.messages == len(_seeded(symbols=(1,))) + 2
    assert eng.captured == 0  # the CPU runs every segment eagerly


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        ParityEngine("java", CAPS)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.make_state(CAPS)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.state_from_numpy(CAPS, P.state_to_numpy(P.make_state(CAPS, "cpu")))
    with pytest.raises(ValueError):
        ParityEngine("python", CAPS, device="cpu")


# ---------------------------------------------------------------------------
# the analogs of tests/test_ops_bits.py, against the port's host helpers

def _rand64(rng, n):
    vals = []
    for _ in range(n):
        kind = rng.randrange(4)
        if kind == 0:
            vals.append(rng.getrandbits(64))
        elif kind == 1:  # sparse
            v = 0
            for _ in range(rng.randrange(1, 4)):
                v |= 1 << rng.randrange(64)
            vals.append(v)
        elif kind == 2:  # dense top region (Q7 frontier)
            t = rng.randrange(40, 63)
            vals.append(((1 << (t + 1)) - 1) - rng.randrange(1 << 8))
        else:
            vals.append(rng.getrandbits(rng.randrange(1, 64)))
    return [jl.jlong(v) for v in vals]


EDGES = [0, 1, -1, 2, -2, jl.jlong(1 << 63), jl.jlong((1 << 63) + 1),
         (1 << 62), (1 << 63) - 1, (1 << 31), -(1 << 31), (1 << 32) - 1]


@pytest.fixture(scope="module")
def samples():
    rng = random.Random(7)
    vals = _rand64(rng, 4000) + EDGES
    for thr in (int(x) for x in bits._OVERSHOOT):
        if thr > 0:
            vals += [thr - 1, thr, jl.jlong(thr + 1)]
    return vals


def _t(vals, dt=torch.int64):
    return torch.tensor(vals, dtype=dt)


def test_first_set_bit_matches_oracle(samples):
    got = bits.first_set_bit_pos(_t(samples)).tolist()
    assert got == [jl.first_set_bit_pos_float(v) for v in samples]


def test_last_set_bit_matches_oracle(samples):
    got = bits.last_set_bit_pos(_t(samples)).tolist()
    assert got == [jl.last_set_bit_pos_float(v) for v in samples]


def test_bit_ops_match_java_semantics():
    rng = random.Random(11)
    ns = _rand64(rng, 512) + EDGES
    # prices incl. negatives and >125 (java shift masking paths)
    ks = [rng.randrange(-130, 260) for _ in ns]
    n, k = _t(ns), _t(ks, torch.int32)
    get, st, un = (bits.jget_bit(n, k).tolist(), bits.jset_bit(n, k).tolist(),
                   bits.junset_bit(n, k).tolist())
    for i in range(len(ns)):
        assert get[i] == jl.get_bit(ns[i], ks[i])
        assert st[i] == jl.set_bit(ns[i], ks[i])
        assert un[i] == jl.unset_bit(ns[i], ks[i])


def test_book_scan_and_bitmask_roundtrip():
    """The book codec against the oracle's helpers on random (msb, lsb)
    pairs and price operations."""
    rng = random.Random(3)
    n = 300
    msbs = [jl.jlong(rng.getrandbits(rng.randrange(0, 63))) for _ in range(n)]
    lsbs = [jl.jlong(rng.getrandbits(rng.randrange(0, 63))) for _ in range(n)]
    prices = [rng.randrange(-5, 130) for _ in range(n)]
    m, lo, p = _t(msbs), _t(lsbs), _t(prices, torch.int32)
    mn, mx = bits.book_min_price(m, lo), bits.book_max_price(m, lo)
    cb = bits.book_check_bit(m, lo, p)
    sm, sl = bits.book_with_bit_set(m, lo, p)
    um, ul = bits.book_with_bit_unset(m, lo, p)
    for i in range(n):
        book = (msbs[i], lsbs[i])
        assert int(mn[i]) == oe._book_min_price(book)
        assert int(mx[i]) == oe._book_max_price(book)
        assert bool(cb[i]) == oe._check_bit(book, prices[i])
        assert (int(sm[i]), int(sl[i])) == oe._with_bit_set(book, prices[i])
        assert (int(um[i]), int(ul[i])) == oe._with_bit_unset(book,
                                                               prices[i])


def test_bucket_key_matches_java_promotion():
    eng = OracleEngine("java")
    rng = random.Random(5)
    bkeys = [jl.jlong(rng.getrandbits(64)) for _ in range(200)] + EDGES
    prices = [rng.randrange(-300, 300) for _ in bkeys]
    got = bits.bucket_key(_t(bkeys), _t(prices, torch.int32)).tolist()
    for i in range(len(bkeys)):
        assert got[i] == eng._bucket_key(bkeys[i], prices[i])


def test_tables_find_put_delete():
    keys = _t([5, 9, 0, 7])
    used = torch.tensor([True, True, False, True])
    k9, k0, k7 = _t(9).reshape(()), _t(0).reshape(()), _t(7).reshape(())
    idx9, found9 = tables.find(keys, used, k9)
    assert bool(found9) and int(idx9) == 1
    assert not bool(tables.find(keys, used, k0)[1])  # slot 2 unused
    idx, ok = tables.alloc(used)
    assert bool(ok) and int(idx) == 2
    idx, ok = tables.put_idx(keys, used, k7)
    assert bool(ok) and int(idx) == 3  # upsert hits the existing slot
    assert not bool(tables.alloc(torch.ones(4, dtype=torch.bool))[1])
    deleted = tables.delete_at(used.clone(), idx9, found9)
    assert deleted.tolist() == [True, False, False, True]
    kept = tables.delete_at(used.clone(), idx9, ~found9)
    assert kept.tolist() == used.tolist()


def test_ops_work_on_scalars_and_batches():
    """The engine calls every op on 0-d tensors; the tests on vectors."""
    vals = [0, 1, 6, -2]
    out = bits.last_set_bit_pos(_t(vals))
    assert out.shape == (4,) and int(out[2]) == 2
    for i, v in enumerate(vals):
        s = bits.last_set_bit_pos(_t(v).reshape(()))
        assert s.shape == () and int(s) == int(out[i])


# ---------------------------------------------------------------------------
# bits and tables against kme_tpu's, value for value

@pytest.mark.parametrize("fn", ["first_set_bit_pos", "last_set_bit_pos",
                                "top_bit", "popcount"])
def test_bit_scans_equal_jax(samples, fn):
    a = np.asarray(samples, np.int64)
    want = (np.asarray(jax.lax.population_count(jnp.asarray(a)))
            if fn == "popcount" else np.asarray(getattr(JB, fn)(
                jnp.asarray(a))))
    got = getattr(bits, fn)(torch.from_numpy(a)).numpy()
    if fn != "popcount":
        assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want.astype(got.dtype))


def test_bit_ops_and_codecs_equal_jax(samples):
    rng = random.Random(13)
    a = np.asarray(samples, np.int64)
    b = np.asarray(samples[::-1], np.int64)
    k = np.asarray([rng.randrange(-300, 300) for _ in samples], np.int32)
    ta, tb, tk = (torch.from_numpy(x) for x in (a, b, k))
    ja, jb, jk = (jnp.asarray(x) for x in (a, b, k))
    pairs = [
        (bits.jshl1(tk), JB.jshl1(jk)),
        (bits.jget_bit(ta, tk), JB.jget_bit(ja, jk)),
        (bits.jset_bit(ta, tk), JB.jset_bit(ja, jk)),
        (bits.junset_bit(ta, tk), JB.junset_bit(ja, jk)),
        (bits.book_min_price(ta, tb), JB.book_min_price(ja, jb)),
        (bits.book_max_price(ta, tb), JB.book_max_price(ja, jb)),
        (bits.book_check_bit(ta, tb, tk), JB.book_check_bit(ja, jb, jk)),
        (bits.bucket_key(ta, tk), JB.bucket_key(ja, jk)),
        *zip(bits.book_with_bit_set(ta, tb, tk),
             JB.book_with_bit_set(ja, jb, jk)),
        *zip(bits.book_with_bit_unset(ta, tb, tk),
             JB.book_with_bit_unset(ja, jb, jk)),
    ]
    for i, (got, want) in enumerate(pairs):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype, i
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(i))
    np.testing.assert_array_equal(bits._OVERSHOOT, JB._OVERSHOOT)


def test_tables_equal_jax_and_take_the_first_hit():
    """find/find2/alloc/put_idx/put2_idx/delete_at against kme_tpu's on
    random tables with duplicate keys (where the first hit decides),
    plus the tie rule itself."""
    rng = np.random.default_rng(2)
    for _ in range(40):
        n = int(rng.integers(1, 40))
        ka = rng.integers(-3, 4, n).astype(np.int64)
        kb = rng.integers(-2, 3, n).astype(np.int64)
        used = rng.random(n) < rng.random()
        qa, qb = np.int64(rng.integers(-3, 4)), np.int64(rng.integers(-2, 3))
        t = [torch.from_numpy(x) for x in (ka, kb, used)]
        tq = [torch.tensor(int(q), dtype=torch.int64) for q in (qa, qb)]
        j = [jnp.asarray(x) for x in (ka, kb, used)]
        jq = [jnp.asarray(q) for q in (qa, qb)]
        pairs = [
            (tables.find(t[0], t[2], tq[0]), JT.find(j[0], j[2], jq[0])),
            (tables.find2(t[0], t[1], t[2], *tq),
             JT.find2(j[0], j[1], j[2], *jq)),
            (tables.alloc(t[2]), JT.alloc(j[2])),
            (tables.put_idx(t[0], t[2], tq[0]),
             JT.put_idx(j[0], j[2], jq[0])),
            (tables.put2_idx(t[0], t[1], t[2], *tq),
             JT.put2_idx(j[0], j[1], j[2], *jq)),
        ]
        for (gi, gf), (wi, wf) in pairs:
            assert (int(gi), bool(gf)) == (int(wi), bool(wf))
        idx, found = tables.find(t[0], t[2], tq[0])
        want = JT.delete_at(j[2], jnp.asarray(int(idx), jnp.int32),
                            jnp.asarray(bool(found)))
        got = tables.delete_at(t[2].clone(), idx, found)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the tie rule: the first of several hits, the first free slot
    keys = torch.tensor([4, 3, 3, 3], dtype=torch.int64)
    idx, found = tables.find(keys, torch.tensor([True, False, True, True]),
                             torch.tensor(3, dtype=torch.int64))
    assert (int(idx), bool(found)) == (2, True)
    idx, ok = tables.alloc(torch.tensor([True, False, True, False]))
    assert (int(idx), bool(ok)) == (1, True)
