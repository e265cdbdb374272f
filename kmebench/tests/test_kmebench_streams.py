"""The generator: the same messages for a seed however they are sliced,
other messages for another seed, the upstream distributions, streams of
other shapes made from parameters alone, and the traffic mixes' due
times."""

import json
import os

import numpy as np
import pytest

from kmebench import arrivals as A
from kmebench import spec as S
from kmebench.reference import opcodes as op
from kmebench.streams import COLS, MessageStream, concat, encode

EXCHANGE = json.load(open(os.path.join(S.HERE, "configs",
                                       "serve-fixed.json")))["stream"]
FUNDED = {"accounts": 256, "deposit": 10_000_000, "preamble_symbols": 64,
          "symbols": 64,
          "per_mille": {"payout": 2, "buy": 448, "sell": 450,
                        "cancel": 100},
          "payout_opcode": "payout", "payout_readd": True, "clamp": True}
SEED = 2**31 + 12345     # seeds beyond 32 signed bits are valid
STEADY = {"arrivals": "poisson", "tick_ms": 1}


@pytest.mark.parametrize("spec", [FUNDED, EXCHANGE],
                         ids=["funded", "exchange"])
def test_same_seed_same_messages_however_sliced(spec):
    a = MessageStream(spec, SEED).take(5000)
    s = MessageStream(spec, SEED)
    b = concat([s.take(n) for n in (1, 17, 256, 1000, 3726)])
    for k in COLS:
        assert np.array_equal(a[k], b[k])
    c = MessageStream(spec, SEED + 1).take(5000)
    assert not np.array_equal(a["oid"], c["oid"])


def test_the_configuration_sends_exchange_test_as_shipped():
    s = MessageStream(EXCHANGE, 11)
    pre = s.take(s.preamble_len)
    # 10 accounts created and funded, symbols 0..S/2 (exchange_test.js:29)
    assert s.preamble_len == 20 + 3
    assert list(pre["sid"][-3:]) == [0, 1, 2]
    assert list(pre["action"][:2]) == [op.CREATE_BALANCE, op.TRANSFER]
    ev = s.take(200_000)
    act = ev["action"]
    assert abs((act == op.BUY).mean() - 0.332) < 0.01
    assert abs((act == op.SELL).mean() - 0.332) < 0.01
    assert abs((act == op.TRANSFER).mean() - 0.002) < 0.001
    assert abs((act == op.ADD_SYMBOL).mean() - 0.001) < 0.0005
    assert not (act == op.PAYOUT).any()
    # payouts go out with the CANCEL opcode and size 100 - rake
    pay = (act == op.CANCEL) & (ev["size"] == 97)
    assert 0.0005 < pay.mean() < 0.0015
    # floor(N(50, 10)) prices and sizes, unclamped
    trade = (act == op.BUY) | (act == op.SELL)
    for k in ("price", "size"):
        assert abs(ev[k][trade].mean() - 49.5) < 0.2
        assert abs(ev[k][trade].std() - 10.0) < 0.2
    assert set(np.unique(ev["sid"][trade])) == {0, 1, 2}
    assert set(np.unique(ev["aid"][trade])) == set(range(10))


def test_out_of_domain_trades_go_out_unclamped():
    # seed 7200000005 sends a size of -1 at message 25,871 (preamble
    # included), as exchange_test.js can
    ev = MessageStream(EXCHANGE, 7200000005).take(40_000)
    trade = (ev["action"] == op.BUY) | (ev["action"] == op.SELL)
    assert list(np.flatnonzero(trade & (ev["size"] <= 0))) == [25871]
    cl = MessageStream(dict(EXCHANGE, clamp=True), 7200000005).take(40_000)
    assert cl["size"][25871] == 1
    assert np.array_equal(np.delete(cl["size"], 25871),
                          np.delete(ev["size"], 25871))


def test_a_funded_payout_stream_from_parameters():
    s = MessageStream(FUNDED, 7)
    pre = s.take(s.preamble_len)
    assert s.preamble_len == 2 * 256 + 64
    assert (pre["size"][1::2][:256] == 10_000_000).all()
    ev = s.take(100_000)
    act = ev["action"]
    n = len(act)
    assert abs((act == op.BUY).mean() - 0.448) < 0.01
    assert abs((act == op.CANCEL).mean() - 0.1) < 0.01
    pay = np.flatnonzero(act == op.PAYOUT)
    assert 0 < len(pay) < 0.005 * n
    # each PAYOUT is followed by a re-ADD of its symbol
    assert (act[pay + 1] == op.ADD_SYMBOL).all()
    assert (ev["sid"][pay + 1] == np.abs(ev["sid"][pay])).all()
    trade = (act == op.BUY) | (act == op.SELL)
    assert ev["price"][trade].min() >= 0 and ev["price"][trade].max() <= 125
    assert ev["size"][trade].min() >= 1


def test_a_hot_book_stream_from_parameters():
    ev = MessageStream(dict(EXCHANGE, symbols=16, preamble_symbols=16,
                            symbol_draw={"hot": 0.7}), 5).take(50_000)
    trade = (ev["action"] == op.BUY) | (ev["action"] == op.SELL)
    share = (ev["sid"][trade] == 0).mean()
    assert abs(share - (0.7 + 0.3 / 16)) < 0.01


def test_bad_stream_parameters_are_refused():
    with pytest.raises(ValueError):
        MessageStream(dict(EXCHANGE, per_mille={"buy": 500}), 1)
    with pytest.raises(ValueError):
        MessageStream(dict(EXCHANGE, symbol_draw="pareto"), 1)
    with pytest.raises(ValueError):
        MessageStream(dict(EXCHANGE, depth=3), 1)


def test_cancels_name_open_orders_of_their_account():
    s = MessageStream(EXCHANGE, 3)
    s.take(s.preamble_len)
    ev = s.take(20_000)
    owner = {}
    for a, o, aid in zip(ev["action"], ev["oid"], ev["aid"]):
        if a in (op.BUY, op.SELL):
            owner[int(o)] = int(aid)
        elif a == op.CANCEL and o != 0:
            assert owner.pop(int(o)) == aid


def test_encode_is_the_upstream_schema():
    cols = {k: np.array([v], np.int64) for k, v in
            zip(COLS, (2, 9007199254740990, 3, 1, -4, 50))}
    assert encode(cols) == ['{"action":2,"oid":9007199254740990,"aid":3,'
                            '"sid":1,"price":-4,"size":50}']


def test_poisson_due_times_are_seeded():
    a = A.due_offsets(STEADY, {"rate_per_s": 5000}, SEED, 10.0)
    b = A.due_offsets(STEADY, {"rate_per_s": 5000}, SEED, 10.0)
    assert np.array_equal(a, b)
    assert (np.diff(a) > 0).all() and 0 < a[0] and a[-1] < 10.0
    assert abs(len(a) - 50_000) < 5 * np.sqrt(50_000)
    gaps = np.diff(a)
    assert abs(gaps.mean() * 5000 - 1) < 0.02
    assert abs(gaps.std() / gaps.mean() - 1) < 0.03     # exponential
    c = A.due_offsets(STEADY, {"rate_per_s": 5000}, SEED + 1, 10.0)
    assert not np.array_equal(a[:100], c[:100])


def test_a_shaped_mix_bursts_and_keeps_its_mean():
    bursty = {"arrivals": "poisson", "shape": [[9, 0.9], [1, 1.9]]}
    a = A.due_offsets(bursty, {"rate_per_s": 4000}, SEED, 30.0)
    assert abs(len(a) - 120_000) < 5 * np.sqrt(120_000)
    phase = a % 10.0
    burst = np.count_nonzero(phase >= 9.0) / 3
    calm = np.count_nonzero(phase < 9.0) / 27
    assert abs(burst / 4000 - 1.9) < 0.05 and abs(calm / 4000 - 0.9) < 0.03


def test_a_closed_loop_has_no_schedule_and_bounds():
    back = json.load(open(os.path.join(S.HERE, "traffic", "backlog.json")))
    assert A.due_offsets(back, {}, 1, 10.0) is None
    assert A.outstanding(back, 1024) == 8 * 1024
    assert A.per_call(back, 1024) == 1024
    assert A.per_call(STEADY, 1024) == A.UNBOUNDED
    for bad in ({"arrivals": "even"}, {"tick_ms": 1},
                {"arrivals": "poisson", "shape": [[1, 0]]},
                {"arrivals": "poisson", "rate": 3}):
        with pytest.raises(ValueError):
            A.check(bad)
