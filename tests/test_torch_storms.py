"""The port's storm workloads: the analogs of the storm cases of
tests/test_workload.py and tests/test_overload.py, run on
`kme_tpu_torch.workload`'s generators and `kme_tpu_torch.bridge.broker`'s
overload controller, plus each profile's stream and windows, and the
controller's replay of them, against the JAX package's."""

import collections
import dataclasses

import pytest
import torch

import kme_tpu.bridge.broker as JB
import kme_tpu.workload as JWL
import kme_tpu_torch.workload as WL
from kme_tpu_torch import opcodes as op
from kme_tpu_torch.bridge.broker import (CLS_DRAIN, CLS_ORDER,
                                         OverloadController,
                                         simulate_overload)
from kme_tpu_torch.oracle import OracleEngine
from kme_tpu_torch.wire import dumps_order

torch.set_num_threads(1)

PROFILES = sorted(WL.STORM_PROFILES)


def _rows(msgs):
    return [dataclasses.astuple(m) for m in msgs]


def test_profiles_registry_equal():
    assert list(WL.STORM_PROFILES) == list(JWL.STORM_PROFILES)
    for name, p in WL.STORM_PROFILES.items():
        j = JWL.STORM_PROFILES[name]
        assert (p.name, p.summary, p.symbols, p.accounts) == \
            (j.name, j.summary, j.symbols, j.accounts)


def test_payout_storm_deterministic_with_bursts():
    a = WL.payout_storm_stream(2_000, num_symbols=8, num_accounts=32,
                               seed=4, storms=3)
    assert a == WL.payout_storm_stream(2_000, num_symbols=8,
                                       num_accounts=32, seed=4, storms=3)
    payouts = [i for i, m in enumerate(a) if m.action == op.PAYOUT]
    # every storm settles EVERY symbol (real PAYOUT opcode)
    assert len(payouts) == 3 * 8
    # bursts are contiguous: each storm's 8 payouts interleave only
    # with their re-ADDs
    for s in range(3):
        burst = payouts[s * 8:(s + 1) * 8]
        assert burst[-1] - burst[0] == 2 * 7
    for i in payouts:
        assert a[i + 1].action == op.ADD_SYMBOL
        assert a[i + 1].sid == abs(a[i].sid)


@pytest.mark.parametrize("name", PROFILES)
def test_storm_profile_deterministic_under_seed(name):
    a = WL.storm_stream(name, 800, num_symbols=8, num_accounts=16, seed=3)
    b = WL.storm_stream(name, 800, num_symbols=8, num_accounts=16, seed=3)
    assert a == b
    assert a != WL.storm_stream(name, 800, num_symbols=8, num_accounts=16,
                                seed=4)


@pytest.mark.parametrize("name", PROFILES)
def test_storm_windows_cover_stream_and_scale(name):
    msgs = WL.storm_stream(name, 800, num_symbols=8, num_accounts=16, seed=0)
    wins = WL.storm_windows(name, 800, num_symbols=8, num_accounts=16)
    assert wins
    for lo, hi, mult in wins:
        assert 0 <= lo < hi <= len(msgs), (lo, hi, len(msgs))
        assert mult > 1


def test_storm_profile_character():
    # payout-storm-wide: one contiguous burst settling EVERY symbol
    a = WL.storm_stream("payout-storm-wide", 600, num_symbols=16,
                        num_accounts=16, seed=1)
    payouts = [i for i, m in enumerate(a) if m.action == op.PAYOUT]
    assert len(payouts) == 16
    assert payouts[-1] - payouts[0] == 2 * 15
    (lo, hi, mult), = WL.storm_windows("payout-storm-wide", 600,
                                       num_symbols=16, num_accounts=16)
    assert lo <= payouts[0] and payouts[-1] < hi

    # cancel-storm: cancels dominate, mostly for bogus oids
    c = WL.storm_stream("cancel-storm", 2_000, num_symbols=8,
                        num_accounts=16, seed=1)
    assert sum(m.action == op.CANCEL for m in c) > 0.6 * 2_000

    # hot-book: one symbol carries nearly all the order flow
    h = WL.storm_stream("hot-book", 2_000, num_symbols=8, num_accounts=16,
                        seed=1)
    sub = collections.Counter(m.sid for m in h
                              if m.action in (op.BUY, op.SELL))
    assert sub[0] / sum(sub.values()) > 0.9

    # liquidation-cascade: multiple full-universe settlement waves
    lq = WL.storm_stream("liquidation-cascade", 1_000, num_symbols=8,
                         num_accounts=16, seed=1)
    assert sum(1 for m in lq if m.action == op.PAYOUT) == 2 * 8


@pytest.mark.parametrize("name", PROFILES)
def test_storm_profile_survives_oracle(name):
    # every profile's full stream processes without a crash, and
    # fixed-mode solvency holds
    e = OracleEngine("fixed")
    for m in WL.storm_stream(name, 600, num_symbols=8, num_accounts=16,
                             seed=2):
        e.process(m)
    assert all(b >= 0 for b in e.balances.values())


def test_adversarial_streams_survive_oracle():
    e = OracleEngine("fixed")
    for m in WL.zipf_hot_stream(1_500, num_symbols=8, num_accounts=24,
                                seed=2):
        e.process(m)
    e2 = OracleEngine("fixed")
    for m in WL.payout_storm_stream(1_500, num_symbols=8, num_accounts=24,
                                    seed=2):
        e2.process(m)
    assert all(b >= 0 for b in e2.balances.values())
    e3 = OracleEngine("fixed")
    for m in WL.cancel_heavy_stream(1_500, num_symbols=8, num_accounts=24,
                                    seed=2):
        e3.process(m)
    assert all(b >= 0 for b in e3.balances.values())


def test_simulate_overload_deterministic_and_sheds():
    lines = [dumps_order(m) for m in WL.storm_stream(
        "flash-crowd", 1500, num_symbols=8, num_accounts=16, seed=0)]
    wins = WL.storm_windows("flash-crowd", 1500, num_symbols=8,
                            num_accounts=16)
    a = simulate_overload(lines, wins, OverloadController(high_lag=32))
    b = simulate_overload(lines, wins, OverloadController(high_lag=32))
    assert a["admitted_idx"] == b["admitted_idx"]
    assert a["shed"] > 0
    assert a["admitted"] + a["shed"] == a["total"] == len(lines)


@pytest.mark.parametrize("name", ["cancel-storm", "flash-crowd"])
def test_simulate_cancels_shed_strictly_less_than_orders(name):
    # under a mix that sheds, class-0 (cancel/payout) shed rate is
    # STRICTLY below class-2 (new order) shed rate
    lines = [dumps_order(m) for m in WL.storm_stream(
        name, 2000, num_symbols=8, num_accounts=16, seed=0)]
    wins = WL.storm_windows(name, 2000, num_symbols=8, num_accounts=16)
    sim = simulate_overload(lines, wins, OverloadController(high_lag=24))
    assert sim["shed"] > 0
    snap = sim["controller"]
    offered = {c: snap["admitted_by_class"][c] + snap["shed_by_class"][c]
               for c in range(3)}
    assert offered[CLS_ORDER] > 0
    rate_order = snap["shed_by_class"][CLS_ORDER] / offered[CLS_ORDER]
    if offered[CLS_DRAIN]:
        assert snap["shed_by_class"][CLS_DRAIN] / offered[CLS_DRAIN] \
            < rate_order


@pytest.mark.parametrize("name", PROFILES)
def test_simulated_storm_equals_jax(name):
    """Each profile's stream, replayed through both packages' controller
    simulation at a shedding watermark, admits the same records."""
    kw = dict(num_symbols=8, num_accounts=16)
    msgs = WL.storm_stream(name, 1200, seed=5, **kw)
    assert _rows(msgs) == _rows(JWL.storm_stream(name, 1200, seed=5, **kw))
    wins = WL.storm_windows(name, 1200, **kw)
    assert wins == JWL.storm_windows(name, 1200, **kw)
    lines = [dumps_order(m) for m in msgs]
    a = simulate_overload(lines, wins, OverloadController(high_lag=16))
    b = JB.simulate_overload(lines, wins, JB.OverloadController(high_lag=16))
    assert a == b
