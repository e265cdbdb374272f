"""The port's autoscaling policy (`kme_tpu_torch/bridge/autoscale.py`),
a pure state machine, against the JAX package's.

The analogs of tests/test_autoscale.py's cases pin determinism (same
trace -> byte-identical decisions), the threefold hysteresis (dwell,
watermark gap, cooldown) and the power-of-two group ladder with its
min/max clamps. The parity case replays numpy-seeded random gauge traces
through both packages' `simulate_autoscale` and `tick_event`: equal
decisions and tick events (tolerance 0).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from kme_tpu.bridge import autoscale as JAS
from kme_tpu_torch.bridge import autoscale as AS
from kme_tpu_torch.bridge.autoscale import (AutoscaleConfig,
                                            AutoscaleController,
                                            shard_imbalance,
                                            simulate_autoscale)

torch.set_num_threads(1)

CFG = AutoscaleConfig(dwell=3, cooldown=4, high_lag=48.0, low_lag=4.0)


def _hot(groups=2):
    return {"groups": groups, "lags": [100.0] * groups}


def _cold(groups=2):
    return {"groups": groups, "lags": [0.0] * groups}


# -- config + imbalance ------------------------------------------------


def test_config_validation():
    with pytest.raises(ValueError):
        AutoscaleConfig(min_groups=0)
    with pytest.raises(ValueError):
        AutoscaleConfig(min_groups=4, max_groups=2)
    with pytest.raises(ValueError):
        AutoscaleConfig(high_lag=4.0, low_lag=4.0)  # no watermark gap
    with pytest.raises(ValueError):
        AutoscaleConfig(dwell=0)
    with pytest.raises(ValueError):
        AutoscaleConfig(cooldown=-1)


def test_shard_imbalance():
    assert shard_imbalance([]) == 1.0
    assert shard_imbalance([0.0, 0.0]) == 1.0   # mean 0 guard
    assert shard_imbalance([5.0, 5.0]) == 1.0
    assert shard_imbalance([30.0, 10.0]) == pytest.approx(1.5)


# -- hysteresis --------------------------------------------------------


def test_dwell_delays_the_split():
    ctl = AutoscaleController(CFG)
    assert ctl.observe(2, [100.0, 100.0]) is None
    assert ctl.observe(2, [100.0, 100.0]) is None
    d = ctl.observe(2, [100.0, 100.0])
    assert d is not None and d["action"] == "split"
    assert d["from"] == 2 and d["to"] == 4 and d["streak"] == 3


def test_streak_resets_on_a_calm_tick():
    ctl = AutoscaleController(CFG)
    ctl.observe(2, [100.0, 100.0])
    ctl.observe(2, [100.0, 100.0])
    ctl.observe(2, [10.0, 10.0])    # neither hot nor cold: resets both
    assert ctl.observe(2, [100.0, 100.0]) is None
    assert ctl.observe(2, [100.0, 100.0]) is None
    assert ctl.observe(2, [100.0, 100.0])["action"] == "split"


def test_cooldown_swallows_ticks():
    ctl = AutoscaleController(CFG)
    for _ in range(3):
        d = ctl.observe(2, [100.0, 100.0])
    assert d["action"] == "split"
    # still red-hot, but the reshard in flight must not be
    # second-guessed: cooldown ticks propose nothing (the streak keeps
    # accumulating, so a STILL-hot system escalates right after)
    for _ in range(CFG.cooldown):
        assert ctl.observe(4, [100.0] * 4) is None
    d = ctl.observe(4, [100.0] * 4)
    assert d is not None and d["to"] == 8


def test_overload_state_counts_as_hot():
    ctl = AutoscaleController(CFG)
    for _ in range(2):
        assert ctl.observe(2, [1.0, 1.0], overload_states=[1, 0]) is None
    d = ctl.observe(2, [1.0, 1.0], overload_states=[0, 2])
    assert d is not None and d["action"] == "split" and d["overloaded"]


def test_imbalance_counts_as_hot():
    ctl = AutoscaleController(CFG)
    lags = [20.0, 0.0, 0.0, 0.0]  # below high_lag, imbalance 4.0
    assert shard_imbalance(lags) >= CFG.high_imbalance
    for _ in range(2):
        assert ctl.observe(4, lags) is None
    assert ctl.observe(4, lags)["action"] == "split"


def test_merge_on_cold_streak_and_min_clamp():
    ctl = AutoscaleController(CFG)
    for _ in range(2):
        assert ctl.observe(2, [0.0, 0.0]) is None
    d = ctl.observe(2, [0.0, 0.0])
    assert d is not None and d["action"] == "merge" and d["to"] == 1
    for _ in range(CFG.cooldown):
        ctl.observe(1, [0.0])
    # at min_groups a cold streak proposes nothing
    for _ in range(6):
        assert ctl.observe(1, [0.0]) is None


def test_max_clamp():
    cfg = AutoscaleConfig(dwell=1, cooldown=0, max_groups=8)
    ctl = AutoscaleController(cfg)
    d = ctl.observe(6, [100.0] * 6)
    assert d["to"] == 8           # min(max, 2N)
    assert ctl.observe(8, [100.0] * 8) is None   # at the ceiling


# -- replay ------------------------------------------------------------


def _trace():
    t = []
    t.append(_hot(2))                       # first sample pins groups
    for _ in range(20):
        t.append({"lags": [100.0, 100.0], "overload": [1, 1]})
    for _ in range(20):
        t.append({"lags": [0.5] * 4})
    return t


def test_simulate_autoscale_deterministic():
    a = simulate_autoscale(_trace(), CFG)
    b = simulate_autoscale(_trace(), CFG)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert a["decisions"], "trace must trigger at least one decision"
    # groups follow proposals during replay: the hot phase splits 2→4,
    # the cold phase merges back down
    actions = [d["action"] for d in a["decisions"]]
    assert actions[0] == "split"
    assert "merge" in actions
    assert a["final_groups"] <= 4


def test_simulate_requires_initial_groups():
    with pytest.raises(ValueError, match="groups"):
        simulate_autoscale([{"lags": [1.0]}])


def test_no_flapping_on_oscillating_trace():
    """A trace that alternates hot/cold every tick must produce ZERO
    decisions: dwell demands consecutive ticks of the same colour."""
    ctl = AutoscaleController(CFG)
    for i in range(40):
        lags = [100.0, 100.0] if i % 2 == 0 else [0.0, 0.0]
        assert ctl.observe(2, lags) is None


# -- parity with the JAX package ----------------------------------------


def _random_trace(rng, n):
    """A gauge trace that wanders between hot, cold and calm phases, with
    overload codes and pinned group counts now and then."""
    t = [{"groups": int(rng.choice([1, 2, 4, 8])), "lags": [0.0]}]
    level = 10.0
    for _ in range(n):
        level = float(np.clip(level * rng.choice([0.5, 1.0, 2.0]), 0.5,
                              200.0))
        g = int(rng.integers(1, 9))
        s = {"lags": [round(float(x), 3)
                      for x in rng.exponential(level, size=g)],
             "overload": [int(x) for x in rng.choice(
                 [0, 0, 0, 0, 1, 2], size=g)]}
        if rng.random() < 0.1:
            s["groups"] = g
        if rng.random() < 0.2:
            s["tick"] = int(rng.integers(0, 1000))
        t.append(s)
    return t


@pytest.mark.parametrize("seed", range(4))
def test_simulate_and_tick_events_match_jax(seed):
    rng = np.random.default_rng(seed)
    kw = dict(dwell=int(rng.integers(1, 4)),
              cooldown=int(rng.integers(0, 6)), high_lag=48.0,
              low_lag=4.0, max_groups=8)
    trace = _random_trace(rng, 300)
    got = AS.simulate_autoscale(trace, AS.AutoscaleConfig(**kw))
    want = JAS.simulate_autoscale(trace, JAS.AutoscaleConfig(**kw))
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert got["decisions"], "the trace must trigger a decision"
    # the monitor's per-tick payloads, with groups following proposals
    ctl, jctl = AS.AutoscaleController(AS.AutoscaleConfig(**kw)), \
        JAS.AutoscaleController(JAS.AutoscaleConfig(**kw))
    groups = trace[0]["groups"]
    for s in trace:
        groups = s.get("groups", groups)
        lags, ov = s.get("lags", ()), s.get("overload", ())
        d, jd = ctl.observe(groups, lags, ov), jctl.observe(groups, lags, ov)
        assert d == jd
        assert AS.tick_event(ctl, groups, lags, ov, d) == \
            JAS.tick_event(jctl, groups, lags, ov, jd)
        if d is not None:
            groups = d["to"]
    assert dataclasses.asdict(ctl.cfg) == dataclasses.asdict(jctl.cfg)
