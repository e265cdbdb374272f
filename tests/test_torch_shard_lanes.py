"""The port's sharded lanes engine (`kme_tpu_torch/parallel/mesh.py`,
`LaneSession(shards > 1)`) against the JAX package's (`shard_map` over
the 8-device virtual CPU mesh of tests/conftest.py) and the oracle, on
CPU tensors; every comparison exact (tolerance 0).

- `LaneSession(shards=2)` == `kme_tpu`'s == the oracle on the
  tests/test_sharding.py analog with PAYOUT barriers (the sharded
  settle): lines, exported state, the canonical payload, counters and
  histograms; and the barrier scenario of tests/test_sharding.py:36 at 4
  shards;
- the sharded step (each lane block's step, then the merge) equals the
  one-device full-width step on a carried state, and a step of NOPs
  leaves the state as it was (the card's graph capture warms up on it);
- a lanes snapshot saved at 1 shard restores at 4 and back, across the
  two packages (tests/test_checkpoint.py:97-103);
- `slow`: shards 1, 2, 4 and 8 against the oracle on a longer stream.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import kme_tpu.opcodes as jop
from kme_tpu.oracle import OracleEngine
from kme_tpu.runtime import checkpoint as JCK
from kme_tpu.runtime.session import LaneSession as JaxSession
from kme_tpu.wire import OrderMsg as JaxOrder
from kme_tpu.workload import zipf_symbol_stream
from kme_tpu.engine.lanes import LaneConfig as JaxConfig
from kme_tpu_torch.engine import lanes as L
from kme_tpu_torch.parallel import mesh
from kme_tpu_torch.runtime import checkpoint as ck
from kme_tpu_torch.runtime.session import LaneSession
from kme_tpu_torch.wire import OrderMsg

torch.set_num_threads(1)

# tests/test_sharding.py:18
CFG = dict(lanes=16, slots=128, accounts=64, max_fills=32, steps=32)


def _port(msgs):
    return [OrderMsg(**dataclasses.asdict(m)) for m in msgs]


def _stream(n=400, seed=4):
    return zipf_symbol_stream(n, num_symbols=16, num_accounts=32, seed=seed,
                              payout_per_mille=8)


def _oracle(msgs):
    ora = OracleEngine("fixed")
    return [[r.wire() for r in ora.process(m.copy())] for m in msgs], ora


def _jax_canonical(jses):
    st = jax.tree.map(np.asarray, jses.state)
    return {k: (np.stack(v) if isinstance(v, tuple) else v)
            for k, v in st.items() if k != "fillbuf"}


def test_sharded_lanes_match_jax_and_oracle(cpu_devices):
    msgs = _stream()
    want, _ = _oracle(msgs)
    cfg = L.LaneConfig(**CFG)
    port = LaneSession(cfg, shards=2, device="cpu")
    jses = JaxSession(JaxConfig(**CFG), shards=2)
    assert port.shards == 2 and port.dev_cfg.width == 0
    got = port.process_wire(_port(msgs))
    assert got == jses.process_wire(msgs) == want
    assert port.export_state() == jses.export_state()
    canon = port.export_canonical()
    jcanon = _jax_canonical(jses)
    assert sorted(canon) == sorted(jcanon)
    for k, v in jcanon.items():
        np.testing.assert_array_equal(canon[k], v, err_msg=k)
    assert port.metrics() == jses.metrics()
    assert port.metrics()["barriers"] > 0
    assert port.histograms() == jses.histograms()


def test_sharded_barrier_ops_match_jax_and_oracle(cpu_devices):
    """tests/test_sharding.py:36 at 4 shards: the owning shard wipes and
    settles; balances merge identically."""
    msgs = [JaxOrder(action=jop.CREATE_BALANCE, aid=1),
            JaxOrder(action=jop.TRANSFER, aid=1, size=100000),
            JaxOrder(action=jop.CREATE_BALANCE, aid=2),
            JaxOrder(action=jop.TRANSFER, aid=2, size=100000)]
    for s in range(4):
        msgs.append(JaxOrder(action=jop.ADD_SYMBOL, sid=s))
    for s in range(4):
        msgs.append(JaxOrder(action=jop.BUY, oid=10 + s, aid=1, sid=s,
                             price=50, size=3))
        msgs.append(JaxOrder(action=jop.SELL, oid=20 + s, aid=2, sid=s,
                             price=45, size=2))
    msgs += [JaxOrder(action=jop.PAYOUT, sid=2, size=97),
             JaxOrder(action=jop.REMOVE_SYMBOL, sid=3),
             JaxOrder(action=jop.PAYOUT, sid=-1, size=97)]
    kw = dict(lanes=4, slots=16, accounts=16, max_fills=8, steps=8)
    want, ora = _oracle(msgs)
    port = LaneSession(L.LaneConfig(**kw), shards=4, device="cpu")
    jses = JaxSession(JaxConfig(**kw), shards=4)
    got = [[r.wire() for r in recs] for recs in port.process(_port(msgs))]
    assert got == want
    assert got == [[r.wire() for r in recs] for recs in jses.process(msgs)]
    assert port.export_state()["balances"] == dict(ora.balances)
    assert port.export_state() == jses.export_state()


def test_sharded_step_equals_one_device_step():
    """Each lane block's step plus the merge == the one-device step at
    full width, from the same carried state and window; a step of NOPs
    leaves the state as it was."""
    cfg = L.LaneConfig(**CFG)
    ses = LaneSession(cfg, width=0, device="cpu")
    ses.process_wire(_port(_stream(300, seed=9)))
    assert ses.metrics()["open_orders"] > 0
    one = {k: v.clone() for k, v in ses.state.items()}
    four = {k: v.clone() for k, v in ses.state.items()}
    T = 4
    rng = np.random.default_rng(1)
    io1 = L.make_step_io(cfg, T, "cpu")
    win = io1["win"]
    for t in range(T):
        lanes_ = rng.permutation(cfg.lanes)[:10]
        aids = rng.permutation(len(ses.scheduler.aid_idx))[:10]
        for j, (ln, a) in enumerate(zip(lanes_, aids)):
            win[t, :, ln] = torch.tensor(
                [1 + (j % 3), 10**6 + 100 * t + j, a,
                 int(rng.integers(30, 70)), int(rng.integers(1, 20)), ln])
    io1["win32"].copy_(win[:, 2:].to(torch.int32))
    io4 = {k: v.clone() for k, v in io1.items()}
    step1 = L.build_lane_step(cfg)
    step4 = mesh.ShardedStep(cfg, 4, "cpu")
    for _ in range(T):
        step1(one, io1)
        step4(four, io4)
    for k in one:
        assert torch.equal(one[k], four[k]), k
    for k in ("out", "fills", "t"):
        assert torch.equal(io1[k][:T] if k != "t" else io1[k],
                           io4[k][:T] if k != "t" else io4[k]), k
    assert int(one["metrics"][L.MET_MSGS]) > int(
        ses.state["metrics"][L.MET_MSGS])
    # a NOP step (the capture's warm-up) is the identity
    before = {k: v.clone() for k, v in four.items()}
    L.idle_step_io(cfg, io4)
    step4(four, io4)
    for k in before:
        assert torch.equal(four[k], before[k]), k
    with pytest.raises(ValueError, match="full width"):
        L.build_lane_step(dataclasses.replace(cfg, width=8), mesh.AXIS)
    with pytest.raises(ValueError, match="divisible"):
        LaneSession(cfg, shards=3, device="cpu")


def test_lanes_snapshot_restores_across_shards_and_packages(cpu_devices,
                                                            tmp_path):
    """tests/test_checkpoint.py:97-103 across packages: a port session
    at 1 shard (compact) snapshots; kme_tpu restores it at 4 shards and
    snapshots; the port restores that at 4 shards and snapshots; kme_tpu
    restores it at 1. Lines and the end state equal one unsharded run's."""
    msgs = _stream(480, seed=6)
    cuts = (150, 270, 390)
    cfg = L.LaneConfig(**CFG)
    full = LaneSession(cfg, device="cpu")
    want = full.process_wire(_port(msgs))
    a = LaneSession(cfg, width=16, device="cpu")
    got = a.process_wire(_port(msgs[:cuts[0]]))
    ck.save_session(str(tmp_path / "a"), a, offset=cuts[0])
    b, off = JCK.load_session(str(tmp_path / "a"), shards=4)
    assert off == cuts[0] and b.shards == 4
    got += b.process_wire(msgs[cuts[0]:cuts[1]])
    JCK.save_session(str(tmp_path / "b"), b, offset=cuts[1])
    c, off = ck.load_session(str(tmp_path / "b"), shards=4, device="cpu")
    assert off == cuts[1] and c.shards == 4 and c.dev_cfg.width == 0
    got += c.process_wire(_port(msgs[cuts[1]:cuts[2]]))
    ck.save_session(str(tmp_path / "c"), c, offset=cuts[2])
    d, off = JCK.load_session(str(tmp_path / "c"), shards=1)
    assert off == cuts[2] and d.shards == 1
    got += d.process_wire(msgs[cuts[2]:])
    assert got == want
    assert d.export_state() == full.export_state()


@pytest.mark.slow
def test_sharded_determinism_and_oracle_parity():
    """tests/test_sharding.py:16: the same stream at every shard count."""
    msgs = zipf_symbol_stream(1500, num_symbols=16, num_accounts=32, seed=4)
    want, _ = _oracle(msgs)
    cfg = L.LaneConfig(**CFG)
    states = {}
    for shards in (1, 2, 4, 8):
        ses = LaneSession(cfg, shards=shards, device="cpu")
        assert ses.process_wire(_port(msgs)) == want, shards
        states[shards] = ses.export_state()
    assert states[2] == states[1] == states[4] == states[8]
