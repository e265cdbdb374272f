"""The port's live N->M resharding (`kme_tpu_torch/bridge/reshard.py`)
against the JAX package's, on the CPU.

Exact equality throughout (tolerance 0):
- `plan_reshard`, `partition_engines` (the partitioned oracle snapshots
  byte for byte) and `settlement_legs` equal `kme_tpu`'s;
- the surgery chain reproduces the single-leader oracle across the
  barrier (`verify_groups_reshard`);
- the coordinator over an old generation that `kme_tpu` wrote: its
  `reshard.json` and the new generation's MatchIn logs equal
  `kme_tpu`'s coordinator's; a re-run after a kill between migrate and
  settle regenerates the same stamps, which the broker suppresses;
- a topology that does not match the journal is refused, and the old
  generation stays fenced.
"""

import json
import os

import pytest
import torch

from kme_tpu.bridge import front as JF
from kme_tpu.bridge import lease as JL
from kme_tpu.bridge import reshard as JR
from kme_tpu.bridge.broker import InProcessBroker as JaxBroker
from kme_tpu.oracle import OracleEngine as JaxOracle
from kme_tpu.runtime import checkpoint as JCK
from kme_tpu.wire import dumps_order
from kme_tpu.workload import cross_account_stream
from kme_tpu_torch.bridge import front as F
from kme_tpu_torch.bridge import lease
from kme_tpu_torch.bridge import reshard as rs
from kme_tpu_torch.bridge.broker import InProcessBroker
from kme_tpu_torch.oracle import OracleEngine
from kme_tpu_torch.runtime import checkpoint as ck
from kme_tpu_torch.wire import parse_order

torch.set_num_threads(1)

SLOTS, FILLS, PREFUND = 128, 16, 8


def _lines(events=500, n=2, seed=7):
    return [dumps_order(m) for m in cross_account_stream(
        events, 128, 32, n, seed=seed, cross_frac=0.5)]


def _engines(engine, substreams):
    engines = [engine("fixed", SLOTS, FILLS) for _ in substreams]
    outs = []
    for eng, sub in zip(engines, substreams):
        outs.append([r.wire() for ln in sub
                     for r in eng.process(parse_order(ln))])
    return engines, outs


def _state(eng):
    return (eng.balances, eng.positions, eng.books, eng.buckets,
            {oid: vars(o) for oid, o in eng.orders.items()})


def _snap_states(save, engines, root):
    """Each engine saved by `save`, loaded back by the port's loader
    (which reads either package's oracle snapshots without `kme_tpu`)."""
    out = []
    for k, eng in enumerate(engines):
        d = os.path.join(root, str(k))
        save(d, eng, 7)
        back = ck.load_oracle(d)[0]
        assert type(back) is OracleEngine
        out.append(_state(back))
    return out


def test_plan_and_legs_equal_jax():
    for a, b in ((2, 4), (4, 2), (1, 4), (3, 3)):
        assert rs.rendezvous_minimal_frac(a, b) == \
            JR.rendezvous_minimal_frac(a, b)
    syms, accts = range(512), range(128)
    plan = rs.plan_reshard(2, 4, syms, accts)
    assert plan == JR.plan_reshard(2, 4, syms, accts)
    for s in plan["moved_symbols"]:
        assert F.symbol_group(s, 4) >= 2
    consolidation = {5: 100, 9: 0, 2: 7, 11: -3, 40: 250}
    legs = rs.settlement_legs(consolidation, 4)
    assert legs == JR.settlement_legs(consolidation, 4)
    assert {leg[3] for leg in legs} == {2, 5, 40}
    assert rs.XID_BASE == JR.XID_BASE


def test_partition_engines_equal_jax(tmp_path):
    lines = _lines()
    subs, _ = F.split_lines(lines, 2, prefund=PREFUND)
    old, _ = _engines(OracleEngine, subs)
    jold, _ = _engines(JaxOracle, subs)
    new, cons = rs.partition_engines(old, 4)
    jnew, jcons = JR.partition_engines(jold, 4)
    assert cons == jcons
    assert [_state(e) for e in new] == [_state(e) for e in jnew]
    assert _snap_states(ck.save_oracle, new, str(tmp_path / "p")) == \
        _snap_states(JCK.save_oracle, jnew, str(tmp_path / "j"))
    with pytest.raises(ValueError):
        rs.partition_engines([OracleEngine("java", SLOTS, FILLS)], 4)


def test_reshard_parity_in_process():
    n, m = 2, 4
    lines = _lines(events=500, n=n)
    split_at = len(lines) // 2
    pre_sub, router = F.split_lines(lines[:split_at], n, prefund=PREFUND)
    old, actual_pre = _engines(OracleEngine, pre_sub)
    new, consolidation = rs.partition_engines(old, m)
    actual_post = [[] for _ in range(m)]
    for g, _seq, _xid, _aid, _amt, line in rs.settlement_legs(
            consolidation, m):
        actual_post[g].extend(r.wire() for r in new[g].process(
            parse_order(line)))
    router.reshard(m)
    for ln in lines[split_at:]:
        for g, routed in router.route_line(ln):
            actual_post[g].extend(r.wire() for r in new[g].process(
                parse_order(routed)))
    rep = F.verify_groups_reshard(
        lines, split_at, actual_pre, actual_post, compat="fixed",
        book_slots=SLOTS, max_fills=FILLS, prefund=PREFUND)
    assert rep["ok"], rep["mismatches"][:2]
    assert rep == JF.verify_groups_reshard(
        lines, split_at, actual_pre, actual_post, compat="fixed",
        book_slots=SLOTS, max_fills=FILLS, prefund=PREFUND)


def _seed_old_generation(root, n, lines):
    """A drained old generation written by the JAX package: per-group
    oracle snapshot, lease grant and persisted MatchIn log."""
    subs, _router = JF.split_lines(lines, n, prefund=PREFUND)
    engines, _outs = _engines(JaxOracle, subs)
    for k, (eng, sub) in enumerate(zip(engines, subs)):
        gdir = os.path.join(root, f"group{k}")
        JL.acquire(gdir)
        JCK.save_oracle(gdir, eng, len(sub))
        b = JaxBroker(persist_dir=os.path.join(gdir, "broker-log"))
        b.create_topic(f"MatchIn.g{k}")
        for i, ln in enumerate(sub):
            b.produce(f"MatchIn.g{k}", None, ln, out_seq=i)
        b.sync()


def _log(root, k):
    b = InProcessBroker(persist_dir=os.path.join(root, f"group{k}",
                                                 "broker-log"))
    return [(r.epoch, r.out_seq, r.value)
            for r in b.fetch(f"MatchIn.g{k}", 0, 10 ** 6)]


def _journal(root):
    with open(os.path.join(root, "reshard.json"), encoding="utf-8") as f:
        j = json.load(f)
    for k in ("t", "old_root", "new_root"):
        j.pop(k, None)
    for phase in j.values():
        if isinstance(phase, dict):
            for k in [k for k in phase if k.endswith("_s") or k == "t"]:
                phase.pop(k)
    return j


def test_coordinator_equals_jax_and_resumes_after_a_kill(tmp_path):
    n, m = 2, 4
    lines = _lines(events=300, n=n)
    for who in ("p", "j"):
        _seed_old_generation(str(tmp_path / f"{who}0"), n, lines)
    new, jnew = str(tmp_path / "p1"), str(tmp_path / "j1")
    j1 = rs.ReshardCoordinator(str(tmp_path / "p0"), new, n, m).run()
    JR.ReshardCoordinator(str(tmp_path / "j0"), jnew, n, m).run()
    assert j1["done"] and j1["settle"]["legs"] > 0
    assert _journal(new) == _journal(jnew)
    logs = [_log(new, k) for k in range(m)]
    assert logs == [_log(jnew, k) for k in range(m)]
    for k in range(m):
        assert type(ck.load_oracle(os.path.join(new, f"group{k}"))[0]) \
            is OracleEngine
    # a kill after migrate, before settle was journaled: the re-run
    # regenerates the same stamped legs and the broker swallows them
    coord = rs.ReshardCoordinator(str(tmp_path / "p0"), new, n, m)
    with open(coord.journal_path, encoding="utf-8") as f:
        j = json.load(f)
    del j["settle"]
    del j["done"]
    with open(coord.journal_path, "w", encoding="utf-8") as f:
        json.dump(j, f)
    j2 = rs.ReshardCoordinator(str(tmp_path / "p0"), new, n, m).run()
    assert j2["settle"]["legs"] == j1["settle"]["legs"]
    assert j2["settle"]["dup_suppressed"] == j1["settle"]["legs"]
    assert [_log(new, k) for k in range(m)] == logs


def test_coordinator_refuses_topology_mismatch(tmp_path):
    lines = _lines(events=200)
    old, new = str(tmp_path / "r0"), str(tmp_path / "r1")
    _seed_old_generation(old, 2, lines)
    rs.ReshardCoordinator(old, new, 2, 4).run()
    with pytest.raises(ValueError, match="different reshard"):
        rs.ReshardCoordinator(old, new, 2, 8).run()
    empty = str(tmp_path / "e0")
    for k in range(2):
        os.makedirs(os.path.join(empty, f"group{k}"))
    with pytest.raises(ValueError, match="drained"):
        rs.ReshardCoordinator(empty, str(tmp_path / "e1"), 2, 4).run()


def test_old_generation_stays_fenced(tmp_path):
    lines = _lines(events=200)
    old, new = str(tmp_path / "r0"), str(tmp_path / "r1")
    _seed_old_generation(old, 2, lines)
    g0 = os.path.join(old, "group0")
    assert rs.probe_fenced(g0) is False
    rs.ReshardCoordinator(old, new, 2, 4).run()
    for k in range(2):
        gdir = os.path.join(old, f"group{k}")
        stolen = lease.current_epoch(gdir)
        assert rs.probe_fenced(gdir, epoch=stolen - 1) is True
        assert JR.probe_fenced(gdir, epoch=stolen - 1) is True
    for k in range(4):
        gdir = os.path.join(new, f"group{k}")
        assert lease.acquire(gdir) >= 2


def test_reshard_cli(tmp_path):
    from kme_tpu_torch.cli import reshard_main

    lines = _lines(events=200)
    old, new = str(tmp_path / "r0"), str(tmp_path / "r1")
    _seed_old_generation(old, 2, lines)
    assert reshard_main(["--old-root", old, "--new-root", new,
                         "--old-groups", "2", "--new-groups", "4"]) == 0
    # re-running is a no-op (journal resume, stamps dedup)
    assert reshard_main(["--old-root", old, "--new-root", new,
                         "--old-groups", "2", "--new-groups", "4"]) == 0
    assert _journal(new)["done"]
