"""The port's seq fleet (`kme_tpu_torch/parallel/seqmesh.py`) against the
JAX package's (`kme_tpu/parallel/seqmesh.py`) and the oracle, on CPU
tensors; every comparison exact (tolerance 0).

- The pure host pieces, port vs `kme_tpu` on seeded inputs:
  `plan_windows` at 2 and 8 shards, `plan_dispatch`, `plan_rebalance`,
  `select_balances` (and its torch form), `apply_placement` and
  `slice_windows` (native and numpy).
- Sessions: the port's `SeqMeshSession(shards=2)`, async, against
  `kme_tpu`'s on the JAX package's 8-device virtual CPU mesh and the
  fixed-mode oracle (tests/test_seqmesh.py's stream): lines, exported
  state, the stacked shard states plane for plane, counters, histograms
  and the stall schedule. Then, port only, async vs lockstep vs one
  `SeqSession` at 4 shards over zipf-hot fed in slices of 300, with
  migrations observed (the analog of tests/test_async_dispatch.py:51).
- `slow`, as the reference marks them: the payout storm, a mid-stream
  drain and export, `wall_feed` parity and 8 shards.
"""

import numpy as np
import pytest
import torch

from kme_tpu.engine import seq as JSQ
from kme_tpu.native import sched as jsched
from kme_tpu.oracle import OracleEngine
from kme_tpu.parallel import seqmesh as JM
from kme_tpu_torch.engine import seq as SQ
from kme_tpu_torch.native import sched as psched
from kme_tpu_torch.parallel import seqmesh as PM
from kme_tpu_torch.runtime.seqsession import SeqSession
from kme_tpu_torch.workload import (payout_storm_stream, zipf_hot_stream,
                                    zipf_symbol_stream)

torch.set_num_threads(1)

# tests/test_seqmesh.py:21-22
CFG = dict(lanes=8, slots=128, accounts=128, max_fills=16,
           pos_cap=1 << 10, probe_max=8)
SLICE = 300   # rebalancing fires between process_wire calls only


def _stream(n=900, seed=11):
    """tests/test_seqmesh.py:25."""
    return zipf_symbol_stream(n, num_symbols=8, num_accounts=24,
                              seed=seed, zipf_a=1.0, payout_per_mille=5)


def _port(shards, **kw):
    return PM.SeqMeshSession(SQ.SeqConfig(**CFG), shards=shards,
                             device="cpu", **kw)


def _jax(shards, **kw):
    return JM.SeqMeshSession(JSQ.SeqConfig(**CFG), shards=shards, **kw)


def _sliced(ses, msgs):
    got = []
    for lo in range(0, len(msgs), SLICE):
        for per in ses.process_wire(msgs[lo:lo + SLICE]):
            got.extend(per)
    return got


def _serial(msgs):
    ses = SeqSession(SQ.SeqConfig(**CFG), device="cpu")
    return [ln for per in ses.process_wire(msgs) for ln in per], ses


def _oracle_lines(msgs):
    ora = OracleEngine("fixed", book_slots=CFG["slots"],
                       max_fills=CFG["max_fills"])
    return [r.wire() for m in msgs for r in ora.process(m.copy())]


# ---------------------------------------------------------------------------
# pure host pieces


@pytest.mark.parametrize("shards", [2, 8])
def test_plan_windows_and_dispatch_equal_jax(cpu_devices, shards):
    msgs = _stream(n=700, seed=5)
    jses, pses = _jax(shards), _port(shards)
    cols, _ = jses.router.route(msgs)
    pcols, _ = pses.router.route(msgs)
    for k in cols:
        np.testing.assert_array_equal(pcols[k], cols[k], err_msg=k)
    # a placement that is not the identity, and sticky homes carried
    perm = np.random.default_rng(shards).permutation(8).astype(np.int64)
    jses._perm, pses._perm = perm.copy(), perm.copy()
    jw, jp, jc, jk = jses.plan_windows(cols)
    pw, pp, pc, pk = pses.plan_windows(cols)
    assert (pp, pk) == (jp, jk)
    np.testing.assert_array_equal(pc, jc)
    assert sorted(pw) == sorted(jw)
    for f in jw:
        np.testing.assert_array_equal(pw[f], jw[f], err_msg=f)
    assert pses._acct_lane == jses._acct_lane
    jd, pd = jses.plan_dispatch(cols, jp), pses.plan_dispatch(cols, pp)
    assert sorted(pd) == sorted(jd)
    for key in ("W", "deps", "barriers", "T_async", "T_lock"):
        assert pd[key] == jd[key], key
    np.testing.assert_array_equal(pd["busy"], jd["busy"])
    np.testing.assert_array_equal(pd["final_sel"], jd["final_sel"])
    assert sorted(pd["merge_sel"]) == sorted(jd["merge_sel"])
    for w, sel in jd["merge_sel"].items():
        np.testing.assert_array_equal(pd["merge_sel"][w], sel)
    assert jd["barriers"] and jd["deps"]


@pytest.mark.parametrize("shards", [2, 4])
def test_plan_rebalance_equal_jax(shards):
    rng = np.random.default_rng(7)
    for trial in range(20):
        load = rng.exponential(1.0, 16) * (rng.random(16) < 0.7)
        load[rng.integers(16)] += 10.0 * trial
        perm = rng.permutation(16).astype(np.int64)
        for thr in (1.0, 1.25):
            want = JM.plan_rebalance(load, perm, shards, threshold=thr)
            got = PM.plan_rebalance(load, perm, shards, threshold=thr)
            assert (got is None) == (want is None)
            if want is not None:
                np.testing.assert_array_equal(got, want)
    assert PM.plan_rebalance(np.zeros(16), np.arange(16), shards) is None


def test_select_balances_equal_jax_and_torch_form():
    rng = np.random.default_rng(3)
    arows = 4
    parts = [{k: rng.integers(-2**31, 2**31, (arows, 128), dtype=np.int64)
              .astype(np.int32) for k in SQ.BAL_KEYS} for _ in range(3)]
    sel = rng.integers(0, 3, arows * 128).astype(np.int32)
    want = JSQ.select_balances(parts, sel)
    got = SQ.select_balances(parts, sel)
    tgot = SQ.select_balances_t(
        [{k: torch.from_numpy(v) for k, v in p.items()} for p in parts],
        torch.from_numpy(sel.astype(np.int64)))
    assert SQ.BAL_KEYS == JSQ.BAL_KEYS
    for k in SQ.BAL_KEYS:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(tgot[k].numpy(), want[k])


@pytest.mark.parametrize("native", [True, False])
def test_apply_placement_and_slice_windows_equal_jax(native, monkeypatch):
    if not native:
        monkeypatch.setenv("KME_NATIVE", "0")
    rng = np.random.default_rng(5)
    perm = rng.permutation(16).astype(np.int64)
    lanes = rng.integers(0, 16, 200).astype(np.int32)
    for a, b in zip(psched.apply_placement(perm, lanes, 4),
                    jsched.apply_placement(perm, lanes, 4)):
        np.testing.assert_array_equal(a, b)
    K, shards, bw = 6, 4, 128
    wins = {f: rng.integers(-2**31, 2**31, (K, shards * bw),
                            dtype=np.int64).astype(np.int32)
            for f in ("act", "lane", "oid_lo")}
    for idx in ([], [0], [1, 3, 4], [0, 1, 2, 3, 4]):
        for s in range(shards):
            got = psched.slice_windows(wins, idx, s, shards, bw)
            want = jsched.slice_windows(wins, idx, s, shards, bw)
            assert sorted(got) == sorted(want)
            for f in want:
                np.testing.assert_array_equal(got[f], want[f])


# ---------------------------------------------------------------------------
# sessions


def test_fleet_matches_jax_and_oracle_at_2_shards(cpu_devices):
    """The port's async fleet at 2 shards == kme_tpu's == the oracle:
    lines, exported state, both packages' per-shard states stacked,
    counters, histograms and the deterministic stall schedule."""
    msgs = _stream(n=400)
    port, jax_ = _port(2), _jax(2)
    assert port.dispatch == jax_.dispatch == "async"
    got = [ln for per in port.process_wire(msgs) for ln in per]
    want = [ln for per in jax_.process_wire(msgs) for ln in per]
    assert got == want == _oracle_lines(msgs)
    assert port.export_state() == jax_.export_state()
    jstate = jax_._gather_state_async()
    pstate = port.gather_state()
    assert sorted(pstate) == sorted(jstate)
    for k, v in jstate.items():
        np.testing.assert_array_equal(pstate[k], np.asarray(v), err_msg=k)
    assert port.metrics() == jax_.metrics()
    assert port.histograms() == jax_.histograms()
    assert port.shard_stats() == jax_.shard_stats()
    for key in ("chip_stall_frac", "chip_stall_frac_lockstep"):
        assert port.stall_stats()[key] == jax_.stall_stats()[key]


@pytest.mark.parametrize("dispatch", ["async", "lockstep"])
def test_fleet_zipf_hot_4_shards_with_migrations(dispatch):
    """zipf-hot through the fleet at 4 shards, fed in slices so the
    elastic planner migrates lanes BETWEEN batches: lines and exported
    state equal the single SeqSession's, in both dispatch modes
    (tests/test_async_dispatch.py:51)."""
    msgs = zipf_hot_stream(1200, num_symbols=8, num_accounts=24, seed=7)
    mesh = _port(4, dispatch=dispatch)
    assert mesh.dispatch == dispatch
    got = _sliced(mesh, msgs)
    want, single = _serial(msgs)
    assert got == want
    assert mesh.shard_stats()["migrations"] > 0, \
        "stream never migrated — interleaving not adversarial"
    assert mesh.export_state() == single.export_state()
    assert mesh.phases["migrate_s"] > 0


def test_fleet_checks_and_raises():
    cfg = SQ.SeqConfig(**CFG)
    import dataclasses

    with pytest.raises(ValueError, match="fixed-mode"):
        PM.SeqMeshSession(dataclasses.replace(cfg, compat="java"), 2,
                          device="cpu")
    with pytest.raises(ValueError, match="VMEM"):
        PM.SeqMeshSession(dataclasses.replace(cfg, hbm_books=True), 2,
                          device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        PM.SeqMeshSession(cfg, 3, device="cpu")
    with pytest.raises(ValueError, match="dispatch"):
        PM.SeqMeshSession(cfg, 2, dispatch="spmd", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PM.SeqMeshSession(cfg, 2)


# ---------------------------------------------------------------------------
# the heavier analogs (slow, as tests/test_async_dispatch.py marks them)


@pytest.mark.slow
def test_fleet_payout_storm_parity():
    msgs = payout_storm_stream(900, num_symbols=8, num_accounts=24, seed=3)
    mesh = _port(4)
    got = _sliced(mesh, msgs)
    want, single = _serial(msgs)
    assert got == want
    assert mesh.export_state() == single.export_state()


@pytest.mark.slow
@pytest.mark.parametrize("dispatch", ["async", "lockstep"])
def test_fleet_mid_stream_drain_export(dispatch):
    msgs = zipf_symbol_stream(1000, num_symbols=8, num_accounts=24,
                              seed=11, zipf_a=1.0, payout_per_mille=5)
    cut = 617
    mesh = _port(8, dispatch=dispatch)
    got = _sliced(mesh, msgs[:cut])
    want, single = _serial(msgs[:cut])
    assert got == want
    assert mesh.export_state() == single.export_state()


@pytest.mark.slow
def test_fleet_wall_feed_parity():
    msgs = zipf_hot_stream(900, num_symbols=8, num_accounts=24, seed=9)
    mesh = _port(4, wall_feed=True)
    got = _sliced(mesh, msgs)
    want, _ = _serial(msgs)
    assert got == want


@pytest.mark.slow
def test_fleet_8_shards_oracle_and_single(cpu_devices):
    msgs = _stream(n=700, seed=23)
    mesh = _port(8)
    got = mesh.process_wire(msgs)
    want, _ = _serial(msgs)
    assert [ln for per in got for ln in per] == want == _oracle_lines(msgs)
