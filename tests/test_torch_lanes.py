"""The port's sweep (lanes) engine against the JAX package's and the
fixed-mode scalar oracle, on CPU tensors.

- the chunk function (`build_lane_chunk`: input scatter, the scan
  steps, output compaction, fill-log append) against the JAX package's on
  a carried state, in all three single-device variants: full width,
  compact, and compact with pos_dma (the row-copy kernels' plain
  versions; `accounts=96` keeps pos_dma off for the compact case);
- the scenarios of tests/test_lanes_engine.py through the port's
  `LaneSession`, the JAX package's and the oracle: MatchOut lines of
  `process_wire` and `process`, `export_state`, metrics, histograms,
  reason codes and the canonical state;
- the int32 prefix-sum wrap of the JAX package's sweep (a reference bug
  the port reproduces: the port equals `kme_tpu`, both differ from the
  oracle);
- state carried across packages (`load_numpy`), the canonical snapshot
  against `checkpoint.save_session`'s payload, snapshots restored in
  both directions, and the seq engine's canonical state restored into
  the lanes engine and back;
- what the card's step graph relies on, run eagerly here: a step over
  NOP slots (the capture's warm-up) leaves the state as it was, the
  session's window buffers reused across windows of any length give
  what fresh ones give, and the re-capture key changes exactly when a
  state tensor is replaced.

Tolerance 0 everywhere: every value is an integer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kme_tpu.opcodes as jop
from kme_tpu.engine import lanes as JL
from kme_tpu.ops import rowdma as JR
from kme_tpu.oracle import OracleEngine
from kme_tpu.runtime import checkpoint as JCK
from kme_tpu.runtime.sequencer import Scheduler as JaxScheduler
from kme_tpu.runtime.session import LaneEngineError as JaxEngineError
from kme_tpu.runtime.session import LaneSession as JaxSession
from kme_tpu.wire import OrderMsg as JaxOrder
from kme_tpu.workload import (cancel_heavy_stream, harness_stream,
                              zipf_symbol_stream)
from kme_tpu_torch.engine import lanes as L
from kme_tpu_torch.engine import seq as SQ
from kme_tpu_torch.runtime.seqsession import SeqSession
from kme_tpu_torch.runtime.sequencer import (CapacityError, EnvelopeError,
                                             Scheduler)
from kme_tpu_torch.runtime.session import (CB_FIELDS, LaneEngineError,
                                           LaneSession)
from kme_tpu_torch.wire import OrderMsg, wire_lines

torch.set_num_threads(1)

CFG = dict(lanes=8, slots=128, accounts=64, max_fills=32, steps=32)
# the three single-device variants: (config, width) -> full width,
# compact without pos_dma (2*96 % 128 != 0), compact with pos_dma
VARIANTS = {"full": (CFG, 0), "compact": (dict(CFG, accounts=96), 16),
            "pos_dma": (CFG, 16)}


def _port(msgs):
    return [OrderMsg(**dataclasses.asdict(m)) for m in msgs]


def _maps(sch):
    return (dict(sch.aid_idx), dict(sch.sid_lane), dict(sch.oid_sid),
            sch._rr_lane)


def _jax_host_state(jses):
    return jax.tree.map(np.asarray, jses.state)


def _canon_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def _jax_canonical(jses):
    """The JAX session's canonical payload, as save_session builds it."""
    st = _jax_host_state(jses)
    S, A = jses.cfg.lanes, jses.cfg.accounts
    out = {}
    for k, v in st.items():
        if k == "fillbuf":
            continue
        v = np.stack(v) if isinstance(v, tuple) else np.asarray(v)
        if k in L._LANE_KEYS:
            v = v[:S]
        elif k in L._POS_KEYS:
            if v.ndim == 3:
                v = _unpack_rows(v)
            v = v.reshape(-1)[:S * A]
        out[k] = v
    return out


def _unpack_rows(v):
    return JR.unpack64_np(v, v.shape[0])


# ---------------------------------------------------------------------------
# scenario streams (tests/test_lanes_engine.py)

def _scenario():
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


def _self_cross():
    O = JaxOrder
    return [O(action=jop.CREATE_BALANCE, aid=1),
            O(action=jop.TRANSFER, aid=1, size=100000),
            O(action=jop.ADD_SYMBOL, sid=0),
            O(action=jop.BUY, oid=1, aid=1, sid=0, price=50, size=3),
            O(action=jop.SELL, oid=2, aid=1, sid=0, price=50, size=3),
            O(action=jop.BUY, oid=3, aid=1, sid=0, price=55, size=4),
            O(action=jop.BUY, oid=4, aid=1, sid=0, price=54, size=4),
            O(action=jop.SELL, oid=5, aid=1, sid=0, price=1, size=20)]


def _slot_overflow():
    O = JaxOrder
    msgs = [O(action=jop.CREATE_BALANCE, aid=1),
            O(action=jop.TRANSFER, aid=1, size=10**6),
            O(action=jop.ADD_SYMBOL, sid=0)]
    return msgs + [O(action=jop.BUY, oid=10 + i, aid=1, sid=0, price=10 + i,
                     size=1) for i in range(5)]


def _credit_wrap():
    O = JaxOrder
    msgs = []
    for a in (0, 1):
        msgs.append(O(action=jop.CREATE_BALANCE, aid=a))
        for _ in range(3):
            msgs.append(O(action=jop.TRANSFER, aid=a, size=2**31 - 1))
    return msgs + [O(action=jop.ADD_SYMBOL, sid=0),
                   O(action=jop.SELL, oid=1, aid=0, sid=0, price=0,
                     size=2**25),
                   O(action=jop.BUY, oid=2, aid=1, sid=0, price=125,
                     size=2**25)]


def _int_min_transfer():
    O = JaxOrder
    return [O(action=jop.CREATE_BALANCE, aid=1),
            O(action=jop.TRANSFER, aid=1, size=-(2**31))]


def _cumsum_wrap():
    """Three resting asks of 2^31-1 at 99, then a BUY of 1 at 99: the JAX
    package's int32 prefix sum wraps (lanes.py:413)."""
    O = JaxOrder
    msgs = []
    for a in range(4):
        msgs.append(O(action=jop.CREATE_BALANCE, aid=a))
        msgs += [O(action=jop.TRANSFER, aid=a, size=2**31 - 1)] * 4
    msgs.append(O(action=jop.ADD_SYMBOL, sid=0))
    msgs += [O(action=jop.SELL, oid=10 + k, aid=k, sid=0, price=99,
               size=2**31 - 1) for k in range(3)]
    return msgs + [O(action=jop.BUY, oid=20, aid=3, sid=0, price=99, size=1)]


SCENARIOS = {
    "end_to_end_w0": (_scenario, CFG, 0, {"barriers": 3}),
    "end_to_end_w1": (_scenario, CFG, 1, {"barriers": 3}),
    "end_to_end_w16": (_scenario, CFG, 16, {"barriers": 3}),
    "self_cross": (_self_cross, CFG, 16, {}),
    "slot_overflow": (_slot_overflow, dict(lanes=2, slots=4, accounts=8,
                                           max_fills=4, steps=8), 16,
                      {"rej_capacity": 1}),
    "credit_wrap": (_credit_wrap, CFG, 16, {}),
    "int_min_transfer": (_int_min_transfer, CFG, 16, {"transfers_ok": 1}),
    "zipf_w0": (lambda: zipf_symbol_stream(
        300, num_symbols=6, num_accounts=40, seed=9, payout_per_mille=8),
        CFG, 0, {}),
    "zipf_w16": (lambda: zipf_symbol_stream(
        300, num_symbols=6, num_accounts=40, seed=9, payout_per_mille=8),
        CFG, 16, {}),
    # the slow-marked workloads of tests/test_lanes_engine.py, shortened
    "harness": (lambda: harness_stream(300, seed=7, payout_opcode_bug=False,
                                       validate=True),
                dict(lanes=4, slots=128, accounts=16, max_fills=32,
                     steps=32), 16, {}),
    "cancel_heavy": (lambda: cancel_heavy_stream(300, num_symbols=8,
                                                 num_accounts=24, seed=9),
                     dict(lanes=8, slots=256, accounts=32, max_fills=32,
                          steps=32), 16, {}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_lane_session_matches_jax_and_oracle(name):
    make, kw, width, want_metrics = SCENARIOS[name]
    msgs = make()
    jses = JaxSession(JL.LaneConfig(**kw), width=width)
    port = LaneSession(L.LaneConfig(**kw), width=width, device="cpu")
    port_rec = LaneSession(L.LaneConfig(**kw), width=width, device="cpu")
    ora = OracleEngine("fixed", book_slots=kw["slots"],
                       max_fills=kw["max_fills"])
    assert port.dev_cfg == L.LaneConfig(**dataclasses.asdict(jses.dev_cfg))

    want = jses.process_wire([m.copy() for m in msgs])
    got = port.process_wire(_port(msgs))
    got_rec = port_rec.process(_port(msgs))
    for i, m in enumerate(msgs):
        oracle = [r.wire() for r in ora.process(m.copy())]
        assert want[i] == oracle, f"JAX vs oracle at message {i}"
        assert got[i] == oracle, f"port wire path at message {i}: {m}"
        assert list(wire_lines(got_rec[i])) == oracle, \
            f"port record path at message {i}: {m}"
    np.testing.assert_array_equal(port.last_reasons, jses.last_reasons)
    np.testing.assert_array_equal(port_rec.last_reasons, jses.last_reasons)

    exp = port.export_state()
    assert exp == jses.export_state()
    assert exp == port_rec.export_state()
    assert exp["balances"] == dict(ora.balances)
    assert exp["positions"] == dict(ora.positions)
    met = port.metrics()
    assert met == jses.metrics()
    assert port.histograms() == jses.histograms()
    for k, v in want_metrics.items():
        assert met[k] == v, k
    _canon_equal(port.export_canonical(), _jax_canonical(jses))


@pytest.mark.parametrize("width", [0, 16])
def test_int32_prefix_wrap_matches_jax_not_oracle(width):
    """Reference bug (ROADMAP Queue C): the JAX package's sweep sums the
    crossing makers' sizes in int32 and wraps, so one BUY of 1 against
    three asks of 2^31-1 echoes a second, zero-size fill and a residual
    of -3. The port reproduces it; the oracle fills once."""
    msgs = _cumsum_wrap()
    jses = JaxSession(JL.LaneConfig(**CFG), width=width)
    port = LaneSession(L.LaneConfig(**CFG), width=width, device="cpu")
    want = jses.process_wire([m.copy() for m in msgs])
    got = port.process_wire(_port(msgs))
    assert got == want
    ora = OracleEngine("fixed", book_slots=CFG["slots"],
                       max_fills=CFG["max_fills"])
    oracle = [[r.wire() for r in ora.process(m.copy())] for m in msgs]
    assert got[:-1] == oracle[:-1] and got[-1] != oracle[-1]
    assert len(oracle[-1]) == 4 and len(got[-1]) == 6
    assert '"oid":11' in got[-1][3] and '"size":0' in got[-1][3]
    assert got[-1][-1].endswith('"size":-3,"next":null,"prev":null}')
    _canon_equal(port.export_canonical(), _jax_canonical(jses))


def _first_window(jses, msgs):
    """Plan `msgs` with the JAX session's scheduler and pack its first
    scan window exactly as LaneSession._dispatch does -> (T, M, cb)."""
    sched = jses.scheduler.plan(msgs)
    cols = sched.cols
    lo = 0
    height = sched.segment_steps[0]
    hi = int(np.searchsorted(cols["segment"], 1))
    order = lo + np.lexsort((cols["lane"][lo:hi], cols["step"][lo:hi]))
    Wn = jses.cfg.window
    widx = order[np.asarray(cols["step"][order]) < Wn]
    from kme_tpu.utils import pow2_bucket

    T = pow2_bucket(min(height, Wn), lo=jses.cfg.steps)
    M = pow2_bucket(max(len(widx), 1))
    return T, M, jses._pack_window(cols, widx, 0, T, M)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_chunk_matches_jax_on_carried_state(variant):
    """A JAX session's state after a head of the stream; the next window
    through both packages' chunk functions: equal packed outputs, equal
    used fill-log prefix, equal state (the fill log's unused tail is
    scratch in both)."""
    kw, width = VARIANTS[variant]
    msgs = zipf_symbol_stream(700, num_symbols=6, num_accounts=40, seed=9)
    jses = JaxSession(JL.LaneConfig(**kw), width=width)
    assert jses.dev_cfg.pos_dma == (variant == "pos_dma")
    jses.process_wire([m.copy() for m in msgs[:400]])
    host = _jax_host_state(jses)
    T, M, cb = _first_window(jses, [m.copy() for m in msgs[400:]])
    assert ((cb["act"] == JL.L_BUY) | (cb["act"] == JL.L_SELL)).sum() > 20
    jst, jouts = JL.build_lane_chunk(jses.dev_cfg, T, M)(
        jax.tree.map(jnp.asarray, host), cb)
    jst = jax.tree.map(np.asarray, jst)

    cfg = L.LaneConfig(**dataclasses.asdict(jses.dev_cfg))
    pst = L.state_from_numpy(cfg, host, "cpu")
    pst, pouts = L.build_lane_chunk(cfg, T, M)(
        pst, {k: torch.from_numpy(v.astype(np.int64)) for k, v in cb.items()})
    np.testing.assert_array_equal(pouts["packed"].numpy(),
                                  np.asarray(jouts["packed"]))
    assert int(pouts["packed"][7, 0]) > 0       # the window filled
    off = int(jst["filloff"][0])
    for k, v in L.state_to_numpy(pst).items():
        want = np.stack(jst[k]) if isinstance(jst[k], tuple) else jst[k]
        if k == "fillbuf":
            v, want = v[:, :off], want[:, :off]
        np.testing.assert_array_equal(v, want, err_msg=k)


def test_step_refuses_the_sharded_path_and_wide_compaction():
    cfg = L.LaneConfig(**CFG)
    with pytest.raises(NotImplementedError, match="seq-fleet"):
        L.build_lane_step(cfg, "shards")
    with pytest.raises(NotImplementedError, match="seq-fleet"):
        LaneSession(cfg, shards=2, device="cpu")
    with pytest.raises(ValueError, match="pos_dma"):
        L.build_lane_step(dataclasses.replace(cfg, pos_dma=True))
    with pytest.raises(ValueError, match="slack"):
        L.chunk_compaction(dataclasses.replace(cfg, width=8, window=8),
                           T=8, M=1024, step=None)


def test_fill_log_overflow_is_the_same_sticky_error():
    kw = dict(CFG, fill_buffer=64)
    msgs = zipf_symbol_stream(200, num_symbols=4, num_accounts=30, seed=2)
    jses = JaxSession(JL.LaneConfig(**kw), width=16)
    port = LaneSession(L.LaneConfig(**kw), width=16, device="cpu")
    with pytest.raises(JaxEngineError) as je:
        jses.process_wire([m.copy() for m in msgs])
    with pytest.raises(LaneEngineError) as pe:
        port.process_wire(_port(msgs))
    assert pe.value.code == je.value.code == L.LERR_FILLBUF_FULL


@pytest.mark.parametrize("width", [0, 16])
def test_scheduler_plans_equal_jax(width):
    msgs = harness_stream(600, seed=3, payout_opcode_bug=False,
                          validate=True)
    a = JaxScheduler(num_lanes=4, num_accounts=32, width=width).plan(msgs)
    sch = Scheduler(num_lanes=4, num_accounts=32, width=width)
    b = sch.plan(_port(msgs))
    assert a.cols.keys() == b.cols.keys()
    for k in a.cols:
        np.testing.assert_array_equal(a.cols[k], b.cols[k], err_msg=k)
        assert a.cols[k].dtype == b.cols[k].dtype
    assert [dataclasses.astuple(x) for x in a.barriers] == \
        [dataclasses.astuple(x) for x in b.barriers]
    assert [x.msg_index for x in a.host_rejects] == \
        [x.msg_index for x in b.host_rejects]
    assert a.segment_steps == b.segment_steps and a.program == b.program
    assert [dataclasses.astuple(p) for p in a.placements] == \
        [dataclasses.astuple(p) for p in b.placements]
    with pytest.raises(CapacityError):
        Scheduler(2, 2).plan([OrderMsg(action=jop.ADD_SYMBOL, sid=s)
                              for s in range(3)])
    with pytest.raises(EnvelopeError):
        Scheduler(8, 8).plan([OrderMsg(action=jop.BUY, oid=1, aid=1, sid=0,
                                       price=2**31, size=1)])


STREAM = dict(num_symbols=6, num_accounts=40, seed=11, payout_per_mille=6)


@pytest.mark.parametrize("width", [0, 16])
def test_jax_head_carried_into_port_tail(width):
    msgs = zipf_symbol_stream(400, **STREAM)
    cut = 230
    jses = JaxSession(JL.LaneConfig(**CFG), width=width)
    jses.process_wire([m.copy() for m in msgs[:cut]])
    port = LaneSession(L.LaneConfig(**CFG), width=width, device="cpu")
    port.load_numpy(_jax_host_state(jses), *_maps(jses.scheduler))
    want = jses.process_wire([m.copy() for m in msgs[cut:]])
    assert port.process_wire(_port(msgs[cut:])) == want
    _canon_equal(port.export_canonical(), _jax_canonical(jses))
    assert port.metrics() == jses.metrics()


def test_export_canonical_equals_save_session_payload(tmp_path):
    msgs = zipf_symbol_stream(400, **STREAM)
    jses = JaxSession(JL.LaneConfig(**CFG), width=16)
    port = LaneSession(L.LaneConfig(**CFG), width=16, device="cpu")
    assert jses.process_wire([m.copy() for m in msgs]) == \
        port.process_wire(_port(msgs))
    path = JCK.save_session(str(tmp_path), jses, offset=400)
    data = np.load(path)
    payload = {k: data[k] for k in data.files if k not in ("meta", "digest")}
    canon = port.export_canonical()
    assert sorted(canon) == sorted(payload)
    for k in payload:
        np.testing.assert_array_equal(canon[k], payload[k], err_msg=k)
        assert canon[k].dtype == payload[k].dtype, k
    meta = JCK._load_file(path)[1]
    aid_idx, sid_lane, oid_sid, rr = _maps(port.scheduler)
    assert meta["aid_idx"] == [list(x) for x in sorted(aid_idx.items())]
    assert meta["oid_sid"] == [list(x) for x in sorted(oid_sid.items())]
    assert meta["sid_lane"] == [list(x) for x in sorted(sid_lane.items())]
    assert meta["rr_lane"] == rr


def test_snapshots_restore_across_packages(tmp_path):
    """A JAX-package snapshot restores into the port and the port's
    canonical payload restores into the JAX package (through its own
    loader); both resume byte-identical to an uninterrupted run."""
    msgs = zipf_symbol_stream(400, **STREAM)
    cut = 200
    full = JaxSession(JL.LaneConfig(**CFG), width=16)
    want = full.process_wire([m.copy() for m in msgs])

    head_j = JaxSession(JL.LaneConfig(**CFG), width=16)
    head_j.process_wire([m.copy() for m in msgs[:cut]])
    path = JCK.save_session(str(tmp_path / "jax"), head_j, offset=cut)
    data, meta = JCK._load_file(path)
    port = LaneSession(L.LaneConfig(**CFG), width=16, device="cpu")
    port.import_canonical({k: data[k] for k in data.files},
                          dict(meta["aid_idx"]), dict(meta["sid_lane"]),
                          dict(meta["oid_sid"]), meta["rr_lane"])
    assert port.process_wire(_port(msgs[cut:])) == want[cut:]

    head_p = LaneSession(L.LaneConfig(**CFG), width=16, device="cpu")
    head_p.process_wire(_port(msgs[:cut]))
    aid_idx, sid_lane, oid_sid, rr = _maps(head_p.scheduler)
    pmeta = dict(meta, aid_idx=sorted(aid_idx.items()),
                 sid_lane=sorted(sid_lane.items()),
                 oid_sid=sorted(oid_sid.items()), rr_lane=rr)
    payload = dict(head_p.export_canonical())
    payload["meta"] = np.frombuffer(
        __import__("json").dumps(pmeta).encode(), dtype=np.uint8)
    (tmp_path / "port").mkdir()
    JCK._atomic_savez(str(tmp_path / "port"), cut, payload)
    tail_j, off = JCK.load_session(str(tmp_path / "port"))
    assert off == cut
    assert tail_j.process_wire([m.copy() for m in msgs[cut:]]) == want[cut:]


def test_seq_and_lanes_canonical_states_restore_into_each_other():
    """checkpoint.py's cross-engine contract inside the port: a seq-engine
    head's canonical state resumes in the lanes engine, and a lanes head
    in the seq engine, both byte-identical to an uninterrupted run."""
    kw = dict(lanes=8, slots=128, accounts=128, max_fills=32)
    scfg = SQ.SeqConfig(**kw, batch=256, pos_cap=1 << 11, fill_cap=1 << 13,
                        probe_max=16)
    lcfg = L.LaneConfig(**kw, steps=32)
    msgs = _port(zipf_symbol_stream(400, **STREAM))
    cut = 200
    want = LaneSession(lcfg, width=16, device="cpu").process_wire(msgs)

    seq_head = SeqSession(scfg, device="cpu")
    assert seq_head.process_wire(msgs[:cut]) == want[:cut]
    lanes_tail = LaneSession(lcfg, width=16, device="cpu")
    r = seq_head.router
    lanes_tail.import_canonical(SQ.export_canonical(scfg, seq_head.state),
                                r.aid_idx, r.sid_lane, r.oid_sid)
    assert lanes_tail.process_wire(msgs[cut:]) == want[cut:]

    lanes_head = LaneSession(lcfg, width=16, device="cpu")
    lanes_head.process_wire(msgs[:cut])
    seq_tail = SeqSession(scfg, device="cpu")
    seq_tail.state = SQ.import_canonical(scfg, lanes_head.export_canonical(),
                                         "cpu")
    sch = lanes_head.scheduler
    seq_tail.router.aid_idx = dict(sch.aid_idx)
    seq_tail.router.sid_lane = dict(sch.sid_lane)
    seq_tail.router.oid_sid = dict(sch.oid_sid)
    assert seq_tail.process_wire(msgs[cut:]) == want[cut:]


def _states_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_idle_step_leaves_the_state_as_it_was(variant):
    """The step graph's warm-up runs one step on the live state with
    every slot a NOP (under compaction on the scrap lane): a state with
    books, positions, balances and counters must come out bit-identical,
    and the step index advances."""
    kw, width = VARIANTS[variant]
    ses = LaneSession(L.LaneConfig(**kw), width=width, device="cpu")
    ses.process_wire(_port(zipf_symbol_stream(400, **STREAM)))
    assert ses.metrics()["open_orders"] > 0 and ses.metrics()["positions"] > 0
    before = {k: v.clone() for k, v in ses.state.items()}
    io = L.make_step_io(ses.dev_cfg, 4, "cpu")
    L.idle_step_io(ses.dev_cfg, io)
    step = L.build_lane_step(ses.dev_cfg)
    step(ses.state, io)
    step(ses.state, io)
    _states_equal(ses.state, before)
    assert int(io["t"][0]) == 2
    assert not io["out"][:2, L._OUT_FIELDS.index("ok")].eq(0).any()


class _FreshBuffers(LaneSession):
    """A session that gives every window new step buffers of exactly its
    T steps, where LaneSession reuses one set sized for the longest."""

    def _run_window(self, T, M, cb):
        self._io = L.make_step_io(self.dev_cfg, T, self.device)
        return super()._run_window(T, M, cb)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_reused_window_buffers_equal_fresh_ones(variant):
    kw, width = VARIANTS[variant]
    cfg = L.LaneConfig(**dict(kw, steps=8))
    msgs = _port(zipf_symbol_stream(500, num_symbols=6, num_accounts=40,
                                    seed=12, payout_per_mille=10))
    ses = LaneSession(cfg, width=width, device="cpu")
    fresh = _FreshBuffers(cfg, width=width, device="cpu")
    for lo in range(0, len(msgs), 120):
        assert ses.process_wire(msgs[lo:lo + 120]) == \
            fresh.process_wire(msgs[lo:lo + 120])
    _states_equal(ses.state, fresh.state)
    assert ses._io["win"].shape[0] == L.window_steps(ses.dev_cfg)
    # a window longer than the buffers is refused
    cb = {f: torch.zeros(16, dtype=torch.int64) for f in CB_FIELDS}
    with pytest.raises(ValueError, match="buffers"):
        L.build_lane_chunk(ses.dev_cfg, 16, 16)(
            ses.state, cb, io=L.make_step_io(ses.dev_cfg, 8, "cpu"))


def test_graph_key_changes_exactly_when_a_state_tensor_is_replaced():
    """The session captures its step graph again when the key changes:
    windows, barriers, the fill-log rewind and every read leave the
    state's tensors in place; replacing one tensor, the dict's tensors,
    load_numpy and import_canonical do not."""
    msgs = _port(zipf_symbol_stream(400, **dict(STREAM,
                                                payout_per_mille=30)))
    ses = LaneSession(L.LaneConfig(**CFG), width=16, device="cpu")
    ref = LaneSession(L.LaneConfig(**CFG), width=16, device="cpu")
    key = ses.graph_key()
    assert [k for k, _ in key] == list(ses.state)
    assert ses.process_wire(msgs[:200]) == ref.process_wire(msgs[:200])
    assert ses.metrics()["barriers"] > 0
    ses.metrics(), ses.histograms(), ses.export_canonical()
    assert ses.graph_key() == key
    ses.state = dict(ses.state)                 # same tensors
    assert ses.graph_key() == key
    swaps = [
        lambda: ses.state.update(bal=ses.state["bal"].clone()),
        lambda: setattr(ses, "state", {k: v.clone()
                                       for k, v in ses.state.items()}),
        lambda: ses.load_numpy(L.state_to_numpy(ses.state),
                               *_maps(ses.scheduler)),
        lambda: ses.import_canonical(ses.export_canonical(),
                                     *_maps(ses.scheduler)),
    ]
    for swap in swaps:
        swap()
        assert ses.graph_key() != key
        key = ses.graph_key()
    assert ses.process_wire(msgs[200:]) == ref.process_wire(msgs[200:])
    with pytest.raises(RuntimeError, match="card"):
        ses.capture()
