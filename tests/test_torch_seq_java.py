"""The port's java mode (kernel B2's plain version, the java router and the
session) against the JAX package's java-mode kernel and session and the
java oracle.

Every value is an integer, so the tolerance is exact equality: all 25
state planes, the header rows and the used fill prefix of each call;
MatchOut lines, `export_state`, metrics and histograms of each session.
The JAX side runs its Pallas kernel in interpret mode on the CPU, as
tests/test_seq_java.py does. Two configurations only (each costs the JAX
side one interpret-mode compile per entry point): the deep-book java
configuration of tests/test_seq_java.py's harness case, and a one-tile
hash for HASH_FULL.
"""

import dataclasses
import hashlib
import importlib.util
import os

import numpy as np
import pytest
import torch

import kme_tpu.opcodes as jop
from kme_tpu.engine import seq as JSQ
from kme_tpu.oracle import OracleEngine
from kme_tpu.runtime.seqsession import SeqSession as JaxSession
from kme_tpu.runtime.seqsession import UnsupportedJavaOp as JaxUnsupported
from kme_tpu.runtime.session import LaneEngineError as JaxEngineError
from kme_tpu.wire import OrderMsg as JaxOrder
from kme_tpu.workload import harness_stream, zipf_symbol_stream
from kme_tpu_torch.engine import seq as SQ
from kme_tpu_torch.runtime.seqsession import SeqSession, UnsupportedJavaOp
from kme_tpu_torch.runtime.session import LaneEngineError
from kme_tpu_torch.wire import OrderMsg, wire_lines

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JKW = dict(lanes=8, slots=256, accounts=128, max_fills=64, batch=256,
           pos_cap=1 << 13, fill_cap=1 << 14, probe_max=16, compat="java",
           hbm_books=True)
TINY = dict(JKW, pos_cap=128, probe_max=1)
COLS = ("act", "oid", "aid", "price", "size", "lane", "aid_raw", "sid_raw")


def _port(msgs):
    return [OrderMsg(**dataclasses.asdict(m)) for m in msgs]


def _batches(msgs, B):
    """Lane-level message tuples (COLS order) -> java column dicts of at
    most B messages; the Q1 flag is set where the raw sid is 0, as the
    router sets it."""
    out = []
    for lo in range(0, len(msgs), B):
        part = msgs[lo:lo + B]
        cols = {f: np.array([m[i] for m in part], np.int64)
                for i, f in enumerate(COLS)}
        cols["flags"] = (cols["sid_raw"] == 0).astype(np.int32)
        out.append((cols, len(part)))
    return out


def _preamble(rng, A, S, deposit=(10**4, 10**6)):
    """CREATE + TRANSFER per account and ADD_SYMBOL per lane; random
    Java-long aids, lane 0 is sid 0 (the Q1 merged book)."""
    araw = [int(v) for v in rng.integers(-2**62, 2**62, A)]
    sraw = [0] + [int(v) for v in rng.integers(1, 2**40, S - 1)]
    msgs = []
    for a in range(A):
        msgs.append((SQ.L_CREATE, 0, a, 0, 0, 0, araw[a], 0))
        msgs.append((SQ.L_TRANSFER, 0, a, 0, int(rng.integers(*deposit)), 0,
                     araw[a], 0))
    for s in range(S):
        msgs.append((SQ.L_ADD_SYMBOL, 0, 0, 0, 0, s, 0, sraw[s]))
    return msgs, araw, sraw


def _java_columns(rng, batches, B=256, S=8, A=40):
    """Crossing trades of small sizes (exact maker exhaustion, so Q2
    ghost fills), a few hot accounts (repeated fills on one (aid, sid):
    Q11 keys and their deletion), trades on the merged sid-0 book, and
    cancels of live orders, some by the wrong account."""
    msgs, araw, sraw = _preamble(rng, A, S)
    live = []
    while len(msgs) < B * batches:
        lane = int(min(rng.zipf(1.6) - 1, S - 1))
        if rng.random() < 0.8 or not live:
            act = SQ.L_BUY if rng.random() < 0.5 else SQ.L_SELL
            acc = int(rng.integers(0, 6 if rng.random() < 0.5 else A))
            oid = int(rng.integers(-2**62, 2**62))
            live.append((oid, lane, acc))
            msgs.append((act, oid, acc, int(rng.integers(44, 57)),
                         int(rng.integers(1, 6)), lane, araw[acc], sraw[lane]))
        else:
            oid, ol, acc = live[int(rng.integers(0, len(live)))]
            if rng.random() < 0.2:
                acc = int(rng.integers(0, A))
            msgs.append((SQ.L_CANCEL, oid, acc, 0, 0, ol, araw[acc],
                         sraw[ol]))
    return _batches(msgs[:B * batches], B), araw


def _used(cfg, plane):
    """The defined part of an output plane: the header rows and, per fill
    field, the fill_total entries written."""
    HR, ft = SQ.hdr_rows(cfg), int(plane[0, 1])
    groups = plane[HR:HR + 5 * (-(-ft // 128))].reshape(-1, 5, 128)
    fills = groups.transpose(1, 0, 2).reshape(5, -1)[:, :ft]
    return np.concatenate([plane[:HR].reshape(-1), fills.reshape(-1)])


def _run_both(cfg_kw, batches):
    """Each batch through the JAX kernel and the port's seq_step on the
    CPU: all 25 planes and the used output equal after every call."""
    jcfg, cfg = JSQ.SeqConfig(**cfg_kw), SQ.SeqConfig(**cfg_kw)
    jstep = JSQ.build_seq_step(jcfg)[0]
    jstate = JSQ.make_seq_state(jcfg)
    state = SQ.make_seq_state(cfg, "cpu")
    assert len(SQ.state_keys(cfg)) == 25
    results = []
    for cols, n in batches:
        jmsgs = JSQ.pack_msgs(jcfg, cols, n)
        msgs = SQ.pack_msgs(cfg, cols, n)
        assert set(msgs) == set(SQ.msg_fields(cfg))
        for f in SQ.msg_fields(cfg):
            assert np.array_equal(jmsgs[f], msgs[f]), f
        jstate, jout = jstep(jstate, jmsgs)
        out = SQ.seq_step(cfg, state, SQ.msgs_to_device(msgs, "cpu"))
        jout, out = np.asarray(jout), out.numpy()
        for k in SQ.state_keys(cfg):
            assert np.array_equal(np.asarray(jstate[k]), state[k].numpy()), k
        assert np.array_equal(_used(cfg, jout), _used(cfg, out))
        results.append(SQ.unpack_out(cfg, out, n))
    return results, state, cfg


def test_java_seq_step_matches_jax_kernel():
    """Two calls of seeded java columns: the quirks all occur, and the
    port's plain version leaves the JAX kernel's planes and output."""
    batches, araw = _java_columns(np.random.default_rng(0), 2)
    res, state, cfg = _run_both(JKW, batches)
    assert int(state["err"][0, 0]) == SQ.LERR_OK
    fills = np.concatenate([r["fills"] for r in res], axis=1)
    assert (fills[3] == 0).any(), "no Q2 ghost fill"
    assert (state["hstate"] == 2).any(), "no Q11 key deleted"
    keys = SQ.export_java(cfg, state)["positions"]
    assert any(ka not in set(araw) for ka, _ in keys), "no Q11 key"
    assert any((c["act"] == SQ.L_BUY).any() and c["flags"].any()
               for c, _ in batches)


def _sticky_batches(kind):
    rng = np.random.default_rng(7)
    B = JKW["batch"]
    if kind == "hash_full":
        # ~150 distinct real (aid, sid) keys in a one-tile hash
        msgs, araw, sraw = _preamble(rng, 80, 3, deposit=(10**7, 10**8))
        oid = 1000
        for s in (1, 2):
            for a in range(0, 80, 2):
                msgs.append((SQ.L_SELL, oid, a, 50, 1, s, araw[a], sraw[s]))
                msgs.append((SQ.L_BUY, oid + 1, a + 1, 55, 1, s, araw[a + 1],
                             sraw[s]))
                oid += 2
        return _batches(msgs, B)
    msgs, araw, sraw = _preamble(rng, 4, 3, deposit=(10**8, 10**9))
    if kind == "domain":
        for k, (price, size) in enumerate([(50, 3), (126, 2), (49, 0),
                                           (-1, 4), (47, 2)]):
            msgs.append((SQ.L_SELL if k % 2 else SQ.L_BUY, 500 + k, k % 4,
                         price, size, 1, araw[k % 4], sraw[1]))
    elif kind == "cap_slots":
        # one more resting buy than a side's 256 slots
        for k in range(JKW["slots"] + 1):
            msgs.append((SQ.L_BUY, 500 + k, 0, 1 + k % 40, 1, 2, araw[0],
                         sraw[2]))
    else:   # cap_fills: a buy sweeping one maker more than max_fills
        for k in range(JKW["max_fills"] + 1):
            msgs.append((SQ.L_SELL, 500 + k, 1, 60, 1, 1, araw[1], sraw[1]))
        msgs.append((SQ.L_BUY, 9000, 2, 70, JKW["max_fills"] + 3, 1,
                     araw[2], sraw[1]))
    return _batches(msgs, B)


@pytest.mark.parametrize("kind,code", [
    ("domain", SQ.LERR_JAVA_DOMAIN), ("cap_slots", SQ.LERR_JAVA_CAP),
    ("cap_fills", SQ.LERR_JAVA_CAP), ("hash_full", SQ.LERR_HASH_FULL)])
def test_java_sticky_errors_match_jax(kind, code):
    """Out-of-domain fields, exhausted slots or fills and a full hash set
    the same sticky error in both packages, with the same planes behind
    it."""
    res, state, _ = _run_both(TINY if kind == "hash_full" else JKW,
                              _sticky_batches(kind))
    assert res[-1]["err"] == code
    assert int(state["err"][0, 0]) == code


# ---- sessions: port vs JAX package vs java oracle -------------------------

def _accounts(*aids, size=10**6):
    O = JaxOrder
    out = []
    for a in aids:
        out += [O(action=jop.CREATE_BALANCE, aid=a),
                O(action=jop.TRANSFER, aid=a, size=size)]
    return out


def _basic_q9():
    O = JaxOrder
    return _accounts(1, 2, size=100000) + [
        O(action=jop.ADD_SYMBOL, sid=1),
        O(action=jop.BUY, oid=10, aid=1, sid=1, price=40, size=5),
        O(action=jop.BUY, oid=11, aid=2, sid=1, price=40, size=3),
        O(action=jop.SELL, oid=12, aid=2, sid=1, price=35, size=6),
        O(action=jop.CANCEL, oid=11, aid=2),
        O(action=jop.CANCEL, oid=11, aid=2)]


def _q2_ghost():
    O = JaxOrder
    return _accounts(1, 2) + [
        O(action=jop.ADD_SYMBOL, sid=1),
        O(action=jop.BUY, oid=10, aid=1, sid=1, price=50, size=4),
        O(action=jop.BUY, oid=11, aid=1, sid=1, price=50, size=3),
        O(action=jop.SELL, oid=12, aid=2, sid=1, price=45, size=4),
        O(action=jop.SELL, oid=13, aid=2, sid=1, price=55, size=2),
        O(action=jop.SELL, oid=14, aid=2, sid=1, price=55, size=9),
        O(action=jop.BUY, oid=15, aid=1, sid=1, price=60, size=2)]


def _q1_merged():
    O = JaxOrder
    return _accounts(1, 2) + [
        O(action=jop.ADD_SYMBOL, sid=0),
        O(action=jop.BUY, oid=10, aid=1, sid=0, price=50, size=5),
        O(action=jop.BUY, oid=11, aid=2, sid=0, price=50, size=3),
        O(action=jop.SELL, oid=12, aid=2, sid=0, price=40, size=4),
        O(action=jop.CANCEL, oid=10, aid=1)]


def _q11_value_keys():
    O = JaxOrder
    msgs = _accounts(1, 2) + [O(action=jop.ADD_SYMBOL, sid=1)]
    oid = 100
    for k in range(10):
        msgs.append(O(action=jop.BUY, oid=oid, aid=1, sid=1, price=50,
                      size=2 + k))
        msgs.append(O(action=jop.SELL, oid=oid + 1, aid=2, sid=1, price=45,
                      size=1 + k))
        oid += 2
    return msgs


SCENARIOS = {
    "basic_q9": _basic_q9,
    "q2_ghost": _q2_ghost,
    "q1_merged": _q1_merged,
    "q11_value_keys": _q11_value_keys,
    "harness_300": lambda: harness_stream(300, seed=3),
}


def _session_error(kind):
    """A price outside the device domain, or a buy that sweeps one maker
    more than max_fills."""
    O = JaxOrder
    msgs = _accounts(1, 2, size=10**9) + [O(action=jop.ADD_SYMBOL, sid=1)]
    if kind == "domain":
        msgs.append(O(action=jop.BUY, oid=10, aid=1, sid=1, price=200,
                      size=2))
        return msgs
    for k in range(JKW["max_fills"] + 1):
        msgs.append(O(action=jop.SELL, oid=100 + k, aid=2, sid=1, price=60,
                      size=1))
    msgs.append(O(action=jop.BUY, oid=9000, aid=1, sid=1, price=70,
                  size=JKW["max_fills"] + 3))
    return msgs


@pytest.mark.parametrize("kind,code", [("domain", SQ.LERR_JAVA_DOMAIN),
                                       ("cap", SQ.LERR_JAVA_CAP)])
def test_java_session_raises_sticky_error_like_jax(kind, code):
    """process_wire raises LaneEngineError with the same code and name in
    both packages, at the same call, with equal lines before it."""
    jcfg, cfg = JSQ.SeqConfig(**JKW), SQ.SeqConfig(**JKW)
    jses, port = JaxSession(jcfg), SeqSession(cfg, device="cpu")
    msgs = _session_error(kind)
    for lo in range(0, len(msgs), 200):
        part = msgs[lo:lo + 200]
        try:
            want = jses.process_wire([m.copy() for m in part])
        except JaxEngineError as e:
            with pytest.raises(LaneEngineError) as got:
                port.process_wire(_port(part))
            assert got.value.code == e.code == code
            assert str(got.value) == str(e)
            break
        assert port.process_wire(_port(part)) == want
    else:
        pytest.fail(f"no sticky error from the {kind} stream")


def _oracle_orders(ora):
    return {oid: {"aid": r.aid, "sid": r.sid, "price": r.price,
                  "size": r.size, "is_buy": r.action == jop.BUY}
            for oid, r in ora.orders.items()}


@pytest.mark.parametrize("name", sorted(SCENARIOS) + ["unsupported_ops"])
def test_java_session_matches_jax_and_oracle(name):
    jcfg, cfg = JSQ.SeqConfig(**JKW), SQ.SeqConfig(**JKW)
    jses, port = JaxSession(jcfg), SeqSession(cfg, device="cpu")
    if name == "unsupported_ops":
        O = JaxOrder
        for bad in (O(action=jop.PAYOUT, sid=1, size=97),
                    O(action=jop.REMOVE_SYMBOL, sid=1),
                    O(action=jop.ADD_SYMBOL, sid=-3),
                    O(action=jop.BUY, oid=1, aid=1, sid=-2, price=5, size=1)):
            with pytest.raises(JaxUnsupported):
                jses.process_wire([bad])
            with pytest.raises(UnsupportedJavaOp):
                port.process_wire(_port([bad]))
        return
    msgs = SCENARIOS[name]()
    port_rec = SeqSession(cfg, device="cpu")
    ora = OracleEngine("java")
    lines = []
    # calls of at most one batch, so the JAX session compiles one scan
    for lo in range(0, len(msgs), 200):
        part = msgs[lo:lo + 200]
        want = jses.process_wire([m.copy() for m in part])
        got = port.process_wire(_port(part))
        lines += [ln for ls in got for ln in ls]
        got_rec = port_rec.process(_port(part))
        for i, m in enumerate(part):
            oracle = [r.wire() for r in ora.process(m.copy())]
            assert want[i] == oracle, f"JAX vs oracle at message {lo + i}"
            assert got[i] == oracle, f"port at message {lo + i}: {m}"
            assert list(wire_lines(got_rec[i])) == oracle, \
                f"port record path at message {lo + i}: {m}"
        np.testing.assert_array_equal(port.last_reasons, jses.last_reasons)
    exp = port.export_state()
    assert exp == jses.export_state()
    assert exp == port_rec.export_state()
    assert exp["balances"] == dict(ora.balances)
    assert exp["positions"] == dict(ora.positions)
    assert exp["orders"] == _oracle_orders(ora)
    for k in SQ.state_keys(cfg):
        assert np.array_equal(port.state[k].numpy(),
                              np.asarray(jses.state[k])), k
    assert port.metrics() == jses.metrics()
    assert port.histograms() == jses.histograms()
    if name == "q11_value_keys":
        assert set(ora.positions) - {(1, 1), (2, 1)}, "no Q11 key"
    if name == "q2_ghost":
        assert any(f'"action":{jop.BOUGHT},' in ln and '"size":0,' in ln
                   for ln in lines), "no Q2 ghost fill"


def test_java_state_carries_from_jax_session_into_port():
    """The first calls on the JAX package; its 25 planes and router maps
    carried into the port with load_numpy; the rest on both: equal
    lines, planes and export."""
    msgs = harness_stream(300, seed=8)
    cut = 200
    jcfg, cfg = JSQ.SeqConfig(**JKW), SQ.SeqConfig(**JKW)
    jses = JaxSession(jcfg)
    jses.process_wire([m.copy() for m in msgs[:cut]])
    port = SeqSession(cfg, device="cpu")
    r = jses.router
    port.load_numpy({k: np.asarray(jses.state[k]) for k in jses.state},
                    r.aid_idx, r.sid_lane, r.oid_sid)
    for lo in range(cut, len(msgs), 200):
        part = msgs[lo:lo + 200]
        want = jses.process_wire([m.copy() for m in part])
        assert port.process_wire(_port(part)) == want
    for k in SQ.state_keys(cfg):
        assert np.array_equal(port.state[k].numpy(),
                              np.asarray(jses.state[k])), k
    assert port.export_state() == jses.export_state()


def test_chip_smoke_java_digest_is_the_oracles():
    """The java stream's MatchOut line count and sha256 that chip_smoke.py
    holds the card to are the java oracle's."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    ora = OracleEngine("java")
    h, n = hashlib.sha256(), 0
    for m in zipf_symbol_stream(**smoke.JAVA_STREAM):
        for rec in ora.process(m):
            h.update(rec.wire().encode())
            h.update(b"\n")
            n += 1
    assert (n, h.hexdigest()) == (smoke.JAVA_LINES, smoke.JAVA_SHA256)
    assert (len(ora.orders), len(ora.positions)) == \
        (smoke.JAVA_OPEN_ORDERS, smoke.JAVA_POSITIONS)
