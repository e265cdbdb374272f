"""The port's native host runtime (kme_tpu_torch/native/) against the JAX
package's and against the port's own Python paths, on the CPU.

- the three C++ sources are byte-identical copies of kme_tpu/native's;
- the library builds or raises: a failed compile or load never hands back
  None, and only KME_NATIVE=0 selects the Python router, scheduler,
  parser and line builder;
- `check_buffer` refuses what would overread on the native side;
- the native seq router equals the port's Python router and kme_tpu's
  native router (INT64_MIN edges; maps persist across calls);
- `plan_batch` equals the port's numpy pack and kme_tpu's `plan_batch`;
- `WireBatch.parse_buffer` gives kme_tpu's columns, nulls included, and a
  buffer with a line outside the native subset parses like parse_order.

Tolerance 0 everywhere: every value is an integer or a byte.
"""

import dataclasses
import hashlib
import os

import numpy as np
import pytest
import torch

import kme_tpu.opcodes as jop
from kme_tpu.native import sched as JNS
from kme_tpu.runtime import seqsession as JSS
from kme_tpu.wire import OrderMsg as JaxOrder
from kme_tpu.wire import WireBatch as JaxBatch
from kme_tpu.workload import harness_stream
from kme_tpu_torch import native
from kme_tpu_torch.engine import seq as SQ
from kme_tpu_torch.native import sched as NS
from kme_tpu_torch.runtime import seqsession as SS
from kme_tpu_torch.runtime import sequencer as SEQ
from kme_tpu_torch.wire import OrderMsg, WireBatch, dumps_order

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(lanes=8, slots=128, accounts=128, max_fills=32, batch=128,
           pos_cap=1 << 11, fill_cap=1 << 12, probe_max=16)


def _port(msgs):
    return [OrderMsg(**dataclasses.asdict(m)) for m in msgs]


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("name", ["kme_router.cpp", "kme_host.cpp",
                                  "kme_wire.cpp", "kme_oracle.cpp",
                                  "kme_front.cpp"])
def test_copied_sources_are_byte_identical(name):
    assert _sha(os.path.join(ROOT, "kme_tpu_torch", "native", name)) == \
        _sha(os.path.join(ROOT, "kme_tpu", "native", name))


@pytest.mark.parametrize("how", ["compiler", "library"])
def test_failed_build_or_load_raises(monkeypatch, tmp_path, how):
    """No quiet fallback: a compiler that fails, or a library that does
    not load, raises; load_library never hands back None for it."""
    monkeypatch.setattr(native, "_host_lib", None)
    monkeypatch.setattr(native, "BUILD", str(tmp_path))
    monkeypatch.delenv("KME_NATIVE", raising=False)
    if how == "compiler":
        monkeypatch.delenv("KME_NATIVE_SO", raising=False)
        monkeypatch.setattr(native, "HOST_CXX", "false")
        with pytest.raises(RuntimeError, match="building the host runtime"):
            native.load_library()
        assert os.listdir(tmp_path) == []      # the temporary name is gone
    else:
        monkeypatch.setenv("KME_NATIVE_SO", str(tmp_path / "missing.so"))
        with pytest.raises(OSError, match="could not be loaded"):
            native.load_library()
    assert native._host_lib is None
    # with neither at fault, the next call loads (the built library)
    monkeypatch.undo()
    monkeypatch.setattr(native, "_host_lib", None)
    assert native.load_library() is not None


def test_kme_native_0_gives_the_python_paths(monkeypatch):
    msgs = _port(harness_stream(300, seed=4, num_symbols=4, num_accounts=8))
    want = SS.SeqSession(SQ.SeqConfig(**CFG), device="cpu").process_wire(
        msgs)
    monkeypatch.setenv("KME_NATIVE", "0")
    assert native.load_library() is None
    assert not NS.native_available()
    assert type(SS.make_seq_router(8, 64)) is SS.SeqRouter
    assert type(SEQ.make_scheduler(8, 64, 4)) is SEQ.Scheduler
    with pytest.raises(RuntimeError, match="KME_NATIVE=0"):
        NS.NativeScheduler(8, 64)
    ses = SS.SeqSession(SQ.SeqConfig(**CFG), device="cpu")
    assert type(ses.router) is SS.SeqRouter
    assert ses.process_wire_buffer(msgs) is None
    assert ses.process_wire(msgs) == want
    buf = "\n".join(dumps_order(m) for m in msgs[:50]).encode()
    wb = WireBatch.parse_buffer(buf)
    assert [dataclasses.astuple(m) for m in wb.msgs()] == \
        [dataclasses.astuple(m) for m in msgs[:50]]


@pytest.mark.parametrize("fault", ["short", "dtype", "strided", "2-D",
                                   "list"])
def test_check_buffer_rejects(fault):
    good = np.zeros(8, np.int64)
    assert native.check_buffer("x", good, np.int64, 8) is good
    bad = {"short": (good, 9), "dtype": (good.astype(np.int32), 8),
           "strided": (np.zeros(16, np.int64)[::2], 8),
           "2-D": (good.reshape(2, 4), None), "list": ([0] * 8, 8)}[fault]
    with pytest.raises(native.BoundaryError):
        native.check_buffer("x", bad[0], np.int64, bad[1])


def _router_stream():
    """tests/test_seq_engine.py's native-router stream: every edge
    (unknown-oid cancels, negative-sid addsym, payout route cleanup,
    re-used oids, a negative-sid trade and the INT64_MIN payout/remove
    edge)."""
    msgs = harness_stream(1200, seed=21, num_symbols=6, num_accounts=12,
                          payout_opcode_bug=False, validate=False)
    INT64_MIN = -(1 << 63)
    msgs += [
        JaxOrder(action=jop.BUY, oid=999001, aid=1, sid=-7, price=50,
                 size=1),
        JaxOrder(action=jop.PAYOUT, sid=INT64_MIN, size=97),
        JaxOrder(action=jop.REMOVE_SYMBOL, sid=INT64_MIN),
        JaxOrder(action=jop.PAYOUT, sid=-7, size=97),
    ]
    return msgs


@pytest.mark.parametrize("form", ["msgs", "wirebatch"])
def test_native_router_matches_python_and_jax(form):
    nat = SS.make_seq_router(16, 256)
    assert isinstance(nat, SS.NativeSeqRouter)
    py = SS.SeqRouter(16, 256)
    jnat = JSS.make_seq_router(16, 256)
    assert isinstance(jnat, JSS.NativeSeqRouter)
    msgs = _router_stream()
    for chunk in (msgs[:500], msgs[500:]):   # maps persist across calls
        part = _port(chunk)
        if form == "wirebatch":
            part = WireBatch.from_msgs(part)
        cn, rn = nat.route(part)
        cp, rp = py.route(part)
        cj, rj = jnat.route([m.copy() for m in chunk])
        assert rn == rp == rj
        assert set(cn) == set(cj)
        for k in cp:
            assert cn[k].tolist() == cp[k].tolist() == cj[k].tolist(), k
            assert cn[k].dtype == cp[k].dtype == cj[k].dtype, k
    for m in ("aid_idx", "sid_lane", "oid_sid"):
        assert getattr(nat, m) == getattr(py, m) == getattr(jnat, m), m


def test_native_router_errors_and_int64_overflow():
    nat = SS.make_seq_router(2, 2)
    with pytest.raises(SS.CapacityError, match="symbol capacity"):
        nat.route(_port([JaxOrder(action=jop.ADD_SYMBOL, sid=s)
                         for s in range(3)]))
    with pytest.raises(SS.EnvelopeError):
        SS.make_seq_router(8, 8).route([OrderMsg(
            action=jop.BUY, oid=1, aid=1, sid=0, price=2**31, size=1)])
    # a field beyond int64 routes that call through the Python router
    # with the maps synced both ways, exactly as kme_tpu does
    msgs = [JaxOrder(action=jop.CREATE_BALANCE, aid=2**64 + 3),
            JaxOrder(action=jop.ADD_SYMBOL, sid=5),
            JaxOrder(action=jop.BUY, oid=2**70, aid=3, sid=5, price=5,
                     size=1),
            JaxOrder(action=jop.CANCEL, oid=2**70, aid=3)]
    nat, jnat = SS.make_seq_router(8, 8), JSS.make_seq_router(8, 8)
    cn, rn = nat.route(_port(msgs))
    cj, rj = jnat.route([m.copy() for m in msgs])
    assert rn == rj
    for k in cj:
        assert cn[k].tolist() == cj[k].tolist(), k
    for m in ("aid_idx", "sid_lane", "oid_sid"):
        assert getattr(nat, m) == getattr(jnat, m), m


def test_plan_batch_parity_with_python_pack_and_jax():
    """tests/test_host_path.py's plan parity: kme_plan_batch (one native
    call: envelope + route + pack) against the numpy pack over the same
    router, and against kme_tpu's plan_batch: routed columns, rejects,
    stacked planes and chunk counts."""
    cfg = SQ.SeqConfig(**CFG)
    ses_a = SS.SeqSession(cfg, device="cpu")
    ses_b = SS.SeqSession(cfg, device="cpu")
    jrouter = JSS.make_seq_router(cfg.lanes, cfg.accounts)
    msgs = harness_stream(300, seed=9, num_symbols=4, num_accounts=8,
                          payout_opcode_bug=False, validate=True)
    for lo in (0, 128, 256):
        part = msgs[lo:lo + 128]
        cols_a, rej_a, stk_a, cnts_a, K_a = ses_a._plan(
            WireBatch.from_msgs(_port(part)))
        # a plain list skips the WireBatch fast path: ses_b routes (through
        # its native router) and packs in numpy over the same messages
        cols_b, rej_b, stk_b, cnts_b, K_b = ses_b._plan(_port(part))
        cols_j, rej_j, stk_j, cnts_j, K_j = JNS.plan_batch(
            jrouter, JaxBatch.from_msgs([m.copy() for m in part]),
            cfg.batch)
        assert (K_a, cnts_a, rej_a) == (K_b, cnts_b, rej_b) \
            == (K_j, cnts_j, rej_j)
        assert set(cols_a) == set(cols_b) == set(cols_j)
        for f in cols_a:
            assert np.array_equal(cols_a[f], cols_b[f]), f"cols[{f!r}]"
            assert np.array_equal(cols_a[f], cols_j[f]), f"cols[{f!r}]"
        assert set(stk_a) == set(stk_b) == set(SQ.MSG_FIELDS)
        for f in stk_a:
            assert stk_a[f].dtype == np.int32
            assert np.array_equal(stk_a[f], stk_b[f]), f"stacked[{f!r}]"
            assert np.array_equal(stk_a[f], stk_j[f]), f"stacked[{f!r}]"
        # and the planes are the kernel's message columns
        packed = SQ.pack_msgs(cfg, cols_a, len(cols_a["act"]))
        for f in SQ.MSG_FIELDS:
            assert np.array_equal(stk_a[f][0], packed[f]), f
    with pytest.raises(SS.EnvelopeError, match="message 1"):
        ses_a._plan(WireBatch.from_msgs([
            OrderMsg(action=jop.CREATE_BALANCE, aid=1),
            OrderMsg(action=jop.BUY, oid=1, aid=1, sid=0, price=1,
                     size=2**31)]))


def test_recon_batch_refuses_short_buffers():
    cfg = SQ.SeqConfig(**CFG)
    ses = SS.SeqSession(cfg, device="cpu")
    batch = WireBatch.from_msgs(_port(harness_stream(40, seed=2)))
    cols, rej, host, fills = ses._run(batch)
    short = dict(host, nfill=host["nfill"][:-1])
    with pytest.raises(native.BoundaryError, match="nfill"):
        ses._recon_buffer(batch, cols, rej, short, fills)
    with pytest.raises(native.BoundaryError, match="fills"):
        ses._recon_buffer(batch, cols, rej, host, fills[:3])


def _json_lines():
    lines = [dumps_order(m).encode() for m in _port(harness_stream(
        200, seed=7, num_symbols=4, num_accounts=8))]
    lines += [b'{"action":3,"oid":5,"aid":1,"sid":2,"price":7,"size":1,'
              b'"next":null,"prev":9}',
              b'{"action":100,"aid":-9223372036854775808}',
              b'{"action":3,"oid":9223372036854775807,"next":-4}',
              b'{}']
    return lines


@pytest.mark.parametrize("kind", ["native_subset", "outside_subset",
                                  "empty"])
def test_parse_buffer_columns_equal_jax(kind):
    lines = _json_lines()
    if kind == "outside_subset":
        # an integral float: parse_order coerces it, the native parser
        # refuses the line, so the whole buffer re-parses in Python
        lines.insert(3, b'{"action":100,"aid":4,"size":2.0}')
    buf = b"\n".join(lines) + b"\n" if kind != "empty" else b""
    got, want = WireBatch.parse_buffer(buf), JaxBatch.parse_buffer(buf)
    # the native parser took the buffer, or refused it whole
    assert (got._msgs is None) == (kind == "native_subset")
    assert got.n == want.n == (0 if kind == "empty" else len(lines))
    for f in WireBatch._COLS + ("hnext", "hprev", "tid", "htid"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert [dataclasses.astuple(m) for m in got.msgs()] == \
        [dataclasses.astuple(m) for m in want.msgs()]
    if kind == "outside_subset":
        assert got.size[3] == 2
