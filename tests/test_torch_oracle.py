"""The port's host engines and copied host modules against the JAX
package's.

- `kme_tpu_torch.oracle.OracleEngine` and `native.oracle.
  NativeOracleEngine` (over the copied `kme_oracle.cpp`) against
  `kme_tpu`'s on harness streams, java and fixed compat: MatchOut
  lines, the exported stores, the native checkpoint dump, and the
  reference-death path (the completed prefix and the error);
- the copied wire additions (binary frames, REJ records, produce
  stamps), fault registry, telemetry registry and leader lease.

Tolerance 0: lines and stores compare exactly.
"""

import dataclasses
import random

import numpy as np
import pytest

import kme_tpu.faults as JF
import kme_tpu.wire as JW
from kme_tpu.native.oracle import NativeOracleEngine as JaxNative
from kme_tpu.oracle import OracleEngine as JaxOracle
from kme_tpu.oracle.engine import ReferenceHang as JaxHang
from kme_tpu.telemetry import Registry as JaxRegistry
from kme_tpu.workload import harness_stream
import kme_tpu_torch.faults as F
import kme_tpu_torch.wire as W
from kme_tpu_torch.bridge import lease
from kme_tpu_torch.native.oracle import NativeOracleEngine
from kme_tpu_torch.oracle import OracleEngine, ReferenceHang
from kme_tpu_torch.telemetry import Registry

STREAMS = {
    # the harness as the reference runs it: java compat, payout opcode bug
    "java": dict(seed=5),
    "fixed": dict(seed=9, num_symbols=4, num_accounts=8,
                  payout_opcode_bug=False, validate=True),
}
ENVELOPE = {"java": {}, "fixed": dict(book_slots=64, max_fills=32)}


def _port(msgs):
    return [W.OrderMsg(**dataclasses.asdict(m)) for m in msgs]


@pytest.mark.parametrize("compat", sorted(STREAMS))
def test_oracle_matches_jax(compat):
    msgs = harness_stream(1500, **STREAMS[compat])
    port = OracleEngine(compat, **ENVELOPE[compat])
    ref = JaxOracle(compat, **ENVELOPE[compat])
    for m, jm in zip(_port(msgs), msgs):
        assert [r.wire() for r in port.process(m)] == \
            [r.wire() for r in ref.process(jm)]
    for store in ("balances", "positions", "books", "buckets"):
        assert getattr(port, store) == getattr(ref, store), store
    assert {k: dataclasses.astuple(v) for k, v in port.orders.items()} == \
        {k: dataclasses.astuple(v) for k, v in ref.orders.items()}


@pytest.mark.parametrize("compat", sorted(STREAMS))
def test_native_engine_matches_jax_and_oracle(compat):
    msgs = harness_stream(3000, **STREAMS[compat])
    port = NativeOracleEngine(compat, **ENVELOPE[compat])
    ref = JaxNative(compat, **ENVELOPE[compat])
    got = port.process_wire(_port(msgs))
    assert got == ref.process_wire([m.copy() for m in msgs])
    ora = OracleEngine(compat, **ENVELOPE[compat])
    assert got == [[r.wire() for r in ora.process(m)] for m in _port(msgs)]
    assert port.dump_state() == ref.dump_state()
    assert port.export_state() == ref.export_state()
    # the dump restores into a fresh engine of either package
    again = NativeOracleEngine(compat, **ENVELOPE[compat])
    again.load_state(ref.dump_state())
    assert again.export_state() == port.export_state()


def test_reference_death_keeps_the_completed_prefix():
    """A REMOVE_SYMBOL on a non-empty book is the reference's Q4
    infinite loop: both engines return the lines of every message
    before it and raise ReferenceHang, as the JAX package's do."""
    msgs = harness_stream(1500, seed=3, num_symbols=4, num_accounts=12,
                          payout_opcode_bug=False, validate=True)
    out, exc = NativeOracleEngine("java").process_wire_partial(_port(msgs))
    jout, jexc = JaxNative("java").process_wire_partial(
        [m.copy() for m in msgs])
    assert isinstance(exc, ReferenceHang) and isinstance(jexc, JaxHang)
    assert out == jout and str(exc) == str(jexc)
    ora = OracleEngine("java")
    lines = []
    with pytest.raises(ReferenceHang):
        for m in _port(msgs):
            lines.append([r.wire() for r in ora.process(m)])
    assert lines == out


def test_wire_frames_and_records_equal_jax():
    rng = random.Random(3)
    vals = [0, 1, -1, 2**31 - 1, -2**31, 2**62, -2**63, 2**63 - 1]
    msgs, tids = [], []
    for _ in range(300):
        f = [rng.choice(vals + [rng.randint(-10**9, 10**9)])
             for _ in range(6)]
        msgs.append(W.OrderMsg(*f, rng.choice([None, rng.randint(0, 99)]),
                               rng.choice([None, -7])))
        tids.append(rng.choice([None, rng.randint(0, 2**62)]))
    jmsgs = [JW.OrderMsg(**dataclasses.asdict(m)) for m in msgs]
    for t in (None, tids):
        buf = W.encode_frames(msgs, t)
        assert buf == JW.encode_frames(jmsgs, t)
        wb, values = W.frames_to_values(buf)
        jwb, jvalues = JW.frames_to_values(buf)
        assert values == jvalues
        for c in W.WireBatch._COLS + ("hnext", "hprev", "tid", "htid"):
            np.testing.assert_array_equal(getattr(wb, c), getattr(jwb, c))
        assert [dataclasses.astuple(m) for m in W.decode_frames(buf)] == \
            [dataclasses.astuple(m) for m in JW.decode_frames(buf)]
        assert W.batch_values(W.WireBatch.parse_frames(buf)) == values
    bad = bytearray(W.encode_frame(msgs[0]))
    bad[1] = 9
    for mod in (W, JW):
        with pytest.raises(mod.WireFrameError, match="version_skew"):
            mod.WireBatch.parse_frames(bytes(bad))
    assert W.is_binary_frame(0xB1) and not W.is_binary_frame(ord("{"))
    for code in range(11):
        assert W.rej_name(code) == JW.rej_name(code)
        assert W.rej_record_json(5, 6, code, {"b": 1, "a": [2]}) == \
            JW.rej_record_json(5, 6, code, {"b": 1, "a": [2]})
    for action in (0, 1, 2, 3, 4, 100, 101, 200, 7):
        assert W.reason_for_reject(action) == JW.reason_for_reject(action)
    assert W.ProduceStamp(2, 9) == W.ProduceStamp(2, 9)


def test_faults_registry_fires_like_jax():
    spec = "seed=7;broker.fetch:p=0.5:n=0;serve.kill:at=100"
    try:
        for mod in (F, JF):
            mod.configure(spec)
        fired = [[mod.should("broker.fetch") for _ in range(64)]
                 for mod in (F, JF)]
        assert fired[0] == fired[1] and any(fired[0]) and not all(fired[0])
        assert F.should("serve.kill", offset=99) is False
        assert F.fired_total() == JF.fired_total()
    finally:
        for mod in (F, JF):
            mod.clear()


def test_registry_and_lease(tmp_path):
    a, b = Registry(), JaxRegistry()
    for r in (a, b):
        r.counter("c", "h").inc(3)
        r.gauge("g").set(1.5)
        r.publish_histograms({"h": [1, 2] + [0] * 14})
        r.latency("lat_e2e").observe(0.004, 3)
    assert a.snapshot() == b.snapshot()
    assert a.prometheus_text() == b.prometheus_text()
    d = str(tmp_path)
    assert lease.current_epoch(d) == 0
    assert lease.acquire(d) == 1 and lease.acquire(d) == 2
    assert lease.steal(d) == 3 and lease.current_epoch(d) == 3
