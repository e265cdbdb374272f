"""The port's checkpoints (`kme_tpu_torch/runtime/checkpoint.py`,
`runtime/javasnap.py`) against the JAX package's, on CPU tensors.

- a snapshot written by either package restores into the other and the
  continuation is byte-identical to an uninterrupted run, for the fixed,
  deep-book (`hbm_books` at 256 slots), java and lanes sessions (the
  analogs of tests/test_seq_engine.py:157 and tests/test_checkpoint.py
  :34 / :370);
- the two packages' snapshots of the same prefix carry the same content
  digest (`_payload_digest`);
- the loaders' fallbacks (torn and digest-mismatched newest snapshots),
  refusals (a seqjava snapshot into a fixed session, a snapshot without
  a card) and retention;
- the seqjava <-> native continuations with the port's native engine.

Tolerance 0 throughout: every value is an integer or a MatchOut byte.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from kme_tpu.engine import lanes as JL
from kme_tpu.engine import seq as JSQ
from kme_tpu.native.oracle import NativeOracleEngine as JaxNative
from kme_tpu.runtime import checkpoint as JCK
from kme_tpu.runtime import javasnap as JJS
from kme_tpu.runtime.seqsession import SeqSession as JaxSeq
from kme_tpu.runtime.session import LaneSession as JaxLanes
from kme_tpu.workload import harness_stream, zipf_symbol_stream
from kme_tpu_torch.engine import lanes as L
from kme_tpu_torch.engine import seq as SQ
from kme_tpu_torch.native.oracle import NativeOracleEngine
from kme_tpu_torch.oracle import OracleEngine
from kme_tpu_torch.runtime import checkpoint as ck
from kme_tpu_torch.runtime import javasnap as JS
from kme_tpu_torch.runtime.seqsession import SeqSession
from kme_tpu_torch.runtime.session import LaneSession
from kme_tpu_torch.wire import OrderMsg

torch.set_num_threads(1)

SEQ_CFGS = {
    "fixed": dict(lanes=8, slots=128, accounts=128, max_fills=32, batch=128,
                  pos_cap=1 << 11, fill_cap=1 << 12, probe_max=16),
    "deep": dict(lanes=8, slots=256, accounts=128, max_fills=64, batch=256,
                 pos_cap=1 << 11, fill_cap=1 << 13, probe_max=16,
                 hbm_books=True),
    "java": dict(lanes=8, slots=512, accounts=128, max_fills=128, batch=512,
                 pos_cap=1 << 12, probe_max=16, compat="java"),
}
LANE_CFG = dict(lanes=8, slots=64, accounts=64, max_fills=32, steps=16)


def _port(msgs):
    return [OrderMsg(**dataclasses.asdict(m)) for m in msgs]


def _seq_stream(kind):
    if kind == "java":
        return harness_stream(900, seed=7)
    return zipf_symbol_stream(500, num_symbols=6, num_accounts=24, seed=3)


def _stored_digest(path):
    return bytes(np.load(path)["digest"]).decode()


@pytest.mark.parametrize("kind", sorted(SEQ_CFGS))
def test_seq_snapshot_crosses_packages(kind, tmp_path):
    """Port snapshot -> the JAX package's loader, and the JAX package's
    snapshot -> the port's loader: both resume byte-identical to an
    uninterrupted JAX run, and both packages' files of the same prefix
    carry the same payload digest."""
    msgs = _seq_stream(kind)
    cut = len(msgs) // 2
    jcfg, cfg = JSQ.SeqConfig(**SEQ_CFGS[kind]), SQ.SeqConfig(**SEQ_CFGS[kind])
    want = JaxSeq(jcfg).process_wire([m.copy() for m in msgs])

    head_p = SeqSession(cfg, device="cpu")
    got_p = head_p.process_wire(_port(msgs[:cut]))
    path_p = ck.save_seq_session(str(tmp_path / "port"), head_p, cut)
    head_j = JaxSeq(jcfg)
    got_j = head_j.process_wire([m.copy() for m in msgs[:cut]])
    path_j = JCK.save_seq_session(str(tmp_path / "jax"), head_j, cut)
    assert got_p == got_j == want[:cut]
    assert _stored_digest(path_p) == _stored_digest(path_j)
    data_p, data_j = np.load(path_p), np.load(path_j)
    assert sorted(data_p.files) == sorted(data_j.files)
    for k in data_j.files:
        assert data_p[k].dtype == data_j[k].dtype, k
    assert JCK._load_file(path_p)[1] == JCK._load_file(path_j)[1]

    tail_j, off = JCK.load_seq_session(str(tmp_path / "port"), jcfg)
    assert off == cut
    assert tail_j.process_wire([m.copy() for m in msgs[cut:]]) == want[cut:]
    tail_p, off = ck.load_seq_session(str(tmp_path / "jax"), cfg,
                                      device="cpu")
    assert off == cut and tail_p.device.type == "cpu"
    assert tail_p.process_wire(_port(msgs[cut:])) == want[cut:]


@pytest.mark.parametrize("width", [0, 16])
def test_lanes_snapshot_crosses_packages(width, tmp_path):
    """The lanes snapshot both ways (full width, and compact with the
    pos_dma planar position rows), with equal digests."""
    msgs = zipf_symbol_stream(400, num_symbols=8, num_accounts=24, seed=21,
                              zipf_a=1.0)
    cut = 200
    jcfg, cfg = JL.LaneConfig(**LANE_CFG), L.LaneConfig(**LANE_CFG)
    want = JaxLanes(jcfg, width=width).process_wire(
        [m.copy() for m in msgs])

    head_p = LaneSession(cfg, width=width, device="cpu")
    assert head_p.dev_cfg.pos_dma == (width > 0)
    head_p.process_wire(_port(msgs[:cut]))
    path_p = ck.save_session(str(tmp_path / "port"), head_p, offset=cut)
    head_j = JaxLanes(jcfg, width=width)
    head_j.process_wire([m.copy() for m in msgs[:cut]])
    path_j = JCK.save_session(str(tmp_path / "jax"), head_j, offset=cut)
    assert _stored_digest(path_p) == _stored_digest(path_j)

    tail_j, off = JCK.load_session(str(tmp_path / "port"))
    assert off == cut
    assert tail_j.process_wire([m.copy() for m in msgs[cut:]]) == want[cut:]
    tail_p, off = ck.load_session(str(tmp_path / "jax"), device="cpu")
    assert off == cut and tail_p.dev_cfg.width == head_p.dev_cfg.width
    assert tail_p.process_wire(_port(msgs[cut:])) == want[cut:]


def _two_snapshots(d):
    msgs = zipf_symbol_stream(300, num_symbols=8, num_accounts=24, seed=9,
                              zipf_a=1.0)
    ses = LaneSession(L.LaneConfig(**LANE_CFG), width=8, device="cpu")
    ses.process_wire(_port(msgs[:100]))
    ck.save_session(d, ses, offset=100)
    ses.process_wire(_port(msgs[100:200]))
    ck.save_session(d, ses, offset=200)
    return ses


@pytest.mark.parametrize("damage", ["torn", "digest"])
def test_damaged_newest_snapshot_falls_back(damage, tmp_path):
    """A torn newest file, and one that still parses but whose array no
    longer matches its stored digest, both fall back to the previous
    snapshot (tests/test_checkpoint.py:110, :559)."""
    d = str(tmp_path)
    _two_snapshots(d)
    path = ck.snapshot_path(d, 200)
    if damage == "torn":
        with open(path, "r+b") as f:
            f.truncate(100)
    else:
        data = {k: v.copy() for k, v in np.load(path).items()}
        data["pos_amt"].flat[0] += 1            # digest array kept stale
        with open(path, "wb") as f:
            np.savez(f, **data)
        with pytest.raises(ValueError, match="digest mismatch"):
            ck._load_file(path)
    resumed, offset = ck.load_session(d, device="cpu")
    assert offset == 100 and resumed is not None
    # the JAX package's loader makes the same call on the same files
    assert JCK.load_session(d)[1] == 100


def test_snapshot_requires_drained_fill_log(tmp_path):
    ses = _two_snapshots(str(tmp_path / "a"))
    ses.state = dict(ses.state)
    ses.state["filloff"] = torch.ones((1,), dtype=torch.int64)
    with pytest.raises(ValueError, match="drained fill log"):
        ck.save_session(str(tmp_path / "b"), ses, offset=50)


def test_seqjava_snapshot_refuses_fixed_restore(tmp_path):
    """tests/test_checkpoint.py:448: a java snapshot into a fixed
    session, or into the lanes engine, is an operator error."""
    cfg = SQ.SeqConfig(**SEQ_CFGS["java"])
    ses = SeqSession(cfg, device="cpu")
    ses.process_wire(_port(harness_stream(300, seed=7)))
    ck.save_seq_session(str(tmp_path), ses, 300)
    fixed = SQ.SeqConfig(**dict(SEQ_CFGS["java"], compat="fixed"))
    with pytest.raises(ck.SnapshotCapacityError):
        ck.load_seq_session(str(tmp_path), fixed, device="cpu")
    with pytest.raises(ck.SnapshotCapacityError):
        ck.load_session(str(tmp_path), device="cpu")


def test_loaders_raise_without_a_card(tmp_path):
    """The loaders default to the card: without one they raise instead of
    restoring onto the CPU or skipping the snapshot as unreadable."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = SQ.SeqConfig(**SEQ_CFGS["fixed"])
    ses = SeqSession(cfg, device="cpu")
    ses.process_wire(_port(_seq_stream("fixed")[:100]))
    ck.save_seq_session(str(tmp_path), ses, 100)
    with pytest.raises(RuntimeError, match="CUDA"):
        ck.load_seq_session(str(tmp_path), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ck.load_session(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        ck.restore_seq_snapshot(ck.snapshot_path(str(tmp_path), 100))


@pytest.mark.parametrize("direction", ["seqjava_to_native",
                                       "native_to_seqjava"])
def test_seqjava_native_continuations(direction):
    """tests/test_checkpoint.py:400 / :426 with the port's native
    engine: the converted state continues byte-identically to an
    uninterrupted native run, and the port's conversions equal the JAX
    package's."""
    cfg = SQ.SeqConfig(**SEQ_CFGS["java"])
    msgs = harness_stream(1200, seed=13 if direction[0] == "s" else 29)
    cut = 700
    judge = NativeOracleEngine("java")
    want = judge.process_wire(_port(msgs))
    assert want == JaxNative("java").process_wire([m.copy() for m in msgs])
    if direction == "seqjava_to_native":
        ses = SeqSession(cfg, device="cpu")
        head = ses.process_wire(_port(msgs[:cut]))
        dump = JS.to_native_dump(JS.export_seqjava(ses))
        jses = JaxSeq(JSQ.SeqConfig(**SEQ_CFGS["java"]))
        jses.process_wire([m.copy() for m in msgs[:cut]])
        assert dump == JJS.to_native_dump(JJS.export_seqjava(jses))
        eng = NativeOracleEngine("java")
        eng.load_state(dump)
        tail = eng.process_wire(_port(msgs[cut:]))
    else:
        eng = NativeOracleEngine("java")
        head = eng.process_wire(_port(msgs[:cut]))
        snap = JS.from_native_dump(eng.dump_state())
        jsnap = JJS.from_native_dump(eng.dump_state())
        assert sorted(snap) == sorted(jsnap)
        for k in snap:
            if isinstance(snap[k], dict):
                assert snap[k] == jsnap[k], k
            else:
                np.testing.assert_array_equal(snap[k], jsnap[k], err_msg=k)
        ses = JS.import_seqjava(cfg, snap, "cpu")
        tail = ses.process_wire(_port(msgs[cut:]))
    assert head + tail == want


def test_retention_keep_depth(tmp_path, monkeypatch):
    """keep= bounds the snapshot tail; KME_CKPT_KEEP sets the default
    (tests/test_checkpoint.py:650)."""
    ses = LaneSession(L.LaneConfig(**LANE_CFG), width=8, device="cpu")
    ses.process_wire(_port(zipf_symbol_stream(50, num_symbols=8,
                                              num_accounts=24, seed=2)))
    d1 = str(tmp_path / "explicit")
    for off in (10, 20, 30, 40):
        ck.save_session(d1, ses, offset=off, keep=2)
    assert [o for o, _ in ck.list_snapshots(d1)] == [40, 30]
    d2 = str(tmp_path / "default")
    monkeypatch.delenv("KME_CKPT_KEEP", raising=False)
    for off in (10, 20, 30, 40, 50):
        ck.save_session(d2, ses, offset=off)
    assert [o for o, _ in ck.list_snapshots(d2)] == [50, 40, 30]
    d3 = str(tmp_path / "env")
    monkeypatch.setenv("KME_CKPT_KEEP", "1")
    for off in (10, 20):
        ck.save_session(d3, ses, offset=off)
    assert [o for o, _ in ck.list_snapshots(d3)] == [20]


def test_snapshot_extra_and_oldest_retained(tmp_path):
    """The additive `extra` meta round-trips through every snapshot kind
    and the retention anchor moves with pruning
    (tests/test_checkpoint.py:675, :697)."""
    d = str(tmp_path / "ck")
    assert ck.oldest_retained_offset(d) is None
    ora = OracleEngine("fixed", book_slots=64, max_fills=32)
    ck.save_oracle(d, ora, 40, extra={"epoch": 3, "out_seq": 99})
    assert ck.snapshot_extra(d, 40) == {"epoch": 3, "out_seq": 99}
    ck.save_oracle(d, ora, 80)
    assert ck.snapshot_extra(d, 80) == {}
    assert ck.snapshot_extra(d, 999) == {}
    nat = NativeOracleEngine("fixed", book_slots=64, max_fills=32)
    ck.save_native(d, nat, 20, extra={"out_seq": 5})
    assert ck.snapshot_extra(d, 20) == {"out_seq": 5}
    assert ck.load_native(d)[1] == 20
    ses = LaneSession(L.LaneConfig(**LANE_CFG), width=8, device="cpu")
    ses.process_wire(_port(zipf_symbol_stream(50, num_symbols=8,
                                              num_accounts=24, seed=9)))
    ck.save_session(d, ses, offset=10, extra={"epoch": 1, "out_seq": 7})
    assert ck.snapshot_extra(d, 10) == {"epoch": 1, "out_seq": 7}
    assert JCK.snapshot_extra(d, 10) == {"epoch": 1, "out_seq": 7}
    resumed, offset = ck.load_session(d, device="cpu")
    assert offset == 10 and resumed.export_state() == ses.export_state()
    assert ck.oldest_retained_offset(d) == 10
    assert [off for off, _ in ck.all_snapshots(d)] == [80, 40, 20, 10]
    ck.save_oracle(d, ora, 192, keep=2)      # prunes the .pkl at 40
    assert not os.path.exists(os.path.join(d, "ckpt-40.pkl"))
    assert ck.oldest_retained_offset(d) == 10
