"""The port's x-ray plane (`kme_tpu_torch/telemetry/xray.py`) against the
JAX package's.

- `materialize` over one durable broker log (written by the port's
  service, with the port's snapshots as anchors) gives equal canonical
  states in both packages at three offsets, cold and anchored;
- `bisect` on the `journal_fill_qty@K` drill pins batch K in both
  packages (the port's seq service on the CPU, the JAX package's oracle
  service), each over the other's journal too, and the repro dumps
  replay across packages;
- the watch grammar, the offline evaluation, `resolve_trace` and the
  watch captures equal the JAX package's;
- `cluster_cut` raises naming the front.
Exact equality throughout.
"""

import json
import os

import pytest
import torch

from kme_tpu.bridge import service as JSV
from kme_tpu.bridge.broker import InProcessBroker as JaxBroker
from kme_tpu.telemetry import xray as JX
from kme_tpu.workload import harness_stream
from kme_tpu_torch.bridge import service as SV
from kme_tpu_torch.bridge.broker import InProcessBroker
from kme_tpu_torch.telemetry import xray as PX
from kme_tpu_torch.telemetry.dtrace import local_tid
from kme_tpu_torch.wire import dumps_order

torch.set_num_threads(1)

KW = dict(compat="fixed", batch=64, slots=128, max_fills=32)


def _stream(n=1200, seed=3):
    return harness_stream(n, seed=seed, num_accounts=8, num_symbols=3,
                          payout_opcode_bug=False, validate=True)


def _serve(mod, mod_broker, msgs, root, engine, **kw):
    log_dir = os.path.join(root, "broker-log")
    b = mod_broker(persist_dir=log_dir)
    b.create_topic(SV.TOPIC_IN)
    b.create_topic(SV.TOPIC_OUT)
    for m in msgs:
        b.produce(SV.TOPIC_IN, None, dumps_order(m))
    if mod is SV:
        kw["device"] = "cpu"
        kw.update(symbols=8, accounts=128)
    svc = mod.MatchService(b, engine=engine, **dict(KW, **kw))
    assert svc.run(max_messages=len(msgs)) == len(msgs)
    svc.close()
    return svc, log_dir


def test_materialize_equal_at_three_offsets(tmp_path):
    msgs = _stream()
    ck = str(tmp_path / "ck")
    svc, log_dir = _serve(SV, InProcessBroker, msgs, str(tmp_path), "seq",
                          checkpoint_dir=ck, checkpoint_every=256,
                          pipeline=2)
    n = len(msgs)
    anchors = []
    for at in (n // 5, n // 2, n):
        pe, pa, pn = PX.materialize(log_dir, at, ckpt_dir=ck,
                                    allow_cold=True, book_slots=128,
                                    max_fills=32)
        je, ja, jn = JX.materialize(log_dir, at, ckpt_dir=ck,
                                    allow_cold=True, book_slots=128,
                                    max_fills=32)
        assert (pa, pn) == (ja, jn)
        anchors.append(pa)
        assert PX.engine_canon(pe) == JX.engine_canon(je)
        cold = PX.materialize(log_dir, at, book_slots=128, max_fills=32)[0]
        assert PX.engine_canon(cold) == JX.engine_canon(JX.materialize(
            log_dir, at, book_slots=128, max_fills=32)[0])
    assert anchors[0] == 0 < anchors[1] < anchors[2]
    # the live session (CPU tensors) at the end equals the cold replay
    assert PX.engine_canon(cold) == PX._canon(
        *(lambda ex: (ex["balances"], ex["positions"],
                      {o: [v["aid"], v["sid"], v["is_buy"], v["price"],
                           v["size"]] for o, v in ex["orders"].items()},
                      ex["books"]))(svc._session.export_state()))
    with pytest.raises(PX.XrayError, match="oldest materializable"):
        PX.materialize(log_dir, 1, ckpt_dir=ck)
    for q in ("balance[1]<0", "depth[1]>=2", "spread[2]==0",
              "position[3,1]>0"):
        pred = PX.parse_watch(q)
        assert PX.eval_engine(pred, pe) == JX.eval_engine(
            JX.parse_watch(q), je)
    assert PX.book_summary(pe, 1) == JX.book_summary(je, 1)
    off = n // 3
    assert PX.resolve_trace(local_tid(0, off), log_dir) == off == \
        JX.resolve_trace(local_tid(0, off), log_dir)


def test_bisect_pins_tampered_batch_in_both_packages(tmp_path,
                                                     monkeypatch):
    msgs = _stream(2000)
    k = 17
    runs = {}
    for mod, broker, tag, engine in ((SV, InProcessBroker, "p", "seq"),
                                     (JSV, JaxBroker, "j", "oracle")):
        root = str(tmp_path / tag)
        jp = os.path.join(root, "journal.bin")
        monkeypatch.setenv("KME_AUDIT_TAMPER", f"journal_fill_qty@{k}")
        svc, log_dir = _serve(mod, broker, msgs, root, engine,
                              checkpoint_dir=os.path.join(root, "ck"),
                              checkpoint_every=512, journal=jp, audit=True,
                              audit_repro_dir=os.path.join(root, "rd"))
        monkeypatch.delenv("KME_AUDIT_TAMPER")
        assert svc._tampered_batch == k and svc.auditor.violations
        runs[tag] = (jp, log_dir, os.path.join(root, "ck"))
    results = {}
    for xmod, xtag in ((PX, "px"), (JX, "jx")):
        for tag, (jp, log_dir, ck) in runs.items():
            # a seq snapshot restores each book in slot order, not in
            # time priority (in both packages), so replays anchored on
            # one may diverge from the truth: the seq service's journal
            # is bisected cold; the oracle's snapshots are exact anchors
            res = xmod.bisect(jp, log_dir, ckpt_dir=ck if tag == "j"
                              else None,
                              repro_dir=str(tmp_path / xtag / tag))
            assert res["divergent"] and res["batch"] == k, (xtag, tag)
            results[(xtag, tag)] = res
    for tag in runs:
        a, b = results[("px", tag)], results[("jx", tag)]
        for key in ("batch", "first_divergent_offset", "diff", "replays",
                    "window_batches"):
            assert a[key] == b[key], key
        # each package's repro replays in the other
        assert PX.replay_bisect_repro(b["repro"]) == \
            JX.replay_bisect_repro(b["repro"])
        assert JX.replay_bisect_repro(a["repro"])["match"]
    assert results[("px", "p")]["diff"] == results[("px", "j")]["diff"]


def test_watch_engine_and_captures_equal_jax(tmp_path):
    from kme_tpu.oracle import OracleEngine as JaxOracle
    from kme_tpu.wire import parse_order as jparse

    msgs = _stream(800, seed=7)
    exprs = ["depth[1]>=4", "balance[1]<0", "spread[1]==0",
             "position[2,1]>0"]
    ora = JaxOracle("fixed")
    groups = [[r.wire() for r in ora.process(jparse(dumps_order(m)))]
              for m in msgs]
    engines = []
    for mod, tag in ((PX, "p"), (JX, "j")):
        w = mod.WatchEngine(exprs, out_dir=str(tmp_path / tag),
                            repro={"log_dir": "/logs",
                                   "checkpoint_dir": "/ck"})
        for lo in range(0, len(groups), 64):
            w.observe_lines(groups[lo:lo + 64],
                            offsets=list(range(lo, lo + len(
                                groups[lo:lo + 64]))),
                            exemplars=[{"tid": 1, "e2e_us": 5}])
        engines.append(w)
    pw, jw = engines
    assert pw.hits == jw.hits and pw.hits
    for pc, jc in zip(pw.capture_paths, jw.capture_paths):
        pd, jd = json.load(open(pc)), json.load(open(jc))
        for key in ("trigger", "predicate", "offset", "value",
                    "exemplars"):
            assert pd[key] == jd[key]
        assert pd["repro"].replace("kme-torch-", "kme-") == jd["repro"]
    for bad in ("balance[1]", "position[1]>0", "depth[1,2]>0", "x[1]<0"):
        with pytest.raises(PX.XrayError):
            PX.parse_watch(bad)
        with pytest.raises(JX.XrayError):
            JX.parse_watch(bad)


def test_cluster_cut_needs_the_front(tmp_path):
    with pytest.raises(NotImplementedError, match="bridge/front.py"):
        PX.cluster_cut(str(tmp_path))
