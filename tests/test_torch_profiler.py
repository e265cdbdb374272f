"""The port's profiler (`kme_tpu_torch/telemetry/profiler.py`) against
the JAX package's.

- `write_transfer_artifact` from the port leaves `kme_tpu`'s entries
  untouched and `kme_tpu`'s `read_transfer_artifact` reads the result;
- a CPU `device_plane` says `backend: "cpu"` and carries none of the
  card fields; a CPU session refuses to time kernels;
- the stage profiler attributes and publishes as the JAX package's;
- trigger captures (and their torch.profiler window) write documents
  both packages' `format_capture` read;
- `dispatch_bytes`, the byte count behind the device plane, on a CPU
  dispatch: message columns, rows read and written, used output rows.
Exact equality throughout.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from kme_tpu.telemetry import profiler as JP
from kme_tpu.telemetry.registry import Registry as JRegistry
from kme_tpu.workload import zipf_symbol_stream
from kme_tpu_torch.bridge import service as SV
from kme_tpu_torch.bridge.broker import InProcessBroker
from kme_tpu_torch.engine import seq as SQ
from kme_tpu_torch.runtime.seqsession import SeqRouter, SeqSession
from kme_tpu_torch.telemetry import profiler as PP
from kme_tpu_torch.telemetry.registry import Registry
from kme_tpu_torch.wire import dumps_order

torch.set_num_threads(1)

CFG = dict(lanes=8, slots=128, accounts=128, max_fills=32, batch=128,
           pos_cap=1 << 11, fill_cap=1 << 12, probe_max=16)


def test_artifact_merge_keeps_jax_entries(tmp_path):
    path = str(tmp_path / "transfer.json")
    JP.write_transfer_artifact(path, {"backend": "cpu",
                                      "h2d_bytes_per_s": 2e9,
                                      "flops_per_batch": 1e6})
    JP.write_transfer_artifact(path, {"backend": "tpu",
                                      "transfer_compute_ratio": 0.4})
    before = JP.read_transfer_artifact(path)
    plane = {"backend": "cuda", "kernel": "seq_scan_kernel<false>",
             "kernel_ms_per_dispatch": 3.8, "bytes_per_batch": 4908,
             "h2d_bytes_per_s": 2.5e10}
    doc = PP.write_transfer_artifact(path, dict(plane))
    assert set(doc) == {"cpu", "tpu", "cuda"}
    back = JP.read_transfer_artifact(path)
    assert back == PP.read_transfer_artifact(path)
    assert back["cpu"] == before["cpu"] and back["tpu"] == before["tpu"]
    assert {k: back["cuda"][k] for k in plane if k != "backend"} == \
        {k: v for k, v in plane.items() if k != "backend"}
    # a second card run overwrites only its own key
    PP.write_transfer_artifact(path, dict(plane, bytes_per_batch=1))
    again = JP.read_transfer_artifact(path)
    assert again["cuda"]["bytes_per_batch"] == 1
    assert again["cpu"] == before["cpu"]
    for mod in (PP, JP):
        with pytest.raises(OSError):
            mod.read_transfer_artifact(str(tmp_path / "missing.json"))


def test_cpu_device_plane_has_no_card_fields():
    ses = SeqSession(SQ.SeqConfig(**CFG), device="cpu")
    msgs = zipf_symbol_stream(300, num_symbols=6, num_accounts=40, seed=1)
    ses.process_wire(msgs)
    for plane in (PP.device_plane(ses), PP.device_plane(None)):
        assert plane["backend"] == "cpu"
        assert not set(plane) & set(PP.CARD_FIELDS)
    assert ses.device_timing() is None
    with pytest.raises(ValueError, match="card"):
        ses.enable_device_plane()


def test_service_cpu_artifact(tmp_path):
    msgs = zipf_symbol_stream(300, num_symbols=6, num_accounts=40, seed=1)
    b = InProcessBroker()
    b.create_topic(SV.TOPIC_IN)
    b.create_topic(SV.TOPIC_OUT)
    for m in msgs:
        b.produce(SV.TOPIC_IN, None, dumps_order(m))
    path = str(tmp_path / "t.json")
    JP.write_transfer_artifact(path, {"backend": "tpu", "x": 1})
    svc = SV.MatchService(b, engine="seq", batch=128, symbols=8,
                          accounts=128, device="cpu", profile=True,
                          profile_artifact=path)
    svc.run(max_messages=len(msgs))
    svc.close()
    doc = JP.read_transfer_artifact(path)
    assert doc["tpu"]["x"] == 1 and set(doc["cpu"]) == {"recorded_at"}
    g = svc.telemetry.snapshot()["gauges"]
    assert "prof_wall_samples_total" in g


def test_stage_profiler_equal_jax():
    stop = threading.Event()

    def _plan():                        # a plan-stage frame
        stop.wait(5.0)

    def _fetch():                       # the port's collect-stage frame
        stop.wait(5.0)

    threads = [threading.Thread(target=f, daemon=True)
               for f in (_plan, _fetch)]
    for t in threads:
        t.start()
    profs = [PP.StageProfiler(interval_s=0.001),
             JP.StageProfiler(interval_s=0.001)]
    try:
        for _ in range(40):
            for p in profs:
                p.sample_once()
    finally:
        stop.set()
    for t in threads:
        t.join(timeout=2.0)
    pf, jf = (p.stage_fractions() for p in profs)
    assert pf["plan"] == 0.5 and pf["collect"] == 0.5
    assert jf["plan"] == 1.0           # the JAX package knows no `_fetch`
    regs = [Registry(), JRegistry()]
    for p, r in zip(profs, regs):
        p.publish(r)
    assert set(regs[0].snapshot()["gauges"]) == \
        set(regs[1].snapshot()["gauges"])
    assert PP.PROF_STAGES == JP.PROF_STAGES


@pytest.mark.parametrize("window", [0.0, 0.05])
def test_trigger_capture_read_by_both(tmp_path, window):
    cap = PP.TriggerCapture(str(tmp_path), p99_us=1_000, cooldown_s=0.0,
                            max_captures=2, window_s=window,
                            registry=Registry())
    assert cap.maybe_fire(None, [{"e2e_us": 10}]) is None
    ex = {"e2e_us": 5_000, "tid": 77, "aid": 3, "oid": 7, "off": 1}
    path = cap.maybe_fire(None, [ex])
    doc = json.load(open(path))
    assert doc["trigger"] == "p99_exemplar" and doc["exemplars"] == [ex]
    if window:
        torch.ones(4).sum()             # some activity in the window
        time.sleep(window)
        trace = cap.close()
        assert trace == doc["device_trace"] and os.path.exists(trace)
        assert "traceEvents" in json.load(open(trace))
        text = PP.format_capture(path)
        assert f"device trace: {trace}" in text
    else:
        assert "device_trace" not in doc and cap.close() is None
    assert PP.list_captures(str(tmp_path)) == JP.list_captures(
        str(tmp_path)) == [path]
    # the JAX package reads the port's document (it shows every key it
    # knows of; the device trace is the port's own)
    jt = JP.format_capture(path)
    assert PP.format_capture(path).startswith(jt.split("\n")[0])
    burn = PP.TriggerCapture(str(tmp_path / "b"), cooldown_s=3600.0)
    assert json.load(open(burn.maybe_fire("slo burn", [])))["trigger"] \
        == "slo_burn"
    assert burn.maybe_fire("slo burn", []) is None


def _dispatch(cfg, msgs):
    router = SeqRouter(cfg.lanes, cfg.accounts)
    state = SQ.make_seq_state(cfg, "cpu")
    out = []
    for lo in range(0, len(msgs), cfg.batch):
        cols, _ = router.route(msgs[lo:lo + cfg.batch])
        chunk = SQ.pack_msgs(cfg, cols, len(cols["act"]))
        pre = {k: v.clone() for k, v in state.items()}
        o = SQ.seq_step(cfg, state, SQ.msgs_to_device(chunk, "cpu"))
        out.append((chunk, o, pre, {k: v.clone()
                                    for k, v in state.items()}))
    return out


def test_dispatch_bytes_counts():
    cfg = SQ.SeqConfig(**CFG)
    msgs = zipf_symbol_stream(600, num_symbols=6, num_accounts=40, seed=3,
                              payout_per_mille=20)
    row = SQ.LN * 4
    seen_fills = False
    for chunk, out, pre, post in _dispatch(cfg, msgs):
        nbytes = SQ.dispatch_bytes(cfg, chunk, out, pre, post, 1)
        ft = int(out[0, 1])
        seen_fills |= ft > 0
        changed = sum(int((pre[k] != post[k]).any(dim=1).sum())
                      for k in SQ.state_keys(cfg))
        floor = (len(SQ.msg_fields(cfg)) * 4 * cfg.batch
                 + (changed + SQ.used_rows(cfg, ft)) * row)
        assert nbytes >= floor and (nbytes - floor) % row == 0
        # a batch of NOPs reads and writes nothing but its columns
        nop = {f: np.zeros_like(chunk[f]) for f in chunk}
        same = {k: v.clone() for k, v in post.items()}
        o = SQ.seq_step(cfg, same, SQ.msgs_to_device(nop, "cpu"))
        assert SQ.dispatch_bytes(cfg, nop, o, post, same, 0) == \
            len(SQ.msg_fields(cfg)) * 4 * cfg.batch \
            + SQ.used_rows(cfg, 0) * row
    assert seen_fills
