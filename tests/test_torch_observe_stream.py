"""The values `chip_smoke.py`'s phase 12 holds the card's observed service
to, recomputed from both packages on the CPU.

The zipf stream at the serve defaults (1024 symbols, 4096 accounts, 128
slots, 16 max fills) runs through the native engine (its MatchOut is
B1's `454c29e3…`); its 1024-message batches give the journal's
canonical lifecycle events and the watch hit set over 1024-message
barriers. Both packages must derive the same events and hits, and these
must be the recorded constants (the card machine has no JAX).
"""

import hashlib
import json
import os
import sys

import torch

from kme_tpu.telemetry import journal as JJ
from kme_tpu.telemetry import xray as JX
from kme_tpu_torch.native.oracle import NativeOracleEngine
from kme_tpu_torch.telemetry import journal as PJ
from kme_tpu_torch.telemetry import xray as PX
from kme_tpu_torch.workload import zipf_symbol_stream

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as CS  # noqa: E402


def _digest(lines):
    h = hashlib.sha256()
    for ln in lines:
        h.update(ln.encode())
        h.update(b"\n")
    return len(lines), h.hexdigest()


def test_observed_constants_from_both_packages():
    msgs = zipf_symbol_stream(**CS.STREAM)
    eng = NativeOracleEngine("fixed", book_slots=CS.SERVE["slots"],
                             max_fills=CS.SERVE["max_fills"])
    B = CS.SERVE["batch"]
    out = []
    for lo in range(0, len(msgs), B):
        o, exc = eng.process_wire_partial(msgs[lo:lo + B])
        assert exc is None
        out.extend(o)
    assert _digest([ln for g in out for ln in g]) == CS.B1_MATCHOUT
    batches = []
    for lo in range(0, len(out), B):
        offs = list(range(lo, min(lo + B, len(out))))
        ev = PJ.batch_events(out[lo:lo + B], offsets=offs)
        assert ev == JJ.batch_events(out[lo:lo + B], offsets=offs)
        batches.append(ev)
    flat = [e for b in batches for e in b]
    canon = PJ.canonical_lines(flat)
    assert canon == JJ.canonical_lines(flat)
    assert _digest(canon) == CS.OBSERVED_CANON
    hits = []
    for mod in (PX, JX):
        w = mod.WatchEngine(list(CS.OBSERVED_WATCH))
        for ev in batches:
            w.observe_events([dict(e) for e in ev])
        hits.append(w.hits)
    assert hits[0] == hits[1]
    doc = json.dumps([list(h) for h in hits[0]])
    assert (len(hits[0]), hashlib.sha256(doc.encode()).hexdigest()) \
        == CS.OBSERVED_HITS == CS.hits_digest(hits[0])
