"""The values `chip_smoke.py`'s phase 13 (the multi-leader front) holds the
card's grouped deployment to, recomputed from the JAX package on the
CPU (the card machine has no JAX).

- groups2 / groups4 over the payout-free zipf stream at the serve
  defaults (phase 3c's stream; on the PAYOUT stream of phase 4 the
  groups do not reproduce the single leader, in either package: a
  settlement can debit a group past the margin the front granted, so
  the front's shadow ledger no longer bounds it): the single leader's
  MatchOut; the JAX package's front splits the stream (transfers on,
  prefund 8), each group's
  substream runs through the native engine at the seq kernel's capacity
  envelope (128 slots, 16 fills), and `merge_streams` joins the groups;
  the merged MatchOut's (lines, sha256) and the router's counters;
- groups-cross over `cross_account_stream(20_000, ..., cross_frac=1.0)`
  at two groups, and its single-leader MatchOut;
- feed-groups over the stream's first 20,000 messages at two groups: each
  group's stamped MatchOut.gK from the JAX package's exactly-once
  service (native engine), through its `FeedDeriver` at `kme-bench
  --suite feed`'s defaults: the sha256 of every frame's bytes.

The port gives the same split, merge and frames (held here as well).
Heavy (the 109k-message stream at two widths): marked slow.
"""

import hashlib
import os
import sys
import tempfile

import pytest
import torch

from kme_tpu.bridge import front as JF
from kme_tpu.bridge import service as JSV
from kme_tpu.bridge.broker import InProcessBroker as JaxBroker
from kme_tpu.bridge.provision import group_topics
from kme_tpu.feed.derive import FeedDeriver as JaxDeriver
from kme_tpu.native.oracle import NativeOracleEngine
from kme_tpu.wire import dumps_order, parse_order
from kme_tpu.workload import cross_account_stream, zipf_symbol_stream
from kme_tpu_torch.bridge import front as PF
from kme_tpu_torch.feed.derive import FeedDeriver

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


def _engine():
    return NativeOracleEngine("fixed", book_slots=CS.SERVE["slots"],
                              max_fills=CS.SERVE["max_fills"])


def _run(lines):
    out = []
    eng = _engine()
    for lo in range(0, len(lines), 4096):
        out.extend(ln for g in eng.process_wire(
            [parse_order(v) for v in lines[lo:lo + 4096]]) for ln in g)
    return out


def _grouped(lines, n):
    """(merged MatchOut digest, router counters, substream line counts)
    of the JAX package's n-group deployment; the port's split is the
    same."""
    per, router = JF.split_lines(lines, n, prefund=CS.FRONT_PREFUND)
    pper, prouter = PF.split_lines(lines, n, prefund=CS.FRONT_PREFUND)
    assert pper == per and prouter.counters == router.counters
    outs = [_run(p) for p in per]
    merged = JF.merge_streams(outs)
    assert PF.merge_streams(outs) == merged
    return _digest(merged), dict(router.counters), [len(p) for p in per]


@pytest.mark.slow
def test_groups_constants():
    lines = [dumps_order(m) for m in zipf_symbol_stream(**CS.GROUPS_STREAM)]
    single = _run(lines)
    assert _digest(single) == CS.GROUPS_SINGLE
    # the groups reproduce the single leader restricted to their messages
    per, _ = JF.split_lines(lines, 2, prefund=CS.FRONT_PREFUND)
    rep = JF.verify_groups(lines, [_run(p) for p in per],
                           book_slots=CS.SERVE["slots"],
                           max_fills=CS.SERVE["max_fills"],
                           prefund=CS.FRONT_PREFUND)
    assert rep["ok"], rep["mismatches"][:1]
    for n in (2, 4):
        got = _grouped(lines, n)
        assert got == CS.GROUPS_ZIPF[n], (n, got)
    cross = [dumps_order(m) for m in cross_account_stream(**CS.CROSS_STREAM)]
    assert (_digest(_run(cross)),) + _grouped(cross, 2) == CS.GROUPS_CROSS


@pytest.mark.slow
def test_feed_constants():
    lines = [dumps_order(m) for m in zipf_symbol_stream(
        **CS.GROUPS_STREAM)][:CS.GROUPS_CLI_PREFIX]
    per, _router = JF.split_lines(lines, 2, prefund=CS.FRONT_PREFUND)
    got = []
    with tempfile.TemporaryDirectory() as td:
        for k in range(2):
            b = JaxBroker()
            topics = group_topics(k)
            for t in topics:
                b.create_topic(t)
            for ln in per[k]:
                b.produce(topics[0], None, ln)
            svc = JSV.MatchService(
                b, engine="native", compat="fixed", group=(k, 2),
                exactly_once=True, checkpoint_dir=os.path.join(td, str(k)),
                checkpoint_every=1 << 30, **CS.SERVE)
            svc.run(max_messages=len(per[k]))
            svc.close()
            recs = b.fetch(topics[1], 0, 1 << 30)
            digests = []
            for mod in (JaxDeriver, FeedDeriver):
                d = mod(group=k, **CS.FEED_DERIVE)
                h = hashlib.sha256()
                for r in recs:
                    msg = parse_order(r.value) if r.key == "OUT" else None
                    for f in d.on_record(r.key, msg, epoch=r.epoch,
                                         src_seq=r.out_seq):
                        h.update(f.raw)
                digests.append((d.frames_out, h.hexdigest()))
            assert digests[0] == digests[1]
            got.append(digests[0])
    assert tuple(got) == CS.FEED_FRAMES


@pytest.mark.slow
def test_payout_stream_groups_diverge():
    """Why phase 13 serves the payout-free stream: on phase 4's PAYOUT
    stream two groups do not reproduce the single leader, in either
    package — a settlement debits a group past what the front's shadow
    ledger assumed a grant covers, and a later order is rejected there
    (`verify_groups` reports it); the merged stream is 343,068 lines
    against the single leader's 345,906 (B1's)."""
    lines = [dumps_order(m) for m in zipf_symbol_stream(**CS.STREAM)]
    assert _digest(_run(lines)) == CS.B1_MATCHOUT
    per, _ = JF.split_lines(lines, 2, prefund=CS.FRONT_PREFUND)
    outs = [_run(p) for p in per]
    rep = JF.verify_groups(lines, outs, book_slots=CS.SERVE["slots"],
                           max_fills=CS.SERVE["max_fills"],
                           prefund=CS.FRONT_PREFUND)
    assert not rep["ok"]
    first = rep["mismatches"][0]
    assert '"action":7' in first["got"] and '"action":7' not in first["want"]
    assert len(JF.merge_streams(outs)) == 343_068
    assert PF.merge_streams(outs) == JF.merge_streams(outs)

