"""Card-only tests of the port: the seq_step CUDA kernel against its plain
PyTorch version, bit for bit, in fixed and java mode and at deep books
(a book thousands of orders deep, with and without its rows staged in
shared memory); the rows-in-use kernel against its; both instantiations
of the row-copy kernels (B4 gather, B5 scatter: planar rows of one
plane, and both position planes joined to int64) against theirs; the
seq and lanes sessions on the card against the same sessions on the
CPU; and the lanes session's step graph against the eager chunk
function from the same pre-state, across state swaps, with its launches
counted per replay; the seq session's pipelined serving on the card
(submit/collect at depths 2 and 3, the pinned staging ring wrapping, the
second-round output copy) against its serial path and the CPU session;
and the service (seq pipelined, seq java, lanes, and a group of a
multi-leader deployment) on the card against the same service on the CPU, with snapshots restored from the card onto the
CPU and back; a hot-standby replica on the card that follows a dead
leader and is promoted, against a CPU service; the chaos harness's
failover drill against supervised children on the card; the service
served over the Kafka transport (an in-memory stand-in for the client)
against B1's recorded lines; the seq fleet (its shards on their own CUDA streams) in
both dispatch modes against the same fleet on the CPU, with a race probe
that patches accounts across shards in every window; the sharded
lanes engine's captured step against the CPU; and the observability
planes that read the card: the seq session's device plane (CUDA-event
kernel time, bytes per dispatch, H2D bandwidth), a card service's TSDB
store diffed against itself by `kme-torch-prof --diff`, and the
auditor's `check_engine` against the state the card's kernels left; and
the serial parity replica on the card (its segments replayed from CUDA graphs,
captured again over a new state) against the CPU run, with its bit ops
at the int64 edge values and its tables' first-hit tie rule.

Every test here carries the `cuda` marker and skips where
`torch.cuda.is_available()` is false (a CUDA kernel has no CPU mode).
The file imports nothing of JAX, so it also runs on a machine with a card
and no JAX, where tests/conftest.py (which imports JAX) is left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from kme_tpu_torch import native
from kme_tpu_torch.engine import lanes as L
from kme_tpu_torch.engine import seq as SQ
from kme_tpu_torch.ops import rowdma
from kme_tpu_torch.runtime.seqsession import SeqSession
from kme_tpu_torch.runtime.session import CB_FIELDS, LaneSession
from kme_tpu_torch.workload import (deep_book_stream, harness_stream,
                                    zipf_symbol_stream)

torch.set_num_threads(1)

KW = dict(lanes=8, slots=256, accounts=128, max_fills=32, batch=256,
          pos_cap=1 << 11, fill_cap=1 << 12, probe_max=16)
JAVA_KW = dict(KW, max_fills=64, pos_cap=1 << 13, fill_cap=1 << 14,
               compat="java", hbm_books=True)
# 16384 slots: the sweep scratch and the staged rows need 107,520 bytes of
# shared memory, so the launcher's opt-in above 48 KB runs
DEEP_KW = dict(KW, lanes=4, slots=16384, hbm_books=True)

STREAMS = {
    "zipf": (KW, lambda: zipf_symbol_stream(
        1500, num_symbols=7, num_accounts=60, seed=2, payout_per_mille=8)),
    "harness": (KW, lambda: harness_stream(1500, seed=3,
                                           payout_opcode_bug=False)),
    "java_harness": (JAVA_KW, lambda: harness_stream(1500, seed=3)),
    "deep_zipf": (DEEP_KW, lambda: zipf_symbol_stream(
        1500, num_symbols=3, num_accounts=60, seed=2, payout_per_mille=8)),
    "java_deep_zipf": (dict(DEEP_KW, compat="java", max_fills=64),
                       lambda: zipf_symbol_stream(
                           1500, num_symbols=3, num_accounts=60, seed=2)),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the seq_step CUDA kernel has no "
                    "CPU mode")
    return torch.device("cuda")


def _chunks(cfg, msgs):
    from kme_tpu_torch.runtime.seqsession import SeqRouter

    router = SeqRouter(cfg.lanes, cfg.accounts, cfg.compat)
    out = []
    for lo in range(0, len(msgs), cfg.batch):
        cols, _ = router.route(msgs[lo:lo + cfg.batch])
        out.append(SQ.pack_msgs(cfg, cols, len(cols["act"])))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_seq_step_on_card_matches_plain_version(cuda_device, stream):
    """Two-row books (slots=256), payouts, invalid harness prices, java
    quirks, 128-row books: each batch leaves bit-identical planes and
    output; one launch per call, counted under its instantiation."""
    kw, make = STREAMS[stream]
    cfg = SQ.SeqConfig(**kw)
    msgs = make()
    gpu = SQ.make_seq_state(cfg, cuda_device)
    cpu = SQ.make_seq_state(cfg, "cpu")
    before = SQ.LAUNCHES[cfg.compat]
    chunks = _chunks(cfg, msgs)
    for c in chunks:
        og = SQ.seq_step(cfg, gpu, SQ.msgs_to_device(c, cuda_device)).cpu()
        oc = SQ.seq_step(cfg, cpu, SQ.msgs_to_device(c, "cpu"))
        assert torch.equal(og, oc)   # both zero-filled beyond the prefix
        for k in SQ.state_keys(cfg):
            assert torch.equal(gpu[k].cpu(), cpu[k]), k
    assert SQ.LAUNCHES[cfg.compat] - before == len(chunks)
    assert int(cpu["err"][0, 0]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [256, 8192, 16384])
def test_rows_in_use_on_card_matches_plain_version(cuda_device, slots):
    """Empty, sparse, full and top-row-only sides, with negative sizes:
    one launch, the plain version's (lanes, 2) int32."""
    cfg = SQ.SeqConfig(**dict(KW, lanes=6, slots=slots))
    rng = np.random.default_rng(slots)
    bs = np.zeros((cfg.lanes, 2, cfg.nr, 128), np.int32)
    bs[1, 0] = rng.integers(1, 50, bs[1, 0].shape)              # full
    bs[2] = (rng.integers(-1, 2, bs[2].shape)
             * (rng.random(bs[2].shape) < 0.001))               # sparse
    bs[3, 1, cfg.nr - 1, 127] = 7                               # top slot
    bs[4, 0, :cfg.nr // 2] = rng.integers(0, 2, bs[4, 0, :cfg.nr // 2].shape)
    bs[5, 1, 0, 0] = -3
    plane = torch.from_numpy(bs.reshape(-1, 128))
    before = SQ.LAUNCHES["rows_in_use"]
    got = SQ.rows_in_use(cfg, plane.to(cuda_device))
    assert SQ.LAUNCHES["rows_in_use"] - before == 1
    want = SQ.rows_in_use(cfg, plane)
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)
    assert want[1, 0] == cfg.nr and want[3, 1] == cfg.nr and want[5, 1] == 1
    assert not want[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("compat,slots,stage,sid", [
    ("fixed", 8192, 16, 5),     # 24 rows deep: past the staged rows
    ("fixed", 8192, 64, 5),     # every depth staged
    ("fixed", 8192, 0, 5),      # nothing staged
    ("fixed", 16384, 16, 5),
    ("java", 8192, 16, 5),
    ("java", 8192, 64, 5),
    ("java", 8192, 16, 0),      # the merged (Q1) book
])
def test_deep_book_on_card_matches_plain_version(cuda_device, monkeypatch,
                                                 compat, slots, stage, sid):
    """One symbol rested 3000 orders deep on one side, cancelled from the
    top rows, swept across rows, wiped by a PAYOUT (fixed mode) and rested
    again: every dispatch leaves the plain version's planes and output,
    and the rows-in-use kernel agrees with its plain version on each
    state."""
    monkeypatch.setattr(SQ, "STAGE_ROWS", stage)
    cfg = SQ.SeqConfig(**dict(KW, lanes=8, slots=slots, max_fills=16,
                              batch=1024, pos_cap=1 << 13, fill_cap=1 << 14,
                              compat=compat, hbm_books=True))
    msgs = deep_book_stream(3000, sid=sid, barrier=compat == "fixed")
    gpu = SQ.make_seq_state(cfg, cuda_device)
    cpu = SQ.make_seq_state(cfg, "cpu")
    before = dict(SQ.LAUNCHES)
    chunks = _chunks(cfg, msgs)
    deepest = 0
    for c in chunks:
        og = SQ.seq_step(cfg, gpu, SQ.msgs_to_device(c, cuda_device)).cpu()
        oc = SQ.seq_step(cfg, cpu, SQ.msgs_to_device(c, "cpu"))
        assert torch.equal(og, oc)
        for k in SQ.state_keys(cfg):
            assert torch.equal(gpu[k].cpu(), cpu[k]), k
        occ = SQ.rows_in_use(cfg, gpu["bs"]).cpu()
        assert torch.equal(occ, SQ.rows_in_use(cfg, cpu["bs"]))
        deepest = max(deepest, int(occ.max()))
    assert SQ.LAUNCHES[compat] - before[compat] == len(chunks)
    assert SQ.LAUNCHES["rows_in_use"] - before["rows_in_use"] == \
        2 * len(chunks)
    assert int(cpu["err"][0, 0]) == 0
    # a merged book's live prices are strictly apart: it stays in row 0
    assert deepest > 16 if sid else deepest == 1


@pytest.mark.cuda
def test_seq_scan_on_card_is_one_launch(cuda_device):
    cfg = SQ.SeqConfig(**KW)
    chunks = _chunks(cfg, zipf_symbol_stream(1200, num_symbols=7,
                                             num_accounts=60, seed=6))
    stacked = {f: np.stack([c[f] for c in chunks]) for f in SQ.MSG_FIELDS}
    gpu = SQ.make_seq_state(cfg, cuda_device)
    cpu = SQ.make_seq_state(cfg, "cpu")
    before = SQ.LAUNCHES["fixed"]
    og = SQ.seq_scan(cfg, gpu, {f: torch.from_numpy(v).to(cuda_device)
                                for f, v in stacked.items()})
    assert SQ.LAUNCHES["fixed"] - before == 1
    oc = SQ.seq_scan(cfg, cpu, {f: torch.from_numpy(v)
                                for f, v in stacked.items()})
    assert torch.equal(og.cpu(), oc)
    for k in SQ.state_keys(cfg):
        assert torch.equal(gpu[k].cpu(), cpu[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("compat", ["fixed", "java"])
def test_session_on_card_matches_cpu(cuda_device, compat):
    cfg = SQ.SeqConfig(**(KW if compat == "fixed" else JAVA_KW))
    msgs = zipf_symbol_stream(2000, num_symbols=7, num_accounts=60, seed=4,
                              payout_per_mille=6 if compat == "fixed" else 0)
    gpu, cpu = SeqSession(cfg), SeqSession(cfg, device="cpu")
    assert gpu.device.type == "cuda"
    for lo in range(0, len(msgs), 700):
        assert gpu.process_wire(msgs[lo:lo + 700]) == \
            cpu.process_wire(msgs[lo:lo + 700])
    assert gpu.export_state() == cpu.export_state()
    assert gpu.metrics() == cpu.metrics()
    assert gpu.histograms() == cpu.histograms()


@pytest.mark.cuda
def test_wrapper_refuses_mixed_devices(cuda_device):
    cfg = SQ.SeqConfig(**KW)
    msgs = SQ.msgs_to_device(SQ.pack_msgs(cfg, {
        f: np.zeros(0, np.int64) for f in ("act", "oid", "aid", "price",
                                           "size", "lane")}, 0), cuda_device)
    with pytest.raises(ValueError):
        SQ.seq_step(cfg, SQ.make_seq_state(cfg, "cpu"), msgs)
    assert native.build("seq_step").endswith(".so")


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 8, 33])
def test_rowdma_kernels_on_card_match_plain_version(cuda_device, W):
    """Rows of 2 and 64 tiles (the second the kme-serve defaults' 32 KiB
    position rows); lanes with repeated scrap lanes; one launch each."""
    rng = np.random.default_rng(W)
    for S, SUB in ((9, 2), (1025, 64)):
        flat = rng.integers(-2**31, 2**31, (S, SUB, 128), dtype=np.int64
                            ).astype(np.int32)
        k = min(max(W - 1, 1), S - 1)  # distinct real lanes, the rest scrap
        lanes = np.full(W, S - 1, np.int32)
        lanes[rng.choice(W, k, replace=False)] = rng.choice(S - 1, k,
                                                            replace=False)
        rows = rng.integers(-2**31, 2**31, (W, SUB, 128), dtype=np.int64
                            ).astype(np.int32)
        g_flat = torch.from_numpy(flat).to(cuda_device)
        g_lanes = torch.from_numpy(lanes).to(cuda_device)
        before = dict(rowdma.LAUNCHES)
        got = rowdma.gather_lane_rows(g_flat, g_lanes)
        want = rowdma.gather_lane_rows(torch.from_numpy(flat),
                                       torch.from_numpy(lanes))
        assert torch.equal(got.cpu(), want)
        c_flat = torch.from_numpy(flat.copy())
        rowdma.scatter_lane_rows(g_flat, g_lanes,
                                 torch.from_numpy(rows).to(cuda_device), S - 1)
        rowdma.scatter_lane_rows(c_flat, torch.from_numpy(lanes),
                                 torch.from_numpy(rows), S - 1)
        torch.cuda.synchronize()
        assert torch.equal(g_flat.cpu(), c_flat)
        assert rowdma.LAUNCHES["gather"] - before["gather"] == 1
        assert rowdma.LAUNCHES["scatter"] - before["scatter"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 8, 33])
def test_pos_rowdma_kernels_on_card_match_plain_version(cuda_device, W):
    """The (2, joined) instantiations: both planes' rows joined to int64
    blocks and split back, at 2 and 64 tiles per row; lanes with repeated
    scrap lanes; one launch each."""
    rng = np.random.default_rng(100 + W)
    for S, SUB in ((9, 2), (1025, 64)):
        A = SUB * 64
        pa, pv = (rng.integers(-2**31, 2**31, (S, SUB, 128), dtype=np.int64
                               ).astype(np.int32) for _ in "ab")
        k = min(max(W - 1, 1), S - 1)
        lanes = np.full(W, S - 1, np.int32)
        lanes[rng.choice(W, k, replace=False)] = rng.choice(S - 1, k,
                                                            replace=False)
        blks = [rng.integers(-2**63, 2**63 - 1, (W, A), dtype=np.int64)
                for _ in "ab"]
        g = [torch.from_numpy(x).to(cuda_device) for x in (pa, pv)]
        c = [torch.from_numpy(x.copy()) for x in (pa, pv)]
        g_lanes = torch.from_numpy(lanes).to(cuda_device)
        before = dict(rowdma.LAUNCHES)
        got = rowdma.gather_pos_rows(*g, g_lanes)
        want = rowdma.gather_pos_rows(*c, torch.from_numpy(lanes))
        for x, y in zip(got, want):
            assert x.dtype == torch.int64 and torch.equal(x.cpu(), y)
        rowdma.scatter_pos_rows(*g, g_lanes, *[torch.from_numpy(b).to(
            cuda_device) for b in blks], S - 1)
        rowdma.scatter_pos_rows(*c, torch.from_numpy(lanes),
                                *[torch.from_numpy(b) for b in blks], S - 1)
        torch.cuda.synchronize()
        for x, y in zip(g, c):
            assert torch.equal(x.cpu(), y)
        assert rowdma.LAUNCHES["gather_pos"] - before["gather_pos"] == 1
        assert rowdma.LAUNCHES["scatter_pos"] - before["scatter_pos"] == 1


@pytest.mark.cuda
def test_rowdma_wrappers_refuse_bad_tensors(cuda_device):
    flat = torch.zeros((4, 2, 128), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        rowdma.gather_lane_rows(flat, torch.zeros(2, dtype=torch.int64,
                                                  device=cuda_device))
    with pytest.raises(ValueError):
        rowdma.gather_lane_rows(flat, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        rowdma.scatter_lane_rows(flat, torch.zeros(2, dtype=torch.int32,
                                                   device=cuda_device),
                                 torch.zeros((2, 1, 128), dtype=torch.int32,
                                             device=cuda_device), 3)
    assert native.build("rowdma").endswith(".so")


@pytest.mark.cuda
@pytest.mark.parametrize("width", [0, 8])
def test_lane_session_on_card_matches_cpu(cuda_device, width):
    """width 8 at 64 accounts runs pos_dma: one B4 and one B5 launch of
    both position planes per padded scan step, from the step graph."""
    cfg = L.LaneConfig(lanes=8, slots=128, accounts=64, max_fills=16,
                       steps=32)
    msgs = zipf_symbol_stream(1500, num_symbols=7, num_accounts=60, seed=4,
                              payout_per_mille=6)
    gpu = LaneSession(cfg, width=width)
    cpu = LaneSession(cfg, width=width, device="cpu")
    assert gpu.device.type == "cuda"
    assert gpu.dev_cfg.pos_dma == (width > 0)
    gpu.capture()         # ahead of the count: its warm-up step runs eagerly
    before = dict(rowdma.LAUNCHES)
    for lo in range(0, len(msgs), 700):
        assert gpu.process_wire(msgs[lo:lo + 700]) == \
            cpu.process_wire(msgs[lo:lo + 700])
    assert gpu.graph_stats["captures"] == 1
    for k in ("gather_pos", "scatter_pos"):
        assert rowdma.LAUNCHES[k] - before[k] == (gpu.steps if width else 0)
    for k in ("gather", "scatter"):
        assert rowdma.LAUNCHES[k] == before[k]
    assert gpu.export_state() == cpu.export_state()
    assert gpu.metrics() == cpu.metrics()
    assert gpu.histograms() == cpu.histograms()
    gc, cc = gpu.export_canonical(), cpu.export_canonical()
    for k in cc:
        assert np.array_equal(gc[k], cc[k]), k


LANE_CFG = L.LaneConfig(lanes=8, slots=128, accounts=64, max_fills=16,
                        steps=32, fill_buffer=1 << 16)


class _Checked(LaneSession):
    """Every window also run from a copy of its pre-state by the eager
    chunk function on the card: packed outputs, the used fill-log prefix
    and every other state plane must equal the graph's (past the prefix
    the log is scratch: at full width every unused fill lands on one
    overflow column, in no set order)."""

    checked = 0

    def _run_window(self, T, M, cb):
        pre = {k: v.clone() for k, v in self.state.items()}
        outs = super()._run_window(T, M, cb)
        eager, eouts = L.build_lane_chunk(self.dev_cfg, T, M)(
            pre, {f: torch.from_numpy(cb[r].copy()).to(self.device)
                  for r, f in enumerate(CB_FIELDS)})
        assert torch.equal(outs["packed"], eouts["packed"])
        end = int(self.state["filloff"][0])
        for k, v in self.state.items():
            if k == "fillbuf":
                v, eager[k] = v[:, :end], eager[k][:, :end]
            assert torch.equal(v, eager[k]), k
        self.checked += 1
        return outs


@pytest.mark.cuda
@pytest.mark.parametrize("width", [0, 8])
def test_graph_windows_equal_eager_chunk(cuda_device, width):
    msgs = zipf_symbol_stream(1500, num_symbols=7, num_accounts=60, seed=5,
                              payout_per_mille=6)
    gpu = _Checked(LANE_CFG, width=width)
    cpu = LaneSession(LANE_CFG, width=width, device="cpu")
    for lo in range(0, len(msgs), 500):
        assert gpu.process_wire(msgs[lo:lo + 500]) == \
            cpu.process_wire(msgs[lo:lo + 500])
    assert gpu.checked > 3
    assert gpu.graph_stats["captures"] == 1
    assert gpu.graph_stats["replays"] == gpu.steps


@pytest.mark.cuda
def test_state_swap_recaptures_and_stays_exact(cuda_device):
    """Replacing the state between windows (a tensor, the whole dict,
    load_numpy, import_canonical) captures the step graph again; the
    session stays line-identical to a CPU session."""
    msgs = zipf_symbol_stream(2000, num_symbols=7, num_accounts=60, seed=7,
                              payout_per_mille=6)
    gpu = LaneSession(LANE_CFG, width=8)
    cpu = LaneSession(LANE_CFG, width=8, device="cpu")
    swaps = [
        lambda: gpu.state.update(bal=gpu.state["bal"].clone()),
        lambda: setattr(gpu, "state", {k: v.clone()
                                       for k, v in gpu.state.items()}),
        lambda: gpu.load_numpy(L.state_to_numpy(gpu.state),
                               *_lane_maps(gpu)),
        lambda: gpu.import_canonical(gpu.export_canonical(),
                                     *_lane_maps(gpu)),
    ]
    for i, lo in enumerate(range(0, len(msgs), 400)):
        assert gpu.process_wire(msgs[lo:lo + 400]) == \
            cpu.process_wire(msgs[lo:lo + 400])
        assert gpu.graph_stats["captures"] == min(i, len(swaps)) + 1
        if i < len(swaps):
            key = gpu.graph_key()
            swaps[i]()
            assert gpu.graph_key() != key
    gc, cc = gpu.export_canonical(), cpu.export_canonical()
    for k in cc:
        assert np.array_equal(gc[k], cc[k]), k


def _lane_maps(ses):
    sch = ses.scheduler
    return (dict(sch.aid_idx), dict(sch.sid_lane), dict(sch.oid_sid),
            sch._rr_lane)


@pytest.mark.cuda
def test_launches_count_graph_replays(cuda_device):
    """The step graph holds one launch of each (2, joined) kernel; each
    replay adds them to LAUNCHES, and the capture itself adds none."""
    gpu = LaneSession(LANE_CFG, width=8)
    before = dict(rowdma.LAUNCHES)
    gpu.capture()
    assert gpu._graph_counts == {"gather": 0, "scatter": 0, "gather_pos": 1,
                                 "scatter_pos": 1}
    # the warm-up step ran eagerly: one launch each
    for k in ("gather_pos", "scatter_pos"):
        assert rowdma.LAUNCHES[k] - before[k] == 1
    before = dict(rowdma.LAUNCHES)
    gpu.process_wire(zipf_symbol_stream(600, num_symbols=7, num_accounts=60,
                                        seed=8))
    torch.cuda.synchronize()
    assert gpu.graph_stats["captures"] == 1 and gpu.steps > 0
    for k in ("gather_pos", "scatter_pos"):
        assert rowdma.LAUNCHES[k] - before[k] == gpu.steps


def _pipelined(ses, batches, depth):
    """submit up to `depth` batches ahead of collect; -> the bytes."""
    parts, pend = [], []
    for b in batches:
        pend.append(ses.submit(b))
        if len(pend) >= depth:
            parts.append(ses.collect(pend.pop(0)))
    while pend:
        parts.append(ses.collect(pend.pop(0)))
    return b"".join(p[0] for p in parts)


def _pipe_stream(compat):
    return zipf_symbol_stream(2000, num_symbols=7, num_accounts=60, seed=4,
                              payout_per_mille=6 if compat == "fixed" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("compat,depth", [("fixed", 2), ("fixed", 3),
                                          ("java", 2)])
def test_pipelined_on_card_equals_serial_and_cpu(cuda_device, compat, depth):
    """submit/collect on the card (pinned staging ring, copy stream, early
    header copy behind an event) gives the bytes and state of the serial
    path on the card and of the CPU session."""
    cfg = SQ.SeqConfig(**(KW if compat == "fixed" else JAVA_KW))
    msgs = _pipe_stream(compat)
    parts = [msgs[lo:lo + cfg.batch] for lo in range(0, len(msgs), cfg.batch)]
    serial, cpu = SeqSession(cfg), SeqSession(cfg, device="cpu")
    want = b"".join(cpu.process_wire_buffer(p)[0] for p in parts)
    assert b"".join(serial.process_wire_buffer(p)[0] for p in parts) == want
    ses = SeqSession(cfg)
    before = SQ.LAUNCHES[compat]
    assert _pipelined(ses, parts, depth) == want
    assert SQ.LAUNCHES[compat] - before == len(parts) == ses.dispatches
    for k in SQ.state_keys(cfg):
        assert torch.equal(ses.state[k].cpu(), cpu.state[k]), k
    # every submit after the first staged under an uncollected batch
    # (the >= 0.5 gate on this wall-clock share is chip_smoke.py's, over
    # 107 batches; over 9, the first submit's one-off costs can outweigh
    # the other 8)
    assert 0 < ses.h2d_overlap_frac < 1
    assert len(ses._staging.ring) == depth + 1


@pytest.mark.cuda
def test_pinned_ring_wraps_many_times(cuda_device):
    """Depth 3 over 64-message batches: the staging ring (depth + 1 slots)
    is reused many times, each slot only after its last copy."""
    cfg = SQ.SeqConfig(**KW)
    msgs = _pipe_stream("fixed")
    parts = [msgs[lo:lo + 64] for lo in range(0, len(msgs), 64)]
    cpu = SeqSession(cfg, device="cpu")
    want = b"".join(cpu.process_wire_buffer(p)[0] for p in parts)
    ses = SeqSession(cfg)
    assert _pipelined(ses, parts, 3) == want
    ring = ses._staging.ring
    assert len(ring) == 4 and ses._staging.turn == len(parts) > 6 * len(ring)


@pytest.mark.cuda
def test_staging_ring_is_allocated_with_the_session(cuda_device):
    """The ring's first three slots exist, sized for one batch, before
    any submit; at depth 2 every batch's planes are views of a slot's
    own device buffer, so no staging allocates."""
    cfg = SQ.SeqConfig(**KW)
    msgs = _pipe_stream("fixed")
    parts = [msgs[lo:lo + cfg.batch] for lo in range(0, len(msgs), cfg.batch)]
    ses = SeqSession(cfg)
    ring = ses._staging.ring
    n = len(SQ.msg_fields(cfg)) * cfg.batch
    assert len(ring) == 3
    assert all(s[0].is_pinned() and s[0].numel() == n and
               s[1].is_cuda and s[1].numel() == n for s in ring)
    bufs = [(s[0].data_ptr(), s[1].data_ptr()) for s in ring]
    ptrs = []
    orig = ses._staging.stage

    def stage(planes, inflight):
        out = orig(planes, inflight)
        ptrs.append(out[0].data_ptr())
        return out

    ses._staging.stage = stage
    cpu = SeqSession(cfg, device="cpu")
    want = b"".join(cpu.process_wire_buffer(p)[0] for p in parts)
    assert _pipelined(ses, parts, 2) == want
    assert [(s[0].data_ptr(), s[1].data_ptr()) for s in ring] == bufs
    assert ptrs == [bufs[i % 3][1] for i in range(len(parts))]


@pytest.mark.cuda
def test_forced_hint_runs_the_overflow_copy(cuda_device, monkeypatch):
    """With the first fetch cut to one fill group per call, calls with
    more fills take the side stream's second-round copy; the bytes do
    not change."""
    cfg = SQ.SeqConfig(**KW)
    msgs = _pipe_stream("fixed")
    parts = [msgs[lo:lo + cfg.batch] for lo in range(0, len(msgs), cfg.batch)]
    cpu = SeqSession(cfg, device="cpu")
    want = b"".join(cpu.process_wire_buffer(p)[0] for p in parts)
    ses = SeqSession(cfg)
    monkeypatch.setattr(ses, "_hint", lambda: 1)
    assert _pipelined(ses, parts, 2) == want
    assert ses.overflow_fetches > 0 and cpu.overflow_fetches == 0


# ---------------------------------------------------------------------------
# the serving stack and checkpoints on the card

SERVICE_MODES = {
    "seq_pipeline2": dict(engine="seq", compat="fixed", pipeline=2),
    "seq_java": dict(engine="seq", compat="java", slots=256, max_fills=64),
    "lanes": dict(engine="lanes", compat="fixed", width=8, slots=64),
}


def _serve(values, device, **kw):
    from kme_tpu_torch.bridge.broker import InProcessBroker
    from kme_tpu_torch.bridge.provision import provision
    from kme_tpu_torch.bridge.service import TOPIC_IN, TOPIC_OUT, MatchService

    b = InProcessBroker()
    provision(b)
    for v in values:
        b.produce(TOPIC_IN, None, v)
    svc = MatchService(b, device=device, **dict(
        dict(batch=128, symbols=8, accounts=128, slots=128, max_fills=32),
        **kw))
    assert svc.run(max_messages=len(values), poll_timeout=0.05) == \
        len(values)
    svc.close()
    return [f"{r.key} {r.value}" for r in b.fetch(TOPIC_OUT, 0, 1 << 30)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(SERVICE_MODES))
def test_card_service_equals_cpu_service(cuda_device, mode):
    from kme_tpu_torch.wire import dumps_order

    kw = SERVICE_MODES[mode]
    if kw["compat"] == "java":
        msgs = harness_stream(1200, seed=5)
    else:
        msgs = harness_stream(1200, seed=3, num_symbols=4, num_accounts=8,
                              payout_opcode_bug=False, validate=True)
    values = [dumps_order(m) for m in msgs]
    assert _serve(values, "cuda", **kw) == _serve(values, "cpu", **kw)


def _serve_group(values, device, k, n, root=None, **kw):
    """Group k of n behind the front: (MatchOut.gK, Xfer.gK) records as
    (epoch, out_seq, key, value), exactly once when `root` is given."""
    from kme_tpu_torch.bridge.broker import InProcessBroker
    from kme_tpu_torch.bridge.provision import group_topics, provision
    from kme_tpu_torch.bridge.service import MatchService

    b = InProcessBroker()
    topics = group_topics(k)
    provision(b, topics=topics)
    for v in values:
        b.produce(topics[0], None, v)
    if root is not None:
        kw.update(exactly_once=True, checkpoint_dir=root)
    svc = MatchService(b, device=device, group=(k, n), **dict(
        dict(batch=128, symbols=16, accounts=128, slots=128, max_fills=32),
        **kw))
    assert svc.run(max_messages=len(values), poll_timeout=0.05) == \
        len(values)
    xfer = dict(svc._xfer)
    svc.close()
    return [[(r.epoch, r.out_seq, r.key, r.value)
             for r in b.fetch(t, 0, 1 << 30)] for t in topics[1:]], xfer


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", [0, 2])
def test_card_grouped_service_equals_cpu_service(cuda_device, pipeline,
                                                 tmp_path):
    """Each group of a two-group deployment served by the seq engine on
    the card equals the same group on the CPU: MatchOut.gK, the stamped
    Xfer.gK transfer legs and the transfer ledger."""
    from kme_tpu_torch.bridge import front
    from kme_tpu_torch.wire import dumps_order
    from kme_tpu_torch.workload import cross_account_stream

    lines = [dumps_order(m) for m in cross_account_stream(
        1500, 16, 64, 2, seed=3, cross_frac=0.7)]
    per, router = front.split_lines(lines, 2)
    assert router.counters["cross_shard_transfers_total"] > 0
    for k in range(2):
        got = _serve_group(per[k], "cuda", k, 2, str(tmp_path / f"c{k}"),
                           engine="seq", pipeline=pipeline)
        want = _serve_group(per[k], "cpu", k, 2, str(tmp_path / f"h{k}"),
                            engine="seq", pipeline=pipeline)
        assert got == want and got[1]["legs"] > 0


@pytest.mark.cuda
def test_card_replica_follows_and_promotes(cuda_device, tmp_path):
    """A hot standby on the card: a pipelined exactly-once leader dies
    after its snapshot; an in-process `Replica(device="cuda")` restores
    it, follows one batch short of the leader's heartbeat, holds, is
    promoted by a pid-less promote.json and serves the rest. Its durable
    MatchOut, deduped by its stamps (none twice), equals a CPU
    service's on the same stream."""
    import json
    import threading
    import time

    from kme_tpu_torch.bridge.broker import InProcessBroker
    from kme_tpu_torch.bridge.consume import DedupRing
    from kme_tpu_torch.bridge.provision import provision
    from kme_tpu_torch.bridge.replica import Replica
    from kme_tpu_torch.bridge.service import TOPIC_IN, MatchService
    from kme_tpu_torch.wire import dumps_order

    kw = dict(engine="seq", compat="fixed", batch=128, symbols=8,
              accounts=128, slots=128, max_fills=32)
    values = [dumps_order(m) for m in harness_stream(
        1200, seed=3, num_symbols=4, num_accounts=8,
        payout_opcode_bug=False, validate=True)]
    ck = str(tmp_path / "ck")
    b = InProcessBroker(persist_dir=str(tmp_path / "ck" / "broker-log"))
    provision(b)
    for v in values:
        b.produce(TOPIC_IN, None, v)
    leader = MatchService(b, pipeline=2, checkpoint_dir=ck,
                          exactly_once=True, checkpoint_every=384,
                          device="cuda", **kw)
    leader.run(max_messages=640, poll_timeout=0.05)
    assert (leader.offset, leader._last_ckpt_offset) == (640, 384)
    leader._write_heartbeat(str(tmp_path / "ck" / "serve.health"),
                            leader.offset)
    del leader, b
    rep = Replica(ck, listen="127.0.0.1:0", checkpoint_every=384,
                  poll=0.02, health_every=0.05,
                  max_messages=len(values) - 512, device="cuda", **kw)
    assert rep.svc.offset == 384
    assert rep.svc._session.state["bal_lo"].is_cuda
    rc = [None]
    th = threading.Thread(target=lambda: rc.__setitem__(0, rep.run()),
                          daemon=True)
    th.start()
    deadline = time.monotonic() + 120
    while rep.svc.offset < 512 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)
    assert rep.svc.offset == 512                # the one-batch holdback
    with open(rep.promote_file, "w") as f:
        json.dump({"failed_at": time.time()}, f)
    th.join(timeout=120)
    assert rc[0] == 0
    gauges = rep.svc.telemetry.snapshot()["gauges"]
    assert gauges["leader_epoch"] == 2 and gauges["dup_suppressed_total"] > 0
    with open(tmp_path / "ck" / "broker-log" / "MatchOut.log") as f:
        rows = [json.loads(ln) for ln in f]
    assert len({(r[2], r[3]) for r in rows}) == len(rows)
    ring = DedupRing()
    got = [f"{r[0]} {r[1]}" for r in rows if not ring.is_dup(r[2], r[3])]
    assert got == _serve(values, "cpu", **kw)


@pytest.mark.cuda
def test_card_chaos_failover(cuda_device, tmp_path):
    """`kme-torch-chaos --scenario failover --engine seq` as a user runs
    it: the supervised leader and its hot standby run B1 on the card
    (chaos's default `--device cuda`), the leader is SIGKILLed mid-stream
    and the standby promoted; the report must say ok (promotion within
    2.0 s, deduped MatchOut byte-exact, dedup exercised, stale epoch
    fenced)."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    native.build("seq_step")        # the children load it, not build it
    native.load_library()
    run_dir = str(tmp_path / "run")
    proc = subprocess.run(
        [sys.executable, "-m", "kme_tpu_torch.cli", "chaos", "--scenario",
         "failover", "--engine", "seq", "--seed", "0", "--events", "2000",
         "--dir", run_dir, "--timeout", "300"],
        cwd=root, capture_output=True, text=True, timeout=420)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(os.path.join(run_dir, "chaos-report.json")) as f:
        report = json.load(f)
    assert report["ok"] and not report["failures"], report["failures"]
    assert report["engine"] == "seq"
    assert report["failover"]["promotions"] >= 1
    assert report["verify"]["epochs"][-1] >= 2


# the MatchOut (lines, sha256 of the lines each followed by a newline) of
# the first KAFKA_PREFIX messages of chip_smoke.py's zipf stream at the
# serve defaults: B1's lines, as the oracle gives them
# (tests/test_torch_kafka.py recomputes them with the JAX package's oracle)
KAFKA_PREFIX = 10_240
KAFKA_PREFIX_MATCHOUT = (
    21_298, "e4d4e49c3b775febc21273ecb5d3bc0c4331336fe1c41911b22a21437bf18486")


@pytest.mark.cuda
def test_card_service_over_kafka(cuda_device, monkeypatch):
    """`kme-torch-serve --kafka` in process, the seq engine on the card at
    the serve defaults, the Kafka cluster an in-memory stand-in for the
    aiokafka client (chip_smoke.py's): the MatchOut of the first
    KAFKA_PREFIX zipf messages is the recorded B1 lines', with one B1
    launch per dispatch."""
    import hashlib
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as CS
    from kme_tpu_torch.bridge import serve
    from kme_tpu_torch.wire import dumps_order

    msgs = zipf_symbol_stream(**CS.STREAM)[:KAFKA_PREFIX]
    logs = {"MatchIn": [(None, dumps_order(m).encode()) for m in msgs]}
    for name, mod in CS.kafka_stand_in(logs).items():
        monkeypatch.setitem(sys.modules, name, mod)
    torch.cuda.synchronize()
    SQ.LAUNCHES["fixed"] = 0
    assert serve.main(["--kafka", "stand-in:9092", "--engine", "seq",
                       "--auto-provision", "--max-messages",
                       str(KAFKA_PREFIX)]) == 0
    torch.cuda.synchronize()
    assert SQ.LAUNCHES["fixed"] == -(-KAFKA_PREFIX // 1024)
    h = hashlib.sha256()
    for k, v in logs["MatchOut"]:
        h.update(k + b" " + v + b"\n")
    assert (len(logs["MatchOut"]), h.hexdigest()) == KAFKA_PREFIX_MATCHOUT


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fixed", "java", "lanes"])
def test_card_snapshot_restores_on_cpu_and_back(cuda_device, kind, tmp_path):
    """A card session's snapshot restores into a CPU session and a CPU
    session's into the card; every continuation equals an uninterrupted
    card run, and card and CPU snapshots of one prefix carry one
    digest."""
    from kme_tpu_torch.runtime import checkpoint as ck

    if kind == "lanes":
        cfg = L.LaneConfig(lanes=8, slots=64, accounts=64, max_fills=32)
        msgs = zipf_symbol_stream(800, num_symbols=8, num_accounts=24,
                                  seed=21)

        def make(dev):
            return LaneSession(cfg, width=8, device=dev)

        save, load = ck.save_session, ck.load_session
    else:
        cfg = SQ.SeqConfig(**(JAVA_KW if kind == "java" else KW))
        msgs = (harness_stream(800, seed=7) if kind == "java" else
                zipf_symbol_stream(800, num_symbols=7, num_accounts=60,
                                   seed=2, payout_per_mille=8))

        def make(dev):
            return SeqSession(cfg, device=dev)

        save = ck.save_seq_session

        def load(d, device):
            return ck.load_seq_session(d, cfg, device=device)
    cut = 400
    want = make("cuda").process_wire(msgs)
    digests = []
    for src, dst in (("cuda", "cpu"), ("cpu", "cuda")):
        head = make(src)
        assert head.process_wire(msgs[:cut]) == want[:cut]
        d = str(tmp_path / src)
        path = save(d, head, cut)
        digests.append(bytes(np.load(path)["digest"]).decode())
        tail, off = load(d, device=dst)
        assert off == cut and tail.device.type == dst
        assert tail.process_wire(msgs[cut:]) == want[cut:]
    assert digests[0] == digests[1]


# ---------------------------------------------------------------------------
# the seq fleet and the sharded lanes engine on the card

FLEET_CFG = dict(lanes=8, slots=128, accounts=128, max_fills=16,
                 pos_cap=1 << 10, probe_max=8)


def _fleet(device, shards=4, **kw):
    from kme_tpu_torch.parallel.seqmesh import SeqMeshSession

    return SeqMeshSession(SQ.SeqConfig(**FLEET_CFG), shards, device=device,
                          **kw)


def _sliced(ses, msgs, n=300):
    out = []
    for lo in range(0, len(msgs), n):
        out.extend(ses.process_wire(msgs[lo:lo + n]))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch", ["async", "lockstep"])
def test_fleet_on_card_matches_cpu(cuda_device, dispatch):
    """The fleet at 4 shards on the card == on the CPU == one CPU
    SeqSession, over zipf-hot in slices (migrations between slices) and a
    zipf stream with PAYOUT barriers; every shard launches the kernel."""
    from kme_tpu_torch.workload import zipf_hot_stream

    for msgs in (zipf_hot_stream(1200, num_symbols=8, num_accounts=24,
                                 seed=7),
                 zipf_symbol_stream(900, num_symbols=8, num_accounts=24,
                                    seed=11, zipf_a=1.0,
                                    payout_per_mille=5)):
        gpu, cpu = _fleet("cuda", dispatch=dispatch), _fleet(
            "cpu", dispatch=dispatch)
        single = SeqSession(SQ.SeqConfig(**FLEET_CFG), device="cpu")
        before = SQ.LAUNCHES["fixed"]
        got = _sliced(gpu, msgs)
        assert got == _sliced(cpu, msgs) == single.process_wire(msgs)
        assert SQ.LAUNCHES["fixed"] > before
        assert gpu.export_state() == cpu.export_state() == \
            single.export_state()
        assert gpu.shard_stats() == cpu.shard_stats()
        assert gpu.metrics() == cpu.metrics()
        for k, v in cpu.gather_state().items():
            assert np.array_equal(gpu.gather_state()[k], v), k
    assert gpu.shard_stats()["migrations"] >= 0


def _race_probe_stream(accounts=16, symbols=8, rounds=12):
    """Every account trades on a different symbol each round, so its
    shard changes between windows: every window after the preamble
    takes point-to-point balance patches."""
    from kme_tpu_torch import opcodes as op
    from kme_tpu_torch.wire import OrderMsg

    msgs = []
    for a in range(accounts):
        msgs.append(OrderMsg(action=op.CREATE_BALANCE, aid=a))
        msgs.append(OrderMsg(action=op.TRANSFER, aid=a, size=1_000_000))
    for sid in range(symbols):
        msgs.append(OrderMsg(action=op.ADD_SYMBOL, sid=sid))
    oid = 1
    for i in range(rounds):
        for a in range(accounts):
            buy = (a + i // 2) % 2 == 0
            msgs.append(OrderMsg(action=op.BUY if buy else op.SELL, oid=oid,
                                 aid=a, sid=(a + i) % symbols,
                                 price=48 + (a * 7 + i) % 5,
                                 size=1 + (a + 3 * i) % 5))
            oid += 1
    return msgs


@pytest.mark.cuda
def test_fleet_race_probe_patch_every_window(cuda_device):
    """Async at 4 shards with a dependency patch in every window: the
    source's planes must be read as of the window before, on its own
    stream — a read of its live planes from another stream would race."""
    msgs = _race_probe_stream()
    plan = _fleet("cpu", rebalance=False)
    cols, _ = plan.router.route(msgs)
    _, placements, _, _ = plan.plan_windows(cols)
    d = plan.plan_dispatch(cols, placements)
    assert {w for w, _ in d["deps"]} == set(range(1, d["W"]))
    for _ in range(3):
        gpu = _fleet("cuda", rebalance=False)
        cpu = _fleet("cpu", rebalance=False)
        assert gpu.process_wire(msgs) == cpu.process_wire(msgs)
        assert gpu.export_state() == cpu.export_state()
        assert gpu.metrics()["fills"] == cpu.metrics()["fills"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_lane_session_on_card_matches_cpu(cuda_device, shards):
    """The sharded step (each lane block on its stream, then the merge)
    replayed from one captured graph == the CPU's eager blocks; it
    launches no row-copy kernel."""
    cfg = L.LaneConfig(lanes=8, slots=128, accounts=64, max_fills=16,
                       steps=32)
    msgs = zipf_symbol_stream(1500, num_symbols=7, num_accounts=60, seed=4,
                              payout_per_mille=6)
    gpu = LaneSession(cfg, shards=shards)
    cpu = LaneSession(cfg, shards=shards, device="cpu")
    gpu.capture()
    before = dict(rowdma.LAUNCHES)
    for lo in range(0, len(msgs), 700):
        assert gpu.process_wire(msgs[lo:lo + 700]) == \
            cpu.process_wire(msgs[lo:lo + 700])
    assert gpu.graph_stats["captures"] == 1
    assert gpu.graph_stats["replays"] == gpu.steps
    assert dict(rowdma.LAUNCHES) == before
    assert gpu.export_state() == cpu.export_state()
    assert gpu.metrics() == cpu.metrics()
    assert gpu.histograms() == cpu.histograms()


# ---------------------------------------------------------------------------
# observability on the card: the device plane and the auditor


@pytest.mark.cuda
def test_device_plane_of_a_card_session(cuda_device, tmp_path):
    """The seq session times every dispatch with CUDA events and counts
    the bytes of every probed one (`dispatch_bytes`, the kernel table's
    count); the plane carries them, the measured H2D bandwidth and the
    transfer seconds, and merges beside other backends' entries."""
    from kme_tpu_torch.telemetry import profiler as PP

    cfg = SQ.SeqConfig(**KW)
    ses = SeqSession(cfg)
    msgs = zipf_symbol_stream(1500, num_symbols=7, num_accounts=60, seed=2,
                              payout_per_mille=8)
    ses.enable_device_plane()
    with pytest.raises(ValueError, match="timed no dispatch"):
        PP.device_plane(ses)
    cpu = SeqSession(cfg, device="cpu")
    for lo in range(0, len(msgs), cfg.batch):
        part = msgs[lo:lo + cfg.batch]
        assert ses.process_wire(part) == cpu.process_wire(part)
    plane = PP.device_plane(ses)
    assert plane["backend"] == "cuda"
    assert plane["dispatches_timed"] == ses.dispatches > 0
    assert plane["dispatches_probed"] == -(-ses.dispatches // 16)
    assert plane["kernel_ms_per_dispatch"] > 0
    assert plane["bytes_per_batch"] > len(SQ.msg_fields(cfg)) * 4 * cfg.batch
    assert plane["h2d_bytes_per_s"] > 1e9
    assert plane["transfer_s_per_batch"] == round(
        plane["bytes_per_batch"] / plane["h2d_bytes_per_s"], 9)
    path = str(tmp_path / "t.json")
    PP.write_transfer_artifact(path, {"backend": "cpu", "x": 1})
    doc = PP.write_transfer_artifact(path, plane)
    assert doc["cpu"]["x"] == 1 and doc["cuda"]["kernel"].startswith(
        "seq_scan_kernel")


@pytest.mark.cuda
def test_prof_diff_of_a_card_store_against_itself(cuda_device, tmp_path,
                                                  capsys):
    """A card service's TSDB store (the seq engine pipelined, the host
    profiler on, a heartbeat every 20 ms) diffed against itself by
    `kme-torch-prof --diff`: stages with evidence, every ratio 1.0, no
    suspect."""
    import json

    from kme_tpu_torch import cli
    from kme_tpu_torch.bridge.broker import InProcessBroker
    from kme_tpu_torch.bridge.provision import provision
    from kme_tpu_torch.bridge.service import TOPIC_IN, MatchService
    from kme_tpu_torch.telemetry import tsdb
    from kme_tpu_torch.wire import dumps_order

    values = [dumps_order(m) for m in zipf_symbol_stream(
        1500, num_symbols=7, num_accounts=60, seed=2, payout_per_mille=8)]
    b = InProcessBroker()
    provision(b)
    for v in values:
        b.produce(TOPIC_IN, None, v)
    store = str(tmp_path / "tsdb")
    svc = MatchService(b, engine="seq", compat="fixed", pipeline=2,
                       batch=128, symbols=8, accounts=128, slots=128,
                       max_fills=32, tsdb=store, profile=True,
                       device=cuda_device)
    assert svc.run(max_messages=len(values), poll_timeout=0.05,
                   health_every=0.02) == len(values)
    assert svc._session.dispatches > 0
    svc.close()
    assert tsdb.window_summary(store)
    assert cli.prof_main(["--diff", store, store, "--json"]) == 0
    att = json.loads(capsys.readouterr().out)
    assert att["stages"] and att["suspect"] is None
    assert all(e["ratio"] == 1.0 for s in att["stages"]
               for e in s["evidence"])


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["seq", "lanes"])
def test_check_engine_on_card_state(cuda_device, engine):
    """The auditor's shadow ledger, fed from the journal's events of a
    card session, equals the state the card's kernels left (exported),
    and catches a balance off by one."""
    from kme_tpu_torch.telemetry.audit import InvariantAuditor
    from kme_tpu_torch.telemetry.journal import batch_events

    msgs = zipf_symbol_stream(1500, num_symbols=7, num_accounts=60, seed=2,
                              payout_per_mille=8)
    if engine == "seq":
        ses = SeqSession(SQ.SeqConfig(**KW))
    else:
        ses = LaneSession(L.LaneConfig(lanes=8, slots=64, accounts=128,
                                       max_fills=32), width=8)
    aud = InvariantAuditor()
    for lo in range(0, len(msgs), 256):
        part = msgs[lo:lo + 256]
        aud.observe(batch_events(ses.process_wire(part),
                                 reasons=ses.last_reasons,
                                 offsets=list(range(lo, lo + len(part)))))
    assert aud.violations == []
    assert aud.check_engine(ses.export_state(), ses.histograms()) == []
    aid = next(iter(aud.balances))
    aud.balances[aid] -= 1
    assert [v["kind"] for v in aud.check_engine(ses.export_state())] == \
        ["state_mismatch"]


PARITY_CAPS = dict(balances=16, positions=1024, books=16, buckets=256,
                   orders=2048, max_events=32, batch=256)


@pytest.mark.cuda
@pytest.mark.parametrize("compat", ["java", "fixed"])
def test_parity_replica_on_card_matches_cpu(cuda_device, compat):
    """The serial parity replica with its state on the card: the same
    records, state arrays and sync count as on the CPU, and the same
    death (a java REMOVE_SYMBOL on a non-empty book, the state frozen
    at it)."""
    from kme_tpu_torch import opcodes as op
    from kme_tpu_torch.engine import parity as P
    from kme_tpu_torch.wire import OrderMsg

    caps = P.ParityCaps(**PARITY_CAPS)
    msgs = (harness_stream(600, seed=0) if compat == "java" else
            harness_stream(600, seed=3, payout_opcode_bug=False,
                           validate=True))
    gpu = P.ParityEngine(compat, caps)
    cpu = P.ParityEngine(compat, caps, device="cpu")
    assert all(v.is_cuda for v in gpu.state.values())
    g = [[r.wire() for r in x] for x in gpu.process_batch(msgs)]
    c = [[r.wire() for r in x] for x in cpu.process_batch(msgs)]
    assert g == c
    assert gpu.syncs == cpu.syncs
    a, b = P.state_to_numpy(gpu.state), P.state_to_numpy(cpu.state)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert gpu.export_state() == cpu.export_state()
    if compat == "java":
        more = [OrderMsg(action=op.ADD_SYMBOL, sid=77),
                OrderMsg(action=op.BUY, oid=1 << 40, aid=0, sid=77,
                         price=40, size=1),
                OrderMsg(action=op.REMOVE_SYMBOL, sid=77)]
        errs = []
        for eng in (gpu, cpu):
            with pytest.raises(P.DeviceParityError) as ei:
                eng.process_batch(more)
            errs.append((ei.value.code, ei.value.index,
                         [[r.wire() for r in x] for x in ei.value.records]))
        assert errs[0] == errs[1] and errs[0][:2] == (P.ERR_HANG, 2)
        assert gpu.export_state() == cpu.export_state()


@pytest.mark.cuda
def test_parity_replica_graphs_recaptured_over_a_new_state(cuda_device):
    """Each segment of a message replays from its CUDA graph; a new state
    object gets graphs captured over its own tables. The card == the CPU
    in both modes (fixed with PAYOUTs and wipes) across such swaps."""
    from kme_tpu_torch.engine import parity as P

    caps = P.ParityCaps(**PARITY_CAPS)
    for compat, msgs in (
            ("java", harness_stream(300, seed=1)),
            ("fixed", harness_stream(400, seed=3, payout_opcode_bug=False,
                                     validate=True))):
        g = P.ParityEngine(compat, caps)
        e = P.ParityEngine(compat, caps, device="cpu")
        half = len(msgs) // 2
        for part in (msgs[:half], msgs[half:]):
            a = [[r.wire() for r in x] for x in g.process_batch(part)]
            b = [[r.wire() for r in x] for x in e.process_batch(part)]
            assert a == b
            assert g.captured > 0 and e.captured == 0
            g.state = {k: v.clone() for k, v in g.state.items()}
            assert g.captured == 0
        assert g.export_state() == e.export_state()
        assert g.syncs == e.syncs


@pytest.mark.cuda
def test_parity_bits_and_tables_on_card(cuda_device):
    """The java-exact bit ops at the int64 edge values (two's-complement
    wrap at INT64_MIN, 1 << 63, key << 8) and the tables' first-hit tie
    rule, on the card == on the CPU."""
    from kme_tpu_torch.ops import bits, tables

    edges = [0, 1, -1, 2, -2, -(1 << 63), -(1 << 63) + 1, (1 << 63) - 1,
             1 << 62, -(1 << 62), (1 << 31), -(1 << 31), (1 << 32) - 1,
             0x5555555555555555, -0x5555555555555556]
    edges += [int(t) + d for t in bits._OVERSHOOT if t > 0 for d in (-1, 0)]
    n = torch.tensor(edges, dtype=torch.int64)
    m = n.flip(0)
    k = torch.tensor([(i * 37) % 400 - 140 for i in range(len(edges))],
                     dtype=torch.int32)
    fns = [lambda a, b, p: bits.first_set_bit_pos(a),
           lambda a, b, p: bits.last_set_bit_pos(a),
           lambda a, b, p: bits.top_bit(a),
           lambda a, b, p: bits.popcount(a),
           lambda a, b, p: bits.jshl1(p),
           lambda a, b, p: bits.jget_bit(a, p),
           lambda a, b, p: bits.jset_bit(a, p),
           lambda a, b, p: bits.junset_bit(a, p),
           lambda a, b, p: bits.book_min_price(a, b),
           lambda a, b, p: bits.book_max_price(a, b),
           lambda a, b, p: bits.book_check_bit(a, b, p),
           lambda a, b, p: torch.stack(bits.book_with_bit_set(a, b, p)),
           lambda a, b, p: torch.stack(bits.book_with_bit_unset(a, b, p)),
           lambda a, b, p: bits.bucket_key(a, p)]
    for i, f in enumerate(fns):
        want = f(n, m, k)
        got = f(n.cuda(), m.cuda(), k.cuda())
        assert got.is_cuda and torch.equal(got.cpu(), want), i
    keys = torch.tensor([4, 3, 3, 3], dtype=torch.int64, device="cuda")
    used = torch.tensor([True, False, True, True], device="cuda")
    idx, found = tables.find(keys, used, keys[1])
    assert (int(idx), bool(found)) == (2, True)
    big = torch.zeros(1 << 16, dtype=torch.bool, device="cuda")
    big[::3] = True
    idx, ok = tables.alloc(big)
    assert (int(idx), bool(ok)) == (1, True)
    idx, found = tables.find(torch.full((1 << 16,), 5, dtype=torch.int64,
                                        device="cuda"), ~big,
                             torch.tensor(5, device="cuda"))
    assert (int(idx), bool(found)) == (1, True)


@pytest.mark.cuda
def test_bench_seq_suite_on_card(cuda_device, monkeypatch):
    """The benchmark's seq suite (`kme-torch-bench`, `--suite lanes
    --engine seq`) on the card at a small configuration: its in-run
    full-stream parity holds, the device time is CUDA-event time of one
    scan, the backend is the card, and the chain kernel launched once
    per scan: two for the device path, one warm, three timed; its
    counters equal a CPU run's."""
    from kme_tpu_torch import benchmarks

    monkeypatch.setenv("KME_BENCH_DEV_REPS", "1")
    kw = dict(events=3000, symbols=16, accounts=256, seed=3, slots=128,
              max_fills=16, batch=512, with_java=False)
    for k in SQ.LAUNCHES:
        SQ.LAUNCHES[k] = 0
    rec = benchmarks.bench_seq_engine(device="cuda", **kw)
    d = rec["detail"]
    assert SQ.LAUNCHES["fixed"] == 1 + 1 + 1 + 3
    assert d["backend"] == "cuda"
    assert d["device_path_method"].startswith("CUDA events")
    assert d["device_path_s"] > 0
    assert d["parity_checked_msgs"] == d["events"]
    cpu = benchmarks.bench_seq_engine(device="cpu", **kw)["detail"]
    for f in ("events", "out_records", "out_mb", "fetched_mb",
              "device_metrics"):
        assert d[f] == cpu[f], f


@pytest.mark.cuda
def test_bench_lanes_suite_on_card(cuda_device, tmp_path):
    """The sweep suite on the card: the parity prefix inside the run,
    the same steps, trades and counters as on the CPU, one launch of
    each row-copy kernel per padded step of its three sessions, and a
    torch.profiler trace with the card's kernels in it."""
    import json

    from kme_tpu_torch import benchmarks

    kw = dict(events=3000, symbols=32, accounts=128, seed=3, steps=16,
              slots=32, max_fills=16, parity_prefix=1000)
    rowdma.LAUNCHES.update({k: 0 for k in rowdma.LAUNCHES})
    rec = benchmarks.bench_lane_engine(device="cuda",
                                       profile_dir=str(tmp_path), **kw)
    d = rec["detail"]
    assert d["backend"] == "cuda"
    assert rowdma.LAUNCHES["gather_pos"] > 0
    assert rowdma.LAUNCHES["gather_pos"] == rowdma.LAUNCHES["scatter_pos"]
    cpu = benchmarks.bench_lane_engine(device="cpu", **kw)["detail"]
    for f in ("sched_steps", "trades", "out_records", "cap_rejects",
              "rejects", "parity_checked_msgs", "device_metrics"):
        assert d[f] == cpu[f], f
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("rows" in n for n in names)
