"""LaneSession: the host half of the sweep (lanes) engine.

The port of `kme_tpu/runtime/session.py`, single device. Plans a message
batch (runtime/sequencer.py), packs each scan window into COMPACT (M,)
message vectors with (t, lane) schedule coordinates, dispatches the
windows and barrier settles, then fetches the compacted outputs once
and reconstructs the byte-exact record stream in arrival order — the
IN / fills / OUT contract of the reference (KProcessor.java:97, 272-273,
124).

Nothing O(T*S) crosses between host and card: each window's inputs go
over in one copy of an (8, M) array, its per-message results come back
in one (8, M) array, and the fills as the used prefix of the persistent
fill log. Nothing in a window syncs with the card; the sticky error is
checked once per batch, in the fetch. A barrier reads its book's order
count once (engine/lanes.py `build_barrier_ops`).

On the card a window's scan steps are replays of one CUDA graph of the
step (engine/lanes.py `build_lane_step`), captured at first use over
the session's static window buffers and its state tensors, and captured
again whenever a state tensor is replaced (`load_numpy`,
`import_canonical`, or assigning `state`): the JAX package jits the
window's `lax.scan` instead. A failed capture or replay raises. On the
CPU the same step runs eagerly.

Also the port's copy of `LaneEngineError` and its name table, with the
seq kernel's codes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from kme_tpu_torch import opcodes as op
from kme_tpu_torch import wire as W
from kme_tpu_torch.engine import lanes as L
from kme_tpu_torch.ops import rowdma
from kme_tpu_torch.runtime.sequencer import Schedule, make_scheduler
from kme_tpu_torch.telemetry import Registry
from kme_tpu_torch.utils import jlong, pow2_bucket
from kme_tpu_torch.wire import OrderMsg, OutRecord, order_json

LERR_HASH_FULL = 4     # position hash exhausted (pos_cap knob)
LERR_JAVA_DOMAIN = 5   # java mode: price/size outside the device domain
LERR_JAVA_CAP = 6      # java mode: slots/max_fills device bound exceeded

_LERR_NAMES = {
    L.LERR_FILLBUF_FULL: "session fill log exhausted (fill_buffer knob)",
    LERR_HASH_FULL: "position hash exhausted (pos_cap knob)",
    LERR_JAVA_DOMAIN:
        "java mode: price/size outside the device domain (the reference "
        "runs unvalidated fields; this stream needs the native engine)",
    LERR_JAVA_CAP:
        "java mode: device capacity exceeded (reference stores are "
        "unbounded -- raise slots/max_fills or use the native engine)",
}


class LaneEngineError(RuntimeError):
    def __init__(self, code: int) -> None:
        self.code = int(code)
        super().__init__(
            f"lane engine error: {_LERR_NAMES.get(self.code, self.code)}")


def _device_reason(lane_act: int, cap: bool) -> int:
    """REJ_* code for a device not-ok result: the capacity flag wins,
    else classify by the internal lane act."""
    if cap:
        return W.REJ_CAPACITY
    if lane_act in (L.L_BUY, L.L_SELL):
        return W.REJ_RISK
    if lane_act == L.L_CANCEL:
        return W.REJ_CANCEL
    return W.REJ_OTHER


# the int64 rows of a window's packed input, in order
CB_FIELDS = ("t", "lane", "slot", "act", "oid", "aid", "price", "size")


@dataclasses.dataclass
class _WindowRun:
    """A dispatched window: its compact device outputs + bookkeeping.

    `idx` are placement ROW ids into the schedule's columnar arrays,
    sorted by (step-in-window, lane) — the order the device appends
    fills to the fill log, so host fill offsets are the running cumsum
    of nfill in row order across windows in dispatch order."""
    idx: np.ndarray           # placement rows, sorted by (step, lane)
    outs: dict                # device tensors (fetched once per batch)
    host: dict = None         # np arrays after fetch
    offs: np.ndarray = None   # (M,) absolute fill-log offsets


class LaneSession:
    """Fixed-mode engine over the sweep step, on one device.

    The state lives on `device` (default the card; `device="cpu"` runs
    the row-copy kernels' plain versions)."""

    def __init__(self, cfg: L.LaneConfig, shards: int = 1,
                 width: int = 16, device="cuda") -> None:
        """width > 0 enables active-lane compaction: the scheduler caps
        each scan step at `width` messages and the device computes
        (T, width) message slots instead of (T, S) lanes. cfg.width, if
        set, wins over the argument."""
        if shards > 1:
            raise NotImplementedError(
                "the sharded lanes engine (shards > 1) comes with the "
                "seq-fleet slice of the port")
        Wd = cfg.width if cfg.width > 0 else width
        # at most one message per lane per step can ever be scheduled, so
        # wider-than-S slots would be permanently dead padding
        Wd = max(min(Wd, cfg.lanes), 0)
        self.shards = 1
        self.cfg = cfg = dataclasses.replace(cfg, width=0, pos_dma=False)
        # compaction reserves the last device lane as the padding scrap
        # lane; positions become planar int32 rows moved by the row-copy
        # kernels whenever the row width tiles (accounts % 64 == 0)
        use_dma = Wd > 0 and (2 * cfg.accounts) % 128 == 0
        self.dev_cfg = (dataclasses.replace(cfg, lanes=cfg.lanes + 1,
                                            width=Wd, pos_dma=use_dma)
                        if Wd else cfg)
        self.device = L.resolve_device(device)
        self.state = L.make_lane_state(self.dev_cfg, self.device)
        # the step's window buffers, shared by every window
        self._io = L.make_step_io(self.dev_cfg, L.window_steps(self.dev_cfg),
                                  self.device)
        # the step graph (card only): the graph, the state addresses it
        # holds, the kernel launches it holds, and its memory pool
        self._graph = self._graph_key = self._graph_counts = None
        self._pool = None
        # CUMULATIVE graph work: captures, host seconds capturing and
        # instantiating, replays and host seconds enqueuing them
        self.graph_stats = {"captures": 0, "capture_s": 0.0,
                            "instantiate_s": 0.0, "replays": 0,
                            "replay_s": 0.0}
        self._settle = L.build_barrier_ops(self.dev_cfg)
        self._gauges = L.build_gauges(self.dev_cfg)
        self.scheduler = make_scheduler(cfg.lanes, cfg.accounts, width=Wd)
        # the metrics surface the service shares (counters, gauges and
        # histograms under the JAX package's names)
        self.telemetry = Registry()
        # CUMULATIVE wall seconds per phase across every batch
        self.phases = {"plan_s": 0.0, "dispatch_s": 0.0, "fetch_s": 0.0,
                       "recon_s": 0.0}
        # padded scan steps run (the sum of every window's T): each runs
        # one B4 gather and one B5 scatter of both position planes under
        # pos_dma
        self.steps = 0
        # per-message REJ_* reason codes for the last processed batch
        self.last_reasons = None

    def load_numpy(self, arrays: dict, aid_idx: Dict[int, int],
                   sid_lane: Dict[int, int], oid_sid: Dict[int, int],
                   rr_lane: int = 0) -> None:
        """Carry an engine across: host state arrays (e.g. `jax.tree.map(
        np.asarray, state)` of a JAX-package LaneSession of the same
        configuration) and its scheduler's maps."""
        self.state = L.state_from_numpy(self.dev_cfg, arrays, self.device)
        self._load_maps(aid_idx, sid_lane, oid_sid, rr_lane)

    def _load_maps(self, aid_idx, sid_lane, oid_sid, rr_lane) -> None:
        sch = self.scheduler
        sch.aid_idx = {int(k): int(v) for k, v in dict(aid_idx).items()}
        sch.sid_lane = {int(k): int(v) for k, v in dict(sid_lane).items()}
        sch.oid_sid = {int(k): int(v) for k, v in dict(oid_sid).items()}
        sch._rr_lane = int(rr_lane)

    def export_canonical(self) -> dict:
        """The canonical snapshot payload (user lanes, flat s64
        positions, metrics (12,), hist (3, 16)) — what the JAX package's
        `checkpoint.save_session` writes. Call between batches."""
        return L.export_canonical(self.dev_cfg, self.state, self.cfg.lanes)

    def import_canonical(self, canon: dict, aid_idx, sid_lane, oid_sid,
                         rr_lane: int = 0) -> None:
        """Restore a canonical payload — a lanes snapshot of either
        package or the seq engine's canonical form — with its maps."""
        self.state = L.import_canonical(self.dev_cfg, canon, self.cfg.lanes,
                                        self.device)
        self._load_maps(aid_idx, sid_lane, oid_sid, rr_lane)

    # ------------------------------------------------------------------

    def _pack_window(self, cols: Dict[str, np.ndarray], widx: np.ndarray,
                     t0: int, T: int, M: int) -> np.ndarray:
        """-> (8, M) int64 rows in CB_FIELDS order; t >= T marks
        padding."""
        n = len(widx)
        cb = np.zeros((len(CB_FIELDS), M), np.int64)
        cb[0] = T
        cb[0, :n] = cols["step"][widx] - t0
        for r, name in ((1, "lane"), (2, "slot"), (3, "act"), (4, "oid"),
                        (5, "aidx"), (6, "price"), (7, "size")):
            cb[r, :n] = cols[name][widx]
        return cb

    def graph_key(self) -> tuple:
        """The names and addresses of the state tensors, which a captured
        step graph holds (host-only: no device access)."""
        return tuple((k, v.data_ptr()) for k, v in self.state.items())

    def capture(self) -> None:
        """Capture the step graph for the current state tensors, unless
        the graph held is theirs. Runs at each window on the card; call it
        to capture ahead of the first window."""
        if self.device.type != "cuda":
            raise RuntimeError("the step graph is captured on the card only")
        key = self.graph_key()
        if key == self._graph_key:
            return
        self._graph = self._graph_key = None
        step = L.build_lane_step(self.dev_cfg)
        # warm up on a side stream (loads the kernels) with every slot a
        # NOP, which leaves the state as it was
        L.idle_step_io(self.dev_cfg, self._io)
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            step(self.state, self._io)
        cur.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = dict(rowdma.CAPTURED)
        t0 = time.perf_counter()
        # thread_local: the serving stack's TCP and heartbeat threads run
        # beside the capture; they issue no CUDA work, and their other
        # API calls must not invalidate it
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            step(self.state, self._io)
        t1 = time.perf_counter()
        graph.instantiate()
        t2 = time.perf_counter()
        self._graph_counts = {k: n - before[k]
                              for k, n in rowdma.CAPTURED.items()}
        self._graph, self._graph_key = graph, key
        st = self.graph_stats
        st["captures"] += 1
        st["capture_s"] += t1 - t0
        st["instantiate_s"] += t2 - t1

    def _replay(self, T: int) -> None:
        """The window's T scan steps: T replays of the step graph."""
        graph, counts = self._graph, self._graph_counts
        t = time.perf_counter()
        for _ in range(T):
            graph.replay()
            rowdma.replayed(counts)
        self.graph_stats["replays"] += T
        self.graph_stats["replay_s"] += time.perf_counter() - t

    def _run_window(self, T: int, M: int, cb: np.ndarray) -> dict:
        """One window on the device: its packed inputs over in one copy,
        the chunk function enqueued (state updated in place) — on the
        card its steps replay the step graph."""
        src = torch.from_numpy(cb)
        run = None
        if self.device.type == "cuda":
            src = src.pin_memory()
            self.capture()
            run = self._replay
        dev = src.to(self.device, non_blocking=True)
        cbt = dict(zip(CB_FIELDS, dev.unbind(0)))
        chunk = L.build_lane_chunk(self.dev_cfg, T, M)
        self.state, outs = chunk(self.state, cbt, io=self._io, run=run)
        self.steps += T
        return outs

    def _dispatch(self, sched: Schedule) -> tuple:
        """Run every dispatch window and barrier in program order. Long
        segments are split into windows of <= cfg.window scan steps.
        Returns (window runs in dispatch order, barrier ok by msg
        index)."""
        cols = sched.cols
        nseg = len(sched.segment_steps)
        # rows are appended in arrival order, so `segment` is sorted
        seg_bounds = np.searchsorted(cols["segment"], np.arange(nseg + 1))

        runs: List[_WindowRun] = []
        barrier_ok: Dict[int, bool] = {}
        Wn = self.cfg.window
        for kind, idx in sched.program:
            if kind == "scan":
                lo, hi = int(seg_bounds[idx]), int(seg_bounds[idx + 1])
                height = sched.segment_steps[idx]
                order = lo + np.lexsort((cols["lane"][lo:hi],
                                         cols["step"][lo:hi]))
                sorted_steps = cols["step"][order]
                for w in range((height + Wn - 1) // Wn):
                    a = np.searchsorted(sorted_steps, w * Wn, "left")
                    b = np.searchsorted(sorted_steps, (w + 1) * Wn, "left")
                    widx = order[a:b]
                    T = pow2_bucket(min(height - w * Wn, Wn),
                                    lo=self.cfg.steps)
                    M = pow2_bucket(max(len(widx), 1))
                    cb = self._pack_window(cols, widx, w * Wn, T, M)
                    runs.append(_WindowRun(widx, self._run_window(T, M, cb)))
            else:
                b = sched.barriers[idx]
                barrier_ok[b.msg_index] = self._settle(
                    self.state, b.lane, jlong(b.credit_size), b.mode)
        return runs, barrier_ok

    def _fetch(self, runs: List[_WindowRun]) -> np.ndarray:
        """One sync: every window's packed outputs in one device-to-host
        copy; check the sticky error; copy the used prefix of the fill
        log and rewind it. Returns the (4, F_used) fill log [oid, aid,
        price, size]."""
        if runs:
            allp = torch.cat([r.outs["packed"] for r in runs], 1).cpu().numpy()
        base, col = 0, 0
        for run in runs:
            M = run.outs["packed"].shape[1]
            p = allp[:, col:col + M]
            col += M
            err = int(p[6, 0])
            if err != L.LERR_OK:
                raise LaneEngineError(err)
            host = {
                "ok": p[0] != 0,
                "residual": p[1],
                "append": p[2] != 0,
                "prev_oid": p[3],
                "cap_reject": p[4] != 0,
                "nfill": p[5],
                "nfill_total": p[7, 0],
            }
            run.host = host
            run.offs = base + np.cumsum(host["nfill"]) - host["nfill"]
            base += int(host["nfill_total"])
            run.outs = None
        if base:
            fills = self.state["fillbuf"][:, :base].cpu().numpy()
        else:
            fills = np.zeros((4, 0), np.int64)
        self.state = L.build_fill_reset(self.dev_cfg)(self.state)
        return fills

    def _run(self, msgs):
        t0 = time.perf_counter()
        sched = self.scheduler.plan(msgs)
        t1 = time.perf_counter()
        runs, barrier_ok = self._dispatch(sched)
        t2 = time.perf_counter()
        fills = self._fetch(runs)
        t3 = time.perf_counter()
        self.phases["plan_s"] += t1 - t0
        self.phases["dispatch_s"] += t2 - t1
        self.phases["fetch_s"] += t3 - t2
        return sched, runs, barrier_ok, fills

    # ------------------------------------------------------------------

    def process(self, msgs: Sequence[OrderMsg]) -> List[List[OutRecord]]:
        sched, runs, barrier_ok, fills = self._run(msgs)
        t = time.perf_counter()
        out = self._reconstruct(msgs, sched, runs, barrier_ok, fills)
        self.phases["recon_s"] += time.perf_counter() - t
        return out

    def process_wire(self, msgs: Sequence[OrderMsg]) -> List[List[str]]:
        """Like process(), but returns the byte-exact `<key> <json>` wire
        lines directly — the serving path."""
        sched, runs, barrier_ok, fills = self._run(msgs)
        t = time.perf_counter()
        out = self._reconstruct_wire(msgs, sched, runs, barrier_ok, fills)
        self.phases["recon_s"] += time.perf_counter() - t
        return out

    def _reconstruct_wire(self, msgs, sched, runs, barrier_ok, fills):
        idx_to_aid = self.scheduler.acct_of_idx()
        lane_to_sid = self.scheduler.sid_of_lane()
        cols = sched.cols
        nmsg = len(msgs)
        # per-message scalar state, extracted in BULK (tolist())
        ok_of = [False] * nmsg
        nfill_of = [0] * nmsg
        off_of = [0] * nmsg
        resid_of = [0] * nmsg
        prev_of = [0] * nmsg
        append_of = [False] * nmsg
        act_of = [0] * nmsg
        lane_of = [0] * nmsg
        cap_of = [False] * nmsg
        for run in runs:
            n = len(run.idx)
            h = run.host
            mis = cols["msg_index"][run.idx].tolist()
            for name, dst in (("ok", ok_of), ("nfill", nfill_of),
                              ("residual", resid_of), ("prev_oid", prev_of),
                              ("append", append_of),
                              ("cap_reject", cap_of)):
                vals = h[name][:n].tolist()
                for k, mi in enumerate(mis):
                    dst[mi] = vals[k]
            offs = run.offs[:n].tolist()
            acts = cols["act"][run.idx].tolist()
            lanes_l = cols["lane"][run.idx].tolist()
            for k, mi in enumerate(mis):
                off_of[mi] = offs[k]
                act_of[mi] = acts[k]
                lane_of[mi] = lanes_l[k]
        f_oid, f_aid, f_price, f_size = (fills[c].tolist() for c in range(4))
        rejects = {r.msg_index for r in sched.host_rejects}
        barriers = {b.msg_index for b in sched.barriers}

        reasons = np.zeros(nmsg, np.uint8)
        out: List[List[str]] = []
        for i, m in enumerate(msgs):
            in_body = order_json(m.action, m.oid, m.aid, m.sid, m.price,
                                 m.size, m.next, m.prev)
            lines = [f'IN {in_body}']
            if i in rejects or (i in barriers and not barrier_ok[i]):
                reasons[i] = (W.REJ_UNROUTABLE if i in rejects
                              else W.REJ_BARRIER)
                lines.append('OUT ' + order_json(
                    op.REJECT, m.oid, m.aid, m.sid, m.price, m.size,
                    m.next, m.prev))
            elif i in barriers:
                lines.append(f'OUT {in_body}')
            else:
                lane_act = act_of[i]
                ok = ok_of[i]
                if lane_act in (L.L_BUY, L.L_SELL) and ok:
                    sid = lane_to_sid[lane_of[i]]
                    is_buy = lane_act == L.L_BUY
                    mk_act = op.SOLD if is_buy else op.BOUGHT
                    tk_act = op.BOUGHT if is_buy else op.SOLD
                    o0 = off_of[i]
                    for e in range(nfill_of[i]):
                        fsz = f_size[o0 + e]
                        lines.append('OUT ' + order_json(
                            mk_act, f_oid[o0 + e], idx_to_aid[f_aid[o0 + e]],
                            sid, 0, fsz))
                        lines.append('OUT ' + order_json(
                            tk_act, m.oid, m.aid, sid,
                            m.price - f_price[o0 + e], fsz))
                    lines.append('OUT ' + order_json(
                        m.action, m.oid, m.aid, m.sid, m.price,
                        resid_of[i], m.next,
                        prev_of[i] if append_of[i] else m.prev))
                else:
                    if not ok:
                        reasons[i] = _device_reason(lane_act, cap_of[i])
                    lines.append('OUT ' + order_json(
                        m.action if ok else op.REJECT, m.oid, m.aid,
                        m.sid, m.price, m.size, m.next, m.prev))
            out.append(lines)
        self.last_reasons = reasons
        return out

    def _reconstruct(self, msgs, sched, runs, barrier_ok, fills):
        idx_to_aid = self.scheduler.acct_of_idx()
        lane_to_sid = self.scheduler.sid_of_lane()
        # run + m-position of each device message within its window run
        cols = sched.cols
        run_of_msg = np.full(len(msgs), -1, np.int64)
        m_of_msg = np.zeros(len(msgs), np.int64)
        for ri, run in enumerate(runs):
            mi = cols["msg_index"][run.idx]
            run_of_msg[mi] = ri
            m_of_msg[mi] = np.arange(len(run.idx))
        rejects = {r.msg_index for r in sched.host_rejects}
        barriers = {b.msg_index for b in sched.barriers}

        reasons = np.zeros(len(msgs), np.uint8)
        out: List[List[OutRecord]] = []
        for i, m in enumerate(msgs):
            recs = [OutRecord("IN", m.copy())]
            echo = m.copy()
            if i in rejects:
                reasons[i] = W.REJ_UNROUTABLE
                echo.action = op.REJECT
            elif i in barriers:
                if not barrier_ok[i]:
                    reasons[i] = W.REJ_BARRIER
                    echo.action = op.REJECT
            else:
                run = runs[run_of_msg[i]]
                mm = int(m_of_msg[i])
                h = run.host
                row = run.idx[mm]
                lane_act = int(cols["act"][row])
                ok = bool(h["ok"][mm])
                is_trade = lane_act in (L.L_BUY, L.L_SELL)
                if is_trade and ok:
                    sid = lane_to_sid[int(cols["lane"][row])]
                    is_buy = lane_act == L.L_BUY
                    o0 = int(run.offs[mm])
                    for e in range(int(h["nfill"][mm])):
                        fsz = int(fills[3, o0 + e])
                        recs.append(OutRecord("OUT", OrderMsg(
                            action=op.SOLD if is_buy else op.BOUGHT,
                            oid=int(fills[0, o0 + e]),
                            aid=idx_to_aid[int(fills[1, o0 + e])], sid=sid,
                            price=0, size=fsz)))
                        recs.append(OutRecord("OUT", OrderMsg(
                            action=op.BOUGHT if is_buy else op.SOLD,
                            oid=m.oid, aid=m.aid, sid=sid,
                            price=m.price - int(fills[2, o0 + e]),
                            size=fsz)))
                    echo.size = int(h["residual"][mm])
                    if bool(h["append"][mm]):
                        echo.prev = int(h["prev_oid"][mm])
                elif not ok:
                    reasons[i] = _device_reason(
                        lane_act, bool(h["cap_reject"][mm]))
                    echo.action = op.REJECT
            recs.append(OutRecord("OUT", echo))
            out.append(recs)
        self.last_reasons = reasons
        return out

    # ------------------------------------------------------------------

    def metrics(self) -> Dict[str, int]:
        """Cumulative device counters + point-in-time gauges, read back
        in one device-to-host copy."""
        g = self._gauges(self.state)
        vals = torch.cat([self.state["metrics"],
                          torch.stack([v.to(torch.int64)
                                       for v in g.values()])]).tolist()
        out = dict(zip(L.METRIC_NAMES, vals[:L.N_METRICS]))
        out.update(zip(g, vals[L.N_METRICS:]))
        self.telemetry.publish_counters(
            {k: out[k] for k in L.METRIC_NAMES})
        self.telemetry.publish_gauges(
            {k: v for k, v in out.items() if k not in L.METRIC_NAMES})
        return out

    def histograms(self) -> Dict[str, list]:
        """In-kernel distribution histograms (power-of-two buckets),
        read back in one copy; published into the registry."""
        rows = self.state["hist"].cpu().numpy()
        out = {name: rows[i].tolist() for i, name in enumerate(L.HIST_NAMES)}
        self.telemetry.publish_histograms(out)
        return out

    def export_state(self) -> Dict[str, dict]:
        """Host dict view comparable to the oracle's stores (fixed
        mode), from the canonical export."""
        canon = self.export_canonical()
        idx_to_aid = self.scheduler.acct_of_idx()
        lane_to_sid = self.scheduler.sid_of_lane()
        S, A = self.cfg.lanes, self.cfg.accounts
        balances = {idx_to_aid[i]: int(canon["bal"][i])
                    for i in range(len(idx_to_aid)) if canon["bal_used"][i]}
        amt = canon["pos_amt"].reshape(S, A)
        avail = canon["pos_avail"].reshape(S, A)
        positions = {}
        # a position exists iff amt != 0 (no-used-flag invariant)
        for lane, a in zip(*np.nonzero(amt != 0)):
            sid = lane_to_sid.get(int(lane))
            if sid is not None and a < len(idx_to_aid):
                positions[(idx_to_aid[a], sid)] = (int(amt[lane, a]),
                                                   int(avail[lane, a]))
        orders = {}
        for lane, side, n in zip(*np.nonzero(canon["slot_used"])):
            sid = lane_to_sid.get(int(lane))
            if sid is None:
                continue
            orders[int(canon["slot_oid"][lane, side, n])] = {
                "aid": idx_to_aid[int(canon["slot_aid"][lane, side, n])],
                "sid": sid,
                "price": int(canon["slot_price"][lane, side, n]),
                "size": int(canon["slot_size"][lane, side, n]),
                "is_buy": bool(side == 0),
            }
        books = {sid: True for sid, lane in self.scheduler.sid_lane.items()
                 if canon["book_exists"][lane]}
        return {"balances": balances, "positions": positions,
                "orders": orders, "books": books}
