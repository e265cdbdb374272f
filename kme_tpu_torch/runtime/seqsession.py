"""SeqSession: host half of the sequential matching kernel engine.

The port of `kme_tpu/runtime/seqsession.py`, fixed and java modes
(`SeqConfig.compat`), at any book depth. There is NO
conflict-free scheduler: the kernel processes messages strictly
sequentially (engine/seq.py), so planning reduces to ID ROUTING — dense
aid/sid maps, oid -> lane routing for cancels, and host-resolved rejects
for messages the device cannot act on (unknown-oid cancels,
negative-sid ADD_SYMBOL, unmapped payout/remove). Barriers (PAYOUT /
REMOVE_SYMBOL) are ordinary device messages (act codes 7/8/9). Java mode
adds the raw Java-long aid/sid columns and the Q1 merged-book flag, and
refuses what lies outside its device surface (`UnsupportedJavaOp`).

The host path is native (native/kme_*.cpp): in fixed mode the C++ router
routes, and a `WireBatch` is routed and packed in one call
(`kme_plan_batch`); in both modes `process_wire_buffer` builds the
MatchOut bytes in one call (`kme_recon_batch`). `KME_NATIVE=0` selects the
Python router and line builder, which stay the semantics authority.

One dispatch per batch: all K chunks go to the card in one kernel launch
(`seq_scan`). On the card the message planes go through a ring of pinned
host buffers and a copy stream; right behind the kernel, the headers plus
an adaptive fill prefix are copied back into pinned memory and an event
is recorded. `submit` returns after that, so the card runs batch N while
the host plans batch N+1 and reconstructs batch N-1 (`collect`, which
waits on batch N's event alone).
"""

from __future__ import annotations

import ctypes
import dataclasses
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from kme_tpu_torch import opcodes as op
from kme_tpu_torch.engine import seq as SQ
from kme_tpu_torch.engine.lanes import MET_BARRIERS
from kme_tpu_torch.native import load_library
from kme_tpu_torch.native.sched import (_arr, export_map, import_map,
                                        plan_batch, recon_batch)
from kme_tpu_torch.runtime.sequencer import CapacityError, EnvelopeError
from kme_tpu_torch.runtime.session import LaneEngineError
from kme_tpu_torch.telemetry import PhaseTimer, Registry
# the overlap of SeqSession.windows (one copy, in the journal module)
from kme_tpu_torch.telemetry.journal import measured_overlap_s  # noqa: F401
from kme_tpu_torch.utils import jlong, pow2_bucket
from kme_tpu_torch.wire import (OrderMsg, OutRecord, WireBatch, order_json,
                                reject_reason_codes)

_TRADE_ACTS = {op.BUY: SQ.L_BUY, op.SELL: SQ.L_SELL}
# the device plane counts the bytes of every 16th one-chunk dispatch: a
# probe clones the state twice, so probing each dispatch would slow the
# path it measures
_PROBE_EVERY = 16


class UnsupportedJavaOp(RuntimeError):
    """The java-compat DEVICE surface excludes barriers and negative-sid
    symbols (dead or broken reference paths — Q3-Q6 and the ±sid book
    cross-coupling); streams containing them belong on the native/oracle
    engines (COMPAT.md)."""


class SeqRouter:
    """Arrival-order ID routing (no conflict analysis). Mirrors the
    sequencer's id spaces and host-reject edge semantics. compat='java'
    additionally emits the raw Java-long aid/sid columns and the Q1
    merged-book flag the kernel needs, and REFUSES the opcodes outside
    the java device surface."""

    def __init__(self, num_lanes: int, num_accounts: int,
                 compat: str = "fixed") -> None:
        self.S = num_lanes
        self.A = num_accounts
        self.compat = compat
        self.aid_idx: Dict[int, int] = {}
        self.sid_lane: Dict[int, int] = {}
        self.oid_sid: Dict[int, int] = {}

    def _acct(self, aid: int) -> int:
        idx = self.aid_idx.get(aid)
        if idx is None:
            if len(self.aid_idx) >= self.A:
                raise CapacityError(
                    f"account capacity {self.A} exhausted (aid={aid})")
            idx = len(self.aid_idx)
            self.aid_idx[aid] = idx
        return idx

    def _lane(self, sid: int) -> int:
        lane = self.sid_lane.get(sid)
        if lane is None:
            if len(self.sid_lane) >= self.S:
                raise CapacityError(
                    f"symbol capacity {self.S} exhausted (sid={sid})")
            lane = len(self.sid_lane)
            self.sid_lane[sid] = lane
        return lane

    def acct_of_idx(self) -> List[int]:
        out = [0] * len(self.aid_idx)
        for aid, idx in self.aid_idx.items():
            out[idx] = aid
        return out

    def sid_of_lane(self) -> Dict[int, int]:
        return {lane: sid for sid, lane in self.sid_lane.items()}

    def route(self, msgs):
        """-> (cols dict incl. msg_index, host_reject msg indices)."""
        if isinstance(msgs, WireBatch):
            msgs = msgs.msgs()
        java = self.compat == "java"
        cols = {k: [] for k in ("msg_index", "act", "aid", "price",
                                "size", "lane", "oid", "aid_raw",
                                "sid_raw", "flags")}
        host_rejects = set()

        def emit(i, act, aidx, lane, m, oid, aid=0, sid=0):
            cols["msg_index"].append(i)
            cols["act"].append(act)
            cols["aid"].append(aidx)
            cols["price"].append(m.price)
            cols["size"].append(m.size)
            cols["lane"].append(lane)
            cols["oid"].append(oid)
            if java:
                cols["aid_raw"].append(aid)
                cols["sid_raw"].append(sid)
                cols["flags"].append(1 if sid == 0 else 0)

        # envelope-check the WHOLE batch up front so an EnvelopeError
        # leaves the id maps untouched
        for i, m in enumerate(msgs):
            if not (-2**31 <= m.price < 2**31 and -2**31 <= m.size < 2**31):
                raise EnvelopeError(
                    f"message {i}: price/size outside int32 "
                    f"(price={m.price}, size={m.size})")
        for i, m in enumerate(msgs):
            a = m.action
            aid, sid, oid = jlong(m.aid), jlong(m.sid), jlong(m.oid)
            if a in _TRADE_ACTS:
                if java and sid < 0:
                    raise UnsupportedJavaOp(
                        f"message {i}: negative-sid trade (sid={sid}) — "
                        f"java ±sid book coupling is outside the device "
                        f"surface; use the native engine")
                # mutation order (lane, oid_sid, acct) is the authority
                # contract of the JAX package's routers
                lane = self._lane(sid)
                self.oid_sid[oid] = sid
                emit(i, _TRADE_ACTS[a], self._acct(aid), lane, m, oid,
                     aid, sid)
            elif a == op.CANCEL:
                rsid = self.oid_sid.get(oid)
                if rsid is None:
                    host_rejects.add(i)
                    continue
                emit(i, SQ.L_CANCEL, self._acct(aid), self._lane(rsid),
                     m, oid, aid, rsid)
            elif a == op.CREATE_BALANCE:
                emit(i, SQ.L_CREATE, self._acct(aid), 0, m, oid, aid, 0)
            elif a == op.TRANSFER:
                emit(i, SQ.L_TRANSFER, self._acct(aid), 0, m, oid, aid, 0)
            elif a == op.ADD_SYMBOL:
                if java and sid < 0:
                    raise UnsupportedJavaOp(
                        f"message {i}: negative-sid ADD_SYMBOL "
                        f"(sid={sid}) — outside the java device surface")
                if sid < 0:
                    host_rejects.add(i)
                    continue
                emit(i, SQ.L_ADD_SYMBOL, 0, self._lane(sid), m, oid,
                     aid, sid)
            elif a in (op.REMOVE_SYMBOL, op.PAYOUT):
                if java:
                    raise UnsupportedJavaOp(
                        f"message {i}: "
                        f"{'REMOVE_SYMBOL' if a == op.REMOVE_SYMBOL else 'PAYOUT'}"
                        f" in java mode — Q3-Q6 barrier paths are outside "
                        f"the device surface; use the native engine")
                s = abs(sid)
                if s not in self.sid_lane:
                    host_rejects.add(i)
                    continue
                lane = self.sid_lane[s]
                if a == op.REMOVE_SYMBOL:
                    act = SQ.L_REMOVE_SYMBOL
                else:
                    act = SQ.L_PAYOUT_YES if sid >= 0 else SQ.L_PAYOUT_NO
                emit(i, act, 0, lane, m, oid)
                dead = [o for o, s2 in self.oid_sid.items() if s2 == s]
                for o in dead:
                    del self.oid_sid[o]
            else:
                host_rejects.add(i)
        out = {
            "msg_index": np.array(cols["msg_index"], np.int64),
            "act": np.array(cols["act"], np.int32),
            "aid": np.array(cols["aid"], np.int32),
            "price": np.array(cols["price"], np.int32),
            "size": np.array(cols["size"], np.int32),
            "lane": np.array(cols["lane"], np.int32),
            "oid": np.array(cols["oid"], np.int64),
        }
        if java:
            out["aid_raw"] = np.array(cols["aid_raw"], np.int64)
            out["sid_raw"] = np.array(cols["sid_raw"], np.int64)
            out["flags"] = np.array(cols["flags"], np.int32)
        return out, host_rejects


class NativeSeqRouter:
    """C++ twin of SeqRouter (native/kme_router.cpp): identical routing
    over columnar int64 arrays, fixed mode. The id maps live in C++; the
    dict properties export/import them for `load_numpy` and snapshots. A
    CALL whose fields overflow int64 routes through a temporary Python
    router (maps synced both ways); subsequent calls are native again."""

    def __init__(self, num_lanes: int, num_accounts: int, lib) -> None:
        self.S = num_lanes
        self.A = num_accounts
        self._lib = lib
        self._h = lib.kme_router_new(num_lanes, num_accounts)
        self._fin = weakref.finalize(self, lib.kme_router_free, self._h)
        # bumped on every wholesale map import (every setter below):
        # SeqSession's recon-LUT cache keys on (map sizes, epoch), and
        # sizes alone can collide across an import
        self._map_epoch = 0

    # -- map views (load_numpy and snapshots read and write these) -------
    def _import(self, ifn, d, vdt):
        self._map_epoch += 1
        import_map(self._h, ifn, d, vdt)

    @property
    def aid_idx(self):
        lib = self._lib
        return export_map(self._h, lib.kme_router_n_accounts,
                          lib.kme_router_export_accounts, np.int32)

    @aid_idx.setter
    def aid_idx(self, d):
        self._import(self._lib.kme_router_import_accounts, d, np.int32)

    @property
    def sid_lane(self):
        lib = self._lib
        return export_map(self._h, lib.kme_router_n_symbols,
                          lib.kme_router_export_symbols, np.int32)

    @sid_lane.setter
    def sid_lane(self, d):
        self._import(self._lib.kme_router_import_symbols, d, np.int32)

    @property
    def oid_sid(self):
        lib = self._lib
        return export_map(self._h, lib.kme_router_n_routes,
                          lib.kme_router_export_routes, np.int64)

    @oid_sid.setter
    def oid_sid(self, d):
        self._import(self._lib.kme_router_import_routes, d, np.int64)

    def acct_of_idx(self) -> List[int]:
        m = self.aid_idx
        out = [0] * len(m)
        for aid, idx in m.items():
            out[idx] = aid
        return out

    def sid_of_lane(self) -> Dict[int, int]:
        return {lane: sid for sid, lane in self.sid_lane.items()}

    def route(self, msgs):
        n = len(msgs)
        try:
            if isinstance(msgs, WireBatch):
                # columnar fast path: zero per-message Python work
                raw = {f: np.ascontiguousarray(getattr(msgs, f), np.int64)
                       for f in ("action", "oid", "aid", "sid",
                                 "price", "size")}
            else:
                raw = {f: np.fromiter((getattr(m, f) for m in msgs),
                                      np.int64, n)
                       for f in ("action", "oid", "aid", "sid", "price",
                                 "size")}
        except OverflowError:
            # a field beyond int64: the columnar path cannot carry it
            py = SeqRouter(self.S, self.A)
            py.aid_idx = self.aid_idx
            py.sid_lane = self.sid_lane
            py.oid_sid = self.oid_sid
            cols, rejects = py.route(msgs)
            self.aid_idx = py.aid_idx
            self.sid_lane = py.sid_lane
            self.oid_sid = py.oid_sid
            return cols, rejects
        bad = ((raw["price"] < -(2**31)) | (raw["price"] >= 2**31)
               | (raw["size"] < -(2**31)) | (raw["size"] >= 2**31))
        if bad.any():
            i = int(np.argmax(bad))
            raise EnvelopeError(
                f"message {i}: price/size outside int32 "
                f"(price={int(raw['price'][i])}, "
                f"size={int(raw['size'][i])})")
        lib = self._lib
        P64 = ctypes.POINTER(ctypes.c_int64)
        rc = lib.kme_router_route(
            self._h, n, *(raw[f].ctypes.data_as(P64)
                          for f in ("action", "oid", "aid", "sid",
                                    "price", "size")))
        if rc != 0:
            raise CapacityError(
                f"{'account' if rc == 1 else 'symbol'} capacity "
                f"exhausted (id={lib.kme_router_err_value(self._h)})")
        nr = lib.kme_router_n_routed(self._h)
        nj = lib.kme_router_n_rejects(self._h)

        def arr(fn, dt, cnt):
            return _arr(fn(self._h), cnt, dt)

        cols = {
            "msg_index": arr(lib.kme_router_o_msg, np.int64, nr),
            "act": arr(lib.kme_router_o_act, np.int32, nr),
            "aid": arr(lib.kme_router_o_aidx, np.int32, nr),
            "price": arr(lib.kme_router_o_price, np.int32, nr),
            "size": arr(lib.kme_router_o_size, np.int32, nr),
            "lane": arr(lib.kme_router_o_lane, np.int32, nr),
            "oid": arr(lib.kme_router_o_oid, np.int64, nr),
        }
        rejects = set(arr(lib.kme_router_o_rej, np.int64, nj).tolist())
        return cols, rejects


def make_seq_router(num_lanes: int, num_accounts: int,
                    compat: str = "fixed"):
    """The native router in fixed mode (identical routing); the Python
    router in java mode (it carries the raw-id and flag columns) and
    under KME_NATIVE=0. A host runtime that fails to build raises."""
    if compat == "java":
        return SeqRouter(num_lanes, num_accounts, compat="java")
    lib = load_library()
    if lib is not None:
        return NativeSeqRouter(num_lanes, num_accounts, lib)
    return SeqRouter(num_lanes, num_accounts)


class _Staging:
    """The card's side of the host path: a ring of pinned host buffers
    for the message planes, a copy stream for their H2D copies, and a
    side stream for the rare second-round output copies."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.copy = torch.cuda.Stream(device)
        self.side = torch.cuda.Stream(device)
        # [pinned int32 buffer, event of the last copy out of it]
        self.ring: List[list] = []
        self.turn = 0

    def stage(self, planes: List[np.ndarray], inflight: int
              ) -> List[torch.Tensor]:
        """Copy the (K, B) int32 planes into a ring slot and from there
        to the card on the copy stream; the current (compute) stream
        waits for that copy. -> the planes on the card."""
        # pipeline depth + 1 slots: one per batch in flight and this one
        while len(self.ring) < inflight + 2:
            self.ring.append([None, None])
        slot = self.ring[self.turn % len(self.ring)]
        self.turn += 1
        if slot[1] is not None:
            # the slot's last copy has long been issued; a slot is
            # written again only after it has completed
            slot[1].synchronize()
        K, B = planes[0].shape
        n = len(planes) * K * B
        if slot[0] is None or slot[0].numel() < n:
            slot[0] = torch.empty(n, dtype=torch.int32, pin_memory=True)
        host = slot[0][:n].view(len(planes), K, B)
        hv = host.numpy()
        for j, plane in enumerate(planes):
            hv[j] = plane
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.copy):
            # allocated on the copy stream, read on the compute stream:
            # record_stream keeps the allocator from handing the block out
            # again before the kernels queued there have read it
            dev = torch.empty((len(planes), K, B), dtype=torch.int32,
                              device=self.device)
            dev.copy_(host, non_blocking=True)
            slot[1] = torch.cuda.Event()
            slot[1].record(self.copy)
        dev.record_stream(compute)
        compute.wait_event(slot[1])
        return list(dev.unbind(0))


@dataclasses.dataclass
class _Pending:
    """One dispatched batch, from submit (or `_run`) to its fetch."""
    seq: int                # submit order (-1 for the serial path)
    msgs: object            # what was planned (a WireBatch from submit)
    cols: dict
    host_rejects: set
    outp: torch.Tensor      # (K, out_rows, 128) on the session's device
    cnts: list
    K: int
    ghint: int              # fill groups per call in the first fetch
    head: torch.Tensor      # the headers + hint prefix (pinned on the card)
    done: Optional[object]  # event behind the early copy (card only)
    stage_s: float
    # device plane: the kernel's (start, end) events, and for a probed
    # dispatch (host columns, state before, state after)
    ev: Optional[tuple] = None
    probe: Optional[tuple] = None


class SeqSession:
    """Engine over the sequential matching kernel, in the config's compat
    mode.

    Same public surface as the JAX package's SeqSession (process /
    process_wire / process_wire_buffer / submit / collect / metrics /
    histograms / export_state). The state lives on `device` (default the
    card; `device="cpu"` runs the kernel's plain PyTorch version, and
    there `submit` runs the batch before it returns)."""

    def __init__(self, cfg: SQ.SeqConfig, device="cuda") -> None:
        self.cfg = cfg
        self.device = SQ.resolve_device(device)
        self.state = SQ.make_seq_state(cfg, self.device)
        self.router = make_seq_router(cfg.lanes, cfg.accounts, cfg.compat)
        self._metrics = np.zeros(SQ.N_METRICS, np.int64)
        self._hist = np.zeros((SQ.N_HIST, SQ.N_HIST_BUCKETS), np.int64)
        # the metrics surface the service shares (counters, gauges and
        # histograms under the JAX package's names)
        self.telemetry = Registry()
        self.timer = PhaseTimer(track="seq")
        # CUMULATIVE wall seconds per phase across every batch (the
        # timer's totals dict IS this attribute)
        self.phases = self.timer.totals
        self.phases.update({"plan_s": 0.0, "stage_s": 0.0, "dispatch_s": 0.0,
                            "fetch_s": 0.0, "recon_s": 0.0})
        self.dispatches = 0
        # second-round fetches of calls whose fills overflowed the hint
        self.overflow_fetches = 0
        # adaptive fill-slice hint (fill groups per call fetched in the
        # first fetch; grows to the observed high-water mark)
        self._ghint = 8
        # per-message REJ_* reason codes for the last processed batch
        self.last_reasons = None
        self._use_native_wire = True
        self._recon = None          # native reconstructor handle
        self._staging = (_Staging(self.device)
                         if self.device.type == "cuda" else None)
        # ("submit"|"collect", pipeline-batch-idx, t0, t1) wall windows
        # of the pipelined path, for measured-overlap reporting
        self.windows: List[tuple] = []
        self._n_submit = 0
        self._n_collect = 0
        # H2D overlap accounting: staging time spent while an earlier
        # submit was still uncollected counts as overlapped
        self._h2d_total_s = 0.0
        self._h2d_overlap_s = 0.0
        # device plane (telemetry/profiler.py), off until asked for:
        # CUDA-event time of every dispatch's kernels, and the bytes of
        # every `_PROBE_EVERY`-th one-chunk dispatch
        self._timing = False
        self._kernel_ms = 0.0
        self._timed = 0
        self._probe_bytes = 0
        self._probed = 0

    def enable_device_plane(self) -> None:
        """Time each dispatch's kernels with CUDA events and count the
        bytes (`SQ.dispatch_bytes`) of every `_PROBE_EVERY`-th dispatch
        of one chunk. A probe copies the state before and after its
        dispatch and reads both back at fetch time. Card sessions only:
        on the CPU there is no kernel to time."""
        if self._staging is None:
            raise ValueError("the device plane times kernels on the card; "
                             f"this session runs on {self.device}")
        self._timing = True

    def device_timing(self) -> Optional[dict]:
        """The device plane's kernel fields, or None when not enabled:
        mean CUDA-event ms per dispatch and mean bytes per probed
        dispatch."""
        if not self._timing:
            return None
        kern = "seq_scan_kernel<%s>" % (
            "true" if self.cfg.compat == "java" else "false")
        out = {"kernel": kern, "dispatches_timed": self._timed,
               "kernel_ms_per_dispatch": (
                   round(self._kernel_ms / self._timed, 6)
                   if self._timed else None),
               "dispatches_probed": self._probed}
        if self._probed:
            out["bytes_per_batch"] = self._probe_bytes // self._probed
        return out

    def load_numpy(self, arrays: dict, aid_idx: Dict[int, int],
                   sid_lane: Dict[int, int], oid_sid: Dict[int, int]) -> None:
        """Carry an engine across: host state planes (e.g. `np.asarray`
        of a JAX-package session's `state[k]`, either mode's planes) and
        its router maps."""
        self.state = SQ.state_from_numpy(self.cfg, arrays, self.device)
        self.router.aid_idx = dict(aid_idx)
        self.router.sid_lane = dict(sid_lane)
        self.router.oid_sid = dict(oid_sid)

    # ------------------------------------------------------------------

    def _plan(self, msgs):
        """Route + pack: columnar router output -> the stacked (K, B)
        int32 input planes of one dispatch. Returns (cols, host_rejects,
        stacked, cnts, K). A WireBatch through the native router takes
        one native call (kme_plan_batch); the numpy pack below is its
        byte-exact twin and java mode's path."""
        if (isinstance(msgs, WireBatch)
                and isinstance(self.router, NativeSeqRouter)):
            return plan_batch(self.router, msgs, self.cfg.batch)
        cols, host_rejects = self.router.route(msgs)
        n = len(cols["act"])
        B = self.cfg.batch
        K = pow2_bucket(max(-(-n // B), 1), lo=1)
        total = K * B

        # zero padding is L_NOP by construction
        def pad32(src):
            a = np.zeros(total, np.int32)
            a[:n] = src[:n]
            return a.reshape(K, B)

        stacked = {f: pad32(cols[f])
                   for f in ("act", "aid", "price", "size", "lane")}
        v = np.zeros(total, np.int64)
        v[:n] = cols["oid"][:n]
        lo, hi = SQ._split64(v)
        stacked["oid_lo"], stacked["oid_hi"] = lo.reshape(K, B), hi.reshape(K, B)
        if self.cfg.compat == "java":
            for name, src in (("aidr", "aid_raw"), ("sidr", "sid_raw")):
                v = np.zeros(total, np.int64)
                v[:n] = cols[src][:n]
                lo, hi = SQ._split64(v)
                stacked[f"{name}_lo"] = lo.reshape(K, B)
                stacked[f"{name}_hi"] = hi.reshape(K, B)
            stacked["flags"] = pad32(cols["flags"])
        cnts = [max(min(B, n - ci * B), 0) for ci in range(K)]
        return cols, host_rejects, stacked, cnts, K

    def _hint(self) -> int:
        """Fill groups per call that the first fetch copies."""
        return min(pow2_bucket(self._ghint, lo=1), self.cfg.fill_cap // 128)

    def _dispatch(self, msgs, seq: int = -1) -> _Pending:
        """Plan, stage, launch (ONE kernel launch over all chunks) and,
        on the card, enqueue the early copy of the headers plus the
        hint's fill prefix into pinned memory behind an event. Nothing
        here waits for the card."""
        with self.timer.phase("plan_s"):
            cols, host_rejects, stacked, cnts, K = self._plan(msgs)
        fields = SQ.msg_fields(self.cfg)
        t = time.perf_counter()
        with self.timer.phase("stage_s"):
            if self._staging is None:
                dev = {f: torch.from_numpy(np.ascontiguousarray(stacked[f]))
                       for f in fields}
            else:
                dev = dict(zip(fields, self._staging.stage(
                    [stacked[f] for f in fields],
                    self._n_submit - self._n_collect)))
        stage_s = time.perf_counter() - t
        with self.timer.phase("dispatch_s"):
            ev = probe = None
            if self._timing:
                if K == 1 and self.dispatches % _PROBE_EVERY == 0:
                    # host columns copied: the planner's buffers are
                    # reused by the next batch
                    probe = ({f: np.array(stacked[f][0]) for f in fields},
                             {k: v.clone() for k, v in self.state.items()})
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            outp = SQ.seq_scan(self.cfg, self.state, dev)
            if ev is not None:
                ev[1].record()
            if probe is not None:
                probe += ({k: v.clone() for k, v in self.state.items()},)
            self.dispatches += 1
            ghint = self._hint()
            rows = SQ.hdr_rows(self.cfg) + 5 * ghint
            done = None
            if self._staging is None:
                head = outp[:, :rows]
            else:
                # on the compute stream right behind the kernel, so that
                # the event waits for this batch's kernel alone and not
                # for the batches submitted after it
                head = torch.empty((K, rows, SQ.LN), dtype=torch.int32,
                                   pin_memory=True)
                head.copy_(outp[:, :rows], non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
        # the rows-in-use scratch that seq_scan allocated is freed to the
        # compute stream's pool: only work queued behind this kernel can
        # reuse it, so the handle need not hold it; `outp` it must hold
        return _Pending(seq, msgs, cols, host_rejects, outp, cnts, K,
                        ghint, head, done, stage_s, ev, probe)

    def _fetch(self, p: _Pending):
        """Wait for the batch's early copy, unpack its headers, and fetch
        the fill rows of calls that overflowed the hint in a second,
        rare round (on the card: on the side stream, behind this batch's
        event, so it never queues behind a later kernel).
        -> (host dict, fills (4, F))."""
        HR = SQ.hdr_rows(self.cfg)
        if p.done is not None:
            p.done.synchronize()
        if p.ev is not None:
            self._kernel_ms += p.ev[0].elapsed_time(p.ev[1])
            self._timed += 1
        if p.probe is not None:
            self._count_bytes(p)
        fetched = p.head.numpy()
        results = []
        for ci in range(p.K):
            res = SQ.unpack_hdr(self.cfg, fetched[ci][:HR], p.cnts[ci])
            if res["err"] != SQ.LERR_OK:
                raise LaneEngineError(res["err"])
            results.append(res)
        gneed = [-(-max(r["fill_total"], 1) // 128) for r in results]
        self._ghint = max(self._ghint, *gneed)
        fills = []
        for ci, res in enumerate(results):
            if gneed[ci] > p.ghint:
                groups = self._second_round(p, ci, HR, HR + 5 * gneed[ci])
            else:
                groups = fetched[ci][HR:HR + 5 * gneed[ci]]
            fills.append(SQ.unpack_fills(groups, res["fill_total"]))
            self._metrics += res["metrics"]
            self._hist += res["hist"]
        host = {k: np.concatenate([r[k] for r in results])
                for k in ("ok", "cap_reject", "append", "residual",
                          "nfill", "prev_oid")}
        return host, np.concatenate(fills, axis=1)

    def _count_bytes(self, p: _Pending) -> None:
        """The bytes of a probed dispatch, read on the side stream behind
        its event, so that the reads do not wait for later kernels."""
        cols, pre, post = p.probe
        p.probe = None
        side = self._staging.side
        with torch.cuda.stream(side):
            side.wait_event(p.done)
            out = p.outp[0]
            barriers = int(out[0, 2 + MET_BARRIERS])
            self._probe_bytes += SQ.dispatch_bytes(self.cfg, cols, out,
                                                   pre, post, barriers)
        self._probed += 1

    def _second_round(self, p: _Pending, ci: int, lo: int, hi: int):
        self.overflow_fetches += 1
        if p.done is None:
            return p.outp[ci, lo:hi].numpy()
        side = self._staging.side
        rows = torch.empty((hi - lo, SQ.LN), dtype=torch.int32,
                           pin_memory=True)
        with torch.cuda.stream(side):
            side.wait_event(p.done)
            rows.copy_(p.outp[ci, lo:hi], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(side)
        ev.synchronize()
        return rows.numpy()

    def _run(self, msgs):
        """One batch serially: dispatch, then fetch.
        -> (cols, host_rejects, host dict, fills (4, F))."""
        p = self._dispatch(msgs)
        with self.timer.phase("fetch_s"):
            host, fills = self._fetch(p)
        return p.cols, p.host_rejects, host, fills

    # -- pipelined serving: dispatch batch N+1 before fetching N --------

    def submit(self, msgs):
        """Route + pack + stage + DISPATCH a batch without fetching its
        outputs; returns an opaque handle for collect(). Several handles
        may be in flight: the state threads through the batches in submit
        order, so collect them in submit order (anything else raises).
        On the card this returns once the kernel and its early output
        copy are queued; on the CPU the batch has run when it returns."""
        t0 = time.perf_counter()
        if not isinstance(msgs, WireBatch):
            try:
                msgs = WireBatch.from_msgs(msgs)
            except OverflowError:
                raise ValueError(
                    "pipelined serving requires int64-range ids — "
                    "route beyond-int64 streams through process_wire")
        p = self._dispatch(msgs, self._n_submit)
        # the staging overlapped the card exactly when an earlier submit
        # is still uncollected: its kernel runs while these planes stage
        self._h2d_total_s += p.stage_s
        if self._n_submit > self._n_collect:
            self._h2d_overlap_s += p.stage_s
        # advisory gauges: cumulative host cost of staging and the share
        # of it hidden under in-flight device compute
        self.telemetry.publish_gauges(
            {"h2d_stage_s": round(self.phases.get("stage_s", 0.0), 6),
             "h2d_overlap_frac": self.h2d_overlap_frac})
        self.windows.append(("submit", self._n_submit, t0,
                             time.perf_counter()))
        self._n_submit += 1
        return p

    @property
    def h2d_overlap_frac(self) -> float:
        """Fraction of H2D staging wall hidden under in-flight device
        compute. Serial paths report 0.0; a depth-N pipeline approaches
        (N-1)/N, so depth 2 gives at least 0.5."""
        if self._h2d_total_s <= 0.0:
            return 0.0
        return round(self._h2d_overlap_s / self._h2d_total_s, 4)

    def collect(self, handle: _Pending):
        """Complete a submit(): wait for its outputs (its own event, not
        the later batches'), fetch and reconstruct the byte stream.
        Returns (buf, line_off, msg_lines) like process_wire_buffer
        (needs the native reconstructor)."""
        if handle.seq != self._n_collect:
            raise ValueError(
                f"collect out of submit order: batch {handle.seq} while "
                f"batch {self._n_collect} is next")
        t0 = time.perf_counter()
        with self.timer.phase("fetch_s"):
            host, fills = self._fetch(handle)
        with self.timer.phase("recon_s"):
            r = self._recon_buffer(handle.msgs, handle.cols,
                                   handle.host_rejects, host, fills)
        self.windows.append(("collect", self._n_collect, t0,
                             time.perf_counter()))
        self._n_collect += 1
        return r

    # ------------------------------------------------------------------

    def process_wire_buffer(self, msgs):
        """Serving fast path: the full byte-exact record stream as ONE
        utf-8 buffer + line offsets + per-message line counts, built by
        the native reconstructor (native/kme_wire.cpp). `msgs` may be a
        WireBatch (no per-message Python work) or an OrderMsg sequence
        (columnarized here, one attribute walk). Returns (buf: bytes,
        line_off: (L+1,) np.int64 incl. end sentinel, msg_lines: (nmsg,)
        np.int32), or None under KME_NATIVE=0 or when a field exceeds
        int64 (callers then take process_wire's Python path)."""
        if load_library() is None:
            return None
        if not len(msgs):
            return b"", np.zeros(1, np.int64), np.zeros(0, np.int32)
        if isinstance(msgs, WireBatch):
            batch = msgs
        else:
            try:
                batch = WireBatch.from_msgs(msgs)
            except OverflowError:
                return None  # beyond-int64 ids ride the Python path
        cols, host_rejects, host, fills = self._run(batch)
        with self.timer.phase("recon_s"):
            return self._recon_buffer(batch, cols, host_rejects, host, fills)

    def _recon_luts(self):
        """lane -> sid and account-idx -> aid LUTs for reconstruction,
        cached against the native router's id-map sizes: the maps only
        grow (REMOVE_SYMBOL wipes books, not the lane mapping), and
        exporting them is O(accounts) per batch. Wholesale imports bump
        _map_epoch, so a same-size restore never serves a stale cache;
        Python routers are uncached (their dicts mutate without a
        hook)."""
        r = self.router
        key = None
        if isinstance(r, NativeSeqRouter):
            key = (int(r._lib.kme_router_n_symbols(r._h)),
                   int(r._lib.kme_router_n_accounts(r._h)),
                   r._map_epoch)
            cached = getattr(self, "_lut_cache", None)
            if cached is not None and cached[0] == key:
                return cached[1], cached[2]
        lut = np.zeros(self.cfg.lanes, np.int64)
        for lane, sid in r.sid_of_lane().items():
            lut[lane] = sid
        idx2aid = np.array(r.acct_of_idx() or [0], np.int64)
        if key is not None:
            self._lut_cache = (key, lut, idx2aid)
        return lut, idx2aid

    def _recon_buffer(self, batch, cols, host_rejects, host, fills):
        """Columnar inputs + device results -> the byte-exact record
        stream through the native one-pass reconstructor
        (kme_recon_batch)."""
        lib = load_library()
        if lib is None:
            raise RuntimeError(
                "the native reconstructor (kme_wire.cpp) is required for "
                "the pipelined/buffer serving path — KME_NATIVE=0 is set; "
                "use process_wire")
        self.last_reasons = reject_reason_codes(
            batch.n, cols["msg_index"], cols["act"], host["ok"],
            host["cap_reject"], host_rejects)
        if self._recon is None:
            self._recon = lib.kme_recon_new()
            # release the native buffer with the session
            self._recon_fin = weakref.finalize(self, lib.kme_recon_free,
                                               self._recon)
        lane_sid, idx2aid = self._recon_luts()
        return recon_batch(lib, self._recon, batch, cols, host, fills,
                           lane_sid, idx2aid)

    def process_wire(self, msgs) -> List[List[str]]:
        """The MatchOut lines of each message: sliced from
        process_wire_buffer's bytes, or built by the Python line builder
        (the `order_json` path) when `_use_native_wire` is off, under
        KME_NATIVE=0, or for ids beyond int64."""
        if self._use_native_wire:
            r = self.process_wire_buffer(msgs)
            if r is not None:
                buf, line_off, msg_lines = r
                text = buf.decode("ascii")
                out = []
                li = 0
                for nl in msg_lines.tolist():
                    out.append([text[line_off[li + k]:line_off[li + k + 1]]
                                for k in range(nl)])
                    li += nl
                return out
        if isinstance(msgs, WireBatch):
            msgs = msgs.msgs()
        cols, host_rejects, host, fills = self._run(msgs)
        idx_to_aid = self.router.acct_of_idx()
        lane_to_sid = self.router.sid_of_lane()

        nmsg = len(msgs)
        self.last_reasons = reject_reason_codes(
            nmsg, cols["msg_index"], cols["act"], host["ok"],
            host["cap_reject"], host_rejects)
        ok_of = [False] * nmsg
        nfill_of = [0] * nmsg
        off_of = [0] * nmsg
        resid_of = [0] * nmsg
        prev_of = [0] * nmsg
        append_of = [False] * nmsg
        act_of = [0] * nmsg
        lane_of = [0] * nmsg
        mis = cols["msg_index"].tolist()
        offs = (np.cumsum(host["nfill"]) - host["nfill"]).tolist() \
            if len(mis) else []
        for arr, dst in ((host["ok"], ok_of), (host["nfill"], nfill_of),
                         (host["residual"], resid_of),
                         (host["prev_oid"], prev_of),
                         (host["append"], append_of)):
            vals = arr.tolist()
            for k, mi in enumerate(mis):
                dst[mi] = vals[k]
        acts = cols["act"].tolist()
        lanes_l = cols["lane"].tolist()
        for k, mi in enumerate(mis):
            off_of[mi] = offs[k]
            act_of[mi] = acts[k]
            lane_of[mi] = lanes_l[k]
        f_oid, f_aid, f_price, f_size = (fills[c].tolist() for c in range(4))

        out: List[List[str]] = []
        for i, m in enumerate(msgs):
            in_body = order_json(m.action, m.oid, m.aid, m.sid, m.price,
                                 m.size, m.next, m.prev)
            lines = [f'IN {in_body}']
            if i in host_rejects or not ok_of[i]:
                lines.append('OUT ' + order_json(
                    op.REJECT, m.oid, m.aid, m.sid, m.price, m.size,
                    m.next, m.prev))
            elif act_of[i] in (SQ.L_BUY, SQ.L_SELL):
                sid = lane_to_sid[lane_of[i]]
                is_buy = act_of[i] == SQ.L_BUY
                mk_act = op.SOLD if is_buy else op.BOUGHT
                tk_act = op.BOUGHT if is_buy else op.SOLD
                o0 = off_of[i]
                for e in range(nfill_of[i]):
                    fsz = f_size[o0 + e]
                    lines.append('OUT ' + order_json(
                        mk_act, f_oid[o0 + e], idx_to_aid[f_aid[o0 + e]],
                        sid, 0, fsz))
                    lines.append('OUT ' + order_json(
                        tk_act, m.oid, m.aid, sid, m.price - f_price[o0 + e],
                        fsz))
                lines.append('OUT ' + order_json(
                    m.action, m.oid, m.aid, m.sid, m.price,
                    resid_of[i], m.next,
                    int(prev_of[i]) if append_of[i] else m.prev))
            else:
                lines.append(f'OUT {in_body}')
            out.append(lines)
        return out

    def process(self, msgs) -> List[List[OutRecord]]:
        if isinstance(msgs, WireBatch):
            msgs = msgs.msgs()
        cols, host_rejects, host, fills = self._run(msgs)
        idx_to_aid = self.router.acct_of_idx()
        lane_to_sid = self.router.sid_of_lane()
        nmsg = len(msgs)
        self.last_reasons = reject_reason_codes(
            nmsg, cols["msg_index"], cols["act"], host["ok"],
            host["cap_reject"], host_rejects)
        dev = {mi: k for k, mi in enumerate(cols["msg_index"].tolist())}
        offs = np.cumsum(host["nfill"]) - host["nfill"]

        out: List[List[OutRecord]] = []
        for i, m in enumerate(msgs):
            recs = [OutRecord("IN", m.copy())]
            echo = m.copy()
            if i in host_rejects:
                echo.action = op.REJECT
                recs.append(OutRecord("OUT", echo))
                out.append(recs)
                continue
            k = dev[i]
            ok = bool(host["ok"][k])
            lane_act = int(cols["act"][k])
            if lane_act in (SQ.L_BUY, SQ.L_SELL) and ok:
                sid = lane_to_sid[int(cols["lane"][k])]
                is_buy = lane_act == SQ.L_BUY
                o0 = int(offs[k])
                for e in range(int(host["nfill"][k])):
                    fsz = int(fills[3, o0 + e])
                    recs.append(OutRecord("OUT", OrderMsg(
                        action=op.SOLD if is_buy else op.BOUGHT,
                        oid=int(fills[0, o0 + e]),
                        aid=idx_to_aid[int(fills[1, o0 + e])], sid=sid,
                        price=0, size=fsz)))
                    recs.append(OutRecord("OUT", OrderMsg(
                        action=op.BOUGHT if is_buy else op.SOLD,
                        oid=m.oid, aid=m.aid, sid=sid,
                        price=m.price - int(fills[2, o0 + e]), size=fsz)))
                echo.size = int(host["residual"][k])
                if bool(host["append"][k]):
                    echo.prev = int(host["prev_oid"][k])
            elif not ok:
                echo.action = op.REJECT
            recs.append(OutRecord("OUT", echo))
            out.append(recs)
        return out

    # ------------------------------------------------------------------

    def metrics(self) -> Dict[str, int]:
        counters = dict(zip(SQ.METRIC_NAMES, self._metrics.tolist()))
        if self.cfg.compat == "java":
            j = SQ.export_java(self.cfg, self.state)
            used = j["slot_size"] > 0
            books, accounts = j["book_exists"], j["bal_used"]
            positions = len(j["positions"])
        else:
            canon = SQ.export_canonical(self.cfg, self.state)
            used = canon["slot_used"]
            books, accounts = canon["book_exists"], canon["bal_used"]
            positions = int((canon["pos_amt"] != 0).sum())
        depth = used.sum(axis=2)
        counters.update({
            "open_orders": int(used.sum()),
            "books": int(books.sum()),
            "accounts": int(accounts.sum()),
            "positions": positions,
            "max_book_depth": int(depth.max()) if depth.size else 0,
        })
        self._publish(counters)
        return counters

    def histograms(self) -> Dict[str, list]:
        """Device-accumulated distribution histograms (HIST_NAMES -> 16
        power-of-two bucket counts); published into the registry.
        book_depth stays empty in java mode (Q1 merged books have no
        per-lane occupancy plane)."""
        h = {name: self._hist[i].tolist()
             for i, name in enumerate(SQ.HIST_NAMES)}
        self.telemetry.publish_histograms(h)
        return h

    def _publish(self, counters: Dict[str, int]) -> None:
        self.telemetry.publish_counters(
            {k: counters[k] for k in SQ.METRIC_NAMES})
        self.telemetry.publish_gauges(
            {k: v for k, v in counters.items()
             if k not in SQ.METRIC_NAMES})

    def export_state(self) -> Dict[str, dict]:
        """Oracle-comparable host dict view. It walks only the positions
        and resting orders that exist, so its cost follows the state in
        use (the auditor reads it at every checkpoint)."""
        if self.cfg.compat == "java":
            return self._export_state_java()
        return self._canon_to_export(SQ.export_canonical(self.cfg,
                                                         self.state))

    def _canon_to_export(self, canon: dict) -> Dict[str, dict]:
        idx_to_aid = self.router.acct_of_idx()
        lane_to_sid = self.router.sid_of_lane()
        A = self.cfg.accounts
        na = len(idx_to_aid)
        balances = {idx_to_aid[i]: int(canon["bal"][i])
                    for i in range(na) if canon["bal_used"][i]}
        positions = {}
        pos_amt = canon["pos_amt"].reshape(self.cfg.lanes, A)[:, :na]
        pos_avail = canon["pos_avail"].reshape(self.cfg.lanes, A)[:, :na]
        # row-major nonzero order == the lane-then-account loop order
        for lane, a in zip(*np.nonzero(pos_amt)):
            sid = lane_to_sid.get(int(lane))
            if sid is not None:
                positions[(idx_to_aid[a], sid)] = (
                    int(pos_amt[lane, a]), int(pos_avail[lane, a]))
        orders = {}
        for lane, side, nn in zip(*np.nonzero(canon["slot_used"])):
            sid = lane_to_sid.get(int(lane))
            if sid is None:
                continue
            orders[int(canon["slot_oid"][lane, side, nn])] = {
                "aid": idx_to_aid[int(canon["slot_aid"][lane, side, nn])],
                "sid": sid,
                "price": int(canon["slot_price"][lane, side, nn]),
                "size": int(canon["slot_size"][lane, side, nn]),
                "is_buy": bool(side == 0),
            }
        books = {sid: True for sid, lane in self.router.sid_lane.items()
                 if canon["book_exists"][lane]}
        return {"balances": balances, "positions": positions,
                "orders": orders, "books": books}

    def _export_state_java(self) -> Dict[str, dict]:
        """Java-mode stores, oracle-comparable: positions keyed by the
        raw 128-bit pairs (real AND Q11 keys), orders with the original
        direction from the ba tag bit."""
        j = SQ.export_java(self.cfg, self.state)
        idx_to_aid = self.router.acct_of_idx()
        lane_to_sid = self.router.sid_of_lane()
        balances = {idx_to_aid[i]: int(j["bal"][i])
                    for i in range(len(idx_to_aid)) if j["bal_used"][i]}
        orders = {}
        for lane, side, nn in zip(*np.nonzero(j["slot_size"] > 0)):
            sid = lane_to_sid.get(int(lane))
            if sid is None:
                continue
            ba = int(j["slot_ba"][lane, side, nn])
            orders[int(j["slot_oid"][lane, side, nn])] = {
                "aid": idx_to_aid[ba & SQ.AMASK],
                "sid": sid,
                "price": int(j["slot_price"][lane, side, nn]),
                "size": int(j["slot_size"][lane, side, nn]),
                "is_buy": (ba >> 30) & 1 == 1,
            }
        books = {sid: True for sid, lane in self.router.sid_lane.items()
                 if j["book_exists"][lane]}
        return {"balances": balances, "positions": j["positions"],
                "orders": orders, "books": books}
