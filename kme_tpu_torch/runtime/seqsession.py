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

One dispatch per `process`/`process_wire` call: all K chunks go to the
card in one kernel launch (`seq_scan`), and the outputs come back in ONE
device-to-host copy of the headers plus an adaptive fill prefix.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from kme_tpu_torch import opcodes as op
from kme_tpu_torch.engine import seq as SQ
from kme_tpu_torch.runtime.sequencer import CapacityError, EnvelopeError
from kme_tpu_torch.runtime.session import LaneEngineError
from kme_tpu_torch.utils import jlong, pow2_bucket
from kme_tpu_torch.wire import (OrderMsg, OutRecord, order_json,
                                reject_reason_codes)

_TRADE_ACTS = {op.BUY: SQ.L_BUY, op.SELL: SQ.L_SELL}


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


def make_seq_router(num_lanes: int, num_accounts: int,
                    compat: str = "fixed"):
    """The Python router (the native router comes with the serving
    slice of the port)."""
    return SeqRouter(num_lanes, num_accounts, compat)


class SeqSession:
    """Engine over the sequential matching kernel, in the config's compat
    mode.

    Same public surface as the JAX package's SeqSession (process /
    process_wire / metrics / histograms / export_state). The state lives
    on `device` (default the card; `device="cpu"` runs the kernel's plain
    PyTorch version)."""

    def __init__(self, cfg: SQ.SeqConfig, device="cuda") -> None:
        self.cfg = cfg
        self.device = SQ.resolve_device(device)
        self.state = SQ.make_seq_state(cfg, self.device)
        self.router = make_seq_router(cfg.lanes, cfg.accounts, cfg.compat)
        self._metrics = np.zeros(SQ.N_METRICS, np.int64)
        self._hist = np.zeros((SQ.N_HIST, SQ.N_HIST_BUCKETS), np.int64)
        # CUMULATIVE wall seconds per phase across every batch
        self.phases = {"plan_s": 0.0, "dispatch_s": 0.0, "fetch_s": 0.0}
        self.dispatches = 0
        # adaptive fill-slice hint (fill groups per call fetched in the
        # single fetch; grows to the observed high-water mark)
        self._ghint = 8
        # per-message REJ_* reason codes for the last processed batch
        self.last_reasons = None

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
        stacked, cnts, K)."""
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

    def _run(self, msgs):
        """Plan, dispatch (ONE kernel launch over all chunks), fetch.
        Phase wall times accumulate in self.phases."""
        t0 = time.perf_counter()
        cols, host_rejects, stacked, cnts, K = self._plan(msgs)
        t1 = time.perf_counter()
        dev = {f: torch.from_numpy(stacked[f]).to(self.device,
                                                  non_blocking=True)
               for f in SQ.msg_fields(self.cfg)}
        outp = SQ.seq_scan(self.cfg, self.state, dev)
        self.dispatches += 1
        t2 = time.perf_counter()
        host, fills = self._fetch_outputs(outp, cnts, K)
        t3 = time.perf_counter()
        self.phases["plan_s"] += t1 - t0
        self.phases["dispatch_s"] += t2 - t1
        self.phases["fetch_s"] += t3 - t2
        return cols, host_rejects, host, fills

    def _fetch_outputs(self, outp, cnts, K):
        """ONE device-to-host copy of every call's header plus the
        adaptive fill-group hint's worth of fill rows; calls whose
        fill_total overflows the hint get a second, rare copy."""
        HR = SQ.hdr_rows(self.cfg)
        ghint = min(pow2_bucket(self._ghint, lo=1), self.cfg.fill_cap // 128)
        fetched = outp[:, :HR + 5 * ghint, :].cpu().numpy()
        results = []
        for ci in range(K):
            res = SQ.unpack_hdr(self.cfg, fetched[ci][:HR], cnts[ci])
            if res["err"] != SQ.LERR_OK:
                raise LaneEngineError(res["err"])
            results.append(res)
        gneed = [-(-max(r["fill_total"], 1) // 128) for r in results]
        self._ghint = max(self._ghint, *gneed)
        fills = []
        for ci, res in enumerate(results):
            if gneed[ci] > ghint:
                groups = outp[ci, HR:HR + 5 * gneed[ci]].cpu().numpy()
            else:
                groups = fetched[ci][HR:HR + 5 * gneed[ci]]
            fills.append(SQ.unpack_fills(groups, res["fill_total"]))
            self._metrics += res["metrics"]
            self._hist += res["hist"]
        host = {k: np.concatenate([r[k] for r in results])
                for k in ("ok", "cap_reject", "append", "residual",
                          "nfill", "prev_oid")}
        return host, np.concatenate(fills, axis=1)

    # ------------------------------------------------------------------

    def process_wire(self, msgs) -> List[List[str]]:
        """The MatchOut lines of each message (the `order_json` path)."""
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
        return counters

    def histograms(self) -> Dict[str, list]:
        """Device-accumulated distribution histograms (HIST_NAMES -> 16
        power-of-two bucket counts). book_depth stays empty in java mode
        (Q1 merged books have no per-lane occupancy plane)."""
        return {name: self._hist[i].tolist()
                for i, name in enumerate(SQ.HIST_NAMES)}

    def export_state(self) -> Dict[str, dict]:
        """Oracle-comparable host dict view. In fixed mode its Python loop
        is O(lanes * (accounts + slots)): at full width use `metrics` or
        `export_canonical`."""
        if self.cfg.compat == "java":
            return self._export_state_java()
        return self._canon_to_export(SQ.export_canonical(self.cfg,
                                                         self.state))

    def _canon_to_export(self, canon: dict) -> Dict[str, dict]:
        idx_to_aid = self.router.acct_of_idx()
        lane_to_sid = self.router.sid_of_lane()
        A = self.cfg.accounts
        balances = {idx_to_aid[i]: int(canon["bal"][i])
                    for i in range(len(idx_to_aid)) if canon["bal_used"][i]}
        positions = {}
        pos_amt = canon["pos_amt"].reshape(self.cfg.lanes, A)
        pos_avail = canon["pos_avail"].reshape(self.cfg.lanes, A)
        orders = {}
        S, _, N = canon["slot_oid"].shape
        for lane in range(S):
            sid = lane_to_sid.get(lane)
            if sid is None:
                continue
            for a in range(len(idx_to_aid)):
                if pos_amt[lane, a] != 0:
                    positions[(idx_to_aid[a], sid)] = (
                        int(pos_amt[lane, a]), int(pos_avail[lane, a]))
            for side in range(2):
                for nn in range(N):
                    if canon["slot_used"][lane, side, nn]:
                        orders[int(canon["slot_oid"][lane, side, nn])] = {
                            "aid": idx_to_aid[int(
                                canon["slot_aid"][lane, side, nn])],
                            "sid": sid,
                            "price": int(canon["slot_price"][lane, side, nn]),
                            "size": int(canon["slot_size"][lane, side, nn]),
                            "is_buy": side == 0,
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
