"""The native host path behind the Python API: the C++ conflict-free
scheduler, the batch plan (envelope check + route + pack) and the one-pass
MatchOut reconstruction (kme_host.cpp, kme_wire.cpp).

The port of `kme_tpu/native/sched.py`. `NativeScheduler` is a drop-in for
`runtime/sequencer.py`'s `Scheduler`, which stays the semantics authority:
identical plans field for field and the same id-space state surface
(aid_idx / sid_lane / oid_sid / _rr_lane as properties backed by the C++
maps). One deliberate difference: the wire envelope (int32 price/size) is
validated for the WHOLE batch up front, so an EnvelopeError leaves the id
maps untouched (the Python scheduler mutates them up to the offending
message); both raise on the same streams.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, List, Sequence

import numpy as np

from kme_tpu_torch.native import BoundaryError, check_buffer, load_library
from kme_tpu_torch.runtime.sequencer import (Barrier, CapacityError,
                                             EnvelopeError, HostReject,
                                             Schedule)
from kme_tpu_torch.utils import jlong
from kme_tpu_torch.wire import OrderMsg

_ST_CAP_ACCOUNTS, _ST_CAP_SYMBOLS = 1, 2
_P64 = ctypes.POINTER(ctypes.c_int64)
_P32 = ctypes.POINTER(ctypes.c_int32)
_PU8 = ctypes.POINTER(ctypes.c_uint8)


def native_available() -> bool:
    return load_library() is not None


def _arr(ptr, n, dtype):
    if n == 0:
        return np.zeros(0, dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def export_map(handle, nfn, efn, vdt) -> Dict[int, int]:
    """One of a native object's int64-keyed id maps as a dict: `nfn`
    gives its size, `efn` fills a key and a value (`vdt`) array."""
    n = nfn(handle)
    keys = np.zeros(n, np.int64)
    vals = np.zeros(n, vdt)
    efn(handle, keys.ctypes.data_as(_P64),
        vals.ctypes.data_as(_P32 if vdt == np.int32 else _P64))
    return dict(zip(keys.tolist(), vals.tolist()))


def import_map(handle, ifn, d: Dict[int, int], vdt) -> None:
    """Replace one of a native object's id maps with the dict `d`."""
    keys = np.fromiter(d.keys(), np.int64, len(d))
    vals = np.fromiter(d.values(), vdt, len(d))
    ifn(handle, len(d), keys.ctypes.data_as(_P64),
        vals.ctypes.data_as(_P32 if vdt == np.int32 else _P64))


class NativeScheduler:
    def __init__(self, num_lanes: int, num_accounts: int,
                 width: int = 0) -> None:
        if width < 0:
            raise ValueError(f"width must be >= 0, got {width}")
        self._lib = load_library()
        if self._lib is None:
            raise RuntimeError("the native scheduler needs the host runtime "
                               "(KME_NATIVE=0 is set)")
        self.S = num_lanes
        self.A = num_accounts
        self.width = width
        self._h = self._lib.kme_sched_new(num_lanes, num_accounts, width)
        self._fin = weakref.finalize(self, self._lib.kme_sched_free, self._h)

    # -- planning ----------------------------------------------------------

    def plan(self, msgs: Sequence[OrderMsg]) -> Schedule:
        n = len(msgs)
        la, lo_, ld, ls, lp, lz = [], [], [], [], [], []
        for i, m in enumerate(msgs):
            if not (-2**31 <= m.price < 2**31 and -2**31 <= m.size < 2**31):
                raise EnvelopeError(
                    f"message {i}: price/size outside int32 "
                    f"(price={m.price}, size={m.size})")
            # action is compared RAW against the opcode table (matching
            # the Python scheduler): out-of-int64 actions are unknown
            # opcodes, never aliased by wrapping. Ids wrap to Java longs
            # exactly like the Python scheduler's map keys.
            a = m.action
            la.append(a if -2**63 <= a < 2**63 else -1)
            lo_.append(jlong(m.oid))
            ld.append(jlong(m.aid))
            ls.append(jlong(m.sid))
            lp.append(m.price)
            lz.append(m.size)
        arrs = [np.array(col, np.int64) if col else np.zeros(0, np.int64)
                for col in (la, lo_, ld, ls, lp, lz)]
        lib, h = self._lib, self._h
        st = lib.kme_sched_plan(h, n, *(a.ctypes.data_as(_P64)
                                        for a in arrs))
        if st == _ST_CAP_ACCOUNTS:
            raise CapacityError(
                f"account capacity {self.A} exhausted "
                f"(aid={lib.kme_sched_err_value(h)})")
        if st == _ST_CAP_SYMBOLS:
            raise CapacityError(
                f"symbol capacity {self.S} exhausted "
                f"(sid={lib.kme_sched_err_value(h)})")

        np_ = lib.kme_sched_n_placed(h)
        cols = {
            "msg_index": _arr(lib.kme_sched_p_msg(h), np_, np.int64),
            "segment": _arr(lib.kme_sched_p_seg(h), np_, np.int32),
            "step": _arr(lib.kme_sched_p_step(h), np_, np.int32),
            "lane": _arr(lib.kme_sched_p_lane(h), np_, np.int32),
            "act": _arr(lib.kme_sched_p_act(h), np_, np.int32),
            "aidx": _arr(lib.kme_sched_p_aidx(h), np_, np.int32),
            "oid": _arr(lib.kme_sched_p_oid(h), np_, np.int64),
            "price": _arr(lib.kme_sched_p_price(h), np_, np.int32),
            "size": _arr(lib.kme_sched_p_size(h), np_, np.int32),
            "slot": _arr(lib.kme_sched_p_slot(h), np_, np.int32),
        }
        nb = lib.kme_sched_n_barriers(h)
        b_msg = _arr(lib.kme_sched_b_msg(h), nb, np.int64)
        b_lane = _arr(lib.kme_sched_b_lane(h), nb, np.int32)
        b_mode = _arr(lib.kme_sched_b_mode(h), nb, np.int32)
        b_credit = _arr(lib.kme_sched_b_credit(h), nb, np.int64)
        barriers = [Barrier(int(b_msg[i]), int(b_lane[i]), int(b_mode[i]),
                            int(b_credit[i])) for i in range(nb)]
        nr = lib.kme_sched_n_rejects(h)
        rejects = [HostReject(int(x))
                   for x in _arr(lib.kme_sched_r_msg(h), nr, np.int64)]
        ns = lib.kme_sched_n_segments(h)
        seg_steps = _arr(lib.kme_sched_seg_steps(h), ns, np.int32).tolist()
        npr = lib.kme_sched_n_program(h)
        prog_raw = _arr(lib.kme_sched_program(h), npr * 2, np.int32)
        program = [("scan" if prog_raw[2 * i] == 0 else "barrier",
                    int(prog_raw[2 * i + 1])) for i in range(npr)]
        return Schedule(cols, barriers, rejects, seg_steps, program)

    # -- id-space state (same surface as the Python Scheduler) ------------

    @property
    def aid_idx(self) -> Dict[int, int]:
        lib = self._lib
        return export_map(self._h, lib.kme_sched_n_accounts,
                          lib.kme_sched_export_accounts, np.int32)

    @aid_idx.setter
    def aid_idx(self, d: Dict[int, int]) -> None:
        import_map(self._h, self._lib.kme_sched_import_accounts, d, np.int32)

    @property
    def sid_lane(self) -> Dict[int, int]:
        lib = self._lib
        return export_map(self._h, lib.kme_sched_n_symbols,
                          lib.kme_sched_export_symbols, np.int32)

    @sid_lane.setter
    def sid_lane(self, d: Dict[int, int]) -> None:
        import_map(self._h, self._lib.kme_sched_import_symbols, d, np.int32)

    @property
    def oid_sid(self) -> Dict[int, int]:
        lib = self._lib
        return export_map(self._h, lib.kme_sched_n_routes,
                          lib.kme_sched_export_routes, np.int64)

    @oid_sid.setter
    def oid_sid(self, d: Dict[int, int]) -> None:
        import_map(self._h, self._lib.kme_sched_import_routes, d, np.int64)

    @property
    def _rr_lane(self) -> int:
        return int(self._lib.kme_sched_rr_lane(self._h))

    @_rr_lane.setter
    def _rr_lane(self, v: int) -> None:
        self._lib.kme_sched_set_rr_lane(self._h, int(v))

    # -- reconstruction helpers (same as Scheduler) ------------------------

    def acct_of_idx(self) -> List[int]:
        d = self.aid_idx
        out = [0] * len(d)
        for aid, idx in d.items():
            out[idx] = aid
        return out

    def sid_of_lane(self) -> Dict[int, int]:
        return {lane: sid for sid, lane in self.sid_lane.items()}


# -- batch host-path entry points (one C++ call per stage) ----------------
#
# The serving hot loop's host work — envelope check + route + pack on the
# way in, output planes -> byte stream on the way out — as single C calls
# (kme_plan_batch / kme_recon_batch). The numpy pack and the Python line
# builder stay the semantics authority (the tests hold them equal).


def plan_batch(router, batch, B: int):
    """Envelope-check + route + pack one WireBatch into the stacked
    (K, B) int32 scan-input planes in a single native call. `router` is a
    NativeSeqRouter; returns (cols, host_rejects, stacked, cnts, K) with
    SeqSession._plan's contract. The stacked planes are zero-copy views
    into a rotating native buffer (4 deep): the caller copies them out
    (to the pinned staging ring, or to the card) before it plans a
    fourth batch."""
    lib = router._lib
    pack = ensure_pack(router)
    # kme_plan_batch reads batch.n int64s from every column with no
    # native-side length check: pin the dtype at conversion and verify
    # the element count BEFORE handing out pointers
    raw = {f: check_buffer(
               f"plan_batch.{f}",
               np.ascontiguousarray(getattr(batch, f), np.int64),
               np.int64, batch.n)
           for f in ("action", "oid", "aid", "sid", "price", "size")}
    K = int(lib.kme_plan_batch(
        pack, router._h, batch.n,
        *(raw[f].ctypes.data_as(_P64)
          for f in ("action", "oid", "aid", "sid", "price", "size")),
        B))
    return collect_plan(lib, router, pack, K, B, raw["price"], raw["size"])


def ensure_pack(router):
    """The router's cached native pack handle (kme_pack_new), created on
    first use and freed with the router."""
    lib = router._lib
    pack = getattr(router, "_pack", None)
    if pack is None:
        pack = lib.kme_pack_new()
        router._pack = pack
        router._pack_fin = weakref.finalize(router, lib.kme_pack_free, pack)
    return pack


def collect_plan(lib, router, pack, K, B, price, size):
    """Shared tail of the native plan: map the result code K to the
    EnvelopeError/CapacityError contract and read back routed columns +
    packed planes. `price`/`size` are the int64 input columns, consulted
    only for the envelope error message."""
    if K == -3:
        i = int(lib.kme_pack_err_index(pack))
        raise EnvelopeError(
            f"message {i}: price/size outside int32 "
            f"(price={int(price[i])}, size={int(size[i])})")
    if K < 0:
        raise CapacityError(
            f"{'account' if K == -1 else 'symbol'} capacity "
            f"exhausted (id={lib.kme_router_err_value(router._h)})")
    h = router._h
    nr = int(lib.kme_router_n_routed(h))
    nj = int(lib.kme_router_n_rejects(h))
    cols = {
        "msg_index": _arr(lib.kme_router_o_msg(h), nr, np.int64),
        "act": _arr(lib.kme_router_o_act(h), nr, np.int32),
        "aid": _arr(lib.kme_router_o_aidx(h), nr, np.int32),
        "price": _arr(lib.kme_router_o_price(h), nr, np.int32),
        "size": _arr(lib.kme_router_o_size(h), nr, np.int32),
        "lane": _arr(lib.kme_router_o_lane(h), nr, np.int32),
        "oid": _arr(lib.kme_router_o_oid(h), nr, np.int64),
    }
    host_rejects = set(_arr(lib.kme_router_o_rej(h), nj, np.int64).tolist())
    planes = np.ctypeslib.as_array(lib.kme_pack_planes(pack),
                                   shape=(7, K, B))
    stacked = {name: planes[j] for j, name in enumerate(
        ("act", "aid", "price", "size", "lane", "oid_lo", "oid_hi"))}
    cnts = [max(min(B, nr - ci * B), 0) for ci in range(K)]
    return cols, host_rejects, stacked, cnts, K


def recon_batch(lib, handle, batch, cols, host, fills, lane_sid, idx2aid):
    """One-pass native reconstruction (kme_recon_batch): batch columns +
    routed rows + device results -> the byte-exact record stream.
    Returns (buf, line_off, msg_lines) like
    SeqSession.process_wire_buffer."""
    c = ctypes
    pp = lambda a, t: a.ctypes.data_as(t)
    i64 = lambda a: np.ascontiguousarray(a, np.int64)
    nmsg = batch.n
    nr = len(cols["msg_index"])
    # kme_recon_batch reads the m_* columns to nmsg and the r_*/h_* rows
    # to nr unconditionally (kme_wire.cpp): every pointer below is
    # validated for dtype/contiguity/length first, so a short or
    # mis-typed buffer raises here instead of overreading native-side
    for f in ("action", "oid", "aid", "sid", "price", "size", "next",
              "prev"):
        check_buffer(f"recon_batch.{f}", getattr(batch, f), np.int64, nmsg)
    for f in ("hnext", "hprev"):
        check_buffer(f"recon_batch.{f}", getattr(batch, f), np.uint8, nmsg)
    r_msg = i64(cols["msg_index"])
    r_act = np.ascontiguousarray(cols["act"], np.int32)
    r_lane = np.ascontiguousarray(cols["lane"], np.int32)
    h_ok = np.ascontiguousarray(host["ok"], np.uint8)
    h_append = np.ascontiguousarray(host["append"], np.uint8)
    h_nfill, h_resid, h_prev = (i64(host[k]) for k in
                                ("nfill", "residual", "prev_oid"))
    check_buffer("recon_batch.cols.msg_index", r_msg, np.int64, nr)
    for nm, a in (("cols.act", r_act), ("cols.lane", r_lane)):
        check_buffer(f"recon_batch.{nm}", a, np.int32, nr)
    for nm, a in (("host.ok", h_ok), ("host.append", h_append)):
        check_buffer(f"recon_batch.{nm}", a, np.uint8, nr)
    for nm, a in (("host.nfill", h_nfill), ("host.residual", h_resid),
                  ("host.prev_oid", h_prev)):
        check_buffer(f"recon_batch.{nm}", a, np.int64, nr)
    check_buffer("recon_batch.lane_sid", lane_sid, np.int64)
    check_buffer("recon_batch.idx2aid", idx2aid, np.int64)
    if fills.ndim != 2 or fills.shape[0] != 4:
        raise BoundaryError(
            f"recon_batch.fills: expected shape (4, F), got {fills.shape}")
    f_oid, f_aidx, f_price, f_size = (
        check_buffer(f"recon_batch.fills[{j}]", i64(fills[j]),
                     np.int64, fills.shape[1]) for j in range(4))
    rc = lib.kme_recon_batch(
        nmsg, pp(batch.action, _P64), pp(batch.oid, _P64),
        pp(batch.aid, _P64), pp(batch.sid, _P64), pp(batch.price, _P64),
        pp(batch.size, _P64), pp(batch.next, _P64),
        pp(batch.hnext, _PU8), pp(batch.prev, _P64),
        pp(batch.hprev, _PU8),
        nr, pp(r_msg, _P64), pp(r_act, _P32), pp(r_lane, _P32),
        pp(h_ok, _PU8), pp(h_nfill, _P64), pp(h_resid, _P64),
        pp(h_prev, _P64), pp(h_append, _PU8),
        len(lane_sid), pp(lane_sid, _P64),
        len(idx2aid), pp(idx2aid, _P64),
        fills.shape[1], pp(f_oid, _P64), pp(f_aidx, _P64),
        pp(f_price, _P64), pp(f_size, _P64), handle)
    if rc != 0:
        raise RuntimeError(f"kme_recon_batch failed rc={rc}")
    blen = lib.kme_recon_len(handle)
    nlines = lib.kme_recon_n_lines(handle)
    buf = c.string_at(lib.kme_recon_buf(handle), blen)
    line_off = np.empty(nlines + 1, np.int64)
    line_off[:nlines] = np.ctypeslib.as_array(
        lib.kme_recon_line_off(handle), (nlines,))
    line_off[nlines] = blen
    msg_lines = np.ctypeslib.as_array(
        lib.kme_recon_msg_lines(handle), (nmsg,)).copy()
    return buf, line_off, msg_lines
