"""Conflict-free scheduler: wire messages -> (step, lane) placements.

The port of `kme_tpu/runtime/sequencer.py`: the Python scheduler, the
semantics authority of the native C++ one (`native/sched.py`), which
`make_scheduler` hands out whenever the host runtime loads. The
exactness contract (engine/lanes.py docstring): a parallel step is
bit-exact with serial replay iff
  (a) each symbol's messages stay in arrival order in its lane,
  (b) no two messages in a step share an actor account,
  (c) PAYOUT / REMOVE_SYMBOL run as exclusive barrier steps.
The greedy placement below enforces all three with two monotone clocks:
`lane_next[lane]` (first free step of the lane) and `actor_next[aid]`
(first step after the account's last message).

The scheduler also owns the id spaces: raw aid -> dense account index,
raw sid -> lane, and the oid -> sid routing map for cancels. Messages
the device cannot act on (unknown-oid cancels, negative-sid ADD_SYMBOL,
unmapped-symbol REMOVE/PAYOUT, unknown opcodes) are resolved host-side
as synthesized rejects.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from kme_tpu_torch import opcodes as op
from kme_tpu_torch.engine import lanes as L
from kme_tpu_torch.utils import jlong
from kme_tpu_torch.wire import EnvelopeError, OrderMsg


class CapacityError(RuntimeError):
    """The workload exceeds a static device capacity (symbols, accounts)."""


@dataclasses.dataclass
class Placed:
    """A device-executed message: its (segment, step, lane) coordinates.
    Under active-lane compaction `slot` is the message's position within
    its step (0..width-1) — the column of the (T, W) scan grid."""
    msg_index: int
    segment: int
    step: int       # step within segment
    lane: int
    lane_act: int   # L_* opcode
    aid_idx: int
    oid: int
    price: int
    size: int
    slot: int = 0


@dataclasses.dataclass
class Barrier:
    """A barrier-executed message (PAYOUT / REMOVE_SYMBOL)."""
    msg_index: int
    lane: int
    mode: int       # 0 remove, 1 payout YES, 2 payout NO
    credit_size: int


@dataclasses.dataclass
class HostReject:
    """Resolved host-side: emit IN + OUT(REJECT) without device work."""
    msg_index: int


_COL_DTYPES = (
    ("msg_index", "int64"), ("segment", "int32"), ("step", "int32"),
    ("lane", "int32"), ("act", "int32"), ("aidx", "int32"),
    ("oid", "int64"), ("price", "int32"), ("size", "int32"),
    ("slot", "int32"),
)


@dataclasses.dataclass
class Schedule:
    """segment_steps[i] = number of steps in scan segment i; the plan
    alternates scan segments and barriers in `program` order.

    Placements are COLUMNAR (`cols`: one numpy array per field, rows in
    arrival order — so `segment` and, per lane, `step` are nondecreasing
    by construction). `placements` materializes row objects for tests."""
    cols: dict                # field -> np.ndarray, aligned rows
    barriers: List[Barrier]
    host_rejects: List[HostReject]
    segment_steps: List[int]
    program: List[tuple]  # ("scan", seg_idx) | ("barrier", barrier_idx)

    _placements_cache: Optional[List[Placed]] = None

    @property
    def placements(self) -> List[Placed]:
        if self._placements_cache is None:
            c = self.cols
            self._placements_cache = [
                Placed(*(int(c[name][i]) for name, _ in _COL_DTYPES))
                for i in range(len(c["msg_index"]))]
        return self._placements_cache


_TRADE_ACTS = {op.BUY: L.L_BUY, op.SELL: L.L_SELL}


def make_scheduler(num_lanes: int, num_accounts: int, width: int = 0):
    """The native C++ scheduler (identical plans); the Python one only
    under KME_NATIVE=0. A host runtime that fails to build raises."""
    from kme_tpu_torch.native.sched import NativeScheduler, native_available

    if native_available():
        return NativeScheduler(num_lanes, num_accounts, width)
    return Scheduler(num_lanes, num_accounts, width)


class Scheduler:
    def __init__(self, num_lanes: int, num_accounts: int,
                 width: int = 0) -> None:
        if width < 0:
            raise ValueError(f"width must be >= 0, got {width}")
        self.S = num_lanes
        self.A = num_accounts
        self.width = width  # >0: at most `width` messages per scan step
        self.aid_idx: Dict[int, int] = {}
        self.sid_lane: Dict[int, int] = {}
        self.oid_sid: Dict[int, int] = {}
        self._rr_lane = 0  # round-robin for lane-free (account) ops

    # -- id spaces ---------------------------------------------------------

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
        """Dense index -> raw aid (for fill-event reconstruction)."""
        out = [0] * len(self.aid_idx)
        for aid, idx in self.aid_idx.items():
            out[idx] = aid
        return out

    def sid_of_lane(self) -> Dict[int, int]:
        return {lane: sid for sid, lane in self.sid_lane.items()}

    # -- planning ----------------------------------------------------------

    def plan(self, msgs: Sequence[OrderMsg]) -> Schedule:
        """Greedy conflict-free placement of a message batch."""
        rows = {name: [] for name, _ in _COL_DTYPES}
        barriers: List[Barrier] = []
        host_rejects: List[HostReject] = []
        segment_steps: List[int] = []
        program: List[tuple] = []

        lane_next = [0] * self.S
        actor_next: Dict[int, int] = {}
        step_fill: Dict[int, int] = {}  # step -> messages placed (width cap)
        first_open = 0  # monotone watermark: every step below it is full
        seg = 0
        seg_height = 0  # steps used so far in the current segment

        def close_segment():
            nonlocal seg, seg_height, lane_next, step_fill, first_open
            if seg_height > 0:
                segment_steps.append(seg_height)
                program.append(("scan", len(segment_steps) - 1))
                seg += 1
            lane_next = [0] * self.S
            for k in actor_next:
                actor_next[k] = 0
            step_fill = {}
            first_open = 0
            seg_height = 0

        def place(i: int, lane: int, lane_act: int, aidx: int,
                  m: OrderMsg, actor_key: Optional[int]) -> None:
            nonlocal seg_height, first_open
            step = lane_next[lane]
            if actor_key is not None:
                step = max(step, actor_next.get(actor_key, 0))
            slot = 0
            if self.width > 0:
                # step_fill counts only grow, so all steps below
                # first_open stay full — start the scan there
                step = max(step, first_open)
                while step_fill.get(step, 0) >= self.width:
                    step += 1
                slot = step_fill.get(step, 0)
                step_fill[step] = slot + 1
                while step_fill.get(first_open, 0) >= self.width:
                    first_open += 1
            r = rows
            r["msg_index"].append(i)
            r["segment"].append(seg)
            r["step"].append(step)
            r["lane"].append(lane)
            r["act"].append(lane_act)
            r["aidx"].append(aidx)
            r["oid"].append(jlong(m.oid))
            r["price"].append(m.price)
            r["size"].append(m.size)
            r["slot"].append(slot)
            lane_next[lane] = step + 1
            if actor_key is not None:
                actor_next[actor_key] = step + 1
            seg_height = max(seg_height, step + 1)

        def free_lane(step_floor: int) -> int:
            # prefer a lane whose clock is <= the actor clock (no stall)
            for probe in range(self.S):
                lane = (self._rr_lane + probe) % self.S
                if lane_next[lane] <= step_floor:
                    self._rr_lane = (lane + 1) % self.S
                    return lane
            lane = min(range(self.S), key=lane_next.__getitem__)
            self._rr_lane = (lane + 1) % self.S
            return lane

        for i, m in enumerate(msgs):
            a = m.action
            if not (-2**31 <= m.price < 2**31 and -2**31 <= m.size < 2**31):
                raise EnvelopeError(
                    f"message {i}: price/size outside int32 "
                    f"(price={m.price}, size={m.size})")
            # the id spaces are Java longs: wrap ONCE here
            aid, sid, oid = jlong(m.aid), jlong(m.sid), jlong(m.oid)
            if a in _TRADE_ACTS:
                lane = self._lane(sid)
                aidx = self._acct(aid)
                self.oid_sid[oid] = sid
                place(i, lane, _TRADE_ACTS[a], aidx, m, actor_key=aid)
            elif a == op.CANCEL:
                # the route stays mapped after a cancel attempt: a cancel
                # can fail (wrong owner) and be retried, and a second
                # cancel of a gone order correctly rejects on device
                rsid = self.oid_sid.get(oid)
                if rsid is None:
                    host_rejects.append(HostReject(i))
                    continue
                lane = self._lane(rsid)
                aidx = self._acct(aid)
                place(i, lane, L.L_CANCEL, aidx, m, actor_key=aid)
            elif a == op.CREATE_BALANCE:
                aidx = self._acct(aid)
                lane = free_lane(actor_next.get(aid, 0))
                place(i, lane, L.L_CREATE, aidx, m, actor_key=aid)
            elif a == op.TRANSFER:
                aidx = self._acct(aid)
                lane = free_lane(actor_next.get(aid, 0))
                place(i, lane, L.L_TRANSFER, aidx, m, actor_key=aid)
            elif a == op.ADD_SYMBOL:
                if sid < 0:
                    host_rejects.append(HostReject(i))
                    continue
                lane = self._lane(sid)
                place(i, lane, L.L_ADD_SYMBOL, 0, m, actor_key=None)
            elif a in (op.REMOVE_SYMBOL, op.PAYOUT):
                # abs(INT64_MIN) = 2^63 can never be a (wrapped) map key,
                # so a payout/remove of that sid host-rejects
                s = abs(sid)
                if s not in self.sid_lane:
                    host_rejects.append(HostReject(i))
                    continue
                lane = self.sid_lane[s]
                close_segment()
                if a == op.REMOVE_SYMBOL:
                    mode = 0
                else:
                    mode = 1 if sid >= 0 else 2
                barriers.append(Barrier(i, lane, mode, m.size))
                program.append(("barrier", len(barriers) - 1))
                # a wiped lane may be re-added later; resting-oid routes
                # die with the wipe
                dead = [o for o, s2 in self.oid_sid.items() if s2 == s]
                for o in dead:
                    del self.oid_sid[o]
            else:
                host_rejects.append(HostReject(i))  # unknown opcode
        close_segment()
        cols = {name: np.array(vals, dtype=dt)
                for (name, dt), vals in zip(_COL_DTYPES, rows.values())}
        return Schedule(cols, barriers, host_rejects, segment_steps,
                        program)
