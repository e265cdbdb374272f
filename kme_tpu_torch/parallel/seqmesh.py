"""The seq fleet: a symbol-sharded set of sequential kernels, bit-exact
against one serial SeqSession.

The port of `kme_tpu/parallel/seqmesh.py`. The seq engine
(engine/seq.py) is strictly serial on one device. The fleet follows the
reference's partition model (the topic is partitioned and Streams
instances split partitions, topic.js:18, KProcessor.java:59-60): lanes
(books, positions, seq counters) are SHARDED — each shard runs its own
seq kernel over its own message subsequence — and the balance planes are
REPLICATED, merged exactly at window boundaries.

On the card a shard is its own state dict (engine/seq.py's planes at the
local lane count) on the session's device plus its own CUDA stream: the
shards launch the seq kernel (`seq_scan`, one warp of one block) on
their streams, so their launches run side by side on separate SMs. On
the CPU the shards run one after another through the kernel's plain
version; the tests run it so.

Why this is bit-exact (the window invariant): within one window every
ACCOUNT's messages live on a single shard, so an account's balance
evolves exactly as in serial replay (balance writes always go to the
acting account: taker debit/credit, transfer, cancel release; maker
fills credit price 0 and touch only lane-local position state). The host
planner (`plan_windows`) closes a window whenever a message's account is
already bound to a different shard, whenever a shard's window capacity
fills, and around barriers (PAYOUT/REMOVE credit many accounts, so each
runs alone in its own window). At a window boundary each shard
contributes an int64 balance delta with at most one nonzero contributor
per account, so the sum is exact, Java-long wrap included.

ELASTIC PLACEMENT: a placement table (`_perm`: global lane -> global
slot; shard = slot // S_local) starts as the identity and a per-lane
load EWMA drives BETWEEN-BATCH migrations of hot lanes to underloaded
shards (`plan_rebalance` decides, `_migrate` permutes the lane state
through the engine's canonical codec, card -> host -> card).
Correctness is placement-independent: any symbol -> shard assignment
that keeps the global application order and the window invariant gives
byte-identical MatchOut.

Two dispatch modes, byte-identical:

- "lockstep": per window, every occupied shard's kernel runs on its
  stream, the streams are joined, and the balance planes are merged —
  `old + sum(delta)` in int64 over each shard's (bal_lo, bal_hi) pair,
  `bal_u` the start plus the summed deltas, `err` the max — and pushed
  back to every shard. The JAX package's `psum`/`pmax` scan body.
- "async" (the default): each shard's windows queue up and are flushed
  as one kernel launch per segment only when forced: by a dependency
  (an account whose messages move from shard A to shard B between
  windows — B takes a point-to-point patch of just the moved accounts
  from A), by a barrier, or at batch end. Barriers and the batch-end
  collect are the only FULL merges: each account's balance is selected
  from the shard that last bound it (`select_balances`), on the card,
  after every shard stream is joined, and pushed to every shard on its
  own stream. The point-to-point patch never reads a shard's live
  planes from another stream: the source's planes are copied on the
  SOURCE's stream right behind its flushed segment (as of window w-1,
  the planner's dependency), an event is recorded there, and the
  destination's stream waits on that event before it scatters the moved
  accounts into its own planes — patch, then append, as the reference.

One semantic note: the sticky error plane is per shard in async mode, so
after an envelope error the OTHER shards keep executing their queued
windows instead of no-opping. The first errored (window, shard) cell in
collect order raises the same LaneEngineError either way, and the error
path aborts the stream.

Per-shard walls are CUDA events on each shard's stream, from its first
submit to the end of its last segment (host clock on the CPU); they feed
`wall_feed` and the per-shard telemetry.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from kme_tpu_torch.engine import seq as SQ
from kme_tpu_torch.native import sched as native_sched
from kme_tpu_torch.runtime.seqsession import SeqSession, make_seq_router
from kme_tpu_torch.runtime.session import LaneEngineError
from kme_tpu_torch.telemetry import PhaseTimer, Registry
from kme_tpu_torch.utils import pow2_bucket

# per-shard per-window message capacity (windows close earlier on
# account conflicts; 128 keeps the padded input planes small)
WINDOW_CAP = 128

# rebalance when the hottest shard's EWMA load exceeds the mean by
# this factor; migrating costs a full canonical round-trip of the lane
# state, so the trigger is deliberately above measurement noise
REBALANCE_THRESHOLD = 1.25
# per-batch decay of the per-lane load estimate
LOAD_EWMA_ALPHA = 0.5
# matchable messages (BUY/SELL) sweep makers; everything else is O(1)
MATCH_WORK_WEIGHT = 2.0

# wall-feed (async only, opt-in): EWMA decay and clip for the measured
# per-shard cost rate that scales the rebalancer's lane weights
WALL_RATE_ALPHA = 0.5
WALL_RATE_MIN, WALL_RATE_MAX = 0.5, 2.0

# communication costs for the dispatch-schedule simulation, in the
# same work units as the per-message weights. The lockstep scan pays a
# full cross-shard merge EVERY window; async pays the full merge only
# at barriers and batch-end collect, plus one point-to-point
# fetch+scatter per dependency patch.
MERGE_COST_WEIGHT = 0.5   # merge cost per participating shard
# host-side cost of one point-to-point dependency patch (the wait for
# the source shard's earlier windows is modeled separately)
PATCH_COST = 0.25

_MSG_FIELDS = ("act", "aid", "price", "size", "lane",
               "oid_lo", "oid_hi")

# the replicated state keys: migration does not permute these
_REPL_KEYS = ("bal_lo", "bal_hi", "bal_u", "err")


def make_mesh_state(local_cfg: SQ.SeqConfig, shards: int,
                    device="cuda") -> dict:
    """Global state: per-shard seq states stacked on the leading row axis
    for the sharded keys; balances/err replicated (the JAX package's
    layout, and the one `split_mesh_state` takes apart)."""
    local = SQ.make_seq_state(local_cfg, device)
    return {k: (v if k in _REPL_KEYS else v.repeat(shards, 1))
            for k, v in local.items()}


def split_mesh_state(state: dict, shards: int) -> List[dict]:
    """Stacked global state -> one local state per shard (replicated
    planes copied to every shard), each a fresh set of tensors."""
    return [{k: (v.clone() if k in _REPL_KEYS
                 else v.reshape(shards, -1, v.shape[-1])[s].clone())
             for k, v in state.items()} for s in range(shards)]


def _i64(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return (lo.to(torch.int64) & 0xFFFFFFFF) | (hi.to(torch.int64) << 32)


def _split64(v: torch.Tensor):
    # a narrowing conversion keeps the low 32 bits
    return v.to(torch.int32), (v >> 32).to(torch.int32)


def plan_rebalance(lane_load, perm, shards: int,
                   threshold: float = REBALANCE_THRESHOLD,
                   max_swaps: Optional[int] = None):
    """Pure placement decision: given the per-lane load EWMA and the
    current placement table, return a new table (or None for "stay").

    Greedy slot swaps between the hottest and coldest shard, accepted
    only while each swap STRICTLY reduces that pair's peak load, so the
    loop terminates and a balanced table is a fixed point. Fully
    deterministic (argmax/argmin first-index ties, no RNG)."""
    S = len(perm)
    Sl = S // shards
    total = float(lane_load.sum())
    if total <= 0.0:
        return None
    shard_loads = np.bincount(perm // Sl, weights=lane_load,
                              minlength=shards).astype(float)
    mean = total / shards
    if shard_loads.max() <= threshold * mean:
        return None
    new = perm.copy()
    budget = S if max_swaps is None else max_swaps
    swapped = False
    for _ in range(budget):
        h = int(shard_loads.argmax())
        c = int(shard_loads.argmin())
        if h == c:
            break
        # best single lane swap hot<->cold: minimize the pair's peak
        best = None
        for gh in range(S):
            if new[gh] // Sl != h:
                continue
            for gc in range(S):
                if new[gc] // Sl != c:
                    continue
                d = float(lane_load[gh]) - float(lane_load[gc])
                if d <= 0.0:
                    continue
                peak = max(shard_loads[h] - d, shard_loads[c] + d)
                if peak >= shard_loads[h]:
                    continue
                if best is None or peak < best[0]:
                    best = (peak, gh, gc, d)
        if best is None:
            break
        _, gh, gc, d = best
        new[gh], new[gc] = new[gc], new[gh]
        shard_loads[h] -= d
        shard_loads[c] += d
        swapped = True
    return new if swapped else None


@dataclasses.dataclass
class _Segment:
    """One kernel launch of a shard: its windows, the (kseg, out_rows,
    128) output planes on the device, and the header + fill-hint prefix
    of each, copied to the host (pinned, behind `done` on the card);
    `end` marks the end of a shard's last segment of the batch."""
    win_idx: List[int]
    out: torch.Tensor
    head: torch.Tensor
    done: Optional[object]
    ghint: int
    end: Optional[object] = None


class SeqMeshSession(SeqSession):
    """Sharded drop-in for SeqSession (fixed mode): the same process /
    process_wire / process_wire_buffer surface, the state split over
    `shards` shards on `device` (default the card; `device="cpu"` runs
    them one after another through the kernel's plain version).

    `dispatch` selects the discipline: "async" (the default; "auto" is
    the same) or "lockstep" (module docstring); both give byte-identical
    MatchOut. `wall_feed=True` (async only) feeds measured per-shard
    walls into the rebalancer's lane-load EWMA as a per-shard cost rate —
    placement changes, bytes don't.

    `phases` holds cumulative host seconds: plan_s (route,
    `plan_windows`, `plan_dispatch`), rebalance_s (`plan_rebalance`),
    migrate_s, dispatch_s (which holds slice_s, stage_s, launch_s,
    patch_s and merge_s), fetch_s and recon_s."""

    def __init__(self, cfg: SQ.SeqConfig, shards: int, *,
                 rebalance: bool = True,
                 rebalance_threshold: float = REBALANCE_THRESHOLD,
                 dispatch: str = "auto",
                 wall_feed: bool = False,
                 device="cuda") -> None:
        if cfg.compat != "fixed":
            raise ValueError(
                "sharded seq serving is fixed-mode only (java mode is "
                "single-chip by Q11's serial semantics, COMPAT.md)")
        if cfg.hbm_books:
            raise ValueError("seq mesh uses VMEM books per shard")
        if cfg.lanes % shards:
            raise ValueError(f"lanes {cfg.lanes} not divisible by "
                             f"{shards} shards")
        if dispatch not in ("auto", "async", "lockstep"):
            raise ValueError(f"unknown dispatch mode {dispatch!r}")
        self.cfg = cfg
        self.shards = shards
        self.local_cfg = SQ.SeqConfig(
            lanes=cfg.lanes // shards, slots=cfg.slots,
            accounts=cfg.accounts, max_fills=cfg.max_fills,
            batch=WINDOW_CAP, pos_cap=cfg.pos_cap,
            fill_cap=cfg.fill_cap, probe_max=cfg.probe_max)
        self.S_local = cfg.lanes // shards
        self.device = SQ.resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._streams = [torch.cuda.Stream(self.device) if self._cuda
                         else None for _ in range(shards)]
        # the shards' states; `state` (the single session's) stays None
        self._shard_states = split_mesh_state(
            make_mesh_state(self.local_cfg, shards, self.device), shards)
        self.state = None
        self.router = make_seq_router(cfg.lanes, cfg.accounts)
        self._metrics = np.zeros(SQ.N_METRICS, np.int64)
        self._hist = np.zeros((SQ.N_HIST, SQ.N_HIST_BUCKETS), np.int64)
        self._recon = None
        self.last_reasons = None
        self.telemetry = Registry()
        self.timer = PhaseTimer(track="seqmesh")
        self.phases = self.timer.totals   # cumulative across batches
        self._use_native_wire = True
        # fill groups per cell in the first output copy (grows to the
        # observed high-water mark)
        self._ghint = 8
        # elastic placement: global lane -> global slot; shard of a
        # lane is perm[lane] // S_local, its kernel row perm[lane] %
        # S_local. Identity == the static layout.
        self.rebalance = rebalance
        self.rebalance_threshold = rebalance_threshold
        self._perm = np.arange(cfg.lanes, dtype=np.int64)
        self._lane_load = np.zeros(cfg.lanes, np.float64)
        # sticky account home: last GLOBAL LANE the account traded on
        # (tracked as a lane, not a shard, so homes follow migrations)
        self._acct_lane: Dict[int, int] = {}
        self._migrations = 0
        self._rebalances = 0
        self._occ_shard = np.zeros(shards, np.int64)
        self._hist_shard = np.zeros(
            (shards, SQ.N_HIST, SQ.N_HIST_BUCKETS), np.int64)
        self.dispatch = "async" if dispatch == "auto" else dispatch
        self.wall_feed = wall_feed
        self._bal_shape = (self.local_cfg.arows, SQ.LN)
        self._shard_rate = np.ones(shards, np.float64)
        # deterministic stall schedule accumulators (plan_dispatch)
        self._sim_busy = np.zeros(shards, np.float64)
        self._sim_T_async = 0.0
        self._sim_T_lock = 0.0
        # measured per-shard walls + H2D overlap accounting
        self._msgs_total = 0
        self._async_wall_total = 0.0
        self._h2d_total_s = 0.0
        self._h2d_overlap_s = 0.0
        self._seg_inflight = 0
        self._t0_shard: List[Optional[object]] = [None] * shards
        self._t_end = 0.0
        # kernel launches (one per segment), in all and per shard, and
        # the per-shard walls (s) of the last batch and of all batches
        self.dispatches = 0
        self.shard_dispatches = np.zeros(shards, np.int64)
        self.last_walls = np.zeros(shards, np.float64)
        self.walls_total = np.zeros(shards, np.float64)

    # -- streams -------------------------------------------------------

    def _on(self, s: int):
        """Shard s's stream as the current stream (nothing on the CPU)."""
        if self._cuda:
            return torch.cuda.stream(self._streams[s])
        return contextlib.nullcontext()

    def _fork(self) -> None:
        """Every shard stream waits for the current stream's work."""
        if self._cuda:
            cur = torch.cuda.current_stream(self.device)
            for st in self._streams:
                st.wait_stream(cur)

    def _join(self) -> None:
        """The current stream waits for every shard stream's work: after
        this, work on the current stream (a host copy, a merge) sees
        every shard's state."""
        if self._cuda:
            cur = torch.cuda.current_stream(self.device)
            for st in self._streams:
                cur.wait_stream(st)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A host array onto the device on the current stream without
        blocking the host behind it (pinned, asynchronous)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if not self._cuda:
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _push(self, s: int, planes: dict) -> None:
        """Copy merged planes (made on the current stream) into shard
        s's state on s's stream, after the merge."""
        st = self._shard_states[s]
        if self._cuda:
            stream = self._streams[s]
            stream.wait_stream(torch.cuda.current_stream(self.device))
            for v in planes.values():
                v.record_stream(stream)
        with self._on(s):
            for k, v in planes.items():
                st[k].copy_(v)

    # -- host planning -------------------------------------------------

    def plan_windows(self, cols):
        """Columnar routed messages -> (wins dict of (K, shards*Bw) i32,
        placements list of (k, window, shard, pos) per routed message,
        cnts (K, shards) int, K).

        A lane's shard and kernel row come from the elastic placement
        table (`_perm`, applied once per batch via
        native_sched.apply_placement). Laneless balance messages
        (CREATE/TRANSFER) follow the account's sticky home lane, the
        last lane it traded on — tracked as a LANE so a migration
        re-pins the account to the lane's new shard and the window
        invariant survives rebalancing. A per-message Python loop: the
        semantics authority, copied as the JAX package has it."""
        n = len(cols["act"])
        Bw = WINDOW_CAP
        acts = cols["act"]
        lanes = cols["lane"]
        aids = cols["aid"]
        _, shard_col, local_col = native_sched.apply_placement(
            self._perm, lanes, self.S_local)
        barrier = ((acts == SQ.L_PAYOUT_YES) | (acts == SQ.L_PAYOUT_NO)
                   | (acts == SQ.L_REMOVE_SYMBOL))
        laneful = ((acts == SQ.L_BUY) | (acts == SQ.L_SELL)
                   | (acts == SQ.L_CANCEL) | (acts == SQ.L_ADD_SYMBOL)
                   | barrier)
        # only balance-touching acts bind their account to a shard
        # (ADD_SYMBOL routes with aid=0 but never touches balances)
        binds = ((acts == SQ.L_BUY) | (acts == SQ.L_SELL)
                 | (acts == SQ.L_CANCEL) | (acts == SQ.L_CREATE)
                 | (acts == SQ.L_TRANSFER))
        windows: List[List[List[int]]] = []  # [w][s] -> routed indices
        placements = []
        bound: Dict[int, int] = {}
        cur = [[] for _ in range(self.shards)]

        def flush():
            nonlocal cur, bound
            if any(cur[s] for s in range(self.shards)):
                windows.append(cur)
            cur = [[] for _ in range(self.shards)]
            bound = {}

        for k in range(n):
            if barrier[k]:
                # barriers credit many accounts: run alone
                flush()
                cur[int(shard_col[k])].append(k)
                flush()
                continue
            a = int(aids[k])
            if laneful[k]:
                s = int(shard_col[k])
                if binds[k]:
                    self._acct_lane[a] = int(lanes[k])
            else:
                s = bound.get(a, self._home_shard(a))
            b = bound.get(a) if binds[k] else None
            if (b is not None and b != s) or len(cur[s]) >= Bw:
                flush()
            if binds[k]:
                bound[a] = s
            cur[s].append(k)
        flush()

        K = pow2_bucket(max(len(windows), 1), lo=1)
        wins = {f: np.zeros((K, self.shards, Bw), np.int32)
                for f in _MSG_FIELDS}
        cnts = np.zeros((K, self.shards), np.int32)
        for w, per in enumerate(windows):
            for s, idxs in enumerate(per):
                cnts[w, s] = len(idxs)
                for p, k in enumerate(idxs):
                    placements.append((k, w, s, p))
                    wins["act"][w, s, p] = cols["act"][k]
                    wins["aid"][w, s, p] = cols["aid"][k]
                    wins["price"][w, s, p] = cols["price"][k]
                    wins["size"][w, s, p] = cols["size"][k]
                    wins["lane"][w, s, p] = int(local_col[k])
                    oid = int(cols["oid"][k])
                    lo = oid & 0xFFFFFFFF
                    wins["oid_lo"][w, s, p] = np.int32(
                        lo - (1 << 32) if lo >= 1 << 31 else lo)
                    wins["oid_hi"][w, s, p] = np.int32(oid >> 32)
        wins = {f: v.reshape(K, self.shards * WINDOW_CAP)
                for f, v in wins.items()}
        placements.sort()
        return wins, placements, cnts, K

    # -- the SeqSession contract ---------------------------------------

    def _run(self, msgs):
        if self.dispatch == "async":
            return self._run_async(msgs)
        return self._run_lockstep(msgs)

    def _stage_and_dispatch(self, s: int, win_idx: List[int],
                            seg: dict) -> _Segment:
        """Launch one window segment on shard s's stream: its message
        planes go over in one pinned asynchronous copy on that stream,
        then one `seq_scan` (its scratch and output allocated on that
        stream), then the header + fill-hint prefix of its output planes
        copied back into pinned memory behind an event. Nothing here
        waits for the card. H2D staging time counts as overlapped when an
        earlier segment since the last full merge is in flight."""
        t0 = time.perf_counter()
        packed = np.stack([seg[f] for f in SQ.MSG_FIELDS])  # (7, kseg, Bw)
        kseg = packed.shape[1]
        ghint = min(pow2_bucket(self._ghint, lo=1),
                    self.local_cfg.fill_cap // SQ.LN)
        rows = SQ.hdr_rows(self.local_cfg) + 5 * ghint
        with self._on(s):
            if self._t0_shard[s] is None:
                if self._cuda:
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    self._t0_shard[s] = ev
                else:
                    self._t0_shard[s] = t0
            dev = self._to_device(packed)
            t1 = time.perf_counter()
            out = SQ.seq_scan(self.local_cfg, self._shard_states[s],
                              dict(zip(SQ.MSG_FIELDS, dev.unbind(0))))
            self.dispatches += 1
            self.shard_dispatches[s] += 1
            done = None
            if self._cuda:
                head = torch.empty((kseg, rows, SQ.LN), dtype=torch.int32,
                                   pin_memory=True)
                head.copy_(out[:, :rows], non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                head = out[:, :rows]
        dt = t1 - t0
        self.timer.add("stage_s", dt)
        self.timer.add("launch_s", time.perf_counter() - t1)
        self._h2d_total_s += dt
        if self._seg_inflight:
            self._h2d_overlap_s += dt
        self._seg_inflight += 1
        return _Segment(list(win_idx), out, head, done, ghint)

    def _fetch_cells(self, segs: List[List[_Segment]]) -> dict:
        """Wait for each segment's early copy; -> {(w, s): host plane}
        holding at least the header and the cell's used fill groups (a
        cell whose fills overflow the hint is copied again, whole, on its
        shard's stream)."""
        HR = SQ.hdr_rows(self.local_cfg)
        nrows = SQ.out_rows(self.local_cfg)
        out_map = {}
        for s, shard_segs in enumerate(segs):
            for seg in shard_segs:
                if seg.done is not None:
                    seg.done.synchronize()
                host = seg.head.numpy()
                for i, w in enumerate(seg.win_idx):
                    plane = host[i]
                    gneed = -(-max(int(plane[0, 1]), 1) // SQ.LN)
                    self._ghint = max(self._ghint, gneed)
                    if gneed > seg.ghint:
                        with self._on(s):
                            plane = seg.out[i, :min(HR + 5 * gneed,
                                                    nrows)].cpu().numpy()
                    out_map[(w, s)] = plane
        return out_map

    def _run_lockstep(self, msgs):
        # migrations happen BETWEEN batches only: state is quiescent
        # here, so the permutation is a pure relabeling of lane rows
        self._maybe_rebalance()

        with self.timer.phase("plan_s"):
            cols, host_rejects = self.router.route(msgs)
            self._note_load(cols)
            wins, placements, cnts, K = self.plan_windows(cols)

        t_disp = time.perf_counter()
        with self.timer.phase("dispatch_s"):
            segs = self._dispatch_lockstep(wins, cnts)

        with self.timer.phase("fetch_s"):
            out_map = self._fetch_cells(segs)
            self._shard_walls(segs)
            self._join()
            disp_wall = time.perf_counter() - t_disp
            host, fills = self._unpack_outputs(cols, placements, cnts, K,
                                               out_map)
            self._publish_shard_telemetry(
                disp_wall, cnts.sum(axis=0).astype(np.int64))
        return cols, host_rejects, host, fills

    def _dispatch_lockstep(self, wins, cnts) -> List[List[_Segment]]:
        """Per window: every occupied shard's kernel on its stream, then
        the streams joined and the balance planes merged exactly (module
        docstring) and pushed to every shard (`merge_s`)."""
        S = self.shards
        segs: List[List[_Segment]] = [[] for _ in range(S)]
        self._t0_shard = [None] * S
        self._seg_inflight = 0
        self._fork()
        # every shard holds the same replicated planes between windows
        base = {k: self._shard_states[0][k].clone() for k in _REPL_KEYS}
        for w in range(cnts.shape[0]):
            occ = [s for s in range(S) if cnts[w, s]]
            if not occ:
                continue
            for s in occ:
                seg = native_sched.slice_windows(wins, [w], s, S, WINDOW_CAP)
                segs[s].append(self._stage_and_dispatch(s, [w], seg))
            with self.timer.phase("merge_s"):
                base = self._merge_window(occ, base)
                for s in range(S):
                    self._push(s, base)
        self._mark_ends(segs)
        return segs

    def _merge_window(self, occ: List[int], base: dict) -> dict:
        """The lockstep merge on the current stream after the occupied
        shards' streams: old + sum of each shard's int64 delta, bal_u the
        start plus the summed deltas, err the max."""
        cur = torch.cuda.current_stream(self.device) if self._cuda else None
        old = _i64(base["bal_lo"], base["bal_hi"])
        total = old.clone()
        used = base["bal_u"].clone()
        err = base["err"].clone()
        for s in occ:
            if cur is not None:
                cur.wait_stream(self._streams[s])
            st = self._shard_states[s]
            total += _i64(st["bal_lo"], st["bal_hi"]) - old
            used += st["bal_u"] - base["bal_u"]
            err = torch.maximum(err, st["err"])
        lo, hi = _split64(total)
        return {"bal_lo": lo, "bal_hi": hi, "bal_u": used, "err": err}

    # -- async dispatch ------------------------------------------------

    def _run_async(self, msgs):
        self._maybe_rebalance()

        with self.timer.phase("plan_s"):
            cols, host_rejects = self.router.route(msgs)
            self._note_load(cols)
            wins, placements, cnts, K = self.plan_windows(cols)
            plan = self.plan_dispatch(cols, placements)

        with self.timer.phase("dispatch_s"):
            t_disp = time.perf_counter()
            segs = self._dispatch_async(wins, cnts, plan)

        with self.timer.phase("fetch_s"):
            out_map = self._fetch_cells(segs)
            walls = self._shard_walls(segs)
            self._join()
            disp_wall = time.perf_counter() - t_disp
            host, fills = self._unpack_outputs(
                cols, placements, cnts, K, out_map)
            occ = cnts.sum(axis=0).astype(np.int64)
            self._sim_busy += plan["busy"]
            self._sim_T_async += plan["T_async"]
            self._sim_T_lock += plan["T_lock"]
            self._msgs_total += int(occ.sum())
            if walls.size:
                self._async_wall_total += float(walls.max())
            if self.wall_feed:
                self._update_wall_rates(walls, plan["busy"])
            self._publish_shard_telemetry_async(walls, occ, disp_wall)
        return cols, host_rejects, host, fills

    def _owner_sel(self, loc: Dict[int, int],
                   base: Optional[int]) -> np.ndarray:
        """Per-account owner-shard selection table for a full merge:
        account a's authoritative balance copy lives on loc[a], else on
        `base` (the shard the last barrier ran on), else anywhere (all
        shards identical since the previous merge — pick 0)."""
        sel = np.zeros(self._bal_shape[0] * self._bal_shape[1],
                       np.int32)
        if base:
            sel[:] = base
        for a, s in loc.items():
            sel[a] = s
        return sel

    def plan_dispatch(self, cols, placements) -> dict:
        """Pure host planning for async dispatch. One walk over the
        batch's windows in stream order derives:

        - `deps[(w, s)]`: the point-to-point dependency set — accounts
          bound to shard s in window w whose authoritative balance copy
          currently lives on another shard;
        - `merge_sel[w]` / `final_sel`: owner-selection tables for the
          full merges at barrier windows and batch-end collect;
        - a deterministic stall schedule for BOTH dispatch modes, with
          per-message weighted costs (MATCH_WORK_WEIGHT) plus
          communication terms (MERGE_COST_WEIGHT / PATCH_COST): async —
          per-shard clocks plus a host clock that blocks on the source
          shard (+ one patch cost) at each dependency, a full merge at
          barriers and batch end only; lockstep — every window is a
          global barrier AND a full merge. chip_stall_frac derives from
          this schedule, so it is replay-stable and device-independent.
        """
        acts = cols["act"]
        aids = cols["aid"]
        S = self.shards
        W = placements[-1][1] + 1 if placements else 0
        barrier_acts = (SQ.L_PAYOUT_YES, SQ.L_PAYOUT_NO,
                        SQ.L_REMOVE_SYMBOL)
        bind_acts = (SQ.L_BUY, SQ.L_SELL, SQ.L_CANCEL, SQ.L_CREATE,
                     SQ.L_TRANSFER)
        cost = np.zeros((W, S))
        binds_w: List[List] = [[] for _ in range(W)]
        barriers: Dict[int, int] = {}
        for k, w, s, _ in placements:
            act = int(acts[k])
            if act in barrier_acts:
                barriers[w] = s
            cost[w, s] += (MATCH_WORK_WEIGHT
                           if act in (SQ.L_BUY, SQ.L_SELL) else 1.0)
            if act in bind_acts:
                binds_w[w].append((int(aids[k]), s))
        deps: Dict[tuple, list] = {}
        merge_sel: Dict[int, np.ndarray] = {}
        loc: Dict[int, int] = {}
        base: Optional[int] = None
        clock = np.zeros(S)
        busy = np.zeros(S)
        host_t = 0.0
        t_lock = 0.0
        m_full = MERGE_COST_WEIGHT * S   # one full merge
        for w in range(W):
            # lockstep: barrier + merge every window
            t_lock += float(cost[w].max()) + m_full
            bs = barriers.get(w)
            if bs is not None:
                # full merge: host waits for every shard, pays ONE
                # merge, then the barrier cell runs alone
                merge_sel[w] = self._owner_sel(loc, base)
                t = max(float(clock.max()), host_t) + m_full
                clock[:] = t
                host_t = t
                clock[bs] = t + float(cost[w, bs])
                busy[bs] += float(cost[w, bs])
                loc = {}
                base = bs
                continue
            cell_deps: Dict[tuple, Dict[int, int]] = {}
            for a, s in binds_w[w]:
                src = loc.get(a, base)
                if src is not None and src != s:
                    cell_deps.setdefault((w, s), {})[a] = src
            for key, d in cell_deps.items():
                deps[key] = sorted(d.items())
            # dependency patches read the SOURCE shard as of window w-1
            # (the dispatcher patches before appending w to any queue),
            # so dependency waits use the pre-window clocks: every cell
            # starts no later than the lockstep barrier max
            prev = clock.copy()
            for s in range(S):
                c = float(cost[w, s])
                if c <= 0.0:
                    continue
                dl = cell_deps.get((w, s))
                if dl:
                    for src in sorted(set(dl.values())):
                        host_t = (max(host_t, float(prev[src]))
                                  + PATCH_COST)
                    start = max(float(prev[s]), host_t)
                else:
                    start = float(prev[s])
                clock[s] = start + c
                busy[s] += c
            for a, s in binds_w[w]:
                loc[a] = s
        return {
            "W": W, "deps": deps, "barriers": barriers,
            "merge_sel": merge_sel,
            "final_sel": self._owner_sel(loc, base),
            "busy": busy,
            # batch-end collect pays async's one deferred merge
            "T_async": ((max(float(clock.max()), host_t) + m_full)
                        if W else 0.0),
            "T_lock": t_lock,
        }

    def _snapshot(self, src: int) -> tuple:
        """A copy of shard src's balance planes taken on src's stream
        right behind what src has queued, and the event behind it: what a
        destination patches from."""
        with self.timer.phase("patch_s"), self._on(src):
            st = self._shard_states[src]
            snap = torch.stack([st[k] for k in SQ.BAL_KEYS])
            ev = None
            if self._cuda:
                ev = torch.cuda.Event()
                ev.record()
        return snap, ev

    def _patch_shard(self, s: int, accs: np.ndarray, snap: tuple) -> None:
        """Scatter the forwarded accounts' balances from a source
        snapshot into shard s's replicated planes, on s's stream after
        the snapshot's event (nothing waits on the host)."""
        planes, ev = snap
        st = self._shard_states[s]
        with self.timer.phase("patch_s"), self._on(s):
            if self._cuda:
                stream = self._streams[s]
                stream.wait_event(ev)
                planes.record_stream(stream)
            idx = self._to_device(accs)
            vals = planes.reshape(len(SQ.BAL_KEYS), -1).index_select(1, idx)
            for j, k in enumerate(SQ.BAL_KEYS):
                st[k].view(-1).index_copy_(0, idx, vals[j])

    def _collect_merge(self, sel: np.ndarray) -> None:
        """FULL merge (barrier window or batch end): on the current
        stream after every shard stream, select each account's
        authoritative balance copy per `sel`, max-merge the sticky error,
        and push the merged planes to every shard on its own stream."""
        with self.timer.phase("merge_s"):
            self._join()
            sts = self._shard_states
            merged = SQ.select_balances_t(
                sts, self._to_device(sel.astype(np.int64)))
            merged["err"] = torch.stack([st["err"] for st in sts]).amax(0)
            for s in range(self.shards):
                self._push(s, merged)
        self._seg_inflight = 0

    def _dispatch_async(self, wins, cnts, plan) -> List[List[_Segment]]:
        """Walk the batch's windows in stream order, buffering each
        shard's windows into its own submission queue and flushing a
        queue only when forced: a dependency (point-to-point — the
        source's planes copied on its stream right behind its flushed
        windows, the moved accounts scattered into the destination on
        the destination's stream), a barrier (full merge), or batch end.
        Shards without dependencies run arbitrarily far ahead."""
        Bw = WINDOW_CAP
        S = self.shards
        pend: List[List[int]] = [[] for _ in range(S)]
        segs: List[List[_Segment]] = [[] for _ in range(S)]
        fetched: Dict[int, tuple] = {}
        self._t0_shard = [None] * S
        self._seg_inflight = 0
        self._fork()

        def flush(s):
            if not pend[s]:
                return
            win_idx, pend[s] = pend[s], []
            fetched.pop(s, None)
            with self.timer.phase("slice_s"):
                seg = native_sched.slice_windows(wins, win_idx, s, S, Bw)
            segs[s].append(self._stage_and_dispatch(s, win_idx, seg))

        def planes_of(src):
            # the snapshot is valid while src has received no further
            # windows: any pending (or patched — see the explicit pops)
            # work invalidates it
            if pend[src] or src not in fetched:
                flush(src)
                fetched[src] = self._snapshot(src)
            return fetched[src]

        for w in range(plan["W"]):
            bs = plan["barriers"].get(w)
            if bs is not None:
                for s in range(S):
                    flush(s)
                self._collect_merge(plan["merge_sel"][w])
                fetched.clear()
                pend[bs].append(w)
                flush(bs)
                continue
            # pass 1 — dependency patches BEFORE window w is appended to
            # ANY queue: the source flush inside planes_of therefore only
            # covers windows <= w-1, matching the stall schedule's
            # prev-clock dependency waits. Patch-then-append keeps the
            # destination's scatter ordered after its own w-1 segment by
            # stream order.
            for s in range(S):
                if not cnts[w, s]:
                    continue
                dl = plan["deps"].get((w, s))
                if not dl:
                    continue
                flush(s)
                by_src: Dict[int, list] = {}
                for a, src in dl:
                    by_src.setdefault(src, []).append(a)
                for src in sorted(by_src):
                    accs = np.fromiter(by_src[src], np.int64,
                                       len(by_src[src]))
                    self._patch_shard(s, accs, planes_of(src))
                fetched.pop(s, None)
            # pass 2 — enqueue window w on every occupied shard
            for s in range(S):
                if cnts[w, s]:
                    pend[s].append(w)
        for s in range(S):
            flush(s)
        self._mark_ends(segs)
        self._collect_merge(plan["final_sel"])
        return segs

    def _mark_ends(self, segs) -> None:
        """Mark the end of each shard's last segment, for its wall."""
        if not self._cuda:
            self._t_end = time.perf_counter()
            return
        for s, stream in enumerate(self._streams):
            if segs[s]:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(stream)
                segs[s][-1].end = ev

    def _shard_walls(self, segs) -> np.ndarray:
        """Each shard's wall in the batch, first submit to the end of its
        last segment: CUDA events on its stream (host clock on the CPU,
        where the shards run one after another)."""
        walls = np.zeros(self.shards, np.float64)
        for s in range(self.shards):
            t0 = self._t0_shard[s]
            if t0 is None:
                continue
            if self._cuda:
                end = segs[s][-1].end
                end.synchronize()
                walls[s] = t0.elapsed_time(end) / 1e3
            else:
                walls[s] = self._t_end - t0
        self.last_walls = walls
        self.walls_total += walls
        return walls

    def _unpack_outputs(self, cols, placements, cnts, K, out_map):
        """Collect, both modes: per-(window, shard) header and fill rows
        from `out_map` -> the per-message host dict and the fills in
        message order. Raises at the first errored cell in (w, s)
        order."""
        HR = SQ.hdr_rows(self.local_cfg)
        n = len(cols["act"])
        host = {k: np.zeros(n, dt) for k, dt in
                (("ok", bool), ("cap_reject", bool),
                 ("append", bool), ("residual", np.int64),
                 ("nfill", np.int64), ("prev_oid", np.int64))}
        groups = {}
        mets = np.zeros(SQ.N_METRICS, np.int64)
        # batch_occupancy convention: per-(window, shard) kernel cells
        # are the dispatch units here, so batch_occupancy observes one
        # observation per non-empty (w, s) cell, valued at that cell's
        # message count — the same counters accumulate per shard into
        # _hist_shard (batch_occupancy_shard{N})
        hists = np.zeros((SQ.N_HIST, SQ.N_HIST_BUCKETS), np.int64)
        for w in range(K):
            for s in range(self.shards):
                cnt = int(cnts[w, s])
                if not cnt:
                    continue
                cell = out_map[(w, s)]
                res = SQ.unpack_hdr(self.local_cfg, cell[:HR], cnt)
                if res["err"] != SQ.LERR_OK:
                    raise LaneEngineError(res["err"])
                ft = res["fill_total"]
                gr = cell[HR:HR + 5 * (-(-max(ft, 1) // 128))]
                groups[(w, s)] = (res, SQ.unpack_fills(gr, ft),
                                  np.concatenate(
                                      ([0], np.cumsum(res["nfill"]))))
                mets += res["metrics"]
                hists += res["hist"]
                self._hist_shard[s] += res["hist"]
        self._metrics += mets
        self._hist += hists
        fills_parts = []
        for k, w, s, p in placements:
            res, fills_ws, off = groups[(w, s)]
            for key in host:
                host[key][k] = res[key][p]
            if res["nfill"][p]:
                fills_parts.append(fills_ws[:, off[p]:off[p + 1]])
        fills = (np.concatenate(fills_parts, axis=1) if fills_parts
                 else np.zeros((4, 0), np.int64))
        return host, fills

    def _update_wall_rates(self, walls, busy) -> None:
        """Fold measured per-shard walls into the per-shard cost-rate
        EWMA (wall_feed=True): a shard whose wall exceeds its planned
        busy share is slower, so its lanes weigh more in the rebalancer.
        Bytes are unaffected — placement only moves work."""
        act = (busy > 0) & (walls > 0)
        if int(act.sum()) < 2:
            return
        r = ((walls[act] / walls[act].mean())
             / (busy[act] / busy[act].mean()))
        rate = np.ones(self.shards, np.float64)
        rate[act] = np.clip(r, WALL_RATE_MIN, WALL_RATE_MAX)
        self._shard_rate = np.clip(
            WALL_RATE_ALPHA * rate
            + (1.0 - WALL_RATE_ALPHA) * self._shard_rate,
            WALL_RATE_MIN, WALL_RATE_MAX)

    def _publish_common(self) -> None:
        reg = self.telemetry
        reg.gauge("shard_count", "mesh shard count").set(self.shards)
        reg.counter("shard_migrations_total",
                    "lane slots moved by elastic placement"
                    ).set(self._migrations)
        reg.counter("shard_rebalances_total",
                    "between-batch rebalance events"
                    ).set(self._rebalances)
        tot = int(self._occ_shard.sum())
        if tot:
            reg.gauge(
                "shard_imbalance",
                "max/mean per-shard cumulative occupancy").set(
                round(float(self._occ_shard.max())
                      * self.shards / tot, 4))
        for s in range(self.shards):
            reg.gauge(f"shard{s}_occupancy",
                      "cumulative messages executed on shard").set(
                int(self._occ_shard[s]))

    def _publish_shard_telemetry_async(self, walls, occ,
                                       disp_wall: float) -> None:
        """Async-mode telemetry: measured per-shard walls feed the
        device_shard{N} histograms, plus the deterministic
        stall-schedule gauges and the H2D overlap fraction."""
        self._occ_shard += occ
        self._publish_common()
        reg = self.telemetry
        for s in range(self.shards):
            if int(occ[s]) and walls[s] > 0:
                reg.latency(
                    f"device_shard{s}",
                    "measured per-shard dispatch wall").observe(
                    float(walls[s]), n=int(occ[s]))
        stats = self.stall_stats()
        if self._sim_T_async > 0:
            reg.gauge(
                "chip_stall_frac",
                "stall fraction of the async dispatch schedule "
                "(deterministic, weighted-cost)").set(
                stats["chip_stall_frac"])
            for s in range(self.shards):
                reg.gauge(
                    f"shard{s}_stall_frac",
                    "per-shard stall fraction (async schedule)").set(
                    round(1.0 - float(self._sim_busy[s])
                          / self._sim_T_async, 4))
        if self._sim_T_lock > 0:
            reg.gauge(
                "chip_stall_frac_lockstep",
                "stall fraction the lockstep schedule would incur on "
                "the same batches").set(stats["chip_stall_frac_lockstep"])
        if self._async_wall_total > 0:
            reg.gauge(
                "chip_msgs_per_sec",
                "messages per second of measured async dispatch wall"
                ).set(stats["chip_msgs_per_sec"])
        if self._h2d_total_s > 0:
            reg.gauge(
                "h2d_overlap_frac",
                "fraction of H2D staging time overlapped under "
                "in-flight device compute").set(stats["h2d_overlap_frac"])

    def stall_stats(self) -> dict:
        """Report surface for the deterministic stall schedule."""
        tot_busy = float(self._sim_busy.sum())
        S = self.shards
        return {
            "chip_stall_frac": (
                round(1.0 - tot_busy / (S * self._sim_T_async), 4)
                if self._sim_T_async > 0 else 0.0),
            "chip_stall_frac_lockstep": (
                round(1.0 - tot_busy / (S * self._sim_T_lock), 4)
                if self._sim_T_lock > 0 else 0.0),
            "h2d_overlap_frac": (
                round(self._h2d_overlap_s / self._h2d_total_s, 4)
                if self._h2d_total_s > 0 else 0.0),
            "chip_msgs_per_sec": (
                round(self._msgs_total / self._async_wall_total, 2)
                if self._async_wall_total > 0 else 0.0),
        }

    # -- elastic placement ---------------------------------------------

    def _home_shard(self, a: int) -> int:
        """Shard for a laneless balance message: the account's sticky
        home lane's CURRENT shard under the placement table, falling
        back to the static hash for accounts that never traded."""
        g = self._acct_lane.get(a)
        if g is None:
            return a % self.shards
        return int(self._perm[g]) // self.S_local

    def _note_load(self, cols) -> None:
        """Fold this batch's routed messages into the per-lane load
        EWMA. Matchable messages (BUY/SELL) weigh more: a taker can
        sweep up to max_fills makers, everything else is O(1)."""
        acts = cols["act"]
        laneful = ((acts == SQ.L_BUY) | (acts == SQ.L_SELL)
                   | (acts == SQ.L_CANCEL) | (acts == SQ.L_ADD_SYMBOL)
                   | (acts == SQ.L_PAYOUT_YES)
                   | (acts == SQ.L_PAYOUT_NO)
                   | (acts == SQ.L_REMOVE_SYMBOL))
        w = np.where((acts == SQ.L_BUY) | (acts == SQ.L_SELL),
                     MATCH_WORK_WEIGHT, 1.0)
        batch = np.bincount(
            cols["lane"][laneful].astype(np.int64),
            weights=w[laneful], minlength=self.cfg.lanes)
        if self.wall_feed and self.dispatch == "async":
            # measured per-shard walls feed the rebalancer: scale each
            # lane's weight by its CURRENT shard's cost rate
            batch = batch * self._shard_rate[
                (self._perm // self.S_local).astype(np.int64)]
        self._lane_load = (LOAD_EWMA_ALPHA * batch
                           + (1.0 - LOAD_EWMA_ALPHA) * self._lane_load)

    def _maybe_rebalance(self) -> None:
        if not self.rebalance or self.shards == 1:
            return
        with self.timer.phase("rebalance_s"):
            new = plan_rebalance(self._lane_load, self._perm, self.shards,
                                 threshold=self.rebalance_threshold)
        if new is None:
            return
        with self.timer.phase("migrate_s"):
            moved = self._migrate(new)
        if moved:
            self._rebalances += 1
            self._migrations += moved

    def _canons(self) -> List[dict]:
        """Each shard's canonical export (a quiescent read: the current
        stream first waits for every shard stream)."""
        self._join()
        return [SQ.export_canonical(self.local_cfg, st)
                for st in self._shard_states]

    def _migrate(self, new_perm) -> int:
        """Permute the sharded lane axis of the state to the new
        placement. Lane state moves WHOLESALE through the engine's
        canonical codec (export_canonical / import_canonical per shard,
        card -> host -> card): books, per-lane seq counters, and the
        lane-keyed position hash are re-keyed for the destination
        shard's local lane stride, while the replicated balance planes
        are untouched — so the migrated state replays byte-identically.
        Runs between batches only, where every shard's replicated planes
        are identical. Returns the number of lanes that changed slot."""
        old_perm = self._perm
        moved = int((new_perm != old_perm).sum())
        if not moved:
            return 0
        Sl, A = self.S_local, self.local_cfg.accounts
        canons = self._canons()
        # inverse of the NEW table: which global lane lands in slot g
        inv_new = np.empty_like(new_perm)
        inv_new[new_perm] = np.arange(len(new_perm),
                                      dtype=new_perm.dtype)
        parts = []
        for s in range(self.shards):
            src = []   # (old_shard, old_row) feeding each local row
            for r in range(Sl):
                g = int(inv_new[s * Sl + r])
                o = int(old_perm[g])
                src.append((o // Sl, o % Sl))
            tgt = dict(canons[0])   # replicated planes from shard 0
            for key in ("slot_oid", "slot_aid", "slot_price",
                        "slot_size", "slot_seq", "slot_used"):
                tgt[key] = np.stack(
                    [canons[ss][key][rr] for ss, rr in src])
            tgt["seq"] = np.stack(
                [canons[ss]["seq"][rr] for ss, rr in src])
            tgt["book_exists"] = np.stack(
                [canons[ss]["book_exists"][rr] for ss, rr in src])
            for key in ("pos_amt", "pos_avail"):
                tgt[key] = np.stack(
                    [canons[ss][key].reshape(Sl, A)[rr]
                     for ss, rr in src]).reshape(-1)
            parts.append(SQ.import_canonical(self.local_cfg, tgt,
                                             self.device))
        self._shard_states = parts
        self._perm = new_perm
        return moved

    # -- per-shard telemetry -------------------------------------------

    def _publish_shard_telemetry(self, disp_wall: float, occ) -> None:
        """Lockstep straggler attribution: each shard is charged an
        occupancy-weighted share of the batch's dispatch wall.
        shard_imbalance = cumulative max/mean per-shard occupancy (1.0 ==
        perfectly balanced)."""
        self._occ_shard += occ
        self._publish_common()
        reg = self.telemetry
        btot = int(occ.sum())
        for s in range(self.shards):
            if btot and int(occ[s]):
                reg.latency(
                    f"device_shard{s}",
                    "occupancy-weighted device wall share").observe(
                    disp_wall * float(occ[s]) / btot, n=int(occ[s]))

    def shard_stats(self) -> dict:
        """Report surface: per-shard occupancy + imbalance."""
        tot = int(self._occ_shard.sum())
        return {
            "shards": self.shards,
            "occupancy": self._occ_shard.tolist(),
            "imbalance": (round(float(self._occ_shard.max())
                                * self.shards / tot, 4)
                          if tot else 0.0),
            "migrations": self._migrations,
            "rebalances": self._rebalances,
        }

    # -- the SeqSession metric surface ---------------------------------

    def histograms(self) -> Dict[str, list]:
        out = {name: self._hist[i].tolist()
               for i, name in enumerate(SQ.HIST_NAMES)}
        for s in range(self.shards):
            for i, name in enumerate(SQ.HIST_NAMES):
                out[f"{name}_shard{s}"] = self._hist_shard[s][i].tolist()
        self.telemetry.publish_histograms(out)
        return out

    def metrics(self) -> Dict[str, int]:
        counters = dict(zip(SQ.METRIC_NAMES, self._metrics.tolist()))
        counters["shard_migrations"] = self._migrations
        counters["shard_rebalances"] = self._rebalances
        tot = int(self._occ_shard.sum())
        if tot:
            counters["shard_imbalance"] = round(
                float(self._occ_shard.max()) * self.shards / tot, 4)
        self._publish(counters)
        return counters

    def gather_state(self) -> Dict[str, np.ndarray]:
        """The shards' states as one host dict in the stacked layout of
        `make_mesh_state` (replicated planes from shard 0, identical on
        every shard between batches)."""
        self._join()
        parts = [SQ.state_to_numpy(st) for st in self._shard_states]
        return {k: (parts[0][k] if k in _REPL_KEYS
                    else np.concatenate([p[k] for p in parts], axis=0))
                for k in parts[0]}

    def export_canonical_global(self) -> dict:
        """Stitch the per-shard canonical exports back into ONE
        global-cfg canonical dict through the inverse placement table.
        Every _run drains before it returns, so this is always a
        quiescent snapshot — a checkpoint between batches sees exactly
        the serial session's state."""
        Sl, A = self.S_local, self.local_cfg.accounts
        canons = self._canons()
        where = []   # global lane g -> (shard, local row)
        for g in range(self.cfg.lanes):
            slot = int(self._perm[g])
            where.append((slot // Sl, slot % Sl))
        gl = {}
        for key in ("slot_oid", "slot_aid", "slot_price", "slot_size",
                    "slot_seq", "slot_used"):
            gl[key] = np.stack([canons[ss][key][rr] for ss, rr in where])
        gl["seq"] = np.stack([canons[ss]["seq"][rr] for ss, rr in where])
        gl["book_exists"] = np.stack(
            [canons[ss]["book_exists"][rr] for ss, rr in where])
        for key in ("pos_amt", "pos_avail"):
            gl[key] = np.stack(
                [canons[ss][key].reshape(Sl, A)[rr]
                 for ss, rr in where]).reshape(-1)
        # replicated planes are identical across shards at batch
        # boundaries — take shard 0
        gl["bal"] = canons[0]["bal"]
        gl["bal_used"] = canons[0]["bal_used"]
        gl["err"] = np.int32(max(int(c["err"]) for c in canons))
        gl["metrics"] = None
        return gl

    def export_state(self):
        """Oracle-comparable host dict view, both dispatch modes: the
        stitched global canon through SeqSession's shared mapping."""
        return self._canon_to_export(self.export_canonical_global())
