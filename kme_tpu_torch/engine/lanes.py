"""Throughput engine: per-symbol order-book lanes, swept in parallel.

The port of `kme_tpu/engine/lanes.py`, single device. The reference's
KV stores and linked lists dissolve into dense per-lane arrays, and the
per-message match loop becomes a sort + prefix-sum *sweep*: constant
work per scan step, everything vectorized over the step's lanes.

Semantics: compat='fixed' exactly (the scalar oracle's corrected
reference semantics), including the Q9 prev-echo leak. A parallel step
is bit-exact with serial replay because the host scheduler
(runtime/sequencer.py) keeps per-symbol arrival order within a lane,
never places two messages of one account in a step, and runs PAYOUT /
REMOVE_SYMBOL as barriers between scan segments.

Data layout per lane (S = lanes, N = slots/side, A = accounts), the JAX
package's, so a state carries across as a dtype/device copy
(`state_from_numpy`):
- book slots (S, 2, N): oid i64, aid-index / price / size / seqno i32,
  used bool. Price-time priority is the scalar key
  `price << 32 | seqno` (ask side; bids use 125 - price).
- positions: flat (S*A,) i64 lane-major, or with `pos_dma` planar int32
  [lo | hi] rows (S, 2A/128, 128) whose W active rows each step reads
  and writes through the row-copy kernels (ops/rowdma.py, B4/B5).
- balances (A,) i64 + used flags; `err` the sticky error; the counters
  `metrics` (12,) and histograms `hist` (3, 16) as i64 tensors (the JAX
  package keeps tuples of scalars in compact mode; snapshots carry the
  array form either way); the fill log `fillbuf` (4, F) with its
  cursor `filloff` (1,).

The port runs one scan step as torch ops on the state's device that
update the state dict's tensors IN PLACE where the JAX package donates
them, reading its messages from static window buffers at a device-side
step index. Nothing in a step waits for the card or reads a host value
(no `.item()`, boolean-mask indexing or `nonzero`), so on the card
LaneSession captures the step once into a CUDA graph and replays it T
times per window — the counterpart of the JAX package's jitted
`lax.scan` — while the CPU runs the same step eagerly. Integer
arithmetic that the JAX package does in int32 is done in int64 and
folded to int32 explicitly (`_i32`), wraparound included: the sweep's
prefix sum at `kme_tpu/engine/lanes.py:413` stays int32 there
(`jnp.cumsum` does not promote) and wraps, and the port reproduces
that; the reductions that `jnp.sum` promotes to int64 are int64 here
too.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from kme_tpu_torch.ops import rowdma
from kme_tpu_torch.utils import pow2_bucket

_I64 = torch.int64
_I32 = torch.int32

# dense lane op codes (host-side routers pack these)
L_NOP = 0
L_BUY = 1
L_SELL = 2
L_CANCEL = 3
L_CREATE = 4
L_TRANSFER = 5
L_ADD_SYMBOL = 6

# lane error codes (sticky, per call). Book/fill CAPACITY overflow is
# NOT an error: it is a per-message REJECT (the envelope policy). Only
# the fill log's bound is a sticky error.
LERR_OK = 0
LERR_FILLBUF_FULL = 3  # fill log exhausted (fill_buffer / fill_cap knob)

# on-device metrics counters
MET_MSGS = 0            # device-executed messages (non-NOP)
MET_TRADES_OK = 1       # accepted BUY/SELL
MET_FILLS = 2           # fill events (maker count)
MET_CONTRACTS = 3       # contracts traded (sum of fill sizes)
MET_REJ_CAPACITY = 4    # envelope rejects
MET_REJ_RISK = 5        # margin/validation rejects
MET_RESTED = 6          # orders appended to a book
MET_CANCELS_OK = 7
MET_REJ_CANCEL = 8
MET_TRANSFERS_OK = 9
MET_REJ_OTHER = 10      # failed create/transfer/add_symbol
MET_BARRIERS = 11       # payout/remove settles executed
N_METRICS = 12

METRIC_NAMES = ("msgs", "trades_ok", "fills", "contracts", "rej_capacity",
                "rej_risk", "rested", "cancels_ok", "rej_cancel",
                "transfers_ok", "rej_other", "barriers")

# on-device distribution histograms: power-of-two buckets. Bucket index
# for value v is #{k in 0..14 : v >= 2^k}: v <= 0 -> bucket 0, v == 1 ->
# 1, v in [2^(i-1), 2^i) -> i, v >= 2^14 -> 15.
HIST_FILLS = 0        # makers swept per ACCEPTED trade (0 = pure rest)
HIST_DEPTH = 1        # resting orders (both sides) in the touched book
#                       after each accepted trade/cancel
HIST_OCCUPANCY = 2    # non-NOP messages per dispatch unit (scan step /
#                       seq kernel call); empty units are unobserved
N_HIST = 3
N_HIST_BUCKETS = 16

HIST_NAMES = ("fills_per_order", "book_depth", "batch_occupancy")

_ROW_KEYS = ("slot_oid", "slot_aid", "slot_price", "slot_size",
             "slot_seq", "slot_used")
# arrays whose leading axis is the lane axis (canonical form: user lanes
# only — the compact path's scrap lane is all-zero)
_LANE_KEYS = _ROW_KEYS + ("seq", "book_exists")
_POS_KEYS = ("pos_amt", "pos_avail")
BIG = 1 << 62


@dataclasses.dataclass(frozen=True)
class LaneConfig:
    """Static shapes of one engine instance (the JAX package's fields)."""

    lanes: int = 8            # S — symbols
    slots: int = 128          # N — resting orders per book side
    accounts: int = 256      # A — dense account capacity
    max_fills: int = 16       # E — makers swept per taker
    steps: int = 64           # T bucket granularity of a dispatch window
    window: int = 1024        # max scan steps per dispatch
    fill_buffer: int = 1 << 20  # fill log capacity
    # width > 0: ACTIVE-LANE COMPACTION — each scan step computes at
    # width W (the at-most-W lanes the scheduler placed in it) instead
    # of all S lanes; the LAST device lane is the padding scrap lane
    # (LaneSession sizes the device state to lanes + 1)
    width: int = 0            # W — max active lanes per scan step
    unroll: int = 1           # the JAX scan's unroll; unused by the port
    # pos_dma (compact mode only): positions as planar int32 rows moved
    # by the row-copy kernels; needs accounts % 64 == 0
    pos_dma: bool = False


def hist_thresholds(device) -> torch.Tensor:
    """(15,) int64 [1, 2, 4, ..., 2^14], made on `device` (no host copy)."""
    k = torch.arange(N_HIST_BUCKETS - 1, dtype=_I64, device=device)
    return torch.ones_like(k) << k


def hist_bucket(v: torch.Tensor, thr=None) -> torch.Tensor:
    """Power-of-two bucket index (any int shape) as int64."""
    if thr is None:
        thr = hist_thresholds(v.device)
    return (v[..., None] >= thr).sum(-1)


def _fill_slack(cfg: LaneConfig) -> int:
    """Slack columns past the fill log's overflow watermark: compact
    mode's block append writes up to one (M*E,) window block from the
    watermark, M bucketed to a power of two over <= window*width."""
    if cfg.width <= 0:
        return 1
    return pow2_bucket(cfg.window * cfg.width) * cfg.max_fills


def resolve_device(device) -> torch.device:
    """The port runs on the card unless the caller asks for the CPU:
    asking for CUDA where there is none raises instead of falling back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default — pass device='cpu' to run the plain PyTorch path")
    return dev


def _shapes(cfg: LaneConfig) -> dict:
    """name -> (shape, dtype) of every state tensor."""
    S, N, A = cfg.lanes, cfg.slots, cfg.accounts
    if cfg.pos_dma:
        pos = ((S,) + rowdma.row_shape(2 * A), _I32)
    else:
        pos = ((S * A,), _I64)
    return {
        "slot_oid": ((S, 2, N), _I64), "slot_aid": ((S, 2, N), _I32),
        "slot_price": ((S, 2, N), _I32), "slot_size": ((S, 2, N), _I32),
        "slot_seq": ((S, 2, N), _I32), "slot_used": ((S, 2, N), torch.bool),
        "seq": ((S,), _I32), "book_exists": ((S,), torch.bool),
        "pos_amt": pos, "pos_avail": pos,
        "bal": ((A,), _I64), "bal_used": ((A,), torch.bool),
        "err": ((), _I32),
        "metrics": ((N_METRICS,), _I64),
        "hist": ((N_HIST, N_HIST_BUCKETS), _I64),
        "fillbuf": ((4, cfg.fill_buffer + _fill_slack(cfg)), _I64),
        "filloff": ((1,), _I64),
    }


def make_lane_state(cfg: LaneConfig, device="cuda") -> dict:
    dev = resolve_device(device)
    return {k: torch.zeros(shape, dtype=dt, device=dev)
            for k, (shape, dt) in _shapes(cfg).items()}


_NP_DT = {_I64: np.int64, _I32: np.int32, torch.bool: np.bool_}


def state_from_numpy(cfg: LaneConfig, arrays: dict, device="cuda") -> dict:
    """Host arrays — e.g. `jax.tree.map(np.asarray, state)` of a JAX
    package session, whose compact-mode metrics and hist are tuples —
    -> a state dict on `device`. Shapes and dtypes are checked."""
    dev = resolve_device(device)
    out = {}
    for k, (shape, dt) in _shapes(cfg).items():
        a = arrays[k]
        if isinstance(a, (tuple, list)):
            a = np.stack([np.asarray(x) for x in a])
        a = np.asarray(a)
        if a.shape != shape or a.dtype != _NP_DT[dt]:
            raise ValueError(f"state array {k}: expected {shape} "
                             f"{_NP_DT[dt].__name__}, got {a.shape} {a.dtype}")
        out[k] = torch.from_numpy(np.array(a, order="C")).to(dev)
    return out


def state_to_numpy(state: dict) -> dict:
    """A host COPY of the state (never a view of a CPU state)."""
    return {k: v.detach().to("cpu", copy=True).numpy()
            for k, v in state.items()}


def export_canonical(cfg: LaneConfig, state: dict, lanes: int) -> dict:
    """The canonical snapshot payload of the JAX package's lanes
    checkpoints (`kme_tpu/runtime/checkpoint.py` `save_session`): every
    state array but the fill log, `lanes` user lanes (the scrap lane
    stripped), positions flat s64 (S*A,), metrics (12,), hist (3, 16)."""
    S, A = lanes, cfg.accounts
    h = state_to_numpy({k: v for k, v in state.items() if k != "fillbuf"})
    for k in _LANE_KEYS:
        h[k] = h[k][:S]
    for k in _POS_KEYS:
        v = h[k]
        if cfg.pos_dma:
            v = rowdma.unpack64_np(v, v.shape[0]).reshape(-1)
        h[k] = v[:S * A]
    return h


def import_canonical(cfg: LaneConfig, canon: dict, lanes: int,
                     device="cuda") -> dict:
    """Inverse of export_canonical into a device state of `cfg` (which
    may carry the scrap lane): also takes the seq engine's canonical
    form (no fill cursor, histograms or counters: those start at 0)."""
    S, A = lanes, cfg.accounts
    arrays = state_to_numpy(make_lane_state(cfg, "cpu"))
    for k, (shape, dt) in _shapes(cfg).items():
        if k == "fillbuf" or canon.get(k) is None:
            continue                # fresh (drained / not carried)
        arr = np.asarray(canon[k])
        if k in _POS_KEYS:
            if arr.shape != (S * A,):
                raise ValueError(f"snapshot {k}: shape {arr.shape}, "
                                 f"canonical ({S * A},)")
            full = np.zeros((shape[0] if cfg.pos_dma else cfg.lanes, A),
                            np.int64)
            full[:S] = arr.reshape(S, A)
            arrays[k] = (rowdma.pack64_np(full, full.shape[0])
                         if cfg.pos_dma else full.reshape(-1))
        elif k in _LANE_KEYS:
            if arr.shape != (S,) + shape[1:]:
                raise ValueError(f"snapshot {k}: shape {arr.shape}, "
                                 f"canonical {(S,) + shape[1:]}")
            arrays[k][:S] = arr
        else:
            if arr.shape != shape:
                raise ValueError(f"snapshot {k}: shape {arr.shape}, "
                                 f"expected {shape}")
            arrays[k] = arr.astype(_NP_DT[dt])
    return state_from_numpy(cfg, arrays, device)


def _priority_key(maker_is_ask, price, seqno):
    """Scalar price-time key, ascending = better maker: asks low price
    first, bids high price first, then arrival (seqno)."""
    p = torch.where(maker_is_ask, price, 125 - price).to(_I64)
    return (p << 32) | seqno


def _i32(v: torch.Tensor) -> torch.Tensor:
    """-> int32 keeping the low 32 bits: Java/XLA int32 wraparound of a
    result computed exactly in int64. (A narrowing conversion is defined
    to keep the low bits; signed overflow, which C++ leaves undefined,
    never happens in the int64 arithmetic before it.)"""
    return v.to(_I32)


# the window's message rows the step reads, int64; the last four are
# also kept as int32 (the book rows and the row-copy kernels take them)
_WIN_FIELDS = ("act", "oid", "aid", "price", "size", "lane")
_WIN_I32 = _WIN_FIELDS[2:]
# a step's per-message outputs, stored as int64 rows
_OUT_FIELDS = ("ok", "residual", "append", "prev_oid", "nfill", "cap_reject")
_FILL_FIELDS = ("fill_oid", "fill_aid", "fill_price", "fill_size")


def window_steps(cfg: LaneConfig) -> int:
    """The most scan steps of one dispatch window (LaneSession buckets a
    window's T to a power of two from cfg.steps up to cfg.window)."""
    return pow2_bucket(cfg.window, lo=cfg.steps)


def make_step_io(cfg: LaneConfig, T: int, device) -> dict:
    """The static buffers a step reads and writes, for windows of up to T
    steps (a captured step graph holds their addresses): the window's
    messages "win" (T, 6, X) int64 and "win32" (T, 4, X) int32 in
    _WIN_FIELDS order, the outputs "out" (T, 6, X) and "fills"
    (T, 4, X, E) int64 in _OUT_FIELDS / _FILL_FIELDS order, and the
    device-side step index "t" (1,) int64."""
    X = cfg.width if cfg.width > 0 else cfg.lanes
    dev = torch.device(device)
    return {
        "win": torch.zeros((T, len(_WIN_FIELDS), X), dtype=_I64, device=dev),
        "win32": torch.zeros((T, len(_WIN_I32), X), dtype=_I32, device=dev),
        "out": torch.empty((T, len(_OUT_FIELDS), X), dtype=_I64, device=dev),
        "fills": torch.empty((T, len(_FILL_FIELDS), X, cfg.max_fills),
                             dtype=_I64, device=dev),
        "t": torch.zeros((1,), dtype=_I64, device=dev),
    }


def idle_step_io(cfg: LaneConfig, io: dict) -> None:
    """Every slot of the window buffers a NOP (under compaction on the
    scrap lane) and the step index 0: a step then leaves the state as it
    was, which makes it a safe warm-up before a graph capture."""
    io["win"].zero_()
    io["win32"].zero_()
    if cfg.width > 0:
        io["win"][:, _WIN_FIELDS.index("lane")] = cfg.lanes - 1
        io["win32"][:, _WIN_I32.index("lane")] = cfg.lanes - 1
    io["t"].zero_()


@functools.lru_cache(maxsize=None)
def build_lane_step(cfg: LaneConfig, axis_name=None):
    """The scan step: step(state, io) runs ONE step of a window.

    io: the window buffers of `make_step_io`. The step reads its (X,)
    message slots (act, oid, aid, price, size, lane) at the device-side
    index io["t"], where X is the step width — S at full width,
    cfg.width under active-lane compaction, where "lane" maps each step
    slot to its device lane (padding slots carry the scrap lane S-1 with
    act=NOP, so their writes are identity). The state dict is updated in
    place; the step writes its (X,) ok / residual / append / prev_oid /
    nfill / cap_reject and (X, E) fill arrays at row io["t"] and
    advances it. Nothing in it waits for the card or depends on a host
    value, so LaneSession captures it once into a CUDA graph and replays
    it T times per window; elsewhere it runs eagerly."""
    if axis_name is not None:
        raise NotImplementedError(
            "the sharded (shard_map) lanes step comes with the seq-fleet "
            "slice of the port")
    S, N, A, E = cfg.lanes, cfg.slots, cfg.accounts, cfg.max_fills
    compact = cfg.width > 0
    X = cfg.width if compact else S
    if cfg.pos_dma and not compact:
        raise ValueError("pos_dma requires active-lane compaction")
    twoE = 2 * E
    # metric rows counted from boolean masks (the rest: FILLS, CONTRACTS
    # from sums; BARRIERS in the settle)
    met_bool = (MET_MSGS, MET_TRADES_OK, MET_REJ_CAPACITY, MET_REJ_RISK,
                MET_RESTED, MET_CANCELS_OK, MET_REJ_CANCEL,
                MET_TRANSFERS_OK, MET_REJ_OTHER)

    def one_step(st, msg, c):
        act, oid, aid, price, size = (msg["act"], msg["oid"], msg["aid"],
                                      msg["price"], msg["size"])
        if compact:
            lanes = msg["lane"]
            sl = {k: st[k].index_select(0, lanes) for k in _ROW_KEYS}
            seq_v = st["seq"].index_select(0, lanes)
            be_v = st["book_exists"].index_select(0, lanes)
        else:
            lanes = c["lanes"]
            sl = {k: st[k] for k in _ROW_KEYS}
            seq_v = st["seq"]
            be_v = st["book_exists"]

        if cfg.pos_dma:
            # copy the W active lanes' position rows of both planes into
            # small (X, A) s64 blocks (one B4 launch); every read/write
            # below is block-local (each step slot owns its lane row —
            # scheduler invariant), and the updated rows are copied back
            # in place at the end (one B5 launch)
            pa_f, pv_f = rowdma.gather_pos_rows(st["pos_amt"],
                                                st["pos_avail"], msg["lane32"])

            def pos_read(blk, accs):                # accs: (X, K) int64
                return torch.gather(blk, 1, accs)

            def pos_write(blk, accs, vals):
                # duplicate accounts within a row carry identical values
                # by construction; the max-select over contributors is
                # the JAX package's one-hot merge
                return blk.scatter_reduce_(1, accs, vals, "amax",
                                           include_self=False)
        else:
            # positions via flat lane*A+acc indices, written in place
            pbase = (lanes * A)[:, None]
            pa_f = st["pos_amt"]
            pv_f = st["pos_avail"]

            def pos_read(arr_f, accs):
                return arr_f[pbase + accs]

            def pos_write(arr_f, accs, vals):
                return arr_f.scatter_reduce_(
                    0, (pbase + accs).reshape(-1), vals.reshape(-1), "amax",
                    include_self=False)

        aid_c = aid[:, None]
        is_buy = act == L_BUY
        not_buy = ~is_buy
        is_trade = is_buy | (act == L_SELL)
        buy_c = is_buy[:, None]
        sell_c = not_buy[:, None]      # the maker side (opp) is side 0
        # one-hot (X, 2, 1) of the own (rest) side: buy -> 0, else 1; and
        # of the maker side
        side_oh = torch.stack([is_buy, not_buy], 1)[:, :, None]
        opp_oh = torch.stack([not_buy, is_buy], 1)[:, :, None]

        def maker(a):                  # (X, 2, N) -> the maker side
            return torch.where(sell_c, a[:, 0], a[:, 1])

        def own(a):                    # (X, 2, N) -> the own side
            return torch.where(buy_c, a[:, 0], a[:, 1])

        bal_g = st["bal"].index_select(0, aid)
        bal_ok = st["bal_used"].index_select(0, aid)

        # ------------------------------------------------- CREATE_BALANCE
        create_ok = (act == L_CREATE) & ~bal_ok

        # ------------------------------------------------------- TRANSFER
        # `-order.size` is Java int negation: wraps at int32
        neg_size = _i32(-size)
        transfer_ok = (act == L_TRANSFER) & bal_ok & (bal_g >= neg_size)

        # ----------------------------------------------------- ADD_SYMBOL
        addsym_ok = (act == L_ADD_SYMBOL) & ~be_v
        book_exists = be_v | addsym_ok

        # ------------------------------------------------- TRADE: margin
        valid = (price >= 0) & (price < 126) & (size > 0)
        signed = torch.where(is_buy, size, neg_size)
        p_avail = pos_read(pv_f, aid_c)[:, 0]   # == 0 when no position
        neg_signed = -signed
        adj = torch.where(is_buy,
                          torch.maximum(p_avail.clamp(max=0), neg_signed),
                          torch.minimum(p_avail.clamp(min=0), neg_signed))
        unit = torch.where(is_buy, price, _i32(price - 100))
        risk = (signed + adj) * unit
        trade_ok = is_trade & valid & be_v & bal_ok & (bal_g >= risk)

        # -------------------------------------------------- TRADE: sweep
        # the JAX package's multi-operand sort becomes a stable sort of
        # the key plus gathers of the payloads; ties occur only among
        # non-crossing entries (keyed BIG), which no output reads
        m_used = maker(sl["slot_used"])
        m_price, m_size = maker(sl["slot_price"]), maker(sl["slot_size"])
        pc = price[:, None]
        crossing = (m_used & trade_ok[:, None]
                    & torch.where(buy_c, m_price <= pc, m_price >= pc))
        key = _priority_key(buy_c, m_price, maker(sl["slot_seq"]))
        skey, perm = torch.sort(torch.where(crossing, key, c["big"]), dim=1,
                                stable=True)
        cross_s = skey < BIG
        sz_raw_s = torch.gather(m_size, 1, perm)
        fo_oid = torch.gather(maker(sl["slot_oid"]), 1, perm[:, :E])
        fo_aid = torch.gather(maker(sl["slot_aid"]), 1, perm[:, :E])
        fo_price = torch.gather(m_price, 1, perm[:, :E])
        sz_sorted = sz_raw_s * cross_s
        # the JAX package's prefix sum stays int32 and wraps; so do the
        # differences built on it
        cum = torch.cumsum(sz_sorted, dim=1, dtype=_I64)
        z = (size * trade_ok)[:, None]
        fill_sorted = torch.minimum(_i32(z - cum + sz_sorted).clamp(min=0),
                                    sz_sorted)
        filled_total = _i32(fill_sorted.sum(1))
        residual = _i32(size - filled_total * trade_ok)
        nfill = (fill_sorted > 0).sum(1)

        # ------------------------- capacity envelope
        o_used_pre = own(sl["slot_used"])
        o_free = ~o_used_pre
        free_idx = torch.argmax(o_free.to(torch.uint8), dim=1)
        rest_want = trade_ok & (residual > 0)
        cap_reject = trade_ok & ((rest_want & ~o_free.any(1)) | (nfill > E))
        trade_acc = trade_ok & ~cap_reject
        acc_c = trade_acc[:, None]

        # margin netting blocks part of the opposite position
        pv_f = pos_write(pv_f, aid_c,
                         (p_avail - adj * (trade_acc & (adj != 0)))[:, None])

        # maker sizes back into slot order through the inverse permutation
        # (fill <= size, so the int32 difference cannot wrap)
        new_m_size = torch.empty_like(m_size).scatter_(
            1, perm, sz_raw_s - fill_sorted)
        slot_size = torch.where(opp_oh, torch.where(
            acc_c, new_m_size, m_size)[:, None, :], sl["slot_size"])
        slot_used = torch.where(opp_oh, torch.where(
            acc_c, m_used & (new_m_size > 0), m_used)[:, None, :],
            sl["slot_used"])

        # ---------------------------------- TRADE: position updates
        # closed-form replay of the per-trade fill sequence (maker fill
        # then taker fill per trade), delete-at-zero included: masked
        # (X, 2E, 2E) reductions instead of a 2E-deep loop; entries
        # interleave [m0, t0, m1, t1, ...]
        fo_fill = fill_sorted[:, :E]
        if fo_fill.shape[1] < E:       # a sweep crosses at most N makers
            pad = lambda a: torch.nn.functional.pad(a, (0, E - a.shape[1]))
            fo_oid, fo_aid, fo_price, fo_fill = (
                pad(fo_oid), pad(fo_aid), pad(fo_price), pad(fo_fill))
        neg_fill = -fo_fill
        t_sgn = torch.where(buy_c, fo_fill, neg_fill)
        acc = torch.stack([fo_aid, msg["aid32"][:, None].expand(X, E)],
                          -1).reshape(X, twoE).to(_I64)
        sgn = torch.stack([torch.where(buy_c, neg_fill, fo_fill), t_sgn],
                          -1).reshape(X, twoE)
        fvalid = ((fo_fill > 0) & acc_c).repeat_interleave(2, dim=1)
        a0 = pos_read(pa_f, acc)   # 0 when no position exists
        v0 = pos_read(pv_f, acc)
        # eq[x, i, j]: entry i is a VALID contributor to entry j's account
        eq = (acc[:, :, None] == acc[:, None, :]) & fvalid[:, :, None]
        sgn_b = sgn[:, :, None]
        prefix = a0 + (sgn_b * (eq & c["le"])).sum(1)
        zero_eq = (fvalid & (prefix == 0))[:, :, None] & eq
        # per entry j: index of its account's last zero prefix (-1 if none)
        jlast = torch.where(zero_eq, c["idx2"], c["neg1"]).amax(1)
        avail_sum = (sgn_b * (eq & (c["idx2"] > jlast[:, None, :]))).sum(1)
        total = (sgn_b * eq).sum(1)
        amt_fin = a0 + total
        avail_fin = torch.where(zero_eq.any(1), avail_sum, v0 + total)
        pa_f = pos_write(pa_f, acc, amt_fin)
        pv_f = pos_write(pv_f, acc, avail_fin * (amt_fin != 0))

        # taker balance credit: sum of fill * improvement, each product
        # a Java int*int that wraps at int32 before the long add
        improve = _i32(pc * acc_c - fo_price)
        credit = _i32(t_sgn.to(_I64) * improve).sum(1)

        # ------------------------------------------------- TRADE: rest
        same_level = o_used_pre & (own(sl["slot_price"]) == pc)
        tail_idx = torch.argmax(torch.where(same_level, own(sl["slot_seq"]),
                                            c["neg1_32"]), dim=1)
        tail_oid = torch.gather(own(sl["slot_oid"]), 1, tail_idx[:, None])
        do_rest = rest_want & trade_acc
        wr = (side_oh & (free_idx[:, None] == c["ar_n"])[:, None, :]
              & do_rest[:, None, None])                      # (X, 2, N)
        new_rows = {
            "slot_oid": torch.where(wr, oid[:, None, None], sl["slot_oid"]),
            "slot_aid": torch.where(wr, msg["aid32"][:, None, None],
                                    sl["slot_aid"]),
            "slot_price": torch.where(wr, msg["price32"][:, None, None],
                                      sl["slot_price"]),
            "slot_size": torch.where(wr, residual[:, None, None], slot_size),
            "slot_seq": torch.where(wr, seq_v[:, None, None], sl["slot_seq"]),
        }
        slot_used = slot_used | wr
        seq = _i32(seq_v + do_rest.to(_I64))

        # --------------------------------------------------------- CANCEL
        is_cancel = act == L_CANCEL
        hit = (sl["slot_used"] & (sl["slot_oid"] == oid[:, None, None])
               ).reshape(X, 2 * N)
        hit_idx = torch.argmax(hit.to(torch.uint8), dim=1)[:, None]
        c_aid = torch.gather(sl["slot_aid"].reshape(X, 2 * N), 1, hit_idx)
        c_price = torch.gather(sl["slot_price"].reshape(X, 2 * N), 1,
                               hit_idx)[:, 0]
        c_size = torch.gather(sl["slot_size"].reshape(X, 2 * N), 1,
                              hit_idx)[:, 0]
        cancel_ok = is_cancel & hit.any(1) & (c_aid[:, 0] == aid)
        slot_used = slot_used & ~((hit_idx == c["ar_2n"])
                                  & cancel_ok[:, None]).reshape(X, 2, N)
        new_rows["slot_used"] = slot_used
        # margin release (book sizes are >= 0 and prices in [0, 126), so
        # these int32 negations and differences cannot wrap)
        c_isbuy = hit_idx[:, 0] < N
        c_signed = torch.where(c_isbuy, c_size, -c_size)
        cp_amt = pos_read(pa_f, aid_c)[:, 0]
        cp_avail_raw = pos_read(pv_f, aid_c)[:, 0]
        blocked = cp_amt - cp_avail_raw
        neg_cs = -c_signed
        c_adj = torch.where(c_isbuy,
                            torch.maximum(blocked.clamp(max=0), neg_cs),
                            torch.minimum(blocked.clamp(min=0), neg_cs))
        c_release = (c_signed + c_adj) * torch.where(c_isbuy, c_price,
                                                     c_price - 100)
        pv_f = pos_write(pv_f, aid_c, (cp_avail_raw + c_adj * (
            cancel_ok & (c_adj != 0)))[:, None])

        # ------------------------------------------- balance delta merge
        st["bal"].index_add_(0, aid, size * transfer_ok
                             + (credit - risk) * trade_acc
                             + c_release * cancel_ok)
        created = torch.zeros(A, dtype=_I32, device=act.device).index_add_(
            0, aid, create_ok.to(_I32))
        st["bal_used"].logical_or_(created > 0)

        # ------------------------------------------------ metrics delta
        not_nop = act != L_NOP
        ok = (trade_acc | cancel_ok | create_ok | transfer_ok | addsym_ok
              | ~not_nop)
        nfill_acc = nfill * trade_acc
        st["metrics"].index_add_(0, c["met_bool"], torch.stack([
            not_nop, trade_acc, cap_reject, is_trade & ~trade_ok, do_rest,
            cancel_ok, is_cancel & ~cancel_ok, transfer_ok,
            (act >= L_CREATE) & ~ok]).sum(1))
        st["metrics"][MET_FILLS:MET_CONTRACTS + 1] += torch.stack(
            [nfill_acc, filled_total.to(_I64) * trade_acc]).sum(1)

        # ---------------------------------------------- histogram deltas
        # fills per accepted trade; book depth AFTER each accepted
        # trade/cancel; non-NOP messages per step (when > 0)
        occ = not_nop.sum(0, keepdim=True)
        v = torch.cat([nfill, slot_used.reshape(X, 2 * N).sum(1), occ])
        st["hist"].view(-1).index_add_(
            0, hist_bucket(v, c["thr"]) + c["hoff"],
            torch.cat([trade_acc, trade_acc | cancel_ok, occ > 0]).to(_I64))

        if compact:
            # duplicate indices only occur on the scrap lane, whose rows
            # are bitwise identity, so the duplicate-index copy is exact
            for k, v in new_rows.items():
                st[k].index_copy_(0, lanes, v)
            st["seq"].index_copy_(0, lanes, seq)
            st["book_exists"].index_copy_(0, lanes, book_exists)
            if cfg.pos_dma:
                # copy the updated (X, A) blocks back in place (the
                # kernel skips scrap-lane rows)
                rowdma.scatter_pos_rows(st["pos_amt"], st["pos_avail"],
                                        msg["lane32"], pa_f, pv_f, S - 1)
        else:
            for k, v in new_rows.items():
                st[k].copy_(v)
            st["seq"].copy_(seq)
            st["book_exists"].copy_(book_exists)
        return {
            "ok": ok,
            "residual": torch.where(trade_acc, residual, msg["size32"]),
            "append": same_level.any(1) & do_rest,
            "prev_oid": tail_oid[:, 0],
            "nfill": nfill_acc,
            "cap_reject": cap_reject,
            "fill_oid": fo_oid, "fill_aid": fo_aid,
            "fill_price": fo_price, "fill_size": fo_fill,
        }

    consts = {}

    def _consts(dev):
        idx2 = torch.arange(twoE, dtype=_I64, device=dev)
        return {
            "lanes": torch.arange(S, dtype=_I64, device=dev),
            "ar_n": torch.arange(N, dtype=_I64, device=dev),
            "ar_2n": torch.arange(2 * N, dtype=_I64, device=dev),
            "idx2": idx2[:, None],
            "le": idx2[:, None] <= idx2[None, :],
            "neg1": torch.full((), -1, dtype=_I64, device=dev),
            "neg1_32": torch.full((), -1, dtype=_I32, device=dev),
            "big": torch.full((), BIG, dtype=_I64, device=dev),
            "thr": hist_thresholds(dev),
            "hoff": torch.cat([torch.full((n,), h * N_HIST_BUCKETS,
                                          dtype=_I64, device=dev)
                               for h, n in ((HIST_FILLS, X),
                                            (HIST_DEPTH, X),
                                            (HIST_OCCUPANCY, 1))]),
            "met_bool": torch.tensor(met_bool, dtype=_I64).to(dev),
        }

    def step(st, io):
        t = io["t"]
        c = consts.get(t.device)
        if c is None:
            c = consts[t.device] = _consts(t.device)
        msg = dict(zip(_WIN_FIELDS, io["win"].index_select(0, t)[0]
                       .unbind(0)))
        msg.update(zip([k + "32" for k in _WIN_I32],
                       io["win32"].index_select(0, t)[0].unbind(0)))
        outs = one_step(st, msg, c)
        io["out"].index_copy_(0, t, torch.stack(
            [outs[k].to(_I64) for k in _OUT_FIELDS])[None])
        io["fills"].index_copy_(0, t, torch.stack(
            [outs[k].to(_I64) for k in _FILL_FIELDS])[None])
        t.add_(1)

    return step


# ---------------------------------------------------------------------------
# compact-I/O chunk: the serving-path wrapper around the scan


def chunk_compaction(cfg: LaneConfig, T: int, M: int, step):
    """Wrap T runs of the one-step function `step` (build_lane_step)
    with device-side input scatter and output compaction: inputs arrive
    as (M,) message vectors with (t, lane|slot) coordinates and are
    scattered into the step's (T, X) window buffers, outputs leave as one
    packed (8, M) int64 array, and fills are appended to the persistent
    fill log in cb order (the session sorts cb by (t, lane)).
    Overflowing the log sets the sticky LERR_FILLBUF_FULL. t >= T marks
    padding entries."""
    S, E = cfg.lanes, cfg.max_fills
    FB = cfg.fill_buffer
    compact = cfg.width > 0
    X = cfg.width if compact else S
    if compact and M * E > _fill_slack(cfg):
        raise ValueError(
            f"chunk M={M} x max_fills={E} exceeds the fill-log slack "
            f"{_fill_slack(cfg)}")

    def chunk(state, cb, io=None, run=None):
        """-> (state, {"packed": (8, M) int64}). `io`: the step's window
        buffers (fresh ones by default); `run(T)`: runs the T steps over
        them (by default the step itself, T times)."""
        dev = cb["t"].device
        if io is None:
            io = make_step_io(cfg, T, dev)
        elif io["win"].shape[0] < T:
            raise ValueError(f"window of {T} steps in buffers of "
                             f"{io['win'].shape[0]}")
        valid = cb["t"] < T
        col = cb["slot"] if compact else cb["lane"]
        flat = torch.where(valid, cb["t"] * X + col, T * X)
        # the (T, X) grid of each message row, padding slots NOP on the
        # scrap lane, written into the window buffers
        grid = torch.zeros((len(_WIN_FIELDS), T * X + 1), dtype=_I64,
                           device=dev)
        grid[_WIN_FIELDS.index("lane")] = S - 1
        grid[:, flat] = torch.stack([cb[k] for k in _WIN_FIELDS])
        win = grid[:, :T * X].reshape(-1, T, X).transpose(0, 1)
        io["win"][:T] = win
        io["win32"][:T] = win[:, len(_WIN_FIELDS) - len(_WIN_I32):]
        io["t"].zero_()
        if run is None:
            for _ in range(T):
                step(state, io)
        else:
            run(T)

        # per-message gathers of the (T, X) outputs
        gflat = torch.clamp(flat, max=T * X - 1)
        ok, residual, append, prev_oid, nfill, cap = io["out"][:T].transpose(
            0, 1).reshape(len(_OUT_FIELDS), T * X)[:, gflat]
        nfill = nfill * valid
        total = nfill.sum()
        base = state["filloff"][0]
        excl = torch.cumsum(nfill, 0) - nfill
        eidx = torch.arange(E, dtype=_I64, device=dev)[None, :]
        mask = eidx < nfill[:, None]
        new_off = base + total
        fills = io["fills"][:T].transpose(0, 1).reshape(
            len(_FILL_FIELDS), T * X, E)[:, gflat]          # (4, M, E)
        buf = state["fillbuf"]
        if compact:
            # stream-compact the (M, E) grid (valid entries keyed by their
            # window-relative log position, padding past the end) and
            # write the packed block contiguously at the cursor; the
            # start clamps as the JAX package's dynamic_update_slice does
            key = torch.where(mask, excl[:, None] + eidx, M * E).reshape(-1)
            _, order = torch.sort(key, stable=True)
            blk = fills.reshape(4, M * E)[:, order]
            start = torch.clamp(base, 0, buf.shape[1] - M * E)
            buf.index_copy_(1, start + torch.arange(M * E, dtype=_I64,
                                                    device=dev), blk)
        else:
            pos = torch.where(mask, torch.clamp(base + excl[:, None] + eidx,
                                                max=FB), FB).reshape(-1)
            buf[:, pos] = fills.reshape(4, M * E)
        err = state["err"]
        err.copy_(torch.where((err == LERR_OK) & (new_off > FB),
                              LERR_FILLBUF_FULL, err))
        state["filloff"].copy_(new_off[None])
        # ALL per-message outputs ride ONE (8, M) int64 array (rows 6/7
        # broadcast the err/total scalars): a single device-to-host copy
        packed = torch.stack([
            (valid & (ok != 0)).to(_I64),
            residual,
            (valid & (append != 0)).to(_I64),
            prev_oid,
            (valid & (cap != 0)).to(_I64),
            nfill,
            err.to(_I64).expand(M),
            total.expand(M),
        ])
        return state, {"packed": packed}

    return chunk


@functools.lru_cache(maxsize=None)
def build_lane_chunk(cfg: LaneConfig, T: int, M: int):
    """Single-device compact-I/O chunk function (state updated in
    place)."""
    return chunk_compaction(cfg, T, M, build_lane_step(cfg))


def build_gauges(cfg: LaneConfig):
    """Point-in-time gauges over the lane state (book depth, open
    orders, live books/accounts/positions)."""
    def gauges(state):
        used = state["slot_used"]
        depth = used.sum(2)                             # (S, 2)
        pa = state["pos_amt"]
        if cfg.pos_dma:  # planar lo/hi rows: live iff either half != 0
            v = pa.reshape(pa.shape[0], 2, -1)
            live = (v[:, 0] != 0) | (v[:, 1] != 0)
        else:
            live = pa != 0
        return {
            "open_orders": used.sum(),
            "books": state["book_exists"].sum(),
            "accounts": state["bal_used"].sum(),
            "positions": live.sum(),
            "max_book_depth": depth.max(),
        }

    return gauges


def build_fill_reset(cfg: LaneConfig):
    """Rewind the fill log (the host consumed it)."""
    def reset(state):
        state["filloff"].zero_()
        return state

    return reset


# ---------------------------------------------------------------------------
# barrier ops (rare; invoked by the host between scan dispatches)

def build_barrier_ops(cfg: LaneConfig, axis_name=None):
    """payout/remove_symbol over ONE lane: settle(state, lane,
    credit_size, mode) -> ok (a Python bool), state updated in place.

    Both wipe the lane's book with per-order margin release in the
    reference's wipe order — buy side first, then (price, seqno) — which
    is sequential per account (each release changes `available`, feeding
    the next release's netting). The JAX package loops over all 2N slots
    on the device; the port reads the number of resting orders (and
    whether the book exists) once per barrier and loops over those
    orders only. PAYOUT then credits `amount * size` per holder (YES) or
    just deletes positions (NO). mode: 0 = REMOVE_SYMBOL, 1 = PAYOUT
    YES, 2 = PAYOUT NO."""
    if axis_name is not None:
        raise NotImplementedError(
            "the sharded settle comes with the seq-fleet slice of the port")
    N, A = cfg.slots, cfg.accounts

    def _pos_row(st, key, lane):
        """One lane's positions as an (A,) s64 row, either layout."""
        if cfg.pos_dma:
            r = st[key][lane].reshape(2 * A)
            return rowdma.join64(r[:A], r[A:])
        return st[key][lane * A:(lane + 1) * A].clone()

    def _pos_row_set(st, key, lane, row64):
        if cfg.pos_dma:
            lo, hi = rowdma.split64(row64)
            st[key][lane].copy_(torch.cat([lo, hi]).reshape(
                st[key].shape[1:]))
        else:
            st[key][lane * A:(lane + 1) * A] = row64

    def settle(state, lane: int, credit_size: int, mode: int) -> bool:
        used = state["slot_used"][lane]                     # (2, N)
        n_used, do = torch.stack([
            used.sum(), state["book_exists"][lane].to(_I64)]).tolist()
        if not do:
            return False
        dev = used.device
        # wipe order: side-major (buy side first), then (price, seqno);
        # the side tag (1 << 44) dominates the (price << 32 | seq) range
        key = (torch.arange(2, dtype=_I64, device=dev)[:, None] * (1 << 44)
               + (state["slot_price"][lane].to(_I64) << 32)
               + state["slot_seq"][lane].to(_I64))
        key = torch.where(used, key, BIG).reshape(2 * N)
        order = torch.sort(key, stable=True)[1][:n_used]
        a_s = state["slot_aid"][lane].reshape(2 * N)[order].to(_I64)
        pr = state["slot_price"][lane].reshape(2 * N)[order].to(_I64)
        sz = state["slot_size"][lane].reshape(2 * N)[order].to(_I64)
        isbuy = order < N
        signed = torch.where(isbuy, sz, _i32(-sz))
        unit = torch.where(isbuy, pr, _i32(pr - 100))
        pos_amt = _pos_row(state, "pos_amt", lane)
        pos_avail = _pos_row(state, "pos_avail", lane)
        bal_delta = torch.zeros(A, dtype=_I64, device=dev)
        for i in range(n_used):
            a = a_s[i:i + 1]
            blocked = pos_amt[a] - pos_avail[a]
            adj = torch.where(isbuy[i],
                              torch.maximum(blocked.clamp(max=0), -signed[i]),
                              torch.minimum(blocked.clamp(min=0), -signed[i]))
            pos_avail.index_add_(0, a, adj)
            bal_delta.index_add_(0, a, (signed[i] + adj) * unit[i])
        _pos_row_set(state, "pos_avail", lane, pos_avail)
        state["slot_used"][lane] = False
        state["book_exists"][lane] = False
        if mode > 0:    # payout: credit holders (YES), delete positions
            if mode == 1:
                bal_delta += pos_amt * credit_size
            zero = torch.zeros(A, dtype=_I64, device=dev)
            _pos_row_set(state, "pos_amt", lane, zero)
            _pos_row_set(state, "pos_avail", lane, zero)
        state["bal"] += bal_delta
        state["metrics"][MET_BARRIERS] += 1
        return True

    return settle
