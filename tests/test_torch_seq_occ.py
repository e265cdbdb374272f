"""What the card's seq_step kernel relies on to walk only the book rows
in use and to select in one pass, checked on the CPU with exact equality.

(a) `rows_in_use` (the plain version of the rows-in-use kernel) against a
    numpy loop on seeded size planes.
(b) The invariant: seeded fixed and java streams with cancels and PAYOUT
    barriers go through `kme_tpu`'s Pallas kernel (interpret mode on JAX
    CPU, as tests/test_torch_seq_kernel.py runs it) and the port's plain
    version, whose stores feed a Python model of the kernel's rule for its
    rows-in-use scratch (made from the size plane before each call; a rest
    raises its side's entry, a barrier wipe zeroes both, nothing else
    lowers it). Every rest must land where the kernel's bounded free-slot
    search would put it, and after every call the model must cover the
    rows in use of both packages' size planes.
(c) The kernel's one-pass lexicographic selection (a best triple per
    lane over its 4 columns of each row, then three warp mins: the least
    first key, the least second key beside it, the least slot beside
    both) against the three masked mins of the plain version, for the
    fill, Q2 ghost, wipe and tail-echo selections, on seeded rows with
    price and seq ties and wrapped out-of-domain prices.
"""

import numpy as np
import pytest
import torch

from kme_tpu.engine import seq as JSQ
from kme_tpu_torch.engine import seq as SQ
from kme_tpu_torch.workload import deep_book_stream

torch.set_num_threads(1)

LN, BIG = SQ.LN, SQ.BIG
KW = dict(lanes=4, accounts=128, max_fills=32, batch=256, pos_cap=1 << 11,
          fill_cap=1 << 12, probe_max=16)
JKW = dict(KW, max_fills=64, pos_cap=1 << 13, fill_cap=1 << 14,
           compat="java", hbm_books=True)


# ---- (a) rows_in_use ------------------------------------------------------

def _loop_rows_in_use(cfg, bs):
    out = np.zeros((cfg.lanes, 2), np.int32)
    for lane in range(cfg.lanes):
        for side in range(2):
            base = (lane * 2 + side) * cfg.nr
            for r in range(cfg.nr):
                if (bs[base + r] != 0).any():
                    out[lane, side] = r + 1
    return out


@pytest.mark.parametrize("slots", [128, 256, 1024])
@pytest.mark.parametrize("kind", ["empty", "full", "holes", "top", "random"])
def test_rows_in_use_matches_numpy_loop(slots, kind):
    cfg = SQ.SeqConfig(**dict(KW, lanes=5, slots=slots))
    rng = np.random.default_rng(slots + len(kind))
    bs = np.zeros((2 * cfg.lanes * cfg.nr, LN), np.int32)
    if kind == "full":
        bs[:] = rng.integers(1, 50, bs.shape)
    elif kind == "holes":    # live rows with empty rows between them
        rows = rng.random(bs.shape[0]) < 0.4
        bs[rows] = rng.integers(0, 3, (int(rows.sum()), LN))
    elif kind == "top":      # one order, in the last slot of one side
        bs[3 * cfg.nr - 1, LN - 1] = 7
    elif kind == "random":   # sparse sizes, some negative
        bs[:] = rng.integers(-1, 2, bs.shape) * (rng.random(bs.shape) < 0.01)
    got = SQ.rows_in_use(cfg, torch.from_numpy(bs))
    assert got.dtype == torch.int32 and tuple(got.shape) == (cfg.lanes, 2)
    want = _loop_rows_in_use(cfg, bs)
    assert np.array_equal(got.numpy(), want)
    if kind == "empty":
        assert not want.any()
    if kind == "full":
        assert (want == cfg.nr).all()
    if kind == "top":
        assert want[1, 0] == cfg.nr and want.sum() == cfg.nr


def test_rows_in_use_checks_its_input():
    cfg = SQ.SeqConfig(**dict(KW, slots=256))
    bs = torch.zeros((2 * cfg.lanes * cfg.nr, LN), dtype=torch.int32)
    with pytest.raises(ValueError, match="bs"):
        SQ.rows_in_use(cfg, bs[:-1])
    with pytest.raises(ValueError, match="bs"):
        SQ.rows_in_use(cfg, bs.to(torch.int64))


# ---- (b) the scratch's update rule covers the rows in use -----------------

class _OccModel(SQ._Reference):
    """The plain version with the kernel's rows-in-use rule run beside
    it: `occ` starts as `rows_in_use` of the size plane, and every store
    that the rule reacts to goes through `p`."""

    def __init__(self, cfg, state):
        super().__init__(cfg, state)
        self.occ = SQ.rows_in_use(cfg, state["bs"]).view(-1).tolist()
        self.rests = 0
        self.above = 0      # rests that opened a new row

    def p(self, key, i, v):
        if key == "bs" and v > 0:        # a rest
            side, flat = divmod(i, self.W)
            # the kernel's search: the first hole below occ, else the
            # first slot above it
            occ = self.occ[side]
            sizes = self.f["bs"][side * self.W:(side + 1) * self.W]
            holes = torch.nonzero(sizes[:occ * LN] == 0).view(-1)
            want = int(holes[0]) if len(holes) else occ * LN
            assert occ < self.NR or len(holes)
            assert flat == want, (side, occ, flat, want)
            assert not (sizes[occ * LN:] != 0).any()
            self.above += flat // LN + 1 > occ
            self.occ[side] = max(occ, flat // LN + 1)
            self.rests += 1
        elif key == "bex" and v == 0:    # a barrier wiped lane i
            self.occ[2 * i] = self.occ[2 * i + 1] = 0
        super().p(key, i, v)

    def check(self, planes):
        """The model covers every plane's rows in use, and no slot at or
        above it is live."""
        for bs in planes:
            real = SQ.rows_in_use(self.cfg, bs).view(-1).tolist()
            assert all(o >= r for o, r in zip(self.occ, real))
            sides = bs.view(len(self.occ), self.NR, LN)
            for s, o in enumerate(self.occ):
                assert not (sides[s, o:] > 0).any()


def _stream_columns(rng, cfg_kw, n):
    """Lane-level columns that pile orders up in one hot lane (lane 0 is
    java's merged sid-0 book): non-crossing and crossing trades of small
    sizes, cancels of live orders, and in fixed mode PAYOUT barriers with
    their re-ADDs."""
    java = cfg_kw.get("compat") == "java"
    S, A, B = cfg_kw["lanes"], 40, cfg_kw["batch"]
    araw = [int(v) for v in rng.integers(-2**62, 2**62, A)]
    sraw = [0] + [int(v) for v in rng.integers(1, 2**40, S - 1)]
    msgs = []
    for a in range(A):
        msgs.append((SQ.L_CREATE, 0, a, 0, 0, 0))
        msgs.append((SQ.L_TRANSFER, 0, a, 0, 10**8, 0))
    for s in range(S):
        msgs.append((SQ.L_ADD_SYMBOL, 0, 0, 0, 0, s))
    live = []
    while len(msgs) < n:
        lane = int(min(rng.zipf(2.0) - 1, S - 1))
        if java:      # the hot lane is an ordinary book, not the merged one
            lane = (lane + 1) % S
        r = rng.random()
        if r < 0.80 or not live:
            buy = rng.random() < 0.5
            price = int(rng.integers(30, 54) if buy else rng.integers(47, 71))
            oid = int(rng.integers(-2**62, 2**62))
            acc = int(rng.integers(0, A))
            live.append((oid, lane, acc))
            msgs.append((SQ.L_BUY if buy else SQ.L_SELL, oid, acc, price,
                         int(rng.integers(1, 6)), lane))
        elif r < 0.9985 or java:
            # mostly the newest orders: they sit in the highest slots
            k = len(live) - 1 - int(rng.integers(0, min(len(live), 60)))
            oid, ol, acc = live.pop(k)
            msgs.append((SQ.L_CANCEL, oid, acc, 0, 0, ol))
        else:
            act = int(rng.choice([SQ.L_PAYOUT_YES, SQ.L_PAYOUT_NO]))
            msgs.append((act, 0, 0, 0, 97, lane))
            msgs.append((SQ.L_ADD_SYMBOL, 0, 0, 0, 0, lane))
    out = []
    for lo in range(0, len(msgs), B):
        part = msgs[lo:lo + B]
        cols = {f: np.array([m[i] for m in part], np.int64)
                for i, f in enumerate(("act", "oid", "aid", "price", "size",
                                       "lane"))}
        if java:
            cols["aid_raw"] = np.array([araw[m[2]] for m in part], np.int64)
            cols["sid_raw"] = np.array([sraw[m[5]] for m in part], np.int64)
            cols["flags"] = (cols["sid_raw"] == 0).astype(np.int32)
        out.append((cols, len(part)))
    return out


@pytest.mark.parametrize("compat,slots", [("fixed", 256), ("fixed", 1024),
                                          ("java", 256), ("java", 1024)])
def test_occ_rule_covers_rows_in_use_of_both_packages(compat, slots):
    kw = dict(KW if compat == "fixed" else JKW, slots=slots)
    jcfg, cfg = JSQ.SeqConfig(**kw), SQ.SeqConfig(**kw)
    jstep = JSQ.build_seq_step(jcfg)[0]
    jstate = JSQ.make_seq_state(jcfg)
    state = SQ.make_seq_state(cfg, "cpu")
    rng = np.random.default_rng(slots + (compat == "java"))
    rests = above = top = 0
    met = np.zeros(SQ.N_METRICS, np.int64)
    batches = 13 if slots == 256 else 9   # enough to fill a 256-slot side
    for cols, n in _stream_columns(rng, kw, batches * kw["batch"]):
        jstate, _ = jstep(jstate, JSQ.pack_msgs(jcfg, cols, n))
        model = _OccModel(cfg, state)
        out = torch.zeros((SQ.out_rows(cfg), LN), dtype=torch.int32)
        model.run(SQ.msgs_to_device(SQ.pack_msgs(cfg, cols, n), "cpu"), out)
        jbs = torch.from_numpy(np.asarray(jstate["bs"]).copy())
        assert torch.equal(jbs, state["bs"])
        model.check([state["bs"], jbs])
        rests, above = rests + model.rests, above + model.above
        met += SQ.unpack_out(cfg, out.numpy(), n)["metrics"]
        top = max(top, max(model.occ))
    # the stream reached what the rule is for
    count = dict(zip(SQ.METRIC_NAMES, met.tolist()))
    assert rests > 500 and above >= 2 and top >= 2
    assert count["cancels_ok"] > 100 and count["fills"] > 100
    if slots == 256:
        # a side filled up: a reject in fixed mode, fatal in java mode
        assert top == cfg.nr
        if compat == "fixed":
            assert count["rej_capacity"] > 0
        else:
            assert int(state["err"][0, 0]) == SQ.LERR_JAVA_CAP
    else:
        assert top < cfg.nr                  # rows above occ stayed unused
        assert int(state["err"][0, 0]) == SQ.LERR_OK
    if compat == "fixed":
        assert count["barriers"] > 0


@pytest.mark.parametrize("compat", ["fixed", "java"])
def test_occ_rule_on_the_deep_book_stream(compat):
    """The deep-book stream of the card checks, at a small depth, through
    CPU sessions: it rests past the first rows, cancels from the top,
    wipes (fixed mode) and rests again, with no sticky error."""
    from kme_tpu_torch.runtime.seqsession import SeqRouter

    kw = dict(KW if compat == "fixed" else JKW, slots=1024, max_fills=16)
    cfg = SQ.SeqConfig(**kw)
    msgs = deep_book_stream(700, num_accounts=40, sid=3,
                            barrier=compat == "fixed")
    router = SeqRouter(cfg.lanes, cfg.accounts, cfg.compat)
    state = SQ.make_seq_state(cfg, "cpu")
    tops, met = [], np.zeros(SQ.N_METRICS, np.int64)
    for lo in range(0, len(msgs), cfg.batch):
        cols, _ = router.route(msgs[lo:lo + cfg.batch])
        model = _OccModel(cfg, state)
        out = torch.zeros((SQ.out_rows(cfg), LN), dtype=torch.int32)
        model.run(SQ.msgs_to_device(
            SQ.pack_msgs(cfg, cols, len(cols["act"])), "cpu"), out)
        model.check([state["bs"]])
        tops.append(max(model.occ))
        met += SQ.unpack_out(cfg, out.numpy(), len(cols["act"]))["metrics"]
    assert int(state["err"][0, 0]) == SQ.LERR_OK
    assert max(tops) == 6                    # 700 sells: rows 0..5
    count = dict(zip(SQ.METRIC_NAMES, met.tolist()))
    assert count["cancels_ok"] > 80 and count["fills"] > 50
    if compat == "fixed":
        assert count["barriers"] == 1 and count["rej_capacity"] > 0
        assert tops[-1] < max(tops)          # the wipe lowered it


# ---- (c) one pass against three -------------------------------------------

def _i32(v):
    return ((np.asarray(v, np.int64) + 2**31) % 2**32 - 2**31).astype(np.int64)


INT32_MAX = 2**31 - 1


def _one_pass(valid, k1, k2):
    """The kernel's `lexmin`: lane t owns columns 4t..4t+3 of each row and
    keeps its least (k1, k2) with the first slot that has it (strict
    compares from (BIG, BIG, BIG), slots in rising order); three warp
    mins follow: the least k1 (BIG or more: nothing accepted that BIG
    does not hide, so (BIG, BIG, BIG)), the least k2 among the lanes
    that hold it, the least slot among those that hold both, the other
    lanes entering each min as INT32_MAX."""
    rows = len(valid) // LN
    best = []
    for t in range(32):
        b1, b2, b3 = BIG, BIG, BIG
        for r in range(rows):
            for j in range(4):
                f = r * LN + 4 * t + j
                a1, a2 = int(k1[f]), int(k2[f])
                if valid[f] and (a1 < b1 or (a1 == b1 and a2 < b2)):
                    b1, b2, b3 = a1, a2, f
        best.append((b1, b2, b3))
    s1 = min(b[0] for b in best)
    if s1 >= BIG:
        return BIG, BIG, BIG
    s2 = min(b[1] if b[0] == s1 else INT32_MAX for b in best)
    s3 = min(b[2] if b[:2] == (s1, s2) else INT32_MAX for b in best)
    return s1, s2, s3


def _three_pass(valid, k1, k2):
    """The plain version's three masked mins -> (k1*, k2*, flat) or None."""
    valid, k1, k2 = (torch.from_numpy(np.asarray(v)) for v in (valid, k1, k2))
    fi = torch.arange(len(valid))

    def minwhere(mask, vals):
        return int(torch.where(mask, vals, BIG).min())

    s1 = minwhere(valid, k1)
    if s1 >= BIG:
        return None
    at = valid & (k1 == s1)
    s2 = minwhere(at, k2)
    return s1, s2, minwhere(at & (k2 == s2), fi)


def _rows(rng, rows):
    """Sizes (a third empty), prices from a few values with out-of-domain
    ones mixed in, seqs with duplicates."""
    n = rows * LN
    w = rng.integers(1, 30, n) * (rng.random(n) < 0.66)
    p = rng.choice([48, 49, 50, 50, 51, 52, 125, 0], n)
    odd = rng.random(n) < 0.05
    p[odd] = rng.choice([2**31 - 1, -2**31, BIG, BIG + 5, -BIG, -5, 126],
                        int(odd.sum()))
    q = rng.integers(0, max(4, n // 3), n)
    return w, p, q


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("seed", range(6))
def test_one_pass_selection_matches_three_masked_mins(rows, seed):
    rng = np.random.default_rng(100 * rows + seed)
    w, p, q = _rows(rng, rows)
    if seed == 5:
        w[:] = 0                                   # an empty side
    for sgn in (1, -1):
        for limit in (50, 47, 53, 2**31 - 1, -5):
            psg = _i32(p * sgn)
            # the fill search: crossing live makers, best price*sgn first
            cross = (w > 0) & (_i32(_i32(p - limit) * sgn) <= 0)
            got, want = _one_pass(cross, psg, q), _three_pass(cross, psg, q)
            assert (None if got[0] >= BIG else got) == want
            # the Q2 ghost search: any live maker
            got, want = _one_pass(w > 0, psg, q), _three_pass(w > 0, psg, q)
            assert (None if got[0] >= BIG else got) == want
            # the tail echo: of the live orders at `limit` the highest
            # seq, then the lowest slot
            same = (w > 0) & (p == limit)
            got = _one_pass(same, ~q, np.zeros_like(q))
            if same.any():
                smax = int(q[same].max())
                slot = int(np.flatnonzero(same & (q == smax))[0])
                assert got == (~smax, 0, slot)
            else:
                assert got == (BIG, BIG, BIG)
    # the barrier wipe: lowest price, then seq, then slot (fixed mode:
    # prices in the domain)
    p = np.clip(p, 0, 125)
    got, want = _one_pass(w > 0, p, q), _three_pass(w > 0, p, q)
    assert (None if got[0] >= BIG else got) == want
