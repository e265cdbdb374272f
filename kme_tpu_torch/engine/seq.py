"""Sequential matching kernel engine: fixed and java modes, books on the
card at any depth.

The port of `kme_tpu/engine/seq.py` (`build_seq_step` /
`build_seq_scan`, every configuration: `compat='fixed'` or `'java'`,
`hbm_books` False or True). One kernel call processes a micro-batch of
B messages STRICTLY SEQUENTIALLY — the reference's own execution model
(KProcessor.java:95-126, single StreamThread) — against the entire
engine state, so no scheduling constraints exist at all.

Semantics, exactly as the JAX kernel:

- compat='fixed': the capacity envelope (slots / max_fills per-message
  rejects), the Q9 prev echo, Java int32/int64 wrap arithmetic, and
  barrier settles (payout / remove wipe order: buy side first, (price,
  seq) within a side).
- compat='java': the reference quirk for quirk on the stock wire
  surface (COMPAT.md): Q1 (symbol 0's buys and sells share one book,
  side 0), Q2 (one zero-size ghost fill), Q9, Q11 (positions keyed by
  their own values, in a 128-bit-key tombstoned hash). No barriers. A
  price or size outside the device domain sets the sticky
  LERR_JAVA_DOMAIN; running out of book slots or fills sets the sticky
  LERR_JAVA_CAP (the reference's stores are unbounded, so it is fatal,
  never a per-message reject).
- hbm_books: on the TPU, books too deep for VMEM live in HBM behind a
  one-lane VMEM cache. The card's kernel reads book rows in place from
  device memory at any depth, and only the rows in use (`rows_in_use`),
  so the port accepts the flag only so that configurations carry across
  from the JAX package; nothing reads it.

Data layout — identical to the JAX package, so state and output planes
carry across as a dtype/device copy (`state_from_numpy`):

- book planes (2*S*NR, 128), row = lane*2*NR + side*NR + r, side 0 =
  buy, N = NR*128 slots/side: oid lo/hi, aid, price, size, seq. A slot
  is occupied iff size > 0. In java mode `ba` packs aid | is_buy << 30.
- fixed positions: an open-addressing hash of (CAP,) entries in
  (CAP/128, 128) planes [key, amt lo/hi, avail lo/hi]; key = lane*A +
  acc + 1 (0 = empty). Entries are never deleted (a live position has
  amt != 0), and probing is tile-granular linear from a Fibonacci home
  tile.
- java positions: the same hash over 128-bit keys (hka lo/hi, hkb
  lo/hi: the real (aid, sid) key or a Q11 (amount, available) key) with
  a state plane (0 empty / 1 live / 2 tombstone), plus the raw-id
  tables araw (account index -> Java-long aid) and sraw (lane -> sid).
- balances (A/128, 128) lo/hi/used planes; per-lane seq counters,
  book-exists flags and (fixed mode) occupied-slot counts (`dep`) as
  (ceil(S/128), 128) planes; the sticky error in `err` (1, 128).

Unlike the JAX kernel, which copies the whole state on every call
(`input_output_aliases` without donation), the port's kernel updates the
state dict's int32 tensors IN PLACE: a call returns only the output
plane.

The kernels are in `csrc/seq_step.cu`: the chain kernel, with `seq_scan`
its wrapper and `seq_scan_reference` its plain PyTorch version, and the
rows-in-use kernel that runs before it at more than one row per side
(`rows_in_use`, plain version `rows_in_use_reference`). A wrapper takes
the plain version only for tensors on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kme_tpu_torch.engine.lanes import (  # noqa: F401 (re-exported)
    L_NOP, L_BUY, L_SELL, L_CANCEL, L_CREATE, L_TRANSFER, L_ADD_SYMBOL,
    LERR_OK, LERR_FILLBUF_FULL, METRIC_NAMES, N_METRICS,
    HIST_NAMES, N_HIST, N_HIST_BUCKETS, resolve_device, state_to_numpy,
)

# output row 0: lane 0 err, lane 1 fill_total, lanes 2..13 the metric
# deltas, lanes HIST_LANE0.. the 3 x 16 per-call histogram deltas
HIST_LANE0 = 2 + N_METRICS

# barrier acts (device-executed)
L_PAYOUT_YES = 7
L_PAYOUT_NO = 8
L_REMOVE_SYMBOL = 9

LERR_HASH_FULL = 4     # position hash exhausted (pos_cap knob)
LERR_JAVA_DOMAIN = 5   # java mode: price/size outside the device domain
LERR_JAVA_CAP = 6      # java mode: slots/max_fills device bound exceeded

LN = 128
BIG = 1 << 30
AMASK = (1 << 30) - 1  # java: the ba plane packs aid index | is_buy << 30

_STATE_KEYS = ("bo_lo", "bo_hi", "ba", "bp", "bs", "bq",
               "seqc", "bex", "bal_lo", "bal_hi", "bal_u",
               "hk", "ha_lo", "ha_hi", "hv_lo", "hv_hi", "dep", "err")

# java mode: four key planes and a state plane replace `hk`; no `dep`
_STATE_KEYS_JAVA = (
    "bo_lo", "bo_hi", "ba", "bp", "bs", "bq",
    "seqc", "bex", "bal_lo", "bal_hi", "bal_u",
    "hka_lo", "hka_hi", "hkb_lo", "hkb_hi", "hstate",
    "ha_lo", "ha_hi", "hv_lo", "hv_hi",
    "araw_lo", "araw_hi", "sraw_lo", "sraw_hi", "err")

_JKEY_PLANES = ("hka_lo", "hka_hi", "hkb_lo", "hkb_hi")

MSG_FIELDS = ("act", "oid_lo", "oid_hi", "aid", "price", "size", "lane")
# java mode adds the raw Java-long aid and sid and the Q1 merged flag
MSG_FIELDS_JAVA = MSG_FIELDS + ("aidr_lo", "aidr_hi", "sidr_lo", "sidr_hi",
                                "flags")


@dataclasses.dataclass(frozen=True)
class SeqConfig:
    """Static shapes of one engine instance."""

    lanes: int = 1024          # S symbols
    slots: int = 128           # N resting orders per side (mult of 128)
    accounts: int = 2048       # A dense account capacity (mult of 128)
    max_fills: int = 16        # E makers swept per taker
    batch: int = 4096          # B messages per kernel call (mult of 128)
    pos_cap: int = 1 << 17     # position hash capacity (pow2 mult of 128)
    fill_cap: int = 1 << 15    # fill entries per call (mult of 128)
    probe_max: int = 64        # max hash tiles probed before HASH_FULL
    compat: str = "fixed"
    hbm_books: bool = False    # accepted for the JAX package's configs; unused

    def __post_init__(self):
        if self.compat not in ("fixed", "java"):
            raise ValueError(f"unknown compat {self.compat!r}")
        bad = []
        if self.slots % LN or self.slots < LN:
            bad.append("slots must be a positive multiple of 128")
        if self.accounts % LN:
            bad.append("accounts must be a multiple of 128")
        if self.batch % LN:
            bad.append("batch must be a multiple of 128")
        if self.pos_cap % LN or self.pos_cap & (self.pos_cap - 1):
            bad.append("pos_cap must be a power of two >= 128")
        if self.fill_cap % LN:
            bad.append("fill_cap must be a multiple of 128")
        if self.max_fills > LN:
            bad.append("max_fills must be <= 128")
        if self.lanes * self.accounts + self.accounts >= (1 << 31):
            bad.append("hash keys must fit int32")
        if 2 * self.lanes * self.slots >= (1 << 31):
            bad.append("book plane offsets must fit int32 "
                       "(2 * lanes * slots < 2**31)")
        if bad:
            raise ValueError("; ".join(bad))

    @property
    def nr(self):
        return self.slots // LN

    @property
    def srows(self):
        return -(-self.lanes // LN)

    @property
    def arows(self):
        return self.accounts // LN

    @property
    def caprows(self):
        return self.pos_cap // LN


def state_keys(cfg: SeqConfig):
    return _STATE_KEYS_JAVA if cfg.compat == "java" else _STATE_KEYS


def msg_fields(cfg: SeqConfig):
    return MSG_FIELDS_JAVA if cfg.compat == "java" else MSG_FIELDS


def _plane_rows(cfg: SeqConfig):
    br = 2 * cfg.lanes * cfg.nr
    rows = {"bo_lo": br, "bo_hi": br, "ba": br, "bp": br, "bs": br,
            "bq": br, "seqc": cfg.srows, "bex": cfg.srows,
            "bal_lo": cfg.arows, "bal_hi": cfg.arows, "bal_u": cfg.arows,
            "ha_lo": cfg.caprows, "ha_hi": cfg.caprows,
            "hv_lo": cfg.caprows, "hv_hi": cfg.caprows, "err": 1}
    if cfg.compat == "java":
        rows.update({k: cfg.caprows for k in _JKEY_PLANES + ("hstate",)})
        rows.update({"araw_lo": cfg.arows, "araw_hi": cfg.arows,
                     "sraw_lo": cfg.srows, "sraw_hi": cfg.srows})
    else:
        # per-lane occupied-slot count (both sides), maintained
        # incrementally for the book-depth histogram
        rows.update({"hk": cfg.caprows, "dep": cfg.srows})
    return {k: rows[k] for k in state_keys(cfg)}


def make_seq_state(cfg: SeqConfig, device="cuda") -> dict:
    dev = resolve_device(device)
    return {k: torch.zeros((r, LN), dtype=torch.int32, device=dev)
            for k, r in _plane_rows(cfg).items()}


def state_from_numpy(cfg: SeqConfig, arrays: dict, device="cuda") -> dict:
    """Host planes (e.g. `np.asarray` of a `kme_tpu` session's state) ->
    a state dict on `device`. Shapes and dtype are checked."""
    dev = resolve_device(device)
    out = {}
    for k, r in _plane_rows(cfg).items():
        a = np.asarray(arrays[k])
        if a.shape != (r, LN) or a.dtype != np.int32:
            raise ValueError(f"state plane {k}: expected ({r}, {LN}) int32, "
                             f"got {a.shape} {a.dtype}")
        out[k] = torch.from_numpy(np.ascontiguousarray(a).copy()).to(dev)
    return out


# ---------------------------------------------------------------------------
# output plane layout (host unpack in unpack_out)

def out_rows(cfg: SeqConfig):
    """Output plane rows: [0] scalars (err, fill_total, metric deltas,
    histogram deltas); [1, 1+5BR) per-message regions (flags / residual /
    nfill / prev lo / prev hi); [1+5BR, ...) fills in GROUPS of 5 rows
    per 128 entries (oid lo/hi, aid, price, size), so the used prefix is
    ONE contiguous row slice."""
    BR, FR = cfg.batch // LN, cfg.fill_cap // LN
    return 1 + 5 * BR + 5 * FR


def hdr_rows(cfg: SeqConfig):
    return 1 + 5 * (cfg.batch // LN)


def used_rows(cfg: SeqConfig, fill_total: int) -> int:
    """Rows of an output plane that a call defines: the header plus the
    fill groups it used."""
    return hdr_rows(cfg) + 5 * (-(-fill_total // LN))


# ---------------------------------------------------------------------------
# host-side packing / unpacking (numpy)

def _split64(v):
    v = np.asarray(v, np.int64)
    return ((v & 0xFFFFFFFF).astype(np.uint32).astype(np.int32),
            (v >> 32).astype(np.int32))


def pack_msgs(cfg: SeqConfig, cols: dict, n: int) -> dict:
    """Columnar router output (numpy, length n <= batch) -> padded (B,)
    int32 input dict. Padding entries are NOPs."""
    B = cfg.batch
    out = {}
    for k in ("act", "aid", "price", "size", "lane"):
        a = np.zeros(B, np.int32)
        a[:n] = cols[k][:n]
        out[k] = a
    v = np.zeros(B, np.int64)
    v[:n] = cols["oid"][:n]
    out["oid_lo"], out["oid_hi"] = _split64(v)
    if cfg.compat == "java":
        for name, src in (("aidr", "aid_raw"), ("sidr", "sid_raw")):
            v = np.zeros(B, np.int64)
            v[:n] = cols[src][:n]
            out[f"{name}_lo"], out[f"{name}_hi"] = _split64(v)
        fl = np.zeros(B, np.int32)
        fl[:n] = cols["flags"][:n]
        out["flags"] = fl
    return out


def unpack_hdr(cfg: SeqConfig, hdr: np.ndarray, n: int) -> dict:
    """Header slice (hdr_rows, 128) -> per-message host dict + scalars."""
    B = cfg.batch
    BR = B // LN
    flat = hdr.reshape(-1)
    scal = flat[:LN]
    base = LN
    flags = flat[base:base + B][:n]
    return {
        "ok": (flags & 1) != 0,
        "cap_reject": (flags & 2) != 0,
        "append": (flags & 4) != 0,
        "residual": flat[base + BR * LN:base + BR * LN + B][:n],
        "nfill": flat[base + 2 * BR * LN:base + 2 * BR * LN + B][:n],
        "prev_oid": ((flat[base + 3 * BR * LN:base + 3 * BR * LN + B][:n]
                      .astype(np.int64) & 0xFFFFFFFF)
                     | (flat[base + 4 * BR * LN:base + 4 * BR * LN + B][:n]
                        .astype(np.int64) << 32)),
        "err": int(scal[0]),
        "fill_total": int(scal[1]),
        "metrics": scal[2:2 + N_METRICS].astype(np.int64),
        "hist": scal[HIST_LANE0:HIST_LANE0 + N_HIST * N_HIST_BUCKETS]
        .astype(np.int64).reshape(N_HIST, N_HIST_BUCKETS),
    }


def unpack_fills(groups: np.ndarray, ftot: int) -> np.ndarray:
    """Fill group rows (5g, 128) -> (4, ftot) [oid, aid, price, size]."""
    if ftot == 0:
        return np.zeros((4, 0), np.int64)
    g = groups.reshape(-1, 5, LN)
    per = np.transpose(g, (1, 0, 2)).reshape(5, -1)
    f_oid = ((per[0, :ftot].astype(np.int64) & 0xFFFFFFFF)
             | (per[1, :ftot].astype(np.int64) << 32))
    return np.stack([f_oid,
                     per[2, :ftot].astype(np.int64),
                     per[3, :ftot].astype(np.int64),
                     per[4, :ftot].astype(np.int64)])


def unpack_out(cfg: SeqConfig, plane: np.ndarray, n: int) -> dict:
    """Whole-plane unpack (tests / single-shot paths)."""
    HR = hdr_rows(cfg)
    res = unpack_hdr(cfg, plane[:HR], n)
    ftot = res["fill_total"]
    groups = plane[HR:HR + 5 * (-(-max(ftot, 1) // LN))]
    res["fills"] = unpack_fills(groups, ftot)
    return res


# ---------------------------------------------------------------------------
# canonical (lanes-style) state import/export for checkpoint parity

def _j64(lo, hi):
    return (lo.astype(np.int64) & 0xFFFFFFFF) | (hi.astype(np.int64) << 32)


def _no_java_canonical(cfg: SeqConfig):
    if cfg.compat != "fixed":
        raise ValueError(
            "java-mode state has no fixed-layout canonical form (128-bit "
            "position keys, direction-tagged merged books) — use "
            "export_java")


def export_canonical(cfg: SeqConfig, state) -> dict:
    """Device planes -> the canonical snapshot layout of the JAX package
    (slot_* (S,2,N), flat positions s64, bal s64), so snapshots restore
    across engines and packages. Fixed mode only."""
    _no_java_canonical(cfg)
    S, N, A, NR = cfg.lanes, cfg.slots, cfg.accounts, cfg.nr
    h = state_to_numpy({k: state[k] for k in _STATE_KEYS})

    def planes2slot(v):
        return v.reshape(S, 2, NR * LN)[:, :, :N]

    slot_size = planes2slot(h["bs"]).astype(np.int32)
    pos_amt = np.zeros(S * A, np.int64)
    pos_avail = np.zeros(S * A, np.int64)
    hk = h["hk"].reshape(-1)
    live = hk != 0
    keys = hk[live] - 1
    pos_amt[keys] = _j64(h["ha_lo"].reshape(-1)[live],
                         h["ha_hi"].reshape(-1)[live])
    pos_avail[keys] = _j64(h["hv_lo"].reshape(-1)[live],
                           h["hv_hi"].reshape(-1)[live])
    return {
        "slot_oid": _j64(planes2slot(h["bo_lo"]), planes2slot(h["bo_hi"])),
        "slot_aid": planes2slot(h["ba"]).astype(np.int32),
        "slot_price": planes2slot(h["bp"]).astype(np.int32),
        "slot_size": slot_size,
        "slot_seq": planes2slot(h["bq"]).astype(np.int32),
        "slot_used": slot_size > 0,
        "seq": h["seqc"].reshape(-1)[:S].astype(np.int32),
        "book_exists": h["bex"].reshape(-1)[:S] != 0,
        "pos_amt": pos_amt,
        "pos_avail": pos_avail,
        "bal": _j64(h["bal_lo"].reshape(-1)[:A], h["bal_hi"].reshape(-1)[:A]),
        "bal_used": h["bal_u"].reshape(-1)[:A] != 0,
        "err": np.int32(h["err"].reshape(-1)[0]),
        "metrics": None,  # counters are host-accumulated in SeqSession
    }


def export_java(cfg: SeqConfig, state) -> dict:
    """Host view of a java-mode state: positions keyed by the 128-bit
    (ka, kb) pairs exactly as the java oracle's dict (real keys (aid,
    sid) AND Q11 keys (amount, available)); orders carry the direction
    tag in `slot_ba`; book planes as in fixed mode."""
    if cfg.compat != "java":
        raise ValueError("export_java reads java-mode state only")
    S, N, A, NR = cfg.lanes, cfg.slots, cfg.accounts, cfg.nr
    h = state_to_numpy({k: state[k] for k in _STATE_KEYS_JAVA})

    def planes2slot(v):
        return v.reshape(S, 2, NR * LN)[:, :, :N]

    def flat64(lo, hi):
        return _j64(h[lo].reshape(-1), h[hi].reshape(-1))

    live = h["hstate"].reshape(-1) == 1
    ka = flat64("hka_lo", "hka_hi")[live]
    kb = flat64("hkb_lo", "hkb_hi")[live]
    amt = flat64("ha_lo", "ha_hi")[live]
    av = flat64("hv_lo", "hv_hi")[live]
    positions = {(int(a), int(b)): (int(x), int(y))
                 for a, b, x, y in zip(ka, kb, amt, av)}
    return {
        "positions": positions,
        "bal": _j64(h["bal_lo"].reshape(-1)[:A], h["bal_hi"].reshape(-1)[:A]),
        "bal_used": h["bal_u"].reshape(-1)[:A] != 0,
        "slot_oid": _j64(planes2slot(h["bo_lo"]), planes2slot(h["bo_hi"])),
        "slot_ba": planes2slot(h["ba"]).astype(np.int64),
        "slot_price": planes2slot(h["bp"]).astype(np.int32),
        "slot_size": planes2slot(h["bs"]).astype(np.int32),
        "book_exists": h["bex"].reshape(-1)[:S] != 0,
        "err": np.int32(h["err"].reshape(-1)[0]),
    }


# the replicated balance planes (account a -> row a >> 7, lane a & 127):
# the only cross-shard-coupled state that the fleet (parallel/seqmesh.py)
# forwards point to point and select-merges at barriers
BAL_KEYS = ("bal_lo", "bal_hi", "bal_u")


def select_balances(planes_by_shard, sel) -> dict:
    """Merge per-shard copies of the replicated balance planes by
    per-account OWNER SELECTION: sel[a] names the shard whose copy of
    account a is authoritative. Exact by construction — under the fleet's
    window invariant an account's balance only ever advances on the shard
    it is currently bound to, so a select needs no arithmetic merge (and
    trivially preserves Java-long wrap).

    planes_by_shard: per-shard dicts of BAL_KEYS -> (arows, 128) int32
    numpy planes. sel: (arows*128,) int shard index per flat account
    slot. Returns the merged (arows, 128) planes. The semantics
    authority of `select_balances_t`."""
    stacked = {k: np.stack([p[k] for p in planes_by_shard])
               for k in BAL_KEYS}
    arows, lanes = stacked[BAL_KEYS[0]].shape[1:]
    idx = sel.reshape(arows, lanes)
    r = np.arange(arows, dtype=np.int64)[:, None]
    c = np.arange(lanes, dtype=np.int64)[None, :]
    return {k: stacked[k][idx, r, c] for k in BAL_KEYS}


def select_balances_t(planes_by_shard, sel: torch.Tensor) -> dict:
    """`select_balances` on tensors, on their device: the planes are
    stacked per key and each account's value gathered from its owner's
    copy. sel: (arows*128,) int64 on the planes' device."""
    out = {}
    for k in BAL_KEYS:
        st = torch.stack([p[k] for p in planes_by_shard])   # (S, arows, 128)
        flat = st.reshape(st.shape[0], -1)
        out[k] = flat.gather(0, sel.reshape(1, -1))[0].reshape(st.shape[1:])
    return out


def _wrap32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v & 0x80000000 else v


def import_canonical(cfg: SeqConfig, canon: dict, device="cuda") -> dict:
    """Inverse of export_canonical (numpy -> state dict on `device`).
    The snapshot's slot depth and account capacity may be SMALLER than
    the config's (position hash keys are recomputed with the new
    stride); shrinking either is a state migration and raises. Fixed
    mode only."""
    _no_java_canonical(cfg)
    S, N, A, NR = cfg.lanes, cfg.slots, cfg.accounts, cfg.nr
    S0 = np.asarray(canon["slot_oid"]).shape[0]
    if S0 != S:
        raise ValueError(
            f"snapshot has {S0} lanes, cfg.lanes={S} — lane-count "
            f"changes need a state migration, not a restore")
    N0 = np.asarray(canon["slot_oid"]).shape[2]
    if N0 > N:
        raise ValueError(
            f"snapshot books are {N0} slots deep; cfg.slots={N} cannot "
            f"hold them — restore into slots >= {N0}")
    A0 = np.asarray(canon["pos_amt"]).reshape(-1).size // S
    if A0 > A:
        raise ValueError(
            f"snapshot has {A0} account slots; cfg.accounts={A} cannot "
            f"hold them — restore into accounts >= {A0}")

    def slot2planes(v):
        full = np.zeros((S, 2, NR * LN), np.int64)
        full[:, :, :N0] = np.asarray(v).reshape(S, 2, N0)
        return full.reshape(2 * S * NR, LN)

    def padplane(v, rows):
        a = np.zeros(rows * LN, np.int32)
        a[:len(v)] = v
        return a.reshape(rows, LN)

    sizes = np.where(np.asarray(canon["slot_used"]),
                     np.asarray(canon["slot_size"]), 0)
    pos_amt = np.asarray(canon["pos_amt"]).reshape(S, A0)
    pos_avail = np.asarray(canon["pos_avail"]).reshape(S, A0)
    lanes_l, accs_l = np.nonzero(pos_amt != 0)
    if len(lanes_l) > cfg.pos_cap // 2:
        raise ValueError(
            f"{len(lanes_l)} live positions exceed half the hash capacity "
            f"{cfg.pos_cap} — raise pos_cap")
    capr = cfg.caprows
    hk = np.zeros(cfg.pos_cap, np.int32)
    amt = np.zeros(cfg.pos_cap, np.int64)
    avail = np.zeros(cfg.pos_cap, np.int64)
    tilemask = capr - 1
    # the kernel stops after min(probe_max, capr) tiles; an entry placed
    # beyond that bound would be invisible to it, so the host probe is
    # bounded identically and overflow is a loud error
    probe_lim = min(cfg.probe_max, capr)
    for ln, ac in zip(lanes_l.tolist(), accs_l.tolist()):
        key = ln * A + ac + 1
        t = (_wrap32(key * -1640531527) >> 7) & tilemask
        for p in range(probe_lim):
            base = ((t + p) & tilemask) * LN
            empt = np.nonzero(hk[base:base + LN] == 0)[0]
            if len(empt):
                j = base + empt[0]
                hk[j] = key
                amt[j] = pos_amt[ln, ac]
                avail[j] = pos_avail[ln, ac]
                break
        else:
            raise ValueError(
                "position hash import overflow: entry unreachable within "
                "probe_max tiles — raise pos_cap or probe_max")
    bal = np.asarray(canon["bal"]).reshape(-1).astype(np.int64)
    oid_lo, oid_hi = _split64(slot2planes(canon["slot_oid"]))
    amt_lo, amt_hi = _split64(amt)
    av_lo, av_hi = _split64(avail)
    bal_lo, bal_hi = _split64(bal)
    arrays = {
        "bo_lo": oid_lo, "bo_hi": oid_hi,
        "ba": slot2planes(canon["slot_aid"]).astype(np.int32),
        "bp": slot2planes(canon["slot_price"]).astype(np.int32),
        "bs": slot2planes(sizes).astype(np.int32),
        "bq": slot2planes(canon["slot_seq"]).astype(np.int32),
        "seqc": padplane(np.asarray(canon["seq"]), cfg.srows),
        "bex": padplane(np.asarray(canon["book_exists"]).astype(np.int32),
                        cfg.srows),
        "bal_lo": padplane(bal_lo, cfg.arows),
        "bal_hi": padplane(bal_hi, cfg.arows),
        "bal_u": padplane(np.asarray(canon["bal_used"]).astype(np.int32),
                          cfg.arows),
        "hk": hk.reshape(capr, LN),
        "ha_lo": amt_lo.reshape(capr, LN), "ha_hi": amt_hi.reshape(capr, LN),
        "hv_lo": av_lo.reshape(capr, LN), "hv_hi": av_hi.reshape(capr, LN),
        # dep is derived state (occupied slots per lane, both sides)
        "dep": padplane((sizes.reshape(S, -1) > 0).sum(axis=1)
                        .astype(np.int32), cfg.srows),
        "err": padplane(np.array([int(canon.get("err", 0))], np.int32), 1),
    }
    return state_from_numpy(cfg, arrays, device)


# ---------------------------------------------------------------------------
# the plain PyTorch version of the kernel: Python ints for the scalars
# (wrapped explicitly, as Java and the kernel's uint32/uint64 math do),
# tensor ops for the 128-wide row work, the same tie order

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1


def _i32(v: int) -> int:
    v &= _M32
    return v - (1 << 32) if v & 0x80000000 else v


def _i64(v: int) -> int:
    v &= _M64
    return v - (1 << 64) if v >> 63 else v


def _muls64(a: int, b: int) -> int:
    """The JAX kernel's i32 x small-i32 product (16-bit split, each
    partial wrapped at 32 bits); exact for |b| <= 2^14."""
    t1 = _i32((a & 0xFFFF) * b)
    t2 = _i32((a >> 16) * b)
    return _i64(t2 * 65536 + t1)


def _hbucket(v: int) -> int:
    return sum(1 for k in range(N_HIST_BUCKETS - 1) if v >= (1 << k))


def _jkey(amt: int, avail: int) -> tuple:
    """A Q11 key: the 64-bit (amount, available) pair as 4 int32 words."""
    return (_i32(amt), _i32(amt >> 32), _i32(avail), _i32(avail >> 32))


def _margin(isbuy: bool, price: int, size: int, amt: int, avail: int):
    """postRemoveAdjustments' arithmetic (KProcessor.java:325-333) ->
    (avail adjustment, balance credit)."""
    signed = size if isbuy else _i32(-size)
    blocked = _i64(amt - avail)
    nsg = -signed
    adj = (max(min(blocked, 0), nsg) if isbuy
           else min(max(blocked, 0), nsg))
    unit = price if isbuy else _i32(price - 100)
    return adj, _muls64(_i32(signed + adj), unit)


class _Reference:
    """One kernel call's worth of state access over flat views of the
    planes (writes land in the caller's tensors)."""

    def __init__(self, cfg: SeqConfig, state: dict):
        self.cfg = cfg
        self.java = cfg.compat == "java"
        self.f = {k: state[k].view(-1) for k in state_keys(cfg)}
        self.NR = cfg.nr
        self.W = cfg.nr * LN                  # slots per side block
        self.tmask = cfg.caprows - 1
        self.probe = min(cfg.probe_max, cfg.caprows)
        self.ci = torch.arange(LN, dtype=torch.int32)
        self.fi = torch.arange(self.W, dtype=torch.int32)

    # -- scalar access ---------------------------------------------------
    def g(self, key, i):
        return int(self.f[key][i])

    def p(self, key, i, v):
        self.f[key][i] = v

    def g64(self, lo, hi, i):
        return _i64((self.g(lo, i) & _M32) | (self.g(hi, i) << 32))

    def p64(self, lo, hi, i, v):
        self.p(lo, i, _i32(v))
        self.p(hi, i, _i32(v >> 32))

    def set_err(self, code):
        if self.g("err", 0) == LERR_OK:
            self.p("err", 0, code)

    def bal_add(self, acc, d):
        self.p64("bal_lo", "bal_hi", acc,
                 self.g64("bal_lo", "bal_hi", acc) + d)

    # -- book blocks -----------------------------------------------------
    def blk(self, key, lane, side):
        b = (lane * 2 * self.NR + side * self.NR) * LN
        return self.f[key][b:b + self.W]

    def minwhere(self, mask, vals):
        return int(torch.where(mask, vals, BIG).min())

    # -- position hash (fixed) -------------------------------------------
    def home(self, key):
        return (_i32(key * -1640531527) >> 7) & self.tmask

    def tile(self, t, key):
        row = self.f["hk"][t * LN:(t + 1) * LN]
        return (self.minwhere(row == key, self.ci),
                self.minwhere(row == 0, self.ci))

    def h_find(self, key):
        """-> flat entry or -1 (absent), in the JAX probe order and
        within its bound."""
        t0 = self.home(key)
        hx, em = self.tile(t0, key)
        if hx < BIG:
            return t0 * LN + hx
        if em < BIG or 1 >= self.probe:
            return -1
        t, probes, res = (t0 + 1) & self.tmask, 1, -1
        while True:
            hx, em = self.tile(t, key)
            stop = hx < BIG or em < BIG or probes + 1 >= self.probe
            if hx < BIG:
                res = t * LN + hx
            t, probes = (t + 1) & self.tmask, probes + 1
            if stop:
                break
        return res

    def h_claim(self, key):
        """find-or-insert -> (flat index, err flag)."""
        t0 = self.home(key)
        hx, em = self.tile(t0, key)
        if hx < BIG:
            return t0 * LN + hx, False
        if em < BIG:
            self.p("hk", t0 * LN + em, key)
            return t0 * LN + em, False
        if 1 >= self.probe:
            return -1, True
        t, probes, res = (t0 + 1) & self.tmask, 1, -1
        while True:
            hx, em = self.tile(t, key)
            ins = hx >= BIG and em < BIG
            if hx < BIG:
                res = t * LN + hx
            if ins:
                res = t * LN + em
                self.p("hk", res, key)
            stop = hx < BIG or ins or probes + 1 >= self.probe
            t, probes = (t + 1) & self.tmask, probes + 1
            if stop:
                break
        return res, res < 0

    def pos_key(self, lane, acc):
        return lane * self.cfg.accounts + acc + 1

    def pos_get(self, lane, acc):
        """-> (amt, avail) as signed 64-bit ints; zeros when absent."""
        e = self.h_find(self.pos_key(lane, acc))
        if e < 0:
            return 0, 0
        return (self.g64("ha_lo", "ha_hi", e), self.g64("hv_lo", "hv_hi", e))

    def pos_set(self, lane, acc, amt, avail):
        e, err = self.h_claim(self.pos_key(lane, acc))
        if e >= 0:
            self.p64("ha_lo", "ha_hi", e, amt)
            self.p64("hv_lo", "hv_hi", e, avail)
        return err

    def fill_one(self, lane, acc, sgn_fill):
        """fillOrder's position half (KProcessor.java:276-287), fixed
        mode: delete-at-zero writes (0, 0)."""
        amt, avail = self.pos_get(lane, acc)
        na, nv = _i64(amt + sgn_fill), _i64(avail + sgn_fill)
        return self.pos_set(lane, acc, na, 0 if na == 0 else nv)

    def release_margin(self, lane, acc, o_isbuy, o_price, o_size):
        """postRemoveAdjustments (KProcessor.java:325-333): returns the
        balance credit and applies the avail adjustment."""
        amt, avail = self.pos_get(lane, acc)
        adj, rel = _margin(o_isbuy, o_price, o_size, amt, avail)
        if adj != 0:
            if self.pos_set(lane, acc, amt, _i64(avail + adj)):
                self.set_err(LERR_HASH_FULL)
        return rel

    # -- position hash (java): 128-bit keys as 4 int32 words, tombstones
    def jhome(self, key):
        kal, kah, kbl, kbh = key
        h = (_i32(kal * -1640531527) ^ _i32(kah * -2048144789)
             ^ _i32(kbl * -1028477387) ^ _i32(kbh * 69069))
        return (h >> 7) & self.tmask

    def jtile(self, t, key):
        """-> lane minima of tile t: live match, empty, reusable (empty
        or tombstone)."""
        sl = slice(t * LN, (t + 1) * LN)
        hs = self.f["hstate"][sl]
        eq = hs == 1
        for plane, w in zip(_JKEY_PLANES, key):
            eq = eq & (self.f[plane][sl] == w)
        return (self.minwhere(eq, self.ci), self.minwhere(hs == 0, self.ci),
                self.minwhere(hs != 1, self.ci))

    def jfind(self, key):
        """-> (flat entry or -1, err). Tombstones are passed over, an
        empty slot ends the probe; err when nothing was found and the
        probe bound was reached."""
        t0 = self.jhome(key)
        hx, em, _ = self.jtile(t0, key)
        if hx < BIG:
            return t0 * LN + hx, False
        if em < BIG or 1 >= self.probe:
            return -1, 1 >= self.probe
        t, probes, res = (t0 + 1) & self.tmask, 1, -1
        while True:
            hx, em, _ = self.jtile(t, key)
            stop = hx < BIG or em < BIG or probes + 1 >= self.probe
            if hx < BIG:
                res = t * LN + hx
            t, probes = (t + 1) & self.tmask, probes + 1
            if stop:
                break
        return res, res < 0 and probes >= self.probe

    def jslot(self, key):
        """-> the live match if there is one, else the first reusable
        slot on the probe path, else -1."""
        t0 = self.jhome(key)
        hx, em, fr = self.jtile(t0, key)
        res = t0 * LN + hx if hx < BIG else -1
        reuse = t0 * LN + fr if fr < BIG else -1
        if not (hx < BIG or em < BIG or 1 >= self.probe):
            t, probes = (t0 + 1) & self.tmask, 1
            while True:
                hx, em, fr = self.jtile(t, key)
                if reuse < 0 and fr < BIG:
                    reuse = t * LN + fr
                if hx < BIG:
                    res = t * LN + hx
                stop = hx < BIG or em < BIG or probes + 1 >= self.probe
                t, probes = (t + 1) & self.tmask, probes + 1
                if stop:
                    break
        return res if res >= 0 else reuse

    def jvals(self, e):
        if e < 0:
            return 0, 0
        return (self.g64("ha_lo", "ha_hi", e), self.g64("hv_lo", "hv_hi", e))

    def jwrite(self, e, key, amt, avail):
        if e >= 0:
            self.p("hstate", e, 1)
            for plane, w in zip(_JKEY_PLANES, key):
                self.p(plane, e, w)
            self.p64("ha_lo", "ha_hi", e, amt)
            self.p64("hv_lo", "hv_hi", e, avail)

    def jclaim(self, key, amt, avail):
        """insert-or-update `key`; a full probe path is HASH_FULL."""
        e = self.jslot(key)
        self.jwrite(e, key, amt, avail)
        if e < 0:
            self.set_err(LERR_HASH_FULL)

    def jfill_one(self, real, sgn_fill):
        """fillOrder, java (Q11, KProcessor.java:276-287): the first fill
        creates the real (aid, sid) entry; later fills read it but write,
        or at zero delete, the (amount, available) key. -> err flag."""
        e, err = self.jfind(real)
        if e < 0:
            if not err:
                self.jclaim(real, sgn_fill, sgn_fill)
            return err
        amt, avail = self.jvals(e)
        na, nv = _i64(amt + sgn_fill), _i64(avail + sgn_fill)
        if na == 0:
            te, _ = self.jfind(_jkey(amt, avail))
            if te >= 0:
                self.p("hstate", te, 2)     # tombstone
        else:
            self.jclaim(_jkey(amt, avail), na, nv)
        return err

    def jrelease_margin(self, real, o_isbuy, o_price, o_size):
        """postRemoveAdjustments, java: the 2-argument setPosition writes
        the adjustment to the (amount, available) key (Q11), the real
        entry stays as it was."""
        amt, avail = self.jvals(self.jfind(real)[0])
        adj, rel = _margin(o_isbuy, o_price, o_size, amt, avail)
        if adj != 0:
            self.jclaim(_jkey(amt, avail), amt, _i64(avail + adj))
        return rel

    # -- one call --------------------------------------------------------
    def run(self, msgs: dict, out: torch.Tensor):
        cfg, java = self.cfg, self.java
        B, E, FB, A = cfg.batch, cfg.max_fills, cfg.fill_cap, cfg.accounts
        BR = B // LN
        o = out.view(-1)
        cols = {k: msgs[k].tolist() for k in msg_fields(cfg)}
        hist = [0] * LN
        met = [0] * N_METRICS
        fill_total = 0

        def hist_obs(lane0, v):
            hist[lane0 + _hbucket(v)] += 1

        for m in range(B):
            act, lane, acc = cols["act"][m], cols["lane"][m], cols["aid"][m]
            limit, size = cols["price"][m], cols["size"][m]
            t_oidlo, t_oidhi = cols["oid_lo"][m], cols["oid_hi"][m]
            is_buy = act == L_BUY
            is_trade = is_buy or act == L_SELL
            is_cancel = act == L_CANCEL
            is_barrier = act in (L_PAYOUT_YES, L_PAYOUT_NO, L_REMOVE_SYMBOL)
            side = 0 if is_buy else 1
            opp = 1 - side
            sgn = 1 if is_buy else -1
            merged = False
            if java:
                # Q1: symbol 0's buys and sells share side 0
                merged = cols["flags"][m] & 1 != 0
                if merged:
                    side = opp = 0
                real = tuple(cols[k][m] for k in ("aidr_lo", "aidr_hi",
                                                   "sidr_lo", "sidr_hi"))
                # raw-id tables, before the message's own logic
                if is_trade or is_cancel or act in (L_CREATE, L_TRANSFER):
                    self.p("araw_lo", acc, real[0])
                    self.p("araw_hi", acc, real[1])
                if act == L_ADD_SYMBOL:
                    self.p("sraw_lo", lane, real[2])
                    self.p("sraw_hi", lane, real[3])

            bex_v = self.g("bex", lane) != 0
            bal = self.g64("bal_lo", "bal_hi", acc)
            bal_ok = self.g("bal_u", acc) != 0

            # ---- CREATE / TRANSFER / ADD_SYMBOL
            create_ok = act == L_CREATE and not bal_ok
            transfer_ok = (act == L_TRANSFER and bal_ok
                           and not bal < _i32(-size))
            addsym_ok = act == L_ADD_SYMBOL and not bex_v
            if create_ok:
                self.p("bal_u", acc, 1)
            if transfer_ok:
                self.bal_add(acc, size)
            if addsym_ok:
                self.p("bex", lane, 1)

            t_ok = t_acc = capr = append = do_rest = c_ok = False
            resid_v, nf, tail_lo, tail_hi, nempt_v = size, 0, 0, 0, 0

            # ---- TRADE
            if is_trade:
                valid = 0 <= limit < 126 and size > 0
                signed = size if is_buy else _i32(-size)
                if java:
                    # no valid gate: out-of-domain fields are fatal
                    if not valid:
                        self.set_err(LERR_JAVA_DOMAIN)
                    e_actor = self.jfind(real)[0]
                    pamt, pav = self.jvals(e_actor)
                else:
                    pamt, pav = self.pos_get(lane, acc)
                nsg = -signed
                adj = (max(min(pav, 0), nsg) if is_buy
                       else min(max(pav, 0), nsg))
                unit = limit if is_buy else _i32(limit - 100)
                risk = _muls64(_i32(signed + adj), unit)
                t_ok = ((java or valid) and bex_v and bal_ok
                        and not bal < risk)

                # phase 1: non-mutating sweep over a scratch copy of the
                # opposite side's sizes (reset on EVERY trade message)
                op_p = self.blk("bp", lane, opp)
                op_q = self.blk("bq", lane, opp)
                wsize = self.blk("bs", lane, opp).clone()
                fslot, fsize = [], []
                remaining = size if t_ok else 0
                ovf = emptied = False
                nempt = 0
                psg = op_p * sgn
                cross0 = (op_p - limit) * sgn <= 0
                while remaining > 0:
                    cross = (wsize > 0) & cross0
                    pstar = self.minwhere(cross, psg)
                    if pstar >= BIG:
                        break
                    if len(fslot) >= E:      # the max_fills envelope
                        ovf = True
                        break
                    at = cross & (psg == pstar)
                    sstar = self.minwhere(at, op_q)
                    flat = self.minwhere(at & (op_q == sstar), self.fi)
                    have = int(wsize[flat])
                    fill = min(remaining, have)
                    wsize[flat] = have - fill
                    fslot.append(flat)
                    fsize.append(fill)
                    remaining -= fill
                    emptied = have == fill
                    nempt += emptied
                residual, nfill = remaining, len(fslot)

                if java and t_ok and residual == 0 and emptied:
                    # Q2 (KProcessor.java:237): with the taker exhausted
                    # and its last maker emptied, the next best maker
                    # whose price >= limit (either direction) gives one
                    # zero-size fill
                    live = wsize > 0
                    gbest = self.minwhere(live, psg)
                    if gbest < BIG:
                        g_at = live & (psg == gbest)
                        g_ss = self.minwhere(g_at, op_q)
                        gfc = self.minwhere(g_at & (op_q == g_ss), self.fi)
                        if int(op_p[gfc]) >= limit:
                            if nfill >= E:
                                self.set_err(LERR_JAVA_CAP)
                            else:
                                fslot.append(gfc)
                                fsize.append(0)
                                nfill += 1

                # capacity envelope + Q9 bucket-tail echo; a merged (Q1)
                # book sees the sweep's sizes on its own side too
                w = wsize if merged else self.blk("bs", lane, side)
                wp = self.blk("bp", lane, side)
                wq = self.blk("bq", lane, side)
                free_flat = self.minwhere(w == 0, self.fi)
                rest_want = t_ok and residual > 0
                over = t_ok and (ovf or (rest_want and free_flat >= BIG))
                if java:
                    if over:     # fatal, never a per-message reject
                        self.set_err(LERR_JAVA_CAP)
                else:
                    capr = over
                t_acc = t_ok and not capr
                do_rest = rest_want and t_acc and free_flat < BIG
                same = (w > 0) & (wp == limit)
                nonempty = bool(same.any())
                smax = int(torch.where(same, wq, -1).max())
                tfc = (self.minwhere(same & (wq == smax), self.fi)
                       if nonempty else 0)
                tail_lo = int(self.blk("bo_lo", lane, side)[tfc])
                tail_hi = int(self.blk("bo_hi", lane, side)[tfc])
                append = nonempty and do_rest

                # phase 2: apply
                if t_acc:
                    self.bal_add(acc, -risk)
                    if adj != 0:
                        if java:
                            # 3-argument setPosition: the real key keeps
                            # its amount, only `available` moves
                            self.jwrite(e_actor, real, pamt, _i64(pav - adj))
                        elif self.pos_set(lane, acc, pamt, _i64(pav - adj)):
                            self.set_err(LERR_HASH_FULL)
                    self.blk("bs", lane, opp).copy_(wsize)
                    oa = self.blk("ba", lane, opp)
                    olo = self.blk("bo_lo", lane, opp)
                    ohi = self.blk("bo_hi", lane, opp)
                    for e2 in range(nfill):
                        flat, fill = fslot[e2], fsize[e2]
                        maid = int(oa[flat]) & AMASK if java else int(oa[flat])
                        mprice = int(op_p[flat])
                        pf = fill_total + e2
                        if pf < FB:
                            r0 = (1 + 5 * BR + (pf >> 7) * 5) * LN + (pf & 127)
                            for fld, v in enumerate((int(olo[flat]),
                                                     int(ohi[flat]), maid,
                                                     mprice, fill)):
                                o[r0 + fld * LN] = v
                        msz = -fill if is_buy else fill
                        if java:
                            mreal = (self.g("araw_lo", maid),
                                     self.g("araw_hi", maid)) + real[2:]
                            me = self.jfill_one(mreal, msz)
                            te = self.jfill_one(real, -msz)
                        else:
                            me = self.fill_one(lane, maid, msz)
                            te = self.fill_one(lane, acc, -msz)
                        self.bal_add(acc, _i32(-msz * (limit - mprice)))
                        if me or te:
                            self.set_err(LERR_HASH_FULL)
                    if fill_total + nfill > FB:
                        self.set_err(LERR_FILLBUF_FULL)
                    if do_rest:
                        seqv = self.g("seqc", lane)
                        ba = acc | (int(is_buy) << 30) if java else acc
                        slot = ((lane * 2 * self.NR + side * self.NR) * LN
                                + free_flat)
                        for key, v in (("bo_lo", t_oidlo), ("bo_hi", t_oidhi),
                                       ("ba", ba), ("bp", limit),
                                       ("bs", residual), ("bq", seqv)):
                            self.p(key, slot, v)
                        self.p("seqc", lane, _i32(seqv + 1))
                    resid_v, nf, nempt_v = residual, nfill, nempt

            # ---- CANCEL
            if is_cancel:
                hits = []
                for s in (0, 1):
                    hit = ((self.blk("bs", lane, s) > 0)
                           & (self.blk("bo_lo", lane, s) == t_oidlo)
                           & (self.blk("bo_hi", lane, s) == t_oidhi))
                    hits.append(self.minwhere(hit, self.fi))
                c_side = 0 if hits[0] < BIG else 1
                c_flat = hits[c_side]
                c_ba = (int(self.blk("ba", lane, c_side)[c_flat])
                        if c_flat < BIG else -1)
                if c_flat < BIG and (c_ba & AMASK if java else c_ba) == acc:
                    c_ok = True
                    # merged (Q1) books hold both directions in side 0, so
                    # java reads the direction from the ba tag bit
                    c_isbuy = (c_ba >> 30) & 1 == 1 if java else c_side == 0
                    c_price = int(self.blk("bp", lane, c_side)[c_flat])
                    c_size = int(self.blk("bs", lane, c_side)[c_flat])
                    self.blk("bs", lane, c_side)[c_flat] = 0
                    if java:
                        rel = self.jrelease_margin(real, c_isbuy, c_price,
                                                   c_size)
                    else:
                        rel = self.release_margin(lane, acc, c_isbuy,
                                                  c_price, c_size)
                    self.bal_add(acc, rel)

            # ---- BARRIERS (payout / remove; never routed in java mode)
            barrier_do = is_barrier and bex_v and not java
            if barrier_do:
                # wipe both sides with margin release, buy side first,
                # (price, seq) order within a side
                for ws in (0, 1):
                    pb = self.blk("bp", lane, ws)
                    qb = self.blk("bq", lane, ws)
                    ab = self.blk("ba", lane, ws)
                    sb = self.blk("bs", lane, ws)
                    while True:
                        used = sb > 0
                        pmin = self.minwhere(used, pb)
                        if pmin >= BIG:
                            break
                        at = used & (pb == pmin)
                        smin = self.minwhere(at, qb)
                        fc = self.minwhere(at & (qb == smin), self.fi)
                        o_aid, o_price = int(ab[fc]), int(pb[fc])
                        o_size = int(sb[fc])
                        sb[fc] = 0
                        self.bal_add(o_aid, self.release_margin(
                            lane, o_aid, ws == 0, o_price, o_size))
                self.p("bex", lane, 0)
                if act != L_REMOVE_SYMBOL:
                    # credit (YES) / just delete (NO) the lane's positions;
                    # a zeroed amt/avail IS deletion (keys stay)
                    klo = lane * A + 1
                    hk = self.f["hk"]
                    mine = (hk >= klo) & (hk < klo + A)
                    if act == L_PAYOUT_YES:
                        amt = (self.f["ha_lo"].to(torch.int64) & _M32) \
                            | (self.f["ha_hi"].to(torch.int64) << 32)
                        live = torch.nonzero(mine & (amt != 0)).view(-1)
                        for e in live.tolist():
                            self.bal_add(int(hk[e]) - klo,
                                         _i64(int(amt[e]) * size))
                    for key in ("ha_lo", "ha_hi", "hv_lo", "hv_hi"):
                        self.f[key].masked_fill_(mine, 0)

            # ---- dep plane (fixed mode) + histograms + outputs + metrics
            if t_acc:
                hist_obs(HIST_LANE0, nf)
            if not java and (t_acc or c_ok or barrier_do):
                newd = 0 if barrier_do else _i32(
                    self.g("dep", lane) + do_rest - nempt_v - c_ok)
                self.p("dep", lane, newd)
                if t_acc or c_ok:
                    hist_obs(HIST_LANE0 + N_HIST_BUCKETS, newd)
            if is_trade:
                ok = t_acc
            elif is_cancel:
                ok = c_ok
            elif act == L_CREATE:
                ok = create_ok
            elif act == L_TRANSFER:
                ok = transfer_ok
            elif act == L_ADD_SYMBOL:
                ok = addsym_ok
            elif is_barrier:
                ok = barrier_do
            else:
                ok = act == L_NOP
            flags = int(ok) | (int(capr) << 1) | (int(append) << 2)
            for k, v in enumerate((flags, resid_v, nf, tail_lo, tail_hi)):
                o[(1 + k * BR) * LN + m] = v
            deltas = (act != L_NOP, t_acc, nf,
                      _i32(size - resid_v) if t_acc else 0, capr,
                      is_trade and not t_ok, do_rest, c_ok,
                      is_cancel and not c_ok, transfer_ok,
                      ((act == L_CREATE and not create_ok)
                       or (act == L_TRANSFER and not transfer_ok)
                       or (act == L_ADD_SYMBOL and not addsym_ok)),
                      barrier_do)
            for k, d in enumerate(deltas):
                met[k] = _i32(met[k] + int(d))
            fill_total += nf

        # batch occupancy: ONE observation per non-empty call
        if met[0] > 0:
            hist_obs(HIST_LANE0 + 2 * N_HIST_BUCKETS, met[0])
        row0 = [0] * LN
        row0[0] = self.g("err", 0)
        row0[1] = fill_total
        row0[2:2 + N_METRICS] = met
        end = HIST_LANE0 + N_HIST * N_HIST_BUCKETS
        row0[HIST_LANE0:end] = hist[HIST_LANE0:end]
        o[:LN] = torch.tensor(row0, dtype=torch.int32)


def seq_scan_reference(cfg: SeqConfig, state: dict, stacked: dict
                       ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: threads the state (updated in
    place) through K chunks of (K, B) message columns and returns the
    (K, out_rows, 128) output planes."""
    K = stacked["act"].shape[0]
    out = torch.zeros((K, out_rows(cfg), LN), dtype=torch.int32,
                      device=stacked["act"].device)
    ref = _Reference(cfg, state)
    for k in range(K):
        ref.run({f: stacked[f][k] for f in msg_fields(cfg)}, out[k])
    return out


# ---------------------------------------------------------------------------
# the byte count of one dispatch

_ROW_BYTES = LN * 4
_JAVA_HASH = ("hka_lo", "hka_hi", "hkb_lo", "hkb_hi", "hstate",
              "ha_lo", "ha_hi", "hv_lo", "hv_hi")


def _java_home(cfg, kal, kah, kbl, kbh):
    """The java hash's home tile of 128-bit keys (4 int32 word arrays)."""
    def mul(v, c):
        return (v.astype(np.int64) * c) & 0xFFFFFFFF

    h = (mul(kal, 0x9E3779B9) ^ mul(kah, 0x85EBCA6B) ^ mul(kbl, 0xC2B2AE35)
         ^ mul(kbh, 69069))
    return (h.astype(np.uint32).view(np.int32) >> 7) & (cfg.caprows - 1)


def dispatch_bytes(cfg: SeqConfig, cols: dict, out, pre: dict,
                   post: dict, barriers: int) -> int:
    """Least bytes one dispatch of ONE chunk must move, counted from
    this batch (the byte bound of the kernel table, and the device
    plane's `bytes_per_batch`; the counterpart of the JAX package's
    `step_cost_analysis`). `cols` are the chunk's host message columns,
    `out` its output plane, `pre`/`post` the state before and after the
    dispatch, `barriers` the barriers it executed. Counted: its
    message columns read once; each state row its messages must read,
    once per plane (of each book-touching lane, all 2*NR `bs` rows, which
    the free-slot search and the sweep scan whole, and of the other book
    planes only what live orders need: the `bo`/`bp`/`bq` rows that hold
    a live order before the batch, and the `ba` rows of the makers
    filled (Q2 ghosts included), of the orders cancelled and of the
    orders a barrier settles; the lane rows, the balance rows of takers,
    makers and credited accounts, the hash rows at the home tiles of the
    takers' and makers' position keys — in java mode the 9 hash planes
    at the home tiles of the real 128-bit keys and the raw-aid rows of
    the makers — and for an executed PAYOUT the whole key plane plus the
    amount rows where the lane's keys sit, from the pre-batch hash);
    each state row it changed, written once (java's (amount, available)
    keys are counted there); the output's used rows."""
    B, NR, A = cfg.batch, cfg.nr, cfg.accounts
    java = cfg.compat == "java"
    act, lane, aid = cols["act"], cols["lane"], cols["aid"]
    res = unpack_out(cfg, out.cpu().numpy(), B)
    f_aid = res["fills"][1].astype(np.int64)
    f_lane = np.repeat(lane.astype(np.int64), res["nfill"])
    dev = act != L_NOP
    read = {}
    book = np.isin(act, [L_BUY, L_SELL, L_CANCEL, L_PAYOUT_YES,
                         L_PAYOUT_NO, L_REMOVE_SYMBOL])
    blk = (np.unique(lane[book]).astype(np.int64)[:, None] * 2 * NR
           + np.arange(2 * NR, dtype=np.int64)).ravel()
    read["bs"] = [blk]
    # the live orders before the batch, by (lane, oid) -> row
    at = torch.nonzero(pre["bs"] > 0)
    rows = at[:, 0].cpu().numpy().astype(np.int64)
    oids = ((pre["bo_lo"][at[:, 0], at[:, 1]].cpu().numpy().astype(np.int64)
             & 0xFFFFFFFF)
            | (pre["bo_hi"][at[:, 0], at[:, 1]].cpu().numpy()
               .astype(np.int64) << 32))
    del at
    live = np.intersect1d(rows, blk)
    for k in ("bo_lo", "bo_hi", "bp", "bq"):
        read[k] = [live]
    where = dict(zip(zip((rows // (2 * NR)).tolist(), oids.tolist()),
                     rows.tolist()))
    cancel = act == L_CANCEL
    c_oid = ((cols["oid_lo"][cancel].astype(np.int64) & 0xFFFFFFFF)
             | (cols["oid_hi"][cancel].astype(np.int64) << 32))
    wanted = (list(zip(f_lane.tolist(), res["fills"][0].tolist()))
              + list(zip(lane[cancel].tolist(), c_oid.tolist())))
    ba = [where[k] for k in wanted if k in where]
    settle = np.unique(lane[np.isin(act, [L_PAYOUT_YES, L_PAYOUT_NO,
                                          L_REMOVE_SYMBOL])])
    ba.extend(rows[np.isin(rows // (2 * NR), settle)].tolist())
    read["ba"] = [np.asarray(ba, np.int64)]
    for k in ("seqc", "bex") + (() if java else ("dep",)):
        read[k] = [lane[dev] >> 7]
    accs = [aid[dev].astype(np.int64), f_aid]
    trade = np.isin(act, [L_BUY, L_SELL, L_CANCEL])
    if java:
        def word(plane, idx):
            return post[plane].reshape(-1).cpu().numpy()[idx]

        nf = res["nfill"]
        keys = [np.concatenate([cols["aidr_lo"][trade],
                                word("araw_lo", f_aid)]),
                np.concatenate([cols["aidr_hi"][trade],
                                word("araw_hi", f_aid)]),
                np.concatenate([cols["sidr_lo"][trade],
                                np.repeat(cols["sidr_lo"], nf)]),
                np.concatenate([cols["sidr_hi"][trade],
                                np.repeat(cols["sidr_hi"], nf)])]
        tiles = _java_home(cfg, *keys)
        for k in _JAVA_HASH:
            read[k] = [tiles]
        read["araw_lo"] = read["araw_hi"] = [f_aid >> 7]
    else:
        keys = np.concatenate([lane[trade].astype(np.int64) * A + aid[trade]
                               + 1, f_lane * A + f_aid + 1])
        h = ((keys * -1640531527) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        tiles = (h >> 7) & (cfg.caprows - 1)
        for k in ("hk", "ha_lo", "ha_hi", "hv_lo", "hv_hi"):
            read[k] = [tiles]
    pays = np.flatnonzero(np.isin(act, [L_PAYOUT_YES, L_PAYOUT_NO]))
    if barriers and len(pays):
        hk = pre["hk"].cpu().numpy()
        read["hk"].append(np.arange(cfg.caprows, dtype=np.int64))
        for i in pays[act[pays] == L_PAYOUT_YES]:
            klo = int(lane[i]) * A + 1
            mine = (hk >= klo) & (hk < klo + A)
            r = np.flatnonzero(mine.any(axis=1))
            read["ha_lo"].append(r)
            read["ha_hi"].append(r)
            accs.append(hk[mine].astype(np.int64) - klo)
    acc_rows = np.concatenate(accs) >> 7
    for k in ("bal_lo", "bal_hi", "bal_u"):
        read[k] = [acc_rows]
    nread = sum(len(np.unique(np.concatenate(v))) for v in read.values())
    changed = sum(int((pre[k] != post[k]).any(dim=1).sum())
                  for k in state_keys(cfg))
    ft = int(out[0, 1])
    return (len(msg_fields(cfg)) * 4 * B + (nread + changed) * _ROW_BYTES
            + used_rows(cfg, ft) * _ROW_BYTES)


# ---------------------------------------------------------------------------
# the kernel's wrapper

# launches by the wrappers: of the seq_step chain kernel per
# instantiation (compat), and of the rows-in-use kernel (comparison
# launches included: a caller that wants the main path's count resets it
# first)
LAUNCHES = {"fixed": 0, "java": 0, "rows_in_use": 0}

# book rows per side that a trade stages in shared memory: the swept
# side's prices and seqs and the own side's sizes, prices and seqs (a
# deeper side is read in place); the launch sizes its shared memory for
# min(STAGE_ROWS, rows per side)
STAGE_ROWS = 16


def _check_planes(what: str, tensors: dict, shapes: dict, dev):
    for k, shape in shapes.items():
        t = tensors[k]
        if (t.device != dev or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{what} {k}: expected contiguous {shape} "
                             f"int32 on {dev}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")


def rows_in_use_reference(cfg: SeqConfig, bs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the rows-in-use kernel: (lanes, 2) int32,
    per (lane, side) one more than the highest of its `nr` rows of the
    size plane `bs` that holds a nonzero size; 0 for an empty side."""
    used = (bs.view(2 * cfg.lanes, cfg.nr, LN) != 0).any(dim=2)
    top = used * torch.arange(1, cfg.nr + 1, dtype=torch.int64,
                              device=bs.device)
    return top.amax(dim=1).to(torch.int32).view(cfg.lanes, 2)


def rows_in_use(cfg: SeqConfig, bs: torch.Tensor, out=None) -> torch.Tensor:
    """The rows a book pass must walk, per (lane, side), derived from the
    size plane (see `rows_in_use_reference`). CPU tensors take the plain
    version; CUDA tensors launch the kernel (into `out` when given) or
    raise."""
    dev = bs.device
    _check_planes("state plane", {"bs": bs},
                  {"bs": (2 * cfg.lanes * cfg.nr, LN)}, dev)
    if dev.type == "cpu":
        return rows_in_use_reference(cfg, bs)
    if dev.type != "cuda":
        raise ValueError(f"rows_in_use runs on cuda or cpu, not {dev}")
    from kme_tpu_torch import native

    if out is None:
        out = torch.empty((cfg.lanes, 2), dtype=torch.int32, device=dev)
    _check_planes("scratch", {"occ": out}, {"occ": (cfg.lanes, 2)}, dev)
    native.launch_rows_in_use(bs, out, cfg.nr)
    LAUNCHES["rows_in_use"] += 1
    return out


def _check(cfg: SeqConfig, state: dict, stacked: dict):
    dev = stacked["act"].device
    K = stacked["act"].shape[0]
    _check_planes("message column", stacked,
                  {f: (K, cfg.batch) for f in msg_fields(cfg)}, dev)
    _check_planes("state plane", state,
                  {k: (r, LN) for k, r in _plane_rows(cfg).items()}, dev)
    return dev, K


def seq_scan(cfg: SeqConfig, state: dict, stacked: dict) -> torch.Tensor:
    """K chunks in ONE launch of the seq_step chain kernel (the chunk loop
    runs inside it). The state dict's planes are updated in place;
    returns the (K, out_rows, 128) int32 output planes. CPU tensors take
    the plain version; CUDA tensors launch the kernels or raise.

    On the card a call is two launches on the current stream. With more
    than one row per side, `rows_in_use` first derives from `bs`, into a
    scratch this call allocates, how many rows of each (lane, side) can
    hold an order; the chain kernel walks only those, keeps the scratch
    current while it runs, and stages up to STAGE_ROWS of them in shared
    memory per trade. The scratch is no state: it is made anew from the
    planes on every call, so nothing can hand the kernel a stale one. A
    failed build or launch of either kernel raises."""
    dev, K = _check(cfg, state, stacked)
    if dev.type == "cpu":
        return seq_scan_reference(cfg, state, stacked)
    if dev.type != "cuda":
        raise ValueError(f"seq_scan runs on cuda or cpu, not {dev}")
    from kme_tpu_torch import native

    out = torch.zeros((K, out_rows(cfg), LN), dtype=torch.int32, device=dev)
    occ = torch.empty((cfg.lanes, 2), dtype=torch.int32, device=dev)
    if cfg.nr > 1:
        rows_in_use(cfg, state["bs"], out=occ)
    native.launch_seq_scan(
        [stacked[f] for f in msg_fields(cfg)]
        + [state[k] for k in state_keys(cfg)] + [out, occ],
        (K, cfg.lanes, cfg.nr, cfg.accounts, cfg.max_fills, cfg.batch,
         cfg.caprows, cfg.fill_cap, min(cfg.probe_max, cfg.caprows),
         min(STAGE_ROWS, cfg.nr)),
        java=cfg.compat == "java")
    LAUNCHES[cfg.compat] += 1
    return out


def seq_step(cfg: SeqConfig, state: dict, msgs: dict) -> torch.Tensor:
    """One micro-batch of (B,) message columns -> (out_rows, 128)."""
    stacked = {f: msgs[f].reshape(1, -1) for f in msg_fields(cfg)}
    return seq_scan(cfg, state, stacked)[0]


def msgs_to_device(cols: dict, device) -> dict:
    """numpy message columns (either mode's) -> int32 tensors on
    `device`."""
    return {f: torch.from_numpy(np.ascontiguousarray(cols[f], np.int32))
            .to(device) for f in MSG_FIELDS_JAVA if f in cols}
