"""Wire schema: the reference's JSON Order message, byte-compatible.

A copy of `kme_tpu/wire.py`, so the port imports nothing of
`kme_tpu`. The reference's serde is Jackson over a POJO with public
fields declared in the order action, oid, aid, sid, price, size, next,
prev (KProcessor.java:448-475), serialized compactly with fields in
declaration order and `next`/`prev` always present (null when unset —
quirk Q9). Incoming messages are parsed by field name; missing fields
default to 0 / null (Jackson primitive defaults).

`WireBatch` is the columnar batch of the native host path. The binary
order frames, the reject-annotation records and the exactly-once
`ProduceStamp` are the broker's and the TCP layer's (bridge/).
"""

from __future__ import annotations

import dataclasses
import json
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

_FIELDS = ("action", "oid", "aid", "sid", "price", "size")


# ---------------------------------------------------------------------------
# Binary order frame: the length-prefixed fixed-width twin of
# the JSON order message — the same zero-copy idea as the journal's
# 96-byte record framing (telemetry/journal.py MAGIC/_REC), promoted to
# a first-class wire protocol. JSON stays accepted on the same socket
# (COMPAT.md): every JSON message begins with '{' (0x7B) and every
# binary frame with WIRE_MAGIC (0xB1), so one peek at the first byte
# negotiates the encoding per message with zero configuration.
#
# Layout (little-endian, 72 bytes, struct "<BBBBI8q"):
#
#   off size field
#   0   1    magic    0xB1 (never 0x7B — JSON auto-detect)
#   1   1    version  WIRE_VERSION (1); anything else is version skew
#   2   1    kind     FRAME_ORDER (0) order; FRAME_PRODUCE (2) is the
#                     TCP produce envelope (bridge/tcp.py) — same
#                     header so one validator covers both
#   3   1    flags    bit0 next present, bit1 prev present (the
#                     nullable POJO pointer fields, quirk Q9); bit2
#                     trace word present: the frame carries
#                     one trailing int64 — the deterministic per-order
#                     trace id (telemetry/dtrace.py) — and its length
#                     prefix is FRAME_SIZE_TRACED
#   4   4    length   total frame bytes (= FRAME_SIZE for kind 0, or
#                     FRAME_SIZE_TRACED when flags bit2 is set) — the
#                     length prefix; a mismatch is rejected before
#                     any field is read, so a corrupt/oversized prefix
#                     can never walk the decoder off the buffer
#   8   64   action oid aid sid price size next prev, int64 each
#   72  8    trace id (int64) — ONLY when flags bit2 is set
#
# The admitted VALUE is unchanged: a binary frame decodes to the exact
# OrderMsg its JSON twin parses to, and the broker stores the canonical
# Jackson line (order_json) — durable logs, oracle replay and MatchOut
# bytes cannot tell which encoding carried a record. The trace word is
# transport-additive the same way the (epoch, out_seq) stamps are: it
# rides ALONGSIDE the record (broker.Record.tid), never inside the
# stored value, so tracing on/off cannot change a durable byte.

WIRE_MAGIC = 0xB1
WIRE_VERSION = 1
FRAME_ORDER = 0
FRAME_PRODUCE = 2      # TCP request envelope kind (bridge/tcp.py)
FLAG_NEXT = 1
FLAG_PREV = 2
FLAG_TID = 4           # trace word present (+8 byte frame)
_FRAME = struct.Struct("<BBBBI8q")
FRAME_SIZE = _FRAME.size          # 72
_TID_WORD = struct.Struct("<q")
FRAME_SIZE_TRACED = FRAME_SIZE + _TID_WORD.size   # 80
_FRAME_HDR = struct.Struct("<BBBBI")


class EnvelopeError(RuntimeError):
    """A wire value falls outside the Jackson-parseable envelope (int32
    price/size) — input on which the reference's deserializer throws and
    its Streams thread dies (KProcessor.java:513-517). Defined here, not
    in runtime/sequencer (which re-exports it), so the service's parse
    path imports no engine module: those pull in torch, seconds of import
    that a host-engine service would otherwise pay in its first batch."""


class WireFrameError(ValueError):
    """A binary frame failed validation. `reason` is one of
    "truncated", "bad_magic", "version_skew", "bad_kind",
    "bad_length"; `code` is always REJ_MALFORMED — a broken frame is
    dropped before the engine exactly like broken JSON (rej table
    code 6), never silently skipped."""

    def __init__(self, reason: str, detail: str) -> None:
        super().__init__(f"bad wire frame ({reason}): {detail}")
        self.reason = reason
        self.code = REJ_MALFORMED


def encode_frame(m: "OrderMsg", tid: Optional[int] = None) -> bytes:
    """One OrderMsg -> one 72-byte binary frame (80 with a trace id:
    flags bit2 + trailing int64). Values beyond int64 raise
    (struct.error is a ValueError subclass here via OverflowError
    semantics) — callers stay on the JSON path, which carries arbitrary
    ints."""
    flags = (FLAG_NEXT if m.next is not None else 0) | \
            (FLAG_PREV if m.prev is not None else 0)
    length, tail = FRAME_SIZE, b""
    if tid is not None:
        flags |= FLAG_TID
        length = FRAME_SIZE_TRACED
        tail = _TID_WORD.pack(tid)
    return _FRAME.pack(WIRE_MAGIC, WIRE_VERSION, FRAME_ORDER, flags,
                       length, m.action, m.oid, m.aid, m.sid,
                       m.price, m.size,
                       0 if m.next is None else m.next,
                       0 if m.prev is None else m.prev) + tail


def encode_frames(msgs, tids=None) -> bytes:
    """OrderMsg sequence -> one contiguous buffer of binary frames.
    `tids` (parallel sequence, None entries allowed) attaches the
    per-order trace words."""
    if tids is None:
        return b"".join(encode_frame(m) for m in msgs)
    return b"".join(encode_frame(m, t) for m, t in zip(msgs, tids))


def _check_frame_header(buf, off: int, remaining: int) -> int:
    """Validate one frame header at `off`; returns the frame length.
    Raises WireFrameError exactly like the native validator
    (kme_front.cpp in the JAX package) — same checks, same order, same reasons."""
    if remaining < _FRAME_HDR.size:
        raise WireFrameError(
            "truncated", f"{remaining} byte(s) at offset {off}, header "
            f"needs {_FRAME_HDR.size}")
    magic, version, kind, flags, length = _FRAME_HDR.unpack_from(
        buf, off)
    if magic != WIRE_MAGIC:
        raise WireFrameError(
            "bad_magic", f"0x{magic:02X} at offset {off} "
            f"(expected 0x{WIRE_MAGIC:02X})")
    if version != WIRE_VERSION:
        raise WireFrameError(
            "version_skew", f"version {version} at offset {off} "
            f"(this build speaks {WIRE_VERSION})")
    if kind != FRAME_ORDER:
        raise WireFrameError(
            "bad_kind", f"kind {kind} at offset {off} (expected "
            f"{FRAME_ORDER})")
    expected = FRAME_SIZE_TRACED if flags & FLAG_TID else FRAME_SIZE
    if length != expected:
        raise WireFrameError(
            "bad_length", f"length prefix {length} at offset {off} "
            f"(order frames are exactly {expected} bytes with these "
            f"flags)")
    if remaining < expected:
        raise WireFrameError(
            "truncated", f"{remaining} byte(s) at offset {off}, frame "
            f"declares {expected}")
    return expected


def decode_frame_tid(buf, off: int = 0
                     ) -> Tuple["OrderMsg", Optional[int], int]:
    """Decode one frame at `off`; returns (msg, trace_id_or_None,
    next_offset). THE Python authority for the frame format — the
    native acceptor (kme_front.cpp in the JAX package) and the numpy batch path
    (parse_frames) are pinned byte-exact against it by
    tests/test_wire_fuzz.py."""
    flen = _check_frame_header(buf, off, len(buf) - off)
    (_m, _v, _k, flags, _len, action, oid, aid, sid, price, size,
     nxt, prv) = _FRAME.unpack_from(buf, off)
    tid = (_TID_WORD.unpack_from(buf, off + FRAME_SIZE)[0]
           if flags & FLAG_TID else None)
    return OrderMsg(action, oid, aid, sid, price, size,
                    nxt if flags & FLAG_NEXT else None,
                    prv if flags & FLAG_PREV else None), tid, off + flen


def decode_frame(buf, off: int = 0) -> Tuple["OrderMsg", int]:
    """decode_frame_tid without the trace word (the older
    shape; existing callers keep their two-tuple)."""
    m, _tid, nxt = decode_frame_tid(buf, off)
    return m, nxt


def decode_frames(buf) -> List["OrderMsg"]:
    """Whole-buffer decode through the per-frame authority."""
    out: List[OrderMsg] = []
    off = 0
    while off < len(buf):
        m, off = decode_frame(buf, off)
        out.append(m)
    return out


def decode_frames_tid(buf) -> List[Tuple["OrderMsg", Optional[int]]]:
    """Whole-buffer decode keeping the per-frame trace words."""
    out: List[Tuple[OrderMsg, Optional[int]]] = []
    off = 0
    while off < len(buf):
        m, tid, off = decode_frame_tid(buf, off)
        out.append((m, tid))
    return out


def is_binary_frame(first_byte: int) -> bool:
    """The per-message encoding negotiation: 0xB1 opens a binary
    frame, anything else (in practice '{' = 0x7B) is JSON."""
    return first_byte == WIRE_MAGIC


# Per-order reject reason codes (the value space of the opt-in REJ
# annotation records and of SeqSession.last_reasons).
REJ_NONE = 0
REJ_CAPACITY = 1
REJ_RISK = 2
REJ_CANCEL = 3
REJ_UNROUTABLE = 4
REJ_BARRIER = 5
REJ_MALFORMED = 6
REJ_OTHER = 7
REJ_UNSPECIFIED = 8
REJ_OVERLOAD = 9

REJ_NAMES = {
    REJ_NONE: "ok",
    REJ_CAPACITY: "rej_capacity",
    REJ_RISK: "rej_risk",
    REJ_CANCEL: "rej_cancel",
    REJ_UNROUTABLE: "rej_unroutable",
    REJ_BARRIER: "rej_barrier",
    REJ_MALFORMED: "rej_malformed",
    REJ_OTHER: "rej_other",
    REJ_UNSPECIFIED: "rej_unspecified",
    REJ_OVERLOAD: "rej_overload",
}


def rej_name(code: int) -> str:
    return REJ_NAMES.get(code, f"rej_{code}")


def reason_for_reject(action: int) -> int:
    """Heuristic reason for engines that report no per-order cause
    (native/oracle): classify by the rejected wire action. Device
    sessions report exact codes instead (runtime/session.py)."""
    if action in (2, 3):          # BUY / SELL
        return REJ_RISK
    if action == 4:               # CANCEL
        return REJ_CANCEL
    if action in (1, 200):        # REMOVE_SYMBOL / PAYOUT
        return REJ_BARRIER
    if action in (0, 100, 101):   # ADD_SYMBOL / CREATE / TRANSFER
        return REJ_OTHER
    return REJ_UNSPECIFIED


def reject_reason_codes(nmsg, msg_index, act, ok, cap_reject, host_rejects):
    """Vectorized per-message reason codes from one device batch's
    routing + results: host-resolved rejects are unroutable; a device
    not-ok is capacity when the cap flag fired, else classified by the
    internal lane act (1/2 trade -> risk, 3 cancel, 7/8/9 barrier,
    other device ops -> other). Returns a (nmsg,) uint8 array."""
    reasons = np.zeros(nmsg, np.uint8)
    if host_rejects:
        reasons[list(host_rejects)] = REJ_UNROUTABLE
    if len(msg_index):
        act = np.asarray(act)
        bad = ~np.asarray(ok, bool)
        by_act = np.where(
            (act == 1) | (act == 2), REJ_RISK,
            np.where(act == 3, REJ_CANCEL,
                     np.where((act >= 7) & (act <= 9), REJ_BARRIER,
                              REJ_OTHER)))
        r = np.where(np.asarray(cap_reject, bool), REJ_CAPACITY,
                     by_act).astype(np.uint8)
        mi = np.asarray(msg_index)
        reasons[mi[bad]] = r[bad]
    return reasons


def rej_record_json(oid: int, aid: int, code: int,
                    detail: Optional[dict] = None) -> str:
    """The value of an opt-in "REJ"-keyed MatchOut annotation record
    (kme-serve --annotate-rejects): compact JSON naming the per-order
    reject cause. ADDITIVE — consumers keyed on IN/OUT are unaffected
    and the default stream stays byte-identical to the reference.

    `detail` appends extra keys in sorted order (rej_overload rows
    carry the observed backlog, active threshold, degradation state and
    backoff hint — the shed never reached the engine, so this record is
    its only durable trace). Without detail the bytes are unchanged
    from every prior release."""
    base = (f'{{"oid":{oid},"aid":{aid},"reason":{code},'
            f'"rej":"{rej_name(code)}"}}')
    if not detail:
        return base
    extra = ",".join(
        f'"{k}":{json.dumps(detail[k], separators=(",", ":"))}'
        for k in sorted(detail))
    return base[:-1] + "," + extra + "}"



@dataclasses.dataclass
class OrderMsg:
    """One wire message. Mirrors the reference Order POJO
    (KProcessor.java:448-475)."""

    action: int = 0
    oid: int = 0
    aid: int = 0
    sid: int = 0
    price: int = 0
    size: int = 0
    next: Optional[int] = None
    prev: Optional[int] = None

    def copy(self) -> "OrderMsg":
        return dataclasses.replace(self)


def parse_order(data: bytes | str) -> OrderMsg:
    """Parse an input JSON message the way Jackson does on the reference
    POJO: creator-bound value fields default to 0 when absent; the
    public `next`/`prev` fields are bound by name when present
    (null/absent -> None)."""
    obj = json.loads(data)
    if not isinstance(obj, dict):
        raise ValueError(f"order message must be a JSON object, got {type(obj)}")
    kw = {}
    for f in _FIELDS:
        v = obj.get(f, 0)
        if v is None:
            v = 0
        kw[f] = _as_int(f, v)
    msg = OrderMsg(**kw)
    for f in ("next", "prev"):
        v = obj.get(f)
        if v is not None:
            setattr(msg, f, _as_int(f, v))
    return msg


def _as_int(field: str, v) -> int:
    if not isinstance(v, int) or isinstance(v, bool):
        # Jackson would coerce or throw; we accept exact ints only
        # (floats with integral value are coerced like Jackson does).
        if isinstance(v, float) and v.is_integer():
            return int(v)
        raise ValueError(f"field {field!r} must be an integer, got {v!r}")
    return v


def order_json(action: int, oid, aid, sid, price, size,
               next: Optional[int] = None,
               prev: Optional[int] = None) -> str:
    """THE Jackson wire template (compact, declaration field order,
    next/prev always present — KProcessor.java:488). dumps_order and the
    session's reconstruction both go through it."""
    nxt = "null" if next is None else str(next)
    prv = "null" if prev is None else str(prev)
    return (
        f'{{"action":{action},"oid":{oid},"aid":{aid},"sid":{sid},'
        f'"price":{price},"size":{size},"next":{nxt},"prev":{prv}}}'
    )


def dumps_order(o: OrderMsg) -> str:
    """Serialize exactly like Jackson on the reference POJO."""
    return order_json(o.action, o.oid, o.aid, o.sid, o.price, o.size,
                      o.next, o.prev)


@dataclasses.dataclass(frozen=True)
class OutRecord:
    """One record on the output stream: key is "IN" (pre-processing echo,
    KProcessor.java:97) or "OUT" (result echo / fill event,
    KProcessor.java:124, 272-273)."""

    key: str
    value: OrderMsg

    def wire(self) -> str:
        """The `<key> <value>` line the reference consumer prints."""
        return f"{self.key} {dumps_order(self.value)}"


def wire_lines(records: Iterator[OutRecord]) -> Iterator[str]:
    for r in records:
        yield r.wire()


class WireBatch:
    """Columnar view of a message batch: the input format of the native
    host path (SeqSession.process_wire_buffer and submit consume it
    directly — router and reconstructor read the columns, so no
    per-message attribute walk runs on the hot path).

    Columns (numpy): action/oid/aid/sid/price/size/next/prev int64,
    hnext/hprev uint8 (1 = pointer present — Jackson binds next/prev from
    input too), plus tid int64 / htid uint8 for the additive trace word
    (zeros when no frame carried one). Values beyond int64 cannot be
    represented; builders raise OverflowError and callers stay on the
    OrderMsg-list path (which carries arbitrary ints)."""

    __slots__ = ("n", "action", "oid", "aid", "sid", "price", "size",
                 "next", "prev", "hnext", "hprev", "tid", "htid",
                 "_msgs")

    _COLS = ("action", "oid", "aid", "sid", "price", "size", "next",
             "prev")

    def __init__(self, n, cols, hnext, hprev, msgs=None, tid=None,
                 htid=None):
        self.n = n
        for f, v in zip(self._COLS, cols):
            setattr(self, f, v)
        self.hnext = hnext
        self.hprev = hprev
        if tid is None or htid is None:
            tid = np.zeros(n, np.int64)
            htid = np.zeros(n, np.uint8)
        self.tid = tid
        self.htid = htid
        self._msgs = msgs

    def record_tid(self, i: int) -> Optional[int]:
        """The trace word carried by row `i`, or None."""
        return int(self.tid[i]) if self.htid[i] else None

    def __len__(self) -> int:
        return self.n

    @classmethod
    def from_msgs(cls, msgs) -> "WireBatch":
        """OrderMsg sequence -> columns (ONE attribute walk; raises
        OverflowError on values beyond int64)."""
        n = len(msgs)
        cols = [np.fromiter((m.action for m in msgs), np.int64, n),
                np.fromiter((m.oid for m in msgs), np.int64, n),
                np.fromiter((m.aid for m in msgs), np.int64, n),
                np.fromiter((m.sid for m in msgs), np.int64, n),
                np.fromiter((m.price for m in msgs), np.int64, n),
                np.fromiter((m.size for m in msgs), np.int64, n),
                np.fromiter((0 if m.next is None else m.next
                             for m in msgs), np.int64, n),
                np.fromiter((0 if m.prev is None else m.prev
                             for m in msgs), np.int64, n)]
        hnext = np.fromiter((m.next is not None for m in msgs), np.uint8, n)
        hprev = np.fromiter((m.prev is not None for m in msgs), np.uint8, n)
        return cls(n, cols, hnext, hprev,
                   msgs if isinstance(msgs, list) else list(msgs))

    @classmethod
    def parse_buffer(cls, buf: bytes) -> "WireBatch":
        """Newline-separated order JSON -> columns, via the native parser
        (kme_wire.cpp kme_parse_*); a buffer with any line outside its
        integer/null subset is parsed whole through parse_order, so
        coercions and errors are exactly the Python authority's. Under
        KME_NATIVE=0 every buffer takes parse_order."""
        from kme_tpu_torch.native import load_library

        if not buf:
            # empty payload = zero messages (the native column pointers
            # are unallocated at n == 0)
            return cls._empty()
        lib = load_library()
        if lib is not None:
            h = lib.kme_parse_new()
            try:
                rc = lib.kme_parse_lines(h, buf, len(buf))
                if rc >= 0:
                    n = int(rc)
                    cols = [np.ctypeslib.as_array(
                        lib.kme_parse_col(h, i), (max(n, 1),))[:n].copy()
                        for i in range(8)]
                    hnext = np.ctypeslib.as_array(
                        lib.kme_parse_hnext(h), (max(n, 1),))[:n].copy()
                    hprev = np.ctypeslib.as_array(
                        lib.kme_parse_hprev(h), (max(n, 1),))[:n].copy()
                    return cls(n, cols, hnext, hprev)
            finally:
                lib.kme_parse_free(h)
        msgs = [parse_order(ln) for ln in buf.split(b"\n") if ln]
        return cls.from_msgs(msgs)

    @classmethod
    def _empty(cls) -> "WireBatch":
        return cls(0, [np.zeros(0, np.int64) for _ in range(8)],
                   np.zeros(0, np.uint8), np.zeros(0, np.uint8), [])

    @classmethod
    def parse_frames(cls, buf: bytes) -> "WireBatch":
        """Concatenated binary order frames -> columns, via the native
        decoder (kme_wire.cpp kme_parse_frames) when available, else a
        vectorized numpy view of the same fixed-width layout. Raises
        WireFrameError (always through the per-frame Python authority,
        so native and fallback surface identical errors) on the first
        invalid frame."""
        if not buf:
            return cls._empty()
        r = _parse_frames_native(buf, emit=False)
        if r is not None:
            return r[0]
        return cls._parse_frames_py(buf)

    @classmethod
    def _parse_frames_py(cls, buf: bytes) -> "WireBatch":
        """Pure-numpy frame decode: one frombuffer over the fixed
        72-byte records, vectorized validation; a traced (80-byte)
        frame anywhere drops to the variable-stride authority walk,
        and ANY invalidity re-walks the buffer through decode_frame so
        the raised error is exactly the authority's (first bad frame,
        field-priority order)."""
        import numpy as np

        nf, tail = divmod(len(buf), FRAME_SIZE)
        dt = np.dtype([("hdr", "<u1", (4,)), ("length", "<u4"),
                       ("v", "<i8", (8,))])
        a = np.frombuffer(buf, dt, count=nf)
        hdr = a["hdr"]
        bad = ((hdr[:, 0] != WIRE_MAGIC) | (hdr[:, 1] != WIRE_VERSION)
               | (hdr[:, 2] != FRAME_ORDER)
               | (a["length"] != FRAME_SIZE))
        if tail or bad.any() or (hdr[:, 3] & FLAG_TID).any():
            # traced frames shift every subsequent header, so the
            # fixed-stride view above is meaningless the moment one
            # appears. A uniformly-traced buffer (loadgen/bench stamp
            # EVERY frame) re-views at the 80-byte stride and stays
            # vectorized; only mixed/invalid buffers pay the walk,
            # which is the single authority for the error surface
            wb = cls._parse_frames_traced_py(buf)
            if wb is not None:
                return wb
            return cls._parse_frames_walk(buf)
        v = a["v"]
        cols = [np.ascontiguousarray(v[:, i]) for i in range(8)]
        flags = hdr[:, 3]
        return cls(nf, cols, (flags & 1).astype(np.uint8),
                   ((flags >> 1) & 1).astype(np.uint8))

    @classmethod
    def _parse_frames_traced_py(cls, buf: bytes
                                ) -> Optional["WireBatch"]:
        """Vectorized decode for a buffer of UNIFORM 80-byte traced
        frames (every header valid, every frame FLAG_TID): one
        frombuffer at the wider stride, same checks as the untraced
        fast path. Returns None — caller falls to the authority walk —
        for anything mixed, torn, or invalid."""
        import numpy as np

        nf, tail = divmod(len(buf), FRAME_SIZE_TRACED)
        if tail or nf == 0:
            return None
        dt = np.dtype([("hdr", "<u1", (4,)), ("length", "<u4"),
                       ("v", "<i8", (8,)), ("tid", "<i8")])
        a = np.frombuffer(buf, dt, count=nf)
        hdr = a["hdr"]
        bad = ((hdr[:, 0] != WIRE_MAGIC)
               | (hdr[:, 1] != WIRE_VERSION)
               | (hdr[:, 2] != FRAME_ORDER)
               | (a["length"] != FRAME_SIZE_TRACED)
               | ((hdr[:, 3] & FLAG_TID) == 0))
        if bad.any():
            return None
        v = a["v"]
        cols = [np.ascontiguousarray(v[:, i]) for i in range(8)]
        flags = hdr[:, 3]
        return cls(nf, cols, (flags & 1).astype(np.uint8),
                   ((flags >> 1) & 1).astype(np.uint8),
                   tid=np.ascontiguousarray(a["tid"]),
                   htid=np.ones(nf, np.uint8))

    @classmethod
    def _parse_frames_walk(cls, buf: bytes) -> "WireBatch":
        """Per-frame authority walk (decode_frame_tid): handles mixed
        72/80-byte buffers and raises the authoritative WireFrameError
        at the first bad frame."""
        import numpy as np

        pairs = decode_frames_tid(buf)
        wb = cls.from_msgs([m for m, _t in pairs])
        n = len(pairs)
        wb.tid = np.fromiter((0 if t is None else t
                              for _m, t in pairs), np.int64, n)
        wb.htid = np.fromiter((t is not None for _m, t in pairs),
                              np.uint8, n)
        return wb

    def msgs(self) -> list:
        """Materialize the OrderMsg view (lazily, for the Python paths;
        the native path never calls this)."""
        if self._msgs is None:
            act, oid, aid = self.action, self.oid, self.aid
            sid, pr, sz = self.sid, self.price, self.size
            nx, pv = self.next, self.prev
            hn, hp = self.hnext, self.hprev
            self._msgs = [
                OrderMsg(int(act[i]), int(oid[i]), int(aid[i]),
                         int(sid[i]), int(pr[i]), int(sz[i]),
                         int(nx[i]) if hn[i] else None,
                         int(pv[i]) if hp[i] else None)
                for i in range(self.n)]
        return self._msgs


def _parse_frames_native(buf: bytes, emit: bool):
    """Native frame decode (+ optional canonical-JSON emission).
    Returns (WireBatch, values-or-None), or None when the native
    library is unavailable (callers fall back to numpy/Python).
    Validation failures re-raise through decode_frames so the error is
    byte-identical to the pure-Python path's."""
    try:
        from kme_tpu_torch.native import load_library

        lib = load_library()
    except ImportError:  # pragma: no cover - packaging edge
        return None
    if lib is None:
        return None
    import ctypes

    import numpy as np

    h = lib.kme_parse_new()
    try:
        rc = lib.kme_parse_frames(h, buf, len(buf))
        if rc < 0:
            decode_frames(buf)  # raises the authoritative error
            raise AssertionError(
                "native rejected a buffer the authority accepts "
                f"(code {rc} at offset {lib.kme_parse_err_off(h)})")
        n = int(rc)
        if n == 0:
            return WireBatch._empty(), ([] if emit else None)
        cols = [np.ctypeslib.as_array(
            lib.kme_parse_col(h, i), (n,)).copy() for i in range(8)]
        hnext = np.ctypeslib.as_array(lib.kme_parse_hnext(h), (n,)).copy()
        hprev = np.ctypeslib.as_array(lib.kme_parse_hprev(h), (n,)).copy()
        tid = np.ctypeslib.as_array(lib.kme_parse_tid(h), (n,)).copy()
        htid = np.ctypeslib.as_array(lib.kme_parse_htid(h), (n,)).copy()
        wb = WireBatch(n, cols, hnext, hprev, tid=tid, htid=htid)
        values = None
        if emit:
            nbytes = int(lib.kme_parse_emit(h))
            raw = ctypes.string_at(lib.kme_parse_emit_buf(h), nbytes)
            off = np.ctypeslib.as_array(lib.kme_parse_emit_off(h),
                                        (n + 1,))
            values = [raw[off[i]:off[i + 1]].decode("ascii")
                      for i in range(n)]
        return wb, values
    finally:
        lib.kme_parse_free(h)


def batch_values(wb: "WireBatch") -> List[str]:
    """Canonical Jackson value line per row (order_json — the bytes
    the broker stores whatever encoding carried the record)."""
    act, oid, aid = wb.action, wb.oid, wb.aid
    sid, pr, sz = wb.sid, wb.price, wb.size
    nx, pv, hn, hp = wb.next, wb.prev, wb.hnext, wb.hprev
    return [order_json(int(act[i]), int(oid[i]), int(aid[i]),
                       int(sid[i]), int(pr[i]), int(sz[i]),
                       int(nx[i]) if hn[i] else None,
                       int(pv[i]) if hp[i] else None)
            for i in range(wb.n)]


def frames_to_values(buf: bytes) -> Tuple["WireBatch", List[str]]:
    """Binary produce path decode: concatenated frames -> (columns,
    canonical JSON value per record) without materializing per-record
    dicts. Native when available (kme_parse_frames + the pinned
    kme_parse_emit emitter, two C calls per batch); numpy + order_json
    otherwise. The values are byte-identical either way — the durable
    log cannot tell which encoding carried a record."""
    if not buf:
        return WireBatch._empty(), []
    r = _parse_frames_native(buf, emit=True)
    if r is not None:
        return r[0], r[1]
    wb = WireBatch._parse_frames_py(buf)
    return wb, batch_values(wb)


@dataclasses.dataclass(frozen=True)
class ProduceStamp:
    """The exactly-once produce stamp carried ALONGSIDE each MatchOut
    record (never inside the value — the visible `<key> <value>` stream
    stays byte-pinned against the reference, which shipped with Kafka's
    exactly-once path commented out, KProcessor.java:29).

    `epoch` is the producing leader's fencing token (bridge/lease.py —
    monotonic across incarnations and failovers); `out_seq` is the
    0-based position of the record in the deterministic output stream.
    Because the engine is deterministic, a crashed leader's replayed
    tail regenerates records with IDENTICAL stamps, which is exactly
    what lets the broker suppress them (bridge/broker.py idempotent
    produce) and consumers dedup defensively
    (bridge/consume.py DedupRing): duplicate detection needs no record
    hashing, only the cursor."""

    epoch: int
    out_seq: int


