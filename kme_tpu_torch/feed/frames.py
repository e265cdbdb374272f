"""Feed frame codec: the sequenced binary market-data frames.

Same envelope discipline as the order wire (wire.py): every frame
opens with the 8-byte header `<BBBBI` — magic 0xB1, version, kind,
flags, u32 total length — validated in the same order with the same
error reasons, so one mental model covers order frames (kinds 0/2)
and feed frames (kinds 8-13). A feed socket never carries JSON after
the subscribe line, but the 0xB1 magic keeps the frames distinguishable
from JSON ('{' = 0x7B) anyway, like every other binary surface here.

All feed frames share a 28-byte common body prefix `<IQqq`:

  group      u32   producing group index (topic MatchOut.gK)
  seq        u64   PER-SYMBOL sequence number (see below)
  src_epoch  i64   producing leader epoch of the source MatchOut
                   record (-1 when the record was unstamped)
  src_seq    i64   source out_seq stamp (or topic offset for
                   unstamped streams; -1 when unknown)

`(group, src_epoch, src_seq)` is the WATERMARK — where in the write
stream this frame was derived. `seq` is the dissemination sequence in
the ITCH/MoldUDP sense (PAPERS.md), but numbered PER SYMBOL rather
than per channel: a subscriber filtered to a symbol subset still sees
a dense 1,2,3,... sequence for every symbol it watches, so gap/dup
detection survives server-side filtering (a global counter would look
full of holes to any filtered subscriber).

Kinds and kind-specific bodies (after the common prefix):

  FEED_DELTA  8   <qqq>  sid, price, size — the ABSOLUTE new total
                  size at (sid, side, price); size 0 deletes the
                  level. Side rides in flags bit0 (0=buy, 1=sell).
  FEED_TOB    9   <qqqqq> sid, bid_price, bid_size, ask_price,
                  ask_size (size 0 = that side empty; prices then 0)
  FEED_DEPTH  10  <qII>  sid, nbid, nask, then nbid+nask <qq>
                  (price, size) pairs, bids best-first then asks
                  best-first. flags bit2 (REFRESH) marks a full-book
                  authoritative image (snapshot / resync); without it
                  the frame is an advisory top-N view and builders
                  must not apply it.
  FEED_SNAP_BEGIN 11  <II> n_frames, depth (0 = full) — opens a
                  snapshot: the next n_frames frames are REFRESH
                  depth images.
  FEED_SNAP_END   12  <II> n_frames, crc32 of the n_frames depth
                  frame bytes between BEGIN and END.
  FEED_RESYNC 13  <q> sid — the server conflated this symbol for
                  this subscriber; a REFRESH depth image for the sid
                  follows. sid -1 means every subscribed symbol.

Flags: bit0 SELL side (deltas), bit1 CONFLATED (server-degraded
top-of-book / advisory), bit2 REFRESH (authoritative full-depth
image).
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import List, Optional, Tuple

from kme_tpu_torch.wire import WIRE_MAGIC, WIRE_VERSION

FEED_DELTA = 8
FEED_TOB = 9
FEED_DEPTH = 10
FEED_SNAP_BEGIN = 11
FEED_SNAP_END = 12
FEED_RESYNC = 13
_FEED_KINDS = (FEED_DELTA, FEED_TOB, FEED_DEPTH, FEED_SNAP_BEGIN,
               FEED_SNAP_END, FEED_RESYNC)

FEED_FLAG_SELL = 1
FEED_FLAG_CONFLATED = 2
FEED_FLAG_REFRESH = 4

_HDR = struct.Struct("<BBBBI")
_COMMON = struct.Struct("<IQqq")          # group, seq, src_epoch, src_seq
_DELTA_BODY = struct.Struct("<qqq")       # sid, price, size
_TOB_BODY = struct.Struct("<qqqqq")       # sid, bp, bs, ap, asz
_DEPTH_HEAD = struct.Struct("<qII")       # sid, nbid, nask
_PAIR = struct.Struct("<qq")              # price, size
_SNAP_BODY = struct.Struct("<II")         # n_frames, depth / crc32
_RESYNC_BODY = struct.Struct("<q")        # sid

_PREFIX = _HDR.size + _COMMON.size        # 36
DELTA_SIZE = _PREFIX + _DELTA_BODY.size   # 60
TOB_SIZE = _PREFIX + _TOB_BODY.size       # 76
SNAP_SIZE = _PREFIX + _SNAP_BODY.size     # 44
RESYNC_SIZE = _PREFIX + _RESYNC_BODY.size # 44

# a depth image of a full 126-price-level book both sides is ~4KB;
# the cap only exists so a corrupt length prefix cannot make a reader
# allocate unbounded memory before the pair count check catches it
_MAX_FRAME = 1 << 20


class FeedFrameError(ValueError):
    """A feed frame failed validation. `reason` mirrors
    wire.WireFrameError: "truncated", "bad_magic", "version_skew",
    "bad_kind", "bad_length"."""

    def __init__(self, reason: str, detail: str) -> None:
        super().__init__(f"bad feed frame ({reason}): {detail}")
        self.reason = reason


@dataclasses.dataclass
class FeedFrame:
    """One decoded feed frame. Only the fields of its kind are
    meaningful; `raw` is the exact encoded bytes (kept on both encode
    and decode so fan-out and byte-identity checks never re-encode)."""

    kind: int
    flags: int
    group: int
    seq: int
    src_epoch: int
    src_seq: int
    sid: int = 0
    price: int = 0
    size: int = 0
    bid_price: int = 0
    bid_size: int = 0
    ask_price: int = 0
    ask_size: int = 0
    bids: Tuple[Tuple[int, int], ...] = ()
    asks: Tuple[Tuple[int, int], ...] = ()
    count: int = 0
    depth: int = 0
    crc: int = 0
    raw: bytes = b""

    @property
    def side(self) -> int:
        """0 = buy side, 1 = sell side (flags bit0)."""
        return 1 if self.flags & FEED_FLAG_SELL else 0

    @property
    def conflated(self) -> bool:
        return bool(self.flags & FEED_FLAG_CONFLATED)

    @property
    def refresh(self) -> bool:
        return bool(self.flags & FEED_FLAG_REFRESH)


def _envelope(kind: int, flags: int, group: int, seq: int,
              src_epoch: int, src_seq: int, body: bytes) -> bytes:
    length = _PREFIX + len(body)
    return (_HDR.pack(WIRE_MAGIC, WIRE_VERSION, kind, flags, length)
            + _COMMON.pack(group, seq, src_epoch, src_seq) + body)


def encode_delta(group: int, seq: int, src_epoch: int, src_seq: int,
                 sid: int, side: int, price: int, size: int) -> bytes:
    flags = FEED_FLAG_SELL if side else 0
    return _envelope(FEED_DELTA, flags, group, seq, src_epoch, src_seq,
                     _DELTA_BODY.pack(sid, price, size))


def encode_tob(group: int, seq: int, src_epoch: int, src_seq: int,
               sid: int, bp: int, bs: int, ap: int, asz: int,
               conflated: bool = False) -> bytes:
    flags = FEED_FLAG_CONFLATED if conflated else 0
    return _envelope(FEED_TOB, flags, group, seq, src_epoch, src_seq,
                     _TOB_BODY.pack(sid, bp, bs, ap, asz))


def encode_depth(group: int, seq: int, src_epoch: int, src_seq: int,
                 sid: int, bids, asks, refresh: bool = False) -> bytes:
    flags = FEED_FLAG_REFRESH if refresh else 0
    body = _DEPTH_HEAD.pack(sid, len(bids), len(asks)) + b"".join(
        _PAIR.pack(p, s) for p, s in bids) + b"".join(
        _PAIR.pack(p, s) for p, s in asks)
    return _envelope(FEED_DEPTH, flags, group, seq, src_epoch, src_seq,
                     body)


def encode_snap_begin(group: int, src_epoch: int, src_seq: int,
                      n_frames: int, depth: int = 0) -> bytes:
    return _envelope(FEED_SNAP_BEGIN, 0, group, 0, src_epoch, src_seq,
                     _SNAP_BODY.pack(n_frames, depth))


def encode_snap_end(group: int, src_epoch: int, src_seq: int,
                    n_frames: int, payload: bytes) -> bytes:
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return _envelope(FEED_SNAP_END, 0, group, 0, src_epoch, src_seq,
                     _SNAP_BODY.pack(n_frames, crc))


def encode_resync(group: int, seq: int, src_epoch: int, src_seq: int,
                  sid: int) -> bytes:
    return _envelope(FEED_RESYNC, FEED_FLAG_CONFLATED, group, seq,
                     src_epoch, src_seq, _RESYNC_BODY.pack(sid))


def _check_feed_header(buf, off: int, remaining: int) -> Tuple[int, int, int]:
    """Validate one feed frame header at `off`; returns (kind, flags,
    length). Same checks, same order, same reasons as the order-frame
    validator (wire._check_frame_header)."""
    if remaining < _HDR.size:
        raise FeedFrameError(
            "truncated", f"{remaining} byte(s) at offset {off}, header "
            f"needs {_HDR.size}")
    magic, version, kind, flags, length = _HDR.unpack_from(buf, off)
    if magic != WIRE_MAGIC:
        raise FeedFrameError(
            "bad_magic", f"0x{magic:02X} at offset {off} "
            f"(expected 0x{WIRE_MAGIC:02X})")
    if version != WIRE_VERSION:
        raise FeedFrameError(
            "version_skew", f"version {version} at offset {off} "
            f"(this build speaks {WIRE_VERSION})")
    if kind not in _FEED_KINDS:
        raise FeedFrameError(
            "bad_kind", f"kind {kind} at offset {off} (feed frames are "
            f"{_FEED_KINDS[0]}..{_FEED_KINDS[-1]})")
    if length < _PREFIX or length > _MAX_FRAME:
        raise FeedFrameError(
            "bad_length", f"length prefix {length} at offset {off} "
            f"(feed frames are {_PREFIX}..{_MAX_FRAME} bytes)")
    if remaining < length:
        raise FeedFrameError(
            "truncated", f"{remaining} byte(s) at offset {off}, frame "
            f"declares {length}")
    return kind, flags, length


def decode_feed(buf, off: int = 0) -> Tuple[FeedFrame, int]:
    """Decode one feed frame at `off`; returns (frame, next_offset).
    THE authority for the feed format — every reader (builder, bench
    subscribers, chaos assertions) decodes through here."""
    kind, flags, length = _check_feed_header(buf, off, len(buf) - off)
    group, seq, src_epoch, src_seq = _COMMON.unpack_from(
        buf, off + _HDR.size)
    f = FeedFrame(kind, flags, group, seq, src_epoch, src_seq,
                  raw=bytes(buf[off:off + length]))
    body_off = off + _PREFIX
    body_len = length - _PREFIX
    if kind == FEED_DELTA:
        if body_len != _DELTA_BODY.size:
            raise FeedFrameError(
                "bad_length", f"delta body {body_len} bytes at offset "
                f"{off} (expected {_DELTA_BODY.size})")
        f.sid, f.price, f.size = _DELTA_BODY.unpack_from(buf, body_off)
    elif kind == FEED_TOB:
        if body_len != _TOB_BODY.size:
            raise FeedFrameError(
                "bad_length", f"tob body {body_len} bytes at offset "
                f"{off} (expected {_TOB_BODY.size})")
        (f.sid, f.bid_price, f.bid_size, f.ask_price,
         f.ask_size) = _TOB_BODY.unpack_from(buf, body_off)
    elif kind == FEED_DEPTH:
        if body_len < _DEPTH_HEAD.size:
            raise FeedFrameError(
                "bad_length", f"depth body {body_len} bytes at offset "
                f"{off} (head needs {_DEPTH_HEAD.size})")
        f.sid, nbid, nask = _DEPTH_HEAD.unpack_from(buf, body_off)
        need = _DEPTH_HEAD.size + (nbid + nask) * _PAIR.size
        if body_len != need:
            raise FeedFrameError(
                "bad_length", f"depth body {body_len} bytes at offset "
                f"{off} ({nbid}+{nask} pairs need {need})")
        p = body_off + _DEPTH_HEAD.size
        f.bids = tuple(_PAIR.unpack_from(buf, p + i * _PAIR.size)
                       for i in range(nbid))
        p += nbid * _PAIR.size
        f.asks = tuple(_PAIR.unpack_from(buf, p + i * _PAIR.size)
                       for i in range(nask))
    elif kind in (FEED_SNAP_BEGIN, FEED_SNAP_END):
        if body_len != _SNAP_BODY.size:
            raise FeedFrameError(
                "bad_length", f"snap body {body_len} bytes at offset "
                f"{off} (expected {_SNAP_BODY.size})")
        a, b = _SNAP_BODY.unpack_from(buf, body_off)
        f.count = a
        if kind == FEED_SNAP_BEGIN:
            f.depth = b
        else:
            f.crc = b
    else:  # FEED_RESYNC
        if body_len != _RESYNC_BODY.size:
            raise FeedFrameError(
                "bad_length", f"resync body {body_len} bytes at offset "
                f"{off} (expected {_RESYNC_BODY.size})")
        (f.sid,) = _RESYNC_BODY.unpack_from(buf, body_off)
    return f, off + length


def decode_feed_frames(buf) -> List[FeedFrame]:
    """Whole-buffer decode through the per-frame authority."""
    out: List[FeedFrame] = []
    off = 0
    while off < len(buf):
        f, off = decode_feed(buf, off)
        out.append(f)
    return out


def feed_frame_length(buf, off: int = 0) -> Optional[int]:
    """Length of the frame starting at `off`, or None when fewer than
    8 header bytes are buffered. For socket readers: the fixed header
    fields are validated now so garbage fails fast, but an incomplete
    BODY is not an error here — the caller is still buffering."""
    if len(buf) - off < _HDR.size:
        return None
    magic, version, kind, _flags, length = _HDR.unpack_from(buf, off)
    if magic != WIRE_MAGIC:
        raise FeedFrameError(
            "bad_magic", f"0x{magic:02X} at offset {off} "
            f"(expected 0x{WIRE_MAGIC:02X})")
    if version != WIRE_VERSION:
        raise FeedFrameError(
            "version_skew", f"version {version} at offset {off} "
            f"(this build speaks {WIRE_VERSION})")
    if kind not in _FEED_KINDS:
        raise FeedFrameError(
            "bad_kind", f"kind {kind} at offset {off} (feed frames are "
            f"{_FEED_KINDS[0]}..{_FEED_KINDS[-1]})")
    if length < _PREFIX or length > _MAX_FRAME:
        raise FeedFrameError(
            "bad_length", f"length prefix {length} at offset {off} "
            f"(feed frames are {_PREFIX}..{_MAX_FRAME} bytes)")
    return length
