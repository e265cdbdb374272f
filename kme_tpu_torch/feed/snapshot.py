"""Feed snapshots: cold-start book state off the checkpoint machinery.

Two related artifacts share the name "snapshot" on the read path:

* the DURABLE deriver snapshot (`feed-%09d.json` in a checkpoint
  directory) — the deriver's restore-complete state at a MatchOut
  offset, written with the same atomic-rename + fsync + digest-verify
  + prune discipline as the engine checkpoints (runtime/checkpoint.py;
  the chaos `ckpt.torn` / `ckpt.bitflip` injection points fire here
  too, and the loader falls back past corrupt files the same way). A
  restarted `kme-torch-feed` loads the newest valid one and replays the
  MatchOut tail from its offset — byte-identical frames come out, by
  deriver purity.

* the WIRE snapshot (`snapshot_frames`) — the SNAP_BEGIN / REFRESH
  depth images / SNAP_END sequence a subscriber receives on connect:
  the snapshot-then-deltas handover. The images carry each symbol's
  CURRENT per-symbol seq, and SNAP_END carries the `(group, epoch,
  out_seq)` watermark, so the subscriber knows exactly where the
  delta splice begins; every symbol the deriver has ever sequenced is
  included (empty books ship as empty images) so a late joiner's seq
  accounting starts aligned for all of them.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from typing import List, Optional, Tuple

from kme_tpu_torch.feed import frames as ff
from kme_tpu_torch.feed.derive import FeedDeriver
from kme_tpu_torch.runtime.checkpoint import (_fsync_dir, _post_write_faults,
                                        _prune)

_FEED_RE = re.compile(r"^feed-(\d+)\.json$")


def feed_snapshot_path(ckpt_dir: str, offset: int) -> str:
    return os.path.join(ckpt_dir, f"feed-{offset:09d}.json")


def _state_digest(state: dict) -> str:
    blob = json.dumps(state, sort_keys=True,
                      separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()


def save_feed_snapshot(ckpt_dir: str, deriver: FeedDeriver, offset: int,
                       keep: Optional[int] = None) -> str:
    """Persist the deriver's state at MatchOut `offset` (the NEXT
    offset to consume). Atomic: tmp write + fsync + rename + dir
    fsync, then the chaos injection points and the prune, exactly like
    _atomic_savez."""
    os.makedirs(ckpt_dir, exist_ok=True)
    state = deriver.state()
    doc = {"version": 1, "kind": "feed", "offset": int(offset),
           "digest": _state_digest(state), "state": state}
    path = feed_snapshot_path(ckpt_dir, offset)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, separators=(",", ":"))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(ckpt_dir)
    _post_write_faults(path)
    _prune(ckpt_dir, _FEED_RE, keep=keep)
    return path


def list_feed_snapshots(ckpt_dir: str) -> List[Tuple[int, str]]:
    """(offset, path) pairs, newest first."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _FEED_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    out.sort(reverse=True)
    return out


def _load_one(path: str) -> Tuple[int, dict]:
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("kind") != "feed":
        raise ValueError(f"{path}: not a feed snapshot")
    state = doc["state"]
    got = _state_digest(state)
    want = doc.get("digest")
    if want and got != want:
        raise ValueError(
            f"content digest mismatch in {path} (stored {want[:12]}…, "
            f"computed {got[:12]}…): corrupt snapshot")
    return int(doc["offset"]), state


def load_feed_snapshot(ckpt_dir: str
                       ) -> Optional[Tuple[int, FeedDeriver]]:
    """Newest valid (offset, restored deriver), falling back past
    torn/corrupt files like the engine checkpoint loader; None when no
    usable snapshot exists."""
    for _off, path in list_feed_snapshots(ckpt_dir):
        try:
            offset, state = _load_one(path)
        except (ValueError, KeyError, OSError):
            continue
        return offset, FeedDeriver.from_state(state)
    return None


def snapshot_frames(deriver: FeedDeriver, sids=None) -> bytes:
    """The wire handover: SNAP_BEGIN, one REFRESH depth image per
    symbol (current seq — images never consume new sequence numbers,
    so serving a snapshot cannot fork the frame stream), SNAP_END with
    the crc of the image bytes and the deriver's source watermark.
    `sids` restricts to a subscription subset; None means every symbol
    the deriver has ever sequenced."""
    ep, sq = deriver.watermark
    known = sorted(deriver._seqs)
    if sids is not None:
        want = set(sids)
        known = [s for s in known if s in want]
    images = b""
    for sid in known:
        bids, asks = deriver.book.depth(sid, 0)
        images += ff.encode_depth(deriver.group,
                                  deriver._seqs.get(sid, 0), ep, sq,
                                  sid, bids, asks, refresh=True)
    return (ff.encode_snap_begin(deriver.group, ep, sq, len(known))
            + images
            + ff.encode_snap_end(deriver.group, ep, sq, len(known),
                                 images))
