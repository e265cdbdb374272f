"""Leader-epoch lease: the fencing token behind exactly-once output.

The reference left Kafka's exactly-once path commented out
(KProcessor.java:29) and ran at-least-once; we replace the transactional
coordinator with the two cheap primitives a deterministic engine needs:

- a monotonically increasing **epoch** handed to each serve incarnation
  (this module: a JSON lease file next to the checkpoints), and
- broker-side **fencing + idempotent produce** keyed on the
  ``(epoch, out_seq)`` stamp each leader puts on its MatchOut records
  (bridge/broker.py).

The lease file is NOT a distributed lock — single-host supervision
(bridge/supervise.py) means at most one writer mutates it at a time.
Races between a dying leader and a promoting standby are resolved where
it matters, at the broker: the larger epoch fences the smaller one, so
even a stale incarnation that still holds an old epoch can never make a
write visible (its produce raises BrokerFenced). ``steal`` exists for
the ``lease.steal`` fault point: it simulates exactly that split-brain
by advancing the epoch out from under the running leader.
"""

from __future__ import annotations

import json
import os
import time

LEASE_FILE = "lease.json"


def _path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, LEASE_FILE)


def read(ckpt_dir: str) -> dict:
    """The raw lease record; {} when absent or unreadable (a torn lease
    write loses at most the latest grant — the next acquire re-reads
    epoch 0 and the broker's recovered fence still rejects true
    staleness, so corruption degrades to a slower restart, not a
    duplicate)."""
    try:
        with open(_path(ckpt_dir), encoding="utf-8") as f:
            rec = json.load(f)
        return rec if isinstance(rec, dict) else {}
    except (OSError, ValueError):
        return {}


def current_epoch(ckpt_dir: str) -> int:
    """Highest epoch ever granted from this checkpoint dir (0 = none)."""
    try:
        return int(read(ckpt_dir).get("epoch", 0))
    except (TypeError, ValueError):
        return 0


def _grant(ckpt_dir: str, role: str, events=None) -> int:
    os.makedirs(ckpt_dir, exist_ok=True)
    epoch = current_epoch(ckpt_dir) + 1
    tmp = _path(ckpt_dir) + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"epoch": epoch, "pid": os.getpid(),
                   "time": time.time(), "role": role}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, _path(ckpt_dir))
    if events is not None:
        # flight recorder: every epoch transition is a fencing event —
        # the caller's EventLog, so the timeline attributes the grant
        # to the process that took it. No pid in the payload (the
        # lease file keeps it): event bytes stay replay-deterministic,
        # which the sim's timeline-digest verdict depends on
        try:
            events.emit("lease.steal" if role == "stolen"
                        else "lease.grant",
                        severity="warn" if role == "stolen" else "info",
                        epoch=epoch, role=role)
        except Exception:
            pass
    return epoch


def acquire(ckpt_dir: str, events=None) -> int:
    """Grant the next leader epoch to the calling process."""
    return _grant(ckpt_dir, "leader", events=events)


def steal(ckpt_dir: str, events=None) -> int:
    """Advance the epoch WITHOUT the current leader's cooperation (the
    ``lease.steal`` split-brain drill — and the reshard coordinator's
    per-group fence)."""
    return _grant(ckpt_dir, "stolen", events=events)
