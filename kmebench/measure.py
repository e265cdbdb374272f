"""The arithmetic of a run: completion times from the consumer's stamps,
rates, latency shares and percentiles, window deltas of the program's
latency histograms, and the comparison with the reference."""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence

import numpy as np


# -- completion and latency ---------------------------------------------

def record_times(fetch_t: np.ndarray, fetch_n: np.ndarray) -> np.ndarray:
    """Receipt time of every record: that of the fetch that brought it."""
    return np.repeat(np.asarray(fetch_t, np.float64),
                     np.asarray(fetch_n, np.int64))


def close_times(closes: np.ndarray, fetch_t, fetch_n) -> np.ndarray:
    """Receipt time of each message's closing record, in message order
    (MatchOut keeps the order of MatchIn)."""
    t = record_times(fetch_t, fetch_n)
    return t[np.asarray(closes, bool)[:len(t)]]


def completed_in(done: np.ndarray, t0: float, t1: float) -> int:
    return int(np.count_nonzero((done >= t0) & (done < t1)))


def latencies(done: np.ndarray, first: int, due: np.ndarray,
              unanswered_at: float) -> np.ndarray:
    """Due time to closing record of messages first .. first+len(due);
    a message never answered counts as answered at `unanswered_at`."""
    n = len(due)
    got = done[first:first + n]
    t = np.full(n, unanswered_at)
    t[:len(got)] = got
    return t - due


def share_within(lat: np.ndarray, limit_s: float) -> float:
    """The share of latencies at or under a limit."""
    return float(np.count_nonzero(lat <= limit_s)) / len(lat)


def percentile(values: np.ndarray, q: float) -> Optional[float]:
    if len(values) == 0:
        return None
    return float(np.percentile(values, q))


def hist_quantile(counts: Sequence[int], bounds: Sequence[float],
                  q: float) -> Optional[float]:
    """Quantile (seconds) of bucket counts whose upper bounds are
    `bounds` (one more bucket past the last), linear inside a bucket."""
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    cum = 0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if cum + c >= target:
            lo = 0.0 if i == 0 else bounds[i - 1]
            hi = bounds[i] if i < len(bounds) else 2 * bounds[-1]
            return lo + (hi - lo) * (target - cum) / c
        cum += c
    return 2 * bounds[-1]


def latency_delta(m0: dict, m1: dict, name: str) -> Optional[List[int]]:
    """Bucket counts a `/metrics.json` latency histogram gained between
    two snapshots."""
    if m0 is None or m1 is None:
        return None
    try:
        b0 = m0["latencies"][name]["buckets"]
        b1 = m1["latencies"][name]["buckets"]
    except KeyError:
        return None
    return [y - x for x, y in zip(b0, b1)]


def gauge_delta(m0: dict, m1: dict, name: str) -> Optional[float]:
    if m0 is None or m1 is None:
        return None
    try:
        return float(m1["gauges"][name]) - float(m0["gauges"][name])
    except KeyError:
        return None


# -- the comparison -----------------------------------------------------

def digest(line: bytes) -> bytes:
    return hashlib.blake2b(line, digest_size=8).digest()


def digests(recs: List[bytes]) -> np.ndarray:
    return np.frombuffer(b"".join(digest(r) for r in recs), dtype="<u8")


def records_differing(got: np.ndarray, want: np.ndarray) -> int:
    """Positions where the records differ, plus the records one side has
    beyond the other: 0 only for the same records in the same order."""
    n = min(len(got), len(want))
    return int(np.count_nonzero(got[:n] != want[:n])) + abs(len(got)
                                                           - len(want))


def first_difference(got: np.ndarray, want: np.ndarray) -> Optional[int]:
    n = min(len(got), len(want))
    bad = np.flatnonzero(got[:n] != want[:n])
    if len(bad):
        return int(bad[0])
    return None if len(got) == len(want) else n


def messages_wrong(got: np.ndarray, want: np.ndarray,
                   counts: np.ndarray) -> int:
    """Messages whose records differ from the reference's; past a
    record lost or doubled every later message counts."""
    starts = np.concatenate([[0], np.cumsum(counts)])
    if len(got) == len(want):
        bad = np.flatnonzero(got != want)
        return int(len(np.unique(np.searchsorted(starts, bad,
                                                 side="right") - 1)))
    d = first_difference(got, want)
    return int(len(counts) - (np.searchsorted(starts, d, side="right") - 1))


def records_doubled(stamps: np.ndarray) -> int:
    """Exactly-once stamps seen more than once (unstamped records: -1)."""
    s = stamps[stamps >= 0]
    return int(len(s) - len(np.unique(s)))
