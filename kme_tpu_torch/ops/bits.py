"""Java-exact 64-bit bit ops and price-bitmap scans — the port of
`kme_tpu/ops/bits.py`.

The reference packs each book side's 126 price levels into two Java longs
(UUID msb/lsb, split at price 63 — KProcessor.java:391-394) and finds the
best price with double-precision log10 math (KProcessor.java:371-377,
quirk Q7). The oracle (oracle/javalong.py) reproduces the float formulas
verbatim; here the same semantics are reproduced with exact integer
tensor ops:

- For the min-scan the float formula is exact on every reachable input
  (single-set-bit values), so the integer lowest set bit is identical.
- For the max-scan the float formula overshoots by one on dense values
  near the top of a 2^t..2^(t+1) range (the reference then NPEs on the
  missing bucket — the oracle's ReferenceCrash). The exact overshoot
  frontier is precomputed per top-bit position with the host's
  math.log10 (the same IEEE-754 doubles the oracle uses), so the scan
  returns the overshot results too.
- Negative and zero inputs follow Java's (int) casts of NaN / -Infinity
  (0 / Integer.MIN_VALUE).

All shifts mask the count to 6 bits like Java long shifts. torch's `>>`
on int64 is arithmetic, as Java's is; its `<<` shifts the unsigned bit
pattern, so `1 << 63` and `key << 8` wrap as on the JVM.

torch has no popcount. Every scan here reads the 64 bits of its input
one by one — `(v >> i) & 1` for i in 0..63, masked after the shift, so a
negative value's sign fill never leaks — and takes a count, the highest
or the lowest set position from them. That is exact on every int64,
negative values and INT64_MIN included, and needs no wrapping
arithmetic: the JAX package's `n & -n` and `v - 1` (which wrap at
INT64_MIN) become the lowest set position, and its smear + popcount
becomes the highest.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from kme_tpu_torch.oracle.javalong import \
    _java_int_of_log_ratio as _host_int_log_ratio

INT32_MIN = -(1 << 31)
_I64 = torch.int64
_I32 = torch.int32


def _compute_overshoot_thresholds() -> np.ndarray:
    """For each top-bit t in 0..62, the smallest v in [2^t, 2^(t+1)) whose
    float last-set-bit scan returns t+1 instead of t; -1 if none.

    int(log10(v)/log10(2)) is monotone non-decreasing in v, so a binary
    search finds the exact frontier; the boundary is verified ±64 around
    the found threshold."""
    thresholds = np.full(63, -1, dtype=np.int64)
    for t in range(63):
        lo, hi = 1 << t, (1 << (t + 1)) - 1
        if _host_int_log_ratio(hi) <= t:
            continue  # never overshoots in this range
        a, b = lo, hi
        while a < b:
            mid = (a + b) // 2
            if _host_int_log_ratio(mid) > t:
                b = mid
            else:
                a = mid + 1
        thr = a
        for v in range(max(lo, thr - 64), min(hi, thr + 64) + 1):
            expect = t + 1 if v >= thr else t
            assert _host_int_log_ratio(v) == expect, (t, v)
        thresholds[t] = thr
    return thresholds


# 63 entries, computed once at import (63 binary searches on the host);
# a copy per device is made at first use.
_OVERSHOOT = _compute_overshoot_thresholds()


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device):
    """(bit positions 0..63, overshoot table) on `device`."""
    return (torch.arange(64, dtype=_I64, device=device),
            torch.from_numpy(_OVERSHOOT).to(device))


def _bit_planes(v: torch.Tensor):
    """(bits, positions): bits[..., i] = bit i of v (0/1, int64)."""
    pos = _consts(v.device)[0]
    return (v.to(_I64).unsqueeze(-1) >> pos) & 1, pos


def popcount(v):
    """Set bits of each int64 (64 for -1): the count of the 64 masked
    single-bit shifts."""
    return _bit_planes(v)[0].sum(-1).to(_I32)


def jshl1(k):
    """Java `1L << k`: count masked to 6 bits; 1<<63 wraps negative."""
    k = (k & 63).to(_I64)
    return torch.ones_like(k) << k


def jget_bit(n, k):
    """KProcessor.java:406-408 — `1L == ((n >> k) & 1L)`, arithmetic
    shift."""
    return ((n.to(_I64) >> (k & 63).to(_I64)) & 1) == 1


def jset_bit(n, k):
    """KProcessor.java:410-412 — `n | (1L << k)`."""
    return n.to(_I64) | jshl1(k)


def junset_bit(n, k):
    """KProcessor.java:414-416 — `n & ~(1L << k)`."""
    return n.to(_I64) & ~jshl1(k)


def top_bit(v):
    """floor(log2(v)) for v > 0 (int32): the highest set position. Like
    the JAX package's smear + popcount - 1, it gives 63 for a negative v
    and -1 for 0."""
    bits, pos = _bit_planes(v)
    return torch.where(bits == 1, pos, -1).amax(-1).to(_I32)


def first_set_bit_pos(n):
    """javalong.first_set_bit_pos_float, exactly (KProcessor.java:371-373).

    n & -n is n's lowest set bit alone; the float formula is exact there,
    so the answer is that bit's position. Java cast quirks: a lowest bit
    of 63 (n == INT64_MIN, where n & -n is negative) -> 0, n == 0 ->
    Integer.MIN_VALUE."""
    bits, pos = _bit_planes(n)
    low = torch.where(bits == 1, pos, 64).amin(-1)
    out = torch.where(low == 63, 0, low).to(_I32)
    return torch.where(n == 0, INT32_MIN, out).to(_I32)


def last_set_bit_pos(n):
    """javalong.last_set_bit_pos_float, exactly (KProcessor.java:375-377),
    including the Q7 overshoot (top+1 past the per-top-bit float frontier
    — the caller's bucket lookup then misses, as on the JVM)."""
    n = n.to(_I64)
    t = top_bit(torch.where(n > 0, n, 1))
    # take(), not thr_table[t]: indexing with a 0-d tensor reads it back
    # to the host
    thr = torch.take(_consts(n.device)[1], t.clamp(0, 62).to(_I64))
    over = (thr >= 0) & (n >= thr)
    pos = t + over.to(_I32)
    out = torch.where(n < 0, 0, pos).to(_I32)
    return torch.where(n == 0, INT32_MIN, out).to(_I32)


# ---------------------------------------------------------------------------
# Book bitmap helpers (msb carries prices 63..125 at offset price-63,
# lsb carries 0..62; bit 63 of lsb unused in the valid domain — Q8 — but
# reachable via negative prices, which the shift masking handles like Java).

def book_min_price(msb, lsb):
    """getMinPriceBucketPointer (KProcessor.java:359-363)."""
    empty = (lsb == 0) & (msb == 0)
    from_msb = first_set_bit_pos(msb) + 63
    from_lsb = first_set_bit_pos(lsb)
    return torch.where(empty, -1,
                       torch.where(lsb == 0, from_msb, from_lsb)).to(_I32)


def book_max_price(msb, lsb):
    """getMaxPriceBucketPointer (KProcessor.java:365-369)."""
    empty = (lsb == 0) & (msb == 0)
    from_lsb = last_set_bit_pos(lsb)
    from_msb = last_set_bit_pos(msb) + 63
    return torch.where(empty, -1,
                       torch.where(msb == 0, from_lsb, from_msb)).to(_I32)


def book_check_bit(msb, lsb, price):
    """checkBit (KProcessor.java:391-394): split at price < 63."""
    return torch.where(price < 63, jget_bit(lsb, price),
                       jget_bit(msb, price - 63))


def book_with_bit_set(msb, lsb, price):
    """getWithBitSet (KProcessor.java:396-399) -> (msb, lsb)."""
    lo = price < 63
    new_lsb = torch.where(lo, jset_bit(lsb, price), lsb.to(_I64))
    new_msb = torch.where(lo, msb.to(_I64), jset_bit(msb, price - 63))
    return new_msb, new_lsb


def book_with_bit_unset(msb, lsb, price):
    """getWithBitUnset (KProcessor.java:401-404) -> (msb, lsb)."""
    lo = price < 63
    new_lsb = torch.where(lo, junset_bit(lsb, price), lsb.to(_I64))
    new_msb = torch.where(lo, msb.to(_I64), junset_bit(msb, price - 63))
    return new_msb, new_lsb


def bucket_key(book_key, price):
    """getBucketPointer (KProcessor.java:379-381): (key << 8) | (long)price
    with Java wrap; a negative price sign-extends and floods the high bits,
    exactly as on the JVM."""
    return (book_key.to(_I64) << 8) | price.to(_I64)
