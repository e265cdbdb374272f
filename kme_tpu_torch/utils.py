"""Small shared host-side utilities (the port's copy of `kme_tpu/utils.py`
`pow2_bucket`, plus the Java-long wrap the router needs from
`kme_tpu/oracle/javalong.py`)."""

from __future__ import annotations

_MASK64 = (1 << 64) - 1
_SIGN64 = 1 << 63


def pow2_bucket(n: int, lo: int = 64) -> int:
    """Round up to a power-of-two bucket (bounds the distinct chunk
    counts a dispatch is padded to)."""
    b = lo
    while b < n:
        b *= 2
    return b


def jlong(x: int) -> int:
    """Wrap an unbounded int to Java signed 64-bit."""
    x &= _MASK64
    return x - (1 << 64) if x & _SIGN64 else x
