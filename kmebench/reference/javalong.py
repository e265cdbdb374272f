"""The benchmark's frozen copy of `kme_tpu_torch/oracle/javalong.py`.

Exact Java 64-bit two's-complement arithmetic for the oracle.

Python ints are unbounded; the reference's codecs do Java `long` bit
twiddling (shifts mask the count to 6 bits, overflow wraps). Every helper
here reproduces Java semantics exactly so the oracle matches the JVM
bit-for-bit even on adversarial inputs (negative prices from the workload
generator's unclamped normals, exchange_test.js:110-115).

Bit-scan note (SURVEY.md §2.5 Q7): the reference finds first/last set bits
with double-precision log10 math (KProcessor.java:371-377). IEEE-754
doubles behave identically in Java and CPython, and
tests/test_javalong.py::test_float_bitscan_equivalence proves the float
formulas agree with exact integer scans over the whole used range
(single-set-bit longs for first-bit, arbitrary non-negative longs for
last-bit). The oracle therefore uses the float formulas directly — they ARE
the reference semantics — and the device engine uses exact integer ops,
with the test as the bridge.
"""

from __future__ import annotations

import math

_MASK64 = (1 << 64) - 1
_SIGN = 1 << 63


def jlong(x: int) -> int:
    """Wrap an unbounded int to Java signed 64-bit."""
    x &= _MASK64
    return x - (1 << 64) if x & _SIGN else x


def jint(x: int) -> int:
    """Wrap to Java signed 32-bit."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x & 0x80000000 else x


def jshl(n: int, k: int) -> int:
    """Java `n << k` on long: shift count masked to 6 bits."""
    return jlong(n << (k & 63))


def jshr(n: int, k: int) -> int:
    """Java `n >> k` (arithmetic) on long."""
    return jlong(n) >> (k & 63)


def jor(a: int, b: int) -> int:
    return jlong(jlong(a) | jlong(b))


def jand(a: int, b: int) -> int:
    return jlong(jlong(a) & jlong(b))


def jnot(a: int) -> int:
    return jlong(~jlong(a))


def jneg(a: int) -> int:
    return jlong(-jlong(a))


def jadd(a: int, b: int) -> int:
    return jlong(a + b)


def jmul(a: int, b: int) -> int:
    return jlong(a * b)


# --- bit ops exactly as KProcessor.java:406-416 ---

def get_bit(n: int, k: int) -> bool:
    """KProcessor.java:406-408: `1L == ((n >> k) & 1L)`."""
    return 1 == (jshr(n, k) & 1)


def set_bit(n: int, k: int) -> int:
    """KProcessor.java:410-412: `n | (1L << k)`."""
    return jor(n, jshl(1, k))


def unset_bit(n: int, k: int) -> int:
    """KProcessor.java:414-416: `n & ~(1L << k)`."""
    return jand(n, jnot(jshl(1, k)))


# --- float bit scans exactly as KProcessor.java:371-377 ---

def first_set_bit_pos_float(n: int) -> int:
    """KProcessor.java:371-373: `(int)((log10(n & -n)) / log10(2))`.

    Java double semantics: log10 of 0 is -inf (-inf/x = -inf, (int)-inf =
    Integer.MIN_VALUE); of negative is NaN ((int)NaN = 0).
    """
    v = jand(n, jneg(n))
    return _java_int_of_log_ratio(v)


def last_set_bit_pos_float(n: int) -> int:
    """KProcessor.java:375-377: `(int)((log10(n)) / log10(2))`."""
    return _java_int_of_log_ratio(jlong(n))


def _java_int_of_log_ratio(v: int) -> int:
    if v < 0:
        return 0  # (int) NaN == 0 in Java
    if v == 0:
        return -(1 << 31)  # (int) -Infinity == Integer.MIN_VALUE
    return int(math.log10(v) / math.log10(2.0))


def first_set_bit_pos(n: int) -> int:
    """Exact-integer equivalent of first_set_bit_pos_float for n with at
    least one set bit (proven equivalent by test_float_bitscan_equivalence)."""
    v = jand(n, jneg(n)) & _MASK64
    return v.bit_length() - 1


def last_set_bit_pos(n: int) -> int:
    """Exact-integer equivalent of last_set_bit_pos_float for n > 0."""
    return jlong(n).bit_length() - 1
