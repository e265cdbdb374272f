"""The reference: a frozen copy of the port's quirk-exact C++ engine
(`kme_oracle.cpp`, beside this file), built with g++ into
`kmebench/_build/` and bound with ctypes.

It takes the benchmark's message columns and returns the MatchOut
records the served path has to produce, as `<key> <json>` lines. It
imports nothing of the program: `kmebench/tests` holds it equal to the
Python copy of the oracle (`oracle.py`) on seeded streams of both
compats, the fixed capacity envelope included.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import List, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "kme_oracle.cpp")
BUILD = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
# the engine's death codes (kme_oracle.cpp): the reference would hang
# or throw on this message
_DEATH = {1: "hang", 2: "crash"}

_lock = threading.Lock()
_lib = None


class ReferenceDeath(RuntimeError):
    """The reference engine would hang or throw at message `index`."""

    def __init__(self, kind: str, index: int, detail: str) -> None:
        super().__init__(f"reference {kind} at message {index}: {detail}")
        self.kind, self.index = kind, index


def library_path() -> str:
    with open(SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD, f"kme_oracle_{tag}.so")


def _build(out: str) -> None:
    os.makedirs(BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        r = subprocess.run(["g++", *CXX_FLAGS, SRC, "-o", tmp],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"building the reference failed (g++ rc="
                               f"{r.returncode}):\n{r.stderr[:2000]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load():
    """The built reference library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            c = ctypes
            P64 = c.POINTER(c.c_int64)
            P8 = c.POINTER(c.c_uint8)
            for name, args, res in (
                    ("kme_oracle_new", [c.c_int32, c.c_int32, c.c_int64,
                                        c.c_int32, c.c_int64], c.c_void_p),
                    ("kme_oracle_free", [c.c_void_p], None),
                    ("kme_oracle_process", [c.c_void_p, c.c_int64]
                     + [P64] * 7 + [P8, P64, P8], c.c_int32),
                    ("kme_oracle_err_index", [c.c_void_p], c.c_int64),
                    ("kme_oracle_err_msg", [c.c_void_p], c.c_char_p),
                    ("kme_oracle_out_buf", [c.c_void_p], c.c_void_p),
                    ("kme_oracle_out_len", [c.c_void_p], c.c_int64),
                    ("kme_oracle_line_counts", [c.c_void_p], P64),
                    ("kme_oracle_n_processed", [c.c_void_p], c.c_int64)):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, res
            _lib = lib
        return _lib


class Reference:
    """One engine instance: `compat` "fixed" or "java"; `book_slots` and
    `max_fills` are the fixed-mode capacity envelope (None = unbounded)."""

    def __init__(self, compat: str, book_slots: Optional[int] = None,
                 max_fills: Optional[int] = None) -> None:
        if compat not in ("fixed", "java"):
            raise ValueError(f"unknown compat {compat!r}")
        if compat == "java" and (book_slots is not None
                                 or max_fills is not None):
            raise ValueError("the capacity envelope is fixed-mode only")
        self._lib = load()
        self._h = self._lib.kme_oracle_new(
            1 if compat == "java" else 0,
            0 if book_slots is None else 1, book_slots or 0,
            0 if max_fills is None else 1, max_fills or 0)

    def close(self) -> None:
        if self._h:
            self._lib.kme_oracle_free(self._h)
            self._h = None

    def __enter__(self) -> "Reference":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def process(self, cols: dict) -> Tuple[bytes, np.ndarray]:
        """Run messages given as int64 columns `action, oid, aid, sid,
        price, size` (no next/prev: the benchmark never sends them).
        Returns (the MatchOut lines joined by "\\n" with a trailing one,
        lines per message). Raises ReferenceDeath where the reference
        would hang or throw."""
        arrs = [np.ascontiguousarray(cols[k], dtype=np.int64)
                for k in ("action", "oid", "aid", "sid", "price", "size")]
        n = len(arrs[0])
        if any(len(a) != n for a in arrs):
            raise ValueError("message columns differ in length")
        if n and (np.abs(arrs[4]).max() >= 2**31
                  or np.abs(arrs[5]).max() >= 2**31):
            raise ValueError("price/size outside int32")
        zeros64 = np.zeros(n, np.int64)
        zeros8 = np.zeros(n, np.uint8)
        P64 = ctypes.POINTER(ctypes.c_int64)
        P8 = ctypes.POINTER(ctypes.c_uint8)
        lib = self._lib
        rc = lib.kme_oracle_process(
            self._h, n, *[a.ctypes.data_as(P64) for a in arrs],
            zeros64.ctypes.data_as(P64), zeros8.ctypes.data_as(P8),
            zeros64.ctypes.data_as(P64), zeros8.ctypes.data_as(P8))
        if rc != 0:
            raise ReferenceDeath(
                _DEATH.get(rc, f"code {rc}"),
                int(lib.kme_oracle_err_index(self._h)),
                lib.kme_oracle_err_msg(self._h).decode())
        total = lib.kme_oracle_out_len(self._h)
        out = ctypes.string_at(lib.kme_oracle_out_buf(self._h), total)
        nproc = lib.kme_oracle_n_processed(self._h)
        counts = (np.ctypeslib.as_array(lib.kme_oracle_line_counts(self._h),
                                        shape=(nproc,)).copy()
                  if nproc else np.zeros(0, np.int64))
        return out, counts


def replay(cols: dict, compat: str, book_slots: Optional[int] = None,
           max_fills: Optional[int] = None) -> Tuple[List[bytes],
                                                     np.ndarray]:
    """The MatchOut records of a whole stream on a fresh engine:
    (records as bytes, lines per message)."""
    with Reference(compat, book_slots, max_fills) as ref:
        out, counts = ref.process(cols)
    recs = out.split(b"\n")
    if recs and recs[-1] == b"":
        recs.pop()
    return recs, counts
