"""NativeOracleEngine: the C++ quirk-exact engine behind the oracle API.

The fast quirk-exact serving path (COMPAT.md: the parallel engine cannot
be quirk-exact under Q11, and the serial device replica is op-count
bound on TPU) — the same semantics as kme_tpu_torch.oracle.OracleEngine, at
native speed. Byte parity (wire lines AND deep store state) is pinned by
tests/test_native_oracle.py.

Envelope: ids are Java longs (wrapped at this marshal boundary — the
Jackson long envelope), price/size int32 (EnvelopeError beyond).
Reference-death paths raise the oracle's ReferenceHang/ReferenceCrash
with the engine state left at the death point, like the oracle.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np

from kme_tpu_torch.native import load_library
from kme_tpu_torch.oracle.engine import ReferenceCrash, ReferenceHang
from kme_tpu_torch.wire import OrderMsg

_ERR_HANG, _ERR_CRASH = 1, 2


def native_available() -> bool:
    return load_library() is not None


class NativeOracleEngine:
    def __init__(self, compat: str = "java",
                 book_slots: Optional[int] = None,
                 max_fills: Optional[int] = None) -> None:
        if compat not in ("java", "fixed"):
            raise ValueError(compat)
        self.java = compat == "java"
        self.book_slots = book_slots
        self.max_fills = max_fills
        if self.java and (book_slots is not None or max_fills is not None):
            raise ValueError("capacity envelope is a fixed-mode concept")
        self._lib = load_library()
        if self._lib is None:
            raise RuntimeError("native engine library unavailable")
        self._h = self._lib.kme_oracle_new(
            1 if self.java else 0,
            0 if book_slots is None else 1, book_slots or 0,
            0 if max_fills is None else 1, max_fills or 0)

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.kme_oracle_free(h)
            self._h = None

    def process_wire(self, msgs: Sequence[OrderMsg]) -> List[List[str]]:
        """Per-message `<key> <json>` wire-line lists, byte-identical to
        [r.wire() for r in OracleEngine.process(m)]. Raises the oracle's
        ReferenceHang/ReferenceCrash on a reference-death message (lines
        of earlier messages are lost to the caller — use
        process_wire_partial to retain them, as the service does)."""
        out, exc = self.process_wire_partial(msgs)
        if exc is not None:
            raise exc
        return out

    def process_wire_partial(self, msgs: Sequence[OrderMsg]):
        """Like process_wire, but on a reference-death message returns
        (lines_of_completed_messages, exception) instead of discarding
        the completed prefix — the byte-faithful service path (the
        reference forwards every record before its thread dies)."""
        from kme_tpu_torch.oracle import javalong as jl
        from kme_tpu_torch.wire import EnvelopeError

        n = len(msgs)
        cols = {k: [] for k in ("action", "oid", "aid", "sid", "price",
                                "size", "next", "prev")}
        nxt_has = np.zeros(n, np.uint8)
        prv_has = np.zeros(n, np.uint8)
        jlong = jl.jlong
        for i, m in enumerate(msgs):
            if not (-2**31 <= m.price < 2**31 and -2**31 <= m.size < 2**31):
                raise EnvelopeError(
                    f"message {i}: price/size outside int32 "
                    f"(price={m.price}, size={m.size})")
            a = m.action
            cols["action"].append(a if -2**63 <= a < 2**63 else -1)
            cols["oid"].append(jlong(m.oid))
            cols["aid"].append(jlong(m.aid))
            cols["sid"].append(jlong(m.sid))
            cols["price"].append(m.price)
            cols["size"].append(m.size)
            cols["next"].append(0 if m.next is None else jlong(m.next))
            cols["prev"].append(0 if m.prev is None else jlong(m.prev))
            if m.next is not None:
                nxt_has[i] = 1
            if m.prev is not None:
                prv_has[i] = 1
        arrs = [np.array(cols[k], np.int64) if n else np.zeros(0, np.int64)
                for k in ("action", "oid", "aid", "sid", "price", "size",
                          "next", "prev")]
        P64 = ctypes.POINTER(ctypes.c_int64)
        P8 = ctypes.POINTER(ctypes.c_uint8)
        lib, h = self._lib, self._h
        rc = lib.kme_oracle_process(
            h, n, arrs[0].ctypes.data_as(P64), arrs[1].ctypes.data_as(P64),
            arrs[2].ctypes.data_as(P64), arrs[3].ctypes.data_as(P64),
            arrs[4].ctypes.data_as(P64), arrs[5].ctypes.data_as(P64),
            arrs[6].ctypes.data_as(P64), nxt_has.ctypes.data_as(P8),
            arrs[7].ctypes.data_as(P64), prv_has.ctypes.data_as(P8))
        exc = None
        if rc == _ERR_HANG:
            exc = ReferenceHang(
                f"message {lib.kme_oracle_err_index(h)}: "
                f"{lib.kme_oracle_err_msg(h).decode()}")
        elif rc == _ERR_CRASH:
            exc = ReferenceCrash(
                f"message {lib.kme_oracle_err_index(h)}: "
                f"{lib.kme_oracle_err_msg(h).decode()}")
        total = lib.kme_oracle_out_len(h)
        raw = ctypes.string_at(lib.kme_oracle_out_buf(h), total).decode()
        lines = raw.splitlines()
        nproc = lib.kme_oracle_n_processed(h)
        counts = np.ctypeslib.as_array(
            lib.kme_oracle_line_counts(h), shape=(nproc,)).tolist() \
            if nproc else []
        out: List[List[str]] = []
        pos = 0
        for c in counts:
            out.append(lines[pos:pos + c])
            pos += c
        return out, exc

    def dump_state(self) -> str:
        """The engine's complete store state as the checkpoint text
        payload (one record per line; includes position insertion
        stamps so dict iteration order survives a restore)."""
        return self._lib.kme_oracle_dump_state(self._h).decode()

    def load_state(self, text: str) -> None:
        """Replace the five stores with a dump_state() payload."""
        rc = self._lib.kme_oracle_load_state(self._h, text.encode())
        if rc != 0:
            raise ValueError("malformed native-engine state payload")

    def export_state(self) -> dict:
        """Host dict view of the five stores, comparable to
        OracleEngine's dicts (tests/test_native_oracle.py)."""
        raw = self.dump_state()
        balances, positions, orders, books, buckets = {}, {}, {}, {}, {}
        for ln in raw.splitlines():
            parts = ln.split()
            kind = parts[0]
            vals = [int(x) for x in parts[1:]]
            if kind == "B":
                balances[vals[0]] = vals[1]
            elif kind == "P":
                positions[(vals[0], vals[1])] = (vals[2], vals[3])
            elif kind == "K":
                books[vals[0]] = (vals[1], vals[2])
            elif kind == "U":
                buckets[vals[0]] = (vals[1], vals[2])
            elif kind == "O":
                orders[vals[0]] = {
                    "action": vals[1], "aid": vals[2], "sid": vals[3],
                    "price": vals[4], "size": vals[5],
                    "next": vals[7] if vals[6] else None,
                    "prev": vals[9] if vals[8] else None,
                }
        return {"balances": balances, "positions": positions,
                "orders": orders, "books": books, "buckets": buckets}
