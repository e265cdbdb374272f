"""The frozen reference: the C++ copy (`reference/kme_oracle.cpp`) equal
to the Python copy of the oracle on seeded streams of two shapes, in the
compats and envelopes the configurations and their controls use; and
the roofline's byte count on a batch counted by hand."""

import numpy as np
import pytest

from kmebench.reference import opcodes as op
from kmebench.reference.native import replay
from kmebench.reference.oracle import OracleEngine
from kmebench.reference.wire import OrderMsg
from kmebench.roofline import (BALANCE_BYTES, ENTRY_BYTES, MSG_BYTES,
                               OUT_BYTES, POSITION_BYTES, least_bytes)
from kmebench.streams import COLS, MessageStream

# small widths so that the 4 000 messages fill books past the envelope
FUNDED = {"accounts": 32, "deposit": 10_000_000, "preamble_symbols": 8,
          "symbols": 8,
          "per_mille": {"payout": 2, "buy": 448, "sell": 450,
                        "cancel": 100},
          "payout_opcode": "payout", "payout_readd": True, "clamp": True}
EXCHANGE = {}                      # exchange_test.js as shipped
CLAMPED = {"clamp": True}
CASES = {
    "clamped-java": (CLAMPED, dict(compat="java")),
    "funded-fixed-envelope": (FUNDED, dict(compat="fixed", book_slots=8,
                                       max_fills=4)),
    "funded-fixed": (FUNDED, dict(compat="fixed")),
    "exchange-java": (EXCHANGE, dict(compat="java")),
    "exchange-fixed": (EXCHANGE, dict(compat="fixed")),
}


def python_lines(cols, compat, book_slots=None, max_fills=None):
    eng = OracleEngine(compat, book_slots=book_slots, max_fills=max_fills)
    out, counts = [], []
    for t in zip(*(cols[k].tolist() for k in COLS)):
        recs = [r.wire().encode() for r in eng.process(OrderMsg(*t))]
        out += recs
        counts.append(len(recs))
    return out, counts


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_cpp_copy_equals_python_copy(case, seed):
    spec, kw = CASES[case]
    cols = MessageStream(spec, seed).take(4000)
    got, counts = replay(cols, **kw)
    want, wcounts = python_lines(cols, **kw)
    assert got == want
    assert list(counts) == wcounts


def test_the_envelope_rejects_what_an_unbounded_book_takes():
    cols = MessageStream(FUNDED, 5).take(4000)
    bounded, _ = replay(cols, compat="fixed", book_slots=8, max_fills=4)
    free, _ = replay(cols, compat="fixed")
    assert bounded != free
    assert sum(r.startswith(b'OUT {"action":7,') for r in bounded) > \
        sum(r.startswith(b'OUT {"action":7,') for r in free)


def test_least_bytes_of_a_batch_counted_by_hand():
    rows = [(op.CREATE_BALANCE, 0, 0, 0, 0, 0),
            (op.TRANSFER, 0, 0, 0, 0, 1000),
            (op.CREATE_BALANCE, 0, 1, 0, 0, 0),
            (op.TRANSFER, 0, 1, 0, 0, 1000),
            (op.ADD_SYMBOL, 0, 0, 0, 0, 0),
            (op.BUY, 10, 0, 0, 50, 5),      # rests
            (op.SELL, 11, 1, 0, 50, 3),     # fills 3 of order 10
            (op.CANCEL, 10, 0, 0, 0, 0)]    # cancels its rest
    cols = {k: np.array([r[i] for r in rows], np.int64)
            for i, k in enumerate(COLS)}
    recs, counts = replay(cols, compat="fixed")
    assert list(counts[5:]) == [2, 4, 2]
    # messages 5-7: 3 read; 5 OUT records written (an echo, two fills and
    # an echo, an echo); balances of accounts 0 and 1 and positions
    # (0, 0) and (1, 0) read and written; order 10 rests inside the
    # window, so it is written once
    want = (3 * MSG_BYTES + 5 * OUT_BYTES + 2 * 2 * BALANCE_BYTES
            + 2 * 2 * POSITION_BYTES + 1 * ENTRY_BYTES)
    assert want == 344
    assert least_bytes(cols, recs, counts, 5, 8) == want
    # from message 6 on, order 10 was resting before the window: read
    # and written
    want6 = (2 * MSG_BYTES + 4 * OUT_BYTES + 2 * 2 * BALANCE_BYTES
             + 2 * 2 * POSITION_BYTES + 2 * ENTRY_BYTES)
    assert least_bytes(cols, recs, counts, 6, 8) == want6
