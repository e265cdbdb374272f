"""Protocol opcodes — the reference's wire opcode table.

The port's own copy of `kme_tpu/opcodes.py` (the port imports nothing of
`kme_tpu`). Mirrors the constants of KProcessor.MatchingEngine
(reference KProcessor.java:65-75). These are wire-level values: they
appear in the JSON `action` field on input and output.
"""

# Wire opcodes (KProcessor.java:65-75)
ADD_SYMBOL = 0
REMOVE_SYMBOL = 1
BUY = 2
SELL = 3
CANCEL = 4
BOUGHT = 5
SOLD = 6
REJECT = 7
CREATE_BALANCE = 100
TRANSFER = 101
PAYOUT = 200

WIRE_ACTIONS = frozenset(
    {ADD_SYMBOL, REMOVE_SYMBOL, BUY, SELL, CANCEL, CREATE_BALANCE, TRANSFER, PAYOUT}
)


class DevOp:
    """Dense device-side op encoding (int32 `action` lane field).

    NOP lanes are padding: a scheduler step rarely fills every symbol lane.
    """

    NOP = 0
    BUY = 1
    SELL = 2
    CANCEL = 3
    CREATE_BALANCE = 4
    TRANSFER = 5
    ADD_SYMBOL = 6
    REMOVE_SYMBOL = 7  # barrier
    PAYOUT = 8  # barrier

    BARRIER_OPS = (REMOVE_SYMBOL, PAYOUT)


WIRE_TO_DEV = {
    BUY: DevOp.BUY,
    SELL: DevOp.SELL,
    CANCEL: DevOp.CANCEL,
    CREATE_BALANCE: DevOp.CREATE_BALANCE,
    TRANSFER: DevOp.TRANSFER,
    ADD_SYMBOL: DevOp.ADD_SYMBOL,
    REMOVE_SYMBOL: DevOp.REMOVE_SYMBOL,
    PAYOUT: DevOp.PAYOUT,
}

DEV_TO_WIRE = {v: k for k, v in WIRE_TO_DEV.items()}
