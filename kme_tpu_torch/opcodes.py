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
